#!/usr/bin/env python3
"""Time the streamed dense conv (K2), the fc-head matmul (K7/K8, int8
and its float modes at every operand pair), the pools (K5, K6) and the attention
kernels' bf16 ``mma.sync`` routes (K9 at DeepSeek-V2's qk 192 / v 128,
K10/K11 at Phi-4-mini's shape) of a checkout of this repository, and the
device time of each net's forward, on one CUDA card: the probe that
holds two trees against each other in one call (PERF.md).

    python3 probe_stream.py [ROOT] [--float-only | --float-variants]

ROOT is the checkout whose ``src/repro_torch`` is timed (default: the one
holding this script); its kernels build into ROOT/build on first use.
``--float-only`` times the float matmul alone.  ``--float-variants``
times it at fc0 (25088 x 4096) and 4096 x 4096, fifo, at a few operand
pairs, under variants of its launch plan (VARIANTS: the plan's constants
in ``stream_matmul/ops.py`` set in this process) and two ablations of
the tensor-core body (ABLATIONS: copies of the package under
ROOT/build/probe_stream built with ``MM_FLOAT_PROBE`` defined, which
``csrc/stream_matmul.cu`` documents): the probe behind the design of
``mm_float_tc``.
Shapes: every streamed dense conv of ResNet-50 and VGG-16 compiled for
``NX2100`` at batch 8 (n_buffers 2, as the executor launches them), every
fc head of the six CNN configs in the mode the engine runs it (the float
modes, at every pair over f32, bf16, f16 and int8 but int8 x int8, also
at VGG-16's fc0 streamed, M = 8), every
maxpool and global-average-pool shape of ResNet-50, ResNet-18,
MobileNetV2 and VGG-16, and the forwards of those four nets.  Device times:
20 calls (a forward: 1) captured into a CUDA graph and replayed, L2 warm.
Beside them, the rate device memory gives a plain reader of VGG-16's fc0
weights (a 25088 x 4096 int8 matrix, 102.8 MB, more than the L2 holds)
by two patterns: 128 CTAs each reading a 32-byte column tile of every
row (what the streamed conv's C_out tiles read), or each reading a
contiguous block of rows.  Prints one JSON line with the card's name and
power limit.
"""
import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

BATCH = 8

# --float-variants: the shapes (K, N), the pairs (x, w), the plan variants
# (name, {plan constant: value}, n_buffers, SM-count factor) and the
# ablations (name, MM_FLOAT_PROBE)
VARIANT_SHAPES = ((25088, 4096), (4096, 4096))
VARIANT_PAIRS = (("bfloat16", "bfloat16"), ("float16", "float16"),
                 ("bfloat16", "float16"), ("bfloat16", "int8"),
                 ("int8", "bfloat16"), ("float32", "float32"),
                 ("float32", "bfloat16"), ("float32", "float16"),
                 ("float32", "int8"))
VARIANTS = (
    ("default", {}, 2, 1),
    ("cp.async", {"MM_TMA_ROWS": 0}, 2, 1),
    ("tma slot 16K", {"MM_TMA_SLOT_MAX": 16384}, 2, 1),
    ("tma slot 48K", {"MM_TMA_SLOT_MAX": 49152}, 2, 1),
    ("tiles 64, 32", {"MM_TILES_TC": (64, 32)}, 2, 1),
    ("n_buffers 3", {}, 3, 1),
    ("split x2", {}, 2, 2),
)
ABLATIONS = (("consumers alone", 1), ("ring alone", 2))

# 128 CTAs of 512 threads read a [rows, 4096] int8 matrix with 16-byte
# loads, 8 in flight a thread: a column tile of `run` bytes of every row
# each (run < 4096), or a contiguous block of rows each (run == 4096)
DRAM_READER = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void reader(const int8_t* w, int rows, int run, int* out) {
  const int per_row = run / 16;
  const int r0 = run == 4096 ? blockIdx.x * (rows / gridDim.x) : 0;
  const int nr = run == 4096 ? rows / gridDim.x : rows;
  const int c0 = run == 4096 ? 0 : blockIdx.x * run;
  unsigned acc = 0;
  // 8 independent loads a thread in flight, in both patterns
  for (int i0 = threadIdx.x; i0 < nr * per_row; i0 += 8 * blockDim.x) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = min(i0 + u * (int)blockDim.x, nr * per_row - 1);
      const int r = r0 + i / per_row, c = c0 + (i % per_row) * 16;
      v[u] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)r * 4096 + c));
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  if (acc == 0x9e3779b9u) out[0] = (int)acc;
}
extern "C" int read_matrix(const int8_t* w, int rows, int run, int* out,
                           cudaStream_t s) {
  reader<<<128, 512, 0, s>>>(w, rows, run, out);
  return (int)cudaGetLastError();
}
"""


def dram_rates(torch, build, root):
    """GB/s of the two reading patterns of DRAM_READER over 25088 x 4096
    int8, device time of 3 calls in a CUDA graph."""
    import ctypes
    out_dir = root / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "dram_reader.cu").write_text(DRAM_READER)
    lib_path = out_dir / "dram_reader.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out_dir / "dram_reader.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.read_matrix.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p]
    rows = 25088
    w = torch.randint(-127, 128, (rows * 4096,), dtype=torch.int8,
                      device="cuda")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    rates = {}
    for name, run in (("column_tiles_32B", 32), ("row_blocks", 4096)):
        ms = device_ms(torch, lambda: lib.read_matrix(
            w.data_ptr(), rows, run, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), 3)
        rates[name] = w.numel() / (ms * 1e6)
    return rates


def device_ms(torch, fn, reps, replays=5):
    """Mean device ms per call of ``reps`` calls captured into one CUDA
    graph (relaxed capture: the launchers set their shared-memory size)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


# the float matmul's operand types (x, w): every pair but int8 x int8
FLOAT_TYPES = ("float32", "bfloat16", "float16", "int8")


def draw(torch, g, dev, shape, dt):
    """A float matmul operand: normal from ``g``, int8 as integers in
    [-127, 127]."""
    if dt == torch.int8:
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)
    return torch.randn(*shape, generator=g, device=dev).to(dt)


def float_times(torch, g, dev, block, heads):
    """Device ms of the float matmul at every fc head (its engine's mode)
    and fc0 (fifo), M = BATCH, n_buffers 2, for every operand pair: keyed
    ``mode:K,N:x-type:w-type``."""
    from repro_torch.kernels.stream_matmul.ops import stream_matmul
    out = {}
    for mode, k_, n_ in [h[:3] for h in heads] + [("fifo", 25088, 4096)]:
        for xd in FLOAT_TYPES:
            for wd in FLOAT_TYPES:
                if xd == wd == "int8":
                    continue
                x = draw(torch, g, dev, (BATCH, k_), getattr(torch, xd))
                w = draw(torch, g, dev, (k_, n_), getattr(torch, wd))
                out[f"{mode}:{k_},{n_}:{xd}:{wd}"] = device_ms(
                    torch, lambda: stream_matmul(x, w, mode=mode,
                                                 bk=block(k_, 512),
                                                 n_buffers=2),
                    5 if k_ == 25088 else 20)
    return out


def probe_tree(root, name, probe):
    """A copy of ROOT's package under ROOT/build/probe_stream/<name> whose
    stream_matmul.cu defines MM_FLOAT_PROBE as ``probe``."""
    dst = root / "build" / "probe_stream" / name.replace(" ", "_")
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(root / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "src" / "repro_torch" / "kernels" / "csrc" / "stream_matmul.cu"
    cu.write_text(f"#define MM_FLOAT_PROBE {probe}\n" + cu.read_text())
    return dst


def variant_times(torch, tree, variants):
    """{shape:pair:variant: {ms, error, plan}} for ``tree``'s package at
    VARIANT_SHAPES and VARIANT_PAIRS, fifo, K blocks of 512, under
    ``variants``."""
    for mod in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[mod]
    sys.path.insert(0, str(tree / "src"))
    try:
        ops = importlib.import_module("repro_torch.kernels.stream_matmul.ops")
        ref = importlib.import_module("repro_torch.kernels.stream_matmul.ref")
        dev = torch.device("cuda")
        sms = ops._device_sms(dev)
        defaults = {k: getattr(ops, k) for v in variants for k in v[1]}
        g = torch.Generator(device=dev).manual_seed(0)
        out = {}
        for k, n in VARIANT_SHAPES:
            for xd, wd in VARIANT_PAIRS:
                x = draw(torch, g, dev, (BATCH, k), getattr(torch, xd))
                w = draw(torch, g, dev, (k, n), getattr(torch, wd))
                want = ref.stream_matmul_ref(x, w).double()
                scale = float(want.abs().max())
                for name, consts, nb, factor in variants:
                    for key, value in {**defaults, **consts}.items():
                        setattr(ops, key, value)
                    ops.mm_float_plan.cache_clear()
                    ops._device_sms = lambda d, s=sms * factor: s

                    def fn():
                        return ops.stream_matmul(x, w, mode="fifo", bk=512,
                                                 n_buffers=nb)
                    plan = ops.mm_float_plan(BATCH, k, n, "fifo", 512, nb,
                                             x.element_size(),
                                             w.element_size(), sms * factor)
                    err = float((fn().double() - want).abs().max()) / scale
                    out[f"{k}x{n}:{xd}x{wd}:{name}"] = {
                        "ms": device_ms(torch, fn, 5 if k > 5000 else 20),
                        "max_err_share_of_max": err,
                        "plan": {f: getattr(plan, f) for f in (
                            "tn", "split", "kblk", "nb", "smem_bytes",
                            "tensor_cores", "tma")}}
                for key, value in defaults.items():
                    setattr(ops, key, value)
        return out
    finally:
        sys.path.remove(str(tree / "src"))


def main():
    import torch
    if not torch.cuda.is_available():
        print("probe_stream: CUDA is not available", file=sys.stderr)
        return 2
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    float_only = "--float-only" in sys.argv[1:]
    root = Path(args[0] if args else
                Path(__file__).resolve().parent).resolve()
    if "--float-variants" in sys.argv[1:]:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60).stdout.strip()
        result = {"root": str(root), "card": card,
                  "variants": variant_times(torch, root, VARIANTS)}
        for name, probe in ABLATIONS:
            result[name] = variant_times(torch, probe_tree(root, name, probe),
                                         VARIANTS[:1])
        print(json.dumps(result))
        return 0
    sys.path.insert(0, str(root / "src"))
    from repro_torch.compiler import NX2100, compile, select_engine
    from repro_torch.compiler.engines import _block
    from repro_torch.configs.cnn import CNN_CONFIGS, get_cnn
    from repro_torch.kernels.conv2d_int8.ops import conv2d_int8_requant
    from repro_torch.kernels.pool_int8.ops import (global_avgpool_int8,
                                                   maxpool_int8)
    from repro_torch.kernels.stream_matmul.ops import stream_matmul_requant
    from repro_torch.models.cnn import cnn_input_shape, init_cnn_params
    from repro_torch.runtime.pipeline import PipelineExecutor
    from repro_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8,
                             device=dev)

    comps = {n: compile(get_cnn(n), NX2100) for n in CNN_CONFIGS}
    conv, mm, heads = {}, {}, []
    for comp in comps.values():
        for sc in comp.plan.schedules:
            sp = sc.spec
            if select_engine(sp).name != "stream_matmul":
                continue
            head = ("fifo" if sc.streamed else "pinned", sp.c_in, sp.c_out,
                    sc.n_buffers)
            if head not in heads:
                heads.append(head)
    float_mm = float_times(torch, g, dev, _block, heads)
    if float_only:
        print(json.dumps({"root": str(root), "card": card,
                          "float_matmul_ms": float_mm}))
        return 0
    for name in ("resnet50", "vgg16"):
        for sc in comps[name].plan.schedules:
            sp = sc.spec
            if not sc.streamed or select_engine(sp).name != "conv2d_int8":
                continue
            key = ",".join(map(str, (sp.in_h, sp.in_w, sp.c_in, sp.c_out,
                                     sp.k_h, sp.stride)))
            if key in conv:
                continue
            x = i8(BATCH, sp.in_h, sp.in_w, sp.c_in)
            w = i8(sp.k_h, sp.k_w, sp.c_in, sp.c_out)
            ws = torch.rand(sp.c_out, generator=g, device=dev) * 0.09 + 0.01
            b = torch.zeros(sp.c_out, device=dev)
            conv[key] = device_ms(torch, lambda: conv2d_int8_requant(
                x, w, ws, b, 0.05, stride=sp.stride, stream=True,
                n_buffers=sc.n_buffers, want_float=sp.kind == "fc"), 20)
    for mode, c_in, c_out, n_buffers in heads:
        x, w = i8(BATCH, c_in), i8(c_in, c_out)
        ws = torch.rand(c_out, generator=g, device=dev) * 0.09 + 0.01
        b = torch.zeros(c_out, device=dev)
        mm[f"{mode}:{c_in},{c_out}"] = device_ms(
            torch, lambda: stream_matmul_requant(
                x, w, ws, b, 0.05, mode=mode, bk=_block(c_in, 512),
                n_buffers=max(2, n_buffers)), 20)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_kernel)
    flash = {}
    for B, H, KV, S, hd, hd_v in ((4, 128, 128, 512, 192, 128),
                                  (4, 24, 8, 512, 128, 128)):
        q, k, v, do = (torch.randn(B, S, h, d, generator=g, device=dev)
                       .bfloat16() for h, d in ((H, hd), (KV, hd),
                                                (KV, hd_v), (H, hd_v)))
        qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
        key = f"{B}x{H}x{KV}x{S}x{hd}x{hd_v}"
        flash[f"fwd:{key}"] = device_ms(
            torch, lambda: flash_attention(q, k, v), 20)
        o, lse = flash_attention_kernel(qt, kt, vt, return_lse=True)
        flash[f"bwd:{key}"] = device_ms(
            torch, lambda: flash_attention_bwd(qt, kt, vt, o, lse, dot), 10)
    pools = {}
    for name in ("resnet50", "resnet18", "mobilenetv2", "vgg16"):
        for sc in comps[name].plan.schedules:
            sp = sc.spec
            engine = select_engine(sp).name
            if engine == "maxpool_int8":
                key = "maxpool:" + ",".join(map(str, (
                    sp.in_h, sp.in_w, sp.c_in, sp.k_h, sp.stride)))
                fn = (lambda x, k=sp.k_h, s=sp.stride:
                      maxpool_int8(x, k=k, stride=s))
            elif engine == "global_avgpool_int8":
                key = f"gap:{sp.in_h},{sp.in_w},{sp.c_in}"
                fn = global_avgpool_int8
            else:
                continue
            if key not in pools:
                x = i8(BATCH, sp.in_h, sp.in_w, sp.c_in)
                pools[key] = device_ms(torch, lambda: fn(x), 20)
    nets = {}
    for name in ("resnet50", "resnet18", "mobilenetv2", "vgg16"):
        comp = comps[name]
        gen = torch.Generator().manual_seed(0)
        params = init_cnn_params(comp.cfg, gen, dev)
        images = torch.randint(-127, 128, cnn_input_shape(comp.cfg, BATCH),
                               generator=gen, dtype=torch.int8).to(dev)
        # the per-layer walk, captured whole into the probe's graph (the
        # fused backend's run is itself a graph replay, which a capture
        # cannot take)
        ex = PipelineExecutor(comp, device=dev, backend="eager")
        nets[name] = device_ms(torch, lambda: ex.run(params, images), 1,
                               replays=10)
    print(json.dumps({"root": str(root), "card": card, "conv_ms": conv,
                      "matmul_ms": mm, "float_matmul_ms": float_mm,
                      "flash_ms": flash, "pool_ms": pools,
                      "net_device_ms": nets,
                      "dram_gb_per_s": dram_rates(torch, _build, root)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
