#!/usr/bin/env python3
"""Time the streamed dense conv (K2), the fc-head matmul (K7/K8, int8
and its f32 and bf16 modes), the pools (K5, K6) and the attention
kernels' bf16 ``mma.sync`` routes (K9 at DeepSeek-V2's qk 192 / v 128,
K10/K11 at Phi-4-mini's shape) of a checkout of this repository, and the
device time of each net's forward, on one CUDA card: the probe that
holds two trees against each other in one call (PERF.md).

    python3 probe_stream.py [ROOT]

ROOT is the checkout whose ``src/repro_torch`` is timed (default: the one
holding this script); its kernels build into ROOT/build on first use.
Shapes: every streamed dense conv of ResNet-50 and VGG-16 compiled for
``NX2100`` at batch 8 (n_buffers 2, as the executor launches them), every
fc head of the six CNN configs in the mode the engine runs it (the float
modes also at VGG-16's fc0 streamed, f32 and bf16 at M = 8), every
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
import json
import subprocess
import sys
from pathlib import Path

BATCH = 8

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


def main():
    import torch
    if not torch.cuda.is_available():
        print("probe_stream: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parent).resolve()
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
    conv, mm = {}, {}
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
    for comp in comps.values():
        for sc in comp.plan.schedules:
            sp = sc.spec
            if select_engine(sp).name != "stream_matmul":
                continue
            mode = "fifo" if sc.streamed else "pinned"
            key = f"{mode}:{sp.c_in},{sp.c_out}"
            if key in mm:
                continue
            x, w = i8(BATCH, sp.c_in), i8(sp.c_in, sp.c_out)
            ws = torch.rand(sp.c_out, generator=g, device=dev) * 0.09 + 0.01
            b = torch.zeros(sp.c_out, device=dev)
            mm[key] = device_ms(torch, lambda: stream_matmul_requant(
                x, w, ws, b, 0.05, mode=mode, bk=_block(sp.c_in, 512),
                n_buffers=max(2, sc.n_buffers)), 20)
    from repro_torch.kernels.stream_matmul.ops import stream_matmul
    float_mm = {}
    for key in list(mm) + ["fifo:25088,4096"]:
        mode, kn = key.split(":")
        k_, n_ = map(int, kn.split(","))
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(BATCH, k_, generator=g, device=dev).to(dt)
            w = torch.randn(k_, n_, generator=g, device=dev).to(dt)
            float_mm[f"{key}:{str(dt)[6:]}"] = device_ms(
                torch, lambda: stream_matmul(x, w, mode=mode,
                                             bk=_block(k_, 512),
                                             n_buffers=2),
                5 if k_ == 25088 else 20)
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
