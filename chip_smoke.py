#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and when
it is run outside a checkout of the repository.  Phases, one line each:

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  2. hold every kernel against its plain PyTorch version on the card at
     every distinct main-path shape of the nets below compiled for
     ``NX2100`` at batch 8 (int8, f32 and int32 outputs bit-identical),
     and the depthwise kernels at every dw shape of MobileNetV1, V2 and
     V3, in both tiers (streamed with ``n_buffers`` in {1, 2, k*k});
  3. the slice: ``compile(cfg, NX2100)`` -> ``PipelineExecutor`` on the
     card at batch 8 on 224x224 inputs, with seeded random weights, for
     ResNet-50, ResNet-18, MobileNetV2 as compiled (every dw layer
     pinned) and MobileNetV2 with every dw layer forced onto the HBM tier
     (``with_offload``).  Launch counters are zeroed just before and read
     just after each forward; logits must equal the plain path's bit for
     bit and the Eq. 2 report must verify;
  4. time each kernel at the slice's shapes (CUDA events), its plain
     version, one PyTorch call computing the same function where there
     is one, and each net end to end;
  5. print the ``kernels`` JSON line, the card's name and power limit,
     and last ``{"ok": true, "device": ...}``.

Times are per slice run (one forward of each of the four nets above): a
kernel's ``ms`` sums its launches on that path (the record also splits
it per net).  Kernel, plain-version and library times are device times:
back-to-back calls captured into a CUDA graph and replayed.  The record
keeps beside them each kernel's time per call from Python, host
included, and each forward's eager time beside its device time (the
same forward replayed as a CUDA graph).  ``bound_ms`` is the larger of
the bytes it must move (inputs read once, outputs written once) over
3.35 TB/s and its int8 operations over 1,979 TOP/s (H100 SXM data
sheet).  A JSON record of the run goes to ``chiprun_out/chip_smoke.json``.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 8
SEED = 0
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

# kernel name -> (source, the Pallas kernel body it replaces)
KERNELS = {
    "conv2d_int8_pinned": ("src/repro_torch/kernels/csrc/conv2d_int8.cu",
                           "src/repro/kernels/conv2d_int8/kernel.py:64"),
    "conv2d_int8_stream": ("src/repro_torch/kernels/csrc/conv2d_int8.cu",
                           "src/repro/kernels/conv2d_int8/kernel.py:77"),
    "maxpool_int8": ("src/repro_torch/kernels/csrc/pool_int8.cu",
                     "src/repro/kernels/pool_int8/kernel.py:45"),
    "global_avgpool_int8": ("src/repro_torch/kernels/csrc/pool_int8.cu",
                            "src/repro/kernels/pool_int8/kernel.py:84"),
    "stream_matmul_pinned": ("src/repro_torch/kernels/csrc/stream_matmul.cu",
                             "src/repro/kernels/stream_matmul/kernel.py:59"),
    "stream_matmul_fifo": ("src/repro_torch/kernels/csrc/stream_matmul.cu",
                           "src/repro/kernels/stream_matmul/kernel.py:109"),
    "dwconv_int8_pinned": ("src/repro_torch/kernels/csrc/dwconv_int8.cu",
                           "src/repro/kernels/conv2d_int8/kernel.py:108"),
    "dwconv_int8_stream": ("src/repro_torch/kernels/csrc/dwconv_int8.cu",
                           "src/repro/kernels/conv2d_int8/kernel.py:124"),
}
# MobileNetV2 with every dw layer forced onto the HBM tier
MV2_DW_HBM = "mobilenetv2_dw_hbm"
# launches per MobileNetV2 forward, as compiled and with the dw layers on HBM
MV2_LAUNCHES = {"conv2d_int8_pinned": 35, "global_avgpool_int8": 1,
                "stream_matmul_pinned": 1}
EXPECTED = {"mobilenetv2": {**MV2_LAUNCHES, "dwconv_int8_pinned": 17},
            MV2_DW_HBM: {**MV2_LAUNCHES, "dwconv_int8_stream": 17}}


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, n):
    """ms on the card's clock from before the first to after the last of
    ``n`` calls of ``fn``."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def call_ms(torch, fn, reps, warm=2):
    """Mean ms per call over ``reps`` back-to-back calls from Python (L2
    warm): the host's dispatch included wherever it outlasts the work."""
    for _ in range(warm):
        fn()
    return event_ms(torch, fn, reps) / reps


def device_ms(torch, fn, reps, replays=5):
    """Mean device ms per call: ``reps`` calls captured into one CUDA
    graph, replayed ``replays`` times, so the host adds nothing between
    launches (L2 warm).  Relaxed capture, since the kernels' launchers
    query the device and set their shared-memory size as they launch."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    return event_ms(torch, graph.replay, replays) / (reps * replays)


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Kernel:
    """What the script learns about one kernel: its worst error against
    the plain version, and per main-path shape its launch count, time,
    plain time, library time and bound."""

    def __init__(self, name):
        self.name = name
        self.max_abs_err = 0.0
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.library_ms = None
        self.bytes = self.ops = 0

    def err(self, torch, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{self.name}: {got.dtype}{tuple(got.shape)}"
                                 f" vs plain {want.dtype}{tuple(want.shape)}")
        e = (got.to(torch.float64) - want.to(torch.float64)).abs().max()
        self.max_abs_err = max(self.max_abs_err, float(e))
        if not torch.equal(got, want):
            raise AssertionError(f"{self.name}: differs from its plain "
                                 f"version by up to {float(e)}")


def main_path_shapes(comp, select_engine):
    """Per kernel: {shape key: launches per forward} of one compiled net
    (what its engines will launch)."""
    shapes = {k: {} for k in KERNELS}

    def add(kernel, key):
        shapes[kernel][key] = shapes[kernel].get(key, 0) + 1

    last = comp.plan.cfg.layers[-1].name
    for s in comp.plan.schedules:
        sp = s.spec
        eng = select_engine(sp).name
        if eng == "conv2d_int8":
            add("conv2d_int8_stream" if s.streamed else
                "conv2d_int8_pinned",
                (sp.in_h, sp.in_w, sp.c_in, sp.c_out, sp.k_h, sp.stride,
                 s.n_buffers, sp.kind == "fc"))
        elif eng == "dwconv_int8":
            add("dwconv_int8_stream" if s.streamed else "dwconv_int8_pinned",
                (sp.in_h, sp.in_w, sp.c_in, sp.k_h, sp.stride, s.n_buffers))
        elif eng == "maxpool_int8":
            add("maxpool_int8", (sp.in_h, sp.in_w, sp.c_in, sp.k_h,
                                 sp.stride))
        elif eng == "global_avgpool_int8":
            add("global_avgpool_int8", (sp.in_h, sp.in_w, sp.c_in))
        elif eng == "stream_matmul":
            mode = "fifo" if s.streamed else "pinned"
            add(f"stream_matmul_{mode}",
                (sp.c_in, sp.c_out, max(2, s.n_buffers),
                 sp.name == last))
        else:
            raise AssertionError(f"{sp.name} bound to {eng}")
    return shapes


def dw_names(cfg):
    return {layer.name for layer in cfg.layers if layer.kind == "dwconv"}


def main():
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compiler import NX2100, compile, select_engine
    from repro_torch.configs.cnn import get_cnn
    from repro_torch.kernels import _build
    from repro_torch.compiler.engines import _block as block_for
    from repro_torch.kernels.conv2d_int8.ops import (conv2d_int8,
                                                     conv2d_int8_requant)
    from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_ref, same_pad
    from repro_torch.kernels.pool_int8.ops import (global_avgpool_int8,
                                                   maxpool_int8)
    from repro_torch.kernels.pool_int8.ref import (global_avgpool_int8_ref,
                                                   maxpool_int8_ref)
    from repro_torch.kernels.quant import requant_epilogue
    from repro_torch.kernels.stream_matmul.ops import (stream_matmul,
                                                       stream_matmul_requant)
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    from repro_torch.models.cnn import (cnn_forward, cnn_input_shape,
                                        init_cnn_params)
    from repro_torch.runtime.pipeline import PipelineExecutor

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    record = {"card": card, "batch": BATCH, "seed": SEED}

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    record["build_s"] = time.perf_counter() - t0
    log("build", f"{len(_build.SOURCES)} sources built with nvcc in "
        f"{record['build_s']:.1f} s")

    nets = {n: compile(get_cnn(n), NX2100)
            for n in ("resnet50", "resnet18", "mobilenetv2")}
    mv2 = nets["mobilenetv2"]
    nets[MV2_DW_HBM] = mv2.with_offload(set(mv2.streamed_names)
                                        | dw_names(mv2.cfg))
    per_net = {n: main_path_shapes(c, select_engine)
               for n, c in nets.items()}
    shapes = {k: {} for k in KERNELS}           # per slice run (both nets)
    for per in per_net.values():
        for k, d in per.items():
            for key, v in d.items():
                shapes[k][key] = shapes[k].get(key, 0) + v
    ks = {k: Kernel(k) for k in KERNELS}
    g = torch.Generator(device=dev).manual_seed(SEED)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8,
                             device=dev)

    def scales(n):
        return (torch.rand(n, generator=g, device=dev) * 0.09 + 0.01,
                torch.zeros(n, device=dev))

    # -- 2. every kernel against its plain version ---------------------------
    t0 = time.perf_counter()
    conv_inputs = {}
    n_checks = 0
    for kname in ("conv2d_int8_pinned", "conv2d_int8_stream"):
        for key in shapes[kname]:
            h, w_, c, co, k, s, _, _ = key
            if key[:6] not in conv_inputs:
                conv_inputs[key[:6]] = (i8(BATCH, h, w_, c), i8(k, k, c, co),
                                        *scales(co))
    for key6, (x, w, ws, b) in conv_inputs.items():
        k = key6[4]
        s = key6[5]
        want = conv2d_int8_ref(x, w, stride=s)
        want_q, want_f = requant_epilogue(want, ws, b, 0.05, True)
        got = conv2d_int8(x, w, stride=s)
        ks["conv2d_int8_pinned"].err(torch, got, want)
        gq, gf = conv2d_int8_requant(x, w, ws, b, 0.05, stride=s,
                                     want_float=True)
        ks["conv2d_int8_pinned"].err(torch, gq, want_q)
        ks["conv2d_int8_pinned"].err(torch, gf, want_f)
        for nb in sorted({1, 2, k * k}):
            got = conv2d_int8(x, w, stride=s, stream=True, n_buffers=nb)
            ks["conv2d_int8_stream"].err(torch, got, want)
            n_checks += 1
        gq, _ = conv2d_int8_requant(x, w, ws, b, 0.05, stride=s, stream=True)
        ks["conv2d_int8_stream"].err(torch, gq, want_q)
        n_checks += 3
    for key in shapes["maxpool_int8"]:
        h, w_, c, k, s = key
        x = i8(BATCH, h, w_, c)
        ks["maxpool_int8"].err(torch, maxpool_int8(x, k=k, stride=s),
                               maxpool_int8_ref(x, k=k, stride=s))
        n_checks += 1
    for key in shapes["global_avgpool_int8"]:
        h, w_, c = key
        x = i8(BATCH, h, w_, c)
        for act in (0.05, 0.1):
            ks["global_avgpool_int8"].err(
                torch, global_avgpool_int8(x, act_scale=act),
                global_avgpool_int8_ref(x, act_scale=act))
            n_checks += 1
    fc_shapes = {key[:2] for m in ("pinned", "fifo")
                 for key in shapes[f"stream_matmul_{m}"]}
    for c_in, c_out in sorted(fc_shapes):
        x, w = i8(BATCH, c_in), i8(c_in, c_out)
        ws, b = scales(c_out)
        want = stream_matmul_ref(x, w)
        want_q, want_f = requant_epilogue(want, ws, b, 0.05, False)
        bk = block_for(c_in, 512)
        for mode in ("pinned", "stream", "fifo"):
            kname = ("stream_matmul_fifo" if mode == "fifo"
                     else "stream_matmul_pinned")
            for nb in ((2, 3, 4) if mode == "fifo" else (2,)):
                got = stream_matmul(x, w, mode=mode, bk=bk, n_buffers=nb)
                ks[kname].err(torch, got, want)
                gq, gf = stream_matmul_requant(x, w, ws, b, 0.05, relu=False,
                                               mode=mode, bk=bk, n_buffers=nb)
                ks[kname].err(torch, gq, want_q)
                ks[kname].err(torch, gf, want_f)
                n_checks += 3
    dw_shapes = set()                 # every dw shape of MobileNetV1-V3
    for n in ("mobilenetv1", "mobilenetv2", "mobilenetv3"):
        comp = nets[n] if n in nets else compile(get_cnn(n), NX2100)
        dw_shapes |= {(s.spec.in_h, s.spec.in_w, s.spec.c_in, s.spec.k_h,
                       s.spec.stride) for s in comp.plan.schedules
                      if select_engine(s.spec).name == "dwconv_int8"}
    dw_inputs = {}
    for key5 in sorted(dw_shapes):
        h, w_, c, k, s = key5
        x, w = i8(BATCH, h, w_, c), i8(k, k, 1, c)
        ws = torch.rand(c, generator=g, device=dev) * 0.09 + 0.01
        b = torch.randn(c, generator=g, device=dev)
        dw_inputs[key5] = (x, w, ws, b)
        want = conv2d_int8_ref(x, w, stride=s, depthwise=True)
        want_q, want_f = requant_epilogue(want, ws, b, 0.05, True)
        for kname, stream, nbs in (("dwconv_int8_pinned", False, (2,)),
                                   ("dwconv_int8_stream", True,
                                    sorted({1, 2, k * k}))):
            for nb in nbs:
                ks[kname].err(torch, conv2d_int8(
                    x, w, stride=s, stream=stream, n_buffers=nb,
                    depthwise=True), want)
                gq, gf = conv2d_int8_requant(
                    x, w, ws, b, 0.05, stride=s, stream=stream, n_buffers=nb,
                    depthwise=True, want_float=True)
                ks[kname].err(torch, gq, want_q)
                ks[kname].err(torch, gf, want_f)
                n_checks += 3
    torch.cuda.synchronize()
    record["check_s"] = time.perf_counter() - t0
    log("check", f"{n_checks} kernel-vs-plain comparisons bit-identical "
        f"({len(conv_inputs)} conv shapes; {len(dw_inputs)} dw shapes of "
        f"MobileNetV1-V3; stream n_buffers in {{1, 2, k*k}}; matmul "
        f"pinned/stream/fifo) in {record['check_s']:.1f} s")

    # -- 3. the slice through the kernels ------------------------------------
    params, images, logits = {}, {}, {}
    launches = {}
    for name, comp in nets.items():
        cfg = comp.cfg
        gen = torch.Generator().manual_seed(SEED)
        params[name] = init_cnn_params(cfg, gen, dev)
        images[name] = torch.randint(-127, 128, cnn_input_shape(cfg, BATCH),
                                     generator=gen, dtype=torch.int8).to(dev)
    ex = {n: PipelineExecutor(c, device=dev) for n, c in nets.items()}
    reports = {}
    for name in nets:
        _build.reset_launches()
        logits[name], reports[name] = ex[name].run(params[name],
                                                   images[name])
        torch.cuda.synchronize()
        launches[name] = dict(_build.LAUNCHES)
        log("slice", f"{name} launches per forward: "
            f"{json.dumps(launches[name], sort_keys=True)}")
    for name, comp in nets.items():
        want = {k: sum(d.values()) for k, d in per_net[name].items() if d}
        if launches[name] != want or launches[name] != EXPECTED.get(
                name, want):
            raise AssertionError(f"{name}: launches {launches[name]} != "
                                 f"plan {want} / expected "
                                 f"{EXPECTED.get(name)}")
        lg, rep = logits[name], reports[name]
        classes = comp.cfg.num_classes
        if lg.shape != (BATCH, classes) or not torch.isfinite(lg).all():
            raise AssertionError(f"{name}: logits {tuple(lg.shape)}")
        plain = cnn_forward(params[name], comp.cfg, images[name])
        if not torch.equal(lg, plain):
            diff = (lg - plain).abs().max().item()
            raise AssertionError(f"{name}: logits differ from the plain "
                                 f"path by up to {diff}")
        rep.verify()
        comp.eq2_report(batch=BATCH).verify()
        plan_words = sum(comp.plan.hbm_words_per_image().values()) * BATCH
        if rep.total_hbm_words != plan_words:
            raise AssertionError(f"{name}: {rep.total_hbm_words} streamed "
                                 f"words != plan {plan_words}")
        log("slice", f"{name}: logits {tuple(lg.shape)} bit-identical to "
            f"the plain path on the card; Eq. 2 verified; streamed words "
            f"{rep.total_hbm_words} = {plan_words // BATCH} x {BATCH}")
    total_launches = {}
    for per in launches.values():
        for k, v in per.items():
            total_launches[k] = total_launches.get(k, 0) + v
    missing = [k for k in KERNELS if not total_launches.get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on the path: "
                             f"{missing}")
    record["launches"] = launches

    # -- 4. timing ------------------------------------------------------------
    t0 = time.perf_counter()
    per_launch = {k: {} for k in KERNELS}  # kernel -> shape key -> device ms
    per_call = {k: {} for k in KERNELS}    # ... -> ms per call from Python

    def time_kernel(kname, keys, fn):
        t, tc = device_ms(torch, fn, reps=20), call_ms(torch, fn, reps=20)
        for key in keys:
            per_launch[kname][key], per_call[kname][key] = t, tc

    def plain_ms(fn):
        return device_ms(torch, fn, reps=3, replays=2)

    for key6, (x, w, ws, b) in conv_inputs.items():
        h, w_, c, co, k, s = key6
        for kname, stream in (("conv2d_int8_pinned", False),
                              ("conv2d_int8_stream", True)):
            keys = [kk for kk in shapes[kname] if kk[:6] == key6]
            if not keys:
                continue
            n = sum(shapes[kname][kk] for kk in keys)
            ho, wo = -(-h // s), -(-w_ // s)
            fc = any(kk[7] for kk in keys)
            kern = ks[kname]
            time_kernel(kname, keys, lambda: conv2d_int8_requant(
                x, w, ws, b, 0.05, stride=s, stream=stream, n_buffers=2,
                want_float=fc))
            kern.plain_ms += n * plain_ms(lambda: requant_epilogue(
                conv2d_int8_ref(x, w, stride=s), ws, b, 0.05, True))
            nbytes = x.numel() + w.numel() + 8 * co + BATCH * ho * wo * co \
                * (5 if fc else 1)
            kern.bytes += n * nbytes
            kern.ops += n * 2 * BATCH * ho * wo * co * k * k * c
    torch.backends.cudnn.allow_tf32 = False    # exact fp32 library conv
    for kname, stream in (("dwconv_int8_pinned", False),
                          ("dwconv_int8_stream", True)):
        kern = ks[kname]
        kern.library_ms = 0.0
        for key, n in shapes[kname].items():
            h, w_, c, k, s, nb = key
            x, w, ws, b = dw_inputs[key[:5]]
            time_kernel(kname, [key], lambda: conv2d_int8_requant(
                x, w, ws, b, 0.05, stride=s, stream=stream, n_buffers=nb,
                depthwise=True))
            kern.plain_ms += n * plain_ms(lambda: requant_epilogue(
                conv2d_int8_ref(x, w, stride=s, depthwise=True), ws, b,
                0.05, True))
            # the library: cuDNN's grouped conv on a float32 channels-last
            # copy of the pre-padded input; every sum is below 2^24, so it
            # is exact.  Timed without the pad and without the requant.
            xp = same_pad(x, k, k, s).to(torch.float32).permute(0, 3, 1, 2)
            wf = w.to(torch.float32).permute(3, 2, 0, 1).contiguous()
            lib_out = F.conv2d(xp, wf, stride=s, groups=c)
            want = conv2d_int8_ref(x, w, stride=s, depthwise=True)
            if not torch.equal(lib_out.permute(0, 2, 3, 1).to(torch.int32),
                               want):
                raise AssertionError(f"{kname} {key}: the library's fp32 "
                                     f"depthwise conv is not exact")
            kern.library_ms += n * device_ms(
                torch, lambda: F.conv2d(xp, wf, stride=s, groups=c), reps=20)
            ho, wo = -(-h // s), -(-w_ // s)
            kern.bytes += n * (x.numel() + w.numel() + 8 * c
                               + BATCH * ho * wo * c)
            kern.ops += n * 2 * BATCH * ho * wo * c * k * k
    for key, n in shapes["maxpool_int8"].items():
        h, w_, c, k, s = key
        x = i8(BATCH, h, w_, c)
        kern = ks["maxpool_int8"]
        time_kernel("maxpool_int8", [key],
                    lambda: maxpool_int8(x, k=k, stride=s))
        kern.plain_ms += n * plain_ms(lambda: maxpool_int8_ref(x, k=k,
                                                               stride=s))
        ho, wo = -(-h // s), -(-w_ // s)
        kern.bytes += n * (x.numel() + BATCH * ho * wo * c)
        kern.ops += n * BATCH * ho * wo * c * k * k
    for key, n in shapes["global_avgpool_int8"].items():
        h, w_, c = key
        x = i8(BATCH, h, w_, c)
        kern = ks["global_avgpool_int8"]
        time_kernel("global_avgpool_int8", [key],
                    lambda: global_avgpool_int8(x, act_scale=0.05))
        kern.plain_ms += n * plain_ms(
            lambda: global_avgpool_int8_ref(x, act_scale=0.05))
        kern.bytes += n * (x.numel() + BATCH * c)
        kern.ops += n * BATCH * h * w_ * c
    for mode in ("pinned", "fifo"):
        kname = f"stream_matmul_{mode}"
        kern = ks[kname]
        lib = 0.0
        for key, n in shapes[kname].items():
            c_in, c_out, nb, last = key
            x, w = i8(BATCH, c_in), i8(c_in, c_out)
            ws, b = scales(c_out)
            bk = block_for(c_in, 512)
            time_kernel(kname, [key], lambda: stream_matmul_requant(
                x, w, ws, b, 0.05, relu=not last, mode=mode, bk=bk,
                n_buffers=nb, want_float=last))
            kern.plain_ms += n * plain_ms(lambda: requant_epilogue(
                stream_matmul_ref(x, w), ws, b, 0.05, not last))
            kern.bytes += n * (x.numel() + w.numel() + 8 * c_out
                               + BATCH * c_out * (5 if last else 1))
            kern.ops += n * 2 * BATCH * c_in * c_out
            if lib is None:
                continue
            try:                       # the library's int8 GEMM, if it
                lib += n * device_ms(  # takes this shape (M=8 may not)
                    torch, lambda: torch._int_mm(x, w), reps=20)
            except RuntimeError as e:
                lib = None
                log("time", f"torch._int_mm refuses [{BATCH},{c_in}]x"
                    f"[{c_in},{c_out}]: {str(e).splitlines()[0][:120]}")
        kern.library_ms = lib
    for name, kern in ks.items():
        kern.ms = sum(n * per_launch[name][key]
                      for key, n in shapes[name].items())
        kern.bound_ms, kern.bound_by = bound_ms(kern.bytes, kern.ops)
    record["ms_per_launch"], record["call_ms_per_launch"] = (
        {k: {",".join(map(str, key)): t for key, t in d.items()}
         for k, d in times.items()} for times in (per_launch, per_call))
    record["kernel_ms_by_net"], record["kernel_call_ms_by_net"] = (
        {net: {k: sum(n * times[k][key] for key, n in d.items())
               for k, d in per.items() if d}
         for net, per in per_net.items()} for times in (per_launch, per_call))

    e2e = {}
    for name, comp in nets.items():
        run = lambda: ex[name].run(params[name], images[name])  # noqa: E731
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        plain_t = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            cnn_forward(params[name], comp.cfg, images[name])
            torch.cuda.synchronize()
            plain_t.append((time.perf_counter() - t) * 1e3)
        # the same forward as one CUDA graph: its device time, and the
        # share of the eager forward the card sits idle
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            graph_logits, _ = run()
        graph.replay()
        if not torch.equal(graph_logits, logits[name]):
            raise AssertionError(f"{name}: the replayed forward's logits "
                                 f"differ from the eager run's")
        dev_ms = event_ms(torch, graph.replay, 10) / 10
        ms = statistics.median(times[1:])
        e2e[name] = {"ms_per_forward": ms, "images_per_s": BATCH / ms * 1e3,
                     "device_ms_per_forward": dev_ms,
                     "idle_share": 1 - dev_ms / ms,
                     "plain_ms_per_forward": statistics.median(plain_t),
                     "runs_ms": times}
        log("time", f"{name} batch {BATCH}: {ms:.3f} ms per forward "
            f"(warm median of {len(times) - 1}), "
            f"{BATCH / ms * 1e3:.1f} images/s; device {dev_ms:.3f} ms "
            f"(card idle {100 * (1 - dev_ms / ms):.0f}% of the forward); "
            f"plain path {e2e[name]['plain_ms_per_forward']:.3f} ms  "
            f"[{card}]")
    record["end_to_end"] = e2e
    record["time_s"] = time.perf_counter() - t0

    # -- 5. report ------------------------------------------------------------
    rows = []
    for name, kern in ks.items():
        src, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": total_launches[name],
                     "max_abs_err": kern.max_abs_err, "ms": kern.ms,
                     "plain_ms": kern.plain_ms, "bound_ms": kern.bound_ms,
                     "bound_by": kern.bound_by,
                     "library_ms": kern.library_ms})
        log("time", f"{name}: {kern.ms:.4f} ms per slice run (device), "
            f"plain {kern.plain_ms:.4f} ms, bound {kern.bound_ms:.4f} ms "
            f"({kern.bound_by}), library {kern.library_ms}  [{card}]")
    record["kernels"] = rows
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
