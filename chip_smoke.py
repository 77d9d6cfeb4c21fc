#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and when
it is run outside a checkout of the repository.  Phases, one line each:

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``, and
     beside them ``nvcc -Xptxas -v`` on ``dwconv_int8.cu``,
     ``conv2d_int8.cu``, ``flash_attention.cu``, ``stream_matmul.cu``
     (the int8 ``mm_kernel`` and the float ``mm_float`` instances) and
     ``pool_int8.cu``: registers, stack and spills of every kernel
     instance (full logs ``ptxas_dwconv.log``, ``ptxas_conv.log``,
     ``ptxas_flash.log``, ``ptxas_matmul.log`` and ``ptxas_pool.log`` in
     the output directory), and from the SASS the
     count of HGMMA, HMMA, IMMA and IDP instructions of each instance and
     the instructions a MAC of each 3x3 ``dw_kernel``'s MAC block; it
     fails unless the instance each main-path launch of K1 (``conv_mma``),
     K2 (``conv_stream``, from the conv plans of its shape) and K9
     (``flash_fwd_wgmma<128>``, from the flash route of Phi-4-mini's head
     dims) takes issues IMMA or HGMMA, and where a K2 instance spills;
  2. hold every kernel against its plain PyTorch version on the card: the
     streamed dense conv (K2) at every dense conv shape of the six CNN
     configs compiled for ``NX2100`` at batch 8, forced onto the streamed
     tier with ``n_buffers`` in {1, 2, k*k}, the pinned one (K1) at every
     shape a config pins, the fc-head matmul (K7/K8) at every fc shape of
     the six configs in its pinned, stream and fifo modes, the pools at
     the main path's shapes and at edge shapes (odd maps, k = 3 at
     stride 1, the generic window, C of 4, 6 and 20) (int8, f32 and int32
     outputs bit-identical); the float matmul (``mm_float``) at
     ``FLOAT_CHECK_SHAPES`` in f32 and bf16 in every mode, the fifo ring
     1 to 4 deep, mixed f32 x bf16 operands, and every fc shape at M = 8,
     each output of the promoted type and within ``FLOAT_TOL``;
     the depthwise kernels at every dw shape of MobileNetV1, V2 and V3 in
     both tiers (streamed with ``n_buffers`` in {1, 2, k*k}); the
     flash-attention forward (o and lse) at the LM slice's prefill shape,
     at S = 2048, at the five ``ATTN_CASES`` of ``tests/test_kernels.py``
     and at hd=192/hd_v=128, in bf16 and f32, within ``FLASH_TOL`` (per
     dtype and output; lse to 1e-4); the flash-attention backward (K10:
     dq; K11: dk, dv) at the same shapes and dtypes on K9's o and lse,
     within ``BWD_TOL``; their f32 sums (bf16 operands, f32 outputs)
     against the plain backward on the f32 casts of the same operands at
     ``BWD_SUM_CASES``, within ``BWD_SUM_TOL``, which sees below bf16's
     precision; and the differentiable ``flash_attention_vjp`` against
     autograd through the plain forward at ``VJP_CASES``;
  3. the slices: ``compile(cfg, NX2100)`` -> ``PipelineExecutor(...,
     backend="eager")`` on the card at batch 8 on 224x224 inputs, with
     seeded random weights, for ResNet-50, ResNet-18, MobileNetV2 as
     compiled (every dw layer pinned), VGG-16 (conv8-10 and fc0 on the
     streamed conv, fc1 and fc2 on the fifo matmul) and MobileNetV2 with
     every dw layer forced onto the HBM tier (``with_offload``): logits
     equal to the plain path's bit for bit (the plain path's time logged),
     the Eq. 2 report verified.  Then the main path, the same five nets
     through ``run()``'s default, the fused backend (the forward captured
     once as a CUDA graph, replayed by every warm run): logits and report
     equal to the eager run's, the launches of a warm run (added by the
     replay) equal to the eager run's, one trace a net with its hits
     counted.  Then ResNet-50 served over it (``cp.serve(microbatch=8,
     credits=4)``): 64 requests of 1-8 images from 4 producer threads,
     each bit-identical to the eager ``run()`` of its images, at most 4
     microbatches in flight, one trace, the Eq. 2 words of the images,
     microbatches x a forward's launches; images/s, latency percentiles,
     pad fraction, the measured stall fractions and the host spans of the
     traced interval beside the ceiling of 8 images a replay of the
     forward's graph; then the adaptive ladder (1, 2, 4, 8) at light
     load, its rungs captured mid-serve, bit-identical.
     Then Phi-4-mini (3.8B, full width and depth, bf16, random weights
     from seed 0) through ``ServingEngine(batch_slots=4, max_seq=1024)``:
     8 requests of 512 tokens, 16 new tokens each; exactly 64
     flash-attention launches (2 prefills x 32 layers); prefill logits
     within 2e-2 x max|logit| of the plain path (kernel mode off); the
     first token equal to the plain path's wherever its top-2 margin
     exceeds that bound.  Then Phi-4-mini training, with the serving
     phase's weights freed: one ``loss_fn`` gradient on the first batch
     with kernel mode on and off (loss within ``LOSS_REL_TOL``, every leaf
     within ``GRAD_REL_TOL``, L2), then ``Trainer.run`` for 3 steps of
     4x512 tokens (AdamW, remat, no checkpoint): exactly 64 K9, 32 K10 and
     32 K11 launches a step and a finite loss and grad norm at every step.
     Then the float matmul's path: ``stream_matmul`` at every fc head of
     the six configs as a matmul at M = 8, in the mode its engine runs,
     and VGG-16's fc0 as a 25088 x 4096 matmul streamed, in f32 and bf16:
     launches of ``stream_matmul_float_pinned`` and ``_fifo`` counted,
     outputs of the promoted type within ``FLOAT_TOL`` of the plain path.
     Launch counters are zeroed just before and read just after each run;
  4. time each kernel at the slice's shapes, its plain version, one
     PyTorch call computing the same function where there is one
     (``F.max_pool2d(ceil_mode=True)`` for the maxpool, whose SAME padding
     lies after the data at every main-path shape; ``torch.matmul`` in
     the operands' type, TF32 off, for the float matmul; beside the
     global average pool the launch floor, a graph-replayed one-element
     ``add_``; ``torch._int_mm`` for the 1x1 convs; for the fc heads and
     VGG-16's
     fc0, a [B, K] x [K, N] product, on x padded with zero rows to M = 32,
     since it refuses M <= 16 and no float conv is exact past 2^24; the
     faster exact of cuDNN's fp32 and TF32 conv for the other dense
     convs; cuDNN's fp32 conv for the depthwise conv;
     ``scaled_dot_product_attention`` for attention, its backward for the
     K10/K11 pair), each net end to end, the LM's prefill, decode step and
     engine run, and the training step (eager ms of steps 2-3, and one
     more step traced by ``torch.profiler`` for its device ms);
  5. print the ``kernels`` JSON line, the card's name and power limit,
     and last ``{"ok": true, "device": ...}``.

Times are per slice run (one forward of each of the five nets, and the
LM's engine run and 3 training steps; ``launches`` counts the fused warm run
of each net): a kernel's ``ms`` sums its
launches on that path (the record also splits it per net and per
launch; for the dense and the depthwise kernels, per shape, the bytes,
bound and library time beside the time a launch, ``conv_per_shape`` with
the plan and each library call's time and whether its output equals the
int32 sums, the streamed conv's bytes read from device memory beside the
Eq. 2 words, ``matmul_per_shape`` likewise, and ``dw_per_shape``).  K10
and K11 share one plain version and one library call, which compute dq,
dk and dv together: each row carries the pair's time.
Kernel, plain-version and library times are device times: back-to-back
calls captured into a CUDA graph and replayed.  The record keeps beside them each kernel's time
per call from Python, host included, and each forward's eager and fused
times (host clock, in turns) beside its device time (the same forward
replayed as a CUDA graph).
``bound_ms`` is the larger of the bytes it must move (inputs read once,
of a windowed map only the rows and columns some window covers; outputs
written once) over 3.35 TB/s and its operations over 1,979 TOP/s
int8, 989 TFLOP/s bf16 or 67 TFLOP/s FP32 on the CUDA cores (the f32
matmul; H100 SXM data sheet; causal attention counts
half of 4·B·H·S²·hd, K10 3 and K11 4 products of 2·B·H·S²·hd, halved
when causal).  ``library_ms`` covers ``library_launches`` of
the kernel's launches, on which the kernel takes
``ms_on_library_launches``.  A JSON record of
the run goes to ``chip_smoke.json`` in the output directory beside this
script.
"""
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 8
# phase 2 takes seconds; a kernel that never finishes (a ring whose
# barriers lost step) fails it after this long instead of hanging the run
CHECK_LIMIT_S = 120
SEED = 0
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
BF16_FLOPS_PER_S = 9.89e14
FP32_FLOPS_PER_S = 6.7e13      # FFMA on the CUDA cores, no TF32

# the LM slice: Phi-4-mini at full width and depth, bf16, served with
# ServingEngine(batch_slots=4, max_seq=1024): 8 prompts of 512 tokens
LM_ARCH = "phi4-mini-3.8b"
LM_SLOTS, LM_MAX_SEQ, LM_REQUESTS, LM_PROMPT, LM_NEW = 4, 1024, 8, 512, 16
LM_REL_TOL = 2e-2        # prefill logits: kernel path vs plain path
# K9 against its plain version: (B, H, KV, S, hd, hd_v, causal, window,
# softcap).  The slice's prefill shape, S = 2048, the five ATTN_CASES of
# tests/test_kernels.py, and one hd != hd_v case.
FLASH_SLICE = (LM_SLOTS, 24, 8, LM_PROMPT, 128, 128, True, 0, 0.0)
FLASH_LONG = (LM_SLOTS, 24, 8, 2048, 128, 128, True, 0, 0.0)
FLASH_CASES = [FLASH_SLICE, FLASH_LONG,
               (2, 4, 4, 256, 64, 64, True, 0, 0.0),
               (2, 4, 2, 256, 64, 64, True, 64, 0.0),
               (1, 8, 2, 128, 32, 32, True, 0, 50.0),
               (1, 2, 2, 128, 64, 64, False, 0, 0.0),
               (1, 4, 1, 128, 128, 128, True, 32, 30.0),
               (1, 4, 2, 256, 192, 128, True, 0, 0.0)]
# (rtol, atol) per operand dtype and output, set from the readings of
# earlier runs (PERF.md): bf16 o differs from the plain version by at most
# one bf16 ulp where the two orders of summation round apart (3.9e-3 at
# |o| in [0.5, 1)), and rtol 1e-2 covers one ulp at any magnitude; f32 o
# keeps tests/test_kernels.py's limits; lse is f32 in both dtypes and
# differs by about one f32 ulp (1e-6 at lse ~ 8).
FLASH_TOL = {("bfloat16", "o"): (1e-2, 1e-2), ("float32", "o"): (2e-5, 6e-5),
             ("bfloat16", "lse"): (1e-5, 1e-4),
             ("float32", "lse"): (1e-5, 1e-4)}
FLASH_DTYPES = ("bfloat16", "float32")
# K10/K11 against flash_attention_bwd_plain, at FLASH_CASES (the training
# shape is FLASH_SLICE) in both dtypes: (rtol, atol as a share of the
# output's max |value|) per operand dtype and output.  Both sides sum in
# f32 (in other orders) and round once to the operand dtype.  Set from
# the readings of the first runs (PERF.md): bf16 within one bf16 ulp
# (worst 0.58 of this limit), f32 within a few f32 ulps of the max (worst
# 0.044 of a limit five times this one)
BWD_TOL = {(d, out): tol for out in ("dq", "dk", "dv")
           for d, tol in (("bfloat16", (1e-2, 1e-3)),
                          ("float32", (2e-5, 2e-6)))}
# K10/K11's f32 sums (bf16 operands, f32 outputs: the accumulators before
# their rounding) against flash_attention_bwd_plain on the f32 casts of the
# same operands, at the training shape and a softcap + GQA case: (rtol,
# atol as a share of the output's max |value|).  Both sides take every
# product exactly in f32 and differ by the order of the f32 additions and
# the scale taken per element.  bf16 outputs hide any error under 2^-9,
# so a split of p and ds that drops its lo part passes BWD_TOL.  Set from
# the card's readings (PERF.md): the kernels read at most 0.49 of this
# limit, a copy of them that drops the lo part 1.37 of it
BWD_SUM_CASES = (FLASH_SLICE, (1, 4, 1, 128, 128, 128, True, 32, 30.0))
BWD_SUM_TOL = (1e-5, 1e-6)
# flash_attention_vjp (K9 + K10/K11 + the GQA fold) against autograd
# through flash_attention_plain, share of max |grad|: the plain forward
# rounds p to bf16 before PV and autograd differentiates that rounding
# (worst 0.35 of the bf16 limit; f32 0.012 of a limit five times this one)
VJP_REL_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
VJP_CASES = (FLASH_SLICE, (1, 8, 2, 128, 32, 32, True, 0, 50.0))

# the LM training slice: Phi-4-mini at full width and depth, bf16, random
# weights from SEED, TokenDataset(seq_len=512, global_batch=4), 3 steps of
# TrainConfig(microbatches=1, remat=True), no checkpoint written
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 512, 4, 3
# launches per training step: K9 twice a layer (forward, then the remat
# recompute), K10 and K11 once a layer
TRAIN_LAUNCHES = {"flash_attention_fwd": 64, "flash_attention_bwd_dq": 32,
                  "flash_attention_bwd_dkv": 32}
# kernel-on against kernel-off (blockwise attention) loss_fn on the same
# params and batch: the loss within LOSS_REL_TOL relative, each leaf's
# |g_on - g_off| / |g_off| (L2) within GRAD_REL_TOL.  Five times the JAX
# package's own gaps between its two routes on reduced Phi-4-mini in bf16
# (loss 1.4e-4 relative, worst leaf 1.42e-2), for 32 layers instead of 2,
# as LM_REL_TOL was derived
LOSS_REL_TOL, GRAD_REL_TOL = 1e-3, 0.07

# the float matmul (mm_float) against its plain version: tests/
# test_kernels.py's limits, rtol and a share of max |ref| as atol, by the
# output's type (f32 for f32 and mixed operands, bf16 for bf16 x bf16)
FLOAT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# tests/test_kernels.py's MM_SHAPES and a ragged shape
FLOAT_CHECK_SHAPES = [(128, 256, 128), (256, 1024, 384), (128, 512, 256),
                      (17, 100, 36)]
# VGG-16's fc0 as a matmul at M = 8: 205 MB of bf16 weights, beyond the L2
FC0_MATMUL = (BATCH, 7 * 7 * 512, 4096)
# the pools' edge shapes, held against their plain versions in phase 2:
# maxpool (B, H, W, C, k, s) and global average pool (B, H, W, C)
MAXPOOL_EDGES = [(2, 13, 11, 64, 3, 2), (2, 9, 7, 20, 3, 1),
                 (3, 7, 9, 4, 2, 2), (2, 15, 17, 64, 3, 1),
                 (2, 10, 9, 20, 5, 2), (1, 6, 5, 4, 3, 2)]
GAP_EDGES = [(2, 3, 5, 20), (3, 4, 4, 6), (2, 1, 1, 64), (1, 56, 56, 48)]

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
    "stream_matmul_float_pinned": (
        "src/repro_torch/kernels/csrc/stream_matmul.cu",
        "src/repro/kernels/stream_matmul/kernel.py:59"),
    "stream_matmul_float_fifo": (
        "src/repro_torch/kernels/csrc/stream_matmul.cu",
        "src/repro/kernels/stream_matmul/kernel.py:109"),
    "dwconv_int8_pinned": ("src/repro_torch/kernels/csrc/dwconv_int8.cu",
                           "src/repro/kernels/conv2d_int8/kernel.py:108"),
    "dwconv_int8_stream": ("src/repro_torch/kernels/csrc/dwconv_int8.cu",
                           "src/repro/kernels/conv2d_int8/kernel.py:124"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:32"),
    "flash_attention_bwd_dq": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/kernel.py:147"),
    "flash_attention_bwd_dkv": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention/kernel.py:179"),
}
LM_KERNEL = "flash_attention_fwd"
BWD_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
FLOAT_MM_KERNELS = ("stream_matmul_float_pinned", "stream_matmul_float_fifo")
CNN_KERNELS = [k for k in KERNELS if k != LM_KERNEL
               and k not in BWD_KERNELS + FLOAT_MM_KERNELS]
# MobileNetV2 with every dw layer forced onto the HBM tier
MV2_DW_HBM = "mobilenetv2_dw_hbm"
# launches per MobileNetV2 forward, as compiled and with the dw layers on HBM
MV2_LAUNCHES = {"conv2d_int8_pinned": 35, "global_avgpool_int8": 1,
                "stream_matmul_pinned": 1}
EXPECTED = {"mobilenetv2": {**MV2_LAUNCHES, "dwconv_int8_pinned": 17},
            MV2_DW_HBM: {**MV2_LAUNCHES, "dwconv_int8_stream": 17}}
# CNN serving: ResNet-50 (7 layers streamed, K2 and K8 on the path) under
# cp.serve(microbatch=BATCH, credits=4): 64 requests of 1-8 images (sizes
# from SEED) from 4 producer threads; then the adaptive ladder (1, 2, 4,
# 8) at light load, closed loop over ADAPTIVE_SIZES, and a burst
SERVE_NET, SERVE_REQUESTS, SERVE_PRODUCERS, SERVE_CREDITS = \
    "resnet50", 64, 4, 4
ADAPTIVE_SIZES = (1, 2, 1, 3, 5, 8, 2)
# a longer interval of the same traffic, for the steady state
SERVE_STEADY_REPEATS = 8
FUSED_WARM_RUNS = 6


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


def bound_ms(nbytes, ops, ops_per_s=INT8_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


class Kernel:
    """What the script learns about one kernel: its worst error against
    the plain version, and per main-path shape its launch count, time,
    plain time, library time and bound."""

    def __init__(self, name, ops_per_s=INT8_OPS_PER_S):
        self.name = name
        self.max_abs_err = 0.0
        self.readings = {}
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.library_ms = None
        # (launches, kernel ms over them) where library_ms covers only
        # some of the kernel's launches
        self.library_covers = None
        self.bytes = self.ops = 0
        self.ops_per_s = ops_per_s
        self.floor_ms = None          # a launch's floor, where it is timed

    def err(self, torch, got, want, tol=None, key=None):
        """Bit identity (the int8 kernels), or with ``tol = (rtol, atol)``
        |got - want| <= atol + rtol |want| everywhere (the float kernel).
        The worst error is kept, and under ``key`` (operand dtype and
        output) also the worst error and the largest share of the limit
        it used."""
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{self.name}: {got.dtype}{tuple(got.shape)}"
                                 f" vs plain {want.dtype}{tuple(want.shape)}")
        diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
        e = float(diff.max()) if diff.numel() else 0.0
        self.max_abs_err = max(self.max_abs_err, e)
        if tol is None:
            ok = torch.equal(got, want)
        else:
            rtol, atol = tol
            share = float((diff / (atol + rtol * want.to(torch.float64).abs()))
                          .max()) if diff.numel() else 0.0
            ok = share <= 1.0 and bool(torch.isfinite(got).all())
            if key is not None:
                r = self.readings.setdefault(key, {"max_abs_err": 0.0,
                                                   "max_share_of_limit": 0.0,
                                                   "rtol": rtol, "atol": atol})
                r["max_abs_err"] = max(r["max_abs_err"], e)
                r["max_share_of_limit"] = max(r["max_share_of_limit"], share)
        if not ok:
            what = "" if tol is None else \
                f" ({key or ''} {share:.4g} of the limit)"
            raise AssertionError(f"{self.name}: differs from its plain "
                                 f"version by up to {e}{what}")


# (source, log name, {template: (mangled-name pattern, display format)}):
# the sources whose kernels the build report lists, and the instances the
# report names (the pattern's groups are the template arguments)
PTXAS_SOURCES = (
    ("dwconv_int8", "ptxas_dwconv.log", {
        "dw_kernel": (r"dw_kernelILb(\d)ELi(\d)ELi(\d)ELi(\d)E",
                      "dw_kernel<{},{},{},{}>")}),
    ("conv2d_int8", "ptxas_conv.log", {
        "conv_mma": (r"conv_mmaILb(\d)ELi(\d)ELi(\d)E",
                     "conv_mma<{},{},{}>"),
        "conv_stream": (r"conv_streamILi(\d)ELi(\d)ELi(\d+)E",
                        "conv_stream<{},{},{}>")}),
    ("flash_attention", "ptxas_flash.log", {
        "flash_fwd_wgmma": (r"flash_fwd_wgmmaILi(\d+)E",
                            "flash_fwd_wgmma<{}>"),
        "flash_fwd_bf16": (r"flash_fwd_bf16ILi(\d+)ELi(\d+)E",
                           "flash_fwd_bf16<{},{}>"),
        "flash_fwd_f32": (r"flash_fwd_f32()", "flash_fwd_f32{}")}),
    ("stream_matmul", "ptxas_matmul.log", {
        "mm_kernel": (r"mm_kernelILi(\d+)ELi(\d+)E", "mm_kernel<{},{}>"),
        "mm_float": (r"mm_floatI(f|13__nv_bfloat16)(f|13__nv_bfloat16|S1_)"
                     r"Li(\d+)E", "mm_float<{},{},{}>")}),
    ("pool_int8", "ptxas_pool.log", {
        "maxpool_band": (r"maxpool_bandILi(\d)ELi(\d)ELi(\d+)ELi(\d)E",
                         "maxpool_band<{},{},{},{}>"),
        "gap_chunk": (r"gap_chunkILi(\d+)E", "gap_chunk<{}>")}),
)
# mangled template arguments, as the report names them (S1_: the
# repeated bf16 of mm_float<bf16, bf16, TN>)
MANGLED_ARGS = {"f": "f32", "13__nv_bfloat16": "bf16", "S1_": "bf16"}
# the tensor-core instruction each redesigned kernel must issue (SASS)
SASS_REQUIRED = {"conv_mma": "IMMA", "conv_stream": "IMMA",
                 "flash_fwd_wgmma": "HGMMA"}


def instance_name(text, templates):
    """(template, display name) of the kernel instance a ptxas or SASS line
    names, or None."""
    import re
    for tmpl, (pattern, fmt) in templates.items():
        m = re.search(pattern, text)
        if m:
            args = [MANGLED_ARGS.get(a, a) for a in m.groups()]
            if pattern.startswith(tmpl + "ILb"):     # a bool first argument
                args[0] = "true" if args[0] == "1" else "false"
            return tmpl, fmt.format(*args)
    return None


def sass_per_mac(body):
    """Instructions a MAC in the SASS block of a 3x3 dw_kernel instance
    that holds its dp4a (IDP) instructions, from the branch or barrier
    before the first to the store, branch or conversion after the last;
    each IDP does 3 MACs of a 3-tap kernel row."""
    import re
    ops = [x.group(1) for x in re.finditer(
        r"/\*[0-9a-f]{4,5}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", body)]
    idp = [i for i, op in enumerate(ops) if op.startswith("IDP")]
    if not idp:
        return None
    lo, hi = idp[0], idp[-1]
    while lo > 0 and not ops[lo - 1].startswith(
            ("BRA", "BAR", "EXIT", "BSYNC", "WARPSYNC")):
        lo -= 1
    while hi < len(ops) - 1 and not ops[hi + 1].startswith(
            ("BRA", "STG", "BAR", "I2F", "EXIT")):
        hi += 1
    return (hi - lo + 1) / (3 * len(idp))


def start_ptxas_report(_build):
    """Start ``nvcc -Xptxas -v`` on each source of ``PTXAS_SOURCES`` (beside
    the build, all at once); the returned function waits for them, writes
    each log to the output directory and returns {source: {instance:
    registers, stack and spill bytes, the count of each tensor-core or
    dp4a SASS instruction (HGMMA, HMMA, IMMA, IDP), and for a 3x3
    dw_kernel the SASS instructions a MAC of its MAC block}}."""
    import re
    import tempfile
    started = []
    for src, log_name, templates in PTXAS_SOURCES:
        out = tempfile.NamedTemporaryFile(suffix=".so", delete=False).name
        proc = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
             str(_build.CSRC / f"{src}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        started.append((src, log_name, templates, out, proc))

    def finish():
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        report = {}
        for src, log_name, templates, out, proc in started:
            log_text, _ = proc.communicate()
            (out_dir / log_name).write_text(log_text)
            if proc.returncode != 0:
                Path(out).unlink(missing_ok=True)
                raise RuntimeError(f"nvcc -Xptxas -v failed on {src}.cu:\n"
                                   f"{log_text}")
            sass = subprocess.run(
                [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
                 out], capture_output=True, text=True, timeout=300,
                check=True).stdout
            Path(out).unlink(missing_ok=True)
            found, cur = {}, None
            for line in log_text.splitlines():
                if re.search(r"entry function|Function properties for",
                             line):
                    named = instance_name(line, templates)
                    cur = named and named[1]
                    if cur:
                        found.setdefault(cur, {"template": named[0]})
                    continue
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
                if m and cur:
                    found[cur].update(stack=int(m.group(1)),
                                      spill_stores=int(m.group(2)),
                                      spill_loads=int(m.group(3)))
                m = re.search(r"Used (\d+) registers", line)
                if m and cur:
                    found[cur]["registers"] = int(m.group(1))
            for body in re.split(r"\n\s+Function : ", sass)[1:]:
                named = instance_name(body.split("\n")[0], templates)
                if not named:
                    continue
                rec = found.setdefault(named[1], {"template": named[0]})
                for op in ("HGMMA", "HMMA", "IMMA", "IDP"):
                    rec[op] = len(re.findall(rf"\b{op}\.", body))
                if named[0] == "dw_kernel" and named[1].split(",")[1] == "3":
                    rec["sass_instr_per_mac"] = sass_per_mac(body)
            report[src] = found
        return report
    return finish


def check_main_path_instances(record, shapes, conv_plan, stream_plan,
                              sm_count, flash_route, torch):
    """The kernel instance each main-path launch of K1, K2 and K9 takes
    (from the conv plans of its shape and the flash route of Phi-4-mini's
    head dims), and that each issues its tensor-core instruction in the
    SASS of the build report, and a K2 instance spills nothing; fails
    where one does not."""
    used = {}
    for key in shapes["conv2d_int8_pinned"]:
        h, w, c, co, k, s = key[:6]
        plan = conv_plan(BATCH, h, w, c, co, k, k, s, sm_count)
        inst = (f"conv_mma<{'true' if plan.packed else 'false'},{plan.wn},"
                f"{plan.nf}>")
        used.setdefault(("conv2d_int8", inst), []).append(list(key[:6]))
    for key in shapes["conv2d_int8_stream"]:
        h, w, c, co, k, s, nb = key[:7]
        plan = stream_plan(BATCH, h, w, c, co, k, k, s, nb, sm_count)
        inst = f"conv_stream<{plan.wn},{plan.nf},{plan.vec}>"
        used.setdefault(("conv2d_int8", inst), []).append(list(key[:6]))
    hd = FLASH_SLICE[4]
    route = flash_route(torch.bfloat16, hd, FLASH_SLICE[5])
    used[("flash_attention",
          f"flash_fwd_wgmma<{hd}>" if route == "wgmma"
          else f"flash_fwd_bf16<{hd},{FLASH_SLICE[5]}>")] = [
              list(FLASH_SLICE[:6])]
    rows = {}
    for (src, inst), keys in used.items():
        rep = record["ptxas"][src].get(inst, {})
        op = SASS_REQUIRED[rep.get("template", inst.split("<")[0])]
        if not rep.get(op):
            raise AssertionError(f"{inst} ({src}.cu), launched at {keys}, "
                                 f"issues no {op} in its SASS: {rep}")
        if inst.startswith("conv_stream") and (
                rep.get("spill_stores", 0) or rep.get("spill_loads", 0)):
            raise AssertionError(f"{inst}, launched at {keys}, spills: "
                                 f"{rep}")
        rows[inst] = {"shapes": keys, op: rep[op],
                      "registers": rep.get("registers"),
                      "spill_bytes": rep.get("spill_stores", 0)
                      + rep.get("spill_loads", 0)}
    record["main_path_instances"] = rows
    log("build", "main-path instances (launch shapes; tensor-core SASS "
        "instructions, registers, spill bytes): " + "; ".join(
            f"{inst}: {len(r['shapes'])} shapes, "
            f"{r.get('IMMA', r.get('HGMMA'))} "
            f"{'IMMA' if 'IMMA' in r else 'HGMMA'}, {r['registers']}, "
            f"{r['spill_bytes']}" for inst, r in rows.items()))


def library_conv(torch, F, x, w, s, same_pad):
    """The PyTorch calls that compute a dense int8 conv's sums, as
    yardsticks of time the port never calls: ``torch._int_mm`` for a 1x1
    (a stride-s 1x1 conv is a matmul over every s-th row and column) and
    for an fc head whose one window covers the map (on x padded to 32
    rows), else
    cuDNN's conv on a channels-last float copy of the pre-padded input,
    once in fp32 (TF32 off) and once with TF32 on (int8 values and their
    products are exact in TF32, and it sums in fp32).  fp32 sums past
    2^24, or a Winograd route, may round: the caller records whether each
    output equals the int32 sums.  The copies are made here, outside the
    timed call.  [{"name", "fn": the timed call or None where the library
    refuses the shape, "out": its output as [B, H', W', C_out],
    "refused"}]."""
    B, H, W, C = x.shape
    k, co = w.shape[0], w.shape[3]
    if k > 1 and H == W == k == s:
        # an fc head as a conv, one window over the whole map (VGG-16's
        # fc0): a [B, k*k*C] x [k*k*C, C_out] product, its sums past 2^24,
        # so no float conv is exact; torch._int_mm refuses M <= 16, so x
        # is padded with zero rows to M = 32 (outside the timed call)
        xs = torch.zeros((32, k * k * C), dtype=torch.int8, device=x.device)
        xs[:B] = x.reshape(B, -1)
        w2 = w.reshape(-1, co)
        return [{"name": "torch._int_mm (M padded to 32)",
                 "fn": lambda: torch._int_mm(xs, w2),
                 "out": lambda: torch._int_mm(xs, w2)[:B].reshape(B, 1, 1,
                                                                   co),
                 "refused": None}]
    if k == 1:
        xs = x[:, ::s, ::s, :].contiguous()
        ho, wo = xs.shape[1:3]
        xs, w2 = xs.reshape(-1, C), w.reshape(C, co)
        try:
            torch._int_mm(xs, w2)
        except RuntimeError as e:
            return [{"name": "torch._int_mm", "fn": None, "out": None,
                     "refused": str(e).splitlines()[0][:120]}]
        return [{"name": "torch._int_mm",
                 "fn": lambda: torch._int_mm(xs, w2),
                 "out": lambda: torch._int_mm(xs, w2).reshape(B, ho, wo,
                                                              co),
                 "refused": None}]
    xp = same_pad(x, k, k, s).to(torch.float32).permute(0, 3, 1, 2)
    wf = w.to(torch.float32).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)

    def conv(tf32):
        def call():
            torch.backends.cudnn.allow_tf32 = tf32
            try:
                return F.conv2d(xp, wf, stride=s)
            finally:
                torch.backends.cudnn.allow_tf32 = False
        return call
    return [{"name": f"cuDNN {'TF32' if tf32 else 'fp32'} conv",
             "fn": conv(tf32),
             "out": (lambda f=conv(tf32): f().permute(0, 2, 3, 1)),
             "refused": None} for tf32 in (False, True)]


def library_readings(torch, calls, want):
    """Each library call's device ms and whether its output equals the
    int32 sums ``want`` (else its largest difference), and the one that
    stands as the library time: the fastest exact call, or the fastest
    where none is exact."""
    got = {}
    for lib in calls:
        if lib["fn"] is None:
            got[lib["name"]] = {"refused": lib["refused"]}
            continue
        diff = float((lib["out"]().to(torch.float64)
                      - want.to(torch.float64)).abs().max())
        got[lib["name"]] = {"ms": device_ms(torch, lib["fn"], reps=20),
                            "exact": diff == 0.0, "max_abs_diff": diff}
    timed = [(r["ms"], not r["exact"], n) for n, r in got.items()
             if "ms" in r]
    if not timed:
        return {"library": calls[0]["name"], "library_ms": None,
                "library_refused": calls[0]["refused"],
                "library_calls": got}
    name = min(timed, key=lambda t: (t[1], t[0]))[2]
    return {"library": name, "library_ms": got[name]["ms"],
            "library_exact": got[name]["exact"],
            "library_max_abs_diff": got[name]["max_abs_diff"],
            "library_calls": got}


def library_maxpool(torch, F, x, k, s):
    """``F.max_pool2d(kernel_size=k, stride=s, ceil_mode=True)`` on the
    NHWC map ``x`` viewed as channels-last NCHW, a yardstick of time the
    port never calls: it computes the SAME maxpool wherever SAME puts all
    its padding after the data (every main-path shape; its windows start
    at s * i and ignore what lies past the edge, as the -128 padding
    does).  int8 where CUDA takes it, else an f16 copy (exact for int8
    values) made outside the timed call.  Its device ms, the type it ran
    in, and whether its output equals the plain version's."""
    from repro_torch.kernels.conv2d_int8.ref import same_out_and_pad
    from repro_torch.kernels.pool_int8.ref import maxpool_int8_ref
    if same_out_and_pad(x.shape[1], k, s)[1] or \
            same_out_and_pad(x.shape[2], k, s)[1]:
        return {"library_ms": None,
                "library_refused": "SAME pads before the data"}
    want = maxpool_int8_ref(x, k=k, stride=s)
    refused = {}
    for dt in (torch.int8, torch.float16):
        xin = x.to(dt).permute(0, 3, 1, 2)

        def call():
            return F.max_pool2d(xin, k, s, ceil_mode=True)
        try:
            out = call()
        except (RuntimeError, NotImplementedError) as e:
            refused[str(dt)] = str(e).splitlines()[0][:120]
            continue
        got = out.permute(0, 2, 3, 1).to(torch.int8)
        return {"library": f"F.max_pool2d(ceil_mode=True) in {dt}",
                "library_ms": device_ms(torch, call, reps=20),
                "library_exact": torch.equal(got, want),
                "library_refused": refused or None}
    return {"library_ms": None, "library_refused": refused}


def input_bytes_read(x, k, s):
    """Bytes of an NHWC int8 map that a SAME k x k window at stride s
    reads: only the rows and columns some output's window covers (a 1x1
    at stride 2 reads one pixel in four)."""
    from repro_torch.kernels.conv2d_int8.ref import same_out_and_pad
    B, H, W, C = x.shape

    def read(n):
        out, pad = same_out_and_pad(n, k, s)
        return len({o * s - pad + i for o in range(out) for i in range(k)}
                   & set(range(n)))
    return B * read(H) * read(W) * C


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


def flash_inputs(torch, g, dev, case, dtype):
    """q [B,H,S,hd], k [B,KV,S,hd], v [B,KV,S,hd_v] (kernel layout)."""
    B, H, KV, S, hd, hd_v = case[:6]
    return (torch.randn(B, H, S, hd, generator=g, device=dev).to(dtype),
            torch.randn(B, KV, S, hd, generator=g, device=dev).to(dtype),
            torch.randn(B, KV, S, hd_v, generator=g, device=dev).to(dtype))


def flash_kw(case):
    return dict(causal=case[6], window=case[7], softcap=case[8])


def check_flash(torch, g, dev, kern):
    """Phase 2 for K9: the kernel against its plain version (at the JAX
    call's blocks, min(128, S)) at every case of FLASH_CASES in bf16 and
    f32, o and lse; and the model-layout entry the main path calls, which
    reads q/k/v and writes o through their strides."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    n = 0
    for case in FLASH_CASES:
        for dname in FLASH_DTYPES:
            q, k, v = flash_inputs(torch, g, dev, case, getattr(torch, dname))
            want_o, want_lse = flash_attention_plain(q, k, v,
                                                     **flash_kw(case))
            o, lse = flash_attention_kernel(q, k, v, return_lse=True,
                                            **flash_kw(case))
            for what, got, want in (("o", o, want_o), ("lse", lse, want_lse)):
                kern.err(torch, got, want, FLASH_TOL[dname, what],
                         f"{dname} {what}")
            n += 2
    q, k, v = (t.transpose(1, 2).contiguous() for t in flash_inputs(
        torch, g, dev, FLASH_SLICE, torch.bfloat16))
    want_o, _ = flash_attention_plain(*(t.transpose(1, 2) for t in (q, k, v)))
    kern.err(torch, flash_attention(q, k, v).transpose(1, 2), want_o,
             FLASH_TOL["bfloat16", "o"], "bfloat16 o")
    return n + 1


def check_flash_bwd(torch, g, dev, ks, record):
    """Phase 2 for K10/K11: the pair against flash_attention_bwd_plain (at
    the JAX call's blocks) at every case of FLASH_CASES in bf16 and f32,
    on the forward o and lse of K9 (its f32 variant for f32): dq, dk and
    dv within BWD_TOL.  Then the pair's f32 sums against the plain
    backward on f32 casts at BWD_SUM_CASES, within BWD_SUM_TOL, and
    flash_attention_vjp in model layout against autograd through
    flash_attention_plain at VJP_CASES."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_kernel, flash_attention_vjp)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_plain)
    n = 0
    for case in FLASH_CASES:
        H, hd_v = case[1], case[5]
        for dname in FLASH_DTYPES:
            dt = getattr(torch, dname)
            q, k, v = flash_inputs(torch, g, dev, case, dt)
            do = torch.randn(q.shape[:3] + (hd_v,), generator=g,
                             device=dev).to(dt)
            o, lse = flash_attention_kernel(q, k, v, return_lse=True,
                                            **flash_kw(case))
            want = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             **flash_kw(case))
            got = flash_attention_bwd(q, k, v, o, lse, do, **flash_kw(case))
            for out, kname, gt, wt in zip(
                    ("dq", "dk", "dv"),
                    (BWD_KERNELS[0], BWD_KERNELS[1], BWD_KERNELS[1]),
                    got, want):
                rtol, share = BWD_TOL[dname, out]
                ks[kname].err(torch, gt, wt,
                              (rtol, share * float(wt.abs().max())),
                              f"{dname} {out}")
                n += 1
    for case in BWD_SUM_CASES:
        q, k, v = flash_inputs(torch, g, dev, case, torch.bfloat16)
        do = torch.randn(q.shape[:3] + (case[5],), generator=g,
                         device=dev).to(torch.bfloat16)
        o, lse = flash_attention_kernel(q, k, v, return_lse=True,
                                        **flash_kw(case))
        want = flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o)),
                                         lse, do.float(), **flash_kw(case))
        got = flash_attention_bwd(q, k, v, o, lse, do, **flash_kw(case),
                                  out_dtype=torch.float32)
        rtol, share = BWD_SUM_TOL
        for out, kname, gt, wt in zip(
                ("dq", "dk", "dv"),
                (BWD_KERNELS[0], BWD_KERNELS[1], BWD_KERNELS[1]), got, want):
            ks[kname].err(torch, gt, wt, (rtol, share * float(wt.abs().max())),
                          f"bfloat16 {out} f32 sums")
            n += 1
    worst = {}
    for case in VJP_CASES:
        for dname in FLASH_DTYPES:
            dt = getattr(torch, dname)
            q, k, v = (t.transpose(1, 2).contiguous().requires_grad_(True)
                       for t in flash_inputs(torch, g, dev, case, dt))
            w = torch.randn(q.shape[:3] + (case[5],), generator=g,
                            device=dev)
            o, _ = flash_attention_plain(*(t.transpose(1, 2)
                                           for t in (q, k, v)),
                                         **flash_kw(case))
            want = torch.autograd.grad(
                (o.transpose(1, 2).float() * w).sum(), (q, k, v))
            o = flash_attention_vjp.apply(q, k, v, *case[6:9])
            got = torch.autograd.grad((o.float() * w).sum(), (q, k, v))
            for name, gt, wt in zip(("dq", "dk", "dv"), got, want):
                bound = VJP_REL_TOL[dname] * float(wt.float().abs().max())
                diff = float((gt.float() - wt.float()).abs().max())
                key = f"{dname} {name}"
                worst[key] = max(worst.get(key, 0.0), diff / bound)
                if not diff <= bound or gt.dtype != dt:
                    raise AssertionError(
                        f"flash_attention_vjp {case} {dname}: {name} differs "
                        f"from autograd through the plain forward by {diff} "
                        f"> {bound}")
                n += 1
    record["vjp_share_of_limit"] = worst
    return n


FLOAT_DTYPE_NAMES = ("float32", "bfloat16")


def float_operands(torch, g, dev, shape, xd, wd):
    """x [M, K] and w [K, N], normal from ``g``, in their types."""
    M, K, N = shape
    return (torch.randn(M, K, generator=g, device=dev).to(xd),
            torch.randn(K, N, generator=g, device=dev).to(wd))


def float_err(torch, kern, got, want):
    """The float matmul against its plain version: same type and shape,
    |got - want| <= tol |want| + tol max|want| with FLOAT_TOL of the
    output's type (readings kept per type)."""
    dname = str(want.dtype).split(".")[1]
    tol = FLOAT_TOL[dname]
    kern.err(torch, got, want, (tol, tol * float(want.float().abs().max())),
             dname)


def check_float_matmul(torch, g, dev, ks, fc_shapes, block_for):
    """Phase 2 for the float modes of K7/K8 (mm_float): FLOAT_CHECK_SHAPES
    in f32 and bf16, pinned, stream and fifo (n_buffers 1-4), each with
    K blocks of 128 (the JAX test's) and of 16 (rings of many blocks);
    mixed f32 x bf16 and bf16 x f32 operands at the first and the ragged
    shape; every fc shape of the six configs at M = 8 in both types and
    every mode, K blocks as the engines cut them."""
    from repro_torch.kernels.stream_matmul.ops import stream_matmul
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    rings = [("pinned", 2, 128), ("stream", 2, 128), ("stream", 2, 16)] + [
        ("fifo", nb, bk) for nb in (1, 2, 3, 4) for bk in (128, 16)]
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(shape, (d, d), rings) for shape in FLOAT_CHECK_SHAPES
             for d in (f32, bf16)]
    cases += [(shape, pair, rings) for shape in (FLOAT_CHECK_SHAPES[0],
                                                 FLOAT_CHECK_SHAPES[-1])
              for pair in ((f32, bf16), (bf16, f32))]
    cases += [((BATCH, k, n), (d, d),
               [(mode, 2, block_for(k, 512))
                for mode in ("pinned", "stream", "fifo")])
              for k, n in sorted(fc_shapes) for d in (f32, bf16)]
    n = 0
    for shape, (xd, wd), runs in cases:
        x, w = float_operands(torch, g, dev, shape, xd, wd)
        want = stream_matmul_ref(x, w)
        for mode, nb, bk in runs:
            kname = ("stream_matmul_float_fifo" if mode == "fifo"
                     else "stream_matmul_float_pinned")
            float_err(torch, ks[kname], stream_matmul(x, w, mode=mode, bk=bk,
                                                      n_buffers=nb), want)
            n += 1
    return n


def float_path(comps, select_engine):
    """The float matmul's path: (K, N, mode) of every fc head of the six
    configs in the mode its engine runs it, and VGG-16's fc0 as a matmul,
    streamed."""
    heads = set()
    for comp in comps.values():
        for sc in comp.plan.schedules:
            if select_engine(sc.spec).name == "stream_matmul":
                heads.add((sc.spec.c_in, sc.spec.c_out,
                           "fifo" if sc.streamed else "pinned"))
    return sorted(heads) + [(FC0_MATMUL[1], FC0_MATMUL[2], "fifo")]


def drive_float_matmul(torch, g, dev, path, block_for, record):
    """Phase 3 for the float matmul: ``stream_matmul`` at every entry of
    ``path`` at M = BATCH in f32 and in bf16, launches counted over these
    calls alone; each output of the promoted type, finite and within
    FLOAT_TOL of the plain path.  Returns the launches and the inputs
    (for phase 4)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.stream_matmul.ops import (FLOAT_KERNELS,
                                                       stream_matmul)
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    inputs = {(k, n, mode, dname): float_operands(
                  torch, g, dev, (BATCH, k, n), getattr(torch, dname),
                  getattr(torch, dname))
              for k, n, mode in path for dname in FLOAT_DTYPE_NAMES}
    outs = {}
    _build.reset_launches()
    for (k, n, mode, dname), (x, w) in inputs.items():
        outs[k, n, mode, dname] = stream_matmul(x, w, mode=mode,
                                                bk=block_for(k, 512),
                                                n_buffers=2)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = {}
    for _, _, mode, _ in inputs:
        want[FLOAT_KERNELS[mode]] = want.get(FLOAT_KERNELS[mode], 0) + 1
    if launches != want:
        raise AssertionError(f"float matmul path: launches {launches} != "
                             f"{want}")
    path = Kernel("float matmul path")
    for key, (x, w) in inputs.items():
        if outs[key].shape != (BATCH, key[1]):
            raise AssertionError(f"float matmul path {key}: shape "
                                 f"{tuple(outs[key].shape)}")
        float_err(torch, path, outs[key], stream_matmul_ref(x, w))
    record["float_matmul_path"] = {"launches": launches,
                                   "readings": path.readings}
    log("slice", f"float matmul: {len(inputs)} calls of stream_matmul (fc "
        f"heads at M = {BATCH} in their engines' modes and fc0 as a "
        f"{FC0_MATMUL[1]} x {FC0_MATMUL[2]} matmul, f32 and bf16), "
        f"launches {json.dumps(launches, sort_keys=True)}; outputs of the "
        f"promoted type within FLOAT_TOL, readings "
        f"{json.dumps(path.readings)}")
    return launches, inputs


def serve_lm(torch, np, dev, record):
    """Phase 3 for the LM: Phi-4-mini at full width and depth through
    ServingEngine on the card; launches counted over engine.run; prefill
    logits of the kernel path against the plain path (kernel mode off:
    the blockwise route) on the same weights and tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as tmod
    from repro_torch.models.accounting import weight_bytes
    from repro_torch.runtime.serving import Request, ServingEngine
    arch = get_arch(LM_ARCH)
    t0 = time.perf_counter()
    params = tmod.init_params(torch.Generator(device=dev).manual_seed(SEED),
                              arch, dev)
    torch.cuda.synchronize()
    rec = {"arch": LM_ARCH, "params": arch.param_count(),
           "weight_bytes": weight_bytes(arch),
           "init_s": time.perf_counter() - t0}
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, arch.vocab_size, LM_PROMPT).astype(np.int32)
               for _ in range(LM_REQUESTS)]
    engine = ServingEngine(params, arch, batch_slots=LM_SLOTS,
                           max_seq=LM_MAX_SEQ)
    _build.reset_launches()
    t0 = time.perf_counter()
    done = engine.run([Request(i, p, max_new=LM_NEW)
                       for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    rec["first_run_s"] = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    n_prefill = -(-LM_REQUESTS // LM_SLOTS)
    if launches != {LM_KERNEL: n_prefill * arch.n_layers}:
        raise AssertionError(f"{LM_ARCH}: launches {launches} != "
                             f"{n_prefill} prefills x {arch.n_layers} layers")
    vp = params["embed"]["table"].shape[0]
    outs = {r.rid: r.out for r in done}
    if sorted(outs) != list(range(LM_REQUESTS)) or any(
            not r.done or len(r.out) != LM_NEW
            or not all(0 <= t < vp for t in r.out) for r in done):
        raise AssertionError(f"{LM_ARCH}: requests incomplete: {outs}")
    engine.admission.assert_quiescent()
    batches = [torch.from_numpy(np.stack(prompts[i:i + LM_SLOTS])).to(dev)
               for i in range(0, LM_REQUESTS, LM_SLOTS)]
    rec["prefill_logit_diff"], rec["prefill_logit_bound"] = [], []
    sure = 0
    with torch.no_grad():
        for bi, toks in enumerate(batches):
            lk, _ = tmod.prefill(params, arch, {"tokens": toks}, LM_MAX_SEQ)
            lm_layers.set_kernel_mode(False)
            try:
                lp, _ = tmod.prefill(params, arch, {"tokens": toks},
                                     LM_MAX_SEQ)
            finally:
                lm_layers.set_kernel_mode(True)
            bound = LM_REL_TOL * float(lp.abs().max())
            diff = float((lk - lp).abs().max())
            rec["prefill_logit_diff"].append(diff)
            rec["prefill_logit_bound"].append(bound)
            if not diff <= bound or not bool(torch.isfinite(lk).all()):
                raise AssertionError(f"{LM_ARCH}: prefill logits of the "
                                     f"kernel path differ from the plain "
                                     f"path by {diff} > {bound}")
            top2 = lp.topk(2, dim=-1).values
            margin_ok = ((top2[:, 0] - top2[:, 1]) > bound).tolist()
            plain_first = lp.argmax(-1).tolist()
            for i, ok in enumerate(margin_ok):
                rid = bi * LM_SLOTS + i
                if ok and outs[rid][0] != plain_first[i]:
                    raise AssertionError(
                        f"{LM_ARCH}: request {rid} first token "
                        f"{outs[rid][0]} != plain path's {plain_first[i]}")
                sure += ok
    rec["first_token_checked"] = sure
    rec["launches"] = launches
    record["lm"] = rec
    log("slice", f"{LM_ARCH} (full width and depth, {rec['params']:,} "
        f"params, bf16): {LM_REQUESTS} requests x {LM_NEW} tokens served "
        f"with {LM_SLOTS} slots, launches {json.dumps(launches)}; prefill "
        f"logits within {max(rec['prefill_logit_diff']):.4g} of the plain "
        f"path (bound {min(rec['prefill_logit_bound']):.4g}); first token "
        f"equal on the {sure} rows whose top-2 margin exceeds the bound")
    return {"params": params, "arch": arch, "engine": engine,
            "prompts": prompts, "batches": batches, "launches": launches}


def named_leaves(tree, prefix=""):
    """(dotted name, tensor) of a nested dict of tensors."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from named_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def rel_l2(torch, a, b):
    """|a - b| / |b| (L2) in f32, one layer of a stacked leaf at a time."""
    num = den = 0.0
    for sa, sb in zip(a.unbind(0) if a.dim() >= 3 else [a],
                      b.unbind(0) if b.dim() >= 3 else [b]):
        num += float((sa.float() - sb.float()).square().sum())
        den += float(sb.float().square().sum())
    return (num / den) ** 0.5


def profile_device_ms(torch, fn):
    """Device ms of the CUDA kernels in one torch.profiler trace of fn()
    (the sum of their durations and the length of their union), and the
    ten kernels with the most device time; None where the trace shows no
    device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0) / 1e3
    if not spans:
        return None
    busy, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 >= end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"sum_ms": sum(t1 - t0 for t0, t1 in spans) / 1e3,
            "busy_ms": busy / 1e3, "kernels": len(spans),
            "top_ms": [[n[:120], t] for n, t in top]}


def train_lm(torch, np, dev, record, card):
    """Phase 3 for LM training: Phi-4-mini at full width and depth, bf16,
    random weights from SEED.  First one loss_fn gradient on the first
    batch, kernel mode on and then off (blockwise attention): the losses
    within LOSS_REL_TOL and each leaf's grads within GRAD_REL_TOL (L2).
    Then Trainer.run for TRAIN_STEPS steps with the kernels: exactly
    TRAIN_LAUNCHES a step, a finite loss and grad_norm at every step; the
    eager ms of each step; one more step traced by torch.profiler for the
    step's device ms."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenDataset
    from repro_torch.kernels import _build
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as tmod
    from repro_torch.runtime.trainer import (TrainConfig, Trainer,
                                             value_and_grad)
    gc.collect()                  # the serving phase's weights go first
    torch.cuda.empty_cache()
    arch = get_arch(LM_ARCH)
    data = TokenDataset(DataConfig(arch.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                   seed=SEED))
    rec = {"seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS}
    params = tmod.init_params(torch.Generator(device=dev).manual_seed(SEED),
                              arch, dev)
    batch = {k: torch.from_numpy(v).to(dev, torch.int64)
             for k, v in data.global_batch(0).items()}
    loss_on, g_on = value_and_grad(params, arch, batch)
    lm_layers.set_kernel_mode(False)
    try:
        loss_off, g_off = value_and_grad(params, arch, batch)
    finally:
        lm_layers.set_kernel_mode(True)
    loss_on, loss_off = float(loss_on), float(loss_off)
    rel = {name: rel_l2(torch, a, b) for (name, a), (_, b) in
           zip(named_leaves(g_on), named_leaves(g_off))}
    worst = max(rel, key=rel.get)
    rec.update(loss_kernel_on=loss_on, loss_kernel_off=loss_off,
               grad_rel_l2=rel)
    if not (np.isfinite(loss_on) and all(np.isfinite(list(rel.values())))):
        raise AssertionError(f"{LM_ARCH}: loss {loss_on} or grads not "
                             f"finite: {rel}")
    if not abs(loss_on - loss_off) <= LOSS_REL_TOL * abs(loss_off):
        raise AssertionError(f"{LM_ARCH}: loss with the kernels {loss_on} "
                             f"!= without {loss_off}")
    if not rel[worst] <= GRAD_REL_TOL:
        raise AssertionError(f"{LM_ARCH}: grads of {worst} differ by "
                             f"{rel[worst]} > {GRAD_REL_TOL} (L2) between "
                             f"kernel mode on and off")
    log("slice", f"{LM_ARCH} loss_fn grad, kernels on vs off: loss "
        f"{loss_on:.6f} vs {loss_off:.6f}; worst leaf {worst} "
        f"{rel[worst]:.4g} (bound {GRAD_REL_TOL})")
    del params, g_on, g_off, batch
    gc.collect()
    torch.cuda.empty_cache()

    # no checkpoint (46 GB at full width): ckpt_every past the TRAIN_STEPS
    # counted steps and the one profiled after them
    tcfg = TrainConfig(steps=TRAIN_STEPS, microbatches=1, remat=True,
                       ckpt_every=TRAIN_STEPS + 2, log_every=1,
                       ckpt_path=str(ROOT / "build" / "train_ckpt"))
    t0 = time.perf_counter()
    tr = Trainer(arch, tcfg, data, seed=SEED, device=dev)
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    _build.reset_launches()
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.run(n_steps=1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(_build.LAUNCHES)
    want = {k: TRAIN_STEPS * n for k, n in TRAIN_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"{LM_ARCH} training: launches {launches} != "
                             f"{want}")
    hist = list(tr.history)
    if [h["step"] for h in hist] != list(range(1, TRAIN_STEPS + 1)) or \
            not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                    for h in hist):
        raise AssertionError(f"{LM_ARCH} training: history {hist}")
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    prof = profile_device_ms(torch, lambda: tr.run(n_steps=1))
    if list(Path(tcfg.ckpt_path).glob("step_*")):
        raise AssertionError(f"a checkpoint was written to {tcfg.ckpt_path}")
    ms = statistics.median(step_ms[1:])
    rec.update(history=hist, step_ms=step_ms, ms_per_step=ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
               profiled_step=prof, launches=launches,
               device_ms_per_step=prof and prof["busy_ms"],
               idle_share=prof and 1 - prof["busy_ms"] / ms)
    record["train"] = rec
    idle = ("not measured (no device activity in the trace)" if prof is None
            else f"{prof['busy_ms']:.3f} ms device, idle "
                 f"{100 * rec['idle_share']:.0f}%")
    log("slice", f"{LM_ARCH} (full width and depth, bf16) trained "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens: losses "
        f"{[round(h['loss'], 4) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}; launches "
        f"{json.dumps(launches)}; peak device memory "
        f"{rec['peak_bytes'] / 1e9:.2f} GB")
    log("time", f"{LM_ARCH} train step {TRAIN_BATCH}x{TRAIN_SEQ}: {ms:.3f} "
        f"ms eager (median of steps 2-{TRAIN_STEPS}), "
        f"{rec['tokens_per_s']:.1f} tokens/s; {idle}  [{card}]")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def time_flash_bwd(torch, F, g, dev, ks, n_launches, card, record):
    """Phase 4 for K10/K11: device ms per launch of each at the training
    shape and at S = 2048 (model layout, as the training path calls
    them), the plain version's ms for the pair, and the backward of
    F.scaled_dot_product_attention (causal, GQA) for the pair."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_plain
    per = {}
    for case in (FLASH_SLICE, FLASH_LONG):
        B, H, KV, S, hd, hd_v = case[:6]
        q, k, v = (t.transpose(1, 2).contiguous() for t in flash_inputs(
            torch, g, dev, case, torch.bfloat16))
        do = torch.randn((B, S, H, hd_v), generator=g,
                         device=dev).to(torch.bfloat16)
        qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
        o, lse = ops.flash_attention_kernel(qt, kt, vt, return_lse=True)
        delta = ops._delta(o, dot)
        dq = torch.empty_like(q)
        dk = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
        dv = torch.empty((B, S, H, hd_v), dtype=q.dtype, device=dev)

        def launch(which):
            return lambda: ops._launch_bwd(
                qt, kt, vt, dot, lse, delta, dq.transpose(1, 2),
                dk.transpose(1, 2), dv.transpose(1, 2), causal=True,
                window=0, softcap=0.0, which=which)
        reps = 20 if S <= 512 else 5
        lq, lk, lv = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                             enable_gqa=True)

        def lib():
            return torch.autograd.grad(out, (lq, lk, lv), dot,
                                       retain_graph=True)
        got = ops.flash_attention_bwd(qt, kt, vt, o, lse, dot)
        lib_diff = float((lib()[0].float() - got[0].float()).abs().max())
        elems_q, elems_kv = B * H * S * hd, B * KV * S * (hd + hd_v)
        flop = 2 * B * H * S * S * hd // 2
        n_dq = 2 * (2 * elems_q + elems_kv + B * H * S * hd_v) + 8 * B * H * S
        n_dkv = 2 * (elems_q + elems_kv + B * H * S * hd_v
                     + B * H * S * (hd + hd_v)) + 8 * B * H * S
        # autograd runs the backward on the forward's stream, which a CUDA
        # graph cannot capture: its device time comes from the profiler
        prof = profile_device_ms(torch, lambda: [lib() for _ in range(reps)])
        per[S] = {"library_ms": prof["busy_ms"] / reps,
                  "plain_ms": device_ms(torch, lambda: flash_attention_bwd_plain(
                      qt, kt, vt, o, lse, dot), reps=2, replays=2),
                  "library_max_abs_diff_dq": lib_diff}
        for kname, which, nbytes, ops_ in (
                (BWD_KERNELS[0], (0,), n_dq, 3 * flop),
                (BWD_KERNELS[1], (1,), n_dkv, 4 * flop)):
            b, by = bound_ms(nbytes, ops_, BF16_FLOPS_PER_S)
            per[S][kname] = {
                "ms": device_ms(torch, launch(which), reps=reps),
                "call_ms": call_ms(torch, launch(which), reps=reps),
                "bound_ms": b, "bound_by": by, "bytes": nbytes,
                "flops": ops_}
        log("time", f"flash backward B={B} H={H} KV={KV} S={S} hd={hd} bf16 "
            f"causal: dq {per[S][BWD_KERNELS[0]]['ms']:.4f} ms, dk/dv "
            f"{per[S][BWD_KERNELS[1]]['ms']:.4f} ms per launch (device); "
            f"bounds {per[S][BWD_KERNELS[0]]['bound_ms']:.4f} / "
            f"{per[S][BWD_KERNELS[1]]['bound_ms']:.4f} ms; the pair: plain "
            f"{per[S]['plain_ms']:.4f} ms, SDPA backward "
            f"{per[S]['library_ms']:.4f} ms  [{card}]")
    t = per[TRAIN_SEQ]
    for kname in BWD_KERNELS:
        kern, n = ks[kname], n_launches[kname]
        kern.ms = n * t[kname]["ms"]
        kern.bound_ms, kern.bound_by = n * t[kname]["bound_ms"], \
            t[kname]["bound_by"]
        # the plain version and the library compute dq, dk and dv in one
        # call: each row carries the pair's time
        kern.plain_ms, kern.library_ms = n * t["plain_ms"], \
            n * t["library_ms"]
    record["flash_bwd_per_launch"] = {str(S): d for S, d in per.items()}


def time_flash(torch, F, g, dev, kern, n_launches, card, record):
    """Phase 4 for K9: device ms per launch at the slice shape and at S =
    2048 (model layout, as the main path calls it), its plain version,
    and F.scaled_dot_product_attention on the same tensors."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_route)
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    per = {}
    for case in (FLASH_SLICE, FLASH_LONG):
        B, H, KV, S, hd, hd_v = case[:6]
        q, k, v = (t.transpose(1, 2).contiguous() for t in flash_inputs(
            torch, g, dev, case, torch.bfloat16))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        lib_diff = float((lib().transpose(1, 2).float()
                          - flash_attention(q, k, v).float()).abs().max())
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + B * S * H * hd_v) \
            + 4 * B * H * S
        flops = 4 * B * H * S * S * hd // 2
        b, by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        per[S] = {"ms": device_ms(torch, lambda: flash_attention(q, k, v),
                                  reps=20),
                  "call_ms": call_ms(torch, lambda: flash_attention(q, k, v),
                                     reps=20),
                  "plain_ms": device_ms(torch, lambda: flash_attention_plain(
                      qt, kt, vt), reps=3, replays=2),
                  "library_ms": device_ms(torch, lib, reps=20),
                  "bound_ms": b, "bound_by": by, "bytes": nbytes,
                  "flops": flops, "library_max_abs_diff": lib_diff}
        per[S]["route"] = flash_route(torch.bfloat16, hd, hd_v)
        per[S]["factor"] = per[S]["ms"] / per[S]["library_ms"]
        log("time", f"{LM_KERNEL} B={B} H={H} KV={KV} S={S} hd={hd} bf16 "
            f"causal ({per[S]['route']} route): {per[S]['ms']:.4f} ms per "
            f"launch (device), plain {per[S]['plain_ms']:.4f} ms, SDPA "
            f"{per[S]['library_ms']:.4f} ms ({per[S]['factor']:.3f}x), "
            f"bound {b:.4f} ms ({by}), {flops / per[S]['ms'] / 1e9:.1f} "
            f"TFLOP/s  [{card}]")
    t = per[LM_PROMPT]
    kern.ms, kern.plain_ms = n_launches * t["ms"], n_launches * t["plain_ms"]
    kern.library_ms = n_launches * t["library_ms"]
    kern.bound_ms, kern.bound_by = n_launches * t["bound_ms"], t["bound_by"]
    record["flash_per_launch"] = {str(S): d for S, d in per.items()}


def time_lm(torch, st, card, record):
    """Phase 4 for the LM: eager prefill ms per batch, decode ms per step
    and tokens/s of whole engine runs; one prefill and one decode step
    replayed as CUDA graphs for device time and the card's idle share."""
    from repro_torch.models import transformer as tmod
    from repro_torch.runtime.serving import Request
    params, arch, engine = st["params"], st["arch"], st["engine"]
    toks = st["batches"][0]
    B = toks.shape[0]

    def host_ms(fn, n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return times

    run_ms = host_ms(lambda: engine.run(
        [Request(i, p, max_new=LM_NEW) for i, p in enumerate(st["prompts"])]),
        2)
    with torch.no_grad():
        def prefill():
            return tmod.prefill(params, arch, {"tokens": toks}, LM_MAX_SEQ)
        pre_ms = host_ms(prefill, 4)[1:]
        logits, cache = prefill()
        cur = logits.argmax(-1)[:, None]
        pos = iter(range(LM_PROMPT, LM_MAX_SEQ))
        dec_ms = host_ms(lambda: tmod.decode_step(params, arch, cache, cur,
                                                  next(pos)), 9)[1:]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            g_logits, _ = prefill()
        graph.replay()
        torch.cuda.synchronize()
        gdiff = float((g_logits - logits).abs().max())
        if not gdiff <= LM_REL_TOL * float(logits.abs().max()):
            raise AssertionError(f"{LM_ARCH}: the replayed prefill's logits "
                                 f"differ from the eager one's by {gdiff}")
        pre_dev = event_ms(torch, graph.replay, 5) / 5
        del graph
        dgraph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(dgraph, capture_error_mode="relaxed"):
            tmod.decode_step(params, arch, cache, cur, LM_PROMPT)
        dgraph.replay()
        dec_dev = event_ms(torch, dgraph.replay, 10) / 10
        del dgraph
    pre, dec = statistics.median(pre_ms), statistics.median(dec_ms)
    run = statistics.median(run_ms)
    n_tok = LM_REQUESTS * LM_NEW
    rec = {"prefill_ms_per_batch": pre, "prefill_runs_ms": pre_ms,
           "prefill_device_ms": pre_dev, "prefill_idle_share": 1 - pre_dev / pre,
           "decode_ms_per_step": dec, "decode_runs_ms": dec_ms,
           "decode_device_ms": dec_dev, "decode_idle_share": 1 - dec_dev / dec,
           "decode_tokens_per_s": B / dec * 1e3,
           "run_ms": run, "runs_ms": run_ms,
           "tokens_per_s": n_tok / run * 1e3,
           "prefill_tokens_per_s": B * LM_PROMPT / pre * 1e3,
           "graph_prefill_max_abs_diff": gdiff}
    record["lm"].update(rec)
    log("time", f"{LM_ARCH} batch {B}x{LM_PROMPT}: prefill {pre:.3f} ms "
        f"eager, {pre_dev:.3f} ms device (idle {100 * rec['prefill_idle_share']:.0f}%); "
        f"decode step {dec:.3f} ms eager, {dec_dev:.3f} ms device (idle "
        f"{100 * rec['decode_idle_share']:.0f}%); engine.run of "
        f"{LM_REQUESTS} requests {run:.1f} ms, {rec['tokens_per_s']:.1f} "
        f"generated tokens/s  [{card}]")


def drive_fused(torch, nets, params, images, logits, reports, launches,
                record):
    """Each net through ``run()``'s default, the fused backend: the first
    run captures the forward as one CUDA graph, a warm run replays it.
    The warm run's launches (counted from zero just before it, added by
    the replay) must equal the eager run's, its logits and report the
    eager run's; one trace a net, hits counted.  Returns the warm runs'
    launches per net."""
    from repro_torch.kernels import _build
    out, rows = {}, {}
    for name, comp in nets.items():
        if comp.trace_count:
            raise AssertionError(f"{name}: a trace before the first run")
        t = time.perf_counter()
        first, _ = comp.run(params[name], images[name])
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t
        _build.reset_launches()
        lg, rep = comp.run(params[name], images[name])
        torch.cuda.synchronize()
        out[name] = dict(_build.LAUNCHES)
        for _ in range(FUSED_WARM_RUNS - 1):
            comp.run(params[name], images[name])
        torch.cuda.synchronize()
        stats = comp.trace_cache_stats()
        if out[name] != launches[name]:
            raise AssertionError(f"{name}: fused launches {out[name]} != "
                                 f"eager {launches[name]}")
        for got, what in ((first, "first"), (lg, "warm")):
            if not torch.equal(got, logits[name]):
                diff = (got - logits[name]).abs().max().item()
                raise AssertionError(f"{name}: the {what} fused run's logits "
                                     f"differ from the eager run's by {diff}")
        if rep.layers != reports[name].layers:
            raise AssertionError(f"{name}: fused report != eager report")
        rep.verify()
        if comp.trace_count != 1 or stats["misses"] != 1 \
                or stats["hits"] != FUSED_WARM_RUNS:
            raise AssertionError(f"{name}: trace cache {stats}")
        rows[name] = {"launches": out[name], "trace_cache": stats,
                      "capture_s": capture_s}
        log("fused", f"{name}: {FUSED_WARM_RUNS} warm runs replay one CUDA "
            f"graph; logits and report equal the eager run's, launches "
            f"{sum(out[name].values())} a forward as eager; trace cache "
            f"{json.dumps(stats)}; first run (eager forward, capture, "
            f"checked replay) {capture_s:.2f} s")
    record["fused"] = rows
    return out


def fused_host_split(torch, comp, params, images):
    """Where a fused run's time goes past the device's, host clock,
    median of 10 single calls each: ``*_ms`` ends in a synchronise,
    ``*_return_ms`` is the time until the call returns (what the host
    spends before the card can finish).  ``run`` is ``comp.run`` (the
    executor, the trace key, the report), ``fn`` the trace's call (the
    copy-in, the replay, the clone), ``replay`` the bare graph replay."""
    trace = comp.fused_trace(params, images, act_scale=0.05)
    calls = {"run": lambda: comp.run(params, images),
             "fn": lambda: trace.fn(params, images),
             "replay": trace.fn.graph.replay}
    out = {}
    for key, fn in calls.items():
        done, ret = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            t_ret = time.perf_counter()
            torch.cuda.synchronize()
            done.append((time.perf_counter() - t) * 1e3)
            ret.append((t_ret - t) * 1e3)
        out[f"{key}_ms"] = statistics.median(done)
        out[f"{key}_return_ms"] = statistics.median(ret)
    return out


def serve_cnn(torch, np, comp, params, per_forward, dev, record):
    """ResNet-50 served over the fused backend (``cp.serve``), then the
    adaptive ladder at light load: every request's logits bit-identical to
    the eager ``run()`` of its images on the card, the credit bound held,
    one warm trace for the fixed shape, the Eq. 2 words of the images, and
    microbatches x one forward's launches.  Records the report, the host
    spans of a traced interval, and the ceiling of BATCH images a graph
    replay of the forward."""
    from repro_torch.kernels import _build
    from repro_torch.models.cnn import cnn_input_shape
    from repro_torch.obs import Tracer
    from repro_torch.runtime.pipeline import PipelineExecutor
    rng = np.random.default_rng(SEED)
    sizes = [int(n) for n in rng.integers(1, BATCH + 1, SERVE_REQUESTS)]
    shape = cnn_input_shape(comp.cfg, 1)[1:]
    reqs = [rng.integers(-127, 128, size=(n,) + shape, dtype=np.int8)
            for n in sizes]
    eager = PipelineExecutor(comp, device=dev, backend="eager")

    def check(got, req, what):
        want = eager.run(params, torch.from_numpy(req).to(dev))[0].cpu()
        if not np.array_equal(got, want.numpy()):
            raise AssertionError(f"serving: {what} differs from the eager "
                                 f"run of its {len(req)} images")

    tracer = Tracer()
    handles = [None] * len(reqs)
    _build.reset_launches()
    with comp.serve(params, microbatch=BATCH, credits=SERVE_CREDITS,
                    tracer=tracer) as eng:
        def producer(pid):
            for i in range(pid, len(reqs), SERVE_PRODUCERS):
                handles[i] = eng.submit(reqs[i])
        threads = [threading.Thread(target=producer, args=(p,))
                   for p in range(SERVE_PRODUCERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            if t.is_alive():
                raise AssertionError("serving: a producer did not finish")
        eng.drain(timeout=300)
        rep = eng.report()
    torch.cuda.synchronize()
    served = dict(_build.LAUNCHES)
    eng.admission.assert_quiescent()
    if eng.admission.max_in_flight_seen > SERVE_CREDITS:
        raise AssertionError(f"serving: {eng.admission.max_in_flight_seen} "
                             f"microbatches in flight > {SERVE_CREDITS}")
    if comp.trace_count != 1:
        raise AssertionError(f"serving: {comp.trace_cache_stats()}")
    if rep.images != sum(sizes) or rep.requests != len(reqs) \
            or rep.hbm_words_useful != rep.images * eng.words_per_image:
        raise AssertionError(f"serving: report {rep.images} images, "
                             f"{rep.hbm_words_useful} useful words")
    want = {k: v * rep.microbatches for k, v in per_forward.items()}
    if served != want:
        raise AssertionError(f"serving: launches {served} != {want}")
    for i, (h, req) in enumerate(zip(handles, reqs)):
        check(h.result(), req, f"request {i}")
    # the ceiling: BATCH images a replay of the forward's graph
    trace = comp.fused_trace(params, torch.zeros(
        (BATCH,) + shape, dtype=torch.int8, device=dev), act_scale=0.05)
    trace.fn.graph.replay()
    graph_ms = event_ms(torch, trace.fn.graph.replay, 20) / 20
    # the host spans of the traced interval, per name: count, total,
    # median and largest ms (the first pack waits for the first request)
    durs = {}
    for ph, sname, _, _, dur, _, _ in tracer.events():
        if ph == "X":
            durs.setdefault(sname, []).append(dur * 1e3)
    spans = {k: {"n": len(v), "total_ms": sum(v),
                 "median_ms": statistics.median(v), "max_ms": max(v)}
             for k, v in durs.items()}
    be = rep.bandwidth_efficiency["measured"]
    row = {"report": rep.to_dict(), "pad_fraction": rep.pad_fraction,
           "device_ms_per_microbatch": graph_ms,
           "ceiling_images_per_s": BATCH / graph_ms * 1e3,
           "host_span_ms": spans, "launches": served,
           "first_spans_ms": {k: v[:5] for k, v in durs.items()},
           "tracer_dropped": tracer.dropped}
    row["report"].pop("request_rows")
    log("serve", f"{SERVE_NET}: {len(reqs)} requests, {rep.images} images in "
        f"{rep.microbatches} microbatches of {BATCH} from "
        f"{SERVE_PRODUCERS} producers, bit-identical to the eager run() of "
        f"each; in flight <= {eng.admission.max_in_flight_seen}/"
        f"{SERVE_CREDITS}; {rep.images_per_s:.1f} images/s against a "
        f"ceiling of {row['ceiling_images_per_s']:.1f} ({BATCH} / "
        f"{graph_ms:.4f} device ms); latency p50 {rep.p50_ms:.2f} p95 "
        f"{rep.p95_ms:.2f} p99 {rep.p99_ms:.2f} ms; pad {rep.pad_fraction:.3f}"
        f"; admission wait {be['admission_wait_fraction']:.3f}, dispatch gap "
        f"{be['dispatch_gap_fraction']:.3f} of the wall ({rep.wall_s * 1e3:.1f}"
        f" ms); host spans (n, total / median / max ms): " + "; ".join(
            f"{k} {v['n']}, {v['total_ms']:.2f} / {v['median_ms']:.3f} / "
            f"{v['max_ms']:.3f}" for k, v in spans.items())
        + f"  [{record['card']}]")

    # the steady state: the same requests SERVE_STEADY_REPEATS times over,
    # from the main thread, untraced
    with comp.serve(params, microbatch=BATCH,
                    credits=SERVE_CREDITS) as eng:
        outs, srep = eng.serve(reqs * SERVE_STEADY_REPEATS)
    for i, (got, h) in enumerate(zip(outs, handles * SERVE_STEADY_REPEATS)):
        if not np.array_equal(got, h.result()):
            raise AssertionError(f"steady serving: request {i} differs")
    sbe = srep.bandwidth_efficiency["measured"]
    row["steady"] = {"requests": srep.requests, "images": srep.images,
                     "images_per_s": srep.images_per_s,
                     "wall_s": srep.wall_s, "p50_ms": srep.p50_ms,
                     "p99_ms": srep.p99_ms, "pad_fraction": srep.pad_fraction,
                     "admission_wait_fraction":
                         sbe["admission_wait_fraction"],
                     "dispatch_gap_fraction": sbe["dispatch_gap_fraction"]}
    log("serve", f"{SERVE_NET} steady: the same requests x "
        f"{SERVE_STEADY_REPEATS} ({srep.images} images, "
        f"{srep.microbatches} microbatches) from one thread, bit-identical: "
        f"{srep.images_per_s:.1f} images/s ({srep.wall_s * 1e3:.1f} ms), "
        f"{100 * srep.images_per_s / row['ceiling_images_per_s']:.1f}% of "
        f"the ceiling; admission wait {sbe['admission_wait_fraction']:.3f}, "
        f"dispatch gap {sbe['dispatch_gap_fraction']:.3f}; first dispatch "
        f"spans of the traced run (ms) "
        f"{[round(v, 3) for v in durs['dispatch'][:5]]}  "
        f"[{record['card']}]")

    # the adaptive ladder at light load: rungs captured mid-serve
    with comp.serve(params, microbatch=BATCH, credits=SERVE_CREDITS,
                    adaptive=True) as eng:
        singles = [rng.integers(-127, 128, size=(n,) + shape, dtype=np.int8)
                   for n in ADAPTIVE_SIZES]
        for i, req in enumerate(singles):
            check(eng.submit(req).result(timeout=300), req, f"single {i}")
        outs, arep = eng.serve(reqs[:16])
    for i, (got, req) in enumerate(zip(outs, reqs[:16])):
        check(got, req, f"burst request {i}")
    if arep.trace_cache["entries"] > arep.trace_cache["max_entries"] \
            or len(arep.microbatch_shapes) < 3:
        raise AssertionError(f"adaptive: shapes {arep.microbatch_shapes}, "
                             f"trace cache {arep.trace_cache}")
    row["adaptive"] = {"microbatch_shapes": arep.microbatch_shapes,
                       "trace_cache": arep.trace_cache,
                       "images_per_s": arep.images_per_s,
                       "p50_ms": arep.p50_ms, "p99_ms": arep.p99_ms,
                       "pad_fraction": arep.pad_fraction}
    record["serving"] = row
    log("serve", f"{SERVE_NET} adaptive (ladder {eng.microbatch_ladder}): "
        f"{len(singles)} closed-loop requests then a burst of 16, "
        f"bit-identical; shapes used (rows: dispatches) "
        f"{json.dumps(arep.microbatch_shapes)}; trace cache "
        f"{json.dumps(arep.trace_cache)}; pad {arep.pad_fraction:.3f}")


def main():
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.compiler import NX2100, compile, select_engine
    from repro_torch.configs.cnn import CNN_CONFIGS, get_cnn
    from repro_torch.kernels import _build
    from repro_torch.compiler.engines import _block as block_for
    from repro_torch.kernels.conv2d_int8.ops import (_sm_count, conv2d_int8,
                                                     conv2d_int8_requant,
                                                     conv_plan,
                                                     stream_bytes_read,
                                                     stream_plan)
    from repro_torch.kernels.flash_attention.ops import flash_route
    from repro_torch.kernels.conv2d_int8.ref import conv2d_int8_ref, same_pad
    from repro_torch.kernels.pool_int8.ops import (gap_plan,
                                                   global_avgpool_int8,
                                                   maxpool_int8, pool_plan)
    from repro_torch.kernels.pool_int8.ref import (global_avgpool_int8_ref,
                                                   maxpool_int8_ref)
    from repro_torch.kernels.quant import requant_epilogue
    from repro_torch.kernels.stream_matmul.ops import (FLOAT_KERNELS,
                                                       mm_bytes_read,
                                                       mm_float_plan,
                                                       mm_plan,
                                                       stream_matmul,
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
    ptxas = start_ptxas_report(_build)
    _build.build_all()
    record["build_s"] = time.perf_counter() - t0
    log("build", f"{len(_build.SOURCES)} sources built with nvcc in "
        f"{record['build_s']:.1f} s")
    record["ptxas"] = ptxas()
    for src, found in record["ptxas"].items():
        log("build", f"{src}.cu under -Xptxas -v (registers, stack, spill "
            f"stores/loads bytes; tensor-core and dp4a SASS instructions; "
            f"for 3x3 dw_kernel the SASS instructions a MAC): " + "; ".join(
                f"{k}: {v.get('registers')}, {v.get('stack')}, "
                f"{v.get('spill_stores')}/{v.get('spill_loads')}, "
                + " ".join(f"{op} {v[op]}" for op in
                           ("HGMMA", "HMMA", "IMMA", "IDP") if v.get(op))
                + (f", {v['sass_instr_per_mac']:.2f}"
                   if v.get("sass_instr_per_mac") else "")
                for k, v in sorted(found.items())))

    nets = {n: compile(get_cnn(n), NX2100)
            for n in ("resnet50", "resnet18", "mobilenetv2", "vgg16")}
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
    sm_count = _sm_count(0)
    check_main_path_instances(record, shapes, conv_plan, stream_plan,
                              sm_count, flash_route, torch)
    ks = {k: Kernel(k) for k in CNN_KERNELS}
    for k in (LM_KERNEL,) + BWD_KERNELS + FLOAT_MM_KERNELS:
        ks[k] = Kernel(k, BF16_FLOPS_PER_S)
    # every plain version and product in f32 (no TF32): the references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8,
                             device=dev)

    def scales(n):
        return (torch.rand(n, generator=g, device=dev) * 0.09 + 0.01,
                torch.zeros(n, device=dev))

    # -- 2. every kernel against its plain version ---------------------------
    t0 = time.perf_counter()

    def hung():
        print(f"[check] FAILED: the kernel-vs-plain checks did not finish in "
              f"{CHECK_LIMIT_S} s (a kernel hangs)", file=sys.stderr,
              flush=True)
        os._exit(3)
    watchdog = threading.Timer(CHECK_LIMIT_S, hung)
    watchdog.daemon = True
    watchdog.start()
    conv_inputs = {}      # the main path's dense conv shapes, for phase 4
    n_checks = 0
    main_conv = {key[:6] for kname in ("conv2d_int8_pinned",
                                       "conv2d_int8_stream")
                 for key in shapes[kname]}
    # every dense conv shape of the six configs: K2 at each (forced onto
    # the streamed tier), K1 at each the configs pin
    comps = {n: nets[n] if n in nets else compile(get_cnn(n), NX2100)
             for n in CNN_CONFIGS}
    dense = [((sc.spec.in_h, sc.spec.in_w, sc.spec.c_in, sc.spec.c_out,
               sc.spec.k_h, sc.spec.stride), sc.streamed)
             for comp in comps.values() for sc in comp.plan.schedules
             if select_engine(sc.spec).name == "conv2d_int8"]
    conv_shapes = main_conv | {key6 for key6, _ in dense}
    pinned_shapes = {key6 for key6, streamed in dense if not streamed}
    for key6 in sorted(conv_shapes):
        h, w_, c, co, k, s = key6
        x, w, ws, b = (i8(BATCH, h, w_, c), i8(k, k, c, co), *scales(co))
        if key6 in main_conv:
            conv_inputs[key6] = (x, w, ws, b)
        want = conv2d_int8_ref(x, w, stride=s)
        want_q, want_f = requant_epilogue(want, ws, b, 0.05, True)
        if key6 in pinned_shapes:
            got = conv2d_int8(x, w, stride=s)
            ks["conv2d_int8_pinned"].err(torch, got, want)
            gq, gf = conv2d_int8_requant(x, w, ws, b, 0.05, stride=s,
                                         want_float=True)
            ks["conv2d_int8_pinned"].err(torch, gq, want_q)
            ks["conv2d_int8_pinned"].err(torch, gf, want_f)
            n_checks += 3
        for nb in sorted({1, 2, k * k}):
            got = conv2d_int8(x, w, stride=s, stream=True, n_buffers=nb)
            ks["conv2d_int8_stream"].err(torch, got, want)
            n_checks += 1
        gq, gf = conv2d_int8_requant(x, w, ws, b, 0.05, stride=s,
                                     stream=True, want_float=True)
        ks["conv2d_int8_stream"].err(torch, gq, want_q)
        ks["conv2d_int8_stream"].err(torch, gf, want_f)
        n_checks += 2
    for b, h, w_, c, k, s in [(BATCH, *key) for key in shapes["maxpool_int8"]
                              ] + MAXPOOL_EDGES:
        x = i8(b, h, w_, c)
        ks["maxpool_int8"].err(torch, maxpool_int8(x, k=k, stride=s),
                               maxpool_int8_ref(x, k=k, stride=s))
        n_checks += 1
    for b, h, w_, c in [(BATCH, *key) for key in shapes["global_avgpool_int8"]
                        ] + GAP_EDGES:
        x = i8(b, h, w_, c)
        for act in (0.05, 0.1):
            ks["global_avgpool_int8"].err(
                torch, global_avgpool_int8(x, act_scale=act),
                global_avgpool_int8_ref(x, act_scale=act))
            n_checks += 1
    fc_shapes = {(sp.c_in, sp.c_out) for comp in comps.values()
                 for sp in (sc.spec for sc in comp.plan.schedules)
                 if select_engine(sp).name == "stream_matmul"}
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
        comp = comps[n]
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
                gq, gf = conv2d_int8_requant(
                    x, w, ws, b, 0.05, stride=s, stream=stream, n_buffers=nb,
                    depthwise=True)
                if gf is not None:
                    raise AssertionError(f"{kname}: f32 values not asked for")
                ks[kname].err(torch, gq, want_q)
                n_checks += 4
    n_float = check_float_matmul(torch, g, dev, ks, fc_shapes, block_for)
    n_flash = check_flash(torch, g, dev, ks[LM_KERNEL])
    n_bwd = check_flash_bwd(torch, g, dev, ks, record)
    torch.cuda.synchronize()
    watchdog.cancel()
    record["check_s"] = time.perf_counter() - t0
    record["float_matmul_readings"] = {k: ks[k].readings
                                       for k in FLOAT_MM_KERNELS}
    record["flash_readings"] = ks[LM_KERNEL].readings
    record["flash_bwd_readings"] = {k: ks[k].readings for k in BWD_KERNELS}
    log("check", f"{n_checks} kernel-vs-plain comparisons bit-identical "
        f"({len(conv_shapes)} dense conv shapes of the six CNN configs "
        f"streamed, {len(pinned_shapes)} of them pinned; {len(fc_shapes)} "
        f"fc shapes; "
        f"{len(dw_inputs)} dw shapes of "
        f"MobileNetV1-V3; stream n_buffers in {{1, 2, k*k}}; matmul "
        f"pinned/stream/fifo; pools at {len(MAXPOOL_EDGES)} + "
        f"{len(GAP_EDGES)} edge shapes); {n_float} float-matmul comparisons "
        f"(f32, bf16 and mixed, n_buffers 1-4, every fc shape) within "
        f"FLOAT_TOL, readings "
        f"{json.dumps(record['float_matmul_readings'])}; {n_flash} "
        f"flash-attention comparisons (o and "
        f"lse at {len(FLASH_CASES)} shapes in bf16 and f32, and the model "
        f"layout) within tolerance, readings "
        f"{json.dumps(ks[LM_KERNEL].readings)}; {n_bwd} flash-backward "
        f"comparisons (dq, dk, dv at {len(FLASH_CASES)} shapes in bf16 and "
        f"f32, their f32 sums at {len(BWD_SUM_CASES)} shapes, and "
        f"flash_attention_vjp against autograd) within tolerance, "
        f"readings {json.dumps(record['flash_bwd_readings'])}, vjp share of "
        f"limit {json.dumps(record['vjp_share_of_limit'])}; in "
        f"{record['check_s']:.1f} s")

    # -- 3. the slice through the kernels ------------------------------------
    params, images, logits = {}, {}, {}
    launches = {}
    for name, comp in nets.items():
        cfg = comp.cfg
        gen = torch.Generator().manual_seed(SEED)
        params[name] = init_cnn_params(cfg, gen, dev)
        images[name] = torch.randint(-127, 128, cnn_input_shape(cfg, BATCH),
                                     generator=gen, dtype=torch.int8).to(dev)
    ex = {n: PipelineExecutor(c, device=dev, backend="eager")
          for n, c in nets.items()}
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
        t_plain = time.perf_counter()
        plain = cnn_forward(params[name], comp.cfg, images[name])
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t_plain
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
            f"the plain path on the card (which took {t_plain * 1e3:.1f} ms); "
            f"Eq. 2 verified; streamed words {rep.total_hbm_words} = "
            f"{plan_words // BATCH} x {BATCH}")
    # the main path: the same nets through run()'s default, the fused
    # backend (one CUDA graph a shape), and ResNet-50 served over it
    fused_launches = drive_fused(torch, nets, params, images, logits,
                                 reports, launches, record)
    total_launches = {}
    for per in fused_launches.values():
        for k, v in per.items():
            total_launches[k] = total_launches.get(k, 0) + v
    launches.update({f"{n} fused": v for n, v in fused_launches.items()})
    serve_cnn(torch, np, nets[SERVE_NET], params[SERVE_NET],
              fused_launches[SERVE_NET], dev, record)
    fpath = float_path(comps, select_engine)
    launches["float matmul"], float_inputs = drive_float_matmul(
        torch, g, dev, fpath, block_for, record)
    total_launches.update(launches["float matmul"])
    lm = serve_lm(torch, np, dev, record)
    launches[LM_ARCH] = lm["launches"]
    total_launches[LM_KERNEL] = lm["launches"][LM_KERNEL]

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

    torch.backends.cudnn.allow_tf32 = False    # library_conv's TF32 call
    # turns it on for itself only
    # Eq. 2 words of one streamed dense conv layer, by shape
    eq2_words = {(sc.spec.in_h, sc.spec.in_w, sc.spec.c_in, sc.spec.c_out,
                  sc.spec.k_h, sc.spec.stride):
                 sc.weight_words_per_row * sc.spec.out_h * BATCH
                 for comp in nets.values() for sc in comp.plan.schedules
                 if sc.streamed}
    # per dense conv shape: launches, device ms a launch, bytes, bound, the
    # library calls, their ms and exactness, the plan (conv_per_shape)
    conv_shape_rows = {"conv2d_int8_pinned": {}, "conv2d_int8_stream": {}}
    for key6, (x, w, ws, b) in conv_inputs.items():
        h, w_, c, co, k, s = key6
        ho, wo = -(-h // s), -(-w_ // s)
        lib = None
        for kname, stream in (("conv2d_int8_pinned", False),
                              ("conv2d_int8_stream", True)):
            keys = [kk for kk in shapes[kname] if kk[:6] == key6]
            if not keys:
                continue
            n = sum(shapes[kname][kk] for kk in keys)
            fc = any(kk[7] for kk in keys)
            kern = ks[kname]
            time_kernel(kname, keys, lambda: conv2d_int8_requant(
                x, w, ws, b, 0.05, stride=s, stream=stream, n_buffers=2,
                want_float=fc))
            kern.plain_ms += n * plain_ms(lambda: requant_epilogue(
                conv2d_int8_ref(x, w, stride=s), ws, b, 0.05, True))
            nbytes = input_bytes_read(x, k, s) + w.numel() + 8 * co \
                + BATCH * ho * wo * co * (5 if fc else 1)
            ops = 2 * BATCH * ho * wo * co * k * k * c
            kern.bytes += n * nbytes
            kern.ops += n * ops
            if lib is None:
                lib = library_readings(
                    torch, library_conv(torch, F, x, w, s, same_pad),
                    conv2d_int8_ref(x, w, stride=s))
            row = {"launches": n, "ms": per_launch[kname][keys[0]],
                   "bytes": nbytes, "bound_ms": bound_ms(nbytes, ops)[0],
                   **lib}
            if not stream:
                plan = conv_plan(BATCH, h, w_, c, co, k, k, s, sm_count)
                row["plan"] = {f: getattr(plan, f) for f in (
                    "n_tile", "rows_per_band", "bands", "packed",
                    "ring_rows", "smem_bytes")}
            else:
                # what a launch reads from device memory, beside the Eq. 2
                # words the executor counts for a layer of this shape
                plan = stream_plan(BATCH, h, w_, c, co, k, k, s, 2, sm_count)
                row["plan"] = {f: getattr(plan, f) for f in (
                    "n_tile", "g", "groups", "nseg", "kb", "nkb", "nb",
                    "rows_per_band", "bands", "smem_bytes")}
                wb, ib = stream_bytes_read(plan, h, w_, c, co, k, k, s)
                row.update(weight_bytes_read=wb, input_bytes_read=ib,
                           eq2_words=eq2_words[key6],
                           weight_gb_per_s=wb / (row["ms"] * 1e6))
            conv_shape_rows[kname][",".join(map(str, key6))] = row
    # per dw shape: launches, device ms a launch, bytes, bound, cuDNN ms
    dw_shape_rows = {"dwconv_int8_pinned": {}, "dwconv_int8_stream": {}}
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
            lib_ms = device_ms(
                torch, lambda: F.conv2d(xp, wf, stride=s, groups=c), reps=20)
            kern.library_ms += n * lib_ms
            ho, wo = -(-h // s), -(-w_ // s)
            nbytes = input_bytes_read(x, k, s) + w.numel() + 8 * c \
                + BATCH * ho * wo * c
            ops = 2 * BATCH * ho * wo * c * k * k
            kern.bytes += n * nbytes
            kern.ops += n * ops
            dw_shape_rows[kname][",".join(map(str, key))] = {
                "launches": n, "ms": per_launch[kname][key],
                "bytes": nbytes, "bound_ms": bound_ms(nbytes, ops)[0],
                "library_ms": lib_ms}
    # per pool shape: launches, device ms a launch, bytes, bound, the plan;
    # for the maxpool F.max_pool2d(ceil_mode=True) (library_maxpool), for
    # the global average pool the launch floor: a graph-replayed
    # one-element add_ on the same card
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(torch, lambda: one.add_(1), reps=20)
    pool_rows = {}
    kern = ks["maxpool_int8"]
    kern.library_ms = 0.0
    for key, n in shapes["maxpool_int8"].items():
        h, w_, c, k, s = key
        x = i8(BATCH, h, w_, c)
        time_kernel("maxpool_int8", [key],
                    lambda: maxpool_int8(x, k=k, stride=s))
        kern.plain_ms += n * plain_ms(lambda: maxpool_int8_ref(x, k=k,
                                                               stride=s))
        ho, wo = -(-h // s), -(-w_ // s)
        nbytes = input_bytes_read(x, k, s) + BATCH * ho * wo * c
        ops = BATCH * ho * wo * c * k * k
        kern.bytes += n * nbytes
        kern.ops += n * ops
        lib = library_maxpool(torch, F, x, k, s)
        if lib["library_ms"] is None:
            raise AssertionError(f"maxpool {key}: no library call: {lib}")
        kern.library_ms += n * lib["library_ms"]
        plan = pool_plan(BATCH, h, w_, c, k, s, sm_count)
        pool_rows["maxpool:" + ",".join(map(str, key))] = {
            "launches": n, "ms": per_launch["maxpool_int8"][key],
            "bytes": nbytes, "bound_ms": bound_ms(nbytes, ops)[0], **lib,
            "plan": {f: getattr(plan, f) for f in (
                "rows", "seg", "cc", "vec", "cols", "threads",
                "smem_bytes")},
            "ctas": plan.bands * plan.segs * plan.c_tiles * BATCH}
    kern = ks["global_avgpool_int8"]
    kern.floor_ms = floor_ms
    for key, n in shapes["global_avgpool_int8"].items():
        h, w_, c = key
        x = i8(BATCH, h, w_, c)
        time_kernel("global_avgpool_int8", [key],
                    lambda: global_avgpool_int8(x, act_scale=0.05))
        kern.plain_ms += n * plain_ms(
            lambda: global_avgpool_int8_ref(x, act_scale=0.05))
        nbytes, ops = x.numel() + BATCH * c, BATCH * h * w_ * c
        kern.bytes += n * nbytes
        kern.ops += n * ops
        plan = gap_plan(BATCH, h, w_, c, sm_count)
        ms = per_launch["global_avgpool_int8"][key]
        pool_rows["gap:" + ",".join(map(str, key))] = {
            "launches": n, "ms": ms, "bytes": nbytes,
            "bound_ms": bound_ms(nbytes, ops)[0], "floor_ms": floor_ms,
            "factor_on_floor": ms / floor_ms,
            "plan": {f: getattr(plan, f) for f in (
                "vec", "cc", "groups", "threads", "smem_bytes")},
            "ctas": plan.c_tiles * BATCH}
    record["pool_per_shape"] = pool_rows
    log("time", "pools per shape (key: launches x us, bound us, library or "
        "floor us; CTAs): " + "; ".join(
            f"{key}: {r['launches']} x {r['ms'] * 1e3:.2f}, "
            f"{r['bound_ms'] * 1e3:.2f}, "
            + (f"F.max_pool2d {r['library_ms'] * 1e3:.2f}"
               + ("" if r["library_exact"] else " (not exact)")
               if "library_ms" in r else
               f"floor {r['floor_ms'] * 1e3:.2f} "
               f"({r['factor_on_floor']:.2f}x)")
            + f"; {r['ctas']}" for key, r in pool_rows.items())
        + f"  [{card}]")
    # per fc head: launches, device ms a launch, bytes, bound, the plan,
    # the bytes a launch reads and the weights' GB/s, and the library:
    # torch._int_mm, which refuses M <= 16, on x padded with zero rows to
    # M = 32 (the padding outside the timed call)
    mm_shape_rows = {}
    for mode in ("pinned", "fifo"):
        kname = f"stream_matmul_{mode}"
        kern = ks[kname]
        kern.library_ms = 0.0
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
            nbytes = x.numel() + w.numel() + 8 * c_out \
                + BATCH * c_out * (5 if last else 1)
            ops = 2 * BATCH * c_in * c_out
            kern.bytes += n * nbytes
            kern.ops += n * ops
            xp = torch.zeros((32, c_in), dtype=torch.int8, device=dev)
            xp[:BATCH] = x
            lib = library_readings(torch, [{
                "name": "torch._int_mm (M padded to 32)",
                "fn": lambda: torch._int_mm(xp, w),
                "out": lambda: torch._int_mm(xp, w)[:BATCH],
                "refused": None}], stream_matmul_ref(x, w))
            kern.library_ms += n * lib["library_ms"]
            plan = mm_plan(BATCH, c_in, c_out, mode, bk, nb, sm_count)
            wb, xb = mm_bytes_read(plan, BATCH, c_in, c_out)
            ms = per_launch[kname][key]
            mm_shape_rows[f"{mode}:{c_in},{c_out}"] = {
                "launches": n, "ms": ms, "bytes": nbytes,
                "bound_ms": bound_ms(nbytes, ops)[0], **lib,
                "plan": {f: getattr(plan, f) for f in (
                    "tn", "split", "kr", "kblk", "nb", "vec")},
                "ctas": plan.n_tiles * plan.split * plan.m_tiles,
                "weight_bytes_read": wb, "x_bytes_read": xb,
                "weight_gb_per_s": wb / (ms * 1e6)}
    record["matmul_per_shape"] = mm_shape_rows
    # the float matmul per path entry (one launch each): device ms, bytes
    # (operands read once, the output written once), bound (f32 products
    # at 67 TFLOP/s FFMA, bf16 at 989), plain ms, and torch.matmul in the
    # operands' type (TF32 off)
    float_rows = {}
    t_bytes = {k: 0.0 for k in FLOAT_MM_KERNELS}
    t_ops = dict(t_bytes)
    for kname in FLOAT_MM_KERNELS:
        ks[kname].library_ms = 0.0
    for (k_, n_, mode, dname), (x, w) in float_inputs.items():
        kern = ks[FLOAT_KERNELS[mode]]
        bk = block_for(k_, 512)
        reps = 5 if (k_, n_) == FC0_MATMUL[1:] else 20

        def fn():
            return stream_matmul(x, w, mode=mode, bk=bk, n_buffers=2)
        ms, cms = device_ms(torch, fn, reps=reps), call_ms(torch, fn, reps)
        pms = device_ms(torch, lambda: stream_matmul_ref(x, w), reps=3,
                        replays=2)
        lms = device_ms(torch, lambda: torch.matmul(x, w), reps=reps)
        ref = stream_matmul_ref(x, w).double()
        lib_diff = float((torch.matmul(x, w).double() - ref).abs().max())
        es = x.element_size()
        nbytes = (BATCH * k_ + k_ * n_ + BATCH * n_) * es
        ops = 2 * BATCH * k_ * n_
        rate = FP32_FLOPS_PER_S if dname == "float32" else BF16_FLOPS_PER_S
        b, by = bound_ms(nbytes, ops, rate)
        kern.ms += ms
        kern.plain_ms += pms
        kern.library_ms += lms
        kern.bound_ms += b
        t_bytes[kern.name] += nbytes / HBM_BYTES_PER_S
        t_ops[kern.name] += ops / rate
        plan = mm_float_plan(BATCH, k_, n_, mode, bk, 2, es, es, sm_count)
        float_rows[f"{mode}:{k_},{n_}:{dname}"] = {
            "ms": ms, "call_ms": cms, "plain_ms": pms, "library_ms": lms,
            "library_max_abs_diff": lib_diff, "bytes": nbytes,
            "flops": ops, "bound_ms": b, "bound_by": by,
            "factor_on_library": ms / lms, "weight_gb_per_s":
                k_ * n_ * es / (ms * 1e6),
            "plan": {f: getattr(plan, f) for f in (
                "tn", "split", "kr", "kblk", "nb", "wvec", "smem_bytes")},
            "ctas": plan.n_tiles * plan.split * plan.m_tiles}
    for kname in FLOAT_MM_KERNELS:
        ks[kname].bound_by = ("bytes" if t_bytes[kname] >= t_ops[kname]
                              else "operations")
    del float_inputs
    record["float_matmul_per_shape"] = float_rows
    log("time", "float matmul per path entry (mode:K,N:type: us, bound "
        "us, torch.matmul us, factor; weight GB/s; CTAs): " + "; ".join(
            f"{key}: {r['ms'] * 1e3:.2f}, {r['bound_ms'] * 1e3:.2f}, "
            f"{r['library_ms'] * 1e3:.2f}, {r['factor_on_library']:.2f}; "
            f"{r['weight_gb_per_s']:.0f}; {r['ctas']}"
            for key, r in float_rows.items()) + f"  [{card}]")
    log("time", "matmul per fc head (mode:K,N: launches x us, bound us, "
        "padded torch._int_mm us; CTAs, weight GB/s): " + "; ".join(
            f"{key}: {r['launches']} x {r['ms'] * 1e3:.2f}, "
            f"{r['bound_ms'] * 1e3:.2f}, {r['library_ms'] * 1e3:.2f}; "
            f"{r['ctas']}, {r['weight_gb_per_s']:.0f}"
            for key, r in mm_shape_rows.items()) + f"  [{card}]")
    for name in CNN_KERNELS:
        kern = ks[name]
        kern.ms = sum(n * per_launch[name][key]
                      for key, n in shapes[name].items())
        kern.bound_ms, kern.bound_by = bound_ms(kern.bytes, kern.ops)
    # K1 and K2 against the library: torch._int_mm for the 1x1 shapes,
    # the faster exact of cuDNN's fp32 and TF32 convs for the k > 1 shapes
    # (library_readings); the split by kernel size, for the factor on
    # each, with each library call's sum beside it
    record["conv_per_shape"] = conv_shape_rows
    for kname, rows in conv_shape_rows.items():
        kern = ks[kname]
        have = [r for r in rows.values() if r["library_ms"] is not None]
        kern.library_ms = sum(r["launches"] * r["library_ms"] for r in have)
        kern.library_covers = (sum(r["launches"] for r in have),
                               sum(r["launches"] * r["ms"] for r in have))
        by_k = {}
        for key, r in rows.items():
            part = by_k.setdefault("1x1" if key.split(",")[4] == "1"
                                   else "k>1", {"launches": 0, "ms": 0.0,
                                                "library_ms": 0.0,
                                                "by_call": {}})
            part["launches"] += r["launches"]
            part["ms"] += r["launches"] * r["ms"]
            part["library_ms"] += r["launches"] * (r["library_ms"] or 0.0)
            for name, d in r["library_calls"].items():
                if "ms" in d:
                    part["by_call"][name] = part["by_call"].get(name, 0.0) \
                        + r["launches"] * d["ms"]
        record[f"{kname}_by_kernel_size"] = by_k
        log("time", f"{kname} per shape (h,w,c,co,k,s: launches x us, "
            f"bound us, library us, exact; plan n_tile/rows/bands): "
            + "; ".join(
                f"{key}: {r['launches']} x {r['ms'] * 1e3:.2f}, "
                f"{r['bound_ms'] * 1e3:.2f}, "
                + (" / ".join(
                    f"{name} {d['ms'] * 1e3:.2f}, "
                    + ("exact" if d["exact"] else
                       f"max diff {d['max_abs_diff']:g}")
                    for name, d in r["library_calls"].items() if "ms" in d)
                   if r["library_ms"] is not None else "no library")
                + (f"; {r['plan']['n_tile']}/{r['plan']['rows_per_band']}/"
                   f"{r['plan']['bands']}" if "plan" in r else "")
                for key, r in rows.items()) + f"  [{card}]")
        log("time", f"{kname} by kernel size: " + "; ".join(
            f"{part} over {d['launches']} launches {d['ms']:.4f} ms "
            f"(device), library {d['library_ms']:.4f} ms, factor "
            f"{d['ms'] / d['library_ms'] if d['library_ms'] else 0:.3f} ("
            + ", ".join(f"{name} {t:.4f} ms" for name, t in
                        d["by_call"].items()) + ")"
            for part, d in by_k.items()) + f"  [{card}]")
    rows = conv_shape_rows["conv2d_int8_stream"]
    log("time", "conv2d_int8_stream reads per launch (h,w,c,co,k,s: weight "
        "MB read, Eq. 2 words of a layer in M (80-bit), input MB read, "
        "weight GB/s; plan n_tile/g/kb/nb/rows): " + "; ".join(
            f"{key}: {r['weight_bytes_read'] / 1e6:.1f}, "
            f"{r['eq2_words'] / 1e6:.1f}, {r['input_bytes_read'] / 1e6:.1f}, "
            f"{r['weight_gb_per_s']:.0f}; {r['plan']['n_tile']}/"
            f"{r['plan']['g']}/{r['plan']['kb']}/{r['plan']['nb']}/"
            f"{r['plan']['rows_per_band']}" for key, r in rows.items())
        + f"  [{card}]")
    # K2 and the matmul against the library, per net
    by_net = {}
    for net, per in per_net.items():
        for kname, prefix in (("conv2d_int8_stream", ""),
                              ("stream_matmul_pinned", "pinned:"),
                              ("stream_matmul_fifo", "fifo:")):
            for key, n in per[kname].items():
                r = (conv_shape_rows[kname][",".join(map(str, key[:6]))]
                     if not prefix else
                     mm_shape_rows[f"{prefix}{key[0]},{key[1]}"])
                d = by_net.setdefault(net, {}).setdefault(
                    kname, {"launches": 0, "ms": 0.0, "library_ms": 0.0})
                d["launches"] += n
                d["ms"] += n * r["ms"]
                d["library_ms"] += n * (r["library_ms"] or 0.0)
    record["streamed_by_net"] = by_net
    log("time", "K2 and the matmul by net (launches, device ms, library "
        "ms, factor): " + "; ".join(
            f"{net} {k}: {d['launches']}, {d['ms']:.4f}, "
            f"{d['library_ms']:.4f}, "
            f"{d['ms'] / d['library_ms'] if d['library_ms'] else 0:.2f}"
            for net, per in by_net.items() for k, d in per.items())
        + f"  [{card}]")
    record["dw_per_shape"] = dw_shape_rows
    for kname, rows in dw_shape_rows.items():
        log("time", f"{kname} per shape (h,w,c,k,s,nb: launches x us, "
            f"bound us, cuDNN us): " + "; ".join(
                f"{key}: {r['launches']} x {r['ms'] * 1e3:.2f}, "
                f"{r['bound_ms'] * 1e3:.2f}, {r['library_ms'] * 1e3:.2f}"
                for key, r in rows.items()) + f"  [{card}]")
    record["ms_per_launch"], record["call_ms_per_launch"] = (
        {k: {",".join(map(str, key)): t for key, t in d.items()}
         for k, d in times.items()} for times in (per_launch, per_call))
    record["kernel_ms_by_net"], record["kernel_call_ms_by_net"] = (
        {net: {k: sum(n * times[k][key] for key, n in d.items())
               for k, d in per.items() if d}
         for net, per in per_net.items()} for times in (per_launch, per_call))

    def host_ms(fn, n):
        """ms of each of ``n`` calls on the host's clock, each ending in a
        synchronise."""
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return out

    e2e = {}
    for name, comp in nets.items():
        run = lambda: ex[name].run(params[name], images[name])  # noqa: E731
        # eager and fused in turns, so both see the same card and host
        times, fused_t = [], []
        for _ in range(2):
            times += host_ms(run, 4)
            fused_t += host_ms(lambda: comp.run(params[name], images[name]),
                               4)
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
        fused_ms = statistics.median(fused_t)
        split = fused_host_split(torch, comp, params[name], images[name])
        e2e[name] = {"ms_per_forward": ms, "images_per_s": BATCH / ms * 1e3,
                     "device_ms_per_forward": dev_ms,
                     "idle_share": 1 - dev_ms / ms,
                     "fused_ms_per_forward": fused_ms,
                     "fused_images_per_s": BATCH / fused_ms * 1e3,
                     "fused_idle_share": 1 - dev_ms / fused_ms,
                     "plain_ms_per_forward": statistics.median(plain_t),
                     "runs_ms": times, "fused_runs_ms": fused_t,
                     "fused_host_split": split}
        log("time", f"{name} batch {BATCH}: eager {ms:.3f} ms per forward "
            f"(warm median of {len(times) - 1}), fused {fused_ms:.3f} ms "
            f"(median of {len(fused_t)}), {BATCH / fused_ms * 1e3:.1f} "
            f"images/s fused; device {dev_ms:.3f} ms (card idle "
            f"{100 * (1 - dev_ms / ms):.0f}% of the eager forward, "
            f"{100 * (1 - dev_ms / fused_ms):.0f}% of the fused one); "
            f"plain path {e2e[name]['plain_ms_per_forward']:.3f} ms; fused "
            f"split (ms to return / to synchronised): " + ", ".join(
                f"{k} {split[k + '_return_ms']:.3f} / {split[k + '_ms']:.3f}"
                for k in ("run", "fn", "replay")) + f"  [{card}]")
    record["end_to_end"] = e2e
    time_lm(torch, lm, card, record)
    del lm
    record["time_s"] = time.perf_counter() - t0

    # -- 3 and 4 for LM training, with the serving phase's weights freed ----
    train = train_lm(torch, np, dev, record, card)
    launches[LM_ARCH + " training"] = train
    for k in (LM_KERNEL,) + BWD_KERNELS:
        total_launches[k] = total_launches.get(k, 0) + train[k]
    missing = [k for k in KERNELS if not total_launches.get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on the path: "
                             f"{missing}")
    record["launches"] = launches
    t0 = time.perf_counter()
    time_flash(torch, F, g, dev, ks[LM_KERNEL], total_launches[LM_KERNEL],
               card, record)
    time_flash_bwd(torch, F, g, dev, ks, total_launches, card, record)
    record["time_s"] += time.perf_counter() - t0

    # -- 5. report ------------------------------------------------------------
    rows = []
    for name, kern in ks.items():
        src, replaces = KERNELS[name]
        # the launches library_ms covers, and this kernel's ms over them
        lib_n, lib_k_ms = kern.library_covers or (
            (total_launches[name], kern.ms) if kern.library_ms is not None
            else (0, 0.0))
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": total_launches[name],
                     "max_abs_err": kern.max_abs_err, "ms": kern.ms,
                     "plain_ms": kern.plain_ms, "bound_ms": kern.bound_ms,
                     "bound_by": kern.bound_by,
                     "library_ms": kern.library_ms,
                     "library_launches": lib_n,
                     "ms_on_library_launches": lib_k_ms})
        if kern.floor_ms is not None:      # the launch floor, beside K6
            rows[-1]["floor_ms"] = kern.floor_ms * total_launches[name]
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
