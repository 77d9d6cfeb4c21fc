#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and when
it is run outside a checkout of the repository.  Phases, one line each:

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` a source, all at once), and from the build's own
     ``-Xptxas -v`` report of ``dwconv_int8.cu``, ``conv2d_int8.cu``,
     ``flash_attention.cu``, ``stream_matmul.cu`` (the int8 ``mm_kernel``
     and the float ``mm_float_tc`` and ``mm_float`` instances) and
     ``pool_int8.cu``:
     registers, stack and spills of every kernel
     instance (full logs ``ptxas_dwconv.log``, ``ptxas_conv.log``,
     ``ptxas_flash.log``, ``ptxas_matmul.log`` and ``ptxas_pool.log`` in
     the output directory), and from the SASS the
     count of HGMMA, HMMA, IMMA and IDP instructions of each instance and
     the instructions a MAC of each 3x3 ``dw_kernel``'s MAC block; it
     fails unless the instance each main-path launch of K1 (``conv_mma``),
     K2 (``conv_stream``, from the conv plans of its shape) and K9
     (``flash_fwd_wgmma<128>`` for Phi-4-mini, Qwen2-MoE, InternVL2,
     Qwen2-72B and Command R+, ``flash_fwd_wgmma<64>`` for SeamlessM4T,
     ``flash_fwd_bf16<192,128>`` for DeepSeek-V2's MLA and
     ``flash_fwd_bf16<32,32>`` for the reduced configs' head dims 16 and
     24, from the flash route and ``kernel_widths`` of their head dims)
     takes issues IMMA, HGMMA or HMMA, and where a K2 instance spills;
  2. hold every kernel against its plain PyTorch version on the card: the
     streamed dense conv (K2) at every dense conv shape of the six CNN
     configs compiled for ``NX2100`` at batch 8, forced onto the streamed
     tier with ``n_buffers`` in {1, 2, k*k}, the pinned one (K1) at every
     shape a config pins, the fc-head matmul (K7/K8) at every fc shape of
     the six configs in its pinned, stream and fifo modes, the pools at
     the main path's shapes and at edge shapes (odd maps, k = 3 at
     stride 1, the generic window, C of 4, 6 and 20) (int8, f32 and int32
     outputs bit-identical); the float matmul (``mm_float``) at
     ``FLOAT_CHECK_SHAPES`` at each of ``FLOAT_PAIRS`` (every pair over
     f32, bf16, f16 and int8 but int8 x int8) in every mode, the fifo ring
     1 to 4 deep, every fc shape at M = 8 in f32 and bf16, and every pair
     at every entry of the float path, each output of the promoted type
     and within ``FLOAT_TOL`` (an f16 output within bf16's), and the f32-x
     tensor-core pairs on edge values at fc0 (``EDGE_PAIRS``: inf and NaN
     where the plain version has them);
     the depthwise kernels at every dw shape of MobileNetV1, V2 and V3 in
     both tiers (streamed with ``n_buffers`` in {1, 2, k*k}); the
     flash-attention forward (o and lse) at the LM slice's prefill shape,
     at S = 2048, at the five ``ATTN_CASES`` of ``tests/test_kernels.py``,
     at hd=192/hd_v=128 and at the LM families' prefill shapes
     (``FLASH_MAIN``: Qwen2-MoE's, DeepSeek-V2's, SeamlessM4T's
     non-causal encoder at S = 1024 and its decoder, InternVL2's,
     Qwen2-72B's, Command R+'s) and the reduced configs'
     (``FLASH_REDUCED``: head dims 16 and 24 / 16 at 8, 16 and 64
     tokens), in bf16 and f32, and at the dry run's
     Phi-4-mini cells (``FLASH_DRYRUN``: S = 32768 and 4096 at batch 1)
     in bf16, within ``FLASH_TOL`` (per
     dtype and output; lse to 1e-4); the flash-attention backward (K10:
     dq; K11: dk, dv) at ``FLASH_CASES`` and the train_4k cell's shape in
     both dtypes on K9's o and lse, within ``BWD_TOL``; their f32 sums (bf16 operands, f32 outputs)
     against the plain backward on the f32 casts of the same operands at
     ``BWD_SUM_CASES``, within ``BWD_SUM_TOL``, which sees below bf16's
     precision; and the differentiable ``flash_attention_vjp`` against
     autograd through the plain forward at ``VJP_CASES`` (at batch 1
     also given a gradient of batch stride 1); at the reduced head dims,
     which the kernels run padded to a width of 32, K9-K11 on rows with
     NaN past the head dim into rows with a sentinel past it, which must
     stay finite and in place (``check_padded_rows``);
  3. the slices: ``compile(cfg, NX2100)`` -> ``PipelineExecutor(...,
     backend="eager")`` on the card at batch 8 on 224x224 inputs, with
     seeded random weights, for ResNet-50, ResNet-18, MobileNetV2 as
     compiled (every dw layer pinned), VGG-16 (conv8-10 and fc0 on the
     streamed conv, fc1 and fc2 on the fifo matmul), MobileNetV1,
     MobileNetV3 and MobileNetV2 with
     every dw layer forced onto the HBM tier (``with_offload``): logits
     equal to the plain path's bit for bit (the plain path's time logged),
     the Eq. 2 report verified.  Then the main path, the same seven nets
     through ``run()``'s default, the fused backend (the forward captured
     once as a CUDA graph, replayed by every warm run): logits and report
     equal to the eager run's, the launches of a warm run (added by the
     replay) equal to the eager run's, one trace a net with its hits
     counted.  Then the ``H100`` target (``[h100]`` lines,
     ``h100_target``): the card's opt-in shared memory a block, read
     from the driver, equal to ``MAX_SMEM_BYTES``; the six nets compiled
     for it keeping NX2100's tiers; MobileNetV1 and V3 compiled for it,
     eager and fused, bit-identical to the NX2100-compiled runs;
     ``WIDE_CONV``, a conv no pinned plan fits, whose launch raises
     compiled for NX2100 and which runs streamed, bit-identical to the
     plain path, compiled for ``H100``.
     Then ResNet-50 served over it (``cp.serve(microbatch=8,
     credits=4)``): 64 requests of 1-8 images from 4 producer threads,
     each bit-identical to the eager ``run()`` of its images, at most 4
     microbatches in flight, one trace, the Eq. 2 words of the images,
     microbatches x a forward's launches; images/s, latency percentiles,
     pad fraction, the measured stall fractions and the host spans of the
     traced interval beside the ceiling of 8 images a replay of the
     forward's graph; then the adaptive ladder (1, 2, 4, 8) at light
     load, its rungs captured mid-serve, bit-identical.
     The autotuned compile path (``[autotune]`` lines): ResNet-50 and
     VGG-16 through ``compile(cfg, NX2100, autotune=True)`` (the default
     ``AutotuneConfig()``; the host search runs in a thread beside the
     build), each search's ``summary()`` and host seconds, the streamed
     sets and knobs equal to ``TUNED``; both tuned nets then run through
     every step above beside the greedy nets (plain path, eager, fused:
     bit-identical; Eq. 2 verified; K2 launches equal to the streamed
     convs K2's engines own).  Tuned ResNet-50 is served at its tuned
     credits (``cp.serve(microbatch=8)``, no ``credits``), the same 64
     requests and checks.  Then the front end (``[frontend]`` lines):
     ``MultiTenantFrontEnd`` over two engines on the card, tuned ResNet-50
     and MobileNetV2 as compiled (``queue_depth=4``, at most 8 requests
     outstanding), four tenants (``FRONTEND_TENANTS``) fed by 4 producer
     threads: every request bit-identical to the eager ``run()`` of its
     images; the credit bounds held and quiescent; under backlog the
     ResNet-50 tenants' delivered images 4:1 within 20% and their Jain
     index at least 0.95; the 0 ms deadline tenant promoted; images/s,
     latency percentiles and deadline misses per tenant beside each
     net's single-engine ceiling.
     Then sharded serving (``[sharded]`` lines): ResNet-50 cut into S = 1,
     2 and 4 stages and VGG-16 into 4 (``compiled.partition(S)``: its
     ``describe()`` and ``modelled_throughput(8·S)``, per-stage Eq. 2
     verified and summing to 8,095,354 and 28,878,467 words an image),
     each served by ``compiled.serve_sharded(params, mesh=compat_make_mesh(
     (S,), ("model",), devices=["cuda:0"] * S), microbatch=8)``: one
     captured CUDA graph and one stream a stage on the one card, the
     stage graphs' launches summing to a forward's; the serving phase's
     64 requests (12 for VGG-16) from 4 threads round-robin, then again
     with explicit ``shard=`` routing, then SERVE_STEADY_REPEATS times
     over from one thread (the steady state): every request
     bit-identical to the eager ``run()`` of its images, the credit bound
     held and quiescent, launches (microbatches + empty slots) x the
     stage graphs'; printed
     without a claim: images/s, latency percentiles and round fill per S
     beside the single engine's ``cp.serve`` figure and the ceiling of 8
     images a graph replay, each stage graph's device ms, a round's
     device span beside the sum of its stage replays (whether the stage
     streams overlap on the die), and the modelled speedup beside the
     measured S-stage / 1-stage ratio.
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
     Then GPipe training (``[gpipe]`` lines, ``gpipe_lm``), the training
     weights freed: Phi-4-mini's 32 decoder layers at full width cut into
     4 stages on ``compat_make_mesh((4,), ("model",), devices=["cuda:0"]
     * 4)`` (a stream a stage), 4 microbatches of 1x512 tokens'
     embeddings through ``gpipe_train_step``: exactly 128 K9, K10 and K11
     launches at (1, 24, 8, 512) (``FLASH_GPIPE``), the loss and every
     gradient leaf against the same stages under plain autograd with no
     ring (``LOSS_REL_TOL``, ``GRAD_REL_TOL``), every stage's gradients
     finite and non-zero; the step's ms, its device span beside the
     sequential run's and the peak memory printed.  Then
     ``trace_fused_abstract`` (``[abstract]`` lines) of ResNet-50 and
     VGG-16 compiled for ``NX2100`` at batch 8, scanned and unrolled, on
     ``meta``: the seconds and the aten ops counted, the card's allocated
     memory unchanged across each call and the engines dispatched equal
     to the engine table.
     K9's launches are counted by shape at the launch, in every LM phase.
     Then the other LM families (``LM_ARCHS``, ``serve_arch``), with
     Phi-4-mini's weights freed, one at a time, each freed before the
     next, each through ``ServingEngine(batch_slots=4)`` at full width in
     bf16 (zero frames or patches, as the JAX engine feeds them):
     Qwen2-MoE-A2.7B whole and DeepSeek-V2 cut to 6 of its 60 layers (8
     requests of 512 tokens; K9 on ``flash_fwd_wgmma<128>`` and
     ``flash_fwd_bf16<192,128>``), Hymba-1.5B and xLSTM-125M whole (8
     requests of 2048 tokens, max_seq 4096: Hymba's 1024-slot ring wraps
     in decode), SeamlessM4T-medium, InternVL2-26B and Gemma2-9B whole,
     Qwen2-72B and Command R+ cut to 4 layers (8 requests of 512 tokens):
     the drawn parameters counted, K9's launches exactly 48 / 12 / 0 / 0
     / 24 + 24 / 96 / 0 / 8 / 8 at the arch's shapes (SeamlessM4T's
     encoder and decoder apart), every request complete, admission
     quiescent.  Where K9 runs, on the engine's feed and on seeded
     frames or patches, with both paths' MoE routing read layer by layer:
     the rows whose routing agrees held to the plain path's prefill
     logits within ``LM_REL_TOL`` (but on ``WHOLE_BOUND_WAIVED``) and to
     its first token where the margin allows, every layer, from the
     plain path's input and routing, within ``LM_REL_TOL`` of the plain
     layer's output, and every row's logits with the plain path's routing
     forced within ``FORCED_LIMIT`` times the plain path's distance from
     an f32 walk of the same weights, planted faults of
     ``PLANTS_CAUGHT`` seen past it; for the MoE families the
     expert-parallel MoE (``[ep]`` lines, ``ep_prefills``): the first
     4x512 prefill feed under ``compat_make_mesh((1, 4), ("data",
     "model"), devices=["cuda:0"] * 4)`` (Qwen2-MoE's 60 experts 15 a
     slot, DeepSeek-V2's 160 40 a slot) and with no mesh: the EP region
     at every MoE layer and never without the mesh, each MoE layer from
     one input and the logits with the grouped run's routing forced
     within ``LM_REL_TOL`` of the grouped path's, K9's launches equal,
     both prefills' device ms; the timings of ``time_lm``.  Then
     each in f32 (``LM_F32``, ``lm_f32``): the MoE families' kernel path
     against the plain path within ``F32_REL_TOL`` (the rows whose
     routing agrees, and every row with the routing forced), and
     ``ep_prefills`` within ``F32_REL_TOL``; for the rest, teacher-forced prefill and a decode step against forward
     within ``F32_REL_TOL``, and Hymba, xLSTM and Gemma2 against the same
     port on the host CPU.
     Then the LM dry run (``[dryrun]`` lines, ``repro_torch.launch.
     dryrun``): the meta sweep, every arch x shape on the 16x16 and
     2x16x16 meshes counted on ``meta`` by ``DRYRUN_JOBS`` processes, 0
     failures and the SKIPs of ``shape_applicable`` (``dryrun_sweep``);
     then Phi-4-mini at full width and depth on the (1, 1) local mesh at
     ``DRYRUN_CELLS`` (each shape's seq_len, the batch one card holds)
     (``dryrun_cells``): the plan's dp = 1 note, the kernel-off count
     taken on the card equal to meta's bit for bit, the kernel-mode
     step's launches (K9; K9, K10, K11 for train) and their charges in
     its count, the warm step time at least the count's t_bound
     (measured / t_bound and the model-FLOP share printed), and the peak
     memory at least the per-device argument bytes.
     Then the reduced configs (``[reduced]`` lines,
     ``reduced_launchers``): ``launch.serve --reduced`` for the ten archs
     and ``launch.train --reduced --steps 3`` for the nine of
     ``REDUCED_TRAIN``, on the card, K9-K11's launches exactly
     ``REDUCED_SERVE`` and ``REDUCED_TRAIN``'s by shape, every request
     served, every loss finite.
     Then the float matmul's path: ``stream_matmul`` at every fc head of
     the six configs as a matmul at M = 8, in the mode its engine runs,
     and VGG-16's fc0 as a 25088 x 4096 matmul streamed, at each operand
     pair of ``FLOAT_PAIRS``: launches of ``stream_matmul_float_pinned``
     and ``_fifo`` counted, outputs of the promoted type within
     ``FLOAT_TOL`` of the plain path, and the launches by instance, as
     the wrapper counts them, those the plans name (33 ``mm_float_tc``
     instances, each with HMMA in its SASS and no spill, and 8
     ``mm_float``, checked first: ``check_float_instances``, ``[build]``
     line).
     Launch counters are zeroed just before and read just after each run;
  4. time each kernel at the slice's shapes, its plain version, one
     PyTorch call computing the same function where there is one
     (``F.max_pool2d(ceil_mode=True)`` for the maxpool, whose SAME padding
     lies after the data at every main-path shape; ``torch.matmul`` in
     the operands' type, TF32 off, for the float matmul, on a mixed pair
     both operands converted to the result type inside the timed call;
     beside the
     global average pool the launch floor, a graph-replayed one-element
     ``add_``; ``torch._int_mm`` for the 1x1 convs; for the fc heads and
     VGG-16's
     fc0, a [B, K] x [K, N] product, on x padded with zero rows to M = 32,
     since it refuses M <= 16 and no float conv is exact past 2^24; the
     faster exact of cuDNN's fp32 and TF32 conv for the other dense
     convs; cuDNN's fp32 conv for the depthwise conv;
     ``scaled_dot_product_attention`` for attention, every backend tried
     and the fastest that takes the operands kept, its backward for the
     K10/K11 pair), each net end to end, each LM's prefill, decode step
     and engine run, and the training step (eager ms of steps 2-3, and one
     more step traced by ``torch.profiler`` for its device ms);
  5. the port's six examples (``[examples]`` lines, ``run_examples``):
     each ``examples_torch/*.py`` ``main()`` in this process on the card
     at its default arguments (``train_lm`` at 20 steps), its output in
     ``example_<name>.txt`` in the output directory, its own checks read
     from it; then print the ``kernels`` JSON line, the card's name and
     power limit, and last ``{"ok": true, "device": ...}``.

Times are per slice run (one forward of each of the seven nets, and the
LM's engine run and 3 training steps; ``launches`` counts the fused warm run
of each net, and for K9–K11 also the dry run's counted steps, the GPipe
step and the expert-parallel prefills): a kernel's
``ms`` sums its launches on that path, K9–K11's each at the shape it was
launched at (the record also splits it per net and per launch, and K9–K11's
per shape; for the dense and the depthwise kernels, per shape, the bytes,
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
import atexit
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card's peaks, one copy in the port (roofline/hw.py: H100 SXM data
# sheet); outside a checkout this import fails and the script with it
from repro_torch.roofline.hw import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, L2_BYTES, PEAK_FLOPS_BF16 as BF16_FLOPS_PER_S,
    PEAK_FLOPS_FP32 as FP32_FLOPS_PER_S, PEAK_FLOPS_INT8 as INT8_OPS_PER_S,
    PEAK_FLOPS_TF32 as TF32_FLOPS_PER_S)

BATCH = 8
# phase 2 takes seconds; a kernel that never finishes (a ring whose
# barriers lost step) fails it after this long instead of hanging the run
CHECK_LIMIT_S = 120
SEED = 0

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
# the LM families' prefill shapes: Qwen2-MoE-A2.7B (16 heads of 128, the
# wgmma route) and DeepSeek-V2's MLA (128 heads, qk 192 / v 128, the
# mma.sync route)
FLASH_QWEN = (LM_SLOTS, 16, 16, LM_PROMPT, 128, 128, True, 0, 0.0)
# the dry run's cells on the card (DRYRUN_CELLS): Phi-4-mini's K9 at
# prefill_32k and train_4k, batch 1, and K10/K11 at train_4k
FLASH_DRY_PREFILL = (1, 24, 8, 32768, 128, 128, True, 0, 0.0)
FLASH_DRY_TRAIN = (1, 24, 8, 4096, 128, 128, True, 0, 0.0)
FLASH_DRYRUN = (FLASH_DRY_PREFILL, FLASH_DRY_TRAIN)
# GPipe training's microbatch (``gpipe_lm``): Phi-4-mini at batch 1
FLASH_GPIPE = (1, 24, 8, LM_PROMPT, 128, 128, True, 0, 0.0)
FLASH_DSV2 = (LM_SLOTS, 128, 128, LM_PROMPT, 192, 128, True, 0, 0.0)
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
VJP_CASES = (FLASH_SLICE, (1, 8, 2, 128, 32, 32, True, 0, 50.0),
             FLASH_DRY_TRAIN, FLASH_GPIPE, (1, 4, 4, 64, 24, 16, True, 0, 0.0))
# GPipe training (``gpipe_lm``): Phi-4-mini's 32 decoder layers at full
# width, bf16, kernel mode on, cut by split_stages into GPIPE_STAGES
# stages on compat_make_mesh((4,), ("model",), devices=["cuda:0"] * 4),
# GPIPE_MICROBATCHES microbatches of 1 x LM_PROMPT tokens' embeddings
# against a seeded target, loss mean((o - y)^2) in f32, no remat: K9,
# K10 and K11 once a layer and microbatch, at FLASH_GPIPE.  Held against
# the same stages run microbatch by microbatch under plain autograd on
# the card (no ring): the loss within LOSS_REL_TOL, every leaf within
# GRAD_REL_TOL (L2)
GPIPE_STAGES, GPIPE_MICROBATCHES = 4, 4
GPIPE_LAUNCHES = {k: 32 * GPIPE_MICROBATCHES for k in (
    "flash_attention_fwd", "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv")}
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
# output's type (f32 for every pair with an f32 operand and for f16 x
# bf16; bf16 and f16 for their own pairs and with int8; f16 takes the
# bf16 bound)
FLOAT_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}
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

# the K9 prefill shapes of the families after the MoE ones: SeamlessM4T's
# encoder over its 1024 frames (non-causal, hd 64) and decoder,
# InternVL2's 48 query heads over 8 KV, Qwen2-72B's 64 and Command R+'s
# 96 (the wgmma route)
FLASH_SEAMLESS_ENC = (LM_SLOTS, 16, 16, 1024, 64, 64, False, 0, 0.0)
FLASH_SEAMLESS_DEC = (LM_SLOTS, 16, 16, LM_PROMPT, 64, 64, True, 0, 0.0)
FLASH_INTERNVL = (LM_SLOTS, 48, 8, LM_PROMPT, 128, 128, True, 0, 0.0)
FLASH_QWEN72 = (LM_SLOTS, 64, 8, LM_PROMPT, 128, 128, True, 0, 0.0)
FLASH_CMDR = (LM_SLOTS, 96, 8, LM_PROMPT, 128, 128, True, 0, 0.0)
# the LM families after the Phi-4-mini phases, one at a time, each freed
# before the next: (arch, n_layers or None for full depth, the
# parameters drawn at that depth, prompt tokens, max_seq, K9's prefill
# shapes as (case, "enc" or "dec")), each at full width, bf16, random
# weights from SEED, through ServingEngine(batch_slots=LM_SLOTS):
# LM_REQUESTS requests of the prompt, LM_NEW new tokens each.  Hymba and
# xLSTM take the long prompts their users run (Hymba's 1024-slot ring
# wraps in decode).  Cut in depth: DeepSeek-V2 to 6 of its 60 layers
# (478.8 GB of bf16 weights whole, 49.8 GB at 6), Qwen2-72B and Command
# R+ to 4 (145 and 208 GB whole).  The parameters drawn are the JAX
# init's (``jax.eval_shape``); for the MoE families ArchConfig.param_count()
# gives 98,304 and 49,152 more.  Hymba (sliding windows), Gemma2
# (local/global windows) and xLSTM (no attention) put no launch on K9,
# as in the JAX package
LM_ARCHS = (
    ("qwen2-moe-a2.7b", None, 14_004_570_112, LM_PROMPT, LM_MAX_SEQ,
     ((FLASH_QWEN, "dec"),)),
    ("deepseek-v2-236b", 6, 24_881_280_000, LM_PROMPT, LM_MAX_SEQ,
     ((FLASH_DSV2, "dec"),)),
    ("hymba-1.5b", None, 1_631_643_232, 2048, 4096, ()),
    ("xlstm-125m", None, 140_185_392, 2048, 4096, ()),
    ("seamless-m4t-medium", None, 715_454_464, LM_PROMPT, LM_MAX_SEQ,
     ((FLASH_SEAMLESS_ENC, "enc"), (FLASH_SEAMLESS_DEC, "dec"))),
    ("internvl2-26b", None, 19_862_722_560, LM_PROMPT, LM_MAX_SEQ,
     ((FLASH_INTERNVL, "dec"),)),
    ("gemma2-9b", None, 9_241_404_928, LM_PROMPT, LM_MAX_SEQ, ()),
    ("qwen2-72b", 4, 6_002_163_712, LM_PROMPT, LM_MAX_SEQ,
     ((FLASH_QWEN72, "dec"),)),
    ("command-r-plus-104b", 4, 9_437_294_592, LM_PROMPT, LM_MAX_SEQ,
     ((FLASH_CMDR, "dec"),)),
)
# the same archs in f32, TF32 off (``lm_f32``): arch -> (n_layers or
# None, S or None, change to the config).  The MoE families at the depth
# that fits (56.0 GB for Qwen2-MoE whole, 51.9 GB for 3 of DeepSeek-V2's
# layers), one batch of LM_SLOTS prompts prefilled on both paths: where
# bf16's rounding is what parts them, f32's (2^-24 against 2^-8) leaves
# the kernel path's logits, with the plain path's routing forced on it,
# within F32_REL_TOL x max|logit|, the CPU tests' f32 tolerance.  With S
# (InternVL2, Gemma2, Qwen2-72B and Command R+ at 2 layers, the rest
# whole), batch 2: teacher-forced prefill of S tokens and one decode step
# against forward on S + 1, within F32_REL_TOL x max|logit|.  S + 1 meets
# both the chunked scans' limit (a multiple of 128) and the blockwise
# attention's (at most 1024); InternVL2's prompt holds its 256 patches.
# Hymba's window is cut to 64 here, so that the prompt passes it and the
# ring's prefill roll is 63.  (xLSTM's mLSTM normalises a chunk otherwise
# than a step, in the JAX package and so in the port,
# tests/test_torch_ssm.py; the two meet where the normaliser's floor
# exp(-m) is the larger, as it is on these inputs.)  The archs with no
# kernel on their path (F32_HOST_ARCHS) are also held, row 0, against the
# same port on the host CPU, same weights, within F32_REL_TOL
LM_F32 = {"qwen2-moe-a2.7b": (None, None, {}),
          "deepseek-v2-236b": (3, None, {}),
          "hymba-1.5b": (None, 127, dict(window=64)),
          "xlstm-125m": (None, 127, {}),
          "seamless-m4t-medium": (None, 127, {}),
          "internvl2-26b": (2, 383, {}),
          "gemma2-9b": (2, 127, {}),
          "qwen2-72b": (2, 127, {}),
          "command-r-plus-104b": (2, 127, {})}
F32_HOST_ARCHS = ("hymba-1.5b", "xlstm-125m", "gemma2-9b")
# [reduced] (``reduced_launchers``): the JAX package's own reduced LM
# configs (ArchConfig.reduced(): 2 layers, d_model 64, 4 heads of 16;
# DeepSeek-V2's MLA at qk 24 / v 16) through the launchers as a user runs
# them, on the card at their defaults: ``launch.serve --arch A --reduced``
# (4 requests of 8 tokens on 2 slots, 8 new each) for all ten archs, and
# ``launch.train --arch A --reduced --steps 3`` (8 x 64 tokens a step,
# remat) for the nine whose JAX counterpart runs: ``repro.launch.train
# --reduced`` raises KeyError 'frames' for SeamlessM4T, whose frames the
# Trainer does not feed, in both packages.  The launches K9-K11 make, by
# shape: serving, K9 once a layer and prefill (2 prefills; SeamlessM4T's
# encoder also, non-causal over its 16 frames); training, K9 twice a
# layer and step (the forward, then the remat recompute), K10 and K11
# once.  Gemma2, Hymba (windowed attention) and xLSTM launch none, as in
# the JAX package.  The reduced head dims run padded to the kernels'
# width of 32 (``kernel_widths``)
FLASH_R_GQA = (2, 4, 2, 8, 16, 16, True, 0, 0.0)
FLASH_R_MHA = (2, 4, 4, 8, 16, 16, True, 0, 0.0)
FLASH_R_MLA = (2, 4, 4, 8, 24, 16, True, 0, 0.0)
FLASH_R_ENC = (2, 4, 4, 16, 16, 16, False, 0, 0.0)
FLASH_RT_GQA = (8, 4, 2, 64, 16, 16, True, 0, 0.0)
FLASH_RT_MHA = (8, 4, 4, 64, 16, 16, True, 0, 0.0)
FLASH_RT_MLA = (8, 4, 4, 64, 24, 16, True, 0, 0.0)
REDUCED_STEPS, REDUCED_LAYERS = 3, 2
# arch -> (K9's serving shapes as (case, prefill launches), the training
# shape or None where the arch's attention takes no kernel; arch not
# trained: absent from REDUCED_TRAIN)
REDUCED_SERVE = {
    "command-r-plus-104b": {FLASH_R_GQA: 4}, "gemma2-9b": {},
    "phi4-mini-3.8b": {FLASH_R_GQA: 4}, "qwen2-72b": {FLASH_R_GQA: 4},
    "qwen2-moe-a2.7b": {FLASH_R_MHA: 4},
    "deepseek-v2-236b": {FLASH_R_MLA: 4}, "hymba-1.5b": {},
    "internvl2-26b": {FLASH_R_GQA: 4},
    "seamless-m4t-medium": {FLASH_R_ENC: 4, FLASH_R_MHA: 4},
    "xlstm-125m": {}}
REDUCED_TRAIN = {
    "command-r-plus-104b": FLASH_RT_GQA, "gemma2-9b": None,
    "phi4-mini-3.8b": FLASH_RT_GQA, "qwen2-72b": FLASH_RT_GQA,
    "qwen2-moe-a2.7b": FLASH_RT_MHA, "deepseek-v2-236b": FLASH_RT_MLA,
    "hymba-1.5b": None, "internvl2-26b": FLASH_RT_GQA, "xlstm-125m": None}
FLASH_REDUCED = (FLASH_R_GQA, FLASH_R_MHA, FLASH_R_MLA, FLASH_R_ENC,
                 FLASH_RT_GQA, FLASH_RT_MHA, FLASH_RT_MLA)
# K9's main-path shapes: Phi-4-mini's (serving and training), then the
# families', then the reduced configs'
FLASH_MAIN = (FLASH_SLICE, FLASH_QWEN, FLASH_DSV2, FLASH_SEAMLESS_ENC,
              FLASH_SEAMLESS_DEC, FLASH_INTERNVL, FLASH_QWEN72, FLASH_CMDR
              ) + FLASH_DRYRUN + (FLASH_GPIPE,) + FLASH_REDUCED
# [train_families] (``train_family``): the other families trained after
# GPipe, one at a time, each freed before the next: (arch, n_layers or
# None for full depth, batch, sequence, K9-K11's shapes as (case, "enc"
# or "dec"), the gradient check, its bounds, its plant), each at full
# width, bf16, random weights from SEED, kernel mode on,
# TrainConfig(microbatches=1, remat=True), AdamW: FAMILY_STEPS steps
# through Trainer (SeamlessM4T's frames and InternVL2's patches, seeded
# as stub_inputs draws them, go through make_train_step directly: the
# Trainer feeds tokens alone, in both packages), then one more under
# torch.profiler.  Depth is cut only where the training state does not
# fit one card: 12 B a parameter (bf16 weight and gradient, f32 mu and
# nu) and 8 B an unembed-table entry (lm_loss's f32 copy and its
# gradient), parameters counted by accounting.count_params.  Command R+
# stays out: 56.6 + 25.2 = 81.8 GB at 1 of its 64 layers.  Hymba takes
# the 2 x 2048 tokens its 1024-token window acts on, at 16 of its 32
# layers for the script's time: its row took 65 s of an 804 s run at 32
# (Mamba's scan, 252,126 kernels a step, host-bound).  Gemma2 and Hymba
# (windowed attention) and xLSTM (no attention) launch no kernel, as in
# the JAX package.
#
# The gradient check, one value_and_grad on the first batch: "kernel",
# against kernel mode off (blockwise attention), the MoE routing of the
# kernel run forced on the plain one (``moe_routing``; a token whose
# experts lie within rounding routes apart in bf16); "f32", against the
# params cast to f32 (TF32 off) on the card.  The bounds, set from an
# H100's readings (PERF.md §6): the loss's share |loss - ref| / |ref|,
# and the worst leaf's |g - g_ref| / |g_ref| (L2) over the leaves whose
# |g_ref| is at least LEAF_FLOOR of the largest leaf's.  The leaves
# below it are ill-conditioned, small differences of large terms, and
# are printed, not held: SeamlessM4T's cross-attention wq and wk over
# frames of 0.01 N(0, 1) (2e-5 of the largest leaf; 0.18 from f32 as
# from the plain path).  Qwen2-MoE's leaf bound is twice the others':
# both packages draw a [E, d, f] expert stack with std 1/sqrt(E), taking
# the expert count for the fan-in (models/layers.py::dense_leaf, as the
# JAX package's _dense_init), 5.8x the 1/sqrt(d) rule's for its 60
# experts, so its MoE branches outweigh the residual stream, each
# layer's bf16 rounding carries forward undiluted and every leaf reads
# 0.053-0.064 over 6 layers (DeepSeek-V2's one layer 0.0136).  The plant,
# the same check on a planted fault, must exceed a bound: "k11", K11
# built from a copy of flash_attention_bwd.cu that leaves every block's
# last key tile out (those 64 keys' dk and dv stay zero;
# ``start_k11_plant``); "slstm", every sLSTM layer's backward scaled by
# SLSTM_PLANT in the bf16 run (``slstm_scaled``)
TRAIN_FAMILIES = (
    ("deepseek-v2-236b", 1, TRAIN_BATCH, TRAIN_SEQ, ((FLASH_DSV2, "dec"),),
     "kernel", (1e-5, 0.04), "k11"),
    ("qwen2-moe-a2.7b", 6, TRAIN_BATCH, TRAIN_SEQ, ((FLASH_QWEN, "dec"),),
     "kernel", (1e-4, 0.08), "k11"),
    ("seamless-m4t-medium", None, TRAIN_BATCH, TRAIN_SEQ,
     ((FLASH_SEAMLESS_ENC, "enc"), (FLASH_SEAMLESS_DEC, "dec")), "kernel",
     (5e-5, 0.045), "k11"),
    ("internvl2-26b", 8, TRAIN_BATCH, TRAIN_SEQ, ((FLASH_INTERNVL, "dec"),),
     "kernel", (1e-4, 0.04), "k11"),
    ("qwen2-72b", 2, TRAIN_BATCH, TRAIN_SEQ, ((FLASH_QWEN72, "dec"),),
     "kernel", (1e-5, 0.04), "k11"),
    ("gemma2-9b", 16, TRAIN_BATCH, TRAIN_SEQ, (), "f32", (2e-5, 0.04), None),
    ("hymba-1.5b", 16, 2, 2048, (), "f32", (1.5e-5, 0.04), None),
    ("xlstm-125m", None, TRAIN_BATCH, TRAIN_SEQ, (), "f32", (5e-4, 0.03),
     "slstm"),
)
FAMILY_STEPS = 2
LEAF_FLOOR = 1e-4
SLSTM_PLANT = 1.03
BWD_MAIN = (FLASH_SLICE, FLASH_DRY_TRAIN, FLASH_GPIPE) + tuple(
    case for row in TRAIN_FAMILIES for case, _ in row[4]) + (
    FLASH_RT_GQA, FLASH_RT_MHA, FLASH_RT_MLA)
# the expert-parallel MoE (``ep_prefills``, inside serve_arch and lm_f32
# for the MoE families): the serving phase's first LM_SLOTS x LM_PROMPT
# prefill feed under compat_make_mesh(EP_MESH, ("data", "model"),
# devices=["cuda:0"] * 4) (Qwen2-MoE's 60 experts 15 a slot,
# DeepSeek-V2's 160 40 a slot; data 1, so the flash call's mesh rule
# does not engage) and with no mesh: the EP region at every MoE layer
# and never without the mesh; each MoE layer from the grouped run's
# input, and the logits with the grouped run's routing forced, within
# LM_REL_TOL (bf16) or F32_REL_TOL (f32) x max|output| of the grouped
# path's; K9's launches equal on both
EP_MESH = (1, 4)
# the plain forward at a longer S is timed by one eager call (CUDA events
# around it; its blocks' loop is too many launches to capture in a graph)
PLAIN_GRAPH_MAX_S = 4096
F32_REL_TOL = 1e-4
# the families' bf16 logits on every row, the MoE routing forced to the
# plain path's on the kernel path and on an f32 walk of the same weights
# (``dense_walk``): the kernel path's distance from the f32 walk, as a
# share of max|logit|, at most FORCED_LIMIT times the plain path's.
# PLANTS: faults planted in the kernel path (every attention sublayer's
# output scaled by 1 + p), read against that limit on the first batch;
# those of PLANTS_CAUGHT must exceed it.  The limit lies between the
# readings on an H100, arch by arch: the sound kernel path's largest
# ratio against the plant 2^-5's: Qwen2-MoE and DeepSeek-V2 0.84-0.88
# against 1.91-2.11, SeamlessM4T 1.19 (seeded frames; 0.94 on zeros)
# against 1.71, InternVL2 1.02 against 2.25, Qwen2-72B 0.98 against
# 1.85, Command R+ 1.09 against 9.07.  The plant 2^-7 reads 1.00-1.19
# (Command R+ 2.60) and passes: the check sees faults of a few percent
FORCED_LIMIT = 1.5
PLANTS = (2 ** -7, 2 ** -5, 2 ** -3)
PLANTS_CAUGHT = (2 ** -5, 2 ** -3)
# the (arch, feed) pairs whose prefill logits are not held to the
# whole-model bound (LM_REL_TOL x max|logit| of the plain path's): every
# layer is held to it and the logits to FORCED_LIMIT instead.  InternVL2
# at 48 layers on the engine's zero patches read 1.046 and 1.010 of the
# bound on an H100 (0.49 and 0.54 on seeded patches, which stay held):
# the two paths lie 0.0170 and 0.0172 of max|logit| from the f32 walk
WHOLE_BOUND_WAIVED = {("internvl2-26b", "engine")}

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
# sharded serving: each net cut into S stages on one card
# (compat_make_mesh((S,), ("model",), devices=["cuda:0"] * S): a CUDA
# stream and a captured graph a stage), microbatch BATCH, the engine's
# default rounds (8·S microbatches) and credits (two rounds); the
# requests of 1-8 images (sizes from SEED, as SERVE_REQUESTS) from
# SERVE_PRODUCERS threads round-robin, then the same requests again with
# explicit shard= routing
SHARDED = (("resnet50", (1, 2, 4), SERVE_REQUESTS), ("vgg16", (4,), 12))
# Eq. 2 words per image the stages must sum to
SHARDED_WORDS = {"resnet50": 8_095_354, "vgg16": 28_878_467}
# the autotuned compile path on NX2100 with the default AutotuneConfig():
# what the search picks (the streamed set, the burst, the burst-matching
# and last-stage FIFO depths, the serving credits), held against the JAX
# package's search by tests/test_torch_autotune.py, and the streamed
# convs K2's engines own (VGG-16's fc0 runs on the streamed conv)
TUNED = {
    "resnet50": {"streamed": ("fc", "s0b1c2", "s1b1c2", "s1b2c2", "s1b3c0",
                              "s2b1c2", "s2b3c2", "s2b4c2", "s3b0c1",
                              "s3b0ds", "s3b1c0", "s3b1c1", "s3b2c1"),
                 "burst": 32, "bm_words": 128, "laststage": 1024,
                 "credits": 4, "conv2d_int8_stream": 12},
    "vgg16": {"streamed": ("conv11", "conv2", "conv6", "conv8", "conv9",
                           "fc0", "fc1", "fc2"),
              "burst": 32, "bm_words": 256, "laststage": 512,
              "credits": 4, "conv2d_int8_stream": 6},
}
TUNED_SUFFIX = "_tuned"
# the front end: tuned ResNet-50 and MobileNetV2 as compiled, one engine
# each (microbatch BATCH, queue_depth 4); (tenant, net, weight,
# deadline_ms); each tenant FRONTEND_REQUESTS requests of 1-8 images
# drawn from a pool of FRONTEND_POOL per net (sizes from SEED), from one
# producer thread each
FRONTEND_TENANTS = (("r50_light", "resnet50" + TUNED_SUFFIX, 1.0, None),
                    ("r50_heavy", "resnet50" + TUNED_SUFFIX, 4.0, None),
                    ("mv2_bulk", "mobilenetv2", 8.0, None),
                    ("mv2_rt", "mobilenetv2", 1.0, 0.0))
FRONTEND_REQUESTS, FRONTEND_POOL = 256, 32
FRONTEND_OUTSTANDING, FRONTEND_QUEUE = 8, 4
FRONTEND_SHARE_TOL, FRONTEND_MIN_JAIN = 0.2, 0.95
# the LM dry run (repro_torch.launch.dryrun): every arch x shape x {16x16,
# 2x16x16} on meta in a subprocess of DRYRUN_JOBS counting processes (64
# PASS, 16 SKIP: the eight archs with full attention skip long_500k), then
# Phi-4-mini at full width and depth on the (1, 1) local mesh, each shape
# at its seq_len with the batch one card holds (decode_32k: 34 GB of KV
# cache), DRYRUN_TIMED warm steps timed after one more
DRYRUN_JOBS, DRYRUN_SWEEP_LIMIT_S, DRYRUN_TIMED = 7, 600, 3
DRYRUN_SWEEP = {"PASS": 64, "SKIP": 16, "FAIL": 0}
DRYRUN_CELLS = (("prefill_32k", 1), ("decode_32k", 8), ("train_4k", 1))
DRYRUN_NOTE = "dp=1: streaming impossible, all replicated"
# the cells whose kernel-off count is taken on the card at full depth
# (check (b)); prefill_32k's blockwise loops take minutes there under the
# counter, so its count is taken from the first layers on both sides
DRYRUN_FULL_OFF = ("decode_32k", "train_4k")
# the flash launches a step makes (a decode step runs none)
DRYRUN_LAUNCHES = {"prefill": {"flash_attention_fwd": 32}, "decode": {},
                   "train": TRAIN_LAUNCHES}
# the shares are read between the heavy tenant's first eighth and three
# quarters of its images delivered (see serve_frontend)
FRONTEND_WINDOW = (1 / 8, 3 / 4)
# the H100 target (``[h100]`` lines): the nets compiled for it beside
# NX2100 and run; the driver attribute of the card's opt-in shared memory
# a block; a 3x3 conv, C 2048 -> 16 on a 4x64 map, that no pinned launch
# plan fits and a streamed one does (then a global average pool and an
# fc head): the working-set check pins it, the card's check streams it
H100_NETS = ("mobilenetv1", "mobilenetv3")
CU_ATTR_SMEM_PER_BLOCK_OPTIN = 97
WIDE_CONV = (("wide", "conv", 3, 3, 2048, 16, 1, 4, 64),
             ("gap", "gap", 4, 64, 16, 16, 64, 4, 64),
             ("fc", "fc", 1, 1, 16, 16, 1, 1, 1))
# the port's examples (``examples_torch/``), each main() in this process
# on the card at its default arguments (train_lm at 20 steps), and what
# each prints when its own checks pass
EXAMPLES = (("cnn_dataflow", []), ("quickstart", []), ("serve_batched", []),
            ("serve_mini_resnet18", []), ("serve_multitenant", []),
            ("train_lm", ["--steps", "20"]))
EXAMPLES_PASSED = {"cnn_dataflow": "bit-identical to reference: True",
                   "quickstart": "quickstart OK",
                   "serve_batched": "64 tokens in",
                   "serve_mini_resnet18": "Eq.2 words",
                   "serve_multitenant": "spot-checked bit-identical",
                   "train_lm": "OK: decreased"}


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
        "mm_float": (r"mm_floatI(f|a|6__half|13__nv_bfloat16)"
                     r"(f|a|6__half|13__nv_bfloat16|S\d*_)Li(\d+)E",
                     "mm_float<{},{},{}>"),
        "mm_float_tc": (r"mm_float_tcI(f|a|6__half|13__nv_bfloat16)"
                        r"(a|6__half|13__nv_bfloat16|S\d*_)Li(\d+)E",
                        "mm_float_tc<{},{},{}>")}),
    ("pool_int8", "ptxas_pool.log", {
        "maxpool_band": (r"maxpool_bandILi(\d)ELi(\d)ELi(\d+)ELi(\d)E",
                         "maxpool_band<{},{},{},{}>"),
        "gap_chunk": (r"gap_chunkILi(\d+)E", "gap_chunk<{}>")}),
)
# mangled template arguments, as the report names them (a substitution,
# S1_ say, repeats the argument before it: mm_float<bf16, bf16, TN>)
MANGLED_ARGS = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16",
                "a": "int8"}
# the tensor-core instruction each redesigned kernel must issue (SASS)
SASS_REQUIRED = {"conv_mma": "IMMA", "conv_stream": "IMMA",
                 "flash_fwd_wgmma": "HGMMA", "flash_fwd_bf16": "HMMA",
                 "mm_float_tc": "HMMA"}


def instance_name(text, templates):
    """(template, display name) of the kernel instance a ptxas or SASS line
    names, or None."""
    import re
    for tmpl, (pattern, fmt) in templates.items():
        m = re.search(pattern, text)
        if m:
            args = []
            for a in m.groups():
                args.append(args[-1] if re.fullmatch(r"S\d*_", a)
                            else MANGLED_ARGS.get(a, a))
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


def ptxas_report(_build):
    """From each source of ``PTXAS_SOURCES``: its build log (the
    ``-Xptxas -v`` report ``_build`` keeps beside the library; written to
    the output directory) and the SASS of its library; returns {source:
    {instance: registers, stack and spill bytes, the count of each
    tensor-core or dp4a SASS instruction (HGMMA, HMMA, IMMA, IDP), and
    for a 3x3 dw_kernel the SASS instructions a MAC of its MAC block}}."""
    import re
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report = {}
    for src, log_name, templates in PTXAS_SOURCES:
        log_text = _build.build_log(src)
        (out_dir / log_name).write_text(log_text)
        sass = subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
             str(_build.library_path(src))], capture_output=True, text=True,
            timeout=300, check=True).stdout
        found, cur = {}, None
        for line in log_text.splitlines():
            if re.search(r"entry function|Function properties for", line):
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


def check_main_path_instances(record, shapes, conv_plan, stream_plan,
                              sm_count, flash_route, torch):
    """The kernel instance each main-path launch of K1, K2 and K9 takes
    (from the conv plans of its shape and the flash route of each LM's
    head dims: ``flash_fwd_wgmma<128>`` for Phi-4-mini and Qwen2-MoE,
    ``flash_fwd_bf16<192,128>`` for DeepSeek-V2's MLA, at the widths of
    ``kernel_widths``: ``flash_fwd_bf16<32,32>`` for the reduced
    configs' head dims 16 and 24), and that each
    issues its tensor-core instruction (IMMA, HGMMA, HMMA) in the SASS of
    the build report, and a K2 instance spills nothing; fails where one
    does not."""
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
    from repro_torch.kernels.flash_attention.ops import kernel_widths
    for case in FLASH_MAIN:
        hd, hd_v = case[4:6]
        route = flash_route(torch.bfloat16, hd, hd_v)
        used.setdefault(("flash_attention",
                         f"flash_fwd_wgmma<{hd}>" if route == "wgmma"
                         else "flash_fwd_bf16<{},{}>".format(
                             *kernel_widths(hd, hd_v))), []).append(
            list(case[:6]))
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
        rows[inst] = {"shapes": keys, "op": op, op: rep[op],
                      "registers": rep.get("registers"),
                      "spill_bytes": rep.get("spill_stores", 0)
                      + rep.get("spill_loads", 0)}
    record["main_path_instances"] = rows
    log("build", "main-path instances (launch shapes; tensor-core SASS "
        "instructions, registers, spill bytes): " + "; ".join(
            f"{inst}: {len(r['shapes'])} shapes, {r[r['op']]} {r['op']}, "
            f"{r['registers']}, {r['spill_bytes']}"
            for inst, r in rows.items()))


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


def check_flash(torch, g, dev, kern, record):
    """Phase 2 for K9: the kernel against its plain version (at the JAX
    call's blocks, min(128, S)) at every case of FLASH_CASES and at the LM
    families' prefill shapes in bf16 and f32, at the dry run's shapes
    (FLASH_DRYRUN) in bf16, the dtype they run in, o and lse; and the
    model-layout entry the main path calls, which reads q/k/v and writes o
    through their strides.  The plain version's bf16 call past
    PLAIN_GRAPH_MAX_S is timed by CUDA events here (``plain_once_ms``),
    for phase 4."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    n, once = 0, record.setdefault("plain_once_ms", {})
    for case in FLASH_CASES + list(FLASH_MAIN[1:]):
        for dname in (("bfloat16",) if case in FLASH_DRYRUN
                      else FLASH_DTYPES):
            q, k, v = flash_inputs(torch, g, dev, case, getattr(torch, dname))
            out = []
            ms = event_ms(torch, lambda: out.append(flash_attention_plain(
                q, k, v, **flash_kw(case))), 1)
            want_o, want_lse = out.pop()
            if case[3] > PLAIN_GRAPH_MAX_S and dname == "bfloat16":
                once[case_key(case)] = ms
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
    the JAX call's blocks) at every case of FLASH_CASES and at the dry
    run's train_4k shape (FLASH_DRY_TRAIN) in bf16 and f32, on the
    forward o and lse of K9 (its f32 variant for f32): dq, dk and dv
    within BWD_TOL.  Then the pair's f32 sums against the plain backward
    on f32 casts at BWD_SUM_CASES, within BWD_SUM_TOL, and
    flash_attention_vjp in model layout against autograd through
    flash_attention_plain at VJP_CASES; at batch 1 also with the
    gradient's batch stride 1 (as autograd may hand it over), which must
    give the same grads bit for bit."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_kernel, flash_attention_vjp)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_plain, flash_attention_plain)
    n = 0
    for case in FLASH_CASES + [c for c in BWD_MAIN if c not in FLASH_CASES]:
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
            if case[0] == 1:
                # the same gradient of o, with batch stride 1
                do = w.to(dt).contiguous()
                odd = do.reshape(-1).as_strided(do.shape,
                                                (1,) + do.stride()[1:])
                o = flash_attention_vjp.apply(q, k, v, *case[6:9])
                usual = torch.autograd.grad(o, (q, k, v), do)
                o = flash_attention_vjp.apply(q, k, v, *case[6:9])
                if not all(torch.equal(a, b) for a, b in zip(
                        usual, torch.autograd.grad(o, (q, k, v), odd))):
                    raise AssertionError(
                        f"flash_attention_vjp {case} {dname}: a gradient "
                        f"of batch stride 1 gives other grads")
                n += 1
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


# the float matmul's operand pairs (x, w) on the path: every pair over
# {f32, bf16, f16, int8} but int8 x int8 (mm_kernel's); the eleven with
# bf16, f16 or int8 weights run on the tensor cores (mm_float_tc; an f32 x
# split exactly into three bf16 parts, a product each), the four with f32
# weights on FFMA (mm_float)
FLOAT_TYPES = ("float32", "bfloat16", "float16", "int8")
FLOAT_PAIRS = tuple((a, b) for a in FLOAT_TYPES for b in FLOAT_TYPES
                    if (a, b) != ("int8", "int8"))
FLOAT_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}
# The FFMA design's device us a launch (mm_float on FFMA at every pair, as
# PERF.md section 6 keeps them; chip_smoke.py on one H100 80GB HBM3 at
# 700.00 W) at the float path's entries, for the pairs (x, w) that were on
# the path then, in the order of FFMA_DESIGN_PAIRS (the last, f32 x bf16,
# from the run of the FFMA body that followed, as it was not on the path
# before); the [time] lines and the record show it beside this run's time
FFMA_DESIGN_PAIRS = (
    ("float32", "float32"), ("float32", "float16"), ("float32", "int8"),
    ("bfloat16", "bfloat16"), ("bfloat16", "float16"), ("bfloat16", "int8"),
    ("float16", "float32"), ("float16", "bfloat16"), ("float16", "float16"),
    ("float16", "int8"), ("int8", "float32"), ("int8", "bfloat16"),
    ("int8", "float16"), ("float32", "bfloat16"))
FFMA_DESIGN_US = {
    "pinned:512,1000": (6.32, 6.02, 6.04, 5.97, 6.05, 6.06, 6.30, 6.09,
                        6.14, 6.22, 6.41, 6.19, 5.99, 5.82),
    "pinned:960,1280": (8.95, 7.97, 7.68, 7.84, 7.84, 7.38, 8.93, 7.83,
                        8.10, 7.44, 9.17, 8.16, 8.18, 7.84),
    "pinned:1024,1000": (7.54, 7.00, 7.01, 6.83, 6.84, 6.70, 7.23, 6.81,
                         6.90, 6.70, 7.46, 6.88, 6.91, 6.72),
    "pinned:1280,1000": (8.02, 7.43, 7.55, 7.24, 7.60, 7.40, 8.13, 7.26,
                         7.51, 7.31, 8.07, 7.57, 7.44, 7.25),
    "fifo:2048,1000": (11.20, 8.62, 8.53, 8.42, 8.57, 8.17, 11.15, 8.40,
                       8.60, 8.15, 10.57, 8.52, 8.48, 8.21),
    "fifo:4096,1000": (15.11, 12.40, 13.55, 12.54, 12.55, 13.55, 15.30,
                       12.43, 12.80, 13.42, 14.51, 12.34, 12.54, 12.12),
    "fifo:4096,4096": (41.65, 31.07, 25.26, 32.07, 32.16, 25.76, 41.75,
                       31.23, 31.72, 26.08, 39.82, 30.16, 30.25, 30.68),
    "fifo:25088,4096": (227.52, 159.94, 121.44, 160.54, 161.02, 121.41,
                        219.25, 155.44, 157.78, 124.61, 208.00, 156.02,
                        156.12, 157.30)}
# The f32-x pairs on the tensor cores on edge values (phase 2, at fc0's
# shape): a row of x holds ordinary values but, by its index mod 8, one
# column of EDGE_BITS (+inf, -inf, a NaN whose payload has only low bits,
# the largest finite f32, a value above bf16's largest that round to
# nearest makes -inf), zeros and -0 (5), values near 2^-105, inside the
# split's exact range from 2^-110 (6), or values near 2^-128 below it with
# the smallest normal and subnormal (7)
EDGE_PAIRS = (("float32", "bfloat16"), ("float32", "float16"),
              ("float32", "int8"))
EDGE_BITS = (0x7f800000, 0xff800000, 0x7f800001, 0x7f7fffff, 0xff7f8001)


def ffma_design_ms(entry, xd, wd):
    """The FFMA design's device ms a launch at path entry ``entry``
    (``mode:K,N``) for the pair (xd, wd), None where it was not on the
    path."""
    row = dict(zip(FFMA_DESIGN_PAIRS, FFMA_DESIGN_US.get(entry, ())))
    return None if (xd, wd) not in row else row[xd, wd] * 1e-3


def pair_name(xd, wd):
    """A float operand pair's name in the record: the type, or x's and
    w's types."""
    return xd if xd == wd else f"{xd}x{wd}"


def float_operands(torch, g, dev, shape, xd, wd):
    """x [M, K] and w [K, N] in their types: normal from ``g``, int8 as
    integers in [-127, 127]."""
    M, K, N = shape

    def draw(shape, dt):
        if dt == torch.int8:
            return torch.randint(-127, 128, shape, generator=g, device=dev,
                                 dtype=torch.int8)
        return torch.randn(*shape, generator=g, device=dev).to(dt)
    return draw((M, K), xd), draw((K, N), wd)


def float_err(torch, kern, got, want):
    """The float matmul against its plain version: same type and shape,
    |got - want| <= tol |want| + tol max|want| with FLOAT_TOL of the
    output's type (readings kept per type)."""
    dname = str(want.dtype).split(".")[1]
    tol = FLOAT_TOL[dname]
    kern.err(torch, got, want, (tol, tol * float(want.float().abs().max())),
             dname)


def edge_operands(torch, g, dev, shape, wd):
    """x [M, K] f32 of edge values as EDGE_BITS says and w [K, N] of type
    ``wd``: normal x 0.25 (int8: integers in [-127, 127])."""
    M, K, N = shape
    x = torch.randn(M, K, generator=g, device=dev)
    bits = x.view(torch.int32)
    cols = torch.randint(0, K, (M,), generator=g, device=dev).tolist()
    for m in range(M):
        kind = m % 8
        if kind < 5:
            bits[m, cols[m]] = EDGE_BITS[kind] - (
                1 << 32 if EDGE_BITS[kind] >> 31 else 0)
        elif kind == 5:
            x[m, ::2] = 0.0
            x[m, 1::4] = -0.0
        elif kind == 6:
            x[m] *= 2.0 ** -105
        else:
            x[m] *= 2.0 ** -128
            bits[m, :2] = torch.tensor([0x00800000, 1], dtype=torch.int32)
    if wd == torch.int8:
        w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                          dtype=torch.int8)
    else:
        w = (torch.randn(K, N, generator=g, device=dev) * 0.25).to(wd)
    return x, w


def edge_err(torch, kern, got, want, x, w):
    """The edge-value case against the plain version: inf and NaN in the
    same places, the infs of the same sign; finite outputs within
    FLOAT_TOL's f32 limit of their row (rtol, and as atol the share of the
    row's largest finite |want|), plus the split's bound for x's values
    below 2^-110 (2^-133 |w| each); the largest share of that limit kept
    under "float32 edges"."""
    tol = FLOAT_TOL["float32"]
    gd, wd_ = got.double(), want.double()
    nan, inf, fin = wd_.isnan(), wd_.isinf(), wd_.isfinite()
    same = (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(gd.isnan(), nan) and torch.equal(gd.isinf(), inf)
            and torch.equal(gd[inf], wd_[inf]))
    row = torch.where(fin, wd_.abs(), torch.zeros_like(wd_)).amax(
        1, keepdim=True)
    below = ((x.abs() < 2.0 ** -110) & (x != 0)).double()
    limit = tol * wd_.abs() + tol * row \
        + 2.0 ** -133 * (below @ w.double().abs())
    diff = (gd - wd_).abs()[fin]
    share = float((diff / limit[fin]).nan_to_num(0.0, float("inf")).max())
    r = kern.readings.setdefault("float32 edges", {"max_share_of_limit": 0.0})
    r["max_share_of_limit"] = max(r["max_share_of_limit"], share)
    if not same or not share <= 1.0:
        raise AssertionError(
            f"{kern.name}: edge values: inf and NaN where the plain version "
            f"has them {same}, finite outputs at {share:.4g} of the limit")


def check_float_matmul(torch, g, dev, ks, fc_shapes, block_for, fpath):
    """Phase 2 for the float modes of K7/K8 (mm_float on FFMA, mm_float_tc
    on the tensor cores): every pair of FLOAT_PAIRS at FLOAT_CHECK_SHAPES,
    pinned, stream and fifo (n_buffers 1-4), each with K blocks of 128
    (the JAX test's) and of 16 (rings of many blocks); every fc shape of
    the six configs at M = 8 in f32 and bf16 and every mode, K blocks as
    the engines cut them; and every pair at every entry of the float
    matmul's path (``float_path``: every fc head and fc0) at M = 8, in
    every mode whose plan fits (fc0 streamed); the f32-x tensor-core pairs
    on edge values at fc0 (EDGE_PAIRS, ``edge_err``)."""
    from repro_torch.kernels.stream_matmul.ops import stream_matmul
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    rings = [("pinned", 2, 128), ("stream", 2, 128), ("stream", 2, 16)] + [
        ("fifo", nb, bk) for nb in (1, 2, 3, 4) for bk in (128, 16)]
    f32, bf16 = torch.float32, torch.bfloat16
    pairs = [(getattr(torch, a), getattr(torch, b)) for a, b in FLOAT_PAIRS]
    cases = [(shape, pair, rings) for shape in FLOAT_CHECK_SHAPES
             for pair in pairs]
    cases += [((BATCH, k, n), (d, d),
               [(mode, 2, block_for(k, 512))
                for mode in ("pinned", "stream", "fifo")])
              for k, n in sorted(fc_shapes) for d in (f32, bf16)]
    cases += [((BATCH, k, n), pair,
               [(m, 2, block_for(k, 512)) for m in (
                   ("pinned", "stream", "fifo") if mode == "pinned"
                   or (k, n) != FC0_MATMUL[1:] else (mode,))])
              for k, n, mode in fpath for pair in pairs]
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
    for _, wd in EDGE_PAIRS:
        x, w = edge_operands(torch, g, dev, FC0_MATMUL, getattr(torch, wd))
        edge_err(torch, ks["stream_matmul_float_fifo"], stream_matmul(
            x, w, mode="fifo", bk=block_for(FC0_MATMUL[1], 512), n_buffers=2),
            stream_matmul_ref(x, w), x, w)
        n += 1
    return n


def check_float_instances(torch, record, fpath, block_for, mm_float_plan,
                          sm_count):
    """The instance each launch of the float path should take (from its
    plan's column tile), and that the build holds 33 ``mm_float_tc``
    instances (11 pairs x 3 tiles), each issuing HMMA in its SASS and
    spilling nothing, and 8 ``mm_float`` (4 pairs x 2 tiles); fails
    where it does not.  Returns {(kernel counter, instance): planned
    launches on the path}, which phase 3 holds its counted launches
    against."""
    from repro_torch.kernels.stream_matmul.ops import (FLOAT_KERNELS,
                                                       float_instance)
    rep = record["ptxas"]["stream_matmul"]
    for tmpl, count in (("mm_float_tc", 33), ("mm_float", 8)):
        have = sorted(k for k, v in rep.items() if v["template"] == tmpl)
        if len(have) != count:
            raise AssertionError(f"{len(have)} {tmpl} instances in the "
                                 f"build, not {count}: {have}")
    used = {}
    for k, n, mode in fpath:
        for xd, wd in FLOAT_PAIRS:
            plan = mm_float_plan(BATCH, k, n, mode, block_for(k, 512), 2,
                                 FLOAT_BYTES[xd], FLOAT_BYTES[wd], sm_count)
            inst = float_instance(getattr(torch, xd), getattr(torch, wd),
                                  plan.tn)
            if plan.tensor_cores != inst.startswith("mm_float_tc"):
                raise AssertionError(f"{inst}: plan on the tensor cores "
                                     f"{plan.tensor_cores}")
            key = (FLOAT_KERNELS[mode], inst)
            used[key] = used.get(key, 0) + 1
    for inst, v in sorted(rep.items()):
        op = SASS_REQUIRED.get(v["template"])
        if op and inst.startswith("mm_float") and not v.get(op):
            raise AssertionError(f"{inst} (stream_matmul.cu) issues no {op} "
                                 f"in its SASS: {v}")
        if v["template"] == "mm_float_tc" and (v.get("spill_stores", 0)
                                               or v.get("spill_loads", 0)):
            raise AssertionError(f"{inst} (stream_matmul.cu) spills: {v}")
    record["float_instances"] = {
        inst: {"planned_launches": sum(n for (_, i), n in used.items()
                                       if i == inst),
               "HMMA": rep.get(inst, {}).get("HMMA", 0),
               "registers": rep.get(inst, {}).get("registers"),
               "spill_bytes": rep.get(inst, {}).get("spill_stores", 0)
               + rep.get(inst, {}).get("spill_loads", 0)}
        for inst in sorted({i for _, i in used})}
    log("build", "float-path instances (planned launches on the path; "
        "HMMA, registers, spill bytes): " + "; ".join(
            f"{inst}: {r['planned_launches']}; {r['HMMA']}, "
            f"{r['registers']}, {r['spill_bytes']}"
            for inst, r in record["float_instances"].items()))
    return used


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


def drive_float_matmul(torch, g, dev, path, block_for, record, planned):
    """Phase 3 for the float matmul: ``stream_matmul`` at every entry of
    ``path`` at M = BATCH for each operand pair of FLOAT_PAIRS, launches
    counted over these calls alone, by counter and by the instance each
    launched (the wrapper's count), the instances as ``planned``; each
    output of the promoted type, finite and within FLOAT_TOL of the plain
    path.  Returns the launches, the inputs, keyed (K, N, mode,
    ``pair_name``), for phase 4, and the launches by (counter,
    instance)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.stream_matmul.ops import (FLOAT_KERNELS,
                                                       stream_matmul)
    from repro_torch.kernels.stream_matmul.ref import stream_matmul_ref
    inputs = {(k, n, mode, pair_name(xd, wd)): float_operands(
                  torch, g, dev, (BATCH, k, n), getattr(torch, xd),
                  getattr(torch, wd))
              for k, n, mode in path for xd, wd in FLOAT_PAIRS}
    outs = {}
    _build.reset_launches()
    for (k, n, mode, dname), (x, w) in inputs.items():
        outs[k, n, mode, dname] = stream_matmul(x, w, mode=mode,
                                                bk=block_for(k, 512),
                                                n_buffers=2)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    by_instance = {key: n for key, n in _build.SHAPE_LAUNCHES.items()
                   if key[0] in launches}
    want = {}
    for _, _, mode, _ in inputs:
        want[FLOAT_KERNELS[mode]] = want.get(FLOAT_KERNELS[mode], 0) + 1
    if launches != want or by_instance != planned:
        raise AssertionError(f"float matmul path: launches {launches} != "
                             f"{want}, or by instance {by_instance} != "
                             f"{planned}")
    path = Kernel("float matmul path")
    for key, (x, w) in inputs.items():
        if outs[key].shape != (BATCH, key[1]):
            raise AssertionError(f"float matmul path {key}: shape "
                                 f"{tuple(outs[key].shape)}")
        float_err(torch, path, outs[key], stream_matmul_ref(x, w))
    record["float_matmul_path"] = {
        "launches": launches, "readings": path.readings,
        "by_instance": {f"{k}:{i}": n for (k, i), n in by_instance.items()}}
    log("slice", f"float matmul: {len(inputs)} calls of stream_matmul (fc "
        f"heads at M = {BATCH} in their engines' modes and fc0 as a "
        f"{FC0_MATMUL[1]} x {FC0_MATMUL[2]} matmul, at {len(FLOAT_PAIRS)} "
        f"operand pairs: every pair over f32, bf16, f16 and int8 but int8 "
        f"x int8), "
        f"launches {json.dumps(launches, sort_keys=True)}; outputs of the "
        f"promoted type within FLOAT_TOL, readings "
        f"{json.dumps(path.readings)}")
    return launches, inputs, by_instance


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
    torch.cuda.reset_peak_memory_stats()
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
    launches, by_case = dict(_build.LAUNCHES), k9_by_case()
    n_prefill = -(-LM_REQUESTS // LM_SLOTS)
    n = n_prefill * arch.n_layers
    if launches != {LM_KERNEL: n} or by_case != {FLASH_SLICE: n}:
        raise AssertionError(f"{LM_ARCH}: launches {launches}, K9's by "
                             f"shape {by_case} != {n_prefill} prefills x "
                             f"{arch.n_layers} layers at {FLASH_SLICE}")
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
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    record["lm"] = rec
    log("slice", f"{LM_ARCH} (full width and depth, {rec['params']:,} "
        f"params, bf16): {LM_REQUESTS} requests x {LM_NEW} tokens served "
        f"with {LM_SLOTS} slots, launches {json.dumps(launches)}; prefill "
        f"logits within {max(rec['prefill_logit_diff']):.4g} of the plain "
        f"path (bound {min(rec['prefill_logit_bound']):.4g}); first token "
        f"equal on the {sure} rows whose top-2 margin exceeds the bound; "
        f"peak device memory {rec['peak_bytes'] / 1e9:.2f} GB")
    return {"params": params, "arch": arch, "engine": engine,
            "prompts": prompts, "batches": batches, "launches": launches,
            "k9_by_case": by_case}


def named_leaves(tree, prefix=""):
    """(dotted name, tensor) of nested dicts and lists of tensors."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
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
    (the sum of their durations and the length of their union), the ten
    kernels with the most device time and the seconds the trace and its
    reading took; None where the trace shows no device activity.  Only
    the device is traced: a step of hundreds of thousands of host ops
    traces faster without them."""
    from torch.profiler import ProfilerActivity, profile
    t_trace = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    t_parse = time.perf_counter()
    spans, by_name = [], {}
    # the profiler's own events, read without the event tree that
    # prof.events() builds (tens of seconds past 10^5 events): torch's
    # private _KinetoEvent list (device_type, is_hidden_event, start_ns,
    # duration_ns, name: torch 2.11 and 2.13 have them), which raises
    # here if a version lacks one
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.is_hidden_event():
            continue
        t0 = e.start_ns() / 1e3
        t1 = t0 + e.duration_ns() / 1e3
        spans.append((t0, t1))
        by_name[e.name()] = by_name.get(e.name(), 0.0) + (t1 - t0) / 1e3
    t_parse, t_trace = time.perf_counter() - t_parse, t_parse - t_trace
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
            "top_ms": [[n[:120], t] for n, t in top],
            "trace_s": t_trace, "parse_s": t_parse}


def train_lm(torch, np, dev, record, card):
    """Phase 3 for LM training: Phi-4-mini at full width and depth, bf16,
    random weights from SEED.  First one loss_fn gradient on the first
    batch, kernel mode on and then off (blockwise attention): the losses
    within LOSS_REL_TOL and each leaf's grads within GRAD_REL_TOL (L2).
    Then Trainer.run for TRAIN_STEPS steps with the kernels: exactly
    TRAIN_LAUNCHES a step, a finite loss and grad_norm at every step; the
    eager ms of each step; one more step traced by torch.profiler for the
    step's device ms.  Returns the launches and, per kernel, its launches
    by shape."""
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
    by_case = {k: k9_by_case(k) for k in TRAIN_LAUNCHES}
    want = {k: TRAIN_STEPS * n for k, n in TRAIN_LAUNCHES.items()}
    if launches != want or by_case != {k: {FLASH_SLICE: n}
                                       for k, n in want.items()}:
        raise AssertionError(f"{LM_ARCH} training: launches {launches}, "
                             f"by shape {by_case} != {want} (each at "
                             f"{FLASH_SLICE})")
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
    return launches, by_case


def gpipe_lm(torch, np, dev, record, card):
    """GPipe training (``[gpipe]`` lines), after the training phase with
    its weights freed: Phi-4-mini's 32 decoder layers at full width,
    bf16, random weights from SEED, kernel mode on, cut by split_stages
    into GPIPE_STAGES stages on a model axis of ``["cuda:0"] *
    GPIPE_STAGES`` (a CUDA stream a stage), GPIPE_MICROBATCHES
    microbatches of 1 x LM_PROMPT tokens' embeddings (seeded tokens)
    against a seeded target, through ``gpipe_train_step``; each stage
    runs the port's own layer loop (``_scan_layers``, no remat).  Fails
    unless the launches are exactly GPIPE_LAUNCHES, all at FLASH_GPIPE;
    the loss is within LOSS_REL_TOL and every gradient leaf within
    GRAD_REL_TOL (L2) of the same stages run microbatch by microbatch
    under plain autograd with no ring; and every stage's gradients are
    finite and non-zero.  Prints the step's ms and the sequential run's
    (host clock, in turns), the step's device span (CUDA events) beside
    the sequential run's, which is the sum of the stage work on one
    stream, and the peak memory.  Returns the launches and, per kernel,
    its launches by shape."""
    import gc

    import torch.utils._pytree as pytree

    from repro_torch.configs import get_arch
    from repro_torch.core.dataflow import gpipe_train_step, split_stages
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import transformer as tmod
    gc.collect()                  # the training phase's weights go first
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    arch = get_arch(LM_ARCH)
    params = tmod.init_params(torch.Generator(device=dev).manual_seed(SEED),
                              arch, dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    toks = torch.randint(0, arch.vocab_size,
                         (GPIPE_MICROBATCHES, 1, LM_PROMPT), generator=g,
                         device=dev)
    with torch.no_grad():
        x_mb = torch.stack([tmod.embed(params["embed"], t) for t in toks])
    y_mb = torch.randn(x_mb.shape, generator=g, device=dev).to(x_mb.dtype)
    staged = split_stages(params["layers"], GPIPE_STAGES)
    del params
    mesh = compat_make_mesh((GPIPE_STAGES,), ("model",),
                            devices=[dev] * GPIPE_STAGES)
    positions = torch.arange(LM_PROMPT, device=dev).expand(1, LM_PROMPT)

    def layer_fn(p, x):
        return tmod._scan_layers(p, arch, x, positions, None,
                                 remat=False)[0]

    def loss_fn(o, y):
        return ((o.float() - y.float()) ** 2).mean()

    def gpipe():
        return gpipe_train_step(layer_fn, loss_fn, staged, x_mb, y_mb,
                                mesh=mesh)

    def sequential():
        leaves, spec = pytree.tree_flatten(staged)
        local = [[a[s].detach().requires_grad_(True) for a in leaves]
                 for s in range(GPIPE_STAGES)]
        losses = []
        for m in range(GPIPE_MICROBATCHES):
            x = x_mb[m]
            for ls in local:
                x = layer_fn(pytree.tree_unflatten(ls, spec), x)
            losses.append(loss_fn(x, y_mb[m]))
        loss = torch.stack(losses).mean()
        got = torch.autograd.grad(loss, [t for ls in local for t in ls])
        n = len(leaves)
        return loss.detach(), pytree.tree_unflatten(
            [torch.stack(got[i::n]) for i in range(n)], spec)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    loss, grads = gpipe()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    by_case = {k: k9_by_case(k) for k in GPIPE_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    if launches != GPIPE_LAUNCHES or by_case != {
            k: {FLASH_GPIPE: n} for k, n in GPIPE_LAUNCHES.items()}:
        raise AssertionError(f"[gpipe] launches {launches}, by shape "
                             f"{by_case} != {GPIPE_LAUNCHES} (each at "
                             f"{FLASH_GPIPE})")
    want_loss, want = sequential()
    loss, want_loss = float(loss), float(want_loss)
    rel = {name: rel_l2(torch, a, b) for (name, a), (_, b) in
           zip(named_leaves(grads), named_leaves(want))}
    worst = max(rel, key=rel.get)
    empty = [f"{name} stage {s}" for name, t in named_leaves(grads)
             for s in range(GPIPE_STAGES)
             if not bool(torch.isfinite(t[s]).all())
             or float(t[s].float().norm()) == 0.0]
    if not (np.isfinite(loss) and abs(loss - want_loss)
            <= LOSS_REL_TOL * abs(want_loss)):
        raise AssertionError(f"[gpipe] loss {loss} against the sequential "
                             f"run's {want_loss}")
    if not rel[worst] <= GRAD_REL_TOL or empty:
        raise AssertionError(f"[gpipe] grads of {worst} differ by "
                             f"{rel[worst]} > {GRAD_REL_TOL} (L2) from the "
                             f"sequential run's, or are zero or not finite: "
                             f"{empty}")
    del grads, want

    def host_and_span(fn):
        """(host ms, device span ms, the allocator's cudaMalloc calls)"""
        torch.cuda.synchronize()
        mallocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t) * 1e3, a.elapsed_time(b),
                torch.cuda.memory_stats().get("num_device_alloc", 0)
                - mallocs)
    times = {"gpipe": [], "sequential": []}
    for name in ("gpipe", "sequential", "sequential", "gpipe"):
        times[name].append(host_and_span(gpipe if name == "gpipe"
                                         else sequential))
    med = {k: (statistics.median(h for h, _, _ in v),
               statistics.median(d for _, d, _ in v)) for k, v in
           times.items()}
    rec = {"stages": GPIPE_STAGES, "microbatches": GPIPE_MICROBATCHES,
           "tokens": LM_PROMPT, "loss": loss, "sequential_loss": want_loss,
           "grad_rel_l2": rel, "launches": launches, "peak_bytes": peak,
           "first_step_s": first_s, "runs_ms": times,
           "ms": med["gpipe"][0], "span_ms": med["gpipe"][1],
           "sequential_ms": med["sequential"][0],
           "sequential_span_ms": med["sequential"][1],
           "seconds": time.perf_counter() - t_phase}
    record["gpipe"] = rec
    log("gpipe", f"{LM_ARCH} 32 layers (full width, bf16) in {GPIPE_STAGES} "
        f"stages on one card, {GPIPE_MICROBATCHES} microbatches of "
        f"1x{LM_PROMPT}: loss {loss:.6f} against the sequential run's "
        f"{want_loss:.6f}, worst leaf {worst} {rel[worst]:.4g} (bound "
        f"{GRAD_REL_TOL}); every stage's grads finite and non-zero; "
        f"launches {json.dumps(launches)} at {FLASH_GPIPE}; peak device "
        f"memory {peak / 1e9:.2f} GB")
    log("time", f"[gpipe] step {rec['ms']:.3f} ms (host, median of 2), "
        f"sequential {rec['sequential_ms']:.3f} ms; device span "
        f"{rec['span_ms']:.3f} ms against the sum of the stage work (the "
        f"sequential run's span on one stream) "
        f"{rec['sequential_span_ms']:.3f} ms; cudaMalloc calls a run "
        f"{[n for _, _, n in times['gpipe']]} and "
        f"{[n for _, _, n in times['sequential']]}; first step "
        f"{first_s:.2f} s; phase {rec['seconds']:.1f} s  [{card}]")
    del staged, x_mb, y_mb
    gc.collect()
    torch.cuda.empty_cache()
    return launches, by_case


def family_arch(name, n_layers):
    """``name``'s config at full width, cut to ``n_layers`` (None: all)."""
    import dataclasses

    from repro_torch.configs import get_arch
    arch = get_arch(name)
    return arch if n_layers is None else dataclasses.replace(
        arch, n_layers=n_layers)


def family_batch(torch, data, extra, step, dev):
    """Step ``step``'s batch of ``data`` on the card, with the stub front
    end's seeded frames or patches ``extra``."""
    return {**{k: torch.from_numpy(v).to(dev, torch.int64)
               for k, v in data.global_batch(step).items()}, **extra}


# K11's key loop in flash_bwd_dkv_tc, and the same loop run no time in
# the last key tile (k0 + TC_BM >= Sk) of every (batch, head)
K11_FUNCTION = "flash_bwd_dkv_tc(BwdArgs a)"
K11_LOOP = "  for (int qt = lo; qt <= hi; ++qt) {"
K11_PLANT = ("  for (int qt = lo; qt <= (k0 + TC_BM >= a.Sk ? lo - 1 : hi); "
             "++qt) {")


def start_k11_plant(_build):
    """Start nvcc on the "k11" plant of TRAIN_FAMILIES: a copy of
    ``csrc/flash_attention_bwd.cu`` whose K11 (``flash_bwd_dkv_tc``)
    leaves every block's last key tile out (K11_PLANT), built into the
    build directory under the hash of the planted source and the headers,
    so a later run loads it without building.  The returned function
    waits for nvcc and returns the library's path (nvcc is killed at exit
    if the script ends first)."""
    import hashlib
    import tempfile
    text = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    at = text.index(K11_FUNCTION)
    if K11_LOOP not in text[at:]:
        raise AssertionError("K11's key loop not found")
    planted = text[:at] + text[at:].replace(K11_LOOP, K11_PLANT, 1)
    h = hashlib.sha256(planted.encode())
    for header in sorted(_build.CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    out = _build.BUILD_DIR / f"k11_plant-{h.hexdigest()[:16]}.so"
    if out.exists():
        return lambda: out
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = out.with_suffix(".cu")
    src.write_text(planted)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build.BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         tmp, str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())

    def finish():
        if not out.exists():
            log_text, _ = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed on the K11 plant:\n"
                                   f"{log_text}")
            os.replace(tmp, out)
        return out
    return finish


@contextlib.contextmanager
def k11_planted(_build, path):
    """The flash backward library at ``path`` (``start_k11_plant``) in
    place of the sound one, for the launches inside."""
    import ctypes
    own = _build.load("flash_attention_bwd")
    _build._libs["flash_attention_bwd"] = ctypes.CDLL(str(path))
    try:
        yield
    finally:
        _build._libs["flash_attention_bwd"] = own


@contextlib.contextmanager
def slstm_scaled(torch):
    """The "slstm" plant of TRAIN_FAMILIES: inside, every sLSTM layer's
    output passes through a node whose backward scales the gradient by
    SLSTM_PLANT."""
    from repro_torch.models import ssm

    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g * SLSTM_PLANT

    own = ssm.slstm_forward

    def slstm_forward(*args, **kw):
        y, state = own(*args, **kw)
        return Scale.apply(y), state
    ssm.slstm_forward = slstm_forward
    try:
        yield
    finally:
        ssm.slstm_forward = own


def family_grads(torch, params, arch, batch, check, plant=None):
    """The gradient check of ``TRAIN_FAMILIES`` on one batch: loss_fn and
    its gradient (``value_and_grad``, remat on) as trained, and the
    reference's: with kernel mode off ("kernel"; the MoE routing of the
    kernel run forced on it, call by call, the remat's recompute
    included), or from the params cast to f32 ("f32", TF32 off).
    ``plant``: a context manager factory; the trained run once more
    inside it (the same routing forced), held to the same reference.
    Returns (loss, reference loss, {leaf: |g - g_ref| / |g_ref| (L2)},
    {leaf: |g_ref|}, and with ``plant`` the planted loss and {leaf: its
    |g - g_ref| / |g_ref|}, else None and None)."""
    import dataclasses

    import torch.utils._pytree as pytree

    from repro_torch.models import layers as lm_layers
    from repro_torch.runtime.trainer import value_and_grad
    with moe_routing() as routes:
        loss, g = value_and_grad(params, arch, batch)
    if check == "kernel":
        if arch.moe is not None and len(routes) != 2 * arch.n_layers:
            raise AssertionError(f"{arch.name}: {len(routes)} routings, "
                                 f"not the forward's and the recompute's")
        lm_layers.set_kernel_mode(False)
        try:
            with moe_routing(routes):
                ref_loss, g_ref = value_and_grad(params, arch, batch)
        finally:
            lm_layers.set_kernel_mode(True)
    else:
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("the f32 reference needs TF32 off")
        p32 = pytree.tree_map(lambda t: t.float(), params)
        ref_loss, g_ref = value_and_grad(
            p32, dataclasses.replace(arch, dtype="float32"), batch)
        del p32

    def rel_to_ref(grads):
        return {n: rel_l2(torch, a, b) for (n, a), (_, b) in
                zip(named_leaves(grads), named_leaves(g_ref))}
    rel = rel_to_ref(g)
    norm = {n: float(b.float().norm()) for n, b in named_leaves(g_ref)}
    del g
    planted_loss = planted_rel = None
    if plant is not None:
        with plant(), moe_routing(routes):
            planted_loss, g = value_and_grad(params, arch, batch)
        planted_loss, planted_rel = float(planted_loss), rel_to_ref(g)
        del g
    return (float(loss), float(ref_loss), rel, norm, planted_loss,
            planted_rel)


def train_family(torch, np, dev, record, card, row, plants):
    """``[train_families]``, one row of TRAIN_FAMILIES: the arch at full
    width (its ``n_layers`` layers, or all), bf16, random weights from
    SEED, kernel mode on.  The training state reckoned (12 B a parameter
    of accounting.count_params, 8 B an unembed-table entry).  First
    ``family_grads`` on the first batch: the loss's share and the worst
    leaf at or above LEAF_FLOOR within the row's bounds, and its plant
    (``plants[plant]``, a context manager factory) past one of them.  Then
    FAMILY_STEPS steps of ``batch`` x ``seq`` tokens, each step's loss and
    grad norm finite and K9, K10 and K11 launched exactly as ``cases``
    say a step (K9 twice a layer under remat, K10 and K11 once), by
    shape; the eager ms of each step, the peak device memory beside the
    reckoning; one more step traced by torch.profiler for its device ms.
    Returns the launches and, per kernel, its launches by shape."""
    import gc

    from repro_torch.data.pipeline import DataConfig, TokenDataset
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tmod
    from repro_torch.models.accounting import count_params
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import (TrainConfig, Trainer,
                                             make_train_step)
    name, n_layers, batch, seq, cases, check, bounds, plant = row
    t_arch = time.perf_counter()
    gc.collect()                  # the earlier phases' weights go first
    torch.cuda.empty_cache()
    arch = family_arch(name, n_layers)
    mla = arch.mla
    hd, hd_v, kv = ((mla.qk_nope_head_dim + mla.qk_rope_head_dim,
                     mla.v_head_dim, arch.n_heads) if mla else
                    (arch.resolved_head_dim, arch.resolved_head_dim,
                     arch.n_kv_heads))
    per_step = {}
    for case, part in cases:
        want = (batch, arch.n_heads, kv,
                arch.n_frames if part == "enc" else seq, hd, hd_v,
                part == "dec")
        if tuple(case[:7]) != want:
            raise AssertionError(f"{name}: training shape {case} is not "
                                 f"the arch's {part} shape {want}")
        per_step[case] = arch.n_enc_layers if part == "enc" else \
            arch.n_layers
    n_count = count_params(arch)
    data = TokenDataset(DataConfig(arch.vocab_size, seq, batch, seed=SEED))
    extra = stub_inputs(torch, np, arch, batch, dev, seeded=True)
    rec = {"arch": name, "n_layers": arch.n_layers, "batch": batch,
           "seq": seq, "check": check, "bounds": bounds, "plant": plant,
           "count_params": n_count}

    # 1. the gradient check on the first batch, then on its plant
    params = tmod.init_params(torch.Generator(device=dev).manual_seed(SEED),
                              arch, dev)
    table = tmod._unembed_table(params, arch)["table"].numel()
    rec["reckoned_state_bytes"] = 12 * n_count + 8 * table
    b0 = family_batch(torch, data, extra, 0, dev)
    loss, ref_loss, rel, norm, p_loss, p_rel = family_grads(
        torch, params, arch, b0, check, plants[plant] if plant else None)
    del params
    parts = {"grad_check": time.perf_counter() - t_arch}
    big = max(norm.values())
    held = [n for n in rel if norm[n] >= LEAF_FLOOR * big]
    below = sorted(set(rel) - set(held), key=rel.get, reverse=True)
    worst = max(held, key=rel.get)
    loss_share = abs(loss - ref_loss) / abs(ref_loss)
    rec.update(loss=loss, ref_loss=ref_loss, loss_share=loss_share,
               grad_rel_l2=rel, grad_norm_ref=norm, worst_leaf=worst,
               leaves_below_floor=below)
    tol_loss, tol_grad = bounds
    ref = "kernel mode off" if check == "kernel" else "the f32 params"
    if not (np.isfinite(loss) and all(np.isfinite(list(rel.values())))):
        raise AssertionError(f"{name}: loss {loss} or grads not finite: "
                             f"{rel}")
    if not loss_share <= tol_loss:
        raise AssertionError(f"{name}: loss {loss} against {ref_loss} with "
                             f"{ref}: {loss_share} > {tol_loss}")
    if not rel[worst] <= tol_grad:
        raise AssertionError(f"{name}: grads of {worst} differ from {ref}'s "
                             f"by {rel[worst]} > {tol_grad} (L2)")
    top = sorted(held, key=rel.get, reverse=True)[:3]
    log("train_families", f"{name} loss_fn grad against {ref}: loss "
        f"{loss:.6f} vs {ref_loss:.6f} ({loss_share:.3g}, bound "
        f"{tol_loss}); worst leaves (L2 share, |g| over the largest "
        f"leaf's) " + ", ".join(f"{n} {rel[n]:.4g} ({norm[n] / big:.2g})"
                                for n in top) + f" (bound {tol_grad}); "
        f"below {LEAF_FLOOR} of the largest, not held: " + (", ".join(
            f"{n} {rel[n]:.4g} ({norm[n] / big:.2g})" for n in below)
            or "none"))
    if plant:
        p_share = abs(p_loss - ref_loss) / abs(ref_loss)
        p_worst = max(held, key=p_rel.get)
        caught = p_share > tol_loss or p_rel[p_worst] > tol_grad
        rec["planted"] = {"loss_share": p_share, "worst_leaf": p_worst,
                          "worst": p_rel[p_worst], "caught": caught,
                          "grad_rel_l2": p_rel}
        log("train_families", f"{name} plant {plant}: loss share "
            f"{p_share:.3g} (bound {tol_loss}), worst leaf {p_worst} "
            f"{p_rel[p_worst]:.4g} (bound {tol_grad}): "
            f"{'caught' if caught else 'MISSED'}")
        if not caught:
            raise AssertionError(f"{name}: the {plant} plant passes the "
                                 f"gradient check's bounds {bounds}")
    gc.collect()
    torch.cuda.empty_cache()

    # 2. FAMILY_STEPS steps and one profiled
    tcfg = TrainConfig(steps=FAMILY_STEPS, microbatches=1, remat=True,
                       ckpt_every=FAMILY_STEPS + 2, log_every=1,
                       ckpt_path=str(ROOT / "build" / "train_ckpt"))
    hist = []
    if extra:
        # frames or patches: make_train_step on the batches directly
        state = {"params": tmod.init_params(
            torch.Generator(device=dev).manual_seed(SEED), arch, dev)}
        state["opt"] = adamw.init(state["params"], tcfg.adamw)
        step_fn = make_train_step(arch, tcfg)

        def one_step():
            i = len(hist)
            state["params"], state["opt"], m = step_fn(
                state["params"], state["opt"],
                family_batch(torch, data, extra, i, dev))
            hist.append({"step": i + 1, "loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"])})
    else:
        state = {"trainer": Trainer(arch, tcfg, data, seed=SEED, device=dev)}

        def one_step():
            state["trainer"].run(n_steps=1)
            hist[:] = state["trainer"].history
    torch.cuda.synchronize()
    parts["init"] = time.perf_counter() - t_arch - sum(parts.values())
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    _build.reset_launches()
    for _ in range(FAMILY_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(_build.LAUNCHES)
    by_case = {k: k9_by_case(k) for k in TRAIN_LAUNCHES}
    want = {LM_KERNEL: {c: 2 * FAMILY_STEPS * n for c, n in per_step.items()},
            **{k: {c: FAMILY_STEPS * n for c, n in per_step.items()}
               for k in BWD_KERNELS}}
    if by_case != want or launches != {
            k: sum(by.values()) for k, by in want.items() if by}:
        raise AssertionError(f"{name} training: launches {launches}, by "
                             f"shape {by_case} != {want}")
    if [h["step"] for h in hist] != list(range(1, FAMILY_STEPS + 1)) or \
            not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                    for h in hist):
        raise AssertionError(f"{name} training: history {hist}")
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    parts["steps"] = time.perf_counter() - t_arch - sum(parts.values())
    prof = profile_device_ms(torch, one_step)
    parts["profiled_step"] = time.perf_counter() - t_arch - sum(
        parts.values())
    if list(Path(tcfg.ckpt_path).glob("step_*")):
        raise AssertionError(f"a checkpoint was written to {tcfg.ckpt_path}")
    ms = step_ms[-1]
    rec.update(history=hist, step_ms=step_ms, ms_per_step=ms,
               tokens_per_s=batch * seq / ms * 1e3, profiled_step=prof,
               launches=launches,
               device_ms_per_step=prof and prof["busy_ms"],
               idle_share=prof and 1 - prof["busy_ms"] / ms)
    state.clear()
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_arch
    rec["parts_s"] = parts
    record.setdefault("train_families", {})[name] = rec
    idle = ("not measured (no device activity in the trace)" if prof is None
            else f"{prof['busy_ms']:.3f} ms device, idle "
                 f"{100 * rec['idle_share']:.0f}%")
    log("train_families", f"{name} ({arch.n_layers} layers, full width, "
        f"bf16) trained {FAMILY_STEPS} steps of {batch}x{seq} tokens"
        f"{' with ' + next(iter(extra)) if extra else ''}: losses "
        f"{[round(h['loss'], 4) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}; launches a step "
        f"{json.dumps({k: n // FAMILY_STEPS for k, n in launches.items()})}"
        f"; peak device memory {rec['peak_bytes'] / 1e9:.2f} GB against "
        f"{rec['reckoned_state_bytes'] / 1e9:.2f} GB of reckoned state "
        f"({n_count:,} parameters); {rec['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    log("time", f"{name} train step {batch}x{seq}: {ms:.3f} ms eager (step "
        f"{FAMILY_STEPS}), {rec['tokens_per_s']:.1f} tokens/s; {idle}; "
        f"costliest kernels "
        f"{[[n[:60], round(t, 3)] for n, t in (prof or {}).get('top_ms', [])]}"
        f"  [{card}]")
    return launches, by_case


def abstract_traces(torch, compile, get_cnn, target, record, card):
    """``[abstract]`` lines: ``trace_fused_abstract`` of ResNet-50 and
    VGG-16 as compiled for ``target`` at batch BATCH, scanned and
    unrolled: the seconds and the aten ops counted.  Fails unless the
    card's allocated memory is the same before and after each call and
    the engines the trace dispatched are the compiled net's engine
    table."""
    from repro_torch.compiler import count_jaxpr_eqns, trace_fused_abstract
    rows = {}
    for name in ("resnet50", "vgg16"):
        for scan in (True, False):
            cp = compile(get_cnn(name), target, scan=scan)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            trace, secs = trace_fused_abstract(cp, BATCH)
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated()
            engines = {s.name: s.kernel for s in trace.stats}
            if after != before or engines != cp.engine_table():
                raise AssertionError(
                    f"[abstract] {name} scan={scan}: device memory "
                    f"{before} -> {after} bytes, or the engines dispatched "
                    f"differ from the engine table")
            rows[f"{name} {'scanned' if scan else 'unrolled'}"] = {
                "seconds": secs, "ops": count_jaxpr_eqns(trace),
                "scan_groups": len(cp.scan_table())}
    record["abstract_trace"] = rows
    log("abstract", f"trace_fused_abstract at batch {BATCH} on meta (aten "
        f"ops, seconds): " + "; ".join(
            f"{k} {v['ops']} ops in {v['seconds']:.3f} s "
            f"({v['scan_groups']} scan groups)" for k, v in rows.items())
        + f"; device memory unchanged across each call  [{card}]")


def time_flash_bwd(torch, F, g, dev, ks, launches_by_case, card, record):
    """Phase 4 for K10/K11: device ms per launch of each at their
    main-path shapes (``launches_by_case``: kernel -> the training
    phase's and the dry run's launches, counted by shape at the launch;
    each must be one of BWD_MAIN) and at S = 2048 (model layout, as the
    training path calls them), the plain version's ms for the pair, and
    the backward of F.scaled_dot_product_attention (GQA, causal where the
    shape is) for the pair; each row sums them over the launches of each
    shape."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_plain
    stray = {k: [c for c in by if c not in BWD_MAIN]
             for k, by in launches_by_case.items()}
    if any(stray.values()):
        raise AssertionError(f"K10/K11 launched on the main path at shapes "
                             f"BWD_MAIN lacks: {stray}")
    per = {}
    for case in BWD_MAIN + (FLASH_LONG,):
        B, H, KV, S, hd, hd_v, causal = case[:7]
        q, k, v = (t.transpose(1, 2).contiguous() for t in flash_inputs(
            torch, g, dev, case, torch.bfloat16))
        do = torch.randn((B, S, H, hd_v), generator=g,
                         device=dev).to(torch.bfloat16)
        qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
        o, lse = ops.flash_attention_kernel(qt, kt, vt, return_lse=True,
                                            causal=causal)
        delta = ops._delta(o, dot)
        dq = torch.empty_like(q)
        dk = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
        dv = torch.empty((B, S, H, hd_v), dtype=q.dtype, device=dev)

        def launch(which):
            return lambda: ops._launch_bwd(
                qt, kt, vt, dot, lse, delta, dq.transpose(1, 2),
                dk.transpose(1, 2), dv.transpose(1, 2), causal=causal,
                window=0, softcap=0.0, which=which)
        reps = 20 if S <= 512 else 5
        got = ops.flash_attention_bwd(qt, kt, vt, o, lse, dot, causal=causal)
        backends, best = sdpa_bwd_readings(torch, F, qt, kt, vt, dot, causal,
                                           reps)
        lib_diff = float((best[1][0].float() - got[0].float()).abs().max())
        elems_q, elems_kv = B * H * S * hd, B * KV * S * (hd + hd_v)
        # the (query, key) pairs the mask keeps; K10 takes q k^T, dO v^T
        # and dS k over them, K11 q k^T, dO v^T, p^T dO and dS^T q
        pairs = B * H * S * S // (2 if causal else 1)
        n_dq = 2 * (2 * elems_q + elems_kv + B * H * S * hd_v) + 8 * B * H * S
        n_dkv = 2 * (elems_q + elems_kv + B * H * S * hd_v
                     + B * H * S * (hd + hd_v)) + 8 * B * H * S
        t = per[case] = {
            "library_ms": backends[best[0]],
            "library_backend": best[0], "library_backends": backends,
            "plain_ms": plain_ms(torch, lambda: flash_attention_bwd_plain(
                qt, kt, vt, o, lse, dot, causal=causal), S, record, None,
                reps=2),
            "library_max_abs_diff_dq": lib_diff}
        for kname, which, nbytes, ops_ in (
                (BWD_KERNELS[0], (0,), n_dq, 2 * pairs * (2 * hd + hd_v)),
                (BWD_KERNELS[1], (1,), n_dkv,
                 2 * pairs * (2 * hd + 2 * hd_v))):
            b, by = bound_ms(nbytes, ops_, BF16_FLOPS_PER_S)
            t[kname] = {
                "ms": device_ms(torch, launch(which), reps=reps),
                "call_ms": call_ms(torch, launch(which), reps=reps),
                "bound_ms": b, "bound_by": by, "bytes": nbytes,
                "flops": ops_}
        log("time", f"flash backward B={B} H={H} KV={KV} S={S} hd={hd} "
            f"hd_v={hd_v} bf16 {'causal' if causal else 'non-causal'}: "
            f"dq {t[BWD_KERNELS[0]]['ms']:.4f} ms, dk/dv "
            f"{t[BWD_KERNELS[1]]['ms']:.4f} ms per launch (device); "
            f"bounds {t[BWD_KERNELS[0]]['bound_ms']:.4f} / "
            f"{t[BWD_KERNELS[1]]['bound_ms']:.4f} ms; the pair: plain "
            f"{t['plain_ms']:.4f} ms, SDPA backward "
            f"{t['library_ms']:.4f} ms ({t['library_backend']}; "
            + ", ".join(f"{n} refused" if isinstance(v, str) else
                        f"{n} {v:.4f}" for n, v in backends.items())
            + f"); main-path launches "
            f"{[launches_by_case[k].get(case, 0) for k in BWD_KERNELS]}"
            f"  [{card}]")
    for kname in BWD_KERNELS:
        kern, by = ks[kname], launches_by_case[kname]
        main = [(n, per[c]) for c, n in by.items() if n]
        kern.ms = sum(n * t[kname]["ms"] for n, t in main)
        kern.bound_ms = sum(n * t[kname]["bound_ms"] for n, t in main)
        by_time = {}
        for n, t in main:
            by_time[t[kname]["bound_by"]] = by_time.get(
                t[kname]["bound_by"], 0.0) + n * t[kname]["bound_ms"]
        kern.bound_by = max(by_time, key=by_time.get)
        # the plain version and the library compute dq, dk and dv in one
        # call: each row carries the pair's time
        kern.plain_ms = sum(n * t["plain_ms"] for n, t in main)
        kern.library_ms = sum(n * t["library_ms"] for n, t in main)
        kern.per_shape = [{
            "case": list(c), "launches": n, "ms": per[c][kname]["ms"],
            "plain_ms": per[c]["plain_ms"],
            "bound_ms": per[c][kname]["bound_ms"],
            "bound_by": per[c][kname]["bound_by"],
            "library_ms": per[c]["library_ms"]}
            for c, n in by.items() if n]
    record["flash_bwd_per_launch"] = {case_key(c): d for c, d in per.items()}


def backward_ms(torch, forward, inputs, do, reps, replays=5):
    """Device ms of autograd's backward of ``forward(*inputs)`` against
    the gradient ``do``, and its first grads.  Autograd runs a backward
    op on its forward op's stream, so the forward runs on a side stream
    and the CUDA graph of ``reps`` backward calls is captured on that
    stream, then replayed and timed by events (the profiler's trace of
    cuDNN's backward came back empty or partial on an H100, and events
    around eager calls time the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward(*inputs)
        first = torch.autograd.grad(out, inputs, do, retain_graph=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="relaxed"):
        for _ in range(reps):
            torch.autograd.grad(out, inputs, do, retain_graph=True)
    graph.replay()
    return event_ms(torch, graph.replay, replays) / (reps * replays), first


def sdpa_bwd_readings(torch, F, q, k, v, do, causal, reps):
    """The backward of ``F.scaled_dot_product_attention`` (GQA, causal or
    not) on kernel-layout views, backend by backend: {backend: its device
    ms a call (``backward_ms``), or the reason it refuses these
    operands}, and the fastest backend with its (dq, dk, dv)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    found, best = {}, None
    for b in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION):
        lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))

        def forward(q_, k_, v_, b=b):
            with sdpa_kernel([b]):
                return F.scaled_dot_product_attention(
                    q_, k_, v_, is_causal=causal, enable_gqa=True)
        try:
            forward(lq, lk, lv)
        except RuntimeError as e:
            found[b.name] = f"refused: {str(e).splitlines()[0][:160]}"
            continue
        found[b.name], first = backward_ms(torch, forward, (lq, lk, lv), do,
                                           reps)
        if best is None or found[b.name] < found[best[0]]:
            best = (b.name, first)
    return found, best


def sdpa_readings(torch, F, q, k, v, causal=True):
    """``F.scaled_dot_product_attention`` (GQA, causal or not) on
    kernel-layout views, backend by backend: {backend: device ms per
    call, or the reason it refuses these operands}, and the fastest
    backend's call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    found, best = {}, None
    for b in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def call(b=b):
            with sdpa_kernel([b]):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
        try:
            call()
            ms = device_ms(torch, call, reps=20 if b != SDPBackend.MATH
                           else 3, replays=5 if b != SDPBackend.MATH else 2)
        except RuntimeError as e:
            found[b.name] = f"refused: {str(e).splitlines()[0][:160]}"
            continue
        found[b.name] = ms
        if best is None or ms < found[best[0]]:
            best = (b.name, call)
    return found, best


def case_key(case):
    """A FLASH case's key in the record: B x H x KV x S x hd x hd_v, and
    "-nc" where not causal."""
    return "x".join(str(n) for n in case[:6]) + ("" if case[6] else "-nc")


def plain_ms(torch, fn, S, record, key, reps=3, replays=2):
    """A plain version's device ms per call (``device_ms``), or, past
    PLAIN_GRAPH_MAX_S, the ms of one eager call by CUDA events (its host
    dispatch included): the one phase 2 timed under ``key``
    (``plain_once_ms``), else one call now."""
    if S <= PLAIN_GRAPH_MAX_S:
        return device_ms(torch, fn, reps=reps, replays=replays)
    once = record.get("plain_once_ms", {})
    return once[key] if key in once else event_ms(torch, fn, 1)


def time_flash(torch, F, g, dev, kern, launches_by_case, card, record):
    """Phase 4 for K9: device ms per launch at each main-path shape
    (``launches_by_case``: the LM phases' launches, counted by shape at
    the launch; each must be one of FLASH_MAIN) and at S = 2048 (model
    layout, as the main path calls it), its plain version, and
    F.scaled_dot_product_attention on the same tensors (every backend
    tried, the fastest that takes the operands kept); the kernel's row
    sums them over the launches of each shape."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_route)
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    stray = [c for c in launches_by_case if c not in FLASH_MAIN]
    if stray:
        raise AssertionError(f"K9 launched on the main path at shapes "
                             f"FLASH_MAIN lacks: {stray}")
    per = {}
    for case in FLASH_MAIN + (FLASH_LONG,):
        B, H, KV, S, hd, hd_v, causal = case[:7]
        key = case_key(case)
        q, k, v = (t.transpose(1, 2).contiguous() for t in flash_inputs(
            torch, g, dev, case, torch.bfloat16))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        libs, (lib_name, lib) = sdpa_readings(torch, F, qt, kt, vt, causal)
        kw = flash_kw(case)
        lib_diff = float((lib().transpose(1, 2).float()
                          - flash_attention(q, k, v, **kw).float())
                         .abs().max())
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + B * S * H * hd_v) \
            + 4 * B * H * S
        flops = 2 * B * H * S * S * (hd + hd_v) // (2 if causal else 1)
        b, by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        t = per[key] = {
            "case": list(case), "launches": launches_by_case.get(case, 0),
            "ms": device_ms(torch, lambda: flash_attention(q, k, v, **kw),
                            reps=20),
            "call_ms": call_ms(torch, lambda: flash_attention(q, k, v, **kw),
                               reps=20),
            "plain_ms": plain_ms(torch, lambda: flash_attention_plain(
                qt, kt, vt, **kw), S, record, key),
            "library_ms": libs[lib_name], "library_backend": lib_name,
            "library_backends": libs, "bound_ms": b, "bound_by": by,
            "bytes": nbytes, "flops": flops,
            "library_max_abs_diff": lib_diff,
            "route": flash_route(torch.bfloat16, hd, hd_v)}
        t["factor"] = t["ms"] / t["library_ms"]
        log("time", f"{LM_KERNEL} B={B} H={H} KV={KV} S={S} hd={hd} "
            f"hd_v={hd_v} bf16 {'causal' if causal else 'non-causal'} "
            f"({t['route']} route, "
            f"{t['launches']} main-path launches): {t['ms']:.4f} ms per "
            f"launch (device), plain {t['plain_ms']:.4f} ms, SDPA "
            f"{t['library_ms']:.4f} ms ({lib_name}; {t['factor']:.3f}x), "
            f"bound {b:.4f} ms ({by}), {flops / t['ms'] / 1e9:.1f} TFLOP/s; "
            f"SDPA backends: " + ", ".join(
                f"{n} {v:.4f} ms" if isinstance(v, float) else f"{n} {v}"
                for n, v in libs.items()) + f"  [{card}]")
    main = [t for t in per.values() if t["launches"]]
    for what in ("ms", "plain_ms", "library_ms", "bound_ms"):
        setattr(kern, what, sum(t["launches"] * t[what] for t in main))
    by_time = {}
    for t in main:
        by_time[t["bound_by"]] = by_time.get(t["bound_by"], 0.0) + \
            t["launches"] * t["bound_ms"]
    kern.bound_by = max(by_time, key=by_time.get)
    kern.per_shape = [{k: t[k] for k in (
        "case", "route", "launches", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "library_backend")} for t in main]
    record["flash_per_launch"] = per


def time_lm(torch, st, card, lm_rec, name=LM_ARCH):
    """Phase 4 for an LM: eager prefill ms per batch, decode ms per step
    and tokens/s of whole engine runs; one prefill and one decode step
    replayed as CUDA graphs for device time and the card's idle share.
    Adds them to ``lm_rec``.  ``st`` may set the prompt length and
    max_seq (else LM_PROMPT, LM_MAX_SEQ), the feed's other inputs
    (``extra``: the engine's zero frames or patches) and the eager
    repeats (``reps``: engine runs, prefills; else 2, 4)."""
    from repro_torch.models import transformer as tmod
    from repro_torch.runtime.serving import Request
    params, arch, engine = st["params"], st["arch"], st["engine"]
    prompt = st.get("prompt", LM_PROMPT)
    max_seq = st.get("max_seq", LM_MAX_SEQ)
    run_reps, pre_reps = st.get("reps", (2, 4))
    toks = st["batches"][0]
    B = toks.shape[0]
    feed = {"tokens": toks, **st.get("extra", {})}

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
        run_reps)
    with torch.no_grad():
        def prefill():
            return tmod.prefill(params, arch, feed, max_seq)
        pre_ms = host_ms(prefill, pre_reps)[1:]
        logits, cache = prefill()
        cur = logits.argmax(-1)[:, None]
        pos = iter(range(prompt, max_seq))
        dec_ms = host_ms(lambda: tmod.decode_step(params, arch, cache, cur,
                                                  next(pos)), 9)[1:]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            g_logits, _ = prefill()
        graph.replay()
        torch.cuda.synchronize()
        gdiff = float((g_logits - logits).abs().max())
        if not gdiff <= LM_REL_TOL * float(logits.abs().max()):
            raise AssertionError(f"{name}: the replayed prefill's logits "
                                 f"differ from the eager one's by {gdiff}")
        pre_dev = event_ms(torch, graph.replay, 5) / 5
        del graph
        dgraph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(dgraph, capture_error_mode="relaxed"):
            tmod.decode_step(params, arch, cache, cur, prompt)
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
           "prefill_tokens_per_s": B * prompt / pre * 1e3,
           "graph_prefill_max_abs_diff": gdiff}
    lm_rec.update(rec)
    log("time", f"{name} batch {B}x{prompt}: prefill {pre:.3f} ms "
        f"eager, {pre_dev:.3f} ms device (idle {100 * rec['prefill_idle_share']:.0f}%); "
        f"decode step {dec:.3f} ms eager, {dec_dev:.3f} ms device (idle "
        f"{100 * rec['decode_idle_share']:.0f}%); engine.run of "
        f"{LM_REQUESTS} requests {run:.1f} ms, {rec['tokens_per_s']:.1f} "
        f"generated tokens/s  [{card}]")


def routing_masks(torch, arch, top_e):
    """The experts each token of a prefill picked and those of its choices
    the capacity cut kept, as two ``[T, E]`` bool masks, from its top-k
    experts ``[T, k]`` (the grouped path's groups and positions)."""
    from repro_torch.models import ffn
    T, k = top_e.shape
    tg = min(ffn.MOE_GROUP, T)
    pos = ffn.capacity_positions(top_e.reshape(T // tg, tg, k),
                                 arch.moe.n_experts).reshape(T, k)
    keep = pos < ffn.moe_capacity(arch, tg)
    chosen = torch.zeros((T, arch.moe.n_experts), dtype=torch.bool,
                         device=top_e.device).scatter_(1, top_e, True)
    return chosen, torch.zeros_like(chosen).scatter_(1, top_e, keep)


def routed_apart(torch, arch, a, b):
    """[T] True where two routings ``[T, k]`` of one prefill differ in the
    experts a token picked or in those of its choices the capacity cut
    kept."""
    ca, ka = routing_masks(torch, arch, a)
    cb, kb = routing_masks(torch, arch, b)
    return ((ca != cb) | (ka != kb)).any(-1)


@contextlib.contextmanager
def moe_routing(forced=None):
    """Reads or forces the MoE routing of what runs inside.  Yields a list
    that gets, call by call, the top-k experts ``[T, k]`` each MoE layer
    took.  With ``forced`` (such a list, in the same order) each call
    takes the next one's experts instead of its router's top-k, its gates
    the router's probabilities renormalised over them.  Patches
    ``repro_torch.models.ffn.top_k``, which ``moe_router`` calls once a
    layer (the package itself has no such option)."""
    from repro_torch.models import ffn
    own = ffn.top_k
    it = None if forced is None else iter(forced)
    taken = []

    def top_k(probs, k):
        if it is None:
            p, e = own(probs, k)
        else:
            e = next(it).reshape(*probs.shape[:-1], k)
            p = probs.gather(-1, e)
        taken.append(e.reshape(-1, k))
        return p, e

    ffn.top_k = top_k
    try:
        yield taken
    finally:
        ffn.top_k = own


def stub_inputs(torch, np, arch, batch, dev, seeded):
    """The stub front ends' inputs: a VLM's patches [batch, n_patches, d]
    or an encoder-decoder's frames [batch, n_frames, d], f32; zeros, as
    the engine feeds them, or (``seeded``) 0.01 x N(0, 1) from SEED, as
    tests/test_archs_smoke.py draws them.  {} for the other archs."""
    n = {"vlm": arch.n_patches}.get(arch.family, arch.n_frames
                                    if arch.enc_dec else 0)
    if not n:
        return {}
    shape = (batch, n, arch.d_model)
    x = (0.01 * np.random.default_rng(SEED).normal(size=shape)).astype(
        np.float32) if seeded else np.zeros(shape, np.float32)
    return {"patches" if arch.family == "vlm" else "frames":
            torch.from_numpy(x).to(dev)}


def dense_walk(torch, tmod, lm_layers, params, arch, feed, *, kernel,
               routes, f32=False, plant=0.0, hold=None):
    """Last-token logits of the prefill of ``feed``, walked layer by layer
    (an encoder's first) with the package's functions, kernel mode
    ``kernel``, every MoE layer's routing forced to ``routes`` (the top-k
    experts each MoE layer of a prefill took, in order, as
    ``moe_routing`` reads them; [] for an arch without MoE layers).
    ``f32``: from the model-dtype embedding (or frames) on in f32, each
    layer's weights cast as it runs (TF32 off): the reference both
    model-dtype paths are held to.  ``plant``: every self-attention
    sublayer's output scaled by 1 + plant, a planted fault for the check
    to see.  ``hold``: a list that gets, layer by layer, max |kernel -
    plain| of the layer's output from one input and routing over
    LM_REL_TOL x max |plain|; the walk goes on from the plain output."""
    import dataclasses

    import torch.utils._pytree as pytree
    from repro_torch.models.layers import cross_attention_kv, rmsnorm
    if f32 and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 walk needs TF32 off")
    run_arch = dataclasses.replace(arch, dtype="float32") if f32 else arch

    def body(x, lp, positions, causal, memory, on):
        lm_layers.set_kernel_mode(on)
        try:
            if f32:
                lp = pytree.tree_map(lambda t: t.float(), lp)
            y, _, _ = tmod._attn_block(run_arch, x, lp, None, positions,
                                       causal=causal)
            if plant:
                y = x + (y - x) * (1 + plant)
            if memory is not None:
                y = tmod._cross_block(run_arch, y, lp, cross_attention_kv(
                    lp["cross"], run_arch, memory))
            return tmod._ffn_block(run_arch, y, lp, with_aux=False)[0]
        finally:
            lm_layers.set_kernel_mode(True)

    def walk(x, stack, n, causal=True, memory=None):
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[0], x.shape[1])
        x = x.float() if f32 else x
        for lp in tmod._unstack(stack, n):
            if hold is None:
                x = body(x, lp, positions, causal, memory, kernel)
                continue
            yp = body(x, lp, positions, causal, memory, False)
            yk = body(x, lp, positions, causal, memory, True)
            diff, top = float((yk - yp).abs().max()), float(yp.abs().max())
            # zero frames give an encoder of zeros on both paths
            hold.append(diff / (LM_REL_TOL * top) if top else
                        (0.0 if diff == 0 else float("inf")))
            x = yp
        return x

    # with ``hold`` each layer runs twice (plain, then kernel), both on
    # the layer's routing
    with moe_routing([r for r in routes for _ in range(1 + (hold is not None))]):
        memory = None
        if arch.enc_dec:
            enc = walk(feed["frames"].to(getattr(torch, arch.dtype)),
                       params["enc_layers"], arch.n_enc_layers, causal=False)
            memory = rmsnorm(params["ln_enc"], enc, arch.norm_eps)
        x = walk(tmod._embed_inputs(params, arch, feed),
                 params["dec_layers" if arch.enc_dec else "layers"],
                 arch.n_layers, memory=memory)
    h = rmsnorm(params["ln_f"], x, arch.norm_eps)
    return tmod.logits_from_hidden(params, arch, h[:, -1])


def k9_by_case(name=LM_KERNEL):
    """K9's (or K10's or K11's, by ``name``) launches since the last
    reset, by the shape the wrapper counted them under, keyed as the
    FLASH cases are (B, H, KV, S, hd, hd_v, causal, window, softcap) where
    the launch was bf16 with as many keys as queries, as the main path's
    are; any other launch keeps the wrapper's own key, so that it shows
    in a comparison."""
    from repro_torch.kernels import _build
    out = {}
    for (kernel, key), n in _build.SHAPE_LAUNCHES.items():
        if kernel == name:
            dtype, B, H, KV, Sq, Sk, *rest = key
            out[(B, H, KV, Sq, *rest) if dtype == "bfloat16" and Sq == Sk
                else key] = n
    return out


def ep_prefills(torch, dev, params, arch, toks, name, card, f32=False):
    """``[ep]`` lines: the expert-parallel MoE on one card.  The prefill
    of ``toks`` (the serving phase's first LM_SLOTS x LM_PROMPT feed) with
    no mesh (the grouped path), then under compat_make_mesh(EP_MESH,
    ("data", "model"), devices=[dev] * 4) with the grouped run's routing
    forced (``moe_routing``).  Fails unless the EP region
    (``ffn._moe_ep_shardmap``, counted by a spy) ran once at every MoE
    layer under the mesh and never without it; each MoE layer, from the
    grouped run's input to it, gives the EP output within ``tol`` x
    max|output| of the grouped one, and the logits are within ``tol`` x
    max|logit| (``tol``: LM_REL_TOL in bf16, F32_REL_TOL in f32); K9's
    launches by shape are the same on both runs (data 1: the flash
    call's mesh rule does not engage).  Prints both prefills' device ms
    (each captured once into a CUDA graph and replayed).  Returns the
    record and, in bf16, K9's launches by shape on the mesh run."""
    import math

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import ffn
    from repro_torch.models import transformer as tmod
    tol = F32_REL_TOL if f32 else LM_REL_TOL
    mesh = compat_make_mesh(EP_MESH, ("data", "model"),
                            devices=[dev] * math.prod(EP_MESH))
    feed = {"tokens": toks}
    own_ep, own_moe = ffn._moe_ep_shardmap, tmod.moe_ffn
    calls, inputs = [], []

    def ep_spy(*a, **k):
        calls.append(1)
        return own_ep(*a, **k)

    def moe_spy(p, cfg, x, *a, **k):
        inputs.append((p, x))
        return own_moe(p, cfg, x, *a, **k)

    def share(a, b):
        return float((a.float() - b.float()).abs().max()) / (
            tol * float(b.float().abs().max()))

    def replayed_ms(fn):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            fn()
        graph.replay()
        ms = event_ms(torch, graph.replay, 5) / 5
        del graph
        return ms

    ffn._moe_ep_shardmap = ep_spy
    try:
        with torch.no_grad():
            tmod.moe_ffn = moe_spy
            try:
                _build.reset_launches()
                with moe_routing() as routes:
                    lg, _ = tmod.prefill(params, arch, feed, LM_MAX_SEQ)
                k9_grouped = k9_by_case()
            finally:
                tmod.moe_ffn = own_moe
            n_moe, grouped_calls = len(routes), len(calls)
            _build.reset_launches()
            with mesh, moe_routing(routes):
                le, _ = tmod.prefill(params, arch, feed, LM_MAX_SEQ)
            k9_ep, prefill_calls = k9_by_case(), len(calls) - grouped_calls
            layer = []
            for p, x in inputs:
                yg = own_moe(p, arch, x, arch.act, with_aux=False)[0]
                with mesh:
                    ye = own_moe(p, arch, x, arch.act, with_aux=False)[0]
                layer.append(share(ye, yg))
            del inputs[:]
            layer_calls = len(calls) - grouped_calls - prefill_calls
            grouped_ms = replayed_ms(
                lambda: tmod.prefill(params, arch, feed, LM_MAX_SEQ))
            with mesh:
                ep_ms = replayed_ms(
                    lambda: tmod.prefill(params, arch, feed, LM_MAX_SEQ))
    finally:
        ffn._moe_ep_shardmap = own_ep
    rec = {"mesh": list(EP_MESH), "moe_layers": n_moe,
           "experts_a_slot": arch.moe.n_experts // EP_MESH[1],
           "dtype": arch.dtype, "tol": tol,
           "ep_calls": {"grouped_prefill": grouped_calls,
                        "ep_prefill": prefill_calls, "layers": layer_calls},
           "layer_share_of_bound": layer,
           "logits_share_of_bound": share(le, lg),
           "k9_grouped": [[list(c), n] for c, n in k9_grouped.items()],
           "k9_ep": [[list(c), n] for c, n in k9_ep.items()],
           "grouped_device_ms": grouped_ms, "ep_device_ms": ep_ms}
    bad = []
    if grouped_calls or prefill_calls != n_moe or layer_calls != n_moe \
            or not n_moe:
        bad.append(f"EP calls {rec['ep_calls']} for {n_moe} MoE layers")
    if not (max(layer) <= 1.0 and rec["logits_share_of_bound"] <= 1.0
            and bool(torch.isfinite(le).all())):
        bad.append("EP output over the bound of the grouped path's")
    if k9_ep != k9_grouped:
        bad.append("K9's launches differ")
    if bad:
        raise AssertionError(f"[ep] {name} {arch.dtype}: {bad}: {rec}")
    log("ep", f"{name} ({arch.n_layers} layers, {arch.dtype}) prefill "
        f"{LM_SLOTS}x{LM_PROMPT} under a {EP_MESH} mesh on one card "
        f"({rec['experts_a_slot']} experts a slot): the EP region at all "
        f"{n_moe} MoE layers, none without the mesh; each MoE layer within "
        f"{max(layer):.3f} of the bound ({tol} x max|output|) of the "
        f"grouped path's from the same input, the logits (grouped routing "
        f"forced) within {rec['logits_share_of_bound']:.3f}; K9 launches "
        f"{json.dumps(rec['k9_ep'])} on both; device ms: grouped "
        f"{grouped_ms:.3f}, expert-parallel {ep_ms:.3f}  [{card}]")
    return rec, ({} if f32 else k9_ep)


def serve_arch(torch, np, dev, record, card, name, n_layers, n_params,
               prompt, max_seq, cases):
    """Phase 3 for an LM family after Phi-4-mini (``LM_ARCHS``): ``name``
    at full width (``n_layers`` of its layers, or all), bf16, random
    weights from SEED, through ServingEngine(batch_slots=LM_SLOTS): the
    drawn parameters counted; K9's launches over engine.run, counted by
    shape at the launch, one a layer (an encoder's at its shape) and
    prefill on each of ``cases`` and on no other shape (none where the
    arch's attention is windowed or absent); every request complete,
    admission quiescent.  Where K9 runs, per batch, the kernel path
    against the plain path (kernel mode off) on the engine's feed and,
    for the VLM and the encoder-decoder, on seeded patches or frames.
    Both paths' MoE routing is read layer by layer as each prefill runs
    (``moe_routing``): a token whose k-th and (k+1)-th router
    probabilities lie within the two attention routes' bf16 difference
    routes apart, which moves its row by far more than the bound, so the
    rows routed apart are left out of the row checks.  Each of these
    fails the run:

    * the prefill logits of the rows whose routing agrees within
      LM_REL_TOL x max|logit| of the plain path's (the whole-model
      bound), on every feed but those of WHOLE_BOUND_WAIVED;
    * a layer, from the plain path's input to it and its routing, over
      LM_REL_TOL x max|output| from the plain layer (``dense_walk``'s
      ``hold``);
    * every row's logits, the plain path's routing forced on both paths,
      further than FORCED_LIMIT times the plain path's distance from an
      f32 walk of the same weights; on the engine feed's first batch each
      of PLANTS, a fault planted in the kernel path's attention, read
      against that limit, and one of PLANTS_CAUGHT not past it;
    * a first token (served, or the seeded feed's) other than the plain
      path's on an agreeing row whose top-2 margin exceeds the bound.

    For the MoE families, then ``ep_prefills`` on the first batch.  Then
    ``time_lm``.  Returns the main path's launches (the engine's and the
    EP prefill's) and K9's launches by case."""
    import dataclasses
    import gc

    import torch.utils._pytree as pytree

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import flash_route
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as tmod
    from repro_torch.models.accounting import weight_bytes
    from repro_torch.runtime.serving import Request, ServingEngine
    t_arch = time.perf_counter()
    gc.collect()                  # the earlier LM phases' weights go first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    arch = get_arch(name)
    if n_layers:
        log("slice", f"{name} reduced: n_layers {arch.n_layers} → "
            f"{n_layers} ({weight_bytes(arch) / 1e9:.1f} GB of bf16 "
            f"weights; one card holds 80 GB)")
        arch = dataclasses.replace(arch, n_layers=n_layers)
    mla = arch.mla
    hd, hd_v, kv = ((mla.qk_nope_head_dim + mla.qk_rope_head_dim,
                     mla.v_head_dim, arch.n_heads) if mla else
                    (arch.resolved_head_dim, arch.resolved_head_dim,
                     arch.n_kv_heads))
    for case, part in cases:
        want = (LM_SLOTS, arch.n_heads, kv,
                arch.n_frames if part == "enc" else prompt, hd, hd_v,
                part == "dec")
        if tuple(case[:7]) != want:
            raise AssertionError(f"{name}: K9 shape {case} is not the "
                                 f"arch's {part} shape {want}")
    t0 = time.perf_counter()
    params = tmod.init_params(torch.Generator(device=dev).manual_seed(SEED),
                              arch, dev)
    torch.cuda.synchronize()
    count = sum(t.numel() for t in pytree.tree_leaves(params))
    if count != n_params:
        raise AssertionError(f"{name}: {count:,} params != {n_params:,}")
    rec = {"arch": name, "n_layers": arch.n_layers, "params": count,
           "weight_bytes": sum(t.numel() * t.element_size()
                               for t in pytree.tree_leaves(params)),
           "prompt": prompt, "max_seq": max_seq,
           "route": flash_route(torch.bfloat16, hd, hd_v) if cases else None,
           "init_s": time.perf_counter() - t0,
           "init_peak_bytes": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, arch.vocab_size, prompt).astype(np.int32)
               for _ in range(LM_REQUESTS)]
    engine = ServingEngine(params, arch, batch_slots=LM_SLOTS,
                           max_seq=max_seq, device=dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    done = engine.run([Request(i, p, max_new=LM_NEW)
                       for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    rec["first_run_s"] = time.perf_counter() - t0
    launches, by_case = dict(_build.LAUNCHES), k9_by_case()
    n_prefill = -(-LM_REQUESTS // LM_SLOTS)
    want = {case: n_prefill * (arch.n_enc_layers if part == "enc"
                               else arch.n_layers) for case, part in cases}
    if by_case != want or launches != (
            {LM_KERNEL: sum(want.values())} if cases else {}):
        raise AssertionError(f"{name}: launches {launches}, K9's by shape "
                             f"{by_case}; expected {want}")
    vp = params["embed"]["table"].shape[0]
    outs = {r.rid: r.out for r in done}
    if sorted(outs) != list(range(LM_REQUESTS)) or any(
            not r.done or len(r.out) != LM_NEW
            or not all(0 <= t < vp for t in r.out) for r in done):
        raise AssertionError(f"{name}: requests incomplete: {outs}")
    engine.admission.assert_quiescent()
    batches = [torch.from_numpy(np.stack(prompts[i:i + LM_SLOTS])).to(dev)
               for i in range(0, LM_REQUESTS, LM_SLOTS)]
    zeros = stub_inputs(torch, np, arch, LM_SLOTS, dev, seeded=False)
    feeds = {"engine": zeros}
    if zeros:
        feeds["seeded"] = stub_inputs(torch, np, arch, LM_SLOTS, dev,
                                      seeded=True)
    checks, plants = {k: [] for k in feeds}, {}
    sure = walk_equal = 0
    with torch.no_grad():
        for bi, toks in enumerate(batches):
            for kind, extra in feeds.items():
                feed = {"tokens": toks, **extra}
                with moe_routing() as rk:
                    lk, _ = tmod.prefill(params, arch, feed, max_seq)
                if not bool(torch.isfinite(lk).all()):
                    raise AssertionError(f"{name}: prefill logits not "
                                         f"finite ({kind} feed)")
                if not cases:
                    continue
                lm_layers.set_kernel_mode(False)
                try:
                    with moe_routing() as rp:
                        lp, _ = tmod.prefill(params, arch, feed, max_seq)
                finally:
                    lm_layers.set_kernel_mode(True)
                bound = LM_REL_TOL * float(lp.abs().max())
                apart = torch.zeros(LM_SLOTS, dtype=torch.bool, device=dev)
                n_apart = 0
                for a, b in zip(rk, rp):
                    tok = routed_apart(torch, arch, a, b)
                    n_apart += int(tok.sum())
                    apart |= tok.reshape(LM_SLOTS, -1).any(-1)
                agree = ~apart
                walk = functools.partial(dense_walk, torch, tmod, lm_layers,
                                         params, arch, feed)
                lw = walk(kernel=True, routes=rk)
                walk_equal += bool(torch.equal(lw, lk))
                if not float((lw - lk).abs().max()) <= bound:
                    raise AssertionError(f"{name}: dense_walk's logits "
                                         f"differ from prefill's")
                hold = []
                walk(kernel=False, routes=rp, hold=hold)
                ref = walk(kernel=False, routes=rp, f32=True)
                torch.cuda.empty_cache()  # the f32 copy of a layer goes
                scale = float(ref.abs().max())
                lkf = walk(kernel=True, routes=rp) if rk else lw
                row = (lk - lp).abs().amax(-1)
                c = {"rows_routed_apart": int(apart.sum()),
                     "token_layers_routed_apart": n_apart,
                     "kernel_vs_plain": float(row[agree].max()) / bound
                     if bool(agree.any()) else None,
                     "whole_bound_held":
                         (name, kind) not in WHOLE_BOUND_WAIVED,
                     "layer_share_of_bound": max(hold),
                     "worst_layer": hold.index(max(hold)),
                     "kernel_vs_f32": float((lkf - ref).abs().max()) / scale,
                     "plain_vs_f32": float((lp - ref).abs().max()) / scale}
                c["ratio"] = c["kernel_vs_f32"] / c["plain_vs_f32"]
                checks[kind].append(c)
                whole = c["kernel_vs_plain"] or 0.0
                if not (c["layer_share_of_bound"] <= 1.0
                        and c["ratio"] <= FORCED_LIMIT
                        and (whole <= 1.0 or not c["whole_bound_held"])):
                    raise AssertionError(
                        f"{name}: the kernel path against the plain path "
                        f"({kind} feed, batch {bi}): {c}; the agreeing rows' "
                        f"logits (kernel_vs_plain, where held) and each "
                        f"layer must lie within the bound (share <= 1), and "
                        f"the logits at most FORCED_LIMIT = {FORCED_LIMIT} "
                        f"times the plain path's distance from the f32 walk")
                if bi == 0 and kind == "engine":
                    for plant in PLANTS:
                        e = float((walk(kernel=True, routes=rp, plant=plant)
                                   - ref).abs().max()) / scale
                        plants[plant] = e / c["plain_vs_f32"]
                    missed = [p for p in PLANTS_CAUGHT
                              if not plants[p] > FORCED_LIMIT]
                    if missed:
                        raise AssertionError(
                            f"{name}: the f32-walk check misses the planted "
                            f"faults {missed} (readings {plants}, limit "
                            f"{FORCED_LIMIT})")
                top2 = lp.topk(2, dim=-1).values
                margin_ok = (((top2[:, 0] - top2[:, 1]) > bound)
                             & agree).tolist()
                first = lp.argmax(-1).tolist()
                got = ([outs[bi * LM_SLOTS + i][0] for i in range(LM_SLOTS)]
                       if kind == "engine" else lk.argmax(-1).tolist())
                for i, ok in enumerate(margin_ok):
                    if ok and got[i] != first[i]:
                        raise AssertionError(
                            f"{name}: row {bi * LM_SLOTS + i} first token "
                            f"{got[i]} != the plain path's {first[i]} "
                            f"({kind} feed)")
                    sure += ok
    rec.update(launches=launches, k9_by_case=[[list(c), n] for c, n in
                                              by_case.items()],
               first_token_checked=sure, forced_limit=FORCED_LIMIT,
               checks={k: v for k, v in checks.items() if v},
               planted_ratio={str(p): r for p, r in plants.items()},
               walk_equals_prefill=walk_equal,
               serve_peak_bytes=torch.cuda.max_memory_allocated())
    # the main path's launches: the engine's, and the EP prefill's
    path_launches, path_by_case = dict(launches), dict(by_case)
    if arch.moe is not None:
        rec["ep"], ep_k9 = ep_prefills(torch, dev, params, arch, batches[0],
                                       name, card)
        for case, n in ep_k9.items():
            path_by_case[case] = path_by_case.get(case, 0) + n
            path_launches[LM_KERNEL] += n
    st = {"params": params, "arch": arch, "engine": engine,
          "prompts": prompts, "batches": batches, "prompt": prompt,
          "max_seq": max_seq, "extra": zeros,
          "reps": (1, 2) if prompt > LM_PROMPT else (2, 4)}
    torch.cuda.reset_peak_memory_stats()
    time_lm(torch, st, card, rec, name)
    rec["time_peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["seconds"] = time.perf_counter() - t_arch

    def joined(v, key, fmt):
        return ", ".join("-" if c[key] is None else format(c[key], fmt)
                         for c in v)
    held = "; ".join(
        f"on the {k} feed"
        + (f" routing apart in {joined(v, 'rows_routed_apart', 'd')} of "
           f"{LM_SLOTS} rows a batch ({joined(v, 'token_layers_routed_apart', 'd')}"
           f" token-layers)," if arch.moe else "")
        + f" the agreeing rows' logits within "
        f"{joined(v, 'kernel_vs_plain', '.3f')} of the bound of the plain "
        f"path's ({'held' if v[0]['whole_bound_held'] else 'not held: WHOLE_BOUND_WAIVED'}),"
        f" each layer within "
        f"{max(c['layer_share_of_bound'] for c in v):.3f} of the bound of "
        f"the plain layer's output from one input, the logits "
        f"{joined(v, 'kernel_vs_f32', '.4g')} of max|logit| from the f32 "
        f"walk against the plain path's {joined(v, 'plain_vs_f32', '.4g')} "
        f"(ratio up to {max(c['ratio'] for c in v):.3f}, limit "
        f"{FORCED_LIMIT})" for k, v in checks.items() if v)
    if plants:
        held += (f"; planted faults (attention output x (1 + p)), ratio "
                 f"to the plain path's distance: "
                 f"{json.dumps({str(p): round(r, 3) for p, r in plants.items()})}"
                 f"; the walk bit-identical to prefill in {walk_equal} of "
                 f"{len(batches) * len(feeds)} prefills")
    log("slice", f"{name} ({'full width, ' + str(arch.n_layers) + ' layers' if n_layers else 'full width and depth'}, "
        f"{count:,} params, {rec['weight_bytes'] / 1e9:.2f} GB, bf16): "
        f"{LM_REQUESTS} requests of {prompt} tokens x {LM_NEW} new served "
        f"with {LM_SLOTS} slots (max_seq {max_seq}), launches "
        f"{json.dumps(launches)}"
        + (f" on the {rec['route']} route (by shape at the launch: {', '.join(f'{p} {by_case.get(c, 0)}' for c, p in cases)}); {held}; first token equal on the {sure} rows whose top-2 margin exceeds the bound" if cases else
           " (no kernel on this arch's path: its attention is windowed or absent, as in the JAX package)")
        + f"; engine.run {rec['tokens_per_s']:.1f} tokens/s; peak device "
        f"memory {rec['init_peak_bytes'] / 1e9:.2f} GB at init, "
        f"{rec['serve_peak_bytes'] / 1e9:.2f} serving, "
        f"{rec['time_peak_bytes'] / 1e9:.2f} timed; {rec['seconds']:.1f} s "
        f"in all  [{card}]")
    record.setdefault("archs", {})[name] = rec
    del st, params, engine
    gc.collect()
    torch.cuda.empty_cache()
    return path_launches, path_by_case


def lm_f32(torch, np, dev, record, card, name, n_layers, S, change):
    """The f32 checks of ``LM_F32``: ``name`` in f32 at full width
    (``n_layers`` of its layers, or all; ``change`` to the config), random
    weights from SEED, TF32 off, each check failing the run past
    F32_REL_TOL x max|logit|:

    * an MoE arch: its first LM_SLOTS prompts prefilled with kernel mode
      on (K9's f32 route) and off, the rows whose routing agrees in every
      layer, and every row with the kernel path's routing forced on the
      plain path; then ``ep_prefills`` on the same prompts in f32;
    * with ``S``: batch 2 of seeded tokens (and frames or patches),
      teacher-forced ``prefill`` of S tokens and one ``decode_step``
      against ``forward`` on S + 1; for F32_HOST_ARCHS, row 0 of both
      also against the same port on the host CPU."""
    import dataclasses
    import gc

    import torch.utils._pytree as pytree

    from repro_torch.configs import get_arch
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as tmod
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    arch = dataclasses.replace(get_arch(name), dtype="float32", **change)
    if n_layers:
        arch = dataclasses.replace(arch, n_layers=n_layers)
    params = tmod.init_params(torch.Generator(device=dev).manual_seed(SEED),
                              arch, dev)
    rec = {"arch": name, "n_layers": arch.n_layers, "S": S,
           "change": change,
           "params": sum(t.numel() for t in pytree.tree_leaves(params))}
    said, outs = [], []

    def share(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())
    with torch.no_grad():
        if arch.moe:
            rng = np.random.default_rng(SEED)
            feed = {"tokens": torch.from_numpy(np.stack([
                rng.integers(0, arch.vocab_size, LM_PROMPT).astype(np.int32)
                for _ in range(LM_SLOTS)])).to(dev)}
            with moe_routing() as rk:
                lk, _ = tmod.prefill(params, arch, feed, LM_MAX_SEQ)
            lm_layers.set_kernel_mode(False)
            try:
                with moe_routing() as rp:
                    lp, _ = tmod.prefill(params, arch, feed, LM_MAX_SEQ)
                with moe_routing(rk):
                    lf, _ = tmod.prefill(params, arch, feed, LM_MAX_SEQ)
            finally:
                lm_layers.set_kernel_mode(True)
            apart = torch.zeros(LM_SLOTS, dtype=torch.bool, device=dev)
            n_apart = 0
            for a, b in zip(rk, rp):
                tok = routed_apart(torch, arch, a, b)
                n_apart += int(tok.sum())
                apart |= tok.reshape(LM_SLOTS, -1).any(-1)
            row = ((lk - lp).abs().amax(-1) / float(lp.abs().max())).tolist()
            agree = [r for r, a in zip(row, apart.tolist()) if not a]
            rec.update(rows_routed_apart=int(apart.sum()),
                       token_layers_routed_apart=n_apart,
                       row_logit_diff_share=row,
                       agreeing_rows_kernel_vs_plain=max(agree, default=0.0),
                       forced_kernel_vs_plain=share(lk, lf))
            outs.append(lk)
            rec["ep"], _ = ep_prefills(torch, dev, params, arch,
                                       feed["tokens"], name, card, f32=True)
            said.append(
                f"kernel against plain path, {LM_SLOTS}x{LM_PROMPT} "
                f"prefill: routing apart in {rec['rows_routed_apart']} of "
                f"{LM_SLOTS} rows ({n_apart} token-layers); logits of the "
                f"rows that agree within "
                f"{rec['agreeing_rows_kernel_vs_plain']:.3g} of max|logit|, "
                f"every row within {rec['forced_kernel_vs_plain']:.3g} with "
                f"the kernel path's routing forced")
        if S:
            toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
                0, arch.vocab_size, (2, S + 1)).astype(np.int64)).to(dev)
            extra = stub_inputs(torch, np, arch, 2, dev, seeded=True)

            def serve(p, rows, where):
                feed = {"tokens": toks[rows, :S].to(where),
                        **{k: v[rows].to(where) for k, v in extra.items()}}
                lp, cache = tmod.prefill(p, arch, feed, S + 8)
                ld, _ = tmod.decode_step(p, arch, cache,
                                         toks[rows, S:S + 1].to(where), S)
                return lp, ld
            hidden, _ = tmod.forward(params, arch, {"tokens": toks, **extra})
            ref_pre, ref_dec = (tmod.logits_from_hidden(params, arch,
                                                        hidden[:, i])
                                for i in (S - 1, S))
            lp, ld = serve(params, slice(None), dev)
            outs += [lp, ld]
            rec.update(prefill_vs_forward=share(lp, ref_pre),
                       decode_vs_forward=share(ld, ref_dec),
                       decode_token_equal=bool(torch.equal(
                           ld.argmax(-1), ref_dec.argmax(-1))))
            said.append(
                f"prefill of {S} tokens within "
                f"{rec['prefill_vs_forward']:.3g} of max|logit| of forward "
                f"on {S + 1}, the decode step within "
                f"{rec['decode_vs_forward']:.3g} (greedy token "
                f"{'equal' if rec['decode_token_equal'] else 'apart'})")
            if name in F32_HOST_ARCHS:
                host = pytree.tree_map(lambda t: t.cpu(), params)
                hp, hd = serve(host, slice(0, 1), "cpu")
                rec["prefill_vs_host"] = share(lp[:1].cpu(), hp)
                rec["decode_vs_host"] = share(ld[:1].cpu(), hd)
                del host
                said.append(f"against the host CPU, row 0: prefill "
                            f"{rec['prefill_vs_host']:.3g}, decode "
                            f"{rec['decode_vs_host']:.3g}")
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["seconds"] = time.perf_counter() - t0
    record.setdefault("lm_f32", {})[name] = rec
    bad = [k for k in ("agreeing_rows_kernel_vs_plain",
                       "forced_kernel_vs_plain", "prefill_vs_forward",
                       "decode_vs_forward", "prefill_vs_host",
                       "decode_vs_host")
           if not rec.get(k, 0.0) <= F32_REL_TOL]
    if bad or not all(bool(torch.isfinite(t).all()) for t in outs):
        raise AssertionError(f"{name} in f32: {bad} over the bound "
                             f"{F32_REL_TOL} (of max|logit|): {rec}")
    log("slice", f"{name} in f32 (full width, {arch.n_layers} layers"
        + (f", {change}" if change else "") + f", {rec['params']:,} "
        f"params): " + "; ".join(said) + f" (bound {F32_REL_TOL}); peak "
        f"{rec['peak_bytes'] / 1e9:.2f} GB; {rec['seconds']:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_sweep(shape_applicable, arch_ids, get_arch, shapes, record):
    """The dry run's meta sweep (``python -m repro_torch.launch.dryrun``
    with no cell named, DRYRUN_JOBS processes): every arch x shape x
    {16x16, 2x16x16} counted on meta.  Fails unless it exits 0 with
    DRYRUN_SWEEP's PASS / SKIP / FAIL lines and its SKIPs are the cells
    ``shape_applicable`` refuses.  Its report and log go to the output
    directory."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh", "both",
         "--jobs", str(DRYRUN_JOBS), "--out",
         str(out_dir / "dryrun_report.json")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=DRYRUN_SWEEP_LIMIT_S)
    secs = time.perf_counter() - t0
    (out_dir / "dryrun_sweep.log").write_text(proc.stdout + proc.stderr)
    lines = proc.stdout.splitlines()
    got = {k: sum(line.startswith(k + " ") for line in lines)
           for k in DRYRUN_SWEEP}
    skipped = {line.split(":")[0].split(" ", 1)[1] for line in lines
               if line.startswith("SKIP ")}
    want_skips = {f"{a} x {s}" for a in arch_ids for s in shapes
                  if not shape_applicable(get_arch(a), shapes[s])[0]}
    record["dryrun_sweep"] = {"seconds": secs, "lines": got,
                              "processes": DRYRUN_JOBS,
                              "returncode": proc.returncode}
    log("dryrun", f"meta sweep: {got['PASS']} PASS, {got['SKIP']} SKIP, "
        f"{got['FAIL']} FAIL over {len(arch_ids)} archs x {len(shapes)} "
        f"shapes x 2 meshes in {secs:.1f} s ({DRYRUN_JOBS} processes)")
    if proc.returncode != 0 or got != DRYRUN_SWEEP or skipped != want_skips:
        raise AssertionError(
            f"the dry run's meta sweep: exit {proc.returncode}, {got} "
            f"(want {DRYRUN_SWEEP}), skips {sorted(skipped ^ want_skips)} "
            f"differ; the tail of its output:\n{proc.stdout[-2000:]}"
            f"{proc.stderr[-2000:]}")


def dryrun_cells(torch, dev, record, card):
    """Phi-4-mini's dry-run cells on the card (DRYRUN_CELLS), at full width
    and depth on the (1, 1) local mesh, random weights from SEED.  For
    each: (a) the placement plan's note is DRYRUN_NOTE (dp = 1); (b) with
    kernel mode off the step's count taken on the card equals the same
    cell's count on meta, FLOPs and bytes bit for bit: at full depth on
    both and equal to the meta sweep's count (extrapolated from the first
    layers) for DRYRUN_FULL_OFF, from the first layers on both for the
    others (the blockwise route's Python loops at 32k take minutes at
    full depth under the counter); (c) with kernel mode on one step at
    full depth on the card launches DRYRUN_LAUNCHES, its count holds
    their charges and equals the count on meta extrapolated from the
    first layers; (d) the warm step time by CUDA events is at least
    the kernel-mode count's t_bound; (e) the peak device memory is at
    least the cell's per-device argument bytes.  Returns the launches of
    the kernel-mode counted steps, in all and per kernel by shape."""
    import dataclasses
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as tmod
    from repro_torch.roofline import analysis
    from repro_torch.roofline.op_cost import Cost, counting
    gc.collect()
    torch.cuda.empty_cache()
    arch = get_arch(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = tmod.init_params(gen, arch, dev)
    mesh = make_local_mesh()
    if mesh.devices.shape != (1, 1):
        raise AssertionError(f"the local mesh is {mesh.devices.shape}, not "
                             f"one card")
    rows, launches, by_case = {}, {}, {}
    try:
        for shape_id, batch in DRYRUN_CELLS:
            shape = dataclasses.replace(SHAPES[shape_id], global_batch=batch)
            name = f"{LM_ARCH} x {shape_id} (batch {batch})"
            # (b) kernel mode off: the card's count and meta's, at full
            # depth or each from the first layers (the card runs the
            # shallow steps for real)
            lm_layers.set_kernel_mode(False)
            full = shape_id in DRYRUN_FULL_OFF
            t0 = time.perf_counter()
            if full:
                off_card = dryrun.step_cost(arch, shape, params=params,
                                            device=dev)
            else:
                off_card = dryrun.extrapolated_cost(arch, shape, device=dev)
            count_s = time.perf_counter() - t0
            off_meta = [dryrun.extrapolated_cost(arch, shape)]
            if full:
                off_meta.append(dryrun.step_cost(arch, shape))
            if any(off_card != c for c in off_meta):
                raise AssertionError(f"{name}, kernel mode off: the card's "
                                     f"count {off_card} differs from meta's "
                                     f"{off_meta}")
            gc.collect()
            torch.cuda.empty_cache()
            # (c) kernel mode on: one counted step, its launches and charges
            lm_layers.set_kernel_mode(True)
            torch.cuda.reset_peak_memory_stats()
            step, state = dryrun.make_step(arch, shape, params, device=dev,
                                           gen=gen)
            charged = Cost()

            def charge(flops, nbytes, mm):
                nonlocal charged
                charged += Cost(flops, nbytes, nbytes, mm)
            _build.add_charge_sink(charge)
            _build.reset_launches()
            try:
                with counting() as c:
                    step()
                torch.cuda.synchronize()
            finally:
                _build.remove_charge_sink(charge)
            got = {k: v for k, v in _build.LAUNCHES.items() if v}
            for k in got:
                for case, n in k9_by_case(k).items():
                    by_case.setdefault(k, {})[case] = \
                        by_case.get(k, {}).get(case, 0) + n
            on_meta = dryrun.extrapolated_cost(arch, shape)
            if got != DRYRUN_LAUNCHES[shape.kind]:
                raise AssertionError(f"{name}: launches {got}, want "
                                     f"{DRYRUN_LAUNCHES[shape.kind]}")
            if c.cost != on_meta:
                raise AssertionError(f"{name}, kernel mode on: the card's "
                                     f"count {c.cost} differs from meta's "
                                     f"{on_meta}")
            if bool(got) != bool(charged.flops) or \
                    c.cost.flops < charged.flops or \
                    c.cost.bytes < charged.bytes:
                raise AssertionError(f"{name}: the count {c.cost} does not "
                                     f"hold the kernels' charges {charged}")
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            # (a) and the cell's per-device argument bytes
            info = dryrun.lower_cell(arch, shape, mesh, params=params,
                                     count=c.cost)
            if info["plan"] != DRYRUN_NOTE:
                raise AssertionError(f"{name}: plan {info['plan']!r}, want "
                                     f"{DRYRUN_NOTE!r}")
            roof = analysis.analyze(
                arch=LM_ARCH, shape=shape_id, mesh_name="1x1", chips=1,
                model_flops=info["model_flops"],
                global_flops=c.cost.flops, global_bytes=c.cost.bytes,
                bytes_per_device=info["arg_bytes"]["total"])
            # (d) the warm step time against the bound
            step()
            times = [event_ms(torch, step, 1) for _ in range(DRYRUN_TIMED)]
            ms = statistics.median(times)
            peak = torch.cuda.max_memory_allocated()
            args = info["arg_bytes"]["total"]
            share = info["model_flops"] / (ms / 1e3 * BF16_FLOPS_PER_S)
            row = {"batch": batch, "seq_len": shape.seq_len,
                   "count_off": off_card.as_dict(),
                   "count_off_depth": "full" if full else "first layers",
                   "count_on": c.cost.as_dict(), "charged": charged.as_dict(),
                   "launches": got, "plan": info["plan"],
                   "t_compute_ms": roof.t_compute * 1e3,
                   "t_memory_ms": roof.t_memory * 1e3,
                   "t_bound_ms": roof.t_bound * 1e3,
                   "dominant": roof.dominant, "ms": ms, "runs_ms": times,
                   "over_bound": ms / (roof.t_bound * 1e3),
                   "model_flops": info["model_flops"],
                   "model_flop_share": share,
                   "mfu_at_bound": roof.mfu_at_bound,
                   "peak_bytes": peak, "arg_bytes": info["arg_bytes"],
                   "peak_over_args": peak / args,
                   "card_count_s": count_s}
            rows[shape_id] = row
            log("dryrun", f"{name}: (a) plan {info['plan']!r}; (b) count "
                f"off on the card = meta "
                f"({'full depth' if full else 'first layers'}): "
                f"{off_card.flops:.6e} FLOPs, "
                f"{off_card.bytes:.6e} bytes ({count_s:.1f} s counting); "
                f"(c) launches {got}, count on (full depth on the card = "
                f"meta) {c.cost.flops:.6e} FLOPs "
                f"{c.cost.bytes:.6e} bytes with {charged.flops:.6e} FLOPs "
                f"{charged.bytes:.6e} bytes charged; (d) {ms:.3f} ms a warm "
                f"step (median of {DRYRUN_TIMED}), t_compute "
                f"{roof.t_compute * 1e3:.3f} ms, t_memory "
                f"{roof.t_memory * 1e3:.3f} ms -> {roof.dominant}-bound, "
                f"measured / t_bound {row['over_bound']:.3f}, model-FLOP "
                f"share {share:.4f}; (e) peak {peak / 1e9:.3f} GB / "
                f"arguments {args / 1e9:.3f} GB = {peak / args:.3f}  "
                f"[{card}]")
            if row["over_bound"] < 1.0:
                raise AssertionError(f"{name}: {ms:.3f} ms under the bound "
                                     f"{roof.t_bound * 1e3:.3f} ms: the "
                                     f"count misses work")
            if peak < args:
                raise AssertionError(f"{name}: peak {peak} bytes under the "
                                     f"arguments' {args}")
            del step, state
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        lm_layers.set_kernel_mode(True)
        lm_layers.set_mesh_axis_sizes({})
    record["dryrun_cells"] = rows
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, by_case


def start_tuning(compile, get_cnn, target):
    """``compile(cfg, target, autotune=True)`` for each net of ``TUNED``
    in a thread of its own (the search is host work, so it runs beside
    the kernels' build).  Returns a function that joins the thread and
    gives {net: (pipeline, wall seconds, the thread's CPU seconds)}, or
    raises what the thread raised."""
    out, errors = {}, []

    def work():
        try:
            for name in TUNED:
                t, cpu = time.perf_counter(), time.thread_time()
                cp = compile(get_cnn(name), target, autotune=True)
                out[name] = (cp, time.perf_counter() - t,
                             time.thread_time() - cpu)
        except BaseException as e:            # re-raised by the join
            errors.append(e)

    thread = threading.Thread(target=work, daemon=True, name="autotune")
    thread.start()

    def join():
        thread.join()
        if errors:
            raise errors[0]
        return out
    return join


def check_tuned(tuned, record):
    """Each tuned pipeline against ``TUNED``: the streamed set, the
    knobs and the serving credits the search must have picked; logs each
    ``summary()`` and the search's host seconds."""
    rows = {}
    for name, (cp, wall, cpu) in tuned.items():
        want, cand = TUNED[name], cp.tuning.candidate
        got = {"streamed": tuple(sorted(cp.streamed_names)),
               "burst": cand.burst, "bm_words": cand.bm_words,
               "laststage": cand.laststage,
               "credits": cp.tuning.serving_credits}
        for key, value in got.items():
            if value != want[key]:
                raise AssertionError(f"autotune {name}: {key} {value} != "
                                     f"{want[key]}")
        if cp.tuning.search != type(cp.tuning.search)() or cp.replaced:
            raise AssertionError(f"autotune {name}: {cp.tuning.search}, "
                                 f"replaced {cp.replaced}")
        summary = cp.tuning.summary()
        rows[name] = {"summary": summary, "search_wall_s": wall,
                      "search_cpu_s": cpu, "streamed": got["streamed"],
                      "scan_table": cp.scan_table()}
        log("autotune", f"{name}: search {wall:.1f} s on the host "
            f"({cpu:.1f} s of the thread's CPU, beside the build); "
            f"{len(got['streamed'])} layers streamed "
            f"{list(got['streamed'])}; burst {cand.burst}, bm_words "
            f"{cand.bm_words}, laststage {cand.laststage}, credits "
            f"{got['credits']}; scan groups {json.dumps(cp.scan_table())}"
            f"; summary {json.dumps(summary)}")
    record["autotune"] = rows


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


def graph_ms(torch, comp, params, shape, dev):
    """Device ms of one replay of the forward's graph for BATCH images of
    ``shape`` (the trace the serving engines replay)."""
    trace = comp.fused_trace(params, torch.zeros(
        (BATCH,) + shape, dtype=torch.int8, device=dev), act_scale=0.05)
    trace.fn.graph.replay()
    return event_ms(torch, trace.fn.graph.replay, 20) / 20


def seeded_requests(np, shape, n):
    """``n`` requests of 1 to BATCH images of ``shape`` (the sizes, then
    the images, drawn from SEED), and the generator, to draw more."""
    rng = np.random.default_rng(SEED)
    sizes = [int(k) for k in rng.integers(1, BATCH + 1, n)]
    return rng, [rng.integers(-127, 128, size=(k,) + shape, dtype=np.int8)
                 for k in sizes]


def serve_cnn(torch, np, name, comp, params, per_forward, dev, record, *,
              credits=SERVE_CREDITS, key="serving", steady=True):
    """A net served over the fused backend (``cp.serve``), then, with
    ``steady``, a longer interval and the adaptive ladder at light load:
    every request's logits bit-identical to the eager ``run()`` of its
    images on the card, the credit bound held, one warm trace for the
    fixed shape, the Eq. 2 words of the images, and microbatches x one
    forward's launches.  ``credits=None`` serves at the engine's default,
    which must be the tuned bound of an autotuned pipeline.  Records the
    report, the host spans of a traced interval, and the ceiling of BATCH
    images a graph replay of the forward, under ``record[key]``."""
    from repro_torch.kernels import _build
    from repro_torch.models.cnn import cnn_input_shape
    from repro_torch.obs import Tracer
    from repro_torch.runtime.pipeline import PipelineExecutor
    shape = cnn_input_shape(comp.cfg, 1)[1:]
    rng, reqs = seeded_requests(np, shape, SERVE_REQUESTS)
    eager = PipelineExecutor(comp, device=dev, backend="eager")

    def check(got, req, what):
        want = eager.run(params, torch.from_numpy(req).to(dev))[0].cpu()
        if not np.array_equal(got, want.numpy()):
            raise AssertionError(f"serving: {what} differs from the eager "
                                 f"run of its {len(req)} images")

    tracer = Tracer()
    handles = [None] * len(reqs)
    _build.reset_launches()
    kw = {} if credits is None else {"credits": credits}
    with comp.serve(params, microbatch=BATCH, tracer=tracer, **kw) as eng:
        bound = eng.admission.capacity
        if credits is None and bound != comp.tuning.serving_credits:
            raise AssertionError(f"serving: {bound} credits, not the tuned "
                                 f"{comp.tuning.serving_credits}")

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
    if eng.admission.max_in_flight_seen > bound:
        raise AssertionError(f"serving: {eng.admission.max_in_flight_seen} "
                             f"microbatches in flight > {bound}")
    if comp.trace_count != 1:
        raise AssertionError(f"serving: {comp.trace_cache_stats()}")
    if rep.images != sum(map(len, reqs)) or rep.requests != len(reqs) \
            or rep.hbm_words_useful != rep.images * eng.words_per_image:
        raise AssertionError(f"serving: report {rep.images} images, "
                             f"{rep.hbm_words_useful} useful words")
    want = {k: v * rep.microbatches for k, v in per_forward.items()}
    if served != want:
        raise AssertionError(f"serving: launches {served} != {want}")
    for i, (h, req) in enumerate(zip(handles, reqs)):
        check(h.result(), req, f"request {i}")
    # the ceiling: BATCH images a replay of the forward's graph
    replay_ms = graph_ms(torch, comp, params, shape, dev)
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
           "device_ms_per_microbatch": replay_ms,
           "ceiling_images_per_s": BATCH / replay_ms * 1e3,
           "host_span_ms": spans, "launches": served,
           "first_spans_ms": {k: v[:5] for k, v in durs.items()},
           "tracer_dropped": tracer.dropped, "credits": bound}
    row["report"].pop("request_rows")
    record[key] = row
    log("serve", f"{name}: {len(reqs)} requests, {rep.images} images in "
        f"{rep.microbatches} microbatches of {BATCH} from "
        f"{SERVE_PRODUCERS} producers, bit-identical to the eager run() of "
        f"each; in flight <= {eng.admission.max_in_flight_seen}/"
        f"{bound}{' (the tuned default)' if credits is None else ''}; "
        f"{rep.images_per_s:.1f} images/s against a "
        f"ceiling of {row['ceiling_images_per_s']:.1f} ({BATCH} / "
        f"{replay_ms:.4f} device ms); latency p50 {rep.p50_ms:.2f} p95 "
        f"{rep.p95_ms:.2f} p99 {rep.p99_ms:.2f} ms; pad {rep.pad_fraction:.3f}"
        f"; admission wait {be['admission_wait_fraction']:.3f}, dispatch gap "
        f"{be['dispatch_gap_fraction']:.3f} of the wall ({rep.wall_s * 1e3:.1f}"
        f" ms); host spans (n, total / median / max ms): " + "; ".join(
            f"{k} {v['n']}, {v['total_ms']:.2f} / {v['median_ms']:.3f} / "
            f"{v['max_ms']:.3f}" for k, v in spans.items())
        + f"  [{record['card']}]")
    if not steady:
        return

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
    log("serve", f"{name} steady: the same requests x "
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
    log("serve", f"{name} adaptive (ladder {eng.microbatch_ladder}): "
        f"{len(singles)} closed-loop requests then a burst of 16, "
        f"bit-identical; shapes used (rows: dispatches) "
        f"{json.dumps(arep.microbatch_shapes)}; trace cache "
        f"{json.dumps(arep.trace_cache)}; pad {arep.pad_fraction:.3f}")


def serve_sharded(torch, np, name, comp, params, per_forward, dev, record,
                  stages, n_requests):
    """A net cut into S stages for each S in ``stages`` and served by
    ``comp.serve_sharded`` on one card, one stream a stage: the
    partition's ``describe()`` and modelled throughput (the FPGA cycle
    model), per-stage Eq. 2 verified and summing to SHARDED_WORDS; each
    stage graph's launches summing to one forward's (``per_forward``) and
    its device ms; a round's device span beside the sum of its stage
    times (whether the stage streams overlap on the die); then the
    requests from SERVE_PRODUCERS threads round-robin, again with
    explicit ``shard=`` routing, and SERVE_STEADY_REPEATS times over from
    this thread: every request bit-identical to the eager ``run()`` of
    its images, the credit bound held and quiescent,
    launches (microbatches + empty slots) x the stage graphs'.  Returns
    the launches of the served intervals, counted from zero just before
    each and read just after."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models.cnn import cnn_input_shape
    from repro_torch.runtime.pipeline import PipelineExecutor
    shape = tuple(cnn_input_shape(comp.cfg, 1)[1:])
    _, reqs = seeded_requests(np, shape, n_requests)
    eager = PipelineExecutor(comp, device=dev, backend="eager")
    want = [eager.run(params, torch.from_numpy(r).to(dev))[0].cpu().numpy()
            for r in reqs]
    words = sum(comp.plan.hbm_words_per_image().values())
    if words != SHARDED_WORDS[name]:
        raise AssertionError(f"sharded {name}: {words} words per image")
    ceiling = BATCH / graph_ms(torch, comp, params, shape, dev) * 1e3
    single = record["serving"] if name == SERVE_NET else None
    rows, launches = {}, {}
    for S in stages:
        part = comp.partition(S)
        M = 8 * S
        modelled = part.modelled_throughput(M)
        part.verify_eq2(batch=BATCH)
        stage_words = [sp.hbm_words_per_image for sp in part.stages]
        if sum(stage_words) != words:
            raise AssertionError(f"sharded {name}: stage words "
                                 f"{stage_words} do not sum to {words}")
        for line in part.describe().splitlines():
            log("sharded", f"{name} S={S} | {line}")
        log("sharded", f"{name} S={S}: modelled_throughput({M}) "
            + json.dumps(modelled))
        mesh = compat_make_mesh((S,), ("model",), devices=[dev] * S)
        t = time.perf_counter()
        eng = comp.serve_sharded(params, mesh=mesh, microbatch=BATCH)
        eng.start()
        start_s = time.perf_counter() - t
        handles, routed = [None] * len(reqs), []
        try:
            progs, ring = eng.stage_programs, eng._ring
            per_mb = {}
            for prog in progs:
                for k, v in prog.runner.launches.counts.items():
                    per_mb[k] = per_mb.get(k, 0) + v
            if per_mb != per_forward:
                raise AssertionError(f"sharded {name} S={S}: the stage "
                                     f"graphs launch {per_mb}, a forward "
                                     f"{per_forward}")
            if len({st.cuda_stream for st in ring.streams}) != S:
                raise AssertionError(f"sharded {name}: {S} stages share "
                                     f"streams")
            stage_ms = [event_ms(torch, p.runner.graph.replay, 20) / 20
                        for p in progs]
            # one round through the ring, forked from and joined into
            # this stream, three times back to back
            x = torch.zeros((M, BATCH) + shape, dtype=torch.int8,
                            device=dev)
            ring.run(None, x)
            span_ms = event_ms(torch, lambda: ring.run(None, x), 3) / 3
            _build.reset_launches()

            def producer(pid):
                for i in range(pid, len(reqs), SERVE_PRODUCERS):
                    handles[i] = eng.submit(reqs[i])
            threads = [threading.Thread(target=producer, args=(p,))
                       for p in range(SERVE_PRODUCERS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
                if th.is_alive():
                    raise AssertionError("sharded: a producer hung")
            eng.drain(timeout=300)
            rep = eng.report()
            routed = [eng.submit(r, shard=(S - 1 - i) % S)
                      for i, r in enumerate(reqs)]
            eng.drain(timeout=300)
            mid = eng.report()
            # the steady state: the same requests SERVE_STEADY_REPEATS
            # times over from this thread, rounds filled by the backlog
            t = time.perf_counter()
            steady_outs, total = eng.serve(reqs * SERVE_STEADY_REPEATS)
            steady_s = time.perf_counter() - t
        finally:
            eng.stop()
        torch.cuda.synchronize()
        served = dict(_build.LAUNCHES)
        for i, (h, r, w) in enumerate(zip(handles, routed, want)):
            if not (np.array_equal(h.result(), w)
                    and np.array_equal(r.result(), w)):
                raise AssertionError(f"sharded {name} S={S}: request {i} "
                                     f"differs from the eager run() of its "
                                     f"{len(w)} images")
        for i, (got, w) in enumerate(zip(steady_outs,
                                         want * SERVE_STEADY_REPEATS)):
            if not np.array_equal(got, w):
                raise AssertionError(f"sharded {name} S={S}: steady "
                                     f"request {i} differs")
        eng.admission.assert_quiescent()
        slots = total.microbatches + total.empty_microbatches
        shard_want = [len(range(k, len(reqs), S))
                      + sum(1 for i in range(len(reqs))
                            if (S - 1 - i) % S == k) for k in range(S)]
        if served != {k: v * slots for k, v in per_mb.items()}:
            raise AssertionError(f"sharded {name} S={S}: launches "
                                 f"{served} != {slots} x {per_mb}")
        n_images = sum(len(r) for r in reqs)
        if total.max_in_flight > total.credits \
                or mid.shard_requests != tuple(shard_want) \
                or total.stage_hbm_words_per_image != tuple(stage_words) \
                or total.images != (2 + SERVE_STEADY_REPEATS) * n_images \
                or total.hbm_words_useful != total.images * words:
            raise AssertionError(f"sharded {name} S={S}: report "
                                 f"{total.to_json()}")
        steady = {"images_per_s": SERVE_STEADY_REPEATS * n_images
                  / steady_s, "wall_s": steady_s,
                  "round_fill_fraction":
                      (total.microbatches - mid.microbatches)
                      / ((total.rounds - mid.rounds) * M)}
        for k, v in served.items():
            launches[k] = launches.get(k, 0) + v
        stage_sum = M * sum(stage_ms)
        row = {"stages": [stage_row(sp) for sp in part.stages],
               "modelled": modelled, "start_s": start_s,
               "stage_device_ms": stage_ms, "round_microbatches": M,
               "round_device_ms": span_ms, "round_stage_sum_ms": stage_sum,
               "overlap_x": stage_sum / span_ms,
               "images_per_s": rep.images_per_s, "p50_ms": rep.p50_ms,
               "p95_ms": rep.p95_ms, "p99_ms": rep.p99_ms,
               "round_fill_fraction": rep.round_fill_fraction,
               "rounds": rep.rounds, "microbatches": rep.microbatches,
               "empty_microbatches": rep.empty_microbatches,
               "max_in_flight": total.max_in_flight,
               "credits": total.credits, "launches": served,
               "steady": steady,
               "report": total.to_dict(), "ceiling_images_per_s": ceiling}
        row["report"].pop("request_rows")
        rows[S] = row
        log("sharded", f"{name} S={S}: {len(reqs)} requests ({rep.images} "
            f"images) from {SERVE_PRODUCERS} producers round-robin, then "
            f"again with explicit shard= routing (shard requests "
            f"{list(mid.shard_requests)}): every request bit-identical "
            f"to the eager run() of its images; {S} stage graph(s) "
            f"replayed on {S} stream(s) of one card, captured in "
            f"{start_s:.2f} s; per-stage Eq. 2 verified, words "
            f"{stage_words} = {words} a image; in flight <= "
            f"{total.max_in_flight}/{total.credits}, quiescent; launches "
            f"{sum(served.values())} = {slots} slots x "
            f"{sum(per_mb.values())}  [{record['card']}]")
        log("sharded", f"{name} S={S}: {rep.images_per_s:.1f} images/s "
            f"(round-robin pass), latency p50 {rep.p50_ms:.2f} p95 "
            f"{rep.p95_ms:.2f} p99 {rep.p99_ms:.2f} ms, round fill "
            f"{rep.round_fill_fraction:.3f} ({rep.microbatches} of "
            f"{rep.rounds} x {M}); stage graphs' device ms "
            f"{[round(v, 4) for v in stage_ms]}; a round of {M} "
            f"microbatches {span_ms:.3f} device ms against "
            f"{stage_sum:.3f} summed over its stage replays "
            f"({stage_sum / span_ms:.2f}x)"
            + ("; single engine cp.serve "
               f"{single['report']['images_per_s']:.1f} images/s"
               if single else "")
            + f"; ceiling {ceiling:.1f} images/s ({BATCH} a graph replay)"
            f"  [{record['card']}]")
        log("sharded", f"{name} S={S} steady: the same requests x "
            f"{SERVE_STEADY_REPEATS} from one thread, bit-identical: "
            f"{steady['images_per_s']:.1f} images/s ({steady_s * 1e3:.1f} "
            f"ms, host clock to the last delivery), round fill "
            f"{steady['round_fill_fraction']:.3f}; device "
            f"{span_ms / M:.4f} ms a microbatch in a full round  "
            f"[{record['card']}]")
    if 1 in rows:
        for S, row in rows.items():
            row["measured_speedup_x"] = \
                row["images_per_s"] / rows[1]["images_per_s"]
            row["steady_speedup_x"] = row["steady"]["images_per_s"] \
                / rows[1]["steady"]["images_per_s"]
            log("sharded", f"{name} S={S}: modelled speedup "
                f"{row['modelled']['sharded_speedup_x']:.3f}x (FPGA cycle "
                f"model, balance {row['modelled']['balance']:.3f}) against "
                f"a measured {row['measured_speedup_x']:.3f}x of the S=1 "
                f"ring's images/s ({row['steady_speedup_x']:.3f}x steady), "
                f"same call  [{record['card']}]")
    record.setdefault("sharded", {})[name] = rows
    return launches


def stage_row(sp):
    return {"stage": sp.stage, "layer_range": list(sp.layer_range),
            "layers": len(sp.layers), "cycles": sp.cycles,
            "hbm_words_per_image": sp.hbm_words_per_image}


def serve_frontend(torch, np, nets, params, per_forward, dev, record):
    """``MultiTenantFrontEnd`` over one engine per net of
    ``FRONTEND_TENANTS`` on the card.  Each tenant's producer thread
    submits FRONTEND_REQUESTS requests at once, so the backlog pools at
    the front door.  Every request bit-identical to the eager ``run()``
    of its images; the front end's credit bound and each engine's held,
    quiescent at stop; launches = microbatches x a forward's, per net;
    the ResNet-50 tenants' images delivered between two snapshots under
    backlog in the ratio of their weights (4:1) within
    FRONTEND_SHARE_TOL and their Jain index at least FRONTEND_MIN_JAIN;
    the deadline tenant promoted.
    Records per tenant images/s, latency percentiles and deadline misses
    beside each net's ceiling."""
    from repro_torch.core.admission import jain_fairness
    from repro_torch.kernels import _build
    from repro_torch.models.cnn import cnn_input_shape
    from repro_torch.runtime.frontend import MultiTenantFrontEnd
    from repro_torch.runtime.pipeline import PipelineExecutor
    rng = np.random.default_rng(SEED)
    net_names = sorted({net for _, net, _, _ in FRONTEND_TENANTS})
    shapes = {n: cnn_input_shape(nets[n].cfg, 1)[1:] for n in net_names}
    pools = {n: [rng.integers(-127, 128, size=(int(k),) + shapes[n],
                              dtype=np.int8)
                 for k in rng.integers(1, BATCH + 1, FRONTEND_POOL)]
             for n in net_names}
    picks = {t: rng.integers(0, FRONTEND_POOL, FRONTEND_REQUESTS)
             for t, _, _, _ in FRONTEND_TENANTS}
    net_of = {t: net for t, net, _, _ in FRONTEND_TENANTS}
    engines = {n: nets[n].serve(params[n], microbatch=BATCH,
                                queue_depth=FRONTEND_QUEUE)
               for n in net_names}
    fe = MultiTenantFrontEnd(engines, max_outstanding=FRONTEND_OUTSTANDING)
    for t, net, w, deadline in FRONTEND_TENANTS:
        fe.register_tenant(t, network=net, weight=w, deadline_ms=deadline)
    handles, errors = {}, []

    def producer(t):
        try:
            handles[t] = [fe.submit(t, pools[net_of[t]][i])
                          for i in picks[t]]
        except BaseException as e:            # re-raised below
            errors.append(e)

    heavy, light = "r50_heavy", "r50_light"
    heavy_images = sum(len(pools[net_of[heavy]][i]) for i in picks[heavy])
    _build.reset_launches()
    t0 = time.perf_counter()
    def delivered():
        fe.admission.check_invariants()
        return {r["tenant"]: r["images"] for r in fe.report().tenant_rows}

    with fe:
        threads = [threading.Thread(target=producer, args=(t,))
                   for t in net_of]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            if th.is_alive():
                raise AssertionError("frontend: a producer did not finish")
        if errors:
            raise errors[0]
        # the shares under backlog, between two snapshots taken when the
        # heavy tenant has FRONTEND_WINDOW of its images back: what the
        # scheduler forwarded while the producers started, before both
        # ResNet-50 tenants were backlogged, is delivered before the
        # first, and the light tenant is still backlogged at the second
        snaps = []
        for frac in FRONTEND_WINDOW:
            while True:
                done = delivered()
                if done[heavy] >= frac * heavy_images \
                        or time.perf_counter() - t0 > 300:
                    break
                time.sleep(0.001)
            snaps.append(done)
        first, done = snaps
        fe.drain(timeout=300)
        rep = fe.report()
        eng_reps = {n: e.report() for n, e in engines.items()}
    torch.cuda.synchronize()
    served = dict(_build.LAUNCHES)
    ctl = fe.admission
    ctl.assert_quiescent()
    if ctl.max_in_flight_seen > FRONTEND_OUTSTANDING \
            or ctl.admitted_total != len(net_of) * FRONTEND_REQUESTS:
        raise AssertionError(f"frontend: {ctl.max_in_flight_seen} in "
                             f"flight, {ctl.admitted_total} admitted")
    for n, eng in engines.items():
        eng.admission.assert_quiescent()
        if eng.admission.max_in_flight_seen > eng.admission.capacity:
            raise AssertionError(f"frontend: {n} engine over its credits")
    want = {}
    for n, per in per_forward.items():
        for k, v in per.items():
            want[k] = want.get(k, 0) + v * eng_reps[n].microbatches
    if served != want:
        raise AssertionError(f"frontend: launches {served} != {want}")
    refs = {}
    for n in net_names:
        eager = PipelineExecutor(nets[n], device=dev, backend="eager")
        refs[n] = [eager.run(params[n], torch.from_numpy(r).to(dev))[0]
                   .cpu().numpy() for r in pools[n]]
    for t, hs in handles.items():
        for j, (h, i) in enumerate(zip(hs, picks[t])):
            if not np.array_equal(h.result(), refs[net_of[t]][i]):
                raise AssertionError(f"frontend: {t} request {j} differs "
                                     f"from the eager run of its images")
    rows = {r["tenant"]: r for r in rep.tenant_rows}
    got = {t: done[t] - first[t] for t in (heavy, light)}
    ratio = got[heavy] / max(1, got[light])
    jain = jain_fairness({t: got[t] / rows[t]["weight"] for t in got})
    share = rows[heavy]["weight"] / rows[light]["weight"]
    if not abs(ratio / share - 1) <= FRONTEND_SHARE_TOL \
            or jain < FRONTEND_MIN_JAIN:
        raise AssertionError(f"frontend: heavy:light {ratio:.3f} (images "
                             f"{got[heavy]}:{got[light]} between "
                             f"snapshots {first} and {done}), Jain "
                             f"{jain:.4f}")
    mv2_sched = fe._lanes[net_of["mv2_rt"]].sched
    if rep.promotions <= 0 or mv2_sched.promotions <= 0 \
            or rows["mv2_rt"]["deadline_misses"] <= 0:
        raise AssertionError(f"frontend: promotions {rep.promotions}, "
                             f"mv2_rt misses "
                             f"{rows['mv2_rt']['deadline_misses']}")
    ceilings = {n: BATCH / graph_ms(torch, nets[n], params[n], shapes[n],
                                    dev) * 1e3 for n in net_names}
    per_net = {n: sum(r["images"] for r in rep.tenant_rows
                      if r["network"] == n) / rep.wall_s for n in net_names}
    record["frontend"] = {
        "report": rep.to_dict(), "launches": served,
        "engines": {n: {"microbatches": r.microbatches,
                        "pad_fraction": r.pad_fraction,
                        "images_per_s": r.images_per_s,
                        "max_in_flight": r.max_in_flight}
                    for n, r in eng_reps.items()},
        "backlog_snapshots": {"first": first, "second": done,
                              "ratio": ratio, "jain": jain},
        "ceiling_images_per_s": ceilings, "images_per_s_by_net": per_net,
        "max_in_flight": ctl.max_in_flight_seen}
    log("frontend", f"{rep.requests} requests, {rep.images} images from "
        f"{len(net_of)} producer threads over {len(net_names)} engines on "
        f"one card, every request bit-identical to the eager run() of its "
        f"images; front-end credits <= {ctl.max_in_flight_seen}/"
        f"{FRONTEND_OUTSTANDING}, quiescent; under backlog heavy:light "
        f"{ratio:.3f} ({got[heavy]}:{got[light]} images between snapshots "
        f"from {first[heavy]}:{first[light]}), Jain {jain:.4f}; "
        f"promotions {rep.promotions}; "
        f"{rep.images_per_s:.1f} images/s in all over "
        f"{rep.wall_s * 1e3:.1f} ms  [{record['card']}]")
    for t, r in rows.items():
        log("frontend", f"{t} ({r['network']}, weight {r['weight']}, "
            f"deadline {r['deadline_ms']} ms): {r['requests']} requests, "
            f"{r['images']} images, {r['images_per_s']:.1f} images/s, p50 "
            f"{r['p50_ms']:.2f} p95 {r['p95_ms']:.2f} p99 {r['p99_ms']:.2f} "
            f"ms, deadline misses {r['deadline_misses']}  "
            f"[{record['card']}]")
    log("frontend", "images/s per net beside its single-engine ceiling "
        "(BATCH images a graph replay): " + "; ".join(
            f"{n} {per_net[n]:.1f} / {ceilings[n]:.1f}" for n in net_names)
        + f"  [{record['card']}]")


def optin_smem_bytes(torch):
    """The card's opt-in shared memory a block, from the driver
    (``cuDeviceGetAttribute``); torch's device properties, where they
    carry it, must say the same."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    out = ctypes.POINTER(ctypes.c_int)
    cuda.cuInit.argtypes = [ctypes.c_uint]
    cuda.cuDeviceGet.argtypes = [out, ctypes.c_int]
    cuda.cuDeviceGetAttribute.argtypes = [out, ctypes.c_int, ctypes.c_int]
    for fn in (cuda.cuInit, cuda.cuDeviceGet, cuda.cuDeviceGetAttribute):
        fn.restype = ctypes.c_int
    dev, val = ctypes.c_int(), ctypes.c_int()
    for what, err in (
            ("cuInit", lambda: cuda.cuInit(0)),
            ("cuDeviceGet", lambda: cuda.cuDeviceGet(
                ctypes.byref(dev), torch.cuda.current_device())),
            ("cuDeviceGetAttribute", lambda: cuda.cuDeviceGetAttribute(
                ctypes.byref(val), CU_ATTR_SMEM_PER_BLOCK_OPTIN, dev))):
        code = err()
        if code != 0:
            raise RuntimeError(f"{what} returned CUDA error {code}")
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    torch_says = getattr(props, "shared_memory_per_block_optin", None)
    if torch_says is not None and torch_says != val.value:
        raise AssertionError(f"the driver says {val.value} B of opt-in "
                             f"shared memory a block, torch {torch_says}")
    return val.value


def h100_target(torch, nets, params, images, logits, dev, record, card):
    """The ``H100`` target on the card.  The card's opt-in shared memory a
    block read from the driver must equal ``MAX_SMEM_BYTES``, what the
    launch plans and the target's stage-5 check assume.  Each of the six
    nets compiled for ``H100`` keeps NX2100's streamed set (its largest
    plan printed).  MobileNetV1 and V3 (``H100_NETS``) compiled for
    ``H100`` run eager and fused: logits equal to the NX2100-compiled
    eager run's (itself equal to the plain path's), warm fused launches
    equal to eager's.  ``WIDE_CONV``: compiled for NX2100 its conv stays
    pinned and the launch raises the plan's ``ValueError``; compiled for
    ``H100`` stage 5 streams it, and eager and fused runs equal the
    plain path with one K2 launch a forward."""
    from repro_torch.compiler import H100, NX2100, compile
    from repro_torch.configs.cnn import CNN_CONFIGS, CNNConfig, ConvLayerSpec
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d_int8.ops import MAX_SMEM_BYTES
    from repro_torch.models.cnn import (cnn_forward, cnn_input_shape,
                                        init_cnn_params)
    out = {"optin_smem_bytes": optin_smem_bytes(torch)}
    if out["optin_smem_bytes"] != MAX_SMEM_BYTES:
        raise AssertionError(f"the card offers {out['optin_smem_bytes']} B "
                             f"of shared memory a block, the plans assume "
                             f"{MAX_SMEM_BYTES}")
    log("h100", f"the card's opt-in shared memory a block: "
        f"{out['optin_smem_bytes']} B, equal to MAX_SMEM_BYTES  [{card}]")
    largest = {}
    for name, cfg in CNN_CONFIGS.items():
        nx, h = compile(cfg, NX2100), compile(cfg, H100)
        if h.streamed_names != nx.streamed_names or h.replaced:
            raise AssertionError(f"{name}: H100 streams {h.streamed_names}, "
                                 f"NX2100 {nx.streamed_names}")
        report = h.vmem_report()
        top = max(report, key=report.get)
        largest[name] = (top, report[top], len(h.streamed_names))
    out["largest_plan"] = largest
    log("h100", "the six nets compiled for H100 keep NX2100's tiers "
        "(net: streamed layers; its largest launch plan at batch 1): "
        + "; ".join(f"{n}: {k}; {top} {b} B"
                    for n, (top, b, k) in largest.items()))
    for name in H100_NETS:
        comp = compile(CNN_CONFIGS[name], H100)
        _build.reset_launches()
        eager, rep = comp.run(params[name], images[name], device=dev,
                             backend="eager")
        torch.cuda.synchronize()
        eager_launches = dict(_build.LAUNCHES)
        first, _ = comp.run(params[name], images[name], device=dev)
        _build.reset_launches()
        fused, frep = comp.run(params[name], images[name], device=dev)
        torch.cuda.synchronize()
        fused_launches = dict(_build.LAUNCHES)
        for got, what in ((eager, "eager"), (first, "first fused"),
                          (fused, "warm fused")):
            if not torch.equal(got, logits[name]):
                raise AssertionError(f"{name}: the H100-compiled {what} "
                                     f"run's logits differ from NX2100's")
        if fused_launches != eager_launches:
            raise AssertionError(f"{name} on H100: fused launches "
                                 f"{fused_launches} != eager "
                                 f"{eager_launches}")
        rep.verify()
        frep.verify()
        out[name] = fused_launches
        log("h100", f"{name} compiled for H100: eager, first and warm "
            f"fused logits equal to the NX2100-compiled eager run's and "
            f"the plain path's; launches a forward "
            f"{json.dumps(fused_launches, sort_keys=True)}")
    cfg = CNNConfig("wide3x3", tuple(ConvLayerSpec(*row)
                                     for row in WIDE_CONV), num_classes=16)
    gen = torch.Generator().manual_seed(SEED)
    p = init_cnn_params(cfg, gen, dev)
    x = torch.randint(-127, 128, cnn_input_shape(cfg, BATCH), generator=gen,
                      dtype=torch.int8).to(dev)
    plain = cnn_forward(p, cfg, x)
    pinned = compile(cfg, NX2100)
    if pinned.streamed_names:
        raise AssertionError(f"NX2100 streams {pinned.streamed_names}")
    try:
        pinned.run(p, x, device=dev)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("the pinned wide conv launched on the card")
    if "shared memory" not in refused:
        raise AssertionError(f"the pinned wide conv failed otherwise: "
                             f"{refused}")
    streamed = compile(cfg, H100)
    if streamed.streamed_names != ("wide",) or \
            streamed.replaced != ("wide",):
        raise AssertionError(f"H100 streams {streamed.streamed_names}")
    eager, rep = streamed.run(p, x, device=dev, backend="eager")
    streamed.run(p, x, device=dev)
    _build.reset_launches()
    fused, _ = streamed.run(p, x, device=dev)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for got, what in ((eager, "eager"), (fused, "fused")):
        if not torch.equal(got, plain):
            raise AssertionError(f"the H100-compiled wide conv's {what} run "
                                 f"differs from the plain path")
    if launches.get("conv2d_int8_stream") != 1:
        raise AssertionError(f"wide conv launches {launches}")
    rep.verify()
    out["wide_conv"] = {"nx2100_refused": refused, "h100_launches": launches,
                        "h100_plan_bytes": streamed.vmem_report()["wide"]}
    log("h100", f"wide conv (3x3, 2048 -> 16, 4x64, batch {BATCH}): "
        f"compiled for NX2100 it stays pinned and its launch raises "
        f"({refused}); compiled for H100 stage 5 streams it "
        f"({streamed.vmem_report()['wide']} B a block at batch 1), eager "
        f"and fused runs bit-identical to the plain path, launches "
        f"{json.dumps(launches, sort_keys=True)}")
    record["h100"] = out


def reduced_launchers(torch, np, record, card):
    """``[reduced]`` lines: the JAX package's reduced LM configs through
    the launchers a user runs, on the card at their defaults:
    ``repro_torch.launch.serve.main(["--arch", A, "--reduced"])`` for
    every arch of REDUCED_SERVE, then ``repro_torch.launch.train.main([
    "--arch", A, "--reduced", "--steps", REDUCED_STEPS, ...])`` for every
    arch of REDUCED_TRAIN (the checkpoint into a temporary directory).
    Each run's output goes to ``reduced_<arch>_<serve|train>.txt`` in the
    output directory.  Fails unless K9-K11 launch exactly as REDUCED_SERVE
    and REDUCED_TRAIN predict by shape, and nowhere else; every served
    request gets its 8 tokens on the card; every logged training loss and
    grad norm is finite.  Returns the launches by kernel and, per kernel,
    by shape."""
    import contextlib
    import gc
    import io
    import tempfile

    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    rec, launches = {}, {}
    by_case = {k: {} for k in (LM_KERNEL,) + BWD_KERNELS}
    t_all = time.perf_counter()

    def run(what, arch, fn, args):
        _build.reset_launches()
        text = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = fn(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        text = text.getvalue()
        (out_dir / f"reduced_{arch}_{what}.txt").write_text(text)
        if rc != 0:
            raise AssertionError(f"[reduced] {what} {arch}: exit {rc}")
        got = {k: k9_by_case(k) for k in by_case}
        for k, d in got.items():
            for case, n in d.items():
                by_case[k][case] = by_case[k].get(case, 0) + n
        for k, n in _build.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + n
        rec.setdefault(arch, {})[what] = {
            "seconds": seconds, "launches": dict(_build.LAUNCHES),
            "by_shape": {k: {case_key(c): n for c, n in d.items()}
                         for k, d in got.items() if d}}
        gc.collect()
        torch.cuda.empty_cache()
        return text, got

    for arch, cases in REDUCED_SERVE.items():
        text, got = run("serve", arch, serve_launcher.main,
                        ["--arch", arch, "--reduced"])
        want = {LM_KERNEL: dict(cases), BWD_KERNELS[0]: {},
                BWD_KERNELS[1]: {}}
        if got != want:
            raise AssertionError(f"[reduced] serve {arch}: K9-K11 by shape "
                                 f"{got} != {want}")
        reqs = [line for line in text.splitlines() if line.startswith("req ")]
        if len(reqs) != 4 or any(len(json.loads(line.split(": ", 1)[1]))
                                 != 8 for line in reqs) or \
                "32 tokens in" not in text or "on cuda" not in text:
            raise AssertionError(f"[reduced] serve {arch}: {text[-600:]!r}")
        served = rec[arch]["serve"]
        log("reduced", f"launch.serve --arch {arch} --reduced on the card: "
            f"4 requests, 32 tokens in {served['seconds']:.2f} s; K9 by "
            f"shape {served['by_shape'].get(LM_KERNEL, {})}")
    with tempfile.TemporaryDirectory(prefix="reduced_ckpt_") as ckpt:
        for arch, case in REDUCED_TRAIN.items():
            text, got = run("train", arch, train_launcher.main,
                            ["--arch", arch, "--reduced", "--steps",
                             str(REDUCED_STEPS), "--ckpt", f"{ckpt}/{arch}",
                             "--ckpt-every", str(REDUCED_STEPS + 1)])
            per_step = REDUCED_STEPS * REDUCED_LAYERS
            want = ({LM_KERNEL: {case: 2 * per_step},
                     BWD_KERNELS[0]: {case: per_step},
                     BWD_KERNELS[1]: {case: per_step}} if case else
                    {k: {} for k in by_case})
            if got != want:
                raise AssertionError(f"[reduced] train {arch}: K9-K11 by "
                                     f"shape {got} != {want}")
            hist = [json.loads(line) for line in text.splitlines()
                    if line.startswith("{")]
            if not hist or hist[-1]["step"] != REDUCED_STEPS or not all(
                    np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                    for h in hist) or "on cuda" not in text:
                raise AssertionError(f"[reduced] train {arch}: "
                                     f"{text[-600:]!r}")
            rec[arch]["train"]["history"] = hist
            log("reduced", f"launch.train --arch {arch} --reduced --steps "
                f"{REDUCED_STEPS} on the card: losses "
                f"{[round(h['loss'], 4) for h in hist]} in "
                f"{rec[arch]['train']['seconds']:.2f} s; K9-K11 by shape "
                f"{rec[arch]['train']['by_shape']}")
    seconds = time.perf_counter() - t_all
    record["reduced"] = {"seconds": seconds, "archs": rec,
                         "launches": launches}
    log("reduced", f"{len(REDUCED_SERVE)} archs served and "
        f"{len(REDUCED_TRAIN)} trained through the launchers in "
        f"{seconds:.1f} s; launches {json.dumps(launches, sort_keys=True)}"
        f"  [{card}]")
    return launches, by_case


def check_padded_rows(torch, g, dev, ks):
    """Phase 2 for K9-K11 at the reduced configs' head dims, which the
    kernels run padded to a width of 32: at each serving shape of
    FLASH_REDUCED and at its training shapes in both dtypes, q, k, v and
    do are views of rows with NaN past hd (hd_v), and o, dq, dk and dv
    views of rows holding a sentinel past it.  Fails if an output is not
    finite (a kernel read past a row's head dim) or a sentinel moved (it
    wrote past it); the values are held to the plain version by
    ``check_flash`` and ``check_flash_bwd``."""
    from repro_torch.kernels.flash_attention import ops
    n = 0
    for case in FLASH_REDUCED:
        B, H, KV, S, hd, hd_v = case[:6]
        kw = flash_kw(case)
        for dname in FLASH_DTYPES:
            dt = getattr(torch, dname)

            def rows(heads, d, fill):
                t = torch.full((B, heads, S, d + 8), fill, device=dev,
                               dtype=dt)
                t[..., :d] = torch.randn(B, heads, S, d, generator=g,
                                         device=dev)
                return t
            q, k, v, do = (rows(h_, d, float("nan"))[..., :d] for h_, d in (
                (H, hd), (KV, hd), (KV, hd_v), (H, hd_v)))
            outs = [torch.full((B, H, S, d + 8), 7.0, device=dev, dtype=dt)
                    for d in (hd_v, hd, hd, hd_v)]
            o, dq, dk, dv = (t[..., :d] for t, d in zip(
                outs, (hd_v, hd, hd, hd_v)))
            lse = torch.empty((B, H, S), device=dev)
            ops._launch(q, k, v, o, lse, **kw)
            ops._launch_bwd(q, k, v, do, lse, ops._delta(o, do), dq, dk, dv,
                            **kw)
            torch.cuda.synchronize()
            for name, t, d in zip(("o", "dq", "dk", "dv"), outs,
                                  (hd_v, hd, hd, hd_v)):
                if not (bool(torch.isfinite(t[..., :d]).all())
                        and bool((t[..., d:] == 7.0).all())):
                    raise AssertionError(
                        f"flash {case} {dname}: {name} read or wrote past "
                        f"its row's head dim {d}")
                n += 1
    return n


def run_examples(record, card):
    """Each example of ``examples_torch/`` (``EXAMPLES``): its ``main()``
    in this process on the card, its output kept in the output directory
    and its own checks read from it (``EXAMPLES_PASSED``)."""
    import contextlib
    import importlib.util
    import io
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    rows = {}
    t0 = time.perf_counter()
    for name, args in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        text = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(text):
            mod.main(list(args))
        seconds = time.perf_counter() - t
        text = text.getvalue()
        (out_dir / f"example_{name}.txt").write_text(text)
        if EXAMPLES_PASSED[name] not in text:
            raise AssertionError(f"example {name}: its checks did not pass; "
                                 f"its output ends {text[-500:]!r}")
        rows[name] = {"args": list(args), "seconds": seconds}
        log("examples", f"{name} {' '.join(args)}: its checks passed on the "
            f"card in {seconds:.1f} s; last line: "
            f"{text.strip().splitlines()[-1]}")
    total = time.perf_counter() - t0
    record["examples"] = {"seconds": total, "rows": rows}
    log("examples", f"six examples in {total:.1f} s  [{card}]")


def main():
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
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
                                                       float_instance,
                                                       mm_bytes_read,
                                                       mm_float_plan,
                                                       mm_plan,
                                                       stream_matmul,
                                                       stream_matmul_requant)
    from repro_torch.kernels.stream_matmul.ref import (result_dtype,
                                                       stream_matmul_ref)
    from repro_torch.models.cnn import (cnn_forward, cnn_input_shape,
                                        init_cnn_params)
    from repro_torch.runtime.pipeline import PipelineExecutor

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    record = {"card": card, "batch": BATCH, "seed": SEED}

    # -- 1. build (and the autotuner's host search beside it) -----------------
    tuned_join = start_tuning(compile, get_cnn, NX2100)
    t0 = time.perf_counter()
    k11_plant = start_k11_plant(_build)
    _build.build_all()
    k11_plant = k11_plant()
    record["build_s"] = time.perf_counter() - t0
    log("build", f"{len(_build.SOURCES)} sources and the K11 plant built "
        f"with nvcc in {record['build_s']:.1f} s")
    record["ptxas"] = ptxas_report(_build)
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
            for n in ("resnet50", "resnet18", "mobilenetv2", "vgg16",
                      "mobilenetv1", "mobilenetv3")}
    mv2 = nets["mobilenetv2"]
    nets[MV2_DW_HBM] = mv2.with_offload(set(mv2.streamed_names)
                                        | dw_names(mv2.cfg))
    tuned = tuned_join()
    check_tuned(tuned, record)
    for n, (cp, _, _) in tuned.items():
        nets[n + TUNED_SUFFIX] = cp
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
             for comp in list(comps.values()) + [
                 nets[n + TUNED_SUFFIX] for n in TUNED]
             for sc in comp.plan.schedules
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
    fpath = float_path(comps, select_engine)
    float_planned = check_float_instances(torch, record, fpath, block_for,
                                          mm_float_plan, sm_count)
    n_float = check_float_matmul(torch, g, dev, ks, fc_shapes, block_for,
                                 fpath)
    n_flash = check_flash(torch, g, dev, ks[LM_KERNEL], record)
    n_bwd = check_flash_bwd(torch, g, dev, ks, record)
    n_pad = check_padded_rows(torch, g, dev, ks)
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
        f"(every pair, n_buffers 1-4, every fc shape and path entry) within "
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
        f"limit {json.dumps(record['vjp_share_of_limit'])}; {n_pad} outputs "
        f"of K9-K11 at the reduced head dims (padded to 32) read and wrote "
        f"nothing past a row's head dim; in {record['check_s']:.1f} s")

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
        if name.endswith(TUNED_SUFFIX) and launches[name].get(
                "conv2d_int8_stream") != TUNED[name[:-len(TUNED_SUFFIX)]][
                    "conv2d_int8_stream"]:
            raise AssertionError(f"{name}: K2 launches {launches[name]}")
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
    h100_target(torch, nets, params, images, logits, dev, record, card)
    serve_cnn(torch, np, SERVE_NET, nets[SERVE_NET], params[SERVE_NET],
              fused_launches[SERVE_NET], dev, record)
    tuned_net = SERVE_NET + TUNED_SUFFIX
    serve_cnn(torch, np, tuned_net, nets[tuned_net], params[tuned_net],
              fused_launches[tuned_net], dev, record, credits=None,
              key="serving_tuned", steady=False)
    serve_frontend(torch, np, nets, params, {
        n: fused_launches[n] for _, n, _, _ in FRONTEND_TENANTS},
        dev, record)
    for name, stages, n_requests in SHARDED:
        served = serve_sharded(torch, np, name, nets[name], params[name],
                               fused_launches[name], dev, record, stages,
                               n_requests)
        launches[f"{name} sharded"] = served
        absent = [k for k in fused_launches[name] if not served.get(k)]
        if absent:
            raise AssertionError(f"sharded {name}: kernels of the path "
                                 f"never launched: {absent}")
    launches["float matmul"], float_inputs, float_used = drive_float_matmul(
        torch, g, dev, fpath, block_for, record, float_planned)
    total_launches.update(launches["float matmul"])
    lm = serve_lm(torch, np, dev, record)
    launches[LM_ARCH] = lm["launches"]
    total_launches[LM_KERNEL] = lm["launches"][LM_KERNEL]
    flash_launches = dict(lm["k9_by_case"])   # K9's launches by shape

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
    # the float matmul per path entry and operand pair (one launch each):
    # device ms, bytes (operands read once, the output written once),
    # bound (useful products 2 M K N, an f32 x's three parts not counted
    # as work, at the rate of the products the route issues: f32 weights
    # at 67 TFLOP/s FFMA, bf16 x f16 and an f32 x's parts against f16 at
    # the 495 of tf32, the others at the 989 of bf16 and f16), plain
    # ms, torch.matmul (TF32 off) in the operands' type, or, for a mixed
    # pair, on both converted to the result type inside the timed call (an
    # int8 operand's conversion timed with it), and the FFMA design's time
    # (FFMA_DESIGN_US, in the record and the [time] line); where the
    # weights fit in the L2 (4096 x 4096 and the heads), a second reading of
    # the kernel and of torch.matmul with the weights rotated over copies
    # that exceed it twice, so each launch reads them from device memory
    float_rows = {}
    t_bytes = {k: 0.0 for k in FLOAT_MM_KERNELS}
    t_ops = dict(t_bytes)
    for kname in FLOAT_MM_KERNELS:
        ks[kname].library_ms = 0.0
        ks[kname].per_shape = []
    for (k_, n_, mode, pname), (x, w) in float_inputs.items():
        kern = ks[FLOAT_KERNELS[mode]]
        bk = block_for(k_, 512)
        reps = 5 if (k_, n_) == FC0_MATMUL[1:] else 20
        out_t = result_dtype(x.dtype, w.dtype)

        def fn(w=w):
            return stream_matmul(x, w, mode=mode, bk=bk, n_buffers=2)

        def lib(w=w):
            if x.dtype == w.dtype:
                return torch.matmul(x, w)
            return torch.matmul(x.to(out_t), w.to(out_t))
        ms, cms = device_ms(torch, fn, reps=reps), call_ms(torch, fn, reps)
        pms = device_ms(torch, lambda: stream_matmul_ref(x, w), reps=3,
                        replays=2)
        lms = device_ms(torch, lib, reps=reps)
        cold = {}
        w_bytes = w.numel() * w.element_size()
        if w_bytes < L2_BYTES:
            copies = [w.clone() for _ in range(-(-2 * L2_BYTES // w_bytes))]
            turn = iter(range(1 << 30))
            for name, f in (("ms", fn), ("library_ms", lib)):
                cold[name] = device_ms(
                    torch, lambda f=f: f(copies[next(turn) % len(copies)]),
                    reps=len(copies), replays=2)
            del copies
        ref = stream_matmul_ref(x, w).double()
        lib_diff = float((lib().double() - ref).abs().max())
        xb, wb = x.element_size(), w.element_size()
        ob = torch.empty((), dtype=out_t).element_size()
        nbytes = BATCH * k_ * xb + k_ * n_ * wb + BATCH * n_ * ob
        ops = 2 * BATCH * k_ * n_
        plan = mm_float_plan(BATCH, k_, n_, mode, bk, 2, xb, wb, sm_count)
        tf32 = ({x.dtype, w.dtype} == {torch.bfloat16, torch.float16}
                or (x.dtype, w.dtype) == (torch.float32, torch.float16))
        rate = (FP32_FLOPS_PER_S if not plan.tensor_cores else
                TF32_FLOPS_PER_S if tf32 else BF16_FLOPS_PER_S)
        b, by = bound_ms(nbytes, ops, rate)
        kern.ms += ms
        kern.plain_ms += pms
        kern.library_ms += lms
        kern.bound_ms += b
        t_bytes[kern.name] += nbytes / HBM_BYTES_PER_S
        t_ops[kern.name] += ops / rate
        key = f"{mode}:{k_},{n_}:{pname}"
        xd_, wd_ = (str(t.dtype).split(".")[1] for t in (x, w))
        float_rows[key] = {
            "ms": ms, "call_ms": cms, "plain_ms": pms, "library_ms": lms,
            "cold_ms": cold.get("ms"),
            "cold_library_ms": cold.get("library_ms"),
            "ffma_design_ms": ffma_design_ms(f"{mode}:{k_},{n_}", xd_, wd_),
            "library_max_abs_diff": lib_diff, "bytes": nbytes,
            "flops": ops, "bound_ms": b, "bound_by": by,
            "share_of_bound": b / (cold.get("ms") or ms),
            "factor_on_library": ms / lms, "weight_gb_per_s":
                k_ * n_ * wb / ((cold.get("ms") or ms) * 1e6),
            "instance": float_instance(x.dtype, w.dtype, plan.tn),
            "plan": {f: getattr(plan, f) for f in (
                "tn", "split", "kr", "kblk", "nb", "wvec", "smem_bytes",
                "tma")},
            "ctas": plan.n_tiles * plan.split * plan.m_tiles}
        kern.per_shape.append({"case": key, "launches": 1, "ms": ms,
                               "plain_ms": pms, "bound_ms": b,
                               "bound_by": by, "library_ms": lms,
                               "cold_ms": cold.get("ms"),
                               "cold_library_ms": cold.get("library_ms")})
    for kname in FLOAT_MM_KERNELS:
        ks[kname].bound_by = ("bytes" if t_bytes[kname] >= t_ops[kname]
                              else "operations")
        ks[kname].instances = {inst: n for (k, inst), n in
                               sorted(float_used.items()) if k == kname}
    del float_inputs
    record["float_matmul_per_shape"] = float_rows

    def us(v):
        return "-" if v is None else f"{v * 1e3:.2f}"
    log("time", "float matmul per path entry (mode:K,N:type: us; L2 cold "
        "us; bound us; torch.matmul us, cold; FFMA design us; share of bound; "
        "weight GB/s; instance): " + "; ".join(
            f"{key}: {us(r['ms'])}; {us(r['cold_ms'])}; {us(r['bound_ms'])};"
            f" {us(r['library_ms'])}, {us(r['cold_library_ms'])}; "
            f"{us(r['ffma_design_ms'])}; {r['share_of_bound']:.3f}; "
            f"{r['weight_gb_per_s']:.0f}; {r['instance']}"
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
    log("time", "kernels' device ms a forward by net: " + "; ".join(
        f"{net} {sum(d.values()):.4f} (" + ", ".join(
            f"{k} {v:.5f}" for k, v in d.items()) + ")"
        for net, d in record["kernel_ms_by_net"].items()) + f"  [{card}]")

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
    for n in TUNED:
        g_, t_ = e2e[n], e2e[n + TUNED_SUFFIX]
        log("autotune", f"{n} tuned against greedy, batch {BATCH}, same "
            f"call: fused {t_['fused_ms_per_forward']:.3f} / "
            f"{g_['fused_ms_per_forward']:.3f} ms, eager "
            f"{t_['ms_per_forward']:.3f} / {g_['ms_per_forward']:.3f} ms, "
            f"device {t_['device_ms_per_forward']:.3f} / "
            f"{g_['device_ms_per_forward']:.3f} ms; card idle "
            f"{100 * t_['fused_idle_share']:.0f}% / "
            f"{100 * g_['fused_idle_share']:.0f}% of the fused forward; "
            f"streamed words a forward "
            f"{reports[n + TUNED_SUFFIX].total_hbm_words} / "
            f"{reports[n].total_hbm_words}  [{card}]")
    time_lm(torch, lm, card, record["lm"])
    del lm
    record["time_s"] = time.perf_counter() - t0

    # -- 3 and 4 for LM training, with the serving phase's weights freed ----
    def add_k9(by_case):
        for case, n in by_case.items():
            flash_launches[case] = flash_launches.get(case, 0) + n
    train, train_cases = train_lm(torch, np, dev, record, card)
    launches[LM_ARCH + " training"] = train
    for k in (LM_KERNEL,) + BWD_KERNELS:
        total_launches[k] = total_launches.get(k, 0) + train[k]
    add_k9(train_cases[LM_KERNEL])
    bwd_launches = {k: dict(train_cases[k]) for k in BWD_KERNELS}
    gpipe, gpipe_cases = gpipe_lm(torch, np, dev, record, card)
    launches[LM_ARCH + " GPipe"] = gpipe
    for k, n in gpipe.items():
        total_launches[k] += n
    add_k9(gpipe_cases[LM_KERNEL])
    for k in BWD_KERNELS:
        for case, n in gpipe_cases[k].items():
            bwd_launches[k][case] = bwd_launches[k].get(case, 0) + n
    # the other families' training, each freed before the next
    t0 = time.perf_counter()
    plants = {"k11": lambda: k11_planted(_build, k11_plant),
              "slstm": lambda: slstm_scaled(torch)}
    for row in TRAIN_FAMILIES:
        got, by_case = train_family(torch, np, dev, record, card, row,
                                    plants)
        launches[row[0] + " training"] = got
        for k, n in got.items():
            total_launches[k] += n
        add_k9(by_case[LM_KERNEL])
        for k in BWD_KERNELS:
            for case, n in by_case[k].items():
                bwd_launches[k][case] = bwd_launches[k].get(case, 0) + n
    log("train_families", f"{len(TRAIN_FAMILIES)} archs trained in "
        f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{n} {r['seconds']:.1f} s"
            for n, r in record["train_families"].items()))
    abstract_traces(torch, compile, get_cnn, NX2100, record, card)

    # -- 3 and 4 for the other LM families, one arch at a time, with
    # Phi-4-mini's weights freed; then each in f32 ---------------------------
    for name, n_layers, n_params, prompt, max_seq, cases in LM_ARCHS:
        got, k9 = serve_arch(torch, np, dev, record, card, name, n_layers,
                             n_params, prompt, max_seq, cases)
        launches[name] = got
        total_launches[LM_KERNEL] += got.get(LM_KERNEL, 0)
        add_k9(k9)
    for name, (n_layers, S, change) in LM_F32.items():
        lm_f32(torch, np, dev, record, card, name, n_layers, S, change)

    # -- the LM dry run: the meta sweep, then Phi-4-mini's cells on the card
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.configs.base import SHAPES, shape_applicable
    dryrun_sweep(shape_applicable, ARCH_IDS, get_arch, SHAPES, record)
    dryrun_launches, dryrun_cases = dryrun_cells(torch, dev, record, card)
    launches[LM_ARCH + " dry run"] = dryrun_launches
    for k, n in dryrun_launches.items():
        total_launches[k] = total_launches.get(k, 0) + n
    add_k9(dryrun_cases.get(LM_KERNEL, {}))
    for k in BWD_KERNELS:
        for case, n in dryrun_cases.get(k, {}).items():
            bwd_launches[k][case] = bwd_launches[k].get(case, 0) + n
    # -- the reduced configs through the launchers ---------------------------
    reduced, reduced_cases = reduced_launchers(torch, np, record, card)
    launches["reduced"] = reduced
    for k, n in reduced.items():
        total_launches[k] = total_launches.get(k, 0) + n
    add_k9(reduced_cases[LM_KERNEL])
    for k in BWD_KERNELS:
        for case, n in reduced_cases[k].items():
            bwd_launches[k][case] = bwd_launches[k].get(case, 0) + n
    missing = [k for k in KERNELS if not total_launches.get(k)]
    if missing:
        raise AssertionError(f"kernels never launched on the path: "
                             f"{missing}")
    record["launches"] = launches
    t0 = time.perf_counter()
    time_flash(torch, F, g, dev, ks[LM_KERNEL], flash_launches, card, record)
    time_flash_bwd(torch, F, g, dev, ks, bwd_launches, card, record)
    record["time_s"] += time.perf_counter() - t0
    run_examples(record, card)

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
        if getattr(kern, "per_shape", None):  # K9-K11: each shape
            rows[-1]["per_shape"] = kern.per_shape
        if getattr(kern, "instances", None):  # the float matmul's
            rows[-1]["instances"] = kern.instances
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
