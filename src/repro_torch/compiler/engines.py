"""LayerEngine protocol + registry — the compiler's extension surface.

H2PIPE emits *layer-specific* hardware: every layer gets its own engine,
chosen by what the layer is (dense conv, depthwise conv, fc head) and
where its weights live (pinned M20K vs HBM-streamed).  A
:class:`LayerEngine` wraps one kernel family and declares

  * ``supports(spec)``            which :class:`ConvLayerSpec` shapes it
                                  can run (checked at *compile* time);
  * ``vmem_bytes(spec, sched)``   the working set one dispatch claims, so
                                  ``compile()`` can validate every layer
                                  against the Target's budget and re-place
                                  (pin -> stream) the ones that do not
                                  fit.  The numbers are the JAX package's,
                                  so both packages compile to the same
                                  tables;
  * ``plan_bytes(spec, sched)``   the shared memory a block of the CUDA
                                  launch plan the card will run claims,
                                  or None where the card has no plan for
                                  the layer (its launch would raise): the
                                  claim the ``H100`` target checks in
                                  place of ``vmem_bytes``;
  * ``run(ctx, sched, params, x, relu)``
                                  the actual dispatch.  Engines hold NO
                                  mutable state and RETURN their
                                  :class:`LayerExecStats`.

Engines register under a short name with :func:`register_engine`; the
compiler picks, per layer, the highest-priority registered engine whose
``supports`` accepts the spec.

Block engines (``is_block = True``) bind a whole :class:`ResBlockSpec`;
``res_block_int8`` fuses a residual block's conv chain, downsample, add
and relu.  ``scanned_res_block_int8`` binds a homogeneous run of blocks
(a plain loop here: PyTorch has no trace to shrink, but the scan tables
and per-iteration Eq. 2 rows stay those of the JAX package).

Built-in engines: ``conv2d_int8`` (dense/pointwise conv + big fc-as-conv
heads), ``dwconv_int8`` (grouped depthwise, ``csrc/dwconv_int8.cu``),
``stream_matmul`` (1x1 fc heads), ``maxpool_int8`` /
``global_avgpool_int8`` (weightless pooling nodes), ``res_block_int8``,
``scanned_res_block_int8``, ``stem_pool_int8`` and ``jnp_ref`` (the plain
reference, priority 0; the name is the JAX package's so engine tables
compare one to one).

Every engine also exposes ``stats(sched, batch)`` — the shape-static
:class:`LayerExecStats` a dispatch of that schedule WILL return, without
executing anything.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import (Any, Dict, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import torch

from repro_torch.configs.cnn import (POOL_KINDS, ConvLayerSpec, ResBlockSpec,
                                     StemUnitSpec)
from repro_torch.core.schedule import HBM, PINNED, LayerSchedule
from repro_torch.kernels.conv2d_int8.ops import (STREAM_MAX_W_OUT,
                                                 conv2d_int8_requant,
                                                 conv_plan, dw_plan,
                                                 same_padded_width,
                                                 stream_plan)
from repro_torch.kernels.pool_int8.ops import (gap_plan, global_avgpool_int8,
                                               maxpool_int8, pool_plan)
from repro_torch.kernels.stream_matmul import ops as sm_ops
from repro_torch.models.cnn import residual_join

Params = Dict[str, Any]

#: The launch plans ``plan_bytes`` reads are taken at batch ``PLAN_BATCH``
#: on a card of ``PLAN_SMS`` SMs (the H100 SXM's).  Whether a plan exists
#: does not depend on either for the convs, the pools and the depthwise
#: conv: the dense plans shrink their bands (and the streamed one its
#: image group) down to one output row of one image before they refuse,
#: the depthwise tile search does not read them, and the pools' stages
#: follow the map and the channels.  The fc matmul's does: its K split
#: narrows as the batch adds row tiles, and its block grows, so its plan
#: is taken where the split is 1 (``PLAN_SMS`` tiles of ``MM_TM`` rows),
#: the largest block any batch gives.
PLAN_BATCH = 1
PLAN_SMS = 132


def _plan_smem(plan, *args) -> Optional[int]:
    """``plan(*args).smem_bytes``, or None where the plan refuses (no
    tile of the launch fits a block's shared memory)."""
    try:
        return plan(*args).smem_bytes
    except ValueError:
        return None


def _max_claim(claims) -> Optional[int]:
    """A unit's plan bytes: the largest of its members' (each member is
    a launch of its own), None when any member has no plan."""
    claims = list(claims)
    return None if any(c is None for c in claims) else max(claims)


@functools.lru_cache(maxsize=None)
def _block(n: int, cap: int) -> int:
    """Largest divisor of n not exceeding cap (the JAX kernels' block
    sizing, kept for the ``vmem_bytes`` accounting and the K-block size).
    Cached: compile() probes this from every ``supports``/``vmem_bytes``
    call, and the divisor scan is linear in n."""
    for b in range(min(n, cap), 0, -1):
        if n % b == 0:
            return b
    return 1


def _padded_width(spec: ConvLayerSpec) -> int:
    """SAME-padded input width (what the line buffer actually holds) —
    from the kernel module's own padding formula, so validation and
    allocation cannot drift apart."""
    return same_padded_width(spec.in_w, spec.k_w, spec.stride)


# ---------------------------------------------------------------------------
# execution context + per-dispatch stats
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerExecStats:
    """What one layer dispatch did (which engine, which tier, Eq. 2 words).

    Frozen and shape-static: engines *return* these alongside their
    tensors (every field derives from the schedule and the input shape,
    never from tensor values), so a run's stats equal the compile-time
    template."""

    name: str
    mode: str                     # "pinned" | "hbm"
    kernel: str                   # engine name that actually ran
    hbm_words: int = 0            # Eq. 2 words streamed for this dispatch

    @classmethod
    def for_dispatch(cls, sched: LayerSchedule, *, kernel: str, batch: int,
                     rows: int = 0, mode: Optional[str] = None
                     ) -> "LayerExecStats":
        mode = sched.mode if mode is None else mode
        words = 0
        if mode == HBM and batch:
            # Eq. 2 accounting: kernels re-read once per output row, per
            # image.  (On TPU the matmul amortizes the batch dim; the
            # paper's accelerator is batch-1, so we report paper units.)
            words = sched.weight_words_per_row * rows * batch
        return cls(name=sched.spec.name, mode=mode, kernel=kernel,
                   hbm_words=words)


@dataclass(frozen=True)
class EngineContext:
    """Per-execution configuration threaded through every engine call.

    Frozen and side-effect free: engines read the activation scale from
    it and return everything they produce — including
    :class:`LayerExecStats` — so concurrent executions of one compiled
    pipeline cannot corrupt each other's reports.  Where an engine runs
    follows from the device of the tensors it is given."""

    act_scale: float


# ---------------------------------------------------------------------------
# the protocol + registry
# ---------------------------------------------------------------------------


@runtime_checkable
class LayerEngine(Protocol):
    """One layer-engine family the compiler can instantiate.

    Engines may additionally declare ``can_stream = False`` (default
    True) when they cannot source weights from the HBM tier; stage 5
    keeps such bindings pinned so plan analytics never charge Eq. 2
    traffic an engine will not execute.

    Engines declaring ``is_block = True`` bind a whole
    :class:`ResBlockSpec` instead of one layer; their methods take the
    block (and a tuple of member schedules, in ``block.members`` order)
    and ``run`` returns ``(int8 activations, per-member stats tuple)``.
    """

    name: str

    def supports(self, spec: ConvLayerSpec) -> bool:
        """Can this engine execute the layer (decided at compile time)?"""
        ...

    def vmem_bytes(self, spec: ConvLayerSpec, sched: LayerSchedule) -> int:
        """Working-set bytes one dispatch claims (batch-1 convention)."""
        ...

    def plan_bytes(self, spec: ConvLayerSpec,
                   sched: LayerSchedule) -> Optional[int]:
        """Shared-memory bytes a block of the card's launch plan claims
        (``PLAN_BATCH``), or None where there is no plan."""
        ...

    def stats(self, sched: LayerSchedule, batch: int) -> LayerExecStats:
        """The shape-static stats one dispatch of ``sched`` WILL return,
        without executing — the template the plan-vs-executed Eq. 2
        cross-check (``CompiledPipeline.stats_template``) is built from.
        Must equal what ``run`` returns for the same schedule/batch."""
        ...

    def run(self, ctx: EngineContext, sched: LayerSchedule, params: Params,
            x: torch.Tensor, relu: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor], LayerExecStats]:
        """Execute the layer; returns (int8 activations, float pre-quant,
        dispatch stats).  Stats are shape-static — safe under a trace."""
        ...


# name -> stack of (priority, insertion_seq, engine); the TOP of each
# stack is live.  Re-registering a name pushes (shadowing the previous
# engine), unregistering pops (restoring it) — so overrides of built-ins
# round-trip without touching this module.  Selection order over the live
# engines is priority DESC then insertion order.
_REGISTRY: Dict[str, List[Tuple[int, int, LayerEngine]]] = {}
_SEQ = 0


def register_engine(name: str, *, priority: int = 10):
    """Class decorator: instantiate and register a LayerEngine under
    ``name``.  Registering an existing name shadows the previous engine
    (how tests/users override a built-in); :func:`unregister_engine`
    pops the override and restores what it shadowed."""
    def deco(cls):
        global _SEQ
        engine = cls() if isinstance(cls, type) else cls
        engine.name = name
        _SEQ += 1
        _REGISTRY.setdefault(name, []).append((priority, _SEQ, engine))
        return cls
    return deco


def unregister_engine(name: str) -> Optional[LayerEngine]:
    """Pop the live engine for ``name`` (restoring any engine it
    shadowed); returns it, or None if the name is unknown."""
    stack = _REGISTRY.get(name)
    if not stack:
        return None
    _, _, engine = stack.pop()
    if not stack:
        del _REGISTRY[name]
    return engine


def get_engine(name: str) -> LayerEngine:
    try:
        return _REGISTRY[name][-1][2]
    except KeyError:
        raise KeyError(f"no engine registered under {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def registered_engines() -> Dict[str, LayerEngine]:
    """Live registered engines in selection order (priority DESC, age)."""
    tops = {name: stack[-1] for name, stack in _REGISTRY.items()}
    items = sorted(tops.items(), key=lambda kv: (-kv[1][0], kv[1][1]))
    return {name: eng for name, (_, _, eng) in items}


def select_engine(spec: ConvLayerSpec) -> LayerEngine:
    """The compile-time choice: highest-priority engine claiming the spec.
    Unit-granular engines (``is_block`` / ``is_scan`` / ``is_stem``) bind
    groups, not layers — skipped here."""
    for eng in registered_engines().values():
        if (getattr(eng, "is_block", False) or getattr(eng, "is_scan", False)
                or getattr(eng, "is_stem", False)):
            continue
        if eng.supports(spec):
            return eng
    raise LookupError(f"no registered engine supports layer {spec.name!r} "
                      f"(kind={spec.kind!r})")


def select_block_engine(block: ResBlockSpec) -> Optional[LayerEngine]:
    """Highest-priority *block* engine claiming the residual block, or
    None — in which case the block's layers keep their per-layer
    bindings (the always-valid fallback)."""
    for eng in registered_engines().values():
        if getattr(eng, "is_block", False) and eng.supports(block):
            return eng
    return None


def select_scan_engine(blocks: Sequence[ResBlockSpec]
                       ) -> Optional[LayerEngine]:
    """Highest-priority *scan* engine (``is_scan = True``) claiming a
    homogeneous run of residual blocks, or None — the run's blocks then
    keep their per-block (or per-layer) bindings."""
    for eng in registered_engines().values():
        if getattr(eng, "is_scan", False) and eng.supports(blocks):
            return eng
    return None


def select_stem_engine(unit: StemUnitSpec) -> Optional[LayerEngine]:
    """Highest-priority *stem* engine (``is_stem = True``) claiming the
    stem conv + maxpool unit, or None — the stem layers then keep their
    per-layer bindings."""
    for eng in registered_engines().values():
        if getattr(eng, "is_stem", False) and eng.supports(unit):
            return eng
    return None


def _is_1x1_fc(spec: ConvLayerSpec) -> bool:
    """fc heads that run as a [B, c_in] x [c_in, c_out] matmul: 1x1 kernel
    on a 1x1 (pooled) map.  Big fc-as-conv heads (VGG's 7x7 fc0) keep the
    conv engine."""
    return (spec.kind == "fc" and spec.k_h == 1 and spec.k_w == 1
            and spec.in_h == 1 and spec.in_w == 1)


def _fc_conv_is_valid_equivalent(spec: ConvLayerSpec) -> bool:
    """The reference applies fc layers with VALID padding while the conv
    engine SAME-pads, so the conv engine may only claim fc-as-conv heads
    whose SAME padding computes to zero in both dims (then SAME == VALID
    bit-for-bit — e.g. VGG's fc0: 7x7 kernel on a 7x7 map, stride 7).
    Anything else binds to the explicit jnp_ref engine instead of
    executing with the wrong padding."""
    return (same_padded_width(spec.in_h, spec.k_h, spec.stride) == spec.in_h
            and same_padded_width(spec.in_w, spec.k_w, spec.stride)
            == spec.in_w)


# ---------------------------------------------------------------------------
# built-in engines
# ---------------------------------------------------------------------------


@register_engine("conv2d_int8", priority=10)
class Conv2DInt8Engine:
    """The line-buffer conv kernel as an engine; weights pinned in shared
    memory or streamed through the n_buffers-deep ring per the schedule.
    ``depthwise=False`` covers dense/pointwise convs (and fc-as-conv
    heads); the ``depthwise=True`` instance (registered as
    ``dwconv_int8``) is the grouped MobileNet path, which launches the
    depthwise kernel (``csrc/dwconv_int8.cu``) on CUDA tensors.

    The pre-quant f32 values are produced only for fc heads, the one
    place ``cnn_forward`` reads them (as logits)."""

    def __init__(self, depthwise: bool = False):
        self.depthwise = depthwise

    def supports(self, spec: ConvLayerSpec) -> bool:
        if self.depthwise:
            return spec.kind == "dwconv"
        return spec.kind in ("conv", "pwconv") or (
            spec.kind == "fc" and not _is_1x1_fc(spec)
            and _fc_conv_is_valid_equivalent(spec))

    def vmem_bytes(self, spec: ConvLayerSpec, sched: LayerSchedule) -> int:
        # channel factors of one weight tap: [1, C] depthwise, [C, C_out]
        # dense.  Widths use the kernel's SAME-pad ceil, not spec's floor.
        tap_in = 1 if self.depthwise else spec.c_in
        c_out = spec.c_in if self.depthwise else spec.c_out
        out_w = spec.out_w                  # SAME ceil, == kernel output
        line_buf = spec.k_h * _padded_width(spec) * spec.c_in      # int8
        if sched.streamed:
            w = min(sched.n_buffers, spec.k_h * spec.k_w) \
                * tap_in * c_out                                   # ring
        else:
            w = spec.k_h * spec.k_w * tap_in * c_out               # pinned
        out_row = out_w * c_out * 4                                # int32
        return line_buf + w + 2 * out_row                          # + acc

    def plan_bytes(self, spec: ConvLayerSpec,
                   sched: LayerSchedule) -> Optional[int]:
        geo = (PLAN_BATCH, spec.in_h, spec.in_w, spec.c_in)
        if self.depthwise:
            if spec.k_h != spec.k_w:
                return None                   # the launcher refuses it
            return _plan_smem(dw_plan, *geo, spec.k_h, spec.stride,
                              sched.streamed, sched.n_buffers, PLAN_SMS)
        conv = (spec.c_out, spec.k_h, spec.k_w, spec.stride)
        if not sched.streamed:
            return _plan_smem(conv_plan, *geo, *conv, PLAN_SMS)
        if spec.out_w > STREAM_MAX_W_OUT:
            return None
        return _plan_smem(stream_plan, *geo, *conv, sched.n_buffers,
                          PLAN_SMS)

    def stats(self, sched: LayerSchedule, batch: int) -> LayerExecStats:
        """The shape-static stats one dispatch returns: the kernel emits
        ``spec.out_h`` SAME-padded output rows per image (out_h is the
        ceil the kernels produce, so template == executed == plan)."""
        return LayerExecStats.for_dispatch(sched, kernel=self.name,
                                           batch=batch,
                                           rows=sched.spec.out_h)

    def run(self, ctx: EngineContext, sched: LayerSchedule, params: Params,
            x, relu: bool):
        spec = sched.spec
        y_q, y_f = conv2d_int8_requant(
            x, params["w"], params["w_scale"], params["bias"],
            act_scale=ctx.act_scale, stride=spec.stride, relu=relu,
            stream=sched.streamed, n_buffers=sched.n_buffers,
            depthwise=self.depthwise, want_float=spec.kind == "fc")
        stats = LayerExecStats.for_dispatch(
            sched, kernel=self.name, batch=int(x.shape[0]),
            rows=int(y_q.shape[1]))
        return y_q, y_f, stats


# the grouped depthwise path is the same engine with the flag flipped
register_engine("dwconv_int8", priority=10)(Conv2DInt8Engine(depthwise=True))


@register_engine("stream_matmul", priority=10)
class StreamMatmulFCEngine:
    """1x1 fc heads as a streamed matmul: ``pinned`` mode keeps W resident
    in shared memory for the call, ``fifo`` prefetches K-blocks through an
    explicit credit ring — the same two weight tiers, matmul-shaped."""

    BM, BK, BN = 128, 512, 128

    def supports(self, spec: ConvLayerSpec) -> bool:
        return _is_1x1_fc(spec)

    def vmem_bytes(self, spec: ConvLayerSpec, sched: LayerSchedule) -> int:
        mode = "fifo" if sched.streamed else "pinned"
        return sm_ops.vmem_bytes(
            mode, 1, spec.c_in, spec.c_out, 1,
            bm=1, bk=_block(spec.c_in, self.BK),
            bn=_block(spec.c_out, self.BN),
            n_buffers=max(2, sched.n_buffers))

    def plan_bytes(self, spec: ConvLayerSpec,
                   sched: LayerSchedule) -> Optional[int]:
        return _plan_smem(
            sm_ops.mm_plan, sm_ops.MM_TM * PLAN_SMS, spec.c_in, spec.c_out,
            "fifo" if sched.streamed else "pinned",
            _block(spec.c_in, self.BK), max(2, sched.n_buffers), PLAN_SMS)

    def stats(self, sched: LayerSchedule, batch: int) -> LayerExecStats:
        """One matmul dispatch == one output 'row' of weight reads."""
        return LayerExecStats.for_dispatch(sched, kernel=self.name,
                                           batch=batch, rows=1)

    def run(self, ctx: EngineContext, sched: LayerSchedule, params: Params,
            x, relu: bool):
        spec = sched.spec
        B = int(x.shape[0])
        c_in, c_out = spec.c_in, spec.c_out
        x2 = x.reshape(B, c_in)
        w2 = params["w"].reshape(c_in, c_out)
        mode = "fifo" if sched.streamed else "pinned"
        y_q, y_f = sm_ops.stream_matmul_requant(
            x2, w2, params["w_scale"], params["bias"],
            act_scale=ctx.act_scale, relu=relu, mode=mode,
            bk=_block(c_in, self.BK), n_buffers=max(2, sched.n_buffers))
        y_q, y_f = y_q.reshape(B, 1, 1, c_out), y_f.reshape(B, 1, 1, c_out)
        stats = LayerExecStats.for_dispatch(sched, kernel=self.name,
                                            batch=B, rows=1)
        return y_q, y_f, stats


@register_engine("maxpool_int8", priority=10)
class MaxPoolInt8Engine:
    """The maxpool topology node as a first-class engine: a k_h-row line
    buffer feeding comparator trees (``kernels/pool_int8``) — the paper
    places a dedicated pooling engine per node exactly like a conv
    engine, just with zero weight memory.  Never streams (there are no
    weights to stream: ``can_stream = False``), Eq. 2 words are 0 by
    construction, and the working-set claim is the line buffer + the
    double-buffered output row."""

    can_stream = False

    def supports(self, spec: ConvLayerSpec) -> bool:
        return spec.kind == "maxpool"

    def vmem_bytes(self, spec: ConvLayerSpec, sched: LayerSchedule) -> int:
        line_buf = spec.k_h * _padded_width(spec) * spec.c_in      # int8
        out_row = spec.out_w * spec.c_in                           # int8
        return line_buf + 2 * out_row

    def plan_bytes(self, spec: ConvLayerSpec,
                   sched: LayerSchedule) -> Optional[int]:
        return _plan_smem(pool_plan, PLAN_BATCH, spec.in_h, spec.in_w,
                          spec.c_in, spec.k_h, spec.stride, PLAN_SMS)

    def stats(self, sched: LayerSchedule, batch: int) -> LayerExecStats:
        return LayerExecStats.for_dispatch(sched, kernel=self.name,
                                           batch=batch,
                                           rows=sched.spec.out_h,
                                           mode=PINNED)

    def run(self, ctx: EngineContext, sched: LayerSchedule, params: Params,
            x, relu: bool):
        spec = sched.spec
        y = maxpool_int8(x, k=spec.k_h, stride=spec.stride)
        stats = LayerExecStats.for_dispatch(
            sched, kernel=self.name, batch=int(x.shape[0]),
            rows=int(y.shape[1]), mode=PINNED)
        return y, None, stats


@register_engine("global_avgpool_int8", priority=10)
class GlobalAvgPoolInt8Engine:
    """The global-average-pool node as an engine: per-channel int32
    accumulators + the activation requantizer (``kernels/pool_int8``).
    Weightless like maxpool (``can_stream = False``, zero Eq. 2 words);
    the working-set claim is the resident spatial map the kernel reduces plus
    the accumulator bank and the 1x1 output row."""

    can_stream = False

    def supports(self, spec: ConvLayerSpec) -> bool:
        return spec.kind == "gap"

    def vmem_bytes(self, spec: ConvLayerSpec, sched: LayerSchedule) -> int:
        in_map = spec.in_h * spec.in_w * spec.c_in                 # int8
        acc = spec.c_in * 4                                        # int32
        return in_map + acc + 2 * spec.c_in

    def plan_bytes(self, spec: ConvLayerSpec,
                   sched: LayerSchedule) -> Optional[int]:
        return _plan_smem(gap_plan, PLAN_BATCH, spec.in_h, spec.in_w,
                          spec.c_in, PLAN_SMS)

    def stats(self, sched: LayerSchedule, batch: int) -> LayerExecStats:
        return LayerExecStats.for_dispatch(sched, kernel=self.name,
                                           batch=batch, rows=1, mode=PINNED)

    def run(self, ctx: EngineContext, sched: LayerSchedule, params: Params,
            x, relu: bool):
        y = global_avgpool_int8(x, act_scale=ctx.act_scale)
        stats = LayerExecStats.for_dispatch(
            sched, kernel=self.name, batch=int(x.shape[0]), rows=1,
            mode=PINNED)
        return y, None, stats


@register_engine("jnp_ref", priority=0)
class JnpReferenceEngine:
    """The plain PyTorch reference path as an explicit, lowest-priority
    engine (the JAX package's name, so engine tables compare): it supports
    every layer and claims no working set, so a layer only lands here when
    no kernel engine claims it — and the engine table SAYS so at compile
    time instead of a silent dispatch fallback.  Streams nothing
    (``can_stream = False``), and accounting records the pinned tier that
    actually ran.  Pool nodes route to the plain pooling references,
    everything else to ``conv_layer_forward``."""

    can_stream = False

    def supports(self, spec: ConvLayerSpec) -> bool:
        return True

    def vmem_bytes(self, spec: ConvLayerSpec, sched: LayerSchedule) -> int:
        return 0

    def plan_bytes(self, spec: ConvLayerSpec,
                   sched: LayerSchedule) -> Optional[int]:
        return 0                              # no launch plan of its own

    def stats(self, sched: LayerSchedule, batch: int) -> LayerExecStats:
        return LayerExecStats.for_dispatch(sched, kernel=self.name,
                                           batch=0, mode=PINNED)

    def run(self, ctx: EngineContext, sched: LayerSchedule, params: Params,
            x, relu: bool):
        from repro_torch.models.cnn import conv_layer_forward, pool_forward
        spec = sched.spec
        stats = LayerExecStats.for_dispatch(sched, kernel=self.name,
                                            batch=0, mode=PINNED)
        if spec.kind in POOL_KINDS:
            return pool_forward(spec, x, act_scale=ctx.act_scale), None, stats
        y_q, y_f = conv_layer_forward(params, spec, x,
                                      act_scale=ctx.act_scale, relu=relu)
        return y_q, y_f, stats


@register_engine("res_block_int8", priority=10)
class ResBlockInt8Engine:
    """A whole residual block — conv chain, identity downsample, int32
    add, clip and relu — as ONE schedulable unit, the granularity the
    paper actually places: an engine is a block of fabric, not a Python
    loop iteration.  Member convs execute on their per-layer engines
    (pinned or HBM-streamed per the member schedules), the join runs
    in-engine, and the unit reports per-member Eq. 2 stats under this
    engine's name — the compile-time binding is exactly what runs.

    The block claims the SUM of its members' working sets plus the
    identity buffer (the skip path holds the block input while the conv
    chain runs), plus the WIDEST intermediate activation map handed
    between members — the chain is sequential inside the unit, so one
    extra staging buffer sized by the widest producer covers every
    member-to-member handoff.  This tightened large-block model is what
    lets bottleneck (1x1-3x3-1x1 + downsample) blocks bind on real
    targets instead of falling back per-layer early; ``compile()`` only
    binds the block when the total fits the target's budget, else
    the layers keep per-layer bindings.

    On the card the members are separate launches (inside one CUDA graph
    when fused) and the identity stays in device memory, so under the
    ``H100`` target the unit fits when every member's launch plan does:
    its ``plan_bytes`` is the largest member's, not a sum.
    """

    is_block = True

    def _member_engines(self, block: ResBlockSpec):
        return [select_engine(m) for m in block.members]

    def supports(self, block: ResBlockSpec) -> bool:
        # every member must land on a conv engine: a jnp_ref (or
        # otherwise non-conv) member means the block's padding/precision
        # contract is not the line-buffer kernel's, so bind per-layer.
        if not block.convs:
            return False
        return all(eng.name in ("conv2d_int8", "dwconv_int8")
                   for eng in self._member_engines(block))

    def vmem_bytes(self, block: ResBlockSpec,
                   scheds: Tuple[LayerSchedule, ...]) -> int:
        first = block.convs[0]
        identity = first.in_h * first.in_w * first.c_in          # int8 skip
        members = sum(
            eng.vmem_bytes(s.spec, s)
            for eng, s in zip(self._member_engines(block), scheds))
        widest = max(m.out_h * m.out_w * m.c_out                 # int8 stage
                     for m in block.members)
        return members + identity + widest

    def plan_bytes(self, block: ResBlockSpec,
                   scheds: Tuple[LayerSchedule, ...]) -> Optional[int]:
        return _max_claim(
            eng.plan_bytes(s.spec, s)
            for eng, s in zip(self._member_engines(block), scheds))

    def stats(self, block: ResBlockSpec, scheds: Tuple[LayerSchedule, ...],
              batch: int) -> Tuple[LayerExecStats, ...]:
        """Per-member stats template in dispatch order (convs then ds),
        each reported under this block engine's name — exactly what one
        ``run`` returns, without executing anything."""
        by_name = {s.spec.name: s for s in scheds}
        order = list(block.convs) + ([block.ds] if block.ds is not None
                                     else [])
        return tuple(
            dataclasses.replace(
                select_engine(m).stats(by_name[m.name], batch),
                kernel=self.name)
            for m in order)

    def run(self, ctx: EngineContext, block: ResBlockSpec,
            scheds: Tuple[LayerSchedule, ...], params: Params, x
            ) -> Tuple[torch.Tensor, Tuple[LayerExecStats, ...]]:
        by_name = {s.spec.name: s for s in scheds}
        stats: List[LayerExecStats] = []

        def member(spec: ConvLayerSpec, xin, relu: bool):
            y_q, _, st = select_engine(spec).run(
                ctx, by_name[spec.name], params[spec.name], xin, relu)
            # the block IS the binding: members report under its name
            stats.append(dataclasses.replace(st, kernel=self.name))
            return y_q

        h = x
        last = len(block.convs) - 1
        for ci, cspec in enumerate(block.convs):
            h = member(cspec, h, relu=ci != last)
        identity = x
        if block.ds is not None:
            identity = member(block.ds, identity, relu=False)
        return residual_join(h, identity), tuple(stats)


@register_engine("scanned_res_block_int8", priority=10)
class ScannedResBlockInt8Engine:
    """A homogeneous RUN of residual blocks as one schedulable unit.  In
    the JAX package this is one ``lax.scan`` over the fused block body,
    which shrinks the trace; PyTorch runs eagerly, so here it is a loop
    that runs each block of the run through its block engine, in order.
    It stays so that the scan tables and the per-iteration Eq. 2 rows
    are those of the JAX package.

    Methods take the block run (and per-block member schedules, outer
    index = block): ``run`` returns ``(int8 activations, stats)`` where
    the stats list EVERY member of EVERY block.

    Working set: one block's claim plus the pinned weights of the
    remaining ``n_blocks - 1`` iterations (the JAX package's accounting).
    Plan bytes: the largest of its blocks' (every member a launch of its
    own, nothing stacked on the card).
    """

    is_scan = True

    def supports(self, blocks: Sequence[ResBlockSpec]) -> bool:
        if len(blocks) < 2:
            return False
        engs = [select_block_engine(b) for b in blocks]
        return all(e is not None and e.name == engs[0].name for e in engs)

    def vmem_bytes(self, blocks: Sequence[ResBlockSpec],
                   scheds_per_block: Sequence[Tuple[LayerSchedule, ...]]
                   ) -> int:
        body = select_block_engine(blocks[0]).vmem_bytes(
            blocks[0], scheds_per_block[0])
        pinned = sum(s.spec.weight_count for s in scheds_per_block[0]
                     if not s.streamed)
        return body + (len(blocks) - 1) * pinned

    def plan_bytes(self, blocks: Sequence[ResBlockSpec],
                   scheds_per_block: Sequence[Tuple[LayerSchedule, ...]]
                   ) -> Optional[int]:
        return _max_claim(
            select_block_engine(b).plan_bytes(b, scheds)
            for b, scheds in zip(blocks, scheds_per_block))

    def stats(self, blocks: Sequence[ResBlockSpec],
              scheds_per_block: Sequence[Tuple[LayerSchedule, ...]],
              batch: int) -> Tuple[LayerExecStats, ...]:
        """Every member of every block, config order, under this engine's
        name — the scan changes how the graph compiles, never what the
        accounting covers."""
        out: List[LayerExecStats] = []
        for blk, scheds in zip(blocks, scheds_per_block):
            beng = select_block_engine(blk)
            out.extend(dataclasses.replace(st, kernel=self.name)
                       for st in beng.stats(blk, scheds, batch))
        return tuple(out)

    def run(self, ctx: EngineContext, blocks: Sequence[ResBlockSpec],
            scheds_per_block: Sequence[Tuple[LayerSchedule, ...]],
            params: Params, x
            ) -> Tuple[torch.Tensor, Tuple[LayerExecStats, ...]]:
        h = x
        for blk, scheds in zip(blocks, scheds_per_block):
            h, _ = select_block_engine(blk).run(ctx, blk, scheds, params, h)
        return h, self.stats(blocks, scheds_per_block, int(x.shape[0]))


@register_engine("stem_pool_int8", priority=10)
class StemPoolInt8Engine:
    """The stem conv + following maxpool as ONE schedulable unit — the
    carried-over ROADMAP nicety: the stem pair rides the block-unit
    machinery (one dispatch, one working-set cost, contiguous member stats)
    instead of two separate nodes.  Members execute on their per-layer
    engine bindings (the conv pinned or HBM-streamed per its schedule,
    the pool weightless), joined by the conv's output map as the only
    intermediate the unit stages.  Plan bytes: the larger of its two
    launches'."""

    is_stem = True

    def supports(self, unit: StemUnitSpec) -> bool:
        try:
            ce = select_engine(unit.conv)
            pe = select_engine(unit.pool)
        except LookupError:                            # pragma: no cover
            return False
        # both members must land on the kernel engines this unit fuses;
        # anything else (jnp_ref fallback after an unregister) keeps the
        # per-layer bindings so the engine table says what truly runs
        return (ce.name in ("conv2d_int8", "dwconv_int8")
                and pe.name == "maxpool_int8")

    def vmem_bytes(self, unit: StemUnitSpec,
                   scheds: Tuple[LayerSchedule, ...]) -> int:
        cs, ps = scheds
        handoff = unit.conv.out_h * unit.conv.out_w * unit.conv.c_out  # int8
        return (select_engine(unit.conv).vmem_bytes(unit.conv, cs)
                + select_engine(unit.pool).vmem_bytes(unit.pool, ps)
                + handoff)

    def plan_bytes(self, unit: StemUnitSpec,
                   scheds: Tuple[LayerSchedule, ...]) -> Optional[int]:
        return _max_claim(select_engine(m).plan_bytes(m, s)
                          for m, s in zip(unit.members, scheds))

    def stats(self, unit: StemUnitSpec, scheds: Tuple[LayerSchedule, ...],
              batch: int) -> Tuple[LayerExecStats, ...]:
        return tuple(
            dataclasses.replace(select_engine(m).stats(s, batch),
                                kernel=self.name)
            for m, s in zip(unit.members, scheds))

    def run(self, ctx: EngineContext, unit: StemUnitSpec,
            scheds: Tuple[LayerSchedule, ...], params: Params, x
            ) -> Tuple[torch.Tensor, Tuple[LayerExecStats, ...]]:
        cs, ps = scheds
        stats: List[LayerExecStats] = []
        y, _, st = select_engine(unit.conv).run(
            ctx, cs, params[unit.conv.name], x, True)
        stats.append(dataclasses.replace(st, kernel=self.name))
        y, _, st = select_engine(unit.pool).run(ctx, ps, {}, y, False)
        stats.append(dataclasses.replace(st, kernel=self.name))
        return y, tuple(stats)
