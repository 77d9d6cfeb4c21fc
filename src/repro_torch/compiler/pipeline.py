"""``compile(cfg, target) -> CompiledPipeline`` — the staged H2PIPE compiler.

Each stage of the paper's flow is an explicit pass over explicit values
(the passes are the JAX package's, on the port's copies of the planning
modules, so both packages make the same decisions):

  1. **parallelism**   HPIPE balancing allocates (p_i, p_o) per layer under
                       ``target.tb_budget`` AI-TBs (§II-B);
  2. **placement**     hybrid selection (Eq. 1 order under the
                       pseudo-channel chain budget) picks the HBM-streamed
                       set until the on-chip remainder fits
                       ``target.bram_m20ks`` (Algorithm 1, §V-B), then
                       clockwise pseudo-channel assignment;
  3. **FIFO sizing**   last-stage + burst-matching depths from the measured
                       HBM latency/efficiency curves (§III/§IV-A), fused
                       into per-layer :class:`LayerSchedule`\\ s;
  4. **engine select** every graph node — convs, fc heads, and the pooling
                       nodes — is bound to a registered
                       :class:`~repro_torch.compiler.engines.LayerEngine`;
                       residual blocks whose members all land on conv
                       engines are bound as ONE unit to ``res_block_int8``,
                       the stem conv + maxpool pair to ``stem_pool_int8``,
                       and homogeneous block runs to
                       ``scanned_res_block_int8``;
  5. **validation**    each binding's working set is checked against
                       ``target.vmem_bytes``; a pinned layer that does not
                       fit is re-placed to the HBM tier when its streamed
                       working set does, and layers that fit in neither
                       tier abort with :class:`TargetBudgetError`;
  6. **trace**         per (input shape, dtype, device, act_scale) and, on
                       the card, per params: the whole engine table walked
                       over ``models.cnn.cnn_forward`` once more and
                       captured into ONE ``torch.cuda.CUDAGraph``, so a
                       warm ``run()`` is a single graph replay, not a
                       Python walk over ~50 kernel launches.  The capture
                       also yields the run's :class:`LayerExecStats`, the
                       template every warm run's report is built from.
                       Traces live in a bounded LRU on the pipeline
                       (``trace_cache_size``).  On the CPU the "trace" is
                       the eager walk itself.

The result is immutable and reusable: ``CompiledPipeline.run()`` executes
it, on the card by default (``repro_torch.runtime.pipeline``), through the
fused trace unless ``backend="eager"`` asks for the walk;
``engine_table()``/``vmem_report()``/``block_table()`` expose the
decisions, ``with_offload()`` recompiles with a forced offload set,
``eq2_report().verify()`` cross-checks the plan's Eq. 2 words against
what the engines report, ``serve()`` starts a CNN serving engine.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.compiler.engines import (  # noqa: F401 (re-export)
    EngineContext, LayerExecStats, get_engine, select_block_engine,
    select_engine, select_scan_engine, select_stem_engine)
from repro_torch.compiler.target import NX2100, Target
from repro_torch.configs.cnn import (CNNConfig, ResBlockSpec, StemUnitSpec,
                                     residual_blocks, stem_unit)
from repro_torch.core import fifo_sim, hbm_model, placement
from repro_torch.core.schedule import (HBM, PINNED, LayerSchedule,
                                       PipelinePlan, detect_scan_groups)
from repro_torch.kernels import _build
from repro_torch.models.cnn import cnn_forward
from repro_torch.obs.metrics import default_registry


@contextlib.contextmanager
def _pass_timer(name: str):
    """Record one compile pass's wall seconds into the process-default
    metrics registry (``compile_pass_seconds{pass=<name>}``): always on
    (a clock read plus one histogram insert per pass)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        default_registry().histogram(
            "compile_pass_seconds", **{"pass": name}).observe(
                time.perf_counter() - t0)


class CompileError(ValueError):
    """A stage of ``compile()`` rejected the (config, target) pair."""


class Eq2MismatchError(RuntimeError):
    """The hard-fail Eq. 2 cross-check tripped: a run's (or template's)
    per-node streamed words disagree with the plan analytics, or a graph
    node never dispatched.  Either means the compiled bindings and the
    executed network have drifted — a correctness bug, never a tolerance
    issue (the comparison is exact integers)."""


class TargetBudgetError(CompileError):
    """One or more layers exceed the target's working-set budget in the weight
    tier they were compiled to.  Carries the per-layer report so callers
    see the whole picture, not just the first offender."""

    def __init__(self, target: Target, report: Dict[str, int],
                 offenders: Sequence[str], reason: str):
        self.target = target
        self.vmem_report = dict(report)
        self.offenders = tuple(offenders)
        lines = [f"{name}: {report[name]} B" for name in offenders]
        super().__init__(
            f"target {target.name!r}: {len(offenders)} layer(s) exceed the "
            f"per-engine working-set budget ({target.vmem_bytes} B) {reason}: "
            + "; ".join(lines))


@dataclass(frozen=True)
class EngineAssignment:
    """The compile-time binding of one layer to one registered engine.
    ``block`` names the fused block unit owning the layer, when stage 4
    grouped it into one (the layer then dispatches at block granularity,
    under the block engine's name)."""

    layer: str
    engine: str                   # registry name (resolved at dispatch)
    mode: str                     # PINNED | HBM
    vmem_bytes: int               # working set the binding claims
    block: Optional[str] = None   # owning block unit, if any
    scan: Optional[str] = None    # owning scan group, if any


@dataclass(frozen=True)
class BlockAssignment:
    """One fused block unit: several layers bound to a single block
    engine, placed and costed together (the paper's engine granularity).
    """

    block: str                    # block name ("s0b0")
    engine: str                   # block engine registry name
    members: Tuple[str, ...]      # member layer names, config order
    vmem_bytes: int               # whole-unit working set
    hbm_words_per_image: int      # Eq. 2 words of the streamed members


@dataclass(frozen=True)
class ScanGroupAssignment:
    """One scanned block run: a shape- and schedule-homogeneous run of
    fused residual blocks bound to a scan engine.  Eq. 2 accounting stays
    per-block AND summed."""

    group: str                              # scan group name ("scan:a..b")
    engine: str                             # scan engine registry name
    blocks: Tuple[str, ...]                 # member block names, order
    members: Tuple[Tuple[str, ...], ...]    # per-block member layer names
    layer_range: Tuple[int, int]            # [start, stop) into cfg.layers
    vmem_bytes: int                         # whole-run working set
    hbm_words_per_block: int                # Eq. 2 words, one iteration
    hbm_words_per_image: int                # Eq. 2 words, whole run

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def member_names(self) -> Tuple[str, ...]:
        """All member layer names across the run, config order."""
        return tuple(n for ms in self.members for n in ms)


@dataclass(frozen=True)
class FusedTrace:
    """One stage-6 artifact: the executable for a concrete input shape
    (on the card a captured CUDA graph, on the CPU the eager walk) plus
    the stats template its trace produced."""

    fn: Callable                  # (params, images) -> logits
    stats: Tuple[LayerExecStats, ...]


class _TraceCache:
    """The stage-6 trace cache: a bounded LRU keyed by (input shape,
    dtype, device, act_scale, params on the card) with hit/miss/eviction
    counters.

    ``get_or_create`` holds the lock across the whole check-create-insert
    sequence — a SINGLE critical section, not double-checked locking, so
    two threads missing on one key never both trace (the loser's work
    would be thrown away, or interleave with the eviction bookkeeping).
    Tracing under the lock serializes captures per pipeline, which is
    what ``run()`` wants: concurrent first calls on one shape share ONE
    trace.  An evicted entry is dropped here: its graph goes with its
    last holder, and the next capture empties the allocator's cache,
    which frees the graph's private pool."""

    def __init__(self, max_entries: int):
        if max_entries < 1:
            raise ValueError(f"trace cache needs >= 1 entry, "
                             f"got {max_entries}")
        self.max_entries = max_entries
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get_or_create(self, key, factory: Callable[[], Any]):
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self.hits += 1
                self._entries.move_to_end(key)
                return hit
            self.misses += 1
            value = self._entries[key] = factory()
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1
            return value

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries),
                    "max_entries": self.max_entries,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions}


@dataclass(frozen=True)
class CompiledPipeline:
    """An executable, validated pipeline: plan + engine bindings + target."""

    plan: PipelinePlan
    target: Optional[Target]
    assignments: Tuple[EngineAssignment, ...]
    replaced: Tuple[str, ...] = ()    # layers stage 5 moved pin -> stream
    block_assignments: Tuple[BlockAssignment, ...] = ()
    scan_assignments: Tuple[ScanGroupAssignment, ...] = ()
    #: bound on distinct stage-6 traces held live (LRU beyond it); see
    #: ``trace_cache_stats``.
    trace_cache_size: int = 8

    def __post_init__(self):
        # the stage-6 trace cache is created EAGERLY (not via
        # cached_property, whose lazy first evaluation races on
        # Python >= 3.12) so concurrent run()s on a fresh pipeline
        # always see the same cache and the same lock.  Frozen
        # dataclasses permit object.__setattr__ into __dict__.
        object.__setattr__(self, "_fused_cache",
                           _TraceCache(self.trace_cache_size))

    # -- introspection ------------------------------------------------------

    def engine_table(self) -> Dict[str, str]:
        """layer name -> registered engine name, in pipeline order."""
        return {a.layer: a.engine for a in self.assignments}

    def block_table(self) -> Dict[str, Tuple[str, ...]]:
        """fused block unit -> member layer names, in pipeline order."""
        return {b.block: b.members for b in self.block_assignments}

    def block_for(self, name: str) -> Optional[BlockAssignment]:
        """The block unit a block (or member layer) name belongs to."""
        return self._block_index.get(name)

    @functools.cached_property
    def _block_index(self) -> Dict[str, BlockAssignment]:
        idx: Dict[str, BlockAssignment] = {}
        for b in self.block_assignments:
            idx[b.block] = b
            for m in b.members:
                idx[m] = b
        return idx

    def scan_table(self) -> Dict[str, Tuple[str, ...]]:
        """scan group -> member block names, in pipeline order."""
        return {g.group: g.blocks for g in self.scan_assignments}

    def scan_for(self, name: str) -> Optional[ScanGroupAssignment]:
        """The scan group a group / block / member layer name belongs to."""
        return self._scan_index.get(name)

    @functools.cached_property
    def _scan_index(self) -> Dict[str, ScanGroupAssignment]:
        idx: Dict[str, ScanGroupAssignment] = {}
        for g in self.scan_assignments:
            idx[g.group] = g
            for b in g.blocks:
                idx[b] = g
            for m in g.member_names:
                idx[m] = g
        return idx

    @functools.cached_property
    def _unit_index(self) -> Dict[str, Union[ResBlockSpec, StemUnitSpec]]:
        """unit name -> the spec it fuses: every residual block by name,
        plus the stem unit (keyed by its conv's name) when the config
        has one — what ``stats_template`` and the scan dispatch use to
        recover the spec a :class:`BlockAssignment` binds."""
        idx: Dict[str, Union[ResBlockSpec, StemUnitSpec]] = {
            b.name: b for b in residual_blocks(self.plan.cfg)}
        su = stem_unit(self.plan.cfg)
        if su is not None:
            idx[su.name] = su
        return idx

    def vmem_report(self) -> Dict[str, int]:
        """layer name -> working-set bytes of its engine binding."""
        return {a.layer: a.vmem_bytes for a in self.assignments}

    def assignment_for(self, name: str) -> Optional[EngineAssignment]:
        return self._assignment_index.get(name)

    @functools.cached_property
    def _assignment_index(self) -> Dict[str, EngineAssignment]:
        """name -> assignment map (cached_property writes straight into
        ``__dict__``, which frozen dataclasses permit)."""
        return {a.layer: a for a in self.assignments}

    def describe(self) -> str:
        """Human-readable engine table (what runs where, before it runs)."""
        hdr = f"{'layer':12s} {'kind':7s} {'tier':7s} {'engine':14s} " \
              f"{'vmem':>10s}  pc"
        rows = [hdr, "-" * len(hdr)]
        for s, a in zip(self.plan.schedules, self.assignments):
            pc = f"PC{s.pc}" if s.pc is not None else "-"
            rows.append(f"{a.layer:12s} {s.spec.kind:7s} {a.mode:7s} "
                        f"{a.engine:14s} {a.vmem_bytes:>10d}  {pc}")
        return "\n".join(rows)

    # -- plan conveniences --------------------------------------------------

    @property
    def cfg(self) -> CNNConfig:
        return self.plan.cfg

    @property
    def schedules(self) -> Tuple[LayerSchedule, ...]:
        return self.plan.schedules

    @property
    def streamed_names(self) -> Tuple[str, ...]:
        return self.plan.streamed_names

    def hbm_words_per_image(self) -> Dict[str, int]:
        return self.plan.hbm_words_per_image()

    def throughput(self) -> Dict[str, float]:
        return self.plan.throughput()

    def predict_stalls(self, outputs_needed: int = 32,
                       word_scale: Optional[int] = None
                       ) -> fifo_sim.SimOutcome:
        return self.plan.predict_stalls(outputs_needed, word_scale)

    def with_offload(self, names: Sequence[str]) -> "CompiledPipeline":
        """Recompile (engine selection + validation) with the offload set
        forced to exactly ``names``.  The forced set is honored verbatim:
        stage 5 does NOT re-place layers here — a forced-pinned layer
        that exceeds the target's working-set budget raises
        :class:`TargetBudgetError` instead of silently streaming."""
        return finalize(self.plan.with_offload(names), self.target,
                        replace=False,
                        trace_cache_size=self.trace_cache_size)

    # -- execution ----------------------------------------------------------

    def executor(self, *, device="cuda", act_scale: float = 0.05,
                 backend: str = "fused"):
        from repro_torch.runtime.pipeline import PipelineExecutor
        return PipelineExecutor(self, device=device, act_scale=act_scale,
                                backend=backend)

    def run(self, params, images, *, device="cuda", backend: str = "fused"):
        """One-shot: (logits, ExecutionReport) for ``images``, on
        ``device`` (the card unless the caller asks for the CPU)."""
        return self.executor(device=device,
                             backend=backend).run(params, images)

    def serve(self, params, *, microbatch: int = 8, credits: int = 4, **kw):
        """Continuous-streaming serving over this pipeline: a
        :class:`~repro_torch.runtime.cnn_serving.CnnServingEngine` packing
        mixed-size requests into ``microbatch``-shaped fused dispatches,
        at most ``credits`` microbatches in flight (§V-A).  Use as a
        context manager, or call ``.start()``."""
        from repro_torch.runtime.cnn_serving import CnnServingEngine
        return CnnServingEngine(self, params, microbatch=microbatch,
                                credits=credits, **kw)

    # -- Eq. 2 template + hard-fail cross-check -----------------------------

    def stats_template(self, batch: int = 1) -> Tuple[LayerExecStats, ...]:
        """The shape-static :class:`LayerExecStats` sequence one run of
        ``batch`` images WILL report, assembled from the bound engines'
        ``stats`` accounting in dispatch order — no execution.
        Block-owned layers report under their block engine's name, same
        as the fused unit's ``run``; equality with an actual report's
        ``layers`` is pinned by test."""
        units = self._unit_index
        out: List[LayerExecStats] = []
        emitted = set()
        for a, s in zip(self.assignments, self.plan.schedules):
            if a.scan is not None:
                # scanned run: the scan engine owns EVERY member of EVERY
                # block in the run (summed-and-per-iteration Eq. 2 words);
                # the run is contiguous in config order, so emit it whole
                # at its first member
                if a.scan in emitted:
                    continue
                emitted.add(a.scan)
                g = self.scan_for(a.scan)
                out.extend(get_engine(g.engine).stats(
                    [units[b] for b in g.blocks],
                    [self.plan.schedules_for(ms) for ms in g.members],
                    batch))
            elif a.block is not None:
                # fused unit (residual block or stem pair): the unit
                # engine owns its members' stats accounting (ONE source —
                # the same method its run mirrors); members are
                # contiguous in config order, so emit the whole unit at
                # its first member
                if a.block in emitted:
                    continue
                emitted.add(a.block)
                basn = self.block_for(a.block)
                scheds = self.plan.schedules_for(basn.members)
                out.extend(get_engine(basn.engine).stats(
                    units[a.block], scheds, batch))
            else:
                out.append(get_engine(a.engine).stats(s, batch))
        return tuple(out)

    def eq2_report(self, batch: int = 1) -> "ExecutionReport":
        """An :class:`ExecutionReport` built from ``stats_template`` —
        what a run of ``batch`` images will report, without executing.
        ``eq2_report().verify()`` is the whole-net plan-vs-dispatch
        Eq. 2 cross-check at compile time."""
        rep = ExecutionReport(plan=self.plan, images=batch,
                              block_assignments=self.block_assignments,
                              scan_assignments=self.scan_assignments)
        rep.layers.extend(self.stats_template(batch))
        return rep

    # -- stage 6: the fused whole-pipeline trace ----------------------------
    # _fused_cache: a bounded-LRU :class:`_TraceCache`, created in
    # __post_init__ so it lives with the pipeline and every executor (and
    # thread) shares the captures.

    @property
    def trace_count(self) -> int:
        """How many distinct traces stage 6 holds LIVE — a warm shape must
        NOT retrace (tested); bounded by ``trace_cache_size`` (LRU beyond
        it)."""
        return len(self._fused_cache)

    def trace_cache_stats(self) -> Dict[str, int]:
        """Stage-6 trace cache counters: ``entries`` / ``max_entries`` /
        ``hits`` / ``misses`` / ``evictions``.  Surfaced by
        :class:`~repro_torch.runtime.cnn_serving.ServingReport` so serving
        exposes whether its shape population thrashes the bound."""
        return self._fused_cache.stats()

    def fused_trace(self, params, images, *,
                    act_scale: float) -> FusedTrace:
        """The stage-6 artifact for this input: on the card one CUDA
        graph of the whole engine table over ``cnn_forward``, bound to
        ``params`` (the graph holds their addresses), plus the stats
        template collected while capturing it.  Cached in a bounded LRU
        (``trace_cache_size`` entries); the fill is ONE critical section,
        so concurrent ``run()``\\ s on one pipeline share a single
        capture."""
        return self.fused_trace_and_first(params, images, act_scale)[0]

    def fused_trace_and_first(self, params, images, act_scale: float):
        """(trace, logits): the logits of the forward a miss's trace ran
        on ``images`` (checked against the eager walk on the card), or
        None on a hit, so the first run of a shape does not run twice."""
        leaves = _params_leaves(params) if images.is_cuda else ()
        key = (tuple(images.shape), str(images.dtype), str(images.device),
               act_scale, tuple(t.data_ptr() for t in leaves))
        first = None

        def _traced():
            nonlocal first
            with _pass_timer("trace_fused"):
                trace, first = trace_fused(self, params, images,
                                           act_scale=act_scale)
            return trace

        out = self._fused_cache.get_or_create(key, _traced)
        reg = default_registry()
        for k, v in self._fused_cache.stats().items():
            reg.gauge("compile_trace_cache", counter=k).set(v)
        return out, first


@dataclass
class ExecutionReport:
    """What one execution did, cross-checked three ways (executed Eq. 2
    words at dispatch, the plan's analytic words, the §V-A fifo_sim).
    ``block_assignments`` carries the compile-time fused-block units so
    Eq. 2 traffic is reportable at block granularity too (fused
    ``res_block_int8`` units as first-class rows, not just their member
    layers)."""

    plan: PipelinePlan
    images: int = 0
    layers: list = dataclasses.field(default_factory=list)  # LayerExecStats
    block_assignments: Tuple["BlockAssignment", ...] = ()
    scan_assignments: Tuple["ScanGroupAssignment", ...] = ()

    @property
    def hbm_weight_words(self) -> Dict[str, int]:
        """Total streamed weight words per layer for the whole batch."""
        out: Dict[str, int] = {}
        for st in self.layers:
            if st.mode == HBM:
                out[st.name] = out.get(st.name, 0) + st.hbm_words
        return out

    @property
    def total_hbm_words(self) -> int:
        return sum(self.hbm_weight_words.values())

    @property
    def streamed_layer_count(self) -> int:
        return len({st.name for st in self.layers if st.mode == HBM})

    def engines_used(self) -> Dict[str, str]:
        """layer -> engine that actually ran (must equal the compile-time
        engine_table for layers the pipeline dispatched)."""
        return {st.name: st.kernel for st in self.layers}

    def block_rows(self) -> List[Dict[str, Any]]:
        """Block-granular Eq. 2 rows: one per fused block unit, with the
        EXECUTED streamed words of its members (from the dispatch
        counters) against the plan-side ``hbm_words_per_image`` the
        :class:`BlockAssignment` claims — the same executed-vs-analytic
        cross-check the per-layer report makes, at engine granularity."""
        executed = self.hbm_weight_words
        rows: List[Dict[str, Any]] = []
        for b in self.block_assignments:
            words = sum(executed.get(m, 0) for m in b.members)
            rows.append({
                "block": b.block,
                "engine": b.engine,
                "members": list(b.members),
                "hbm_words": words,
                "hbm_words_per_image": words // self.images
                if self.images else 0,
                "plan_hbm_words_per_image": b.hbm_words_per_image,
            })
        return rows

    @property
    def hbm_block_words(self) -> Dict[str, int]:
        """Executed streamed words per fused block unit, whole batch."""
        return {r["block"]: r["hbm_words"] for r in self.block_rows()}

    def scan_rows(self) -> List[Dict[str, Any]]:
        """Scan-group Eq. 2 rows: one per scanned block run, with the
        EXECUTED streamed words summed over the run AND per iteration
        (per member block), against the plan-side per-block and whole-run
        words the :class:`ScanGroupAssignment` claims.  The per-iteration
        column is what proves the scan did not collapse the accounting:
        every block of the run streams its own weights, homogeneously."""
        executed = self.hbm_weight_words
        rows: List[Dict[str, Any]] = []
        for g in self.scan_assignments:
            per_block = [sum(executed.get(m, 0) for m in ms)
                         for ms in g.members]
            rows.append({
                "group": g.group,
                "engine": g.engine,
                "blocks": list(g.blocks),
                "n_blocks": g.n_blocks,
                "hbm_words": sum(per_block),
                "hbm_words_per_block": per_block,
                "plan_hbm_words_per_block": g.hbm_words_per_block,
                "plan_hbm_words_per_image": g.hbm_words_per_image,
            })
        return rows

    def verify(self) -> "ExecutionReport":
        """HARD-FAIL Eq. 2 cross-check over the whole topology: every
        graph node dispatched exactly once per image, executed streamed
        words equal to the plan's ``weight_words_per_image`` analytics
        per node AND per fused block unit — exact integer equality,
        raising :class:`Eq2MismatchError` on the first drift.  Returns
        self so call sites can chain it."""
        names = [s.spec.name for s in self.plan.schedules]
        dispatched = {st.name for st in self.layers}
        missing = [n for n in names if n not in dispatched]
        if missing:
            raise Eq2MismatchError(
                f"{len(missing)} graph node(s) never dispatched: {missing}")
        # only nonzero demands: a (caller-forced) streamed zero-word node
        # never shows up in the HBM-mode dispatch counters, and zero
        # words planned == zero words executed is agreement, not drift
        expected = {n: w * self.images
                    for n, w in self.plan.hbm_words_per_image().items()
                    if w > 0}
        got = self.hbm_weight_words
        if got != expected:
            drift = {n: (expected.get(n), got.get(n))
                     for n in set(expected) | set(got)
                     if expected.get(n) != got.get(n)}
            raise Eq2MismatchError(
                f"executed Eq. 2 words != plan analytics "
                f"(plan, executed): {drift}")
        for row in self.block_rows():
            want = row["plan_hbm_words_per_image"] * self.images
            if row["hbm_words"] != want:
                raise Eq2MismatchError(
                    f"block {row['block']}: executed {row['hbm_words']} "
                    f"words != plan {want}")
        for row in self.scan_rows():
            want = row["plan_hbm_words_per_image"] * self.images
            if row["hbm_words"] != want:
                raise Eq2MismatchError(
                    f"scan group {row['group']}: executed "
                    f"{row['hbm_words']} words != plan {want}")
            per = row["plan_hbm_words_per_block"] * self.images
            for blk, w in zip(row["blocks"], row["hbm_words_per_block"]):
                if w != per:
                    raise Eq2MismatchError(
                        f"scan group {row['group']} iteration {blk}: "
                        f"executed {w} words != plan {per} (the scanned "
                        f"body must stream every iteration's weights)")
        return self

    def fifo_prediction(self, outputs_needed: int = 32,
                        word_scale: Optional[int] = None
                        ) -> fifo_sim.SimOutcome:
        """§V-A credit-mode stall/delivery prediction for the streamed set."""
        return self.plan.predict_stalls(outputs_needed, word_scale)

    def modelled_throughput(self) -> Dict[str, float]:
        return self.plan.throughput()


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------


def plan_pipeline(cfg: CNNConfig, target: Target) -> PipelinePlan:
    """Stages 1-3: parallelism, placement, FIFO sizing — the executable
    :class:`PipelinePlan` (no engine bindings yet)."""
    with _pass_timer("parallelism"):
        plans = placement.allocate_parallelism(cfg, target.tb_budget)
    with _pass_timer("placement"):
        plans = placement.hybrid_selection(plans, target.bram_m20ks,
                                           n_pc=target.n_pc,
                                           burst=target.burst)
        placement.assign_pseudo_channels(plans, n_pc=target.n_pc)

    with _pass_timer("fifo_sizing"):
        laststage = hbm_model.min_laststage_fifo_depth(target.burst)
        bm_words = hbm_model.burst_matching_fifo_words(target.burst)
        schedules = tuple(
            LayerSchedule(
                spec=p.spec,
                mode=HBM if p.offload else PINNED,
                p_i=p.p_i, p_o=p.p_o, pc=p.pc,
                burst=target.burst,
                laststage_fifo_depth=laststage,
                bm_fifo_words=bm_words,
                n_buffers=target.n_buffers,
            ) for p in plans)
        out = PipelinePlan(cfg=cfg, schedules=schedules,
                           placements=tuple(plans), burst=target.burst,
                           n_pc=target.n_pc)
    return out


def finalize(plan: PipelinePlan, target: Optional[Target], *,
             replace: bool = True, scan: bool = True,
             trace_cache_size: int = 8) -> CompiledPipeline:
    """Stages 4-5 over an existing plan: bind every layer to a registered
    engine, then enforce the target's working-set budget — re-placing pinned
    layers whose working set only fits when streamed, and raising
    :class:`TargetBudgetError` for layers that fit in neither tier.

    ``scan=False`` disables scan-group binding (every block then runs
    as its own unit).  ``trace_cache_size`` bounds the stage-6 LRU trace
    cache.

    Re-placement respects Algorithm 1's hard feasibility constraint: a
    move consumes the layer's ``p_i * p_o`` tensor-chain feeds from the
    target's pseudo-channel pool, and layers the pool cannot feed stay
    pinned (and fail validation) rather than silently oversubscribing
    the HBM bandwidth the throughput model assumes.

    ``replace=False`` keeps the plan's tier decisions verbatim (used by
    ``with_offload``: a caller-forced offload set must not be silently
    expanded — validation fails instead).  ``target=None`` binds engines
    without budget enforcement (the deprecation-compat path for raw
    ``PipelinePlan`` values).
    """
    # engine choice depends only on the spec, so bind once per layer and
    # reuse across the re-placement and assignment passes
    engines = {s.spec.name: select_engine(s.spec) for s in plan.schedules}

    moved = []
    if target is not None and replace:
        free_bw = target.chain_budget - sum(
            s.p_i * s.p_o for s in plan.streamed)
        for s in plan.schedules:
            eng = engines[s.spec.name]
            if s.streamed or eng.vmem_bytes(s.spec, s) <= target.vmem_bytes:
                continue
            streamed = dataclasses.replace(s, mode=HBM)
            chains = s.p_i * s.p_o
            if eng.vmem_bytes(s.spec, streamed) <= target.vmem_bytes \
                    and chains <= free_bw:
                moved.append(s.spec.name)
                free_bw -= chains
        if moved:
            plan = plan.with_offload(
                set(plan.streamed_names) | set(moved))

    # engines that cannot source weights from HBM (jnp_ref) must not hold
    # the HBM tier, or plan analytics/fifo_sim would charge Eq. 2 traffic
    # that never executes: demote compile-chosen placements to pinned,
    # reject caller-forced ones loudly.
    unstreamable = [s.spec.name for s in plan.streamed
                    if not getattr(engines[s.spec.name], "can_stream", True)]
    if unstreamable:
        if not replace:
            raise CompileError(
                f"layer(s) {unstreamable} are bound to engines that cannot "
                f"stream weights from HBM; remove them from the forced "
                f"offload set")
        plan = plan.with_offload(
            set(plan.streamed_names) - set(unstreamable))

    assignments = []
    offenders = []
    for s in plan.schedules:
        eng = engines[s.spec.name]
        vb = eng.vmem_bytes(s.spec, s)
        assignments.append(EngineAssignment(
            layer=s.spec.name, engine=eng.name, mode=s.mode, vmem_bytes=vb))
        if target is not None and vb > target.vmem_bytes:
            offenders.append(s.spec.name)
    if offenders:
        reason = ("in every feasible weight tier (pinned over budget; HBM "
                  "tier over budget or out of pseudo-channel bandwidth)"
                  if replace else
                  "in their forced weight tier (re-placement disabled by "
                  "with_offload)")
        raise TargetBudgetError(
            target, {a.layer: a.vmem_bytes for a in assignments}, offenders,
            reason)

    # residual blocks whose members all sit on conv engines become
    # ONE schedulable unit under a block engine (the paper's granularity:
    # an engine is a block of fabric).  The unit claims the sum of its
    # members' working sets + the identity buffer; when that exceeds the
    # target's ceiling, the block simply keeps per-layer bindings.
    blocks: List[BlockAssignment] = []
    by_layer = {a.layer: i for i, a in enumerate(assignments)}
    for blk in residual_blocks(plan.cfg):
        beng = select_block_engine(blk)
        if beng is None:
            continue
        scheds = plan.schedules_for([m.name for m in blk.members])
        vb = beng.vmem_bytes(blk, scheds)
        if target is not None and vb > target.vmem_bytes:
            continue
        blocks.append(BlockAssignment(
            block=blk.name, engine=beng.name,
            members=tuple(m.name for m in blk.members), vmem_bytes=vb,
            hbm_words_per_image=sum(s.weight_words_per_image
                                    for s in scheds if s.streamed)))
        for m in blk.members:
            i = by_layer[m.name]
            assignments[i] = dataclasses.replace(
                assignments[i], engine=beng.name, block=blk.name)

    # the stem conv + following maxpool pair rides the same block-unit
    # machinery: one BlockAssignment, one working-set cost, members dispatching
    # under the stem engine's name.  Over budget (or members not on the
    # fused engines) -> per-layer bindings, like any block.
    su = stem_unit(plan.cfg)
    if su is not None:
        seng = select_stem_engine(su)
        if seng is not None:
            scheds = plan.schedules_for([m.name for m in su.members])
            vb = seng.vmem_bytes(su, scheds)
            if target is None or vb <= target.vmem_bytes:
                blocks.append(BlockAssignment(
                    block=su.name, engine=seng.name,
                    members=tuple(m.name for m in su.members),
                    vmem_bytes=vb,
                    hbm_words_per_image=sum(s.weight_words_per_image
                                            for s in scheds if s.streamed)))
                for m in su.members:
                    i = by_layer[m.name]
                    assignments[i] = dataclasses.replace(
                        assignments[i], engine=seng.name, block=su.name)

    # scan-group binding: homogeneous runs of block-bound residual blocks
    # (same shapes, same schedules, same block engine) become ONE unit
    # whose Eq. 2 accounting stays per block.
    scans: List[ScanGroupAssignment] = []
    if scan:
        basn_by_name = {b.block: b for b in blocks}
        blk_specs = {b.name: b for b in residual_blocks(plan.cfg)}
        for g in detect_scan_groups(plan):
            basns = [basn_by_name.get(bn) for bn in g.blocks]
            if any(b is None for b in basns):
                continue                  # some block fell back per-layer
            if len({b.engine for b in basns}) != 1:
                continue                  # mixed block engines: no one body
            group_blocks = [blk_specs[bn] for bn in g.blocks]
            sceng = select_scan_engine(group_blocks)
            if sceng is None:
                continue
            scheds_pb = [plan.schedules_for(ms) for ms in g.members]
            vb = sceng.vmem_bytes(group_blocks, scheds_pb)
            if target is not None and vb > target.vmem_bytes:
                continue                  # stacked weights over budget
            per_block = sum(s.weight_words_per_image
                            for s in scheds_pb[0] if s.streamed)
            scans.append(ScanGroupAssignment(
                group=g.name, engine=sceng.name, blocks=g.blocks,
                members=g.members, layer_range=g.layer_range,
                vmem_bytes=vb, hbm_words_per_block=per_block,
                hbm_words_per_image=per_block * g.n_blocks))
            for ms in g.members:
                for m in ms:
                    i = by_layer[m]
                    assignments[i] = dataclasses.replace(
                        assignments[i], engine=sceng.name, scan=g.name)

    return CompiledPipeline(plan=plan, target=target,
                            assignments=tuple(assignments),
                            replaced=tuple(moved),
                            block_assignments=tuple(blocks),
                            scan_assignments=tuple(scans),
                            trace_cache_size=trace_cache_size)


def make_dispatchers(compiled: CompiledPipeline, ctx: EngineContext,
                     collect: Optional[List[LayerExecStats]]
                     ) -> Tuple[Callable, Callable, Callable]:
    """The (layer, block, scan) dispatch hooks ``cnn_forward`` routes
    through: each offered layer/block/run executes on its compile-time
    binding, with the returned :class:`LayerExecStats` appended to
    ``collect``."""
    plan = compiled.plan

    def dispatch(spec, p, x, relu: bool):
        asn = compiled.assignment_for(spec.name)
        if asn is None or asn.block is not None:
            # unknown to the plan, or owned by a fused block unit (the
            # block hook handles it) -> decline, the plain path runs it
            return None
        y_q, y_f, st = get_engine(asn.engine).run(
            ctx, plan.schedule_for(spec.name), p, x, relu)
        if collect is not None:
            collect.append(st)
        return y_q, y_f

    def block_dispatch(block, params, x):
        basn = compiled.block_for(block.name)
        if basn is None:
            return None
        scheds = plan.schedules_for(basn.members)
        y, stats = get_engine(basn.engine).run(ctx, block, scheds, params, x)
        if collect is not None:
            collect.extend(stats)
        return y

    def scan_dispatch(block, params, x, limit: int):
        # offered at every residual block's lead conv: accept only when
        # this block LEADS a bound scan group and the whole run fits the
        # active layer_range (partitioning keeps groups atomic, so a
        # truncated offer means a caller-forced odd range — decline and
        # let per-block execution cover it, bit-identically)
        g = compiled.scan_for(block.name)
        if g is None or g.blocks[0] != block.name:
            return None
        n = len(g.member_names)
        if n > limit:
            return None
        blocks = [compiled._unit_index[bn] for bn in g.blocks]
        scheds = [plan.schedules_for(ms) for ms in g.members]
        y, stats = get_engine(g.engine).run(ctx, blocks, scheds, params, x)
        if collect is not None:
            collect.extend(stats)
        return y, n

    return dispatch, block_dispatch, scan_dispatch


def walk(compiled: CompiledPipeline, params, images, *, act_scale: float,
         collect: Optional[List[LayerExecStats]]):
    """The eager walk: ``cnn_forward`` over the compile-time bindings,
    each engine launching its kernels from Python, stats appended to
    ``collect``."""
    ctx = EngineContext(act_scale=act_scale)
    dispatch, block_dispatch, scan_dispatch = make_dispatchers(
        compiled, ctx, collect)
    return cnn_forward(params, compiled.plan.cfg, images, engine=dispatch,
                       block_engine=block_dispatch,
                       scan_engine=scan_dispatch)


def _params_leaves(params) -> Tuple[torch.Tensor, ...]:
    """Every tensor of a CNN params tree, in the tree's order."""
    return tuple(t for layer in params.values() for t in layer.values())


# captures one at a time in the process: each on a stream of its own,
# relaxed, so other threads' CUDA calls (a completer's copies) may go on
_CAPTURE_LOCK = threading.Lock()


class _GraphTrace:
    """A forward captured as one CUDA graph: static input, static output,
    the params it was captured with (held, so no freed address is reused
    under a live graph) and the launches the capture recorded.

    A call copies the images into the static input, replays, and returns
    a clone of the static output, so a later call never overwrites logits
    a caller holds; ``params`` is not read, since the trace key names the
    captured ones.  Calls are serialised per trace under a lock, and a
    caller's stream first waits on the previous call's event, since the
    static buffers are shared by every stream that replays them."""

    def __init__(self, graph, static_in, static_out, leaves, launches):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.leaves = leaves
        self.launches = launches
        self._lock = threading.Lock()
        self._done = torch.cuda.Event()

    def __call__(self, params, images):
        if images.shape != self.static_in.shape \
                or images.dtype != self.static_in.dtype \
                or images.device != self.static_in.device:
            raise ValueError(
                f"trace captured for {tuple(self.static_in.shape)} "
                f"{self.static_in.dtype} on {self.static_in.device}, got "
                f"{tuple(images.shape)} {images.dtype} on {images.device}")
        stream = torch.cuda.current_stream(images.device)
        with self._lock:
            stream.wait_event(self._done)
            self.static_in.copy_(images)
            self.graph.replay()
            out = self.static_out.clone()
            self._done.record(stream)
        _build.count_replay(self.launches)
        return out


def trace_fused(compiled: CompiledPipeline, params, images, *,
                act_scale: float):
    """Stage 6 for this input: ``(FusedTrace, logits)``.

    On the card: one eager forward first (every kernel built and its
    shared-memory attribute set before capture), then the walk captured
    into ONE ``torch.cuda.CUDAGraph`` over a static input of the images'
    shape (``capture_error_mode="relaxed"``: the launchers query the
    device and set attributes as they launch), with the stats of that
    capture as the template every warm run reports; a first replay on
    ``images`` must equal the eager forward bit for bit.  A failed
    capture or replay raises: nothing falls back to the eager walk.

    On the CPU the trace is the eager walk: it runs once here, on
    ``images``, for its stats, and its logits serve the call that asked.
    """
    stats: List[LayerExecStats] = []
    if not images.is_cuda:
        logits = walk(compiled, params, images, act_scale=act_scale,
                      collect=stats)

        def fn(p, x):
            return walk(compiled, p, x, act_scale=act_scale, collect=None)
        return FusedTrace(fn=fn, stats=tuple(stats)), logits

    dev = images.device
    with torch.cuda.device(dev):
        eager = walk(compiled, params, images, act_scale=act_scale,
                     collect=None)
        static_in = images.clone()
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            torch.cuda.synchronize(dev)
            # an evicted trace's private pool is freed only now, so that
            # churning through shapes keeps device memory bounded
            torch.cuda.empty_cache()
            with _build.capturing_launches() as launches:
                with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev),
                                      capture_error_mode="relaxed"):
                    static_out = walk(compiled, params, static_in,
                                      act_scale=act_scale, collect=stats)
        runner = _GraphTrace(graph, static_in, static_out,
                             _params_leaves(params), dict(launches))
        logits = runner(params, images)
        if not torch.equal(logits, eager):
            raise RuntimeError(
                "the captured forward's replay differs from the eager walk "
                f"for input {tuple(images.shape)}")
    return FusedTrace(fn=runner, stats=tuple(stats)), logits


def compile(cfg: CNNConfig, target: Target = NX2100, *,
            scan: bool = True, trace_cache_size: int = 8
            ) -> CompiledPipeline:
    """Compile a CNN for a target: passes 1-5 up front, validated and
    executable; the stage-6 fused trace is made (and cached) per input on
    first ``run()``.  ``scan=False`` binds no scan groups;
    ``trace_cache_size`` bounds the stage-6 LRU trace cache."""
    plan = plan_pipeline(cfg, target)
    with _pass_timer("finalize"):
        return finalize(plan, target, scan=scan,
                        trace_cache_size=trace_cache_size)
