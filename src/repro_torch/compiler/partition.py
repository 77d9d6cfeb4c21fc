"""Cutting a compiled pipeline into device-local stage programs.

H2PIPE instantiates every layer engine on one die; the mesh analogue
pipelines the SAME compiled schedule across devices — stage ``s`` owns a
contiguous slice of the placed layer order (§V-B: pipeline order is
placement order) and streams its own weights, exactly like a
pseudo-channel feeding its region of the die.  This module is the
compiler stage that produces those slices:

:func:`partition_pipeline`
    Cuts ``CompiledPipeline.plan`` into ``n_stages`` contiguous
    :class:`StageProgram`\\ s, balanced by the per-layer cycle model
    (``LayerPlan.cycles_per_image`` — the same §II-B cost the
    parallelism allocator balances within a die) with an exact
    linear-partition DP.  Fused residual blocks are ATOMIC: the identity
    add spans the block, so a cut inside one would break the topology
    (``cnn_forward`` rejects such ranges too).

:class:`StagePartition`
    The result: per-stage layer ranges, cycles, Eq. 2 words and
    boundary activation shapes, plus the per-stage plan-vs-dispatch
    cross-check — :meth:`StagePartition.verify_eq2` builds one
    :class:`~repro_torch.compiler.pipeline.ExecutionReport` per stage
    from the sliced plan and the sliced stats template and hard-fails
    (:class:`~repro_torch.compiler.pipeline.Eq2MismatchError`) on any
    drift, so splitting the graph never loosens the Eq. 2 guarantee.

:func:`stage_forward_fns`
    The stage programs as callables: stage ``s`` runs its
    ``cnn_forward`` slice through the SAME compile-time engine bindings
    (``make_dispatchers``) the fused whole-net trace uses — the sharded
    executor dispatches heterogeneous per-stage engine tables, not a
    re-derived model.  The sharded engine captures the same walk, one
    CUDA graph a stage (``trace_fused(..., layer_range=...)``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, List, Optional, Sequence, Tuple

from repro_torch.compiler.engines import EngineContext
from repro_torch.configs.cnn import residual_blocks
from repro_torch.core import hbm_model, placement

if TYPE_CHECKING:                                      # pragma: no cover
    from repro_torch.compiler.pipeline import (CompiledPipeline,
                                               ExecutionReport)


class PartitionError(ValueError):
    """The (pipeline, n_stages) pair cannot be partitioned."""


@dataclass(frozen=True)
class StageProgram:
    """One device-local stage: a contiguous slice of the placed layer
    order, carrying the slice's modelled cost and Eq. 2 accounting."""

    stage: int
    layer_range: Tuple[int, int]      # [start, stop) into cfg.layers
    layers: Tuple[str, ...]           # layer names, pipeline order
    cycles: int                       # sum of members' cycles_per_image
    hbm_words_per_image: int          # Eq. 2 words of streamed members


@dataclass(frozen=True)
class StagePartition:
    """A compiled pipeline cut into ``n_stages`` stage programs."""

    compiled: "CompiledPipeline"
    stages: Tuple[StageProgram, ...]

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def total_cycles(self) -> int:
        return sum(s.cycles for s in self.stages)

    @property
    def max_stage_cycles(self) -> int:
        return max(s.cycles for s in self.stages)

    @property
    def balance(self) -> float:
        """sum/max stage cycles — the pipeline's parallel efficiency
        ceiling (``n_stages`` when perfectly balanced)."""
        return self.total_cycles / self.max_stage_cycles

    def describe(self) -> str:
        rows = [f"{'stage':>5s} {'layers':>6s} {'cycles':>8s} "
                f"{'eq2 words/img':>13s}  members"]
        rows.append("-" * len(rows[0]))
        for s in self.stages:
            names = ",".join(s.layers[:4]) + ("..." if len(s.layers) > 4
                                              else "")
            rows.append(f"{s.stage:>5d} {len(s.layers):>6d} {s.cycles:>8d} "
                        f"{s.hbm_words_per_image:>13d}  {names}")
        return "\n".join(rows)

    # -- stage boundaries ----------------------------------------------------

    def boundary_shape(self, stage: int, microbatch: int
                       ) -> Tuple[int, int, int, int]:
        """The per-microbatch activation shape ENTERING ``stage``: the
        declared input geometry of the stage's first layer (config
        geometries are validated self-consistent by the builders)."""
        start, _ = self.stages[stage].layer_range
        spec = self.compiled.plan.cfg.layers[start]
        return (microbatch, spec.in_h, spec.in_w, spec.c_in)

    def out_shape(self, microbatch: int) -> Tuple[int, int]:
        return (microbatch, self.compiled.plan.cfg.num_classes)

    # -- modelled throughput (the deterministic benchmark numbers) -----------

    def modelled_throughput(self, round_microbatches: int,
                            fabric_mhz: float = hbm_model.FABRIC_MHZ
                            ) -> dict:
        """§VI-style modelled serving throughput of the staged pipeline
        vs the same schedule on one device — purely from the cycle model
        and the M + S - 1 fill law (``pipeline_stats``), so the numbers
        are deterministic and diff-gateable (wall clocks on a shared
        host cannot expose device parallelism; the model is the claim,
        as for the single-die §VI numbers).

        Stage time is ``max_stage_cycles`` (the slowest stage paces the
        ring); a round of M microbatches completes in M + S - 1 stage
        times, against M whole-net times for the 1-stage baseline:
        speedup = balance * M / (M + S - 1).
        """
        M = round_microbatches
        S = self.n_stages
        rate = fabric_mhz * 1e6 * placement.PIPELINE_EFF
        sharded = rate * M / ((M + S - 1) * self.max_stage_cycles)
        one_stage = rate / self.total_cycles
        return {
            "round_microbatches": M,
            "n_stages": S,
            "max_stage_cycles": self.max_stage_cycles,
            "total_cycles": self.total_cycles,
            "balance": self.balance,
            "sharded_images_per_s": sharded,
            "one_stage_images_per_s": one_stage,
            "sharded_speedup_x": sharded / one_stage,
            "scaling_efficiency": sharded / one_stage / S,
        }

    # -- per-stage Eq. 2 cross-check -----------------------------------------

    def stage_report(self, stage: int, batch: int = 1) -> "ExecutionReport":
        """The :class:`ExecutionReport` stage ``stage`` will produce for
        ``batch`` images: the plan sliced to the stage's layers, the
        stats template sliced to the same range (template order is
        config order — fused blocks emit contiguous member stats), and
        the block units wholly owned by the stage.  ``.verify()`` on it
        is the per-stage plan-vs-dispatch Eq. 2 cross-check."""
        from repro_torch.compiler.pipeline import ExecutionReport
        cp = self.compiled
        start, stop = self.stages[stage].layer_range
        names = set(self.stages[stage].layers)
        subplan = dataclasses.replace(
            cp.plan, schedules=cp.plan.schedules[start:stop],
            placements=cp.plan.placements[start:stop])
        stage_blocks = tuple(b for b in cp.block_assignments
                             if set(b.members) <= names)
        stage_scans = tuple(g for g in cp.scan_assignments
                            if set(g.member_names) <= names)
        rep = ExecutionReport(plan=subplan, images=batch,
                              block_assignments=stage_blocks,
                              scan_assignments=stage_scans)
        rep.layers.extend(cp.stats_template(batch)[start:stop])
        return rep

    def verify_eq2(self, batch: int = 1) -> Tuple["ExecutionReport", ...]:
        """Hard-fail Eq. 2 verification over the SPLIT graph: every
        stage's report verifies (plan-vs-dispatch, per node and per
        fused block), the stage ranges tile the layer order exactly, and
        the per-stage words conserve the whole-plan total.  Returns the
        per-stage reports so callers can inspect the split accounting."""
        cp = self.compiled
        L = len(cp.plan.schedules)
        pos = 0
        for s in self.stages:
            if s.layer_range[0] != pos:
                raise PartitionError(
                    f"stage {s.stage} starts at {s.layer_range[0]}, "
                    f"expected {pos}: stages must tile the layer order")
            pos = s.layer_range[1]
        if pos != L:
            raise PartitionError(
                f"stages cover [0, {pos}) of {L} layers")
        reports = tuple(self.stage_report(s.stage, batch)
                        for s in self.stages)
        for rep in reports:
            rep.verify()
        whole = sum(cp.plan.hbm_words_per_image().values())
        split = sum(s.hbm_words_per_image for s in self.stages)
        if split != whole:
            raise PartitionError(
                f"per-stage Eq. 2 words ({split}) do not conserve the "
                f"whole-plan total ({whole})")
        return reports


# ---------------------------------------------------------------------------
# the partition pass
# ---------------------------------------------------------------------------


def _atomic_units(compiled: "CompiledPipeline") -> List[Tuple[int, int]]:
    """Contiguous [start, stop) index ranges that stage cuts must not
    split: scan groups are ONE unit (the run is one scan engine's body,
    a cut inside it would have to unroll the run), residual blocks
    (fused or not — the identity add spans the block either way) are
    one unit, fused non-residual units (the stem conv+pool pair) are
    one unit, everything else is its own."""
    cfg = compiled.plan.cfg
    owner = {}
    # coarsest granularity wins: claim scan groups first, then residual
    # blocks not inside one, then the remaining fused units (stem pair)
    for g in compiled.scan_assignments:
        for m in g.member_names:
            owner[m] = g.group
    for b in residual_blocks(cfg):
        for m in b.members:
            owner.setdefault(m.name, b.name)
    for ba in compiled.block_assignments:
        for m in ba.members:
            owner.setdefault(m, ba.block)
    units: List[Tuple[int, int]] = []
    names = [l.name for l in cfg.layers]
    i = 0
    while i < len(names):
        if names[i] in owner:
            unit = owner[names[i]]
            j = i
            while j < len(names) and owner.get(names[j]) == unit:
                j += 1
            units.append((i, j))
            i = j
        else:
            units.append((i, i + 1))
            i += 1
    return units


def _linear_partition(costs: Sequence[int], k: int) -> List[Tuple[int, int]]:
    """Exact contiguous k-way partition minimizing the max group sum
    (classic linear-partition DP — unit counts are ~dozens, so O(n^2 k)
    is instant)."""
    n = len(costs)
    pre = [0] * (n + 1)
    for i, c in enumerate(costs):
        pre[i + 1] = pre[i] + c
    inf = float("inf")
    best = [[inf] * (k + 1) for _ in range(n + 1)]
    cut = [[0] * (k + 1) for _ in range(n + 1)]
    best[0][0] = 0
    for s in range(1, k + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                v = max(best[j][s - 1], pre[i] - pre[j])
                if v < best[i][s]:
                    best[i][s] = v
                    cut[i][s] = j
    groups: List[Tuple[int, int]] = []
    i, s = n, k
    while s > 0:
        j = cut[i][s]
        groups.append((j, i))
        i, s = j, s - 1
    return list(reversed(groups))


def partition_pipeline(compiled: "CompiledPipeline",
                       n_stages: int) -> StagePartition:
    """Cut a compiled pipeline into ``n_stages`` balanced stage programs
    (see module docstring).  Raises :class:`PartitionError` when the
    request is infeasible (more stages than atomic units)."""
    if n_stages < 1:
        raise PartitionError(f"n_stages must be >= 1, got {n_stages}")
    units = _atomic_units(compiled)
    if n_stages > len(units):
        raise PartitionError(
            f"cannot cut {len(units)} atomic unit(s) (fused residual "
            f"blocks count as one) into {n_stages} non-empty stages; "
            f"use at most {len(units)} stages for "
            f"{compiled.plan.cfg.name!r}")
    cycles = [p.cycles_per_image for p in compiled.plan.placements]
    unit_costs = [sum(cycles[a:b]) for a, b in units]
    groups = _linear_partition(unit_costs, n_stages)

    plan = compiled.plan
    stages: List[StageProgram] = []
    for s, (ua, ub) in enumerate(groups):
        start, stop = units[ua][0], units[ub - 1][1]
        scheds = plan.schedules[start:stop]
        stages.append(StageProgram(
            stage=s,
            layer_range=(start, stop),
            layers=tuple(sc.spec.name for sc in scheds),
            cycles=sum(cycles[start:stop]),
            hbm_words_per_image=sum(sc.weight_words_per_image
                                    for sc in scheds if sc.streamed)))
    return StagePartition(compiled=compiled, stages=tuple(stages))


# ---------------------------------------------------------------------------
# stage programs as callables (what the sharded executor dispatches)
# ---------------------------------------------------------------------------


def stage_forward_fns(part: StagePartition, *, act_scale: float = 0.05,
                      collect: Optional[Sequence[list]] = None
                      ) -> List[Callable]:
    """One ``(params, x) -> y`` callable per stage: the stage's
    ``cnn_forward`` slice routed through the pipeline's compile-time
    engine bindings (the eager walk of its ``layer_range``; where it
    runs follows from the device of ``x``).  ``collect[s]`` (when
    given) receives stage ``s``'s :class:`LayerExecStats` on every call
    — the executed-side Eq. 2 counters the sharded engine cross-checks
    against the per-stage plan.
    """
    from repro_torch.compiler.pipeline import make_dispatchers
    from repro_torch.models.cnn import cnn_forward
    compiled = part.compiled
    cfg = compiled.plan.cfg
    ctx = EngineContext(act_scale=act_scale)
    fns: List[Callable] = []
    for s, sp in enumerate(part.stages):
        sink = None if collect is None else collect[s]
        dispatch, block_dispatch, scan_dispatch = make_dispatchers(
            compiled, ctx, sink)

        def fn(params, x, _range=sp.layer_range, _d=dispatch,
               _b=block_dispatch, _s=scan_dispatch):
            return cnn_forward(params, cfg, x, engine=_d, block_engine=_b,
                               scan_engine=_s, layer_range=_range)
        fns.append(fn)
    return fns
