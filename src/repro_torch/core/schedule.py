"""Executable pipeline schedule — Algorithm 1 fused with FIFO sizing.

The planner pieces each answer one question: ``placement`` decides *which*
layers stream weights from HBM (Eq. 1 / Algorithm 1) and how much
parallelism each engine gets; ``hbm_model`` sizes the FIFOs that make the
streams safe (§III-B/§IV-A); ``fifo_sim`` proves the flow control live
(§V-A).  The staged compiler (``repro_torch.compiler.compile``) fuses all three
into one *executable* schedule: per layer, the weight tier (pinned vs
HBM-streamed), the pseudo-channel, the burst length, and the
FIFO/double-buffer depths the runtime executor
(``repro_torch.runtime.pipeline``) instantiates as CUDA kernel
configurations.  This module owns the schedule *data model*
(:class:`LayerSchedule` / :class:`PipelinePlan`) plus the deprecated
``build_pipeline_plan`` shim; the passes themselves live in
``repro_torch.compiler.pipeline``.

Units: weight traffic is counted in 80-bit tensor-chain words (the
granularity a pseudo-channel feeds, §III-B); a streamed layer re-reads its
kernel once per output row (Eq. 2), so
``weight_words_per_image = weight_words_per_row * out_h``.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.cnn import CNNConfig, ConvLayerSpec
from repro_torch.core import fifo_sim, hbm_model, placement
from repro_torch.core.placement import CHAIN_BITS, LayerPlan

PINNED = "pinned"                 # weights resident on chip (M20K / VMEM)
HBM = "hbm"                       # weights double-buffer-streamed from HBM


@dataclass(frozen=True)
class LayerSchedule:
    """Everything the runtime needs to instantiate one layer engine."""

    spec: ConvLayerSpec
    mode: str                     # PINNED | HBM
    p_i: int
    p_o: int
    pc: Optional[int]             # pseudo-channel when streamed
    burst: int                    # HBM words per read request
    laststage_fifo_depth: int     # words; §IV-A latency-covering FIFO
    bm_fifo_words: int            # burst-matching SCFIFO depth
    n_buffers: int                # executable double-buffer ring depth

    @property
    def streamed(self) -> bool:
        return self.mode == HBM

    @property
    def weight_words_per_row(self) -> int:
        """80-bit chain words one weight re-read costs (Eq. 2 numerator)."""
        return -(-self.spec.weight_bits(8) // CHAIN_BITS)

    @property
    def weight_words_per_image(self) -> int:
        """Streamed layers re-read kernels once per output row (Eq. 2)."""
        return self.weight_words_per_row * self.spec.out_h


@dataclass(frozen=True)
class PipelinePlan:
    """The fused, executable schedule for one CNN."""

    cfg: CNNConfig
    schedules: Tuple[LayerSchedule, ...]
    placements: Tuple[LayerPlan, ...]     # Algorithm 1 output (read-only)
    burst: int
    n_pc: int

    @functools.cached_property
    def _schedule_index(self) -> Dict[str, LayerSchedule]:
        """name -> schedule map, built once per plan (plans are frozen;
        ``dataclasses.replace`` derivatives get a fresh cache)."""
        return {s.spec.name: s for s in self.schedules}

    def schedule_for(self, name: str) -> LayerSchedule:
        return self._schedule_index[name]

    def schedules_for(self, names: Sequence[str]
                      ) -> Tuple[LayerSchedule, ...]:
        """Member schedules of a fused unit (e.g. a residual block bound
        to one block engine), in the given order — the granularity the
        compiler costs and the block engines execute."""
        return tuple(self._schedule_index[n] for n in names)

    @property
    def streamed(self) -> Tuple[LayerSchedule, ...]:
        return tuple(s for s in self.schedules if s.streamed)

    @property
    def pinned(self) -> Tuple[LayerSchedule, ...]:
        return tuple(s for s in self.schedules if not s.streamed)

    @property
    def streamed_names(self) -> Tuple[str, ...]:
        return tuple(s.spec.name for s in self.streamed)

    def hbm_words_per_image(self) -> Dict[str, int]:
        """Eq. 2 weight traffic per image, per streamed layer."""
        return {s.spec.name: s.weight_words_per_image for s in self.streamed}

    def throughput(self) -> Dict[str, float]:
        """The §VI throughput model over this plan's placements."""
        return placement.pipeline_throughput(
            self.placements, burst=self.burst, n_pc=self.n_pc)

    # -- fifo_sim bridge ----------------------------------------------------

    def sim_config(self, outputs_needed: int = 32,
                   word_scale: Optional[int] = None
                   ) -> Tuple[fifo_sim.SimConfig, int]:
        """Map the streamed layers onto the §V-A weight-distribution sim:
        engines in pipeline order share one DCFIFO, each consuming
        ``weight_words_per_row`` words per activation (one activation ==
        one output row).  ``word_scale`` divides word counts so big layers
        simulate quickly (auto-picked to keep <=64 words/act); returns
        (config, scale) so callers can rescale totals back."""
        # only nodes with nonzero Eq. 2 demand enter the sim: weightless
        # topology nodes (maxpool / GAP) never hold the HBM tier under
        # compile(), but a caller-forced plan could place one there — a
        # zero-word engine would otherwise round up to 1 word/act and
        # corrupt the counters, so they are filtered here
        streamed = tuple(s for s in self.streamed
                         if s.weight_words_per_row > 0)
        if not streamed:
            raise ValueError("plan streams no weight words; "
                             "nothing to simulate")
        wpr = [s.weight_words_per_row for s in streamed]
        if word_scale is None:
            word_scale = max(1, max(wpr) // 64)
        wpa = tuple(max(1, w // word_scale) for w in wpr)
        lat_cycles = max(1, int(hbm_model.read_latency_ns(self.burst, "avg")
                                * hbm_model.FABRIC_MHZ / 1e3))
        # the per-layer credit pool is the burst-matching FIFO the
        # schedules actually carry (identical to the §IV-A 2-burst sizing
        # for compiler-built plans; the autotuner deepens it per plan),
        # never smaller than one burst or the prefetcher could not issue
        bm_depth = max(min(s.bm_fifo_words for s in streamed), self.burst)
        cfg = fifo_sim.SimConfig(
            n_layers=len(streamed),
            burst=self.burst,
            bm_fifo_depth=bm_depth,
            act_fifo_depth=2,
            dcfifo_depth=max(2 * self.burst, 16),
            hbm_latency=lat_cycles,
            weights_per_act=wpa,
            outputs_needed=outputs_needed,
        )
        return cfg, word_scale

    def predict_stalls(self, outputs_needed: int = 32,
                       word_scale: Optional[int] = None
                       ) -> fifo_sim.SimOutcome:
        """Credit-mode discrete-event prediction of tail-engine stalls for
        the streamed subset (the §V-A liveness + §IV-A sizing check)."""
        cfg, _ = self.sim_config(outputs_needed, word_scale)
        return fifo_sim.simulate(cfg, "credit")

    # -- overrides ----------------------------------------------------------

    def with_offload(self, names: Sequence[str]) -> "PipelinePlan":
        """Plan with the offload set forced to exactly ``names`` — used by
        tests and demos to exercise the streamed path on configs whose
        Eq. 1 scores keep everything on chip."""
        names = set(names)
        unknown = names - {s.spec.name for s in self.schedules}
        if unknown:
            raise KeyError(sorted(unknown))
        new_places = []
        for p in self.placements:
            q = dataclasses.replace(p)
            q.offload = p.spec.name in names
            q.pc = None
            new_places.append(q)
        placement.assign_pseudo_channels(new_places, n_pc=self.n_pc)
        scheds = tuple(
            dataclasses.replace(
                s, mode=HBM if s.spec.name in names else PINNED,
                pc=q.pc)
            for s, q in zip(self.schedules, new_places))
        return dataclasses.replace(self, schedules=scheds,
                                   placements=tuple(new_places))


@dataclass(frozen=True)
class ScanGroup:
    """A run of consecutive residual blocks the fused trace compiles as
    ONE scanned body: identical member shapes (``block_shape_signature``)
    AND identical member schedules (weight tier, buffer ring depth, FIFO
    depths — everything that changes the executed computation; the
    pseudo-channel may differ, it is bandwidth bookkeeping).  Per-block
    params stack along a leading axis and ``lax.scan`` iterates the one
    traced body over them, so the jaxpr size is independent of the run
    length — the haliax ``Stacked`` scan-over-layers idiom at block
    granularity."""

    name: str                               # "scan:s2b1..s2b5"
    blocks: Tuple[str, ...]                 # member block names, order
    members: Tuple[Tuple[str, ...], ...]    # per-block member layer names
    layer_range: Tuple[int, int]            # [start, stop) into cfg.layers

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def member_names(self) -> Tuple[str, ...]:
        """All member layer names across the group, config order."""
        return tuple(n for ms in self.members for n in ms)


def _schedule_signature(s: LayerSchedule) -> Tuple:
    """The schedule fields that change what a member dispatch COMPUTES
    (tier, parallelism, burst, FIFO/buffer depths).  ``pc`` is excluded:
    which pseudo-channel feeds a streamed engine is plan bookkeeping,
    not execution semantics."""
    return (s.mode, s.p_i, s.p_o, s.burst, s.laststage_fifo_depth,
            s.bm_fifo_words, s.n_buffers)


def detect_scan_groups(plan: "PipelinePlan") -> Tuple[ScanGroup, ...]:
    """The plan's scannable block runs: each shape-homogeneous run
    (:func:`repro_torch.configs.cnn.homogeneous_block_runs`) split into maximal
    sub-runs of >= 2 blocks whose member schedules also agree position by
    position — Algorithm 1 may pin one repeat of a stage and stream
    another, and such blocks must NOT share a scanned body (the body is
    traced once, so every iteration executes the same tier/buffer
    configuration)."""
    from repro_torch.configs.cnn import homogeneous_block_runs
    idx = {l.name: i for i, l in enumerate(plan.cfg.layers)}
    groups: List[ScanGroup] = []

    def sched_sig(block) -> Tuple:
        return tuple(_schedule_signature(plan.schedule_for(m.name))
                     for m in block.members)

    def flush(cur) -> None:
        if len(cur) < 2:
            return
        blocks = tuple(b.name for b in cur)
        groups.append(ScanGroup(
            name=f"scan:{blocks[0]}..{blocks[-1]}",
            blocks=blocks,
            members=tuple(tuple(m.name for m in b.members) for b in cur),
            layer_range=(idx[cur[0].members[0].name],
                         idx[cur[-1].members[-1].name] + 1)))

    for run in homogeneous_block_runs(plan.cfg):
        cur = [run[0]]
        for prev, b in zip(run, run[1:]):
            if sched_sig(b) == sched_sig(prev):
                cur.append(b)
            else:
                flush(cur)
                cur = [b]
        flush(cur)
    return tuple(groups)


def build_pipeline_plan(cfg: CNNConfig, *,
                        tb_budget: Optional[int] = None,
                        bram_m20ks: Optional[int] = None,
                        burst: int = 8,
                        n_pc: int = hbm_model.USABLE_PCS,
                        n_buffers: int = 2) -> PipelinePlan:
    """DEPRECATED shim over the staged compiler (``repro_torch.compiler``).

    Use ``repro_torch.compiler.compile(cfg, target)`` instead: the keyword
    defaults this function hard-coded are now explicit :class:`Target`
    descriptors (``NX2100`` reproduces these defaults exactly), and the
    compiler additionally binds every layer to a registered engine and
    validates the VMEM budget.  This shim preserves the PRE-compiler
    behavior verbatim: it runs stages 1-3 only
    (``compiler.plan_pipeline``) — no engine binding, no VMEM
    validation/re-placement — so existing callers keep their exact
    placements for any budget.  ``compile()`` adds the new checks.
    """
    warnings.warn(
        "build_pipeline_plan is deprecated; use repro_torch.compiler.compile("
        "cfg, target) with a Target descriptor (repro_torch.compiler.NX2100 "
        "reproduces the old defaults)", DeprecationWarning, stacklevel=2)
    from repro_torch import compiler
    changes: Dict[str, object] = dict(burst=burst, n_pc=n_pc,
                                      n_buffers=n_buffers)
    if tb_budget is not None:
        changes["tb_budget"] = tb_budget
    if bram_m20ks is not None:
        changes["bram_m20ks"] = bram_m20ks
    return compiler.plan_pipeline(cfg, compiler.NX2100.replace(**changes))
