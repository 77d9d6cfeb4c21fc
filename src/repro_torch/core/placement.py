"""Layer selection for HBM offload — Eq. 1 + Algorithm 1 (§V-B), plus the
HPIPE parallelism allocator that produces the (p_i, p_o) the score consumes,
and the clockwise pseudo-channel assignment.

Units follow the paper exactly:
  * memory in M20K blocks (20480 bits each); offloading a layer's weight
    buffer frees its M20Ks but pays 2 M20Ks for the 512x80b last-stage FIFO
    (the ``- 2`` in Eq. 1) — burst-matching cost is added separately;
  * bandwidth in 80-bit tensor-chain feeds: a layer consumes p_i*p_o chains,
    one pseudo-channel feeds 3 (240 of 256 bits).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.cnn import CNNConfig, ConvLayerSpec
from repro_torch.core import hbm_model

M20K_BITS = 20480
CHAIN_BITS = 80
CHAINS_PER_PC = 3                 # 240 of 256 bits per PC (§III-B)

# Pooling topology nodes are placed and costed like every engine (their
# activation line buffers land in the BRAM budget), but they are
# weightless: no M20Ks to save (Eq. 1 score is negative, so Algorithm 1
# never offloads them), no AI-TBs to balance, comparator/accumulator
# cycles off the critical path.


# ---------------------------------------------------------------------------
# parallelism allocation (the HPIPE compiler's balancing pass, §II-B)
# ---------------------------------------------------------------------------


@dataclass
class LayerPlan:
    spec: ConvLayerSpec
    p_i: int = 1
    p_o: int = 1
    offload: bool = False          # True -> weights in HBM
    pc: Optional[int] = None       # pseudo-channel id when offloaded

    @property
    def cycles_per_image(self) -> int:
        """Compute cycles with full-width parallelism: each cycle one
        (p_i x 10-weight, p_o-channel) chain group advances all out_w
        positions; rows are processed line by line.  Pool nodes sweep one
        output line per cycle on fabric comparators/accumulators — never
        the pipeline bottleneck."""
        s = self.spec
        if s.is_pool:
            return s.out_h
        ci_eff = s.c_in if s.kind != "dwconv" else 1
        co_eff = s.c_out if s.kind != "dwconv" else s.c_in
        depth = -(-ci_eff * s.k_h * s.k_w // (10 * self.p_i))
        chans = -(-co_eff // self.p_o)
        return s.out_h * depth * chans

    @property
    def tensor_blocks(self) -> int:
        """AI-TBs consumed: one chain covers 3 adjacent output columns.
        Pool nodes do no MACs and consume none."""
        if self.spec.is_pool:
            return 0
        return self.p_i * self.p_o * -(-self.spec.out_w // 3)

    @property
    def weight_m20ks(self) -> int:
        """On-chip weight memory in M20Ks (the Eq. 1 numerator's first term,
        including the output_width/18 duplication factor for fanout)."""
        blocks = -(-self.spec.weight_bits(8) // M20K_BITS)
        dup = -(-self.spec.out_w // 18)
        return blocks * dup

    @property
    def chains(self) -> int:
        """HBM bandwidth demand in 80-bit chain feeds (Eq. 1 denominator)."""
        return self.p_i * self.p_o


def allocate_parallelism(cfg: CNNConfig, tb_budget: int,
                         fabric_mhz: float = hbm_model.FABRIC_MHZ
                         ) -> List[LayerPlan]:
    """Greedy pipeline balancing: repeatedly double (p_i or p_o) of the
    bottleneck layer while tensor blocks remain (HPIPE's compiler strategy:
    'increase the throughput of layers that would otherwise bottleneck')."""
    plans = [LayerPlan(spec=l) for l in cfg.layers]
    # pool nodes keep (1, 1): weightless comparator/accumulator engines
    # have no chain parallelism to balance and no AI-TBs to spend
    balance = [p for p in plans if not p.spec.is_pool]
    if not balance:
        return plans

    def used() -> int:
        return sum(p.tensor_blocks for p in plans)

    while True:
        bott = max(balance, key=lambda p: p.cycles_per_image)
        s = bott.spec
        ci_eff = (s.c_in if s.kind != "dwconv" else 1) * s.k_h * s.k_w
        co_eff = s.c_out if s.kind != "dwconv" else s.c_in
        # prefer the dimension with remaining headroom
        candidates = []
        if bott.p_i * 10 < ci_eff:
            candidates.append("p_i")
        if bott.p_o * 2 <= co_eff:
            candidates.append("p_o")
        if not candidates:
            break
        # try the preferred dimension first, but fall back to the other
        # one before giving up: the cheaper dimension may still fit the
        # remaining AI-TB budget when the preferred double does not
        candidates.sort(key=lambda d: ci_eff / bott.p_i if d == "p_i"
                        else co_eff / bott.p_o, reverse=True)
        doubled = False
        for dim in candidates:
            setattr(bott, dim, getattr(bott, dim) * 2)
            if used() > tb_budget:
                setattr(bott, dim, getattr(bott, dim) // 2)
                continue
            doubled = True
            break
        if not doubled:
            break
    return plans


# ---------------------------------------------------------------------------
# Eq. 1 score
# ---------------------------------------------------------------------------


def eq1_score(plan: LayerPlan) -> float:
    """Desirability of moving layer weights to HBM: M20Ks saved (minus the
    2-M20K last-stage FIFO cost) per unit of HBM bandwidth required."""
    s = plan.spec
    kernel_m20ks = -(-s.weight_bits(8) // M20K_BITS)
    dup = -(-s.out_w // 18)
    saved = (kernel_m20ks - 2) * dup
    bw = plan.p_i * plan.p_o * CHAIN_BITS
    return saved / bw


# ---------------------------------------------------------------------------
# Algorithm 1: greedy offload under the pseudo-channel bandwidth budget
# ---------------------------------------------------------------------------


def algorithm1(plans: Sequence[LayerPlan], n_pc: int = hbm_model.USABLE_PCS,
               ) -> List[LayerPlan]:
    """Offload the highest-scoring layers until chain bandwidth runs out.
    Mutates and returns ``plans`` (offload flags)."""
    order = sorted(range(len(plans)), key=lambda i: eq1_score(plans[i]),
                   reverse=True)
    free_bw = n_pc * CHAINS_PER_PC
    for i in order:
        if free_bw == 0:
            break
        if eq1_score(plans[i]) <= 0:
            continue                       # offloading would not save memory
        need = plans[i].chains
        if need <= free_bw:
            plans[i].offload = True
            free_bw -= need
    return list(plans)


def hybrid_selection(plans: Sequence[LayerPlan], bram_m20ks: int,
                     n_pc: int = hbm_model.USABLE_PCS,
                     burst: int = 8) -> List[LayerPlan]:
    """The full hybrid policy (§VI-A): keep as many weight buffers on chip
    as BRAM allows; layers chosen for HBM by Algorithm 1 order.  Activations
    always stay on chip (§III-B).  Offloads highest-score layers first until
    the on-chip remainder fits."""
    # work on copies: the caller's plans (and their offload flags) must
    # stay untouched — the autotuner calls this in a loop over candidate
    # plans and relies on the seed staying pristine
    plans = [dataclasses.replace(p) for p in plans]
    for p in plans:
        p.offload = False
        p.pc = None
    act_m20ks = sum(-(-l.spec.activation_window_bits(8) // M20K_BITS)
                    for l in plans)
    order = sorted(range(len(plans)), key=lambda i: eq1_score(plans[i]),
                   reverse=True)
    free_bw = n_pc * CHAINS_PER_PC

    def onchip_m20ks() -> int:
        total = act_m20ks
        for p in plans:
            if p.offload:
                total += hbm_model.fifo_m20k_cost(burst) * \
                    -(-p.spec.out_w // 18)
            else:
                total += p.weight_m20ks
        return total

    for i in order:
        if onchip_m20ks() <= bram_m20ks:
            break
        if free_bw >= plans[i].chains and eq1_score(plans[i]) > 0:
            plans[i].offload = True
            free_bw -= plans[i].chains
    return list(plans)


def assign_pseudo_channels(plans: Sequence[LayerPlan],
                           n_pc: int = hbm_model.N_PCS) -> None:
    """Clockwise assignment (§V-B): offloaded layers in pipeline order get
    PCs 0->15 then 31->16, wrapping round-robin when layers outnumber PCs.

    Only the first ``n_pc`` pseudo-channels in clockwise die order are
    usable (§VI-B: 31 of the NX2100's 32 close timing), so the walk must
    never hand out an id >= ``n_pc`` — a target with 8 usable PCs gets
    ids 0..7, never the far-stack 16..31 range."""
    clockwise = list(range(16)) + list(range(31, 15, -1))
    clockwise = [pc for pc in clockwise if pc < n_pc]
    k = 0
    for p in plans:
        if p.offload:
            p.pc = clockwise[k % len(clockwise)]
            k += 1


# ---------------------------------------------------------------------------
# throughput model (drives Table II / Fig. 6 benchmarks)
# ---------------------------------------------------------------------------


# Pipeline compute efficiency: fraction of peak tensor-chain issue rate the
# real HPIPE pipeline sustains (line-boundary bubbles, ragged tiling,
# control overheads).  Single global constant calibrated once against the
# paper's three measured hybrid throughputs (§VI-A); documented in
# EXPERIMENTS.md — not tuned per network.
PIPELINE_EFF = 0.62


def pipeline_throughput(plans: Sequence[LayerPlan], burst: int = 8,
                        fabric_mhz: float = hbm_model.FABRIC_MHZ,
                        n_pc: int = hbm_model.USABLE_PCS,
                        ) -> Dict[str, float]:
    """Images/s of the layer pipeline: every layer runs concurrently; the
    pipeline rate is set by the slowest layer.

    An HBM-fed layer consumes p_i*p_o 80-bit words per compute cycle, so
    its weight feed must sustain that rate x Fig. 3a efficiency.  The chain
    budget is global (Algorithm 1's ``n_pc x 3`` pool — a wide layer spans
    pseudo-channels); when offloaded demand exceeds the pool, every HBM
    layer is throttled by the same oversubscription factor."""
    eff = hbm_model.read_efficiency(burst)
    demand = sum(p.chains for p in plans if p.offload)
    pool = n_pc * CHAINS_PER_PC
    over = min(1.0, pool / demand) if demand else 1.0
    worst_s = 0.0
    bott = None
    for p in plans:
        t = p.cycles_per_image / (fabric_mhz * 1e6 * PIPELINE_EFF)
        if p.offload:
            # stream rate never exceeds eff x (its share of the pool)
            t_w = p.cycles_per_image / (fabric_mhz * 1e6 * eff * over)
            t = max(t, t_w)
        if t > worst_s:
            worst_s, bott = t, p
    return {
        "images_per_s": 1.0 / worst_s if worst_s else float("inf"),
        "bottleneck": bott.spec.name if bott else "",
        "bottleneck_on_hbm": bool(bott.offload) if bott else False,
        "oversubscription": over,
    }
