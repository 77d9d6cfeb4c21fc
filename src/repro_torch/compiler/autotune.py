"""Search-based placement + FIFO co-optimization over the greedy Alg. 1 seed.

Eq. 1 / Algorithm 1 is a greedy heuristic: it scores each layer once and
offloads down the score order until the on-chip remainder fits.  That
ignores every interaction the real pipeline has — which streamed layers
share the prefetcher, how deep the burst-matching FIFOs are, what burst
length the HBM controller runs at — all of which move the §V-A stall
count and the on-chip M20K bill without changing Eq. 1's ranking.
Since the burst-aggregated credit-mode :mod:`repro_torch.core.fifo_sim`
evaluates a full-net word stream in well under a second, it is now a
viable inner-loop cost model, and this module searches where Algorithm 1
guessed ("Memory-Efficient Dataflow Inference for Deep CNNs on FPGA" is
the reference point for buffer-minimizing placement; HPIPE's balancing
pass still supplies the per-layer parallelism and the greedy plan seeds
the search).

The search space (one :class:`Candidate`) is joint over

  * the **offload set** — which streamable layers hold the HBM tier;
  * the **burst length** — §III-A efficiency/latency both move with it;
  * the **burst-matching FIFO depth** — the per-layer credit pool of the
    §V-A flow control: deeper = fewer tail stalls, more M20Ks;
  * the **last-stage FIFO depth** — hard-bounded below by the §IV-A
    latency-covering minimum for the candidate burst; pure M20K cost in
    the deterministic cost model (it exists to absorb latency *jitter*,
    which the fixed-latency sim abstracts away), so the search keeps it
    at the floor unless a burst move shifts the floor itself.

Serving credits are co-optimized after the plan search: the §V-A credit
law (`repro_torch.core.admission.replay_schedule`) is swept downward to the
smallest in-flight bound that still saturates the dispatch pipeline, and
``CompiledPipeline.serve()`` picks that bound up as its default.

Hard constraints (a candidate violating any is infeasible, never
objective-traded):

  * tensor blocks — untouched: parallelism comes from the stage-1
    allocation under ``target.tb_budget`` and is never re-opened here;
  * ``target.chain_budget`` — offloaded ``p_i*p_o`` chain feeds within
    the pseudo-channel pool (Alg. 1's own feasibility rule);
  * ``target.bram_m20ks`` — activations + pinned weights + FIFO plumbing
    at the *candidate's* depths (``hbm_model.fifo_m20k_cost``).  When the
    greedy seed itself overflows the budget (it gives up once every
    positive-score layer streams), the bound relaxes to the seed's own
    footprint: the tuned plan may never be *worse* than the seed;
  * ``target.vmem_bytes`` — every layer's engine working set in its
    candidate tier (same allowance relaxation as BRAM); under a target
    that checks launch plans (``H100``), the CUDA launch plan of every
    layer in its candidate tier within ``target.smem_bytes``
    (``Target.claim`` / ``Target.fits``, the check stage 5 makes);
  * modelled throughput — the §VI model may never drop below the seed's
    images/s: stalls and BRAM are only ever bought at equal-or-better
    throughput.

The objective is the seed-normalized sum of credit-mode tail-engine
stall cycles and on-chip M20Ks; the optimizer (simulated annealing, or
plain hill-climbing with ``strategy="greedy"``) is deterministic under a
fixed ``AutotuneConfig.seed``, and the returned plan is the best
*feasible* candidate ever visited — the seed is visited first, so the
result is never worse than greedy on the objective.

The module is a copy of the JAX package's ``compiler/autotune.py``
over the port's planning modules, with no torch code of its own: the
search runs on the host, visits the same candidates in the same order (one
``random.Random(seed)``, streamable layers in layer order, offload sets
sorted) and returns the same plan as the JAX package's for the same
config, target and seed.  Its budgets are the target's, not the card's.

Entry points: :func:`autotune_plan` for the raw search, or
``compiler.compile(cfg, target, autotune=AutotuneConfig(...))`` to get a
normal, fully validated :class:`CompiledPipeline` whose plan still
passes ``eq2_report().verify()``.
"""
from __future__ import annotations

import dataclasses
import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.compiler.engines import select_engine
from repro_torch.compiler.target import Target
from repro_torch.configs.cnn import CNNConfig
from repro_torch.core import admission, fifo_sim, hbm_model, placement
from repro_torch.core.placement import CHAIN_BITS, M20K_BITS, LayerPlan
from repro_torch.core.schedule import HBM, PINNED, LayerSchedule, PipelinePlan

BURSTS = (4, 8, 16, 32)               # §III-A characterized burst lengths


@dataclass(frozen=True)
class AutotuneConfig:
    """Search knobs — everything the co-optimizer may vary and how long
    it looks.  Deterministic per ``seed``."""

    seed: int = 0
    iterations: int = 400             # proposal steps (evals are cached)
    strategy: str = "anneal"          # "anneal" | "greedy" (hill-climb)
    initial_temp: float = 0.25        # in seed-normalized objective units
    outputs_needed: int = 32          # fifo_sim stream length per eval
    word_scale: Optional[int] = None  # None -> fixed once from the config
    max_bm_words: int = 256           # burst-matching FIFO ceiling (words)
    max_laststage_mult: int = 4       # last-stage ceiling, x the §IV-A min
    serving_latency_ticks: int = 3    # dispatch depth for the credit sweep
    max_serving_credits: int = 16

    def __post_init__(self):
        if self.strategy not in ("anneal", "greedy"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.iterations < 0:
            raise ValueError("iterations must be >= 0")


@dataclass(frozen=True)
class Candidate:
    """One point of the joint search space."""

    offload: Tuple[str, ...]          # sorted streamed-layer names
    burst: int
    bm_words: int                     # burst-matching FIFO depth (words)
    laststage: int                    # last-stage FIFO depth (words)


@dataclass(frozen=True)
class Evaluation:
    """The cost model's verdict on one candidate."""

    feasible: bool
    violations: Tuple[str, ...] = ()
    stall_cycles: int = 0             # credit-mode tail-engine stalls
    sim_cycles: int = 0
    onchip_m20ks: int = 0
    images_per_s: float = 0.0         # §VI throughput model
    hbm_words_per_image: int = 0      # Eq. 2 total over the streamed set
    objective: float = math.inf       # seed-normalized stall + M20K sum


@dataclass(frozen=True)
class AutotuneResult:
    """The search outcome: tuned vs greedy, plus the plan to compile."""

    cfg_name: str
    target_name: str
    search: AutotuneConfig
    candidate: Candidate
    seed_candidate: Candidate
    tuned: Evaluation
    greedy: Evaluation
    plan: PipelinePlan                # the tuned, executable plan
    serving_credits: int              # smallest saturating §V-A bound
    evaluations: int = 0
    accepted_moves: int = 0
    word_scale: int = 1
    #: per-feasible-evaluation search trajectory, ``(iteration,
    #: objective, best_objective)`` with the greedy seed at iteration 0 —
    #: the observability record of *how* the annealer got to ``tuned``
    #: (plotted/asserted without re-running the search).
    objective_trace: Tuple[Tuple[int, float, float], ...] = ()

    @property
    def improved(self) -> bool:
        """Strictly better than greedy on stalls or M20Ks (the bench
        acceptance bar; throughput parity is a feasibility constraint,
        so it never needs re-checking here)."""
        return (self.tuned.stall_cycles < self.greedy.stall_cycles
                or self.tuned.onchip_m20ks < self.greedy.onchip_m20ks)

    def summary(self) -> Dict[str, object]:
        """JSON-ready greedy-vs-tuned record (the BENCH artifact row)."""
        return {
            "net": self.cfg_name,
            "target": self.target_name,
            "seed": self.search.seed,
            "iterations": self.search.iterations,
            "evaluations": self.evaluations,
            "accepted_moves": self.accepted_moves,
            "word_scale": self.word_scale,
            "outputs_needed": self.search.outputs_needed,
            "greedy_streamed": len(self.seed_candidate.offload),
            "greedy_stall_cycles": self.greedy.stall_cycles,
            "greedy_m20ks": self.greedy.onchip_m20ks,
            "greedy_images_per_s": round(self.greedy.images_per_s, 1),
            "greedy_hbm_words_per_image": self.greedy.hbm_words_per_image,
            "tuned_streamed": len(self.candidate.offload),
            "tuned_stall_cycles": self.tuned.stall_cycles,
            "tuned_m20ks": self.tuned.onchip_m20ks,
            "tuned_images_per_s": round(self.tuned.images_per_s, 1),
            "tuned_hbm_words_per_image": self.tuned.hbm_words_per_image,
            "tuned_burst": self.candidate.burst,
            "tuned_bm_words": self.candidate.bm_words,
            "tuned_laststage": self.candidate.laststage,
            "tuned_objective": round(self.tuned.objective, 4),
            "greedy_objective": round(self.greedy.objective, 4),
            "serving_credits": self.serving_credits,
            "improved": self.improved,
        }


class AutotuneError(ValueError):
    """The search could not produce a feasible plan for the target."""


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


class _CostModel:
    """Evaluates candidates against one (config, target) pair.

    Everything a candidate shares — the stage-1 parallelism, the engine
    bindings, the activation M20Ks, the fifo_sim ``word_scale`` — is
    computed once here; evaluations are cached per candidate so the
    annealer revisiting a state costs a dict lookup."""

    def __init__(self, cfg: CNNConfig, target: Target, at: AutotuneConfig):
        self.cfg = cfg
        self.target = target
        self.at = at
        self.base: List[LayerPlan] = placement.allocate_parallelism(
            cfg, target.tb_budget)
        self.engines = {p.spec.name: select_engine(p.spec) for p in self.base}
        self.act_m20ks = sum(
            -(-p.spec.activation_window_bits(8) // M20K_BITS)
            for p in self.base)
        # layers the search may flip: weight-bearing, streamable engines
        self.streamable = tuple(
            p.spec.name for p in self.base
            if not p.spec.is_pool
            and -(-p.spec.weight_bits(8) // CHAIN_BITS) > 0
            and getattr(self.engines[p.spec.name], "can_stream", True))
        # one word_scale for EVERY candidate: stall counts are only
        # comparable across plans when they divide word demands alike
        wpr = [-(-p.spec.weight_bits(8) // CHAIN_BITS) for p in self.base
               if not p.spec.is_pool]
        self.word_scale = at.word_scale or max(1, max(wpr, default=1) // 64)

        # the greedy Alg. 1 seed (hybrid selection copies, so self.base
        # stays pristine for every later candidate build)
        seeded = placement.hybrid_selection(
            self.base, target.bram_m20ks, n_pc=target.n_pc,
            burst=target.burst)
        self.seed_candidate = Candidate(
            offload=tuple(sorted(p.spec.name for p in seeded if p.offload)),
            burst=target.burst,
            bm_words=hbm_model.burst_matching_fifo_words(target.burst),
            laststage=hbm_model.min_laststage_fifo_depth(target.burst))

        self._cache: Dict[Candidate, Evaluation] = {}
        self.evaluations = 0

        # seed references: evaluated without the vs-seed constraints,
        # then used to normalize/bound every other candidate
        self._seed_eval: Optional[Evaluation] = None
        self._seed_eval = self.evaluate(self.seed_candidate)

    # -- plan construction --------------------------------------------------

    def build_plan(self, cand: Candidate) -> PipelinePlan:
        """The executable plan a candidate denotes — same shape as
        ``compiler.plan_pipeline`` output, with the tuned knobs in the
        schedules so ``sim_config``/M20K accounting see them."""
        offload = set(cand.offload)
        plans = []
        for p in self.base:
            q = dataclasses.replace(p)
            q.offload = p.spec.name in offload
            q.pc = None
            plans.append(q)
        placement.assign_pseudo_channels(plans, n_pc=self.target.n_pc)
        schedules = tuple(
            LayerSchedule(
                spec=q.spec,
                mode=HBM if q.offload else PINNED,
                p_i=q.p_i, p_o=q.p_o, pc=q.pc,
                burst=cand.burst,
                laststage_fifo_depth=cand.laststage,
                bm_fifo_words=cand.bm_words,
                n_buffers=self.target.n_buffers,
            ) for q in plans)
        return PipelinePlan(cfg=self.cfg, schedules=schedules,
                            placements=tuple(plans), burst=cand.burst,
                            n_pc=self.target.n_pc)

    # -- accounting ---------------------------------------------------------

    def onchip_m20ks(self, cand: Candidate, plan: PipelinePlan) -> int:
        """Hybrid selection's BRAM bill at the candidate's FIFO depths."""
        total = self.act_m20ks
        fifo = hbm_model.fifo_m20k_cost(cand.burst, cand.laststage,
                                        cand.bm_words)
        for p in plan.placements:
            if p.offload:
                total += fifo * -(-p.spec.out_w // 18)
            else:
                total += p.weight_m20ks
        return total

    def _stalls(self, plan: PipelinePlan) -> Tuple[int, int]:
        streamed = [s for s in plan.streamed if s.weight_words_per_row > 0]
        if not streamed:
            return 0, 0
        sim_cfg, _ = plan.sim_config(self.at.outputs_needed,
                                     word_scale=self.word_scale)
        out = fifo_sim.simulate(sim_cfg, "credit")
        return out.stall_cycles, out.cycles

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, cand: Candidate) -> Evaluation:
        hit = self._cache.get(cand)
        if hit is not None:
            return hit
        self.evaluations += 1
        ev = self._evaluate(cand)
        self._cache[cand] = ev
        return ev

    def _evaluate(self, cand: Candidate) -> Evaluation:
        seed = self._seed_eval            # None only for the seed itself
        violations: List[str] = []

        unknown = [n for n in cand.offload if n not in self.streamable]
        if unknown:
            violations.append(f"unstreamable layer(s) {unknown}")
        if cand.burst not in BURSTS:
            violations.append(f"uncharacterized burst {cand.burst}")
        if cand.bm_words < cand.burst:
            violations.append(
                f"bm_words {cand.bm_words} < burst {cand.burst} "
                f"(prefetcher could never issue)")
        min_ls = hbm_model.min_laststage_fifo_depth(cand.burst)
        if cand.laststage < min_ls:
            violations.append(
                f"laststage {cand.laststage} below the §IV-A "
                f"latency-covering minimum {min_ls} for burst {cand.burst}")
        if violations:
            return Evaluation(feasible=False, violations=tuple(violations))

        plan = self.build_plan(cand)
        chains = sum(p.chains for p in plan.placements if p.offload)
        if chains > self.target.chain_budget:
            violations.append(
                f"{chains} chain feeds exceed the pseudo-channel pool "
                f"{self.target.chain_budget}")

        m20ks = self.onchip_m20ks(cand, plan)
        # the seed sets the BRAM allowance when it overflows the target:
        # hybrid selection legitimately exceeds small budgets once every
        # positive-score layer already streams, and "never worse than the
        # seed" is the contract the search enforces from there
        bram_allow = max(self.target.bram_m20ks,
                         m20ks if seed is None else seed.onchip_m20ks)
        if m20ks > bram_allow:
            violations.append(
                f"{m20ks} on-chip M20Ks exceed the allowance {bram_allow}")

        for s in plan.schedules:
            vb = self.target.claim(self.engines[s.spec.name], s.spec, s)
            if self.target.fits(vb):
                continue
            if self.target.checks_plans:
                violations.append(
                    f"{s.spec.name}: no launch plan within the card's "
                    f"{self.target.smem_bytes} B of shared memory a block")
            else:
                violations.append(
                    f"{s.spec.name}: {vb} B exceeds the per-engine VMEM "
                    f"budget {self.target.vmem_bytes}")

        thr = plan.throughput()["images_per_s"]
        if seed is not None and thr < seed.images_per_s * (1 - 1e-9):
            violations.append(
                f"modelled {thr:.1f} images/s below the greedy seed's "
                f"{seed.images_per_s:.1f}")

        stall, cycles = self._stalls(plan)
        words = sum(plan.hbm_words_per_image().values())
        stall_ref = max(1, stall if seed is None else seed.stall_cycles)
        m20k_ref = max(1, m20ks if seed is None else seed.onchip_m20ks)
        return Evaluation(
            feasible=not violations,
            violations=tuple(violations),
            stall_cycles=stall,
            sim_cycles=cycles,
            onchip_m20ks=m20ks,
            images_per_s=thr,
            hbm_words_per_image=words,
            objective=stall / stall_ref + m20ks / m20k_ref,
        )

    # -- move proposal ------------------------------------------------------

    def propose(self, rng: random.Random, cand: Candidate) -> Candidate:
        """One neighbor: flip a layer's tier, step the burst, or resize a
        FIFO.  Knobs are re-clamped so a burst move keeps the candidate
        structurally valid (bm >= burst, laststage >= its new minimum)."""
        moves: List[Tuple[str, object]] = [("flip", n)
                                           for n in self.streamable]
        bi = BURSTS.index(cand.burst)
        if bi > 0:
            moves.append(("burst", BURSTS[bi - 1]))
        if bi < len(BURSTS) - 1:
            moves.append(("burst", BURSTS[bi + 1]))
        if cand.bm_words * 2 <= self.at.max_bm_words:
            moves.append(("bm", cand.bm_words * 2))
        if cand.bm_words // 2 >= cand.burst:
            moves.append(("bm", cand.bm_words // 2))
        min_ls = hbm_model.min_laststage_fifo_depth(cand.burst)
        if cand.laststage * 2 <= self.at.max_laststage_mult * min_ls:
            moves.append(("laststage", cand.laststage * 2))
        if cand.laststage // 2 >= min_ls:
            moves.append(("laststage", cand.laststage // 2))

        kind, val = moves[rng.randrange(len(moves))]
        if kind == "flip":
            offload = set(cand.offload)
            offload.symmetric_difference_update({val})
            return dataclasses.replace(cand, offload=tuple(sorted(offload)))
        if kind == "burst":
            burst = int(val)
            return dataclasses.replace(
                cand, burst=burst,
                bm_words=max(cand.bm_words, burst),
                laststage=max(cand.laststage,
                              hbm_model.min_laststage_fifo_depth(burst)))
        if kind == "bm":
            return dataclasses.replace(cand, bm_words=int(val))
        return dataclasses.replace(cand, laststage=int(val))


# ---------------------------------------------------------------------------
# serving-credit co-optimization (§V-A on the dispatch pipeline)
# ---------------------------------------------------------------------------


def solve_serving_credits(latency_ticks: int, *, items: int = 64,
                          max_credits: int = 16) -> int:
    """The smallest in-flight bound that still saturates a dispatch
    pipeline of ``latency_ticks`` depth, by replaying the §V-A credit
    law itself (``admission.replay_schedule``) rather than trusting the
    closed form: makespan is non-increasing in credits, so walk down
    from ``max_credits`` while the saturated makespan holds."""
    if latency_ticks < 0:
        raise ValueError("latency_ticks must be >= 0")
    best = max_credits
    saturated = None
    for c in range(max_credits, 0, -1):
        tr = admission.replay_schedule(items, capacity=c,
                                       latency_ticks=latency_ticks)
        if saturated is None:
            saturated = tr.makespan
        if tr.makespan == saturated:
            best = c
        else:
            break
    return best


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------


def autotune_plan(cfg: CNNConfig, target: Target,
                  at: AutotuneConfig = AutotuneConfig()) -> AutotuneResult:
    """Run the co-optimization and return the best feasible plan found.

    Deterministic per ``at.seed``; the greedy Alg. 1 seed is the first
    candidate visited, so the result is never worse than greedy on the
    objective.  Raises :class:`AutotuneError` when not even the seed is
    feasible (a target whose budgets reject every plan should go through
    plain ``compile()`` to get the full :class:`TargetBudgetError`
    diagnosis instead)."""
    model = _CostModel(cfg, target, at)
    rng = random.Random(at.seed)

    cur = model.seed_candidate
    cur_ev = model.evaluate(cur)
    if not cur_ev.feasible:
        raise AutotuneError(
            f"greedy seed for {cfg.name!r} on {target.name!r} is "
            f"infeasible: {'; '.join(cur_ev.violations)}")
    best, best_ev = cur, cur_ev
    accepted = 0
    trace = [(0, cur_ev.objective, best_ev.objective)]

    for i in range(at.iterations):
        cand = model.propose(rng, cur)
        ev = model.evaluate(cand)
        if not ev.feasible:
            continue
        delta = ev.objective - cur_ev.objective
        if at.strategy == "greedy":
            take = delta < 0
        else:
            temp = max(1e-6, at.initial_temp
                       * (1.0 - i / max(1, at.iterations)))
            take = delta <= 0 or rng.random() < math.exp(-delta / temp)
        if take:
            cur, cur_ev = cand, ev
            accepted += 1
            if ev.objective < best_ev.objective:
                best, best_ev = cand, ev
        trace.append((i + 1, ev.objective, best_ev.objective))

    return AutotuneResult(
        cfg_name=cfg.name,
        target_name=target.name,
        search=at,
        candidate=best,
        seed_candidate=model.seed_candidate,
        tuned=best_ev,
        greedy=model._seed_eval,
        plan=model.build_plan(best),
        serving_credits=solve_serving_credits(
            at.serving_latency_ticks, max_credits=at.max_serving_credits),
        evaluations=model.evaluations,
        accepted_moves=accepted,
        word_scale=model.word_scale,
        objective_trace=tuple(trace),
    )
