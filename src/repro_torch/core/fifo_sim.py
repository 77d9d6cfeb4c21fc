"""Discrete-event simulation of the H2PIPE weight-distribution network.

Reproduces the paper's §V-A result: when several layer engines share one
HBM-to-fabric DCFIFO, a ready/valid latency-insensitive protocol can
head-of-line block and deadlock (Fig. 5), while credit-based flow control
cannot.  The simulator models:

  HBM controller -> shared DCFIFO -> per-layer burst-matching FIFOs
      -> layer engines, with activation FIFOs between consecutive layers.

A layer engine consumes one activation from its upstream FIFO plus
``weights_per_act`` weight words to emit one activation downstream.  The
weight prefetcher round-robins burst reads over the layers sharing the
pseudo-channel; deliveries arrive in request order after ``hbm_latency``
cycles (the deterministic abstraction of Fig. 3b).

Modes
-----
``ready_valid``  the DCFIFO head transfers only if the destination
                 burst-matching FIFO has space; otherwise it blocks ALL
                 layers behind it (head-of-line blocking).
``credit``       the prefetcher holds per-layer credit counters sized to the
                 burst-matching FIFO and issues a read only when the whole
                 burst is guaranteed space — the DCFIFO can always drain.

Implementation note (exact full-net simulation)
-----------------------------------------------
Words within one layer are indistinguishable, so the hot credit-mode
path (:func:`simulate`) tracks word *counts* — burst-aggregated inflight
records and integer occupancy arrays — instead of one deque entry per
word, and fast-forwards exactly through periodic steady states (when the
residual state recurs with every engine mid-burst, the next ``m``
periods are an affine replay and are applied in O(1)).  The cycle cap
scales with the total word demand, so ``word_scale=1`` runs over full
Eq. 2 word streams (hundreds of thousands of words per activation) are
exact AND finish in CI time.  The original per-word event loop survives
as :func:`simulate_reference` — it still serves the ``ready_valid``
head-of-line mode, and the regression tests assert the fast path is
cycle-for-cycle identical to it.

The same credit semantics guard the multi-stage pipeline executor in
``core/dataflow.py``; the property tests in tests/test_core_paper.py and
tests/test_fifo_sim_fast.py check the deadlock repro, credit-mode
liveness, and fast-vs-reference equality over random topologies.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class SimConfig:
    n_layers: int = 3
    burst: int = 4                    # words per HBM read
    bm_fifo_depth: int = 8            # per-layer burst-matching FIFO (words)
    act_fifo_depth: int = 2           # inter-layer activation FIFO
    dcfifo_depth: int = 16            # shared HBM->fabric DCFIFO
    hbm_latency: int = 12             # cycles request -> first word
    weights_per_act: Tuple[int, ...] = (1, 1, 1)
    outputs_needed: int = 64          # activations layer N-1 must emit
    deadlock_window: int = 2000       # no-progress cycles -> deadlocked
    cycle_cap: Optional[int] = None   # None -> scaled to the word demand


@dataclass
class SimOutcome:
    completed: bool
    deadlocked: bool
    cycles: int
    outputs: int
    stall_cycles: int                 # cycles the tail engine was frozen
    per_layer_weight_words: List[int] = field(default_factory=list)


def _cycle_cap(cfg: SimConfig) -> int:
    """Hard stop for a wedged-but-progressing sim.  The historical fixed
    500k cap predates exact full-net streams (a single activation can
    demand >200k words at word_scale=1), so the cap now scales with the
    total demand — including the latency-bound delivery rate: a layer
    with ``bm_fifo_depth`` credits against ``hbm_latency`` cycles of
    read latency sustains only ``bm/(bm+latency)`` words per cycle
    (Little's law — the §IV-A motivation for latency-covering FIFOs),
    so budget that many delivery rounds over the whole word stream."""
    if cfg.cycle_cap is not None:
        return cfg.cycle_cap
    total_words = sum(w * cfg.outputs_needed for w in cfg.weights_per_act)
    rounds = 1 + cfg.hbm_latency // max(1, cfg.bm_fifo_depth)
    return max(500_000, 4 * total_words * rounds + cfg.hbm_latency + 10_000)


def simulate(cfg: SimConfig, mode: str = "credit",
             start_skew: Optional[List[int]] = None) -> SimOutcome:
    """Run the network until the last layer emits ``outputs_needed``
    activations, deadlock is detected, or the cycle cap is hit.

    ``start_skew``: cycle at which each layer engine powers on (the paper's
    start-up scenario: the first layer operating while consecutive layers
    still wait on activations).

    ``credit`` mode runs on the burst-aggregated fast path (bit-identical
    to :func:`simulate_reference` — regression-tested); ``ready_valid``
    keeps the per-word reference loop, whose head-of-line blocking is the
    very thing being modelled.
    """
    assert mode in ("ready_valid", "credit")
    if mode == "credit":
        return _simulate_credit_fast(cfg, start_skew)
    return simulate_reference(cfg, mode, start_skew)


def _simulate_credit_fast(cfg: SimConfig,
                          start_skew: Optional[List[int]]) -> SimOutcome:
    """Credit-mode sim over word counts instead of per-word deques.

    Two credit-mode invariants make this exact:
      * credits reserve burst-matching space at issue time, so the
        DCFIFO always drains fully within the cycle — its only residual
        role is capping deliveries at ``dcfifo_depth`` words/cycle;
      * deliveries happen in request order at one word/cycle per burst,
        so an inflight burst is fully described by (first-arrival cycle,
        layer, words remaining).

    On top of the counters, an exact periodic fast-forward: whenever the
    residual state (FIFO occupancies, credits, activation queues,
    round-robin pointer, inflight offsets) recurs while every layer is
    mid-activation (no ``weight_need`` reset in between), the dynamics
    are a fixed affine step per period — apply ``m`` periods at once,
    bounded so no layer crosses an activation boundary or an issuance
    truncation inside the jump.  This is what makes ``word_scale=1``
    full-net streams (~10^6 words) simulate exactly in well under a
    second instead of ~10^6 Python cycles.
    """
    L = cfg.n_layers
    wpa = list(cfg.weights_per_act)
    assert len(wpa) == L
    skew = list(start_skew) if start_skew else [0] * L
    max_skew = max(skew)
    cap = _cycle_cap(cfg)
    burst = cfg.burst
    lat = cfg.hbm_latency
    bm_depth = cfg.bm_fifo_depth
    act_depth = cfg.act_fifo_depth
    dc_depth = cfg.dcfifo_depth
    needed = cfg.outputs_needed
    window = cfg.deadlock_window

    # numpy int64 state keeps the totals overflow-safe for full Eq. 2
    # streams; the per-cycle loop reads/writes them through plain lists
    # (cheaper in the interpreter) and syncs at jump/exit points.
    total_need = np.asarray(wpa, np.int64) * needed

    bm = [0] * L                      # burst-matching FIFO occupancy
    credits = [bm_depth] * L
    weight_need = wpa[:]              # remaining words for current act
    got_words = [0] * L
    acts = [0] * (L + 1)              # inter-layer activation FIFOs
    issued = [0] * L
    inflight: Deque[List[int]] = deque()   # [next_arrival, layer, remaining]
    outputs = 0
    stall = 0
    rr = 0
    last_progress = 0
    cycle = 0

    # periodic fast-forward bookkeeping
    snapshots: Dict[Tuple, Tuple] = {}
    jump_floor = 2 * burst            # only worth probing mid-big-burst

    while outputs < needed and cycle < cap:
        cycle += 1
        progressed = False

        # 1+3. deliver arrived words straight into the burst-matching
        #      FIFOs (credits reserved the space; the DCFIFO's residual
        #      effect is the per-cycle delivery cap), in request order.
        space = dc_depth
        while inflight and space > 0:
            head = inflight[0]
            fd, lid, rem = head
            if fd > cycle:
                break                        # head word not arrived (FIFO)
            take = cycle - fd + 1            # words arrived, 1/cycle each
            if take > rem:
                take = rem
            if take > space:
                take = space
            bm[lid] += take
            space -= take
            progressed = True
            if take == rem:
                inflight.popleft()
            else:
                head[0] = fd + take          # next undelivered word
                head[2] = rem - take
                break

        # 2. prefetcher issues one burst per cycle at most
        for probe in range(L):
            lid = (rr + probe) % L
            rem_need = int(total_need[lid]) - issued[lid]
            if rem_need <= 0:
                continue
            n = burst if rem_need > burst else rem_need
            if credits[lid] < n:
                continue
            credits[lid] -= n
            inflight.append([cycle + lat, lid, n])
            issued[lid] += n
            rr = (lid + 1) % L
            break

        # 4. layer engines (last to first so same-cycle hand-off works)
        boundary = False
        for lid in range(L - 1, -1, -1):
            if cycle < skew[lid]:
                continue
            tail = lid == L - 1
            if not ((lid == 0 or acts[lid] > 0)
                    and (tail or acts[lid + 1] < act_depth)):
                if tail:
                    stall += 1
                continue
            wn = weight_need[lid]
            if wn > 0:
                if bm[lid] > 0:
                    bm[lid] -= 1
                    got_words[lid] += 1
                    wn = weight_need[lid] = wn - 1
                    credits[lid] += 1
                    progressed = True
                else:
                    if tail:
                        stall += 1
                    continue
            if wn == 0:
                weight_need[lid] = wpa[lid]
                boundary = True
                if lid > 0:
                    acts[lid] -= 1
                if tail:
                    outputs += 1
                else:
                    acts[lid + 1] += 1
                progressed = True

        if progressed:
            last_progress = cycle
        elif cycle - last_progress > window:
            return SimOutcome(False, True, cycle, outputs, stall, got_words)

        # 5. periodic steady-state fast-forward (exact, see docstring)
        if boundary:
            snapshots.clear()            # an act completed: regime changed
            continue
        if cycle <= max_skew or min(weight_need) <= jump_floor:
            continue
        key = (tuple(bm), tuple(credits), tuple(acts), rr,
               tuple((b[0] - cycle, b[1], b[2]) for b in inflight))
        prev = snapshots.get(key)
        if prev is None:
            snapshots[key] = (cycle, outputs, stall, tuple(weight_need),
                              tuple(got_words), tuple(issued))
            continue
        p_cycle, p_outputs, p_stall, p_need, p_got, p_issued = prev
        period = cycle - p_cycle
        if outputs != p_outputs:
            snapshots[key] = (cycle, outputs, stall, tuple(weight_need),
                              tuple(got_words), tuple(issued))
            continue
        dgot = [got_words[i] - p_got[i] for i in range(L)]
        dneed = [p_need[i] - weight_need[i] for i in range(L)]
        dissue = [issued[i] - p_issued[i] for i in range(L)]
        dstall = stall - p_stall
        # exactness guards: the period must be a pure mid-activation
        # chew (every consumed word decremented weight_need — no reset),
        # with real progress to replay.
        if dneed != dgot or not any(dgot):
            snapshots[key] = (cycle, outputs, stall, tuple(weight_need),
                              tuple(got_words), tuple(issued))
            continue
        m = (cap - cycle - 1) // period
        for i in range(L):
            if dgot[i] > 0:
                # never reach an activation boundary inside the jump
                m = min(m, (weight_need[i] - 1) // dgot[i])
            if dissue[i] > 0:
                # never truncate a burst (remaining stays >= period+burst)
                m = min(m, (int(total_need[i]) - issued[i] - dissue[i]
                            - burst) // dissue[i])
        if m <= 0:
            snapshots[key] = (cycle, outputs, stall, tuple(weight_need),
                              tuple(got_words), tuple(issued))
            continue
        shift = m * period
        cycle += shift
        stall += m * dstall
        for i in range(L):
            weight_need[i] -= m * dgot[i]
            got_words[i] += m * dgot[i]
            issued[i] += m * dissue[i]
        for b in inflight:
            b[0] += shift
        last_progress = cycle
        snapshots.clear()

    return SimOutcome(outputs >= needed, False, cycle, outputs, stall,
                      got_words)


def simulate_reference(cfg: SimConfig, mode: str = "credit",
                       start_skew: Optional[List[int]] = None) -> SimOutcome:
    """The original per-word event loop: one deque entry per weight word.

    Kept as the executable specification — ``ready_valid`` mode runs
    here (head-of-line blocking needs the word-tagged DCFIFO), and the
    fast credit path is regression-tested cycle-for-cycle against it.
    Too slow for word_scale=1 full-net streams; use :func:`simulate`.
    """
    assert mode in ("ready_valid", "credit")
    L = cfg.n_layers
    wpa = list(cfg.weights_per_act)
    assert len(wpa) == L
    start_skew = start_skew or [0] * L

    # state
    dcfifo: Deque[int] = deque()                  # words tagged by layer id
    inflight: Deque[Tuple[int, int]] = deque()    # (deliver_cycle, layer)
    bm: List[Deque[int]] = [deque() for _ in range(L)]
    acts: List[Deque[int]] = [deque() for _ in range(L + 1)]
    credits = [cfg.bm_fifo_depth for _ in range(L)]
    weight_need = [wpa[i] for i in range(L)]      # remaining for current act
    got_words = [0] * L
    outputs = 0
    stall = 0
    rr = 0                                        # round-robin pointer
    last_progress = 0
    cycle = 0
    cap = _cycle_cap(cfg)

    # total weight words each layer will ever need (stop prefetching after)
    total_need = [wpa[i] * cfg.outputs_needed for i in range(L)]
    issued = [0] * L

    while outputs < cfg.outputs_needed and cycle < cap:
        cycle += 1
        progressed = False

        # 1. deliver arrived HBM words into the DCFIFO (in request order)
        while inflight and inflight[0][0] <= cycle and \
                len(dcfifo) < cfg.dcfifo_depth:
            _, lid = inflight.popleft()
            dcfifo.append(lid)
            progressed = True

        # 2. prefetcher issues one burst per cycle at most
        for probe in range(L):
            lid = (rr + probe) % L
            if issued[lid] >= total_need[lid]:
                continue
            n = min(cfg.burst, total_need[lid] - issued[lid])
            if mode == "credit":
                if credits[lid] < n:
                    continue
                credits[lid] -= n
            else:
                if len(inflight) + len(dcfifo) + n > cfg.dcfifo_depth:
                    continue
            for w in range(n):
                inflight.append((cycle + cfg.hbm_latency + w, lid))
            issued[lid] += n
            rr = (lid + 1) % L
            break

        # 3. DCFIFO head -> burst-matching FIFO (head-of-line semantics)
        while dcfifo:
            head = dcfifo[0]
            if len(bm[head]) < cfg.bm_fifo_depth:
                bm[head].append(dcfifo.popleft())
                progressed = True
            else:
                break                              # HoL block (ready/valid)
                # (credit mode never hits this: space was reserved)

        # 4. layer engines (last to first so same-cycle hand-off works)
        for lid in reversed(range(L)):
            if cycle < start_skew[lid]:
                continue
            src_ok = (lid == 0) or bool(acts[lid])
            dst_ok = len(acts[lid + 1]) < cfg.act_fifo_depth or lid == L - 1
            if not (src_ok and dst_ok):
                if lid == L - 1:
                    stall += 1
                continue
            if weight_need[lid] > 0:
                if bm[lid]:
                    bm[lid].popleft()
                    got_words[lid] += 1
                    weight_need[lid] -= 1
                    if mode == "credit":
                        credits[lid] += 1
                    progressed = True
                else:
                    if lid == L - 1:
                        stall += 1
                    continue
            if weight_need[lid] == 0:
                weight_need[lid] = wpa[lid]
                if lid > 0:
                    acts[lid].popleft()
                if lid == L - 1:
                    outputs += 1
                else:
                    acts[lid + 1].append(1)
                progressed = True

        if progressed:
            last_progress = cycle
        elif cycle - last_progress > cfg.deadlock_window:
            return SimOutcome(False, True, cycle, outputs, stall, got_words)

    return SimOutcome(outputs >= cfg.outputs_needed, False, cycle, outputs,
                      stall, got_words)


def fig5_scenario() -> SimConfig:
    """The paper's deadlock setup: three consecutive layers share one
    DCFIFO; the downstream layer's burst-matching FIFO fills while it waits
    on activations that can only come from the upstream layer — whose
    weights are stuck behind the head of the DCFIFO."""
    return SimConfig(
        n_layers=3,
        burst=4,
        bm_fifo_depth=4,
        act_fifo_depth=1,
        dcfifo_depth=8,
        hbm_latency=6,
        weights_per_act=(8, 1, 1),     # layer 0 is weight-hungry
        outputs_needed=32,
    )


def demo() -> Dict[str, SimOutcome]:
    """Run the Fig. 5 scenario both ways (used by tests and benchmarks)."""
    cfg = fig5_scenario()
    skew = [0, 40, 80]                # §V-A start-up skew
    return {
        "ready_valid": simulate(cfg, "ready_valid", start_skew=skew),
        "credit": simulate(cfg, "credit", start_skew=skew),
    }
