"""Stall attribution: measured host fractions vs modelled stall cycles.

H2PIPE's §VI evaluation is a *bandwidth efficiency* claim: achieved
throughput laid against the theoretical HBM limit, with every lost cycle
attributed to a stall source (FIFO credit starvation, burst-matching
depth, pseudo-channel contention).  The reproduction models that side
exactly (``fifo_sim`` credit mode over the streamed set); this module
closes the loop by laying the *measured* serving-side fractions next to
it, in one JSON-safe dict that rides on
:class:`~repro_torch.runtime.cnn_serving.ServingReport.bandwidth_efficiency`:

  * **measured** (host wall clock on the serving engine's injected
    clock):
      - ``admission_wait_fraction`` — time the dispatcher spent blocked
        on the §V-A credit bound, over the serving wall.  The runtime
        analogue of the paper's FIFO-credit stalls: credits exhausted
        means the device (HBM) side is the bottleneck;
      - ``dispatch_gap_fraction`` — time the dispatcher spent with NO
        work to pack (queue empty between dispatches), over the wall.
        Gaps mean the *supply* side starved the pipeline — the
        complement of admission waits;
  * **modelled** (deterministic ``fifo_sim`` credit-mode replay of the
    plan's streamed set): tail-engine ``stall_cycles`` over total
    ``cycles``, plus the per-engine word deliveries the simulation
    produced — the §VI per-engine view.

The two halves answer the paper's question for a real serving interval:
of the cycles we lost, how many does the model predict (FIFO/credit
structure) and how many are measured host effects (arrival gaps,
dispatch overhead) that no FIFO depth can fix.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

__all__ = ["stall_attribution"]


def _fraction(num: float, den: float) -> float:
    return num / den if den > 0 else 0.0


def stall_attribution(*, wall_s: float, admission_wait_s: float,
                      dispatch_gap_s: float,
                      modelled: Optional[Any] = None,
                      engine_names: Sequence[str] = (),
                      word_scale: Optional[int] = None
                      ) -> Dict[str, Any]:
    """Build the ``bandwidth_efficiency`` report section.

    ``modelled`` is a ``fifo_sim.SimOutcome`` (duck-typed: ``cycles``,
    ``stall_cycles``, ``outputs``, ``completed``,
    ``per_layer_weight_words``) or ``None`` when the plan streams
    nothing; ``engine_names`` are the streamed engines in the sim's
    layer order, ``word_scale`` the demand divisor the sim ran under
    (so per-engine words can be rescaled by readers).

    ``engine_names`` must be exactly as long as the sim's per-layer word
    list — a mismatch means the caller's name order and the sim topology
    drifted apart, and silently zipping them would misattribute words, so
    it raises :class:`ValueError` instead.  The per-engine view is
    emitted as ``per_engine_weight_word_rows`` — a list of
    ``[name, words]`` pairs that preserves duplicates and sim order —
    with the ``per_engine_weight_words`` dict kept as a compatibility
    view (duplicate names collapse there, last row wins).

    Both measured fractions are host wall-clock on shared machines —
    they carry meaning as *attribution* (which side of the pipeline
    starved), not as absolute performance.
    """
    out: Dict[str, Any] = {
        "wall_s": wall_s,
        "measured": {
            "admission_wait_s": admission_wait_s,
            "admission_wait_fraction": _fraction(admission_wait_s, wall_s),
            "dispatch_gap_s": dispatch_gap_s,
            "dispatch_gap_fraction": _fraction(dispatch_gap_s, wall_s),
        },
    }
    if modelled is not None:
        words = list(modelled.per_layer_weight_words)
        if len(engine_names) != len(words):
            raise ValueError(
                f"stall_attribution: {len(engine_names)} engine name(s) "
                f"for {len(words)} per-layer word count(s) — the streamed "
                f"set and the sim topology drifted apart")
        rows = [[name, w] for name, w in zip(engine_names, words)]
        out["modelled"] = {
            "stall_cycles": modelled.stall_cycles,
            "cycles": modelled.cycles,
            "stall_fraction": _fraction(modelled.stall_cycles,
                                        modelled.cycles),
            "outputs": modelled.outputs,
            "completed": modelled.completed,
            "word_scale": word_scale,
            "per_engine_weight_word_rows": rows,
            # compat view: duplicate engine names collapse (last wins);
            # readers that care about order/duplicates use the rows
            "per_engine_weight_words": dict(rows),
        }
    return out
