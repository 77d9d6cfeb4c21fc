"""The port's ``core/admission.py`` against the JAX package's, on the CPU.

Both modules are plain Python, so the same inputs must give the same
values, not just the same laws: the tick-law replays (flat and staged)
give equal traces over a grid of capacities, latencies, stage counts and
item counts; the weighted-fair scheduler makes the same picks, charges
the same deficits and promotes the same heads on seeded backlogs with
deadlines, idle tenants and mid-rotation unregistration; Jain's index is
equal; and the errors name the same faults.  The port's controller keeps
its invariants when the replays drive it, and its flat replay agrees
with the port's own ``fifo_sim`` on the single-engine law topology.
"""
import dataclasses
import random

import pytest

from repro.core import admission as jadm
from repro_torch.core import admission as tadm
from repro_torch.core import fifo_sim
from repro_torch.obs.trace import monotonic_clock

CAPACITIES = (1, 2, 3, 5, 8)
LATENCIES = (0, 1, 3, 7)
ITEMS = (1, 7, 32)


@pytest.mark.parametrize("items", ITEMS)
@pytest.mark.parametrize("latency", LATENCIES)
@pytest.mark.parametrize("capacity", CAPACITIES)
def test_replay_schedule_equals_jax(capacity, latency, items):
    got = tadm.replay_schedule(items, capacity=capacity,
                               latency_ticks=latency)
    want = jadm.replay_schedule(items, capacity=capacity,
                                latency_ticks=latency)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.max_in_flight == min(capacity, latency + 1, items)


@pytest.mark.parametrize("items", (1, 9, 24))
@pytest.mark.parametrize("extra", (None, -1, 0, 2))
@pytest.mark.parametrize("stages", (1, 2, 4, 6))
def test_replay_staged_schedule_equals_jax(stages, extra, items):
    """``extra`` None is the default capacity (one credit a stage); -1 a
    bound tighter than the ring, which stalls admission."""
    capacity = None if extra is None else max(1, stages + extra)
    got = tadm.replay_staged_schedule(items, n_stages=stages,
                                      capacity=capacity)
    want = jadm.replay_staged_schedule(items, n_stages=stages,
                                       capacity=capacity)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.max_stage_occupancy <= 1


def _law_sim(capacity, latency, n):
    """The port's fifo_sim in credit mode on the single-engine law
    topology: the prefetcher's credits are the admission credits."""
    return fifo_sim.simulate(fifo_sim.SimConfig(
        n_layers=1, burst=1, bm_fifo_depth=capacity, act_fifo_depth=1,
        dcfifo_depth=max(64, capacity), hbm_latency=latency,
        weights_per_act=(1,), outputs_needed=n), "credit")


@pytest.mark.parametrize("capacity,latency,n",
                         [(1, 1, 5), (2, 5, 20), (4, 3, 17), (8, 40, 50),
                          (3, 12, 1)])
def test_replay_matches_port_fifo_sim(capacity, latency, n):
    sim = _law_sim(capacity, latency, n)
    trace = tadm.replay_schedule(n, capacity=capacity,
                                 latency_ticks=latency)
    assert sim.completed and not sim.deadlocked
    assert trace.makespan == sim.cycles
    assert trace.idle_ticks == sim.stall_cycles


@pytest.mark.parametrize("staged", [False, True])
def test_controller_invariants_under_replay(staged):
    """A caller's controller carries the whole schedule: every tick's
    invariants held, its counters show every item, it ends quiescent and
    can replay again; busy, closed or mis-sized controllers are refused
    as in the JAX package."""
    ctl = tadm.AdmissionController(4)
    for _ in range(2):
        if staged:
            trace = tadm.replay_staged_schedule(9, n_stages=4, capacity=4,
                                                controller=ctl)
        else:
            trace = tadm.replay_schedule(9, capacity=4, latency_ticks=3,
                                         controller=ctl)
        assert trace.makespan == 9 + 4 - 1
        ctl.check_invariants()
        ctl.assert_quiescent()
    assert ctl.admitted_total == ctl.completed_total == 18
    assert ctl.max_in_flight_seen == 4

    def replay(mod, c, **kw):
        if staged:
            return mod.replay_staged_schedule(1, n_stages=2, controller=c,
                                              **kw)
        return mod.replay_schedule(1, latency_ticks=1, controller=c, **kw)

    for mod in (tadm, jadm):
        with pytest.raises(ValueError, match="capacity"):
            replay(mod, mod.AdmissionController(3), capacity=2)
        busy = mod.AdmissionController(2)
        assert busy.try_acquire()
        with pytest.raises(ValueError, match="open and idle"):
            replay(mod, busy, capacity=2)
        busy.release()
        busy.close()
        with pytest.raises(ValueError, match="open and idle"):
            replay(mod, busy, capacity=2)
    for mod in (tadm, jadm):
        with pytest.raises(ValueError, match="latency_ticks"):
            mod.replay_schedule(1, capacity=1, latency_ticks=-1)
        with pytest.raises(ValueError, match="n_stages"):
            mod.replay_staged_schedule(1, n_stages=0)


def test_controller_clock_is_the_obs_clock():
    assert tadm.AdmissionController(1).clock is monotonic_clock


# ---------------------------------------------------------------------------
# the weighted-fair scheduler
# ---------------------------------------------------------------------------


def _scheduler_state(s):
    return (s.tenants, dict(s._deficit), dict(s.picks),
            dict(s.served_cost), s.promotions, s._cursor, s._granted)


def _drive(seed, quantum):
    """One seeded scenario through both schedulers: tenants of random
    weights, random head costs, some heads with deadlines (past or
    future), idle tenants, and a tenant unregistered mid-rotation and
    another registered late.  Returns the pick sequences."""
    rng = random.Random(seed)
    ts, js = (tadm.WeightedFairScheduler(quantum=quantum),
              jadm.WeightedFairScheduler(quantum=quantum))
    names = [f"t{i}" for i in range(rng.randint(2, 5))]
    for n in names:
        w = rng.choice((0.5, 1.0, 2.0, 4.0, 8.0))
        ts.register(n, w)
        js.register(n, w)
    got, want = [], []
    for step in range(300):
        if step == 120:
            gone = rng.choice(ts.tenants)
            ts.unregister(gone)
            js.unregister(gone)
        if step == 200:
            ts.register("late", 3.0)
            js.register("late", 3.0)
        backlog = {}
        for n in ts.tenants:
            if rng.random() < 0.8:
                deadline = (rng.uniform(-5.0, 20.0)
                            if rng.random() < 0.15 else None)
                backlog[n] = (float(rng.randint(1, 8)), deadline)
        if not backlog:
            continue
        now = float(step)
        got.append(ts.pick({k: tadm.HeadOfQueue(c, step + d if d else None)
                            for k, (c, d) in backlog.items()}, now=now))
        want.append(js.pick({k: jadm.HeadOfQueue(c, step + d if d else None)
                             for k, (c, d) in backlog.items()}, now=now))
        assert _scheduler_state(ts) == _scheduler_state(js), step
    return got, want, ts


@pytest.mark.parametrize("quantum", (0.5, 1.0, 3.0))
@pytest.mark.parametrize("seed", range(6))
def test_weighted_fair_picks_equal_jax(seed, quantum):
    got, want, sched = _drive(seed, quantum)
    assert got == want
    assert len(got) > 200
    assert sched.promotions > 0


@pytest.mark.parametrize("weights", [(1, 4), (1, 2, 3), (8, 1, 1, 2)])
def test_weighted_fair_long_run_shares_track_weights(weights):
    s = tadm.WeightedFairScheduler()
    for i, w in enumerate(weights):
        s.register(i, float(w))
    backlog = {i: tadm.HeadOfQueue(1.0) for i in range(len(weights))}
    n = 100 * sum(weights)
    for _ in range(n):
        s.pick(backlog)
    for i, w in enumerate(weights):
        assert abs(s.picks[i] - n * w / sum(weights)) <= sum(weights) + 1


def test_weighted_fair_deadline_promotion_charges_deficit():
    s = tadm.WeightedFairScheduler()
    s.register("heavy", 8.0)
    s.register("urgent", 0.5)
    backlog = {"heavy": tadm.HeadOfQueue(1.0),
               "urgent": tadm.HeadOfQueue(1.0, deadline=5.0)}
    assert s.pick(backlog, now=0.0) == "heavy"
    assert s.pick(backlog, now=6.0) == "urgent"
    assert s.promotions == 1 and s._deficit["urgent"] < 0.0
    b2 = {"heavy": tadm.HeadOfQueue(1.0, deadline=4.0),
          "urgent": tadm.HeadOfQueue(1.0, deadline=1.0)}
    assert s.pick(b2, now=10.0) == "urgent"


def test_weighted_fair_unregister_mid_rotation_equals_jax():
    """The cursor cases of ``unregister``: a tenant before, at and after
    the cursor, and the last one."""
    for gone in ("a", "c", "d"):
        ts, js = tadm.WeightedFairScheduler(), jadm.WeightedFairScheduler()
        for s in (ts, js):
            for k in ("a", "b", "c", "d"):
                s.register(k, 1.0 + len(k))
        for s, mod in ((ts, tadm), (js, jadm)):
            s.pick({"c": mod.HeadOfQueue(5.0)})
            s.unregister(gone)
        assert _scheduler_state(ts) == _scheduler_state(js)
        rest = [k for k in ("a", "b", "c", "d") if k != gone]
        got = [ts.pick({k: tadm.HeadOfQueue(1.0) for k in rest})
               for _ in range(12)]
        want = [js.pick({k: jadm.HeadOfQueue(1.0) for k in rest})
                for _ in range(12)]
        assert got == want
    for s in (tadm.WeightedFairScheduler(), jadm.WeightedFairScheduler()):
        s.register("only")
        s.unregister("only")
        assert s.tenants == [] and s._cursor == 0


def test_weighted_fair_validation_and_nonconvergence_equal_jax():
    for mod in (tadm, jadm):
        s = mod.WeightedFairScheduler()
        with pytest.raises(ValueError, match="quantum"):
            mod.WeightedFairScheduler(quantum=0.0)
        s.register("a", 2.0)
        with pytest.raises(ValueError, match="already"):
            s.register("a")
        with pytest.raises(ValueError, match="weight"):
            s.register("b", 0.0)
        with pytest.raises(ValueError, match="at least one"):
            s.pick({})
        with pytest.raises(ValueError, match="not registered"):
            s.pick({"ghost": mod.HeadOfQueue(1.0)})
        with pytest.raises(ValueError, match="not registered"):
            s.unregister("ghost")
        tiny = mod.WeightedFairScheduler(quantum=1e-12)
        tiny.register("a", 1.0)
        with pytest.raises(RuntimeError, match="converge"):
            tiny.pick({"a": mod.HeadOfQueue(1e12)})


@pytest.mark.parametrize("seed", range(5))
def test_jain_fairness_equals_jax(seed):
    rng = random.Random(seed)
    shares = {i: rng.choice((0.0, rng.uniform(0.0, 10.0)))
              for i in range(rng.randint(1, 6))}
    assert tadm.jain_fairness(shares) == jadm.jain_fairness(shares)
    for fixed in ({}, {"a": 0.0}, {"a": 1.0, "b": 0.0},
                  {"a": 1.0, "b": 1.0, "c": 1.0, "d": 0.0}):
        assert tadm.jain_fairness(fixed) == jadm.jain_fairness(fixed)
