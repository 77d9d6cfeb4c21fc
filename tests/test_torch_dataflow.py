"""The port's stage ring (core/dataflow.py) on CPU stage meshes.

The JAX package gets multi-stage meshes by forcing host devices in a
subprocess; the port's mesh may repeat a device, so 1-, 2-, 4- and
8-stage rings run here in one process on ``["cpu"] * S``.  Held:
``split_stages`` / ``pipeline_stats`` and their errors against the JAX
package's, the fill law against the port's ``replay_staged_schedule``,
the tick schedule itself (stage ``s`` on microbatch ``t - s``), toy
homogeneous and heterogeneous rings bit-identical to the port's
sequential composition, and the same toys against the JAX package's
``staged_pipeline_apply``: bit for bit with an int8 carry, within
``FLOAT_TOL`` in float32, where JAX's ``tanh`` and products round apart
from PyTorch's (JAX's own ring differs from its ``vmap`` there by 5.8e-11
absolute, tests/test_dataflow.py's failing single-stage test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dataflow as jdf
from repro.launch.mesh import compat_make_mesh as jax_mesh
from repro_torch.core.admission import replay_staged_schedule
from repro_torch.core.dataflow import (StageRing, pipeline_apply,
                                       pipeline_stats, split_stages,
                                       staged_pipeline_apply)
from repro_torch.launch.mesh import (Mesh, compat_make_mesh,
                                     mesh_axis_sizes)

# float32 toy against the JAX package: (rtol, atol), some f32 ulps of
# the |y| <= 1 outputs of tanh over up to 16 layers
FLOAT_TOL = (1e-5, 1e-6)
STAGE_COUNTS = (1, 2, 4, 8)


def _mesh(S, axis="model"):
    return compat_make_mesh((S,), (axis,), devices=["cpu"] * S)


def test_split_stages():
    p = {"w": torch.zeros((16, 4, 4)), "b": [torch.zeros(16)]}
    s = split_stages(p, 8)
    assert s["w"].shape == (8, 2, 4, 4) and s["b"][0].shape == (8, 2)
    with pytest.raises(ValueError, match="cannot split 15"):
        split_stages({"w": torch.zeros((15, 4))}, 8)
    with pytest.raises(ValueError, match="n_stages"):
        split_stages(p, 0)


@pytest.mark.parametrize("S,M", [(1, 1), (8, 24), (3, 7), (5, 2)])
def test_pipeline_stats_match_jax(S, M):
    st = pipeline_stats(n_stages=S, n_microbatches=M)
    assert st == jdf.pipeline_stats(n_stages=S, n_microbatches=M)
    assert st["ticks"] == M + S - 1 and st["in_flight_credits"] == S


@pytest.mark.parametrize("S", (1, 2, 3, 5, 8))
def test_fill_law_matches_staged_replay(S):
    """pipeline_stats' M + S - 1 ticks are the staged admission replay's
    makespan, and the replay holds one microbatch a stage."""
    for M in (1, 2, 7, 24):
        st = pipeline_stats(n_stages=S, n_microbatches=M)
        tr = replay_staged_schedule(M, n_stages=S)
        assert tr.makespan == st["ticks"] == M + S - 1
        assert tr.max_in_flight <= st["in_flight_credits"]
        assert tr.max_stage_occupancy <= 1


def test_mesh():
    m = compat_make_mesh((2, 3), ("data", "model"), devices=["cpu"] * 6)
    assert isinstance(m, Mesh)
    assert mesh_axis_sizes(m) == {"data": 2, "model": 3}
    assert m.axis_devices("model") == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="no axis"):
        m.axis_devices("pipe")
    with pytest.raises(ValueError, match="3 device"):
        compat_make_mesh((4,), ("model",), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="differ in length"):
        compat_make_mesh((4,), ("data", "model"), devices=["cpu"] * 4)


def test_mesh_has_no_cpu_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        compat_make_mesh((2,), ("model",))


def _toy(seed, L, d):
    g = torch.Generator().manual_seed(seed)
    Ws = torch.randn((L, d, d), generator=g) * 0.1

    def layer_fn(p, x):
        for w in p["w"]:
            x = torch.tanh(x @ w)
        return x

    def ref(x):
        for w in Ws:
            x = torch.tanh(x @ w)
        return x
    return Ws, layer_fn, ref


def test_pipeline_apply_validates_inputs():
    mesh = _mesh(1)
    Ws, layer_fn, _ = _toy(0, 4, 4)
    x_mb = torch.zeros((3, 2, 4))
    with pytest.raises(ValueError, match="no axis 'data'"):
        pipeline_apply(layer_fn, split_stages({"w": Ws}, 1), x_mb,
                       mesh=mesh, axis="data")
    with pytest.raises(ValueError, match="split_stages"):
        pipeline_apply(layer_fn, {"w": Ws}, x_mb, mesh=mesh)
    with pytest.raises(ValueError, match=r"\[M, mb, \.\.\.\]"):
        pipeline_apply(layer_fn, split_stages({"w": Ws}, 1),
                       torch.zeros((3,)), mesh=mesh)


@pytest.mark.parametrize("S", STAGE_COUNTS)
def test_pipeline_apply_matches_sequential(S):
    """The homogeneous ring adds scheduling, never arithmetic: bit for
    bit the sequential apply, for several microbatch counts."""
    for i, (M, mb) in enumerate([(1, 2), (3, 2), (5, 1), (11, 3)]):
        Ws, layer_fn, ref = _toy(i, 16, 8)
        x_mb = torch.randn((M, mb, 8),
                           generator=torch.Generator().manual_seed(100 + i))
        out = pipeline_apply(layer_fn, split_stages({"w": Ws}, S), x_mb,
                             mesh=_mesh(S))
        assert torch.equal(out, torch.stack([ref(x) for x in x_mb]))


def test_staged_pipeline_validates_inputs():
    mesh = _mesh(1)
    fn = lambda p, x: x                              # noqa: E731
    x_mb = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="stage programs"):
        staged_pipeline_apply([fn, fn], {}, x_mb, mesh=mesh,
                              boundary_shapes=[None, (3, 4)],
                              out_shape=(3, 4))
    with pytest.raises(ValueError, match="boundary_shapes"):
        staged_pipeline_apply([fn], {}, x_mb, mesh=mesh,
                              boundary_shapes=[], out_shape=(3, 4))
    with pytest.raises(ValueError, match="no axis"):
        staged_pipeline_apply([fn], {}, x_mb, mesh=mesh, axis="data",
                              boundary_shapes=[None], out_shape=(3, 4))
    with pytest.raises(ValueError, match=r"\[M, mb, \.\.\.\]"):
        staged_pipeline_apply([fn], {}, torch.zeros(4), mesh=mesh,
                              boundary_shapes=[None], out_shape=(3, 4))
    with pytest.raises(ValueError, match="expected out_shape"):
        staged_pipeline_apply([fn], {}, x_mb, mesh=mesh,
                              boundary_shapes=[None], out_shape=(3, 5))
    with pytest.raises(ValueError, match="declares boundary shape"):
        staged_pipeline_apply([fn, fn], {}, x_mb, mesh=_mesh(2),
                              boundary_shapes=[None, (3, 5)],
                              out_shape=(3, 4))
    with pytest.raises(ValueError, match="one device type"):
        StageRing([fn, fn], ["cpu", "meta"], boundary_shapes=[None, (3, 4)],
                  out_shape=(3, 4))


WIDTHS = (6, 10, 3, 8, 5, 7, 4, 9, 6)        # stage s: widths[s] -> [s+1]


def _hetero(S, seed=0):
    """S float32 stages of different programs and boundary widths, and
    the same weights as numpy."""
    w = WIDTHS[:S + 1]
    Ws = [np.random.default_rng(seed + s).normal(0, 0.3, (w[s], w[s + 1]))
          .astype(np.float32) for s in range(S)]
    params = {f"w{s}": torch.from_numpy(Ws[s]) for s in range(S)}
    fns = [lambda p, x, _s=s: torch.tanh(x @ p[f"w{_s}"]) for s in range(S)]
    return w, Ws, params, fns


@pytest.mark.parametrize("S", STAGE_COUNTS)
def test_staged_heterogeneous_matches_sequential(S):
    w, Ws, params, fns = _hetero(S)
    for M, mb in ((1, 2), (7, 2), (3, 1)):
        x_mb = torch.from_numpy(np.random.default_rng(M).normal(
            0, 1, (M, mb, w[0])).astype(np.float32))
        out = staged_pipeline_apply(
            fns, params, x_mb, mesh=_mesh(S),
            boundary_shapes=[None] + [(mb, w[s]) for s in range(1, S)],
            out_shape=(mb, w[S]), out_dtype=torch.float32,
            carry_dtype=torch.float32)
        want = []
        for x in x_mb:
            for fn in fns:
                x = fn(params, x)
            want.append(x)
        assert torch.equal(out, torch.stack(want))


def _jax_ring(jfn, params, x_mb, out_shape, carry):
    """The JAX package's staged_pipeline_apply on its one CPU device,
    with the whole stage composition as its one stage."""
    mesh = jax_mesh((1,), ("model",))
    with mesh:
        return np.asarray(jdf.staged_pipeline_apply(
            [jfn], params, jnp.asarray(x_mb), mesh=mesh,
            boundary_shapes=[None], out_shape=out_shape,
            out_dtype=jnp.float32, carry_dtype=carry))


@pytest.mark.parametrize("S", STAGE_COUNTS)
def test_staged_float_toy_matches_jax_within_tolerance(S):
    w, Ws, params, fns = _hetero(S, seed=10)
    M, mb = 5, 2
    x_mb = np.random.default_rng(1).normal(0, 1, (M, mb, w[0])) \
        .astype(np.float32)
    out = staged_pipeline_apply(
        fns, params, torch.from_numpy(x_mb), mesh=_mesh(S),
        boundary_shapes=[None] + [(mb, w[s]) for s in range(1, S)],
        out_shape=(mb, w[S]), carry_dtype=torch.float32)

    def jfn(p, x):
        for s in range(S):
            x = jnp.tanh(x @ p[f"w{s}"])
        return x
    want = _jax_ring(jfn, {f"w{s}": Ws[s] for s in range(S)}, x_mb,
                     (mb, w[S]), jnp.float32)
    np.testing.assert_allclose(out.numpy(), want, rtol=FLOAT_TOL[0],
                               atol=FLOAT_TOL[1])


def _int8_stage(x, w, shift):
    """int8 x int8 -> int32 sums, shifted, clipped back to int8."""
    y = x.to(torch.int32) @ w.to(torch.int32)
    return torch.clamp(y >> shift, -127, 127).to(torch.int8)


@pytest.mark.parametrize("S", STAGE_COUNTS)
def test_staged_int8_carry_bit_identical_to_jax(S):
    """An int8 ring (exact integer stages, int8 boundaries, the CNN's
    carry) equals the JAX package's bit for bit."""
    w = WIDTHS[:S + 1]
    rng = np.random.default_rng(S)
    Ws = [rng.integers(-127, 128, (w[s], w[s + 1]), dtype=np.int8)
          for s in range(S)]
    M, mb = 6, 3
    x_mb = rng.integers(-127, 128, (M, mb, w[0]), dtype=np.int8)
    params = {f"w{s}": torch.from_numpy(Ws[s]) for s in range(S)}
    fns = [lambda p, x, _s=s: _int8_stage(x, p[f"w{_s}"], 7)
           for s in range(S)]
    out = staged_pipeline_apply(
        fns, params, torch.from_numpy(x_mb), mesh=_mesh(S),
        boundary_shapes=[None] + [(mb, w[s]) for s in range(1, S)],
        out_shape=(mb, w[S]))
    assert out.dtype == torch.float32

    def jfn(p, x):
        for s in range(S):
            y = x.astype(jnp.int32) @ p[f"w{s}"].astype(jnp.int32)
            x = jnp.clip(y >> 7, -127, 127).astype(jnp.int8)
        return x
    want = _jax_ring(jfn, {f"w{s}": Ws[s] for s in range(S)}, x_mb,
                     (mb, w[S]), jnp.int8)
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("S", STAGE_COUNTS)
def test_ring_follows_the_static_schedule(S):
    """Stage s runs microbatch t - s at tick t: each stage sees the
    microbatches in order, once each, a tick's stages enqueued last to
    first, and microbatch m leaves the last stage at tick m + S - 1; at
    most one microbatch a stage and S in flight."""
    M, calls = 5, []

    def make(s):
        def fn(_p, x):
            calls.append((s, int(x[0, 0])))
            return x
        return fn
    x_mb = torch.arange(M, dtype=torch.int8).reshape(M, 1, 1)
    out = staged_pipeline_apply(
        [make(s) for s in range(S)], None, x_mb, mesh=_mesh(S),
        boundary_shapes=[None] + [(1, 1)] * (S - 1), out_shape=(1, 1))
    assert torch.equal(out, x_mb.float())
    ticks, i = [], 0
    for t in range(M + S - 1):
        live = [s for s in reversed(range(S)) if 0 <= t - s < M]
        ticks.append(live)
        assert calls[i:i + len(live)] == [(s, t - s) for s in live]
        assert len(live) <= S
        i += len(live)
    assert i == len(calls) == M * S
    done = [t for t, live in enumerate(ticks) if S - 1 in live]
    assert done == [m + S - 1 for m in range(M)]


def test_ring_uses_a_programs_static_input():
    """A stage program that carries ``static_in`` (a captured graph's
    input) gets each boundary copied into it and is called on it."""
    seen = []

    class Program:
        def __init__(self, shape):
            self.static_in = torch.zeros(shape, dtype=torch.int8)

        def __call__(self, _p, x):
            seen.append(x is self.static_in)
            return x + 1

    progs = [Program((2, 3)) for _ in range(3)]
    x_mb = torch.zeros((4, 2, 3), dtype=torch.int8)
    ring = StageRing(progs, ["cpu"] * 3, boundary_shapes=[None, (2, 3),
                                                          (2, 3)],
                     out_shape=(2, 3))
    for _ in range(2):
        assert torch.equal(ring.run(None, x_mb), torch.full((4, 2, 3), 3.))
    assert seen and all(seen)
    with pytest.raises(ValueError, match="static input"):
        StageRing(progs, ["cpu"] * 3, boundary_shapes=[None, (2, 4),
                                                       (2, 3)],
                  out_shape=(2, 3))
    with pytest.raises(ValueError, match="stage 0's input"):
        ring.run(None, torch.zeros((4, 2, 4), dtype=torch.int8))
