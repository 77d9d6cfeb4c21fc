"""The port's LM dry run (``launch/dryrun.py``) on the CPU: the depth and
microbatch extrapolation against the full count at a small depth (a
dense, a windowed, an alternating and an encoder-decoder stack), ``main``
in this process on ``meta`` (the cells the JAX package's
``tests/test_dryrun.py`` runs, in both meshes, and its SKIP), a row's
``model_flops`` against the JAX package's ``count_params`` formula, and
the per-device argument bytes against what the JAX package's specs give
for the same leaves."""
import dataclasses
import json
import math

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.configs import shape_applicable as jax_shape_applicable
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tmod
from repro.models.accounting import count_params as jax_count_params
from repro.optim import adamw as jax_adamw
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.models import layers


def small(name, n_layers, **kw):
    return dataclasses.replace(get_arch(name).reduced(), n_layers=n_layers,
                               **kw)


@pytest.fixture
def restore_modes():
    yield
    layers.set_kernel_mode(True)
    layers.set_mesh_axis_sizes({})


@pytest.mark.parametrize("kind,batch", [("train", 64), ("prefill", 2),
                                        ("decode", 2)])
@pytest.mark.parametrize("arch", [
    small("phi4-mini-3.8b", 5),                     # dense, period 1
    small("gemma2-9b", 6),                          # local/global, period 2
    small("xlstm-125m", 6),                         # mLSTM/sLSTM, period 2
    small("seamless-m4t-medium", 3, n_enc_layers=4),  # two stacks
], ids=["dense", "windowed", "alternating", "enc-dec"])
def test_extrapolation_equals_the_full_count(arch, kind, batch,
                                            restore_modes):
    """Train at batch 64 accumulates 8 microbatches: extrapolated from 2
    and 3 as well as from the shallow depths.  Kernel mode off, as the
    dry run's default."""
    layers.set_kernel_mode(False)
    shape = ShapeConfig("small", 32, batch, kind)
    points, _, steps = dryrun.corners(arch, shape)
    assert len(steps) == 2 ** len(points) > 1
    if kind == "train":
        assert dryrun.train_microbatches(shape) == 8 and (2, 3) in points
    assert dryrun.extrapolated_cost(arch, shape) == \
        dryrun.step_cost(arch, shape)


@pytest.mark.parametrize("kind,batch", [("train", 64), ("prefill", 2)])
def test_extrapolation_with_the_kernels_charged(kind, batch, restore_modes):
    """Kernel mode on: the flash kernels' charges extrapolate too."""
    layers.set_kernel_mode(True)
    arch = small("phi4-mini-3.8b", 4, head_dim=32)
    shape = ShapeConfig("small", 128, batch, kind)
    assert dryrun.extrapolated_cost(arch, shape) == \
        dryrun.step_cost(arch, shape)


def test_a_depth_the_period_does_not_divide_is_counted_whole():
    arch = small("gemma2-9b", 5)
    points, target, steps = dryrun.corners(arch, ShapeConfig("s", 32, 2,
                                                             "prefill"))
    assert points == () and steps == [({}, None)]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_main_counts_a_cell(mesh, tmp_path, capsys, restore_modes):
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                        "--mesh", mesh, "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "PASS xlstm-125m x decode_32k" in text
    assert "roofline:" in text
    row, = json.loads(out.read_text())
    assert row["mesh"] == ("16x16" if mesh == "single" else "2x16x16")
    assert row["skipped"] is None and row["t_collective_s"] is None
    assert row["coll_detail"] == {"note": "not counted: no SPMD partitioner"}
    assert row["plan"].startswith("replicated=")


def test_worker_processes_count_as_one(tmp_path, capsys, restore_modes):
    """``--jobs 2`` counts the cell's corners in two worker processes and
    gives the rows one process gives, on both meshes."""
    rows = []
    for jobs in ("1", "2"):
        out = tmp_path / f"r{jobs}.json"
        assert dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                            "--mesh", "both", "--jobs", jobs,
                            "--out", str(out)]) == 0
        rows.append([{k: v for k, v in r.items() if k != "compile_s"}
                     for r in json.loads(out.read_text())])
    assert "counted 1 cells on meta with 2 processes" in \
        capsys.readouterr().out
    assert len(rows[0]) == 2 and rows[0] == rows[1]


def test_main_prints_the_skip(tmp_path, capsys, restore_modes):
    assert dryrun.main(["--arch", "gemma2-9b", "--shape", "long_500k",
                        "--mesh", "single",
                        "--out", str(tmp_path / "r.json")]) == 0
    text = capsys.readouterr().out
    assert "SKIP gemma2-9b x long_500k" in text and "long_500k" in text


@pytest.mark.parametrize("shape_id", list(SHAPES))
@pytest.mark.parametrize("name", ARCH_IDS)
def test_the_skips_are_the_jax_packages(name, shape_id):
    """The cells the dry run skips (``shape_applicable``) and why."""
    assert shape_applicable(get_arch(name), SHAPES[shape_id]) == \
        jax_shape_applicable(jax_get_arch(name), JAX_SHAPES[shape_id])


def test_main_fails_on_a_failing_cell(tmp_path, capsys, restore_modes):
    assert dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                        "--mesh", "single",
                        "--out", str(tmp_path / "r.json")]) == 1
    assert "FAIL no-such-arch" in capsys.readouterr().out


@pytest.mark.parametrize("shape_id", list(SHAPES))
@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "qwen2-moe-a2.7b",
                                  "xlstm-125m", "seamless-m4t-medium"])
def test_model_flops_is_the_jax_formula(name, shape_id):
    shape = SHAPES[shape_id]
    n_act = jax_count_params(jax_get_arch(name), active_only=True)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mf, t = dryrun.model_flops(get_arch(name), shape)
    assert t == tokens
    assert mf == (6 if shape.kind == "train" else 2) * n_act * tokens


def _jax_sharded_bytes(tree, specs, sizes):
    """Per-device bytes under the JAX package's specs, leaf for leaf."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= sizes.get(a, 1) if a is not None else 1
        total += -(-math.prod(leaf.shape) * leaf.dtype.itemsize // n)
    return total


@pytest.mark.parametrize("shape_id", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "xlstm-125m"])
def test_argument_bytes_match_the_jax_specs(name, shape_id, restore_modes):
    """Params by their specs (the plan off), the AdamW state by
    ``state_specs``, the cache by ``cache_specs``: the JAX package's specs
    on its own abstract trees give the same per-device bytes."""
    sizes = {"data": 16, "model": 16}
    layers.set_mesh_axis_sizes(sizes)
    jax_layers.set_mesh_axis_sizes(sizes)
    try:
        from repro_torch.launch.mesh import make_production_mesh
        shape = SHAPES[shape_id]
        arch = get_arch(name)
        info = dryrun.lower_cell(arch, shape, make_production_mesh(),
                                 stream_plan=False,
                                 count=dryrun.Cost())
        jarch = jax_get_arch(name)
        jparams = jax.eval_shape(lambda: jax_tmod.init_params(
            jax.random.PRNGKey(0), jarch))
        jspecs = jax_tmod.param_specs(jarch)
        got = info["arg_bytes"]
        assert got["params"] == _jax_sharded_bytes(jparams, jspecs, sizes)
        if shape.kind == "train":
            cfg = jax_adamw.AdamWConfig()
            jopt = jax.eval_shape(lambda p: jax_adamw.init(p, cfg), jparams)
            assert got["opt"] == _jax_sharded_bytes(
                jopt, jax_adamw.state_specs(jparams, jspecs, cfg), sizes)
        else:
            jcache = jax.eval_shape(lambda: jax_tmod.init_cache(
                jarch, shape.global_batch, shape.seq_len))
            assert got["cache"] == _jax_sharded_bytes(
                jcache, jax_tmod.cache_specs(jarch, shape.global_batch),
                sizes)
        assert got["total"] == sum(v for k, v in got.items() if k != "total")
    finally:
        jax_layers.set_mesh_axis_sizes({})


@pytest.mark.parametrize("kind,batch", [("train", 2), ("prefill", 2),
                                        ("decode", 2)])
def test_a_real_step_counts_as_the_meta_one(kind, batch, restore_modes):
    """A step run for real (here on the CPU, random weights and tokens)
    counts what its cell counts on ``meta``, extrapolated from the first
    layers: the check the card runs on Phi-4-mini at full size."""
    import torch
    layers.set_kernel_mode(False)
    arch = small("phi4-mini-3.8b", 4)
    shape = ShapeConfig("small", 32, batch, kind)
    params = dryrun.tmod.init_params(torch.Generator().manual_seed(0), arch,
                                     "cpu")
    on_cpu = dryrun.step_cost(arch, shape, params=params, device="cpu")
    assert on_cpu == dryrun.extrapolated_cost(arch, shape)
    assert on_cpu == dryrun.extrapolated_cost(arch, shape, device="cpu")
    assert on_cpu.matmul_flops > 0
