"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_import_with_jax_blocked():
    code = textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith("jax."):
                    raise ImportError("jax is blocked")
                return None

        sys.meta_path.insert(0, Block())
        import repro_torch
        import repro_torch.compiler, repro_torch.runtime.pipeline
        import repro_torch.kernels, repro_torch.convert
        import repro_torch.models.cnn, repro_torch.models.transformer
        import repro_torch.runtime.serving, repro_torch.launch.serve
        import repro_torch.kernels.flash_attention, repro_torch.configs
        import repro_torch.optim.adamw, repro_torch.runtime.trainer
        import repro_torch.ckpt.checkpoint, repro_torch.data.pipeline
        import repro_torch.launch.train
        import repro_torch.runtime.cnn_serving, repro_torch.obs.trace
        import repro_torch.obs.stall, repro_torch.obs.metrics
        import repro_torch.compiler.partition, repro_torch.core.dataflow
        import repro_torch.runtime.sharded_serving
        import repro_torch.launch.mesh
        import repro_torch.models.ffn, repro_torch.models.mla
        import repro_torch.configs.qwen2_moe_a2_7b
        import repro_torch.configs.deepseek_v2_236b
        import repro_torch.models.ssm
        import repro_torch.core.streaming, repro_torch.core.write_path
        import repro_torch.launch.dryrun, repro_torch.roofline.analysis
        import repro_torch.roofline.op_cost, repro_torch.roofline.hw
        from repro_torch.configs import ARCH_IDS, get_arch
        for name in ARCH_IDS:
            get_arch(name)
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "repro") or m.startswith(("jax.",
                                                               "repro.")))
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


IMPORT_RE = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s))", re.M)


def test_no_jax_or_repro_import_in_sources():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    offenders = [f"{p.relative_to(SRC)}: {m.group(0).strip()}"
                 for p in files for m in IMPORT_RE.finditer(p.read_text())]
    assert not offenders, offenders


EXAMPLES = SRC.parent / "examples_torch"
# what the port's examples may import: the port, torch, numpy and the
# standard library modules they use
EXAMPLE_IMPORTS = {"repro_torch", "torch", "numpy", "argparse",
                   "dataclasses", "tempfile", "threading", "time"}


def test_no_jax_or_repro_import_in_examples():
    files = sorted(EXAMPLES.glob("*.py"))
    assert len(files) == 6
    offenders = [f"{p.name}: {m.group(0).strip()}"
                 for p in files for m in IMPORT_RE.finditer(p.read_text())]
    assert not offenders, offenders


def test_examples_import_only_the_port_torch_and_numpy():
    import ast
    for p in sorted(EXAMPLES.glob("*.py")):
        tops = set()
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops.add(node.module.split(".")[0])
        assert tops <= EXAMPLE_IMPORTS, (p.name, tops - EXAMPLE_IMPORTS)


def test_chip_smoke_imports_no_jax():
    text = (SRC.parent / "chip_smoke.py").read_text()
    assert not IMPORT_RE.search(text)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_default_device_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.compiler import MINI, compile
    from repro_torch.configs.cnn import mini_resnet18
    from repro_torch.runtime.pipeline import PipelineExecutor, execute_cnn
    comp = compile(mini_resnet18(), MINI)
    x = torch.zeros((1, 32, 32, 3), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="CUDA"):
        comp.run({}, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineExecutor(comp)
    with pytest.raises(RuntimeError, match="CUDA"):
        execute_cnn(comp, {}, x)


def test_lm_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tmod
    from repro_torch.runtime.serving import ServingEngine
    arch = get_arch("phi4-mini-3.8b").reduced()
    params = tmod.init_params(torch.Generator().manual_seed(0), arch, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(params, arch)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "phi4-mini-3.8b", "--reduced"])


def test_dryrun_local_mesh_raises_without_cuda(no_cuda, tmp_path, capsys):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        make_local_mesh()
    assert dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "decode_32k",
                        "--mesh", "local",
                        "--out", str(tmp_path / "r.json")]) == 1
    assert "FAIL phi4-mini-3.8b" in capsys.readouterr().out


def test_train_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, TokenDataset
    from repro_torch.launch import train
    from repro_torch.runtime.trainer import TrainConfig, Trainer
    arch = get_arch("phi4-mini-3.8b").reduced()
    data = TokenDataset(DataConfig(arch.vocab_size, 32, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(arch, TrainConfig(ckpt_path=str(tmp_path)), data)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "phi4-mini-3.8b", "--reduced", "--ckpt",
                    str(tmp_path)])


def test_train_launcher_runs_on_cpu_when_asked(capsys, tmp_path):
    from repro_torch.launch import train
    assert train.main(["--arch", "phi4-mini-3.8b", "--reduced", "--device",
                       "cpu", "--steps", "4", "--seq-len", "32", "--batch",
                       "4", "--ckpt-every", "2", "--fail-at", "3",
                       "--ckpt", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert '"step": 4' in out and "done at step 4 on cpu" in out
    assert (tmp_path / "step_00000004" / "COMMITTED").exists()


def test_serve_launcher_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "phi4-mini-3.8b", "--reduced", "--device",
                       "cpu", "--requests", "3", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "9 tokens" in out


def test_unported_archs_raise():
    """An id the registry lacks raises ``KeyError``; every registered arch
    (all ten of the JAX package's) initialises at ``.reduced()``."""
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.models import transformer as tmod
    with pytest.raises(KeyError, match="available"):
        get_arch("gemma3-27b")
    assert len(ARCH_IDS) == 10
    for name in ARCH_IDS:
        params = tmod.init_params(torch.Generator().manual_seed(0),
                                  get_arch(name).reduced(), "cpu")
        assert "embed" in params, name


def test_fused_backend_raises():
    """The fused backend is the default and runs on the CPU (its trace is
    the eager walk there); an unknown backend, and images on another
    device than the executor's, raise."""
    from repro_torch.compiler import MINI, compile
    from repro_torch.configs.cnn import mini_resnet18
    from repro_torch.models.cnn import cnn_input_shape, init_cnn_params
    from repro_torch.runtime.pipeline import PipelineExecutor
    cfg = mini_resnet18(hw=8, width=16)
    comp = compile(cfg, MINI)
    params = init_cnn_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros(cnn_input_shape(cfg, 1), dtype=torch.int8)
    ex = PipelineExecutor(comp, device="cpu")
    assert ex.backend == "fused"
    fused, _ = ex.run(params, x)
    eager, _ = comp.run(params, x, device="cpu", backend="eager")
    assert torch.equal(fused, eager) and comp.trace_count == 1
    with pytest.raises(ValueError, match="backend"):
        PipelineExecutor(comp, device="cpu", backend="rtl")
    with pytest.raises(ValueError, match="executor"):
        ex.run(params, x.to("meta"))


def test_cpu_tensors_take_the_plain_version_only():
    """No launch is counted for CPU tensors, and CPU runs never touch the
    kernel build."""
    from repro_torch.kernels import LAUNCHES, conv2d_int8, reset_launches
    reset_launches()
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.ones((3, 3, 8, 4), dtype=torch.int8)
    y = conv2d_int8(x, w, stream=True)
    assert y.dtype == torch.int32 and y.shape == (1, 4, 4, 4)
    assert LAUNCHES == {}


def test_launch_counts_by_shape():
    """A wrapper that names its shape counts it beside the kernel; a
    captured graph's shapes count at each replay; a reset clears both."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import KERNEL, launch_shape
    shape = launch_shape(torch.bfloat16, 4, 16, 16, 1024, 1024, 64, 64,
                         False, 0, 0.0)
    assert shape == ("bfloat16", 4, 16, 16, 1024, 1024, 64, 64, False, 0,
                     0.0)
    _build.reset_launches()
    try:
        _build.count_launch(KERNEL, shape)
        _build.count_launch("maxpool_int8")
        with _build.capturing_launches() as graph:
            _build.count_launch(KERNEL, shape)
        assert graph.counts == {KERNEL: 1, (KERNEL, shape): 1}
        _build.count_replay(graph)
        _build.count_replay(graph)
        assert _build.LAUNCHES == {KERNEL: 3, "maxpool_int8": 1}
        assert _build.SHAPE_LAUNCHES == {(KERNEL, shape): 3}
    finally:
        _build.reset_launches()
    assert _build.LAUNCHES == {} and _build.SHAPE_LAUNCHES == {}


def _reference_exports(package: str):
    """The public names the JAX package's ``package/__init__.py`` imports
    or assigns (its ``__all__`` where it has one), parsed with ``ast``."""
    import ast
    tree = ast.parse((SRC / "repro" / package / "__init__.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if t.id == "__all__":
                        return list(ast.literal_eval(node.value))
                    names.append(t.id)
        elif isinstance(node, ast.FunctionDef):
            names.append(node.name)
    return [n for n in names if not n.startswith("_")]


def _reference_arch_ids():
    import ast
    tree = ast.parse((SRC / "repro" / "configs" / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "_ARCH_MODULES":
            return list(ast.literal_eval(node.value))
    raise AssertionError("no _ARCH_MODULES in the JAX package's configs")


def test_configs_exports_equal_the_jax_packages():
    import repro_torch.configs as configs
    from repro_torch.configs.base import SHAPES, reduced_shape
    assert configs.__all__ == _reference_exports("configs")
    assert all(hasattr(configs, n) for n in configs.__all__)
    archs = configs.all_archs()
    assert list(archs) == _reference_arch_ids() == list(configs.ARCH_IDS)
    assert all(a == configs.get_arch(k) for k, a in archs.items())
    assert configs.SHAPES is SHAPES and configs.reduced_shape is \
        reduced_shape


@pytest.mark.parametrize("package", ["core", "compiler", "kernels"])
def test_package_exports_cover_the_jax_packages(package):
    """Every public name of the JAX package's ``__init__`` (its
    ``__all__`` where it has one) but the interpret-mode preset, which
    the port has not by design."""
    import importlib
    mod = importlib.import_module(f"repro_torch.{package}")
    want = set(_reference_exports(package)) - {"TPU_INTERPRET"}
    assert want and not {n for n in want if not hasattr(mod, n)}
    assert not hasattr(mod, "TPU_INTERPRET")
    assert want <= set(getattr(mod, "__all__", want))
