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
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tmod
    with pytest.raises(KeyError, match="available"):
        get_arch("gemma2-9b")
    arch = get_arch("phi4-mini-3.8b").reduced()
    gen = torch.Generator().manual_seed(0)
    for change in (dict(family="moe"), dict(family="ssm"),
                   dict(enc_dec=True), dict(attn_kind="mla")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmod.init_params(gen, dataclasses.replace(arch, **change), "cpu")


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
