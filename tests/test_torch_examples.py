"""The port's six examples (``examples_torch/``) run on the CPU at their
smallest arguments and pass their own checks; without ``--device cpu``
they run on the card, and raise where there is none."""
import importlib.util
import pathlib

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples_torch"
NAMES = ("cnn_dataflow", "quickstart", "serve_batched",
         "serve_mini_resnet18", "serve_multitenant", "train_lm")
# the smallest arguments each example takes (it has no others)
SMALL = {
    "cnn_dataflow": ["resnet18"],
    "quickstart": [],
    "serve_batched": ["--requests", "2", "--slots", "2", "--max-new", "2"],
    "serve_mini_resnet18": ["--requests", "4", "--microbatch", "2",
                            "--credits", "2", "--producers", "2"],
    "serve_multitenant": [],
    "train_lm": ["--steps", "11", "--seq-len", "16", "--batch", "2"],
}
# what each prints when its own checks pass
PASSED = {
    "cnn_dataflow": "bit-identical to reference: True",
    "quickstart": "quickstart OK",
    "serve_batched": "4 tokens in",
    "serve_mini_resnet18": "Eq.2 words",
    "serve_multitenant": "spot-checked bit-identical",
    "train_lm": "OK: decreased",
}


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_example_is_here():
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_cpu(name, capsys):
    load(name).main(SMALL[name] + ["--device", "cpu"])
    assert PASSED[name] in capsys.readouterr().out


@pytest.mark.parametrize("name", NAMES)
def test_example_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        load(name).main(SMALL[name])


class _Stop(Exception):
    """Raised by the spy once it has seen the arch an example builds."""


# (example, arguments, the arch whose .reduced() it runs): the defaults,
# and an arch whose attention runs the flash kernels
LM_EXAMPLES = [("quickstart", [], "qwen2-moe-a2.7b"),
               ("serve_batched", [], "gemma2-9b"),
               ("serve_batched", ["--arch", "deepseek-v2-236b"],
                "deepseek-v2-236b"),
               ("train_lm", [], "xlstm-125m"),
               ("train_lm", ["--arch", "phi4-mini-3.8b"], "phi4-mini-3.8b")]


@pytest.mark.parametrize("name,args,arch", LM_EXAMPLES)
def test_lm_example_runs_the_reduced_config(name, args, arch):
    """Each LM example hands its trainer or engine ``get_arch(arch)
    .reduced()`` field by field, as the JAX package's examples do (head
    dim 16, DeepSeek-V2's MLA at qk 24 / v 16)."""
    import dataclasses

    from repro_torch.configs import get_arch
    mod = load(name)
    seen = []

    def spy(*a, **kw):
        seen.append(next(x for x in a if dataclasses.is_dataclass(x)
                         and hasattr(x, "head_dim")))
        raise _Stop
    for cls in ("Trainer", "ServingEngine"):
        if hasattr(mod, cls):
            setattr(mod, cls, spy)
    with pytest.raises(_Stop):
        mod.main(args + ["--device", "cpu"])
    want = get_arch(arch).reduced()
    for f in dataclasses.fields(want):
        assert getattr(seen[0], f.name) == getattr(want, f.name), f.name
    assert seen[0] == want and seen[0].head_dim == 16
