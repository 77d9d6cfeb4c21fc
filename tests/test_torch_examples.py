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
