"""Quickstart: the whole system in about a minute, on the port.

  PYTHONPATH=src python examples_torch/quickstart.py
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu

Runs on the CUDA card by default and raises without one; ``--device
cpu`` runs the kernels' plain versions.

1. picks an architecture (reduced config),
2. shows the H2PIPE placement plan (which weights would pin vs stream)
   of the full model on the production mesh, abstract (``meta``),
3. trains a few steps (the loss of a held-out batch decreases),
4. serves a batch of requests through prefill + credit-bounded decode.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import streaming
from repro_torch.data.pipeline import DataConfig, TokenDataset
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import transformer as tmod
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.pipeline import resolve_device
from repro_torch.runtime.serving import Request, ServingEngine
from repro_torch.runtime.trainer import TrainConfig, Trainer


def held_out_loss(params, arch, data, dev, first=10_000, n=8):
    """The mean loss of the ``n`` batches from step ``first``, which 20
    steps never train on.  The losses the trainer logs are each of
    another batch, and over 20 steps they differ by batch more than
    training moves them, so the check compares the same batches before
    and after."""
    total = 0.0
    for step in range(first, first + n):
        batch = {k: torch.from_numpy(v).to(dev, torch.int64)
                 for k, v in data.global_batch(step).items()}
        with torch.no_grad():
            total += float(tmod.loss_fn(params, arch, batch, remat=False))
    return total / n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch_full = get_arch("qwen2-moe-a2.7b")
    arch = arch_full.reduced()
    print(f"arch: {arch.name} (reduced: {arch.n_layers}L d={arch.d_model} "
          f"hd={arch.head_dim})")

    # --- placement plan on the production mesh (abstract, no allocation) --
    with compat_make_mesh((16, 16), ("data", "model"),
                          devices=["meta"] * 256):
        plan = streaming.plan_placement(tmod.abstract_params(arch_full),
                                        tmod.param_specs(arch_full),
                                        arch_full)
    print(f"H2PIPE placement plan (full {arch_full.name}): {plan.notes}")
    streamed = plan.streamed()
    if streamed:
        print(f"  example streamed tensor: {streamed[0].path} "
              f"({streamed[0].bytes/2**20:.0f} MiB, "
              f"score={streamed[0].score:.1f})")

    # --- train a few steps ------------------------------------------------
    data = TokenDataset(DataConfig(vocab_size=arch.vocab_size, seq_len=32,
                                   global_batch=4))
    with tempfile.TemporaryDirectory(prefix="quickstart_ckpt_") as ckpt:
        tcfg = TrainConfig(steps=20, ckpt_every=10, log_every=5,
                           ckpt_path=ckpt,
                           adamw=AdamWConfig(lr_peak=1e-3, warmup_steps=2,
                                             total_steps=20))
        tr = Trainer(arch, tcfg, data, device=dev)
        before = held_out_loss(tr.params, arch, data, dev)
        hist = tr.run()
        after = held_out_loss(tr.params, arch, data, dev)
    print("train:", " -> ".join(f"{h['loss']:.3f}" for h in hist))
    print(f"held-out loss: {before:.3f} -> {after:.3f}")
    assert after < before, "the loss did not fall"

    # --- serve ------------------------------------------------------------
    eng = ServingEngine(tr.params, arch, batch_slots=2, max_seq=64,
                        device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, arch.vocab_size, size=6).astype(
        np.int32), max_new=5) for i in range(3)]
    done = eng.run(reqs)
    for r in done:
        print(f"serve req{r.rid}: {r.out}")
    assert all(r.done and len(r.out) == 5 for r in done)
    print("quickstart OK")


if __name__ == "__main__":
    main()
