"""Training launcher: deterministic data, AdamW, async atomic checkpoints,
crash recovery, attention through the flash kernels.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
      --reduced --device cpu --steps 20 --seq-len 64 --batch 8

Runs on the card by default and raises when there is none; ``--device
cpu`` runs the plain versions.  Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, TokenDataset
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (chaos drill)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    data = TokenDataset(DataConfig(vocab_size=arch.vocab_size,
                                   seq_len=args.seq_len,
                                   global_batch=args.batch))
    tcfg = TrainConfig(
        steps=args.steps, microbatches=args.microbatches,
        ckpt_every=args.ckpt_every, ckpt_path=args.ckpt,
        adamw=AdamWConfig(lr_peak=args.lr,
                          warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps))
    tr = Trainer(arch, tcfg, data, device=args.device)
    if args.resume and tr.restore():
        print(f"resumed from step {tr.step}")
    hist = tr.run(fail_at=args.fail_at)
    for h in hist:
        print(json.dumps(h))
    if len(hist) >= 2 and hist[-1]["loss"] >= hist[0]["loss"]:
        print("WARNING: loss did not decrease")
    tr.save(sync=True)
    print(f"done at step {tr.step} on {tr.device}; checkpoint in {args.ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
