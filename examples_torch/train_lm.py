"""End-to-end training driver on the port: train an LM for a few hundred
steps with the full substrate (deterministic data, AdamW, async
checkpoints, crash recovery).

  # fast demo (reduced config)
  PYTHONPATH=src python examples_torch/train_lm.py
  PYTHONPATH=src python examples_torch/train_lm.py --device cpu

  # the ~100M-parameter run (xlstm-125m, a few hundred steps)
  PYTHONPATH=src python examples_torch/train_lm.py --full --steps 300

Runs on the CUDA card by default and raises without one; ``--device
cpu`` runs the kernels' plain versions.  The checkpoints go to a
temporary directory, removed at the end.
"""
import argparse
import tempfile

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, TokenDataset
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.pipeline import resolve_device
from repro_torch.runtime.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--full", action="store_true",
                    help="use the full (125M) config instead of reduced")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch = get_arch(args.arch)
    if not args.full:
        arch = arch.reduced()
    data = TokenDataset(DataConfig(vocab_size=arch.vocab_size,
                                   seq_len=args.seq_len,
                                   global_batch=args.batch))
    with tempfile.TemporaryDirectory(prefix="train_lm_ckpt_") as ckpt:
        tcfg = TrainConfig(
            steps=args.steps, microbatches=2, ckpt_every=50, log_every=10,
            ckpt_path=ckpt,
            adamw=AdamWConfig(lr_peak=3e-3,
                              warmup_steps=args.steps // 10,
                              total_steps=args.steps))
        tr = Trainer(arch, tcfg, data, device=dev)
        hist = tr.run(fail_at=args.fail_at)
        print("step,loss,grad_norm")
        for h in hist:
            print(f"{h['step']},{h['loss']:.4f},{h['grad_norm']:.3f}")
        first, last = hist[0]["loss"], hist[-1]["loss"]
        print(f"loss {first:.3f} -> {last:.3f} "
              f"({'OK: decreased' if last < first else 'WARNING'})")
        tr.save(sync=True)


if __name__ == "__main__":
    main()
