"""Serving launcher: batched prefill+decode with credit-bounded admission.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --reduced --device cpu --requests 6 --max-new 8

Takes every arch of ``repro_torch.configs.ARCH_IDS``.  Runs on the card
by default and raises when there is none; ``--device cpu`` runs the plain
versions.  Weights are random, drawn from seed 0; prompts are 8 tokens
(a VLM's ``n_patches``, if more), the stub front ends' patches and
frames zeros.  ``--max-seq`` defaults to 128, or to the prompt plus
``--max-new`` where that is longer; a ``--max-seq`` shorter than that is
refused.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import transformer as tmod
from repro_torch.runtime.pipeline import resolve_device
from repro_torch.runtime.serving import Request, ServingEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    # a VLM prompt holds at least its n_patches image slots
    prompt = max(8, arch.n_patches)
    need = prompt + args.max_new
    max_seq = max(128, need) if args.max_seq is None else args.max_seq
    if max_seq < need:
        ap.error(f"--max-seq {max_seq} is shorter than the prompt ({prompt} "
                 f"tokens) plus --max-new ({args.max_new})")
    dev = resolve_device(args.device)
    params = tmod.init_params(torch.Generator(dev).manual_seed(0), arch, dev)
    engine = ServingEngine(params, arch, batch_slots=args.slots,
                           max_seq=max_seq, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, arch.vocab_size, size=prompt).astype(
        np.int32), max_new=args.max_new) for i in range(args.requests)]
    t0 = time.perf_counter()
    done = engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    for r in done:
        print(f"req {r.rid}: {r.out}")
    print(f"{toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          f"{args.slots} slots, credit-bounded admission, on {dev})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
