"""End-to-end serving driver on the port (the paper is an inference
system, so the end-to-end example is serving: batched requests through
prefill + credit-bounded continuous decode).

  PYTHONPATH=src python examples_torch/serve_batched.py [--arch gemma2-9b]
  PYTHONPATH=src python examples_torch/serve_batched.py --device cpu

Runs on the CUDA card by default and raises without one; ``--device
cpu`` runs the kernels' plain versions.

Serves a stream of requests against a reduced model, reporting tokens/s,
admission behaviour (credits) and per-request outputs.  The same engine
code serves the full-width models (``python -m repro_torch.launch.serve``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import transformer as tmod
from repro_torch.runtime.pipeline import resolve_device
from repro_torch.runtime.serving import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    arch = get_arch(args.arch).reduced()
    params = tmod.init_params(torch.Generator(dev).manual_seed(0), arch, dev)
    engine = ServingEngine(params, arch, batch_slots=args.slots,
                           max_seq=128, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, arch.vocab_size,
                                    size=int(rng.integers(4, 12))).astype(
        np.int32), max_new=args.max_new) for i in range(args.requests)]

    print(f"serving {len(reqs)} requests on {arch.name} "
          f"({args.slots} slots = credits) on {dev}")
    t0 = time.time()
    done = engine.run(reqs)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    for r in done[:4]:
        print(f"  req{r.rid} prompt_len={len(r.prompt)} -> {r.out}")
    print(f"{toks} tokens in {dt:.2f}s = {toks/dt:.1f} tok/s")
    assert all(r.done for r in done)


if __name__ == "__main__":
    main()
