"""Continuous-streaming CNN serving demo on the port — a burst of
mixed-size requests.

H2PIPE's accelerator admits a new image every initiation interval with
FIFO credits bounding the number in flight (§V-A); this drives the
software analogue end to end: compile the executable mini ResNet-18,
start a :class:`CnnServingEngine` (packed fixed-shape microbatches, each
one replay of the forward's CUDA graph on the card, credit-bounded
dispatch), submit a burst of requests of 1..5 images each from several
producer threads at once, and print the :class:`ServingReport` table —
throughput, latency percentiles, queue depth, and per-request Eq. 2 HBM
words.

  PYTHONPATH=src python examples_torch/serve_mini_resnet18.py \
      [--requests 24] [--microbatch 8] [--credits 4] [--producers 4] \
      [--device cpu]

Runs on the CUDA card by default and raises without one; ``--device
cpu`` runs the kernels' plain versions.
"""
import argparse
import threading

import numpy as np
import torch

from repro_torch import compiler
from repro_torch.configs.cnn import mini_resnet18
from repro_torch.models.cnn import cnn_input_shape, init_cnn_params
from repro_torch.runtime.pipeline import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--microbatch", type=int, default=8)
    ap.add_argument("--credits", type=int, default=4)
    ap.add_argument("--producers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = mini_resnet18(hw=8, width=16, stages=4)
    print(f"compiling {cfg.name} ({len(cfg.layers)} layers) ...")
    cp = compiler.compile(cfg, compiler.MINI)
    params = init_cnn_params(cfg, torch.Generator().manual_seed(0), dev)
    print(f"  {len(cp.streamed_names)} HBM-streamed layers, "
          f"{len(cp.block_assignments)} fused residual blocks")

    rng = np.random.default_rng(0)
    shape = cnn_input_shape(cfg, 1)[1:]
    bursts = [rng.integers(-127, 128, size=(int(rng.integers(1, 6)),)
                           + shape, dtype=np.int16).astype(np.int8)
              for _ in range(args.requests)]

    with cp.serve(params, microbatch=args.microbatch,
                  credits=args.credits, device=dev) as eng:
        # N producers submitting concurrently — the credit bound holds
        # (the admission controller's high-water mark is in the report)
        chunks = [bursts[i::args.producers] for i in range(args.producers)]
        threads = [threading.Thread(
            target=lambda c=c: [eng.submit(b) for b in c]) for c in chunks]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        eng.drain()
        report = eng.report()

    print()
    print(report.table())
    eng.admission.check_invariants()
    assert report.requests == args.requests
    assert report.max_in_flight <= args.credits


if __name__ == "__main__":
    main()
