"""Multi-tenant serving on the port: three networks, one front door,
weighted-fair.

  PYTHONPATH=src python examples_torch/serve_multitenant.py
  PYTHONPATH=src python examples_torch/serve_multitenant.py --device cpu

Runs on the CUDA card by default and raises without one; ``--device
cpu`` runs the kernels' plain versions.

1. compiles executable-scale mini ResNet-18, ResNet-50, and MobileNet
   pipelines (each its own H2PIPE accelerator with its own §V-A credit
   bound — the MobileNet one with the adaptive microbatch ladder);
2. registers four tenants against them through one
   :class:`~repro_torch.runtime.frontend.MultiTenantFrontEnd`: weighted
   shares (``video`` gets 4x ``batch``), one latency-sensitive tenant
   with a per-request deadline;
3. pushes mixed open-loop traffic through the front door, then prints
   the :class:`FrontEndReport`: per-tenant latency percentiles,
   deadline-miss rates, the deficit-round-robin pick counts, and
   Jain's fairness index over weight-normalized delivered throughput;
4. spot-checks one request per network against the sequential
   ``run()`` reference — scheduling policy never changes an output bit.
"""
import argparse

import numpy as np
import torch

from repro_torch import compiler
from repro_torch.configs.cnn import (mini_mobilenet, mini_resnet18,
                                     mini_resnet50)
from repro_torch.models.cnn import cnn_input_shape, init_cnn_params
from repro_torch.runtime.frontend import MultiTenantFrontEnd
from repro_torch.runtime.pipeline import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    nets = {}
    for i, (name, cfg) in enumerate({
            "resnet18": mini_resnet18(hw=8, width=16, stages=4),
            "resnet50": mini_resnet50(hw=8, width=16, stages=4),
            "mobilenet": mini_mobilenet(hw=8, width=16, blocks=4),
    }.items()):
        cp = compiler.compile(cfg, compiler.MINI)
        nets[name] = (cfg, cp, init_cnn_params(
            cfg, torch.Generator().manual_seed(i), dev))
        print(f"compiled {name}: {len(cp.plan.schedules)} layers, "
              f"{len(cp.plan.streamed)} streamed")

    def engine(name, **kw):
        _, cp, params = nets[name]
        return cp.serve(params, microbatch=4, credits=2, queue_depth=4,
                        device=dev, **kw)

    fe = MultiTenantFrontEnd(
        {"resnet18": engine("resnet18"), "resnet50": engine("resnet50"),
         "mobilenet": engine("mobilenet", adaptive=True)},
        max_outstanding=6)
    fe.register_tenant("video", network="resnet18", weight=4.0)
    fe.register_tenant("batch", network="resnet18", weight=1.0)
    fe.register_tenant("search", network="resnet50", weight=2.0)
    fe.register_tenant("edge", network="mobilenet", weight=1.0,
                       deadline_ms=5000.0)

    rng = np.random.default_rng(0)

    def images(cfg, n):
        shape = cnn_input_shape(cfg, 1)[1:]
        return rng.integers(-127, 128, size=(n,) + shape,
                            dtype=np.int16).astype(np.int8)

    traffic = []
    for k in range(6):
        traffic.append(("video", images(nets["resnet18"][0], 2)))
        traffic.append(("search", images(nets["resnet50"][0], 1)))
        if k % 2 == 0:
            traffic.append(("batch", images(nets["resnet18"][0], 3)))
        traffic.append(("edge", images(nets["mobilenet"][0], 1)))

    with fe:
        reqs = [(t, fe.submit(t, imgs)) for t, imgs in traffic]
        fe.drain()
        report = fe.report()

    print()
    print(report.table())

    # scheduling never changes an output bit: spot-check one request
    # per network against the sequential reference
    spot = {"video": "resnet18", "search": "resnet50", "edge": "mobilenet"}
    for tenant, net in spot.items():
        t, req = next(r for r in reqs if r[0] == tenant)
        _, cp, params = nets[net]
        want = cp.run(params, torch.from_numpy(req.images).to(dev),
                      device=dev)[0].cpu().numpy()
        assert np.array_equal(req.result(), want), f"{tenant} diverged!"
    print("\nspot-checked bit-identical to sequential run() "
          f"on all three networks ({dev})")


if __name__ == "__main__":
    main()
