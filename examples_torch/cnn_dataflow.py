"""The paper's own scenario, end to end, on the port: a CNN compiled into
a layer-pipelined dataflow accelerator with a hybrid weight memory.

  PYTHONPATH=src python examples_torch/cnn_dataflow.py [resnet18|resnet50|...]
  PYTHONPATH=src python examples_torch/cnn_dataflow.py resnet18 --device cpu

Runs on the CUDA card by default and raises without one; ``--device
cpu`` runs the kernels' plain versions.

1. ``compile(cfg, NX2100)`` runs the staged compiler against the paper's
   device descriptor: parallelism allocation (HPIPE balancing), Eq. 1 +
   Algorithm 1 placement, clockwise pseudo-channels, FIFO sizing, engine
   binding, working-set validation — and prints the placement BEFORE
   anything executes;
2. reports the throughput model against the Eq. 2 bound;
3. compiles the same network for ``H100``: NX2100's budgets, with stage 5
   checking every layer against the CUDA launch plan the card runs (the
   shared memory a block of it claims), and prints that engine table;
4. EXECUTES an executable-scale variant of the network end to end through
   the compiled pipeline: conv layers dispatch to the int8 conv kernels
   with weights pinned or streamed per its own Algorithm 1 plan, fc heads
   ride the streamed matmul — and the result is verified bit-identical to
   the plain functional path on the same device.
"""
import argparse

import torch

from repro_torch import compiler
from repro_torch.configs import CNN_CONFIGS
from repro_torch.configs.cnn import mini_resnet18
from repro_torch.core import bounds, placement
from repro_torch.models.cnn import (cnn_forward, cnn_input_shape,
                                    init_cnn_params)
from repro_torch.runtime.pipeline import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("name", nargs="?", default="resnet18",
                    choices=sorted(CNN_CONFIGS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = args.name

    cfg = CNN_CONFIGS[name]
    frac = {"resnet18": .51, "resnet50": .33, "vgg16": .40}.get(name, .5)
    target = compiler.NX2100.replace(
        name=f"nx2100-{name}",
        tb_budget=int(bounds.NX2100_TENSOR_BLOCKS * frac))
    compiled = compiler.compile(cfg, target)

    print(f"== {name}: H2PIPE compile for target {target.name!r} ==")
    offloaded = compiled.plan.streamed
    print(f"layers: {len(compiled.schedules)}, "
          f"offloaded to HBM: {len(offloaded)}")
    placements = {p.spec.name: p for p in compiled.plan.placements}
    for s in offloaded[:6]:
        p = placements[s.spec.name]
        print(f"  {s.spec.name:10s} -> PC{s.pc:<2d} "
              f"score={placement.eq1_score(p):8.1f} "
              f"chains={p.chains}")
    t = compiled.throughput()
    print(f"modelled throughput: {t['images_per_s']:.0f} im/s "
          f"(bottleneck {t['bottleneck']}, "
          f"{'HBM' if t['bottleneck_on_hbm'] else 'on-chip'})")
    print(f"Eq.2 all-HBM bound: {bounds.all_hbm_bound_ims(cfg):.0f} im/s")

    # --- the card's own check: every layer against its CUDA launch plan ----
    card = compiler.compile(cfg, compiler.H100.replace(
        name=f"h100-{name}", tb_budget=target.tb_budget))
    print(f"\n== {name}: the same budgets, checked against the H100's "
          f"launch plans ({card.target.smem_bytes} B of shared memory a "
          f"block) ==")
    print(card.describe())
    assert card.streamed_names == compiled.streamed_names, \
        "the card's check moved a layer off its Algorithm 1 tier"

    # --- execute through the compiled pipeline ----------------------------
    # Executable scale: the mini ResNet-18 topology is big enough that
    # Eq. 1 scores go positive and Algorithm 1 streams layers on the MINI
    # target (a smaller device).
    r = mini_resnet18(hw=32, width=32)
    cp = compiler.compile(r, compiler.MINI)
    assert cp.streamed_names, "Algorithm 1 chose no HBM layers?"
    print(f"\n== {r.name}: compiled for {cp.target.name!r} ==")
    print(cp.describe())

    gen = torch.Generator().manual_seed(0)
    params = init_cnn_params(r, gen, dev)
    x = torch.randint(-127, 128, cnn_input_shape(r, 4), generator=gen,
                      dtype=torch.int8).to(dev)
    logits, report = cp.run(params, x, device=dev)
    ref = cnn_forward(params, r, x)
    same = torch.equal(logits, ref)
    print(f"images {tuple(x.shape)} -> logits {tuple(logits.shape)} on "
          f"{dev}, bit-identical to reference: {same}")
    assert same, "the compiled pipeline differs from the plain path"
    print(f"Eq.2 weight words streamed: {report.total_hbm_words} "
          f"over {report.streamed_layer_count} layers")
    sim = report.fifo_prediction(outputs_needed=8)
    print(f"fifo_sim (credit mode): completed={sim.completed}, "
          f"tail stalls={sim.stall_cycles} cycles over {sim.cycles}")


if __name__ == "__main__":
    main()
