#!/usr/bin/env python3
"""Repeat chip_smoke.py's front-end phase, for the spread of its readings.

    python3 probe_frontend.py [N] [--window A B]

Needs one CUDA card.  Builds the kernels, compiles tuned ResNet-50
(``compile(..., autotune=True)``) and MobileNetV2 for ``NX2100``, runs
each forward once through ``run()`` (capturing its graph), then runs
``chip_smoke.serve_frontend`` N times (default 5).  Each run prints its
``[frontend]`` lines; the last line is a JSON list of each run's two
snapshots, heavy:light ratio and Jain index.  ``--window A B`` reads the
shares between the snapshots at fractions A and B of the heavy tenant's
images delivered (default ``chip_smoke.FRONTEND_WINDOW``; ``0 0.5`` reads
from the start, warm-up included).  The probe reports the shares and
does not hold them to chip_smoke.py's bounds; every other check of the
phase stays.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="?", type=int, default=5)
    ap.add_argument("--window", nargs=2, type=float, default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_frontend: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.compiler import NX2100, compile
    from repro_torch.configs.cnn import get_cnn
    from repro_torch.kernels import _build
    from repro_torch.models.cnn import cnn_input_shape, init_cnn_params
    if args.window is not None:
        cs.FRONTEND_WINDOW = tuple(args.window)
    cs.FRONTEND_SHARE_TOL, cs.FRONTEND_MIN_JAIN = float("inf"), 0.0
    _build.build_all()
    nets = {n: compile(get_cnn(n.split(cs.TUNED_SUFFIX)[0]), NX2100,
                       autotune=n.endswith(cs.TUNED_SUFFIX))
            for n in sorted({n for _, n, _, _ in cs.FRONTEND_TENANTS})}
    params, per_forward = {}, {}
    for n, comp in nets.items():
        params[n] = init_cnn_params(
            comp.cfg, torch.Generator().manual_seed(cs.SEED), "cuda")
        x = torch.zeros(cnn_input_shape(comp.cfg, cs.BATCH),
                        dtype=torch.int8, device="cuda")
        comp.run(params[n], x)
        _build.reset_launches()
        comp.run(params[n], x)
        torch.cuda.synchronize()
        per_forward[n] = dict(_build.LAUNCHES)
    out = []
    for _ in range(args.runs):
        record = {"card": cs.card_line()}
        cs.serve_frontend(torch, np, nets, params, per_forward, "cuda",
                          record)
        fe = record["frontend"]
        out.append({**fe["backlog_snapshots"],
                    "images_per_s": fe["report"]["images_per_s"]})
    print(record["card"])
    print(json.dumps({"window": cs.FRONTEND_WINDOW, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
