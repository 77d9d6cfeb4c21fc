#!/usr/bin/env python3
"""The flash-attention checks of ``chip_smoke.py`` alone, on the card:
K9-K11 against their plain versions in bf16, f32 and f16 (phase 2's flash
checks, the padded rows and the odd head dims), Phi-4-mini served and
trained in f16, and the f16 instances timed at Phi-4-mini's shape beside
SDPA in f16 and their bound.

    python3 probe_f16.py
    python3 probe_f16.py --grads     # Phi-4-mini's gradient in bf16 and f16,
                                     # kernel mode on and off, against f32

Prints the ``[check]``-style readings, the ``[f16]`` and ``[odd hd]``
lines and writes ``chiprun_out/probe_f16.json``; exits non-zero where a
check fails or without a card.
"""
import json
import sys
import time

import chip_smoke as cs

# the loss scales the f16 gradient is taken under (``--grads``)
F16_SCALES = (1, 2 ** 8, 2 ** 12, 2 ** 16)


def grads_against_f32(torch, np, dev, card, record, n_layers=None):
    """Phi-4-mini's loss_fn gradient on one batch (4 x 512, seed 0) in bf16
    and in f16, each with kernel mode on and off, against the same weights
    cast to f32 (TF32 off, kernel mode on: the f32 flash kernels): each
    leaf's |g - g_f32| / |g_f32| (L2), the share of exact zeros in each
    gradient, and the largest |g|; at ``n_layers`` (else every layer)."""
    import dataclasses
    import gc

    from repro_torch.data.pipeline import DataConfig, TokenDataset
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import transformer as tmod
    from repro_torch.runtime.trainer import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dtype in ("bfloat16", "float16"):
        arch = cs.lm_arch(dtype)
        if n_layers:
            arch = dataclasses.replace(arch, n_layers=n_layers)
        data = TokenDataset(DataConfig(arch.vocab_size, cs.TRAIN_SEQ,
                                       cs.TRAIN_BATCH, seed=cs.SEED))
        batch = {k: torch.from_numpy(v).to(dev, torch.int64)
                 for k, v in data.global_batch(0).items()}
        params = tmod.init_params(
            torch.Generator(device=dev).manual_seed(cs.SEED), arch, dev)
        # the f32 reference first, its params freed before the others run
        p32 = torch.utils._pytree.tree_map(lambda t: t.float(), params)
        loss32, g32 = value_and_grad(p32, dataclasses.replace(
            arch, dtype="float32"), batch)
        del p32
        g32 = dict(cs.named_leaves(g32))
        gc.collect()
        torch.cuda.empty_cache()
        rec = out[dtype] = {"loss_f32": float(loss32)}
        scales = (1,) if dtype == "bfloat16" else F16_SCALES
        for scale in scales:
            runs = {}
            for mode in ("on", "off"):
                lm_layers.set_kernel_mode(mode == "on")
                try:
                    loss, g = (value_and_grad(params, arch, batch)
                               if scale == 1 else cs.scaled_value_and_grad(
                                   torch, params, arch, batch, scale))
                finally:
                    lm_layers.set_kernel_mode(True)
                g = runs[mode] = dict(cs.named_leaves(g))
                rel = {n: cs.rel_l2(torch, g[n], g32[n]) for n in g32}
                worst = max(rel, key=rel.get)
                rec[f"{mode} x{scale}"] = {
                    "loss": float(loss), "rel_l2_to_f32": rel,
                    "zero_share": {n: float((g[n] == 0).float().mean())
                                   for n in g32},
                    "worst": [worst, rel[worst]]}
            vs = rec[f"on_vs_off x{scale}"] = {
                n: cs.rel_l2(torch, runs["on"][n], runs["off"][n])
                for n in g32}
            del runs
            gc.collect()
            torch.cuda.empty_cache()
            on, off = rec[f"on x{scale}"], rec[f"off x{scale}"]
            cs.log("grads", f"Phi-4-mini {cs.DNAME[dtype]} at "
                   f"{arch.n_layers} layers, one loss_fn gradient, loss "
                   f"scale {scale}: loss on {on['loss']:.6f}, off "
                   f"{off['loss']:.6f}, f32 {rec['loss_f32']:.6f}; "
                   f"|g - g_f32| / |g_f32| by leaf, kernel on / off: "
                   + ", ".join(
                       f"{n} {on['rel_l2_to_f32'][n]:.4g} / "
                       f"{off['rel_l2_to_f32'][n]:.4g} (zeros "
                       f"{on['zero_share'][n]:.3g} / "
                       f"{off['zero_share'][n]:.3g}, on vs off "
                       f"{vs[n]:.4g}, max|g_f32| "
                       f"{float(g32[n].abs().max()):.3g})" for n in g32)
                   + f"  [{card}]")
        del params, g32
        gc.collect()
        torch.cuda.empty_cache()
    record["grads_against_f32"] = out


def main():
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("probe_f16: CUDA is not available", file=sys.stderr)
        return 2
    if "--grads" in sys.argv:
        record = {"card": cs.card_line()}
        grads_against_f32(torch, np, torch.device("cuda"), record["card"],
                          record)
        out = cs.ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "probe_f16_grads.json").write_text(
            json.dumps(record, indent=1, default=str))
        print(record["card"])
        return 0
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    card = cs.card_line()
    t0 = time.perf_counter()
    _build.build_all(["flash_attention", "flash_attention_bwd",
                      "flash_attention_f16", "flash_attention_bwd_f16"])
    cs.log("build", f"flash libraries in {time.perf_counter() - t0:.1f} s")
    record = {"card": card}
    ks = {k: cs.Kernel(k, cs.BF16_FLOPS_PER_S)
          for k in (cs.LM_KERNEL,) + cs.BWD_KERNELS + tuple(cs.F16_ROWS)}
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    t0 = time.perf_counter()
    n = (cs.check_flash(torch, g, dev, ks, record)
         + cs.check_flash_bwd(torch, g, dev, ks, record)
         + cs.check_padded_rows(torch, g, dev, ks)
         + cs.check_odd_head_dims(torch, g, dev, ks, card))
    torch.cuda.synchronize()
    record["readings"] = {k: v.readings for k, v in ks.items()}
    cs.log("check", f"{n} flash comparisons in "
           f"{time.perf_counter() - t0:.1f} s; vjp "
           f"{json.dumps(record['vjp_share_of_limit'])}; readings "
           f"{json.dumps(record['readings'])}")
    lm = cs.serve_lm(torch, np, dev, record, dtype=cs.F16)
    cases = {cs.LM_KERNEL: dict(lm["k9_by_case"])}
    del lm
    _, train_cases = cs.train_lm(torch, np, dev, record, card, dtype=cs.F16)
    for k, by in train_cases.items():
        for case, m in by.items():
            cases.setdefault(k, {})
            cases[k][case] = cases[k].get(case, 0) + m
    main = (cs.FLASH_SLICE,)
    cs.time_flash(torch, F, g, dev, ks["flash_attention_fwd_f16"],
                  cases[cs.LM_KERNEL], card, record, dtype=cs.F16, main=main)
    cs.time_flash_bwd(torch, F, g, dev, ks,
                      {k: cases[k] for k in cs.BWD_KERNELS}, card, record,
                      dtype=cs.F16, main=main)
    rows = {row: {"launches": sum(cases[k].values()), "ms": ks[row].ms,
                  "bound_ms": ks[row].bound_ms, "plain_ms": ks[row].plain_ms,
                  "library_ms": ks[row].library_ms,
                  "max_abs_err": ks[row].max_abs_err}
            for row, k in cs.F16_ROWS.items()}
    record["f16_rows"] = rows
    cs.log("f16", json.dumps(rows) + f"  [{card}]")
    out = cs.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe_f16.json").write_text(json.dumps(record, indent=1,
                                                   default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
