#!/usr/bin/env python3
"""K10 and K11 (the flash-attention backward) on the card, apart from
``chip_smoke.py``: both 16-bit routes at the bf16 training shapes of the
main path, timed in turns, and variants of the ``wgmma`` route's source.

    python3 probe_flash_bwd.py              # mma.sync and wgmma in turns
    python3 probe_flash_bwd.py --variants   # the wgmma route's variants

The default times each kernel at each shape of ``SHAPES`` on the
``mma.sync`` route and on the ``wgmma`` route in turns (mma.sync, wgmma,
wgmma, mma.sync), device ms a launch by graph replay (``chip_smoke``'s
``device_ms``).  ``--variants`` builds copies of
``csrc/flash_attention_bwd.cu`` with one edit each (``VARIANTS``: another
ring depth, or a step of the work left out, to see what holds a tile), prints each copy's ptxas report for the wgmma instances,
and times the library and each copy in turns on the wgmma route.  Writes
``chiprun_out/probe_flash_bwd.json``; exits non-zero without a card.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

SHAPES = (cs.FLASH_SLICE, cs.FLASH_DRY_TRAIN, cs.FLASH_GPIPE, cs.FLASH_QWEN,
          cs.FLASH_SEAMLESS_ENC, cs.FLASH_SEAMLESS_DEC, cs.FLASH_INTERNVL,
          cs.FLASH_QWEN72)
# name -> [(text of the library's source, its replacement)]
VARIANTS = {
    # a ring of three streamed tiles
    "stages3": [("constexpr int WG_STAGES = 2; ",
                 "constexpr int WG_STAGES = 3; ")],
    # K10 without its elementwise steps (ds = s * dp)
    "dq_no_elementwise": [(
        "          sc[j][e] = grad_plain(a, c2, sc[j][e], dp[j][e],\n"
        "                                e < 2 ? l2_0 : l2_1, e < 2 ? dl0 : "
        "dl1, &p);",
        "          sc[j][e] = sc[j][e] * dp[j][e];")],
    # K10 without its dQ product (the split still made)
    "dq_no_product": [(
        "    split_wgmma<WG_TILE / 16>(acc, f, ks, L::TILE_PANEL);", "")],
}


def inputs(torch, g, dev, case):
    B, H, KV, S, hd, hd_v, causal = case[:7]
    from repro_torch.kernels.flash_attention import ops
    q, k, v = (t.transpose(1, 2).contiguous() for t in cs.flash_inputs(
        torch, g, dev, case, torch.bfloat16))
    do = torch.randn((B, S, H, hd_v), generator=g, device=dev).to(q.dtype)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    o, lse = ops.flash_attention_kernel(qt, kt, vt, return_lse=True,
                                        causal=causal)
    delta = ops._delta(o, dot)
    grads = (torch.empty_like(q),
             torch.empty((B, S, H, hd), dtype=q.dtype, device=dev),
             torch.empty((B, S, H, hd_v), dtype=q.dtype, device=dev))

    def launch(which, route):
        return lambda: ops._launch_bwd(
            qt, kt, vt, dot, lse, delta, *(t.transpose(1, 2) for t in grads),
            causal=causal, window=0, softcap=0.0, which=(which,),
            route=route)
    return launch


def build_variants(_build):
    """The VARIANTS' libraries (one nvcc each, all at once) and, for each,
    the wgmma instances' (registers, stack, spill stores, spill loads)."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    out = Path("build/probe_flash_bwd")
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} not found once")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reports = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        reports[name] = {
            m.group(1): [int(x) for x in m.groups()[1:]] for m in re.finditer(
                r"entry function '\S*?(flash_bwd_\w+?_wgmmaI\w*?)EEv\S*'.*?"
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads.*?Used (\d+) registers", log, re.S)}
    return {name: out / f"{name}.so" for name in VARIANTS}, reports


def main():
    import torch
    if not torch.cuda.is_available():
        print("probe_flash_bwd: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    card = cs.card_line()
    dev = torch.device("cuda")
    record = {"card": card}
    variants = "--variants" in sys.argv
    own = ops._bwd_lib(torch.bfloat16)
    libs = {"library": own}
    if variants:
        paths, record["ptxas"] = build_variants(_build)
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            fn = lib.flash_attention_bwd_launch
            fn.argtypes = own.flash_attention_bwd_launch.argtypes
            fn.restype = ctypes.c_int
            lib._typed = True
            libs[name] = lib
        for name, rep in record["ptxas"].items():
            print(f"[ptxas] {name}: " + "; ".join(
                f"{k}: {v[3]} registers, stack {v[0]}, spills {v[1]}/{v[2]}"
                for k, v in rep.items()), flush=True)
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    order = ([("library", "wgmma")] + [(n, "wgmma") for n in VARIANTS]
             if variants else [("library", "mma_sync"),
                               ("library", "wgmma")])
    record["shapes"] = {}
    for case in SHAPES:
        launch = inputs(torch, g, dev, case)
        reps = 20 if case[3] <= 1024 else 5
        res = {}
        try:
            for turn in (order, order[::-1]):
                for name, route in turn:
                    _build._libs["flash_attention_bwd"] = libs[name]
                    for which in (0, 1):
                        key = f"{name}/{route}/{('dq', 'dkv')[which]}"
                        res.setdefault(key, []).append(cs.device_ms(
                            torch, launch(which, route), reps=reps))
        finally:
            _build._libs["flash_attention_bwd"] = own
        record["shapes"][cs.case_key(case)] = res
        print(f"[bwd] {case[:7]} " + "; ".join(
            f"{k} {sum(v) / len(v):.5f} ms ({', '.join(f'{x:.5f}' for x in v)})"
            for k, v in res.items()) + f"  [{card}]", flush=True)
    out = cs.ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe_flash_bwd.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
