"""LM dry run: count every (arch x shape x mesh) cell — the port of
``repro.launch.dryrun``.

For each of the 10 architectures x its applicable input shapes, this
builds abstract params (``meta`` tensors, nothing allocated), applies the
H2PIPE placement plan to the partition specs, and counts the cell's step
on the production meshes:

  * 16 x 16            (data, model)       — single pod, 256 devices
  * 2 x 16 x 16        (pod, data, model)  — two pods, 512 devices

``train_*`` cells count the full train step (fwd + remat + bwd + AdamW,
``runtime/trainer.py``); ``prefill_*`` cells the prompt-processing serve
step; ``decode_*`` / ``long_*`` cells one-token decode against a cache of
seq_len.

Per cell it prints the per-device argument bytes (params by their specs,
the AdamW state by ``state_specs``, the cache by ``cache_specs``, the
inputs by ``batch_specs``: the counterpart of ``memory_analysis()``'s
argument bytes), the step's global FLOPs and bytes (``roofline.op_cost``)
and the roofline terms (``roofline.analysis``, H100 constants).

The port has no XLA: where the reference compiles each cell, the port
runs its step on ``meta`` tensors under the counter.  Its layer stacks
are Python loops, so a stack of identical layers is counted from its
first layers: at two depths a period p apart (p the period of the layer
kinds: 2 for xLSTM's mLSTM/sLSTM and Gemma2's local/global, else 1; 2
and 3 layers, or 2 and 4), and for a train
step with gradient accumulation at 2 and 3 microbatches, and the count
is extrapolated multilinearly to the real depth and microbatches — exact
for identical layers and microbatches (``tests/test_torch_dryrun.py``
holds it to the full count at a small depth).  The step is counted
inside its mesh (``with mesh:``), as the JAX package lowers it there: on
the production meshes an arch whose experts the model axis divides
(DeepSeek-V2's 160 over 16) runs its MoE layers expert-parallel, and
with ``--kernels on`` the flash call takes the blockwise path where the
query or KV heads do not divide 16.  The two production meshes agree on
all a count reads of them (``count_key``), so each (arch, shape) is
counted once for both.

``--mesh local`` runs the cell for real on this process's card (``--device
cpu`` for the CPU) at full depth with random weights from seed 0, and
counts the step as it runs there.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun               # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-125m \\
      --shape decode_32k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import sys
import time
from fractions import Fraction
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.core import streaming
from repro_torch.launch.mesh import (Mesh, make_local_mesh,
                                     make_production_mesh, mesh_axis_sizes)
from repro_torch.models import transformer as tmod
from repro_torch.models.accounting import count_params
from repro_torch.models.layers import (P, _current_physical_mesh,
                                       axis_size, dp_spec,
                                       flatten_with_paths,
                                       kernel_mode_enabled, set_kernel_mode,
                                       set_mesh_axis_sizes, spec_shard_count)
from repro_torch.optim import adamw
from repro_torch.roofline import analysis, collectives
from repro_torch.roofline.op_cost import Cost, counting
from repro_torch.runtime.trainer import TrainConfig, make_train_step


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def train_microbatches(shape: ShapeConfig) -> int:
    """Gradient-accumulation factor for the train dry run: keeps the live
    residual set (saved layer inputs) to ~1/M of the global batch."""
    for m in (8, 4, 2):
        if shape.global_batch % m == 0 and shape.global_batch // m >= 8:
            return m
    return 1


def input_specs(arch: ArchConfig, shape: ShapeConfig, *, device="meta",
                microbatches: Optional[int] = None,
                gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
    """Every model input of this cell: ``meta`` tensors (the reference's
    ``ShapeDtypeStruct``s), or on another device tokens drawn from
    ``gen`` and zero patches or frames.  ``microbatches`` overrides the
    train step's leading axis (the dry run's extrapolation)."""
    B, S = shape.global_batch, shape.seq_len

    def tensor(shape_, dtype):
        if torch.device(device).type == "meta":
            return torch.empty(shape_, dtype=dtype, device="meta")
        if dtype == torch.int32:
            return torch.randint(0, arch.vocab_size, shape_, dtype=dtype,
                                 generator=gen, device=device)
        return torch.zeros(shape_, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        mb = train_microbatches(shape) if shape.kind == "train" else 1
        per = B // mb
        if microbatches is not None:
            mb = microbatches
        lead = (mb, per) if mb > 1 else (B,)
        feed = {"tokens": tensor(lead + (S,), torch.int32)}
        if shape.kind == "train":
            feed["labels"] = tensor(lead + (S,), torch.int32)
        if arch.family == "vlm":
            feed["patches"] = tensor(lead + (arch.n_patches, arch.d_model),
                                     torch.float32)
        if arch.enc_dec:
            feed["frames"] = tensor(lead + (arch.n_frames, arch.d_model),
                                    torch.float32)
        return feed
    # decode: one new token + cache of length S
    return {"tokens": tensor((B, 1), torch.int32)}


def batch_specs(arch: ArchConfig, shape: ShapeConfig) -> Dict[str, P]:
    mb = train_microbatches(shape) if shape.kind == "train" else 1
    per = shape.global_batch // mb
    dp = dp_spec(per) or None
    lead = (None, dp) if mb > 1 and shape.kind == "train" else (dp,)
    out = {"tokens": P(*lead, None)}
    if shape.kind == "train":
        out["labels"] = P(*lead, None)
    if shape.kind in ("train", "prefill"):
        if arch.family == "vlm":
            out["patches"] = P(*lead, None, None)
        if arch.enc_dec:
            out["frames"] = P(*lead, None, None)
    return out


# ---------------------------------------------------------------------------
# the step of a cell
# ---------------------------------------------------------------------------


def train_config(shape: ShapeConfig,
                 microbatches: Optional[int] = None) -> TrainConfig:
    """The train step's config, as the reference's dry run builds it."""
    return TrainConfig(
        microbatches=microbatches or train_microbatches(shape),
        adamw=adamw.AdamWConfig(grad_wire_bf16=kernel_mode_enabled()))


def make_step(arch: ArchConfig, shape: ShapeConfig, params, *,
              device="meta", microbatches: Optional[int] = None,
              gen: Optional[torch.Generator] = None
              ) -> Tuple[Callable[[], Any], Dict[str, Any]]:
    """``(step, state)``: ``step()`` runs the cell's step once on
    ``params`` (on ``device``); ``state`` holds what it runs on (the
    AdamW state, the cache, the inputs).  A train step updates the params
    and the AdamW state in place, a decode step the cache."""
    feed = input_specs(arch, shape, device=device, microbatches=microbatches,
                       gen=gen)
    if shape.kind == "train":
        tcfg = train_config(shape, microbatches)
        opt = adamw.init(params, tcfg.adamw)
        step_fn = make_train_step(arch, tcfg)
        return (lambda: step_fn(params, opt, feed)), {"opt": opt,
                                                      "batch": feed}
    if shape.kind == "prefill":
        return (lambda: tmod.prefill(params, arch, feed,
                                     max_seq=shape.seq_len)), {"batch": feed}
    enc_len = arch.n_frames if arch.enc_dec else 0
    cache = tmod.init_cache(arch, shape.global_batch, shape.seq_len,
                            device=device, enc_len=enc_len)
    return (lambda: tmod.decode_step(params, arch, cache, feed["tokens"],
                                     shape.seq_len - 1)), \
        {"cache": cache, "batch": feed}


def streamed_paths(arch: ArchConfig) -> Tuple[str, ...]:
    """The leaves the placement plan streams over ``data`` on the active
    mesh (their planned spec names ``data``): each is all-gathered at
    its use.  Planned on the whole arch, so that a depth cut of it
    streams the same leaves."""
    abstract = tmod.abstract_params(arch)
    pspecs = tmod.param_specs(arch)
    plan = streaming.plan_placement(abstract, pspecs, arch)
    planned = streaming.apply_plan_to_specs(pspecs, plan, abstract)
    return tuple(path for path, spec in flatten_with_paths(planned)
                 if any("data" in collectives.axis_names(p)
                        for p in spec or ()))


@contextlib.contextmanager
def partitioned(arch: ArchConfig, shape: ShapeConfig, params, state,
                streamed=(), microbatches: Optional[int] = None):
    """Inside an entered mesh of more than one slot, the step run in this
    context is charged its collectives (``roofline/collectives.py``):
    the params placed by their specs (``streamed`` leaves gathered at
    each use) and the cache by ``cache_specs`` (an activation's share of
    the batch is taken by ``batch_shards`` when the mesh is known); a
    train step also charges its gradients' reduction and the ZeRO gather
    of the AdamW update."""
    if _current_physical_mesh() is None:
        yield
        return
    m = microbatches or (train_microbatches(shape) if shape.kind == "train"
                         else 1)
    pspecs = tmod.param_specs(arch)
    with collectives.partitioning() as part:
        part.place_tree(params, pspecs, streamed)
        if "cache" in state:
            part.place_tree(state["cache"],
                            tmod.cache_specs(arch, shape.global_batch))
        yield
        if shape.kind == "train":
            collectives.charge_train_sync(
                params, pspecs, adamw.state_specs(
                    params, pspecs, train_config(shape, m).adamw)["mu"],
                m, streamed=streamed)


def step_cost(arch: ArchConfig, shape: ShapeConfig, *, params=None,
              device="meta", microbatches: Optional[int] = None,
              streamed=()) -> Cost:
    """The count of one step of the cell, run in full on ``device``
    (``params`` default to ``meta`` ones there, else to weights drawn
    from seed 0); inside a mesh of more than one slot, with its
    collectives (``streamed``: the leaves the plan streams)."""
    gen = None
    if torch.device(device).type != "meta":
        gen = torch.Generator(device).manual_seed(0)
    if params is None:
        params = (tmod.abstract_params(arch) if gen is None
                  else tmod.init_params(gen, arch, device))
    step, state = make_step(arch, shape, params, device=device,
                            microbatches=microbatches, gen=gen)
    with counting() as c, partitioned(arch, shape, params, state, streamed,
                                      microbatches):
        step()
    return c.cost


def layer_period(arch: ArchConfig) -> int:
    """The period of the layer kinds along the stack: xLSTM alternates
    mLSTM and sLSTM, Gemma2 local and global windows."""
    return 2 if arch.family == "ssm" or arch.attn_kind == "local_global" \
        else 1


def _extrapolate(values: Dict[Tuple[int, ...], Cost],
                 points: Tuple[Tuple[int, int], ...],
                 target: Tuple[int, ...]) -> Cost:
    """Multilinear extrapolation of the corner counts to ``target``: exact
    when the count is affine in each variable (identical layers,
    identical microbatches); the result must come out whole."""
    out = {}
    for field in Cost.__slots__:
        total = Fraction(0)
        for corner, cost in values.items():
            w = Fraction(1)
            for (a, b), c, t in zip(points, corner, target):
                w *= Fraction(b - t, b - a) if c == a else Fraction(t - a,
                                                                    b - a)
            total += w * getattr(cost, field)
        if total.denominator != 1:
            raise ArithmeticError(f"extrapolated {field} {total} is not "
                                  f"whole")
        out[field] = int(total)
    return Cost.from_dict(out)


def corners(arch: ArchConfig, shape: ShapeConfig):
    """``(points, target, steps)``: the variables extrapolated (the depths,
    and the microbatches of a train step that accumulates more than 3),
    each as ``(lo, hi)``, their real values, and per corner of the grid
    the ``(depths, microbatches)`` its step runs at.  A depth is counted
    at ``lo`` and one period more, ``lo`` the period but at least 2 (the
    gradients of a one-layer stack come back in another memory layout, so
    one layer is not yet on the line); a depth the period does not reach
    from there, or that is at most ``lo`` plus a period, is counted at its
    real value."""
    names, points, target = [], [], []
    for name, n, p in (("n_layers", arch.n_layers, layer_period(arch)),
                       ("n_enc_layers", arch.n_enc_layers, 1)):
        lo = max(p, 2)           # a one-layer stack's grads lie otherwise
        if n > lo + p and (n - lo) % p == 0:
            names.append(name)
            points.append((lo, lo + p))
            target.append(n)
    m = train_microbatches(shape) if shape.kind == "train" else 1
    mb_var = m > 3
    if mb_var:
        points.append((2, 3))
        target.append(m)
    steps = [(dict(zip(names, c)), c[-1] if mb_var else None)
             for c in itertools.product(*points)]
    return tuple(points), tuple(target), steps


def corner_cost(arch: ArchConfig, shape: ShapeConfig, depths: Dict[str, int],
                microbatches: Optional[int], device="meta",
                stream_plan: bool = True) -> Cost:
    streamed = streamed_paths(arch) if stream_plan and \
        _current_physical_mesh() is not None else ()
    return step_cost(dataclasses.replace(arch, **depths), shape,
                     microbatches=microbatches, device=device,
                     streamed=streamed)


def extrapolated_cost(arch: ArchConfig, shape: ShapeConfig, counts=None,
                      device="meta") -> Cost:
    """The cell's count, from its first layers (and its first
    microbatches): see the module docstring.  The corners' steps run on
    ``device`` (``meta`` by default; elsewhere on random weights).
    ``counts``: the corners' counts, in the order of ``corners(...)[2]``,
    where already taken."""
    points, target, steps = corners(arch, shape)
    if counts is None:
        counts = [corner_cost(arch, shape, d, mb, device) for d, mb in steps]
    if not points:
        return counts[0]
    values = dict(zip(itertools.product(*points), counts))
    return _extrapolate(values, points, target)


def naive_collective_count(arch: ArchConfig, shape: ShapeConfig,
                           counts) -> Cost:
    """The count whose collectives make the reference's
    ``naive_module_sum``: each loop body counted once — here each layer
    stack at one period of its layers and one microbatch, extrapolated
    from the corners' counts as the count is; a cell counted whole keeps
    its count."""
    points, target, _ = corners(arch, shape)
    if not points:
        return counts[0]
    once = [b - a for a, b in points]         # one period of each stack
    if shape.kind == "train" and train_microbatches(shape) > 3:
        once[-1] = 1                          # and one microbatch
    values = dict(zip(itertools.product(*points), counts))
    return _extrapolate(values, points, tuple(once))


def batch_shards(shape: ShapeConfig) -> int:
    """How many ways the active mesh's data axes split a step's batch (a
    microbatch's, in training), as ``batch_specs`` shards it: each
    device's share of an activation's collective bytes."""
    per = shape.global_batch // (train_microbatches(shape)
                                 if shape.kind == "train" else 1)
    dp = dp_spec(per)
    return axis_size(dp) if dp is not None else 1


def count_key(arch_id: str, shape: ShapeConfig, kernels: bool,
              stream_plan: bool = True) -> tuple:
    """The key of a cell's count, read inside the entered mesh: the arch,
    the shape, the kernel mode and what of the mesh the count reads —
    where the mesh has more than one slot, the model axis's size (the
    expert-parallel MoE, the flash call's mesh rule, the collectives),
    whether the data axes split the batch a step's attention sees (the
    rule), the data axis's size (the ZeRO and streamed weights'
    collectives) and the leaves the plan streams.  How many ways the data
    axes split the batch the count leaves open (``batch_shards``)."""
    mesh = _current_physical_mesh()
    per = shape.global_batch // (train_microbatches(shape)
                                 if shape.kind == "train" else 1)
    on_mesh = None if mesh is None else (
        axis_size("model"), dp_spec(per) is not None, axis_size("data"),
        streamed_paths(get_arch(arch_id)) if stream_plan else ())
    return (arch_id, shape, kernels, on_mesh)


def _corner_task(arch_id: str, shape: ShapeConfig, depths, mb,
                 kernels: bool, multi_pod: bool,
                 stream_plan: bool) -> Dict[str, int]:
    set_kernel_mode(kernels)
    with make_production_mesh(multi_pod=multi_pod):
        return corner_cost(get_arch(arch_id), shape, depths, mb,
                           stream_plan=stream_plan).as_dict()


def count_cells(cells, kernels: bool, jobs: int, *, multi_pod: bool = False,
                stream_plan: bool = True) -> Dict[tuple, Tuple[Cost, Cost]]:
    """Count every (arch id, shape) of ``cells`` on ``meta`` inside the
    single-pod (or ``multi_pod``) production mesh with ``jobs`` worker
    processes, each corner of each cell a task, the longest first:
    ``{count_key(...): (count, naive count)}``, as ``run_cell`` takes
    them (``naive_collective_count``)."""
    import concurrent.futures
    import multiprocessing

    tasks = []
    for arch_id, shape in cells:
        arch = get_arch(arch_id)
        for i, (depths, mb) in enumerate(corners(arch, shape)[2]):
            size = (arch.family == "ssm", shape.kind == "train",
                    shape.kind == "prefill",
                    math.prod(depths.values()) * (mb or 1))
            tasks.append((size, arch_id, shape, i, depths, mb))
    tasks.sort(key=lambda t: t[0], reverse=True)
    done: Dict[Tuple[str, ShapeConfig], Dict[int, Cost]] = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(jobs, mp_context=ctx) as ex:
        futs = {ex.submit(_corner_task, a, s, d, mb, kernels, multi_pod,
                          stream_plan): (a, s, i)
                for _, a, s, i, d, mb in tasks}
        for fut in concurrent.futures.as_completed(futs):
            a, s, i = futs[fut]
            done.setdefault((a, s), {})[i] = Cost.from_dict(fut.result())
    out = {}
    with make_production_mesh(multi_pod=multi_pod):
        for (a, s), by_i in done.items():
            corner_counts = [by_i[i] for i in range(len(by_i))]
            out[count_key(a, s, kernels, stream_plan)] = (
                extrapolated_cost(get_arch(a), s, corner_counts),
                naive_collective_count(get_arch(a), s, corner_counts))
    return out


# ---------------------------------------------------------------------------
# per-device argument bytes
# ---------------------------------------------------------------------------


def _sharded_bytes(tree, specs) -> int:
    """Per-device bytes of a tree of tensors under a spec tree of the same
    structure (a shard is rounded up, as a partitioner pads)."""
    leaves = flatten_with_paths(tree)
    spec_leaves = flatten_with_paths(specs)
    if [p for p, _ in leaves] != [p for p, _ in spec_leaves]:
        raise ValueError("a tree and its specs differ in structure")
    return sum(-(-t.numel() * t.element_size() // spec_shard_count(s))
               for (_, t), (_, s) in zip(leaves, spec_leaves))


def argument_bytes(arch: ArchConfig, shape: ShapeConfig, params, pspecs,
                   state: Dict[str, Any]) -> Dict[str, int]:
    """Per-device bytes of every argument of the cell's step, by part."""
    out = {"params": _sharded_bytes(params, pspecs)}
    bspecs = batch_specs(arch, shape)
    if shape.kind == "train":
        out["opt"] = _sharded_bytes(
            state["opt"], adamw.state_specs(params, pspecs,
                                            adamw.AdamWConfig()))
        out["batch"] = _sharded_bytes(state["batch"], bspecs)
    elif shape.kind == "prefill":
        out["batch"] = _sharded_bytes(state["batch"], bspecs)
    else:
        out["cache"] = _sharded_bytes(
            state["cache"], tmod.cache_specs(arch, shape.global_batch))
        out["batch"] = _sharded_bytes(state["batch"],
                                      {"tokens": bspecs["tokens"]})
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# cell lowering
# ---------------------------------------------------------------------------


def model_flops(arch: ArchConfig, shape: ShapeConfig) -> Tuple[int, int]:
    """(model FLOPs, tokens): 6·N_active·tokens for train (fwd + bwd),
    2·N_active·tokens for inference (fwd only)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_act = count_params(arch, active_only=True)
    return (6 if shape.kind == "train" else 2) * n_act * tokens, tokens


def lower_cell(arch: ArchConfig, shape: ShapeConfig, mesh: Mesh, *,
               stream_plan: bool = True, params=None,
               count: Optional[Cost] = None,
               naive: Optional[Cost] = None) -> Dict[str, Any]:
    """Plan, specs, per-device argument bytes, the count of one cell and
    its collectives a device (``coll_detail``, under the reference's
    keys, ``naive_module_sum`` from ``naive_collective_count``).

    On the production meshes (``meta`` devices) the params are abstract
    and the count is ``extrapolated_cost``.  On a local mesh ``params``
    are real tensors on its device, and the step is counted as it runs
    there, in full; ``count`` (and ``naive``) reuse a count already
    taken.  The step is counted inside ``with mesh:``."""
    set_mesh_axis_sizes(mesh_axis_sizes(mesh))
    device = mesh.devices.flat[0]
    abstract = tmod.abstract_params(arch)
    pspecs = tmod.param_specs(arch)
    plan_notes = "off"
    if stream_plan:
        plan = streaming.plan_placement(abstract, pspecs, arch)
        pspecs = streaming.apply_plan_to_specs(pspecs, plan, abstract)
        plan_notes = plan.notes
    if params is None:
        if device.type != "meta":
            raise ValueError(f"a {device} mesh needs the params")
        params = abstract
    _, state = make_step(arch, shape, abstract)       # shapes alone
    args = argument_bytes(arch, shape, abstract, pspecs, state)
    if count is None:
        with mesh:
            if device.type == "meta":
                corner_counts = [
                    corner_cost(arch, shape, d, mb, stream_plan=stream_plan)
                    for d, mb in corners(arch, shape)[2]]
                count = extrapolated_cost(arch, shape, corner_counts)
                naive = naive_collective_count(arch, shape, corner_counts)
            else:
                count = step_cost(arch, shape, params=params, device=device)
    shards = batch_shards(shape)
    detail = collectives.detail(count, shards)
    detail["naive_module_sum"] = collectives.total(naive or count, shards)
    mf, tokens = model_flops(arch, shape)
    return {"plan": plan_notes, "model_flops": mf, "tokens": tokens,
            "global_flops": count.flops, "global_bytes": count.bytes,
            "count": count, "naive_count": naive or count,
            "coll_detail": detail, "arg_bytes": args}


def run_cell(arch_id: str, shape_id: str, mesh_kind: str, *,
             stream_plan: bool = True, kernels: bool = False,
             verbose: bool = True, device=None, shape=None,
             params=None, counts: Optional[Dict] = None
             ) -> Optional[Dict[str, Any]]:
    """One cell on ``mesh_kind`` ("single", "multi" or "local"; ``device``
    for "local"); ``shape`` overrides ``SHAPES[shape_id]`` (a cut batch).
    ``counts`` (``{count_key(...): (count, naive count)}``, as
    ``count_cells`` gives them) holds the meta counts already taken, and
    a meta count this call takes is added to it.  Returns the cell's
    row, or a SKIP row for an inapplicable shape."""
    set_kernel_mode(kernels)
    arch = get_arch(arch_id)
    shape = shape or SHAPES[shape_id]
    ok, why = shape_applicable(arch, shape)
    if not ok:
        if verbose:
            print(f"SKIP {arch_id} x {shape_id}: {why}")
        return {"arch": arch_id, "shape": shape_id, "mesh": mesh_kind,
                "skipped": why}
    if mesh_kind == "local":
        mesh = make_local_mesh(device=device)
    else:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    chips = math.prod(mesh.devices.shape)
    dev = mesh.devices.flat[0]
    if dev.type != "meta" and params is None:
        params = tmod.init_params(torch.Generator(dev).manual_seed(0), arch,
                                  dev)
    with mesh:
        key = count_key(arch_id, shape, kernels, stream_plan)
    cached = counts.get(key) if counts is not None and dev.type == "meta" \
        else None
    t0 = time.time()
    info = lower_cell(arch, shape, mesh, stream_plan=stream_plan,
                      params=params, count=cached and cached[0],
                      naive=cached and cached[1])
    if counts is not None and dev.type == "meta":
        counts[key] = (info["count"], info["naive_count"])
    dt = time.time() - t0
    args = info["arg_bytes"]
    roof = analysis.analyze(
        arch=arch_id, shape=shape_id,
        mesh_name="x".join(map(str, mesh.devices.shape)), chips=chips,
        model_flops=info["model_flops"], global_flops=info["global_flops"],
        global_bytes=info["global_bytes"], bytes_per_device=args["total"],
        coll_detail=info["coll_detail"])
    row = roof.row()
    row.update({"compile_s": dt, "plan": info["plan"],
                "coll_detail": roof.coll_detail, "skipped": None,
                "arg_bytes_per_device": args,
                "count": info["count"].as_dict(), "t_bound_s": roof.t_bound,
                "global_batch": shape.global_batch,
                "kernels": kernel_mode_enabled()})
    if verbose:
        print(f"PASS {arch_id} x {shape_id} on {row['mesh']}  "
              f"count={'counted before' if cached else f'{dt:.1f}s'}")
        print(f"  arguments: {args['total'] / 2**30:.2f}GiB per device ("
              + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in args.items()
                          if k != "total") + ")")
        print(f"  cost: flops={roof.hlo_flops:.3e} bytes={roof.hlo_bytes:.3e}"
              f" (global) coll/dev={roof.coll_bytes:.3e} ("
              + ", ".join(f"{k} {v}" for k, v in roof.coll_detail.items()
                          if v) + ")")
        print(f"  roofline: compute={roof.t_compute * 1e3:.2f}ms "
              f"memory={roof.t_memory * 1e3:.2f}ms "
              f"collective={roof.t_collective * 1e3:.2f}ms "
              f"-> {roof.dominant}-bound, useful={roof.useful_fraction:.2f} "
              f"mfu@bound={roof.mfu_at_bound:.3f}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, help="one shape id (default all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "local"])
    ap.add_argument("--stream-plan", default="on", choices=["on", "off"])
    ap.add_argument("--kernels", default="off", choices=["on", "off"],
                    help="route attention through the flash kernels")
    ap.add_argument("--device", default="cuda",
                    help="the local mesh's device (--mesh local)")
    ap.add_argument("--out", default="dryrun_report.json")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes for the meta counts")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    kernels = args.kernels == "on"
    rows = []
    failures = []
    kernels0 = kernel_mode_enabled()
    counts: Dict[tuple, Tuple[Cost, Cost]] = {}
    try:
        if args.jobs > 1 and args.mesh != "local":
            t0 = time.time()
            counts = count_cells(
                [(a, SHAPES[s]) for a in archs for s in shapes
                 if shape_applicable(get_arch(a), SHAPES[s])[0]],
                kernels, args.jobs, multi_pod=meshes[0] == "multi",
                stream_plan=args.stream_plan == "on")
            print(f"counted {len(counts)} cells on meta with {args.jobs} "
                  f"processes in {time.time() - t0:.1f} s")
        for mk in meshes:
            for a in archs:
                for s in shapes:
                    try:
                        row = run_cell(a, s, mk,
                                       stream_plan=args.stream_plan == "on",
                                       kernels=kernels,
                                       device=args.device, counts=counts)
                        if row:
                            rows.append(row)
                    except Exception as e:                   # noqa: BLE001
                        failures.append((a, s, mk, repr(e)))
                        print(f"FAIL {a} x {s} on {mk}: {e!r}")
    finally:
        set_kernel_mode(kernels0)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1, default=str)
    print(f"\n{len(rows)} cells recorded -> {args.out}; "
          f"{len(failures)} failures")
    for f_ in failures:
        print("  FAIL:", *f_)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
