"""FLOP and HBM-byte accounting of a PyTorch step — the port of
``repro.roofline.jaxpr_cost``.

The reference walks a jaxpr; the port runs the step under a
``TorchDispatchMode`` and applies the same rules to every aten op it
sees, forward and backward (autograd's backward ops, and a layer that
remat runs again, are counted where they run):

* matmuls and convolutions count their FLOPs exactly (``2·m·k·n`` a
  product; ``2·|out|·C_in/groups·k_h·k_w`` a convolution) and move their
  operand and result bytes;
* reductions, cumulative ops, softmax, sort and top-k move their operand
  and result bytes and count their output elements as FLOPs;
* gathers move twice their result's bytes (read gathered, write),
  scatters twice their update's; a copy that changes the memory layout
  (a transpose made contiguous) twice its result's;
* elementwise, broadcast, view and convert ops count their output
  elements as FLOPs and move no bytes (fused, as XLA fuses them);
  allocating an empty tensor counts nothing.

``bytes_unfused`` counts every op's operands and results, but a view
twice what it views (its result), not its whole operand: a layer's slice
of an ``[L]`` stack touches that layer, so a count stays affine in the
depth.

``Cost.bytes`` is that fused traffic model, ``bytes_unfused`` every op's
operands and results.  Counts are Python ints: exact at any size.

The hand kernels launch through ctypes, below the dispatcher, so each
wrapper charges its launch itself (``_build.Charge``, by the reference's
``pallas_call`` rule), and a replayed CUDA graph charges what its
capture recorded; on ``meta`` tensors the flash wrappers charge without
launching.

Where the reference and the port count one step differently: a
``lax.scan`` body counts once times its length in the jaxpr, where the
port runs (and counts) every trip of its Python loop — the same total;
``einsum`` lowers to views, copies and ``bmm`` in aten, where a jaxpr
has one ``dot_general``, so the layout copies it makes count as
transposes; the reference has no ``while`` loop on the LM path.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _build
from repro_torch.roofline import collectives


class Cost:
    """``flops`` and ``bytes`` (the fused traffic model), ``bytes_unfused``
    and ``matmul_flops`` (the matmuls' and convolutions' FLOPs alone);
    on a mesh, the collectives a device takes part in (``collectives.py``):
    the result bytes of each kind, those of activations (``*_batched``)
    over the whole batch, and their number, ``collectives``."""
    __slots__ = ("flops", "bytes", "bytes_unfused", "matmul_flops",
                 "all_gather", "all_reduce", "reduce_scatter", "all_to_all",
                 "collective_permute", "all_gather_batched",
                 "all_reduce_batched", "reduce_scatter_batched",
                 "all_to_all_batched", "collective_permute_batched",
                 "collectives")

    def __init__(self, flops=0, nbytes=0, nbytes_unfused=0, matmul_flops=0,
                 **coll):
        self.flops = flops
        self.bytes = nbytes
        self.bytes_unfused = nbytes_unfused
        self.matmul_flops = matmul_flops
        for name in self.__slots__[4:]:
            setattr(self, name, coll.pop(name, 0))
        if coll:
            raise TypeError(f"unknown fields {sorted(coll)}")

    def __iadd__(self, o: "Cost") -> "Cost":
        for name in self.__slots__:
            setattr(self, name, getattr(self, name) + getattr(o, name))
        return self

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "Cost":
        c = cls()
        for name in cls.__slots__:
            setattr(c, name, d[name])
        return c

    def as_dict(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in self.__slots__}

    def __eq__(self, o) -> bool:
        return isinstance(o, Cost) and self.as_dict() == o.as_dict()

    def __repr__(self) -> str:
        return f"Cost({self.as_dict()})"


_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "vdot", "mv",
           "addmv", "_int_mm"}
_CONV = {"convolution", "_convolution", "conv2d", "conv1d",
         "convolution_backward"}
_TRAFFIC = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "any", "all", "logsumexp", "cumsum", "cumprod", "cummax", "cummin",
    "logcumsumexp", "sort", "topk", "var", "std", "var_mean", "std_mean",
    "norm", "linalg_vector_norm", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "aminmax",
    "kthvalue", "median", "mode", "count_nonzero", "nansum"}
_GATHER = {"index", "index_select", "gather", "embedding", "take"}
_SCATTER = {
    "index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "index_add", "index_add_", "index_copy", "index_copy_",
    "embedding_dense_backward", "slice_scatter", "select_scatter",
    "diagonal_scatter", "as_strided_scatter"}
_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "_local_scalar_dense", "set_", "resize_",
          "record_stream"}
_LAYOUT_COPIES = {"clone", "_to_copy", "contiguous"}


def _leaves(x, out: list) -> list:
    """The leaves of an op's arguments or results (nested tuples, lists
    and dicts), faster than a general pytree flatten."""
    if isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    else:
        out.append(x)
    return out


def _tensors(tree):
    return [t for t in _leaves(tree, []) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(name: str, args) -> int:
    if name in ("mm", "_int_mm"):
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "addmm":
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "bmm":
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("baddbmm", "addbmm"):
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("dot", "vdot", "mv"):
        return 2 * args[0].numel()
    if name == "addmv":
        return 2 * args[1].numel()
    raise AssertionError(name)


def _conv_flops(name: str, args, out) -> int:
    """2 x output elements x the MACs an output element takes."""
    if name == "convolution_backward":
        # the input's and the weight's grads, each the forward's count
        grad_out, w, mask = args[0], args[2], args[-1]
        per = 2 * grad_out.numel() * math.prod(w.shape[1:])
        return per * (int(bool(mask[0])) + int(bool(mask[1])))
    w = args[1]
    y = out if isinstance(out, torch.Tensor) else out[0]
    return 2 * y.numel() * math.prod(w.shape[1:])


def op_cost(func, args, kwargs, out) -> Cost:
    """The reference's rule for one aten op."""
    name = func.overloadpacket.__name__
    if name in _EMPTY:
        return Cost()
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    in_bytes = sum(_nbytes(t) for t in ins)
    out_bytes = sum(_nbytes(t) for t in outs)
    io = in_bytes + out_bytes
    out_elems = sum(t.numel() for t in outs)
    if name in _MATMUL:
        mf = _matmul_flops(name, args)
        extra = out_elems if name in ("addmm", "baddbmm", "addbmm",
                                      "addmv") else 0
        return Cost(mf + extra, io, io, mf)
    if name in _CONV:
        mf = _conv_flops(name, args, out)
        return Cost(mf, io, io, mf)
    if name in _TRAFFIC:
        return Cost(out_elems, io, io)
    if name in _GATHER:
        return Cost(out_elems, 2 * out_bytes, io)
    if name in _SCATTER:
        upd = [t for t in ins[1:] if t.is_floating_point()]
        upd_bytes = _nbytes(upd[-1]) if upd else out_bytes
        return Cost(out_elems, 2 * upd_bytes, io)
    if name == "copy_":
        dst, src = args[0], args[1]
        if dst.untyped_storage().nbytes() > _nbytes(dst):
            return Cost(out_elems, 2 * _nbytes(src), io)   # into a slice
        if src.dim() and not _same_layout(src, dst):
            return Cost(0, 2 * _nbytes(dst), io)         # a transpose
        return Cost(out_elems, 0, io)
    if name in _LAYOUT_COPIES and ins and outs and \
            not _same_layout(ins[0], outs[0]):
        return Cost(0, 2 * out_bytes, io)                # a transpose
    if _is_view(func):
        # touches what it views: a layer's slice of a stack, not the stack
        return Cost(out_elems, 0, 2 * out_bytes)
    return Cost(out_elems, 0, io)


def _is_view(func) -> bool:
    schema = func._schema
    return not schema.is_mutable and any(r.alias_info is not None
                                         for r in schema.returns)


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether copying a into b keeps each element's place in memory
    order (no transpose): both dense in the same dim order."""
    if a.shape != b.shape:
        return a.is_contiguous() and b.is_contiguous()
    if a.is_contiguous() and b.is_contiguous():
        return True
    return a.stride() == b.stride()


def _fresh_outputs(func) -> bool:
    """Whether ``func`` returns new tensors: it writes no argument and no
    result aliases one (not a view, not in place)."""
    schema = func._schema
    return not schema.is_mutable and all(r.alias_info is None
                                         for r in schema.returns)


def _key(x):
    """A hashable signature of an op's argument: a tensor's device, dtype,
    shape and strides; a container's entries in place; a value with its
    type (``1``, ``1.0`` and ``True`` give different results)."""
    if isinstance(x, torch.Tensor):
        return (x.device.type, x.dtype, tuple(x.shape), x.stride())
    if isinstance(x, (tuple, list)):
        return (len(x),) + tuple(_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    return (type(x), x)


# per process: op signature -> (result structure, result shapes, cost),
# and op -> whether it returns fresh tensors
_MEMO: Dict[tuple, tuple] = {}
_FRESH: Dict[Any, bool] = {}


class CostCounter(TorchDispatchMode):
    """Counts every aten op run under it (and every kernel launch charged
    meanwhile) into ``self.cost``.

    On ``meta`` tensors most of a step's time is the ops' shape functions
    (many are Python); an op that returns fresh tensors (no view, nothing
    in place) is computed once per signature — the op and its arguments'
    shapes, strides, dtypes and values — and afterwards, in this process,
    its outputs are allocated from the stored shapes and its stored cost
    is counted."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if collectives.quiet():          # the partitioner's markers
            return func(*args, **kwargs)
        key = None
        fresh = _FRESH.get(func)
        if fresh is None:
            fresh = _FRESH[func] = _fresh_outputs(func)
        if fresh:
            if all(x.device.type == "meta" for x in _tensors((args, kwargs))):
                try:
                    key = (func, _key(args), _key(kwargs))
                    hit = _MEMO.get(key)
                except TypeError:                # an unhashable argument
                    key = hit = None
                if hit is not None:
                    spec, metas, cost = hit
                    self.cost += cost
                    return spec.unflatten([
                        torch.empty_strided(shape, stride, dtype=dtype,
                                            device="meta")
                        for shape, stride, dtype in metas])
        out = func(*args, **kwargs)
        cost = op_cost(func, args, kwargs, out)
        self.cost += cost
        if key is not None:
            flat, spec = tree_flatten(out)
            if all(isinstance(t, torch.Tensor) and t.device.type == "meta"
                   for t in flat):
                _MEMO[key] = (spec, [(tuple(t.shape), t.stride(),
                                           t.dtype) for t in flat], cost)
        return out

    def charge(self, flops: int, nbytes: int, matmul_flops: int) -> None:
        self.cost += Cost(flops, nbytes, nbytes, matmul_flops)

    def charge_collective(self, kind: str, nbytes: int,
                          batched: bool) -> None:
        name = kind.replace("-", "_") + ("_batched" if batched else "")
        setattr(self.cost, name, getattr(self.cost, name) + nbytes)
        self.cost.collectives += 1

    def __enter__(self):
        _build.add_charge_sink(self.charge)
        collectives.add_sink(self.charge_collective)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.remove_charge_sink(self.charge)
        collectives.remove_sink(self.charge_collective)
        return super().__exit__(*exc)


@contextlib.contextmanager
def counting() -> Iterator[CostCounter]:
    """``with counting() as c: step(...)`` then ``c.cost``."""
    with CostCounter() as counter:
        yield counter


def count(fn, *args, **kwargs) -> Cost:
    """The Cost of ``fn(*args, **kwargs)``: every aten op it runs, on any
    device (``meta`` tensors give the count without computing), plus the
    kernel launches charged meanwhile."""
    with counting() as c:
        fn(*args, **kwargs)
    return c.cost


def cost_of(fn, *args, **kwargs) -> Dict[str, Any]:
    """Global FLOPs and traffic bytes of ``fn(*args)``, the reference's
    ``cost_of``; with ``bytes_unfused`` and ``matmul_flops`` beside."""
    c = count(fn, *args, **kwargs)
    return {name: getattr(c, name) for name in Cost.__slots__[:4]}
