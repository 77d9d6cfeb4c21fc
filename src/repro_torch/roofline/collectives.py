"""Per-device collective bytes of a step on a mesh — the counterpart of
``repro.roofline.analysis.collective_bytes`` and
``repro.roofline.hlo_loops.scaled_collective_bytes``.

The reference compiles each cell for its mesh and reads the collectives
XLA's SPMD partitioner emitted from the post-SPMD HLO text: each one's
result bytes per device, those inside a ``while`` body times its trip
count.  The port has no partitioner.  It runs the step on ``meta`` tensors
(``roofline/op_cost.py``) with the partition specs of the weights, the
cache and the batch attached to the tensors (:class:`Partitioner`, a
``TorchFunctionMode``), and charges a collective wherever a partitioner
has to emit one, by these rules:

* a product that contracts a dim some operand shards over a mesh axis
  (the row-parallel products: attention's ``wo``, the FFN's ``w_down``,
  a decode's scores against a cache sharded on its sequence): all-reduce
  of the product's result;
* a product that keeps a dim an operand shards (the column-parallel
  products: ``wq``, ``w_gate``, ``w_up``, the vocab-sharded unembed): the
  result is sharded on it, and the gradient of each other operand is a
  partial sum, all-reduced in the backward;
* a weight the placement plan streams (``data`` in its spec,
  ``core/streaming.py``): all-gather of the weight at each use (each
  layer, and again where remat runs the layer a second time), and
  reduce-scatter of its gradient in the backward;
* a row gather from a table sharded on its rows (the vocab-sharded
  embedding): all-reduce of the gathered rows;
* a softmax, logsumexp, max, sum or gather along a dim the mesh shards:
  all-reduce of the reduced result (two for a softmax and a logsumexp:
  the max and the sum);
* the expert-parallel region (``models/ffn.py::_moe_ep_shardmap``): the
  ``psum`` of its partial outputs, all-reduce (``charge_region_psum``);
* a train step (``charge_train_sync``): every gradient of a weight that
  is not streamed all-reduced over the data axes once a microbatch, and
  every weight whose AdamW moments the data axis shards (ZeRO-1,
  ``optim/adamw.py::state_specs``) all-gathered after the update.

Each charge is the collective's result bytes on one device, the quantity
the reference's ``collective_bytes`` sums, and each execution is
charged, so a layer's collectives count once a layer (and once a
microbatch), as the reference's loop-scaled ``scaled`` count does.  An
activation's bytes a device are its bytes over the shards of the dims
its placement shards, and over the shards of the step's batch: those are
charged ``batched`` and divided when the mesh's batch split is given
(:func:`detail`), so one count serves meshes that differ only in how
many ways they split the batch (16 x 16 and 2 x 16 x 16).  A tensor the
rules know nothing of is taken as replicated on the model axis.

What the rules do not derive: the reshards XLA's partitioner chooses on
its own (the all-gathers and collective-permutes around a KV-head count
the model axis does not divide, the rematerialisations it reports as
involuntary, the all-to-all of a sharded embedding's scatter-add);
``tests/test_torch_collectives.py`` holds the port to the reference's
readings and states that gap by kind.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Dict, Iterable, Iterator, NamedTuple, Optional

import torch
from torch.overrides import (TorchFunctionMode,
                             _get_current_function_mode_stack)

from repro_torch.models.layers import axis_size, flatten_with_paths

#: the collective kinds, under the reference's names
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_sinks: list = []
_sink_lock = threading.Lock()
# set while the partitioner runs its own markers: the cost counter
# (``op_cost.CostCounter``) counts none of their ops
_quiet = threading.local()


def quiet() -> bool:
    """Whether the ops running now are the partitioner's own."""
    return getattr(_quiet, "on", False)


@contextlib.contextmanager
def _quietly():
    _quiet.on = True
    try:
        yield
    finally:
        _quiet.on = False


def add_sink(fn) -> None:
    """``fn(kind, nbytes, batched)`` receives each collective's charge
    until :func:`remove_sink`."""
    with _sink_lock:
        _sinks.append(fn)


def remove_sink(fn) -> None:
    with _sink_lock:
        _sinks.remove(fn)


def charge(kind: str, nbytes: int, batched: bool = False) -> None:
    """One collective of ``kind`` whose result is ``nbytes`` on a device;
    ``batched``: ``nbytes`` holds the whole batch, which the mesh's data
    axes split (an activation's), so a device's share is ``nbytes`` over
    the batch's shards, known only once the mesh is (:func:`detail`)."""
    if kind not in KINDS:
        raise ValueError(f"unknown collective {kind!r}")
    if nbytes <= 0:
        return
    with _sink_lock:
        sinks = list(_sinks)
    for fn in sinks:
        fn(kind, int(nbytes), batched)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


class Placement(NamedTuple):
    """Where a tensor lies on the mesh: ``axes`` one entry per dim (a mesh
    axis, a tuple of them, or None); ``streamed``: a weight the plan
    shards over ``data``, gathered at each use (``axes`` then holds its
    model-axis sharding alone)."""
    axes: tuple
    streamed: bool = False

    def shards(self, dim: int) -> int:
        return _size(self.axes[dim])

    def drop(self, dim: int) -> "Placement":
        return self._replace(axes=self.axes[:dim] + self.axes[dim + 1:])


def _size(ax) -> int:
    return 1 if ax is None else axis_size(ax)


def axis_names(ax) -> tuple:
    """The mesh axes one entry of a partition spec names."""
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)


def weight_placement(spec, ndim: int, streamed: bool = False) -> Placement:
    """The placement of a weight or cache leaf with partition spec
    ``spec``.  Its data axes are dropped: on a cache they split the batch,
    which every activation's bytes already divide by, and a weight the
    plan streams over ``data`` is marked ``streamed`` instead."""
    parts = list(spec or ()) + [None] * (ndim - len(spec or ()))
    axes = []
    for p in parts[:ndim]:
        kept = tuple(a for a in axis_names(p) if a not in ("pod", "data"))
        axes.append(None if not kept else kept[0] if len(kept) == 1
                    else kept)
    return Placement(tuple(axes), streamed)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Marker(torch.autograd.Function):
    """The identity, charging collectives: ``fwd`` when it runs, ``bwd``
    when autograd runs its backward (each a tuple of (kind, bytes,
    batched))."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        for kind, n, batched in fwd:
            charge(kind, n, batched)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for kind, n, batched in ctx.bwd:
            charge(kind, n, batched)
        return g, None, None


def _flat_tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _flat_tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _flat_tensors(v, out)
    return out


_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


class Partitioner(TorchFunctionMode):
    """Tracks each weight's and cache leaf's placement through the ops a
    step runs on them and charges the collectives of the module
    docstring's rules to the active sinks (a ``CostCounter``'s)."""

    def __init__(self):
        super().__init__()
        self._placed: Dict[int, tuple] = {}
        self._handlers = {
            torch.unbind: self._unbind, torch.Tensor.unbind: self._unbind,
            torch.Tensor.__getitem__: self._getitem,
            torch.einsum: self._einsum,
            torch.matmul: self._matmul, torch.Tensor.matmul: self._matmul,
            torch.Tensor.__matmul__: self._matmul,
            torch.Tensor.t: self._transpose2,
            torch.softmax: self._softmax, torch.Tensor.softmax: self._softmax,
            torch.logsumexp: self._logsumexp,
            torch.Tensor.logsumexp: self._logsumexp,
            torch.amax: self._reduce, torch.Tensor.amax: self._reduce,
            torch.sum: self._reduce, torch.Tensor.sum: self._reduce,
            torch.gather: self._gather, torch.Tensor.gather: self._gather,
        }

    # -- the side table ----------------------------------------------------

    def place(self, t: torch.Tensor, p: Optional[Placement]) -> None:
        if p is None or all(a is None for a in p.axes) and not p.streamed:
            return
        self._placed[id(t)] = (weakref.ref(t), p)

    def placement(self, t) -> Optional[Placement]:
        if not isinstance(t, torch.Tensor):
            return None
        hit = self._placed.get(id(t))
        if hit is None or hit[0]() is not t:
            return None
        return hit[1]

    def place_tree(self, tree, specs, streamed: Iterable[str] = ()) -> None:
        """Attach each leaf's placement from its spec in ``specs`` (a tree
        of the same structure); ``streamed`` names paths the plan streams
        whose spec does not say so (a depth cut of a planned arch)."""
        streamed = set(streamed)
        leaves = flatten_with_paths(tree)
        spec_leaves = dict(flatten_with_paths(specs))
        for path, t in leaves:
            if not isinstance(t, torch.Tensor):
                continue
            self.place(t, weight_placement(spec_leaves.get(path), t.dim(),
                                           path in streamed))

    @staticmethod
    def act_bytes(t: torch.Tensor, p: Optional[Placement]) -> int:
        """Bytes of activation ``t`` over the shards of the dims ``p``
        shards: a device's share of the whole batch (charged
        ``batched``)."""
        n = _nbytes(t)
        div = 1
        if p is not None:
            for ax in p.axes:
                div *= _size(ax)
        return -(-n // div)

    # -- dispatch ------------------------------------------------------------

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        handler = self._handlers.get(func)
        if handler is not None:
            return handler(func, args, kwargs)
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor) and self.placement(out) is None:
            # an op that keeps the shape keeps the placement of an
            # operand of that shape (casts, elementwise ops, where)
            for t in _flat_tensors((args, kwargs), []):
                p = self.placement(t)
                if p is not None and t.shape == out.shape:
                    self.place(out, p)
                    break
        return out

    def _unbind(self, func, args, kwargs):
        out = func(*args, **kwargs)
        p = self.placement(args[0])
        if p is not None:
            dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
            dim %= args[0].dim()
            for o in out:
                self.place(o, p.drop(dim))
        return out

    def _getitem(self, func, args, kwargs):
        t, idx = args[0], args[1]
        out = func(*args, **kwargs)
        p = self.placement(t)
        if p is None:
            return out
        if isinstance(idx, torch.Tensor):
            # rows of a table: each device gathers the rows it holds and
            # the partial rows are summed
            if p.shards(0) > 1:
                charge("all-reduce", self.act_bytes(out, None), True)
            return out
        parts = idx if isinstance(idx, tuple) else (idx,)
        if any(not isinstance(i, (int, slice)) for i in parts):
            return out
        axes = list(p.axes)
        keep = []
        for d, i in enumerate(parts):
            if isinstance(i, slice):
                whole = i == slice(None)
                keep.append(axes[d] if whole else None)   # a slot's slice
        keep += axes[len(parts):]
        self.place(out, p._replace(axes=tuple(keep)))
        return out

    def _transpose2(self, func, args, kwargs):
        out = func(*args, **kwargs)
        p = self.placement(args[0])
        if p is not None and len(p.axes) == 2:
            self.place(out, p._replace(axes=p.axes[::-1]))
        return out

    # -- products --------------------------------------------------------

    def _einsum(self, func, args, kwargs):
        eq = args[0].replace(" ", "")
        ops = list(args[1:])
        if len(ops) == 1 and isinstance(ops[0], (tuple, list)):
            ops = list(ops[0])
        lhs, out_letters = eq.split("->")
        return self._product(lambda *xs: func(eq, *xs), ops,
                             lhs.split(","), out_letters)

    def _matmul(self, func, args, kwargs):
        a, b = args[0], args[1]
        if a.dim() < 2 or b.dim() < 1:
            return func(*args, **kwargs)
        nb = max(a.dim(), b.dim()) - 2
        batch = _LETTERS[:nb]
        m, k, n = _LETTERS[nb:nb + 3]
        la = batch[nb - (a.dim() - 2):] + m + k
        lb = (batch[nb - (b.dim() - 2):] + k + n) if b.dim() >= 2 else k
        lo = batch + m + (n if b.dim() >= 2 else "")
        return self._product(lambda x, y: func(x, y), [a, b], [la, lb], lo)

    def _product(self, run, ops, letters, out_letters):
        places = [self.placement(t) for t in ops]
        if all(p is None for p in places):
            return run(*ops)
        sharded: Dict[str, Any] = {}
        for t, p, ls in zip(ops, places, letters):
            if p is None:
                continue
            for d, ch in enumerate(ls):
                if p.axes[d] is not None and t.shape[d] > 1:
                    sharded.setdefault(ch, p.axes[d])
        contracted = {ch for ls in letters for ch in ls} - set(out_letters)
        red = [sharded[ch] for ch in sorted(contracted) if ch in sharded]
        out_p = Placement(tuple(sharded.get(ch) for ch in out_letters))
        wrapped = []
        with _quietly():
            for t, p, ls in zip(ops, places, letters):
                fwd, bwd = (), ()
                if p is not None and p.streamed:
                    gathered = -(-_nbytes(t) // _prod(
                        _size(a) for a in p.axes))
                    fwd = (("all-gather", gathered, False),)
                    bwd = (("reduce-scatter",
                            -(-gathered // axis_size("data")), False),)
                elif any(ch in sharded and ch not in ls
                         for ch in out_letters):
                    # the gradient of ``t`` contracts a dim the other
                    # operands keep sharded in the result: a partial sum
                    bwd = (("all-reduce", self.act_bytes(t, p), True),)
                if fwd or bwd and t.requires_grad and \
                        torch.is_grad_enabled():
                    t = _Marker.apply(t, fwd, bwd)
                wrapped.append(t)
        out = run(*wrapped)
        if red:
            charge("all-reduce", self.act_bytes(out, out_p), True)
        self.place(out, out_p)
        return out

    # -- reductions along a sharded dim -----------------------------------

    def _dim_sharded(self, t, dim) -> Optional[Placement]:
        p = self.placement(t)
        if p is None or dim is None:
            return None
        dims = dim if isinstance(dim, (tuple, list)) else (dim,)
        if any(p.shards(d % t.dim()) > 1 for d in dims):
            return p
        return None

    def _softmax(self, func, args, kwargs):
        t = args[0]
        dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
        out = func(*args, **kwargs)
        p = self._dim_sharded(t, dim)
        if p is not None:
            n = self.act_bytes(out, p) * p.shards(dim % t.dim()) \
                // t.shape[dim]
            charge("all-reduce", n, True)         # the max
            charge("all-reduce", n, True)         # the sum
            self.place(out, p)
        return out

    def _logsumexp(self, func, args, kwargs):
        t = args[0]
        dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
        out = func(*args, **kwargs)
        p = self._dim_sharded(t, dim)
        if p is not None:
            rest = self._reduced(p, t, dim, kwargs.get("keepdim", False))
            charge("all-reduce", self.act_bytes(out, rest), True)
            charge("all-reduce", self.act_bytes(out, rest), True)
            self.place(out, rest)
        return out

    def _reduce(self, func, args, kwargs):
        t = args[0]
        dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
        out = func(*args, **kwargs)
        p = self._dim_sharded(t, dim) if isinstance(t, torch.Tensor) \
            else None
        if p is not None:
            keepdim = kwargs.get("keepdim",
                                 args[2] if len(args) > 2 else False)
            rest = self._reduced(p, t, dim, keepdim)
            charge("all-reduce", self.act_bytes(out, rest), True)
            self.place(out, rest)
        return out

    def _gather(self, func, args, kwargs):
        t = args[0]
        dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
        out = func(*args, **kwargs)
        p = self._dim_sharded(t, dim)
        if p is not None:
            rest = p._replace(axes=tuple(
                None if d == dim % t.dim() else a
                for d, a in enumerate(p.axes)))
            charge("all-reduce", self.act_bytes(out, rest), True)
            self.place(out, rest)
        return out

    @staticmethod
    def _reduced(p: Placement, t, dim, keepdim) -> Placement:
        dims = {d % t.dim() for d in (dim if isinstance(dim, (tuple, list))
                                      else (dim,))}
        if keepdim:
            return p._replace(axes=tuple(None if d in dims else a
                                         for d, a in enumerate(p.axes)))
        return p._replace(axes=tuple(a for d, a in enumerate(p.axes)
                                     if d not in dims))


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


# the partitioner of the step being counted (one step at a time a
# process); its mode is not on the stack where remat reruns a layer in
# the backward
_ACTIVE: list = []


def active() -> Optional[Partitioner]:
    """The partitioner of the step being counted, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def partitioning() -> Iterator[Partitioner]:
    """``with partitioning() as part:`` then ``part.place_tree(params,
    specs)``: the step run inside is charged its collectives."""
    part = Partitioner()
    _ACTIVE.append(part)
    try:
        with part:
            yield part
    finally:
        _ACTIVE.pop()


def rerun_visible(fn):
    """``fn`` for ``torch.utils.checkpoint``: where a step is being
    partitioned, its rerun in the backward (which runs with no function
    mode on the stack) enters the partitioner, so the rerun's
    collectives are charged, as XLA's remat emits them again."""
    part = active()
    if part is None:
        return fn

    def visible(*args, **kwargs):
        if part in _get_current_function_mode_stack():
            return fn(*args, **kwargs)
        with part:
            return fn(*args, **kwargs)
    return visible


def charge_region_psum(y: torch.Tensor, axis: str = "model") -> None:
    """The ``psum`` over ``axis`` that ends a ``shard_map`` region
    (``models/ffn.py::_moe_ep_shardmap``): all-reduce of its result, where
    a step is being partitioned."""
    if active() is not None and axis_size(axis) > 1:
        charge("all-reduce", Partitioner.act_bytes(y, None), True)


def charge_train_sync(params, specs, moment_specs, microbatches: int,
                      streamed: Iterable[str] = ()) -> None:
    """The collectives of a train step around its backward: each
    gradient of a weight that is not streamed all-reduced over the data
    axes once a microbatch, in the weight's dtype, and each weight whose
    AdamW moments ``data`` shards but the weight's spec does not (ZeRO-1)
    all-gathered after the update.  Streamed weights reduce-scatter their
    gradients in the backward (``Partitioner``)."""
    if axis_size("data") <= 1:
        return
    streamed = set(streamed)
    spec_of = dict(flatten_with_paths(specs))
    mom_of = dict(flatten_with_paths(moment_specs))
    for path, t in flatten_with_paths(params):
        if not isinstance(t, torch.Tensor) or path in streamed:
            continue
        p = weight_placement(spec_of.get(path), t.dim())
        model = _prod(_size(a) for a in p.axes)
        for _ in range(microbatches):
            charge("all-reduce", -(-_nbytes(t) // model))
        if "data" in {a for part in mom_of.get(path) or ()
                      for a in axis_names(part)}:
            charge("all-gather", -(-_nbytes(t) // model))


def detail(cost, batch_shards: int = 1) -> Dict[str, int]:
    """A count's collectives by the reference's keys (``coll_detail``):
    bytes a device of each kind on a mesh that splits the batch
    ``batch_shards`` ways, and ``count``."""
    out = {kind: getattr(cost, _field(kind)) + -(
        -getattr(cost, _field(kind) + "_batched") // batch_shards)
        for kind in KINDS}
    out["count"] = cost.collectives
    return out


def _field(kind: str) -> str:
    return kind.replace("-", "_")


def total(cost, batch_shards: int = 1) -> int:
    """Bytes a device of every collective of a count (``detail``)."""
    d = detail(cost, batch_shards)
    return sum(d[kind] for kind in KINDS)
