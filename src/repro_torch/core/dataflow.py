"""Layer-pipelined dataflow executor — H2PIPE's architecture on a stage mesh.

The paper's accelerator assigns consecutive CNN layers to specialised
engines placed around the die, with activations flowing through small
FIFOs between them, every engine busy on a different image (Fig. 1).
Here each slot of a mesh axis (:mod:`repro_torch.launch.mesh`) owns a
contiguous group of layers (a *stage*) and activations move stage to
stage around a ring while every stage computes on a different
microbatch.  A slot may repeat a device: on one card each stage runs on
a CUDA stream of its own, so S stage programs run at once on one die,
the layer pipeline H2PIPE builds on the FPGA.

Key H2PIPE semantics carried over:
  * **continuous streaming**: the static schedule admits one microbatch
    per tick, stage ``s`` works on microbatch ``t - s`` at tick ``t``
    and microbatch ``m`` leaves the last stage at tick ``m + S - 1`` —
    at most S in flight, the credit bound of §V-A;
  * **a slot is reused only once consumed** (§V-A): stage ``s + 1``
    waits on stage ``s``'s event, copies the boundary activation into
    its own input buffer and records a *consumed* event; stage ``s``
    overwrites its output only after that event;
  * **pipeline order = placement order** (§V-B): stage s holds layers
    [s*L/S, (s+1)*L/S) of ``split_stages`` (homogeneous ring), or the
    compiler's partition (``staged_pipeline_apply``, heterogeneous).

The executor is generic over the per-stage function, so the CNN stage
graphs and the tests' toy layers use the same machinery.  On the CPU the
ring runs the same schedule in one thread; results equal the sequential
composition of the stages bit for bit on either device.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import canonical_device


def _validate_mesh_axis(mesh, axis: str) -> int:
    """The pipeline axis must exist on the mesh; say what was available."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if axis not in sizes:
        raise ValueError(
            f"mesh has no axis {axis!r}; available axes: {sizes} "
            f"(pass axis=<name> matching the mesh the pipeline runs on)")
    return sizes[axis]


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    _tree_map(out.append, tree)
    return out


def split_stages(stacked_params, n_stages: int):
    """[L, ...] stacked layer params -> [S, L/S, ...]."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")

    def re(x):
        L = x.shape[0]
        if L % n_stages != 0:
            raise ValueError(
                f"cannot split {L} stacked layers into {n_stages} equal "
                f"stages ({L} % {n_stages} != 0); pad the stack or pick a "
                f"stage count that divides the layer count")
        return x.reshape((n_stages, L // n_stages) + tuple(x.shape[1:]))
    return _tree_map(re, stacked_params)


def pipeline_stats(n_stages: int, n_microbatches: int) -> Dict[str, float]:
    total = n_microbatches + n_stages - 1
    return {
        "ticks": total,
        "bubble_fraction": (n_stages - 1) / total,
        "in_flight_credits": n_stages,
    }


def _check_microbatches(x_mb: torch.Tensor) -> None:
    if x_mb.ndim < 2 or x_mb.shape[0] < 1:
        raise ValueError(
            f"x_mb must be [M, mb, ...] with M >= 1 microbatches, got "
            f"shape {tuple(x_mb.shape)}")


def _on_stream(device: torch.device, stream):
    """A context that makes ``stream`` on ``device`` current (nothing
    without a stream: the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


class StageRing:
    """The stage ring, built once and run per round of microbatches.

    ``stage_fns[s](params, x) -> y`` runs stage ``s`` on ``devices[s]``.
    ``boundary_shapes[s]`` is the per-microbatch activation shape
    entering stage ``s`` (``[0]`` is unused and may be None), and a
    non-last stage's output, cast to ``carry_dtype``, must have the next
    stage's boundary shape; the last stage's must have ``out_shape``
    (cast to ``out_dtype``).  Either mismatch raises ``ValueError``.

    A stage program may carry ``static_in``, the tensor its captured
    CUDA graph reads: the ring then copies each boundary straight into
    it and calls the program on it; otherwise the ring keeps an input
    buffer of the boundary's shape for the stage.

    On CUDA devices each stage gets a stream of its own.  :meth:`run`
    forks the stage streams from the caller's current stream and, by
    default, joins them back into it, so the output is ready in the
    caller's stream order and the call itself does not wait for the
    card.  A ring is driven by one thread at a time.
    """

    def __init__(self, stage_fns: Sequence[Callable],
                 devices: Sequence[torch.device], *,
                 boundary_shapes: Sequence[Optional[Tuple[int, ...]]],
                 out_shape: Tuple[int, ...],
                 out_dtype: torch.dtype = torch.float32,
                 carry_dtype: torch.dtype = torch.int8):
        S = len(stage_fns)
        if S < 1 or len(devices) != S:
            raise ValueError(f"{S} stage programs for {len(devices)} "
                             f"device slot(s)")
        if len(boundary_shapes) != S:
            raise ValueError(
                f"boundary_shapes must carry one entry per stage "
                f"({S}), got {len(boundary_shapes)}")
        devices = [canonical_device(d) for d in devices]
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a stage ring runs on one device type, got "
                             f"{[str(d) for d in devices]}")
        self.fns = list(stage_fns)
        self.devices = devices
        self.boundary_shapes = [None if b is None else tuple(b)
                                for b in boundary_shapes]
        self.out_shape = tuple(out_shape)
        self.out_dtype = out_dtype
        self.carry_dtype = carry_dtype
        self.cuda = devices[0].type == "cuda"
        # each stage's input buffer: its program's static input, or one
        # the ring holds (stage 0 reads the round directly unless its
        # program has a static input)
        self.inbuf: List[Optional[torch.Tensor]] = []
        for s, (fn, dev) in enumerate(zip(self.fns, devices)):
            buf = getattr(fn, "static_in", None)
            want = self.boundary_shapes[s]
            if buf is not None:
                if (s > 0 and tuple(buf.shape) != want) \
                        or buf.device != dev:
                    raise ValueError(
                        f"stage {s}'s static input {tuple(buf.shape)} on "
                        f"{buf.device} != boundary {want} on {dev}")
            elif s > 0:
                if want is None:
                    raise ValueError(f"stage {s} needs a boundary shape")
                buf = torch.empty(want, dtype=carry_dtype, device=dev)
            self.inbuf.append(buf)
        if self.cuda:
            self.streams = [torch.cuda.Stream(device=d) for d in devices]
            self.done = [torch.cuda.Event() for _ in devices]
            self.consumed = [torch.cuda.Event() for _ in devices]
            for buf, st in zip(self.inbuf, self.streams):
                if buf is not None:
                    buf.record_stream(st)
        # whether stage s's output was ever handed on (its consumed
        # event recorded): from then on it waits on that event before
        # overwriting the output, across rounds too
        self._handed = [False] * S

    @property
    def n_stages(self) -> int:
        return len(self.fns)

    def _on(self, s: int):
        return _on_stream(self.devices[s],
                          self.streams[s] if self.cuda else None)

    def run(self, params, x_mb: torch.Tensor, *,
            join: bool = True) -> torch.Tensor:
        """``x_mb`` [M, mb, ...] -> [M, *out_shape] on the last stage's
        device, by the static schedule: at tick ``t`` stage ``s`` runs
        microbatch ``t - s`` (stages idle outside ``[s, s + M)``), the
        stages of a tick enqueued last to first so that each hand-off
        reads the previous tick's output.

        On CUDA devices the stage streams first wait for the caller's
        current stream (where ``x_mb`` was made).  ``join`` makes the
        caller's stream wait for the round; without it the caller waits
        on an event it records on ``streams[-1]`` after the call, and
        the next round's stages start as soon as their own stage of this
        round is done."""
        _check_microbatches(x_mb)
        S, M = self.n_stages, x_mb.shape[0]
        if x_mb.device != self.devices[0]:
            x_mb = x_mb.to(self.devices[0])
        if self.inbuf[0] is not None \
                and tuple(x_mb.shape[1:]) != tuple(self.inbuf[0].shape):
            raise ValueError(f"microbatches {tuple(x_mb.shape[1:])} != "
                             f"stage 0's input "
                             f"{tuple(self.inbuf[0].shape)}")
        if self.cuda:
            begin = torch.cuda.Event()
            begin.record(torch.cuda.current_stream(self.devices[0]))
            for st in self.streams:
                st.wait_event(begin)
            x_mb.record_stream(self.streams[0])
        with self._on(S - 1):
            out = torch.empty((M,) + self.out_shape, dtype=self.out_dtype,
                              device=self.devices[-1])
        held: List[Optional[torch.Tensor]] = [None] * S
        for t in range(M + S - 1):
            for s in reversed(range(S)):
                m = t - s
                if 0 <= m < M:
                    with self._on(s):
                        held[s] = self._step(s, m, params, x_mb, held, out)
        if self.cuda and join:
            caller = torch.cuda.current_stream(self.devices[-1])
            caller.wait_event(self.done[-1])
            out.record_stream(caller)
        return out

    def _step(self, s: int, m: int, params, x_mb, held, out):
        """Stage ``s`` on microbatch ``m``, on its stream: take the
        boundary (after the producer's event), free the producer's slot
        (the consumed event), wait until this stage's own last output
        was consumed, run, and hand the output on.  Returns the output
        the next stage will read (None for the last stage)."""
        S = self.n_stages
        src = x_mb[m] if s == 0 else held[s - 1]
        if s > 0 and self.cuda:
            self.streams[s].wait_event(self.done[s - 1])
        buf = self.inbuf[s]
        if buf is not None:
            buf.copy_(src, non_blocking=True)
            src = buf
        if s > 0 and self.cuda:
            self.consumed[s - 1].record(self.streams[s])
            self._handed[s - 1] = True
        if self.cuda and self._handed[s]:
            self.streams[s].wait_event(self.consumed[s])
        y = self.fns[s](params, src)
        if s == S - 1:
            if tuple(y.shape) != self.out_shape:
                raise ValueError(f"stage {s} produced {tuple(y.shape)}, "
                                 f"expected out_shape {self.out_shape}")
            out[m].copy_(y)
            nxt = None
        else:
            want = self.boundary_shapes[s + 1]
            if tuple(y.shape) != want:
                raise ValueError(
                    f"stage {s} produced {tuple(y.shape)}, but stage "
                    f"{s + 1} declares boundary shape {want}")
            nxt = y.to(self.carry_dtype)
            if self.cuda:
                nxt.record_stream(self.streams[s + 1])
        if self.cuda:
            self.done[s].record(self.streams[s])
        return nxt


def _check_staged(params_staged, n_stages: int, axis: str) -> None:
    bad = [tuple(a.shape) for a in _tree_leaves(params_staged)
           if tuple(a.shape[:1]) != (n_stages,)]
    if bad:
        raise ValueError(
            f"params_staged leaves must carry a leading stage dimension of "
            f"{n_stages} (the {axis!r} mesh axis size); got leading dims "
            f"{sorted({s[0] if s else None for s in bad})} — build them "
            f"with split_stages(params, {n_stages})")


def pipeline_apply(layer_fn: Callable, params_staged, x_mb: torch.Tensor, *,
                   mesh, axis: str = "model") -> torch.Tensor:
    """Run microbatches through the homogeneous stage ring.

    layer_fn(stage_params, x) -> x   applies one stage's layer group; it is
        called with the [L/S, ...] slice owned by the stage, on the
        stage's device.
    params_staged: [S, L/S, ...] tree of tensors (see ``split_stages``).
    x_mb: [M, mb, ...] microbatched input.

    Returns [M, mb, ...] outputs on the last stage's device.
    """
    n_stages = _validate_mesh_axis(mesh, axis)
    _check_microbatches(x_mb)
    _check_staged(params_staged, n_stages, axis)
    devices = mesh.axis_devices(axis)
    fns = []
    for s, dev in enumerate(devices):
        local = _tree_map(lambda a, _s=s, _d=dev: a[_s].to(_d),
                          params_staged)
        fns.append(lambda _p, x, _l=local: layer_fn(_l, x))
    shape = tuple(x_mb.shape[1:])
    ring = StageRing(fns, devices, boundary_shapes=[shape] * n_stages,
                     out_shape=shape, out_dtype=x_mb.dtype,
                     carry_dtype=x_mb.dtype)
    return ring.run(None, x_mb)


def staged_pipeline_apply(stage_fns: Sequence[Callable], params,
                          x_mb: torch.Tensor, *, mesh, axis: str = "model",
                          boundary_shapes: Sequence[Optional[Tuple[int, ...]]],
                          out_shape: Tuple[int, ...],
                          out_dtype: torch.dtype = torch.float32,
                          carry_dtype: torch.dtype = torch.int8
                          ) -> torch.Tensor:
    """``pipeline_apply`` generalised to HETEROGENEOUS stages.

    A partitioned CNN's stages run different slices of the compiled
    engine table, and stage boundaries change the activation geometry
    (stride-2 transitions, GAP), so every slot runs its OWN program and
    each hop carries its boundary's own shape.

    stage_fns[s](params, x) -> y   runs stage ``s``'s layer slice;
        ``params`` is the whole parameter tree — each stage program
        reads only its own layers' entries.
    x_mb: [M, mb, ...] microbatched input.
    boundary_shapes[s]: the per-microbatch activation shape ENTERING
        stage ``s`` (``boundary_shapes[0]`` is unused — stage 0 reads
        ``x_mb`` directly — and may be None).  Inter-stage activations
        are cast to ``carry_dtype`` (int8 for the quantized CNN).
    out_shape/out_dtype: the last stage's per-microbatch output.

    Returns [M, *out_shape] on the last stage's device.  Admission
    follows the static schedule of :class:`StageRing`: one microbatch
    per tick, at most S in flight (§V-A), microbatch m completing at
    tick m + S - 1.
    """
    S = _validate_mesh_axis(mesh, axis)
    if len(stage_fns) != S:
        raise ValueError(
            f"{len(stage_fns)} stage programs for a {S}-device {axis!r} "
            f"axis; the partition's n_stages must equal the mesh axis size")
    if len(boundary_shapes) != S:
        raise ValueError(
            f"boundary_shapes must carry one entry per stage "
            f"({S}), got {len(boundary_shapes)}")
    _check_microbatches(x_mb)
    ring = StageRing(stage_fns, mesh.axis_devices(axis),
                     boundary_shapes=boundary_shapes, out_shape=out_shape,
                     out_dtype=out_dtype, carry_dtype=carry_dtype)
    return ring.run(params, x_mb)


# slot (device, stage index) -> the CUDA stream every recording round
# runs that stage on: the caching allocator keeps freed blocks per
# stream, so a fresh stream each step would allocate every activation
# and gradient anew
_STAGE_STREAMS: Dict[Tuple[torch.device, int], Any] = {}
_STAGE_STREAMS_LOCK = threading.Lock()


def _stage_stream(device: torch.device, s: int):
    with _STAGE_STREAMS_LOCK:
        st = _STAGE_STREAMS.get((device, s))
        if st is None:
            st = _STAGE_STREAMS[device, s] = torch.cuda.Stream(device=device)
        return st


def _recording_round(stage_fns: Sequence[Callable],
                     devices: Sequence[torch.device], x_mb: torch.Tensor,
                     last_fn: Callable[[int, torch.Tensor], torch.Tensor]
                     ) -> List[torch.Tensor]:
    """One round of the stage ring that autograd records: the ring's tick
    order and, on CUDA devices, its stage streams, but every (stage,
    microbatch) hand-off a fresh tensor (no reused input buffer, no copy
    into an output), since autograd keeps what a stage read for its
    backward.  ``last_fn(m, y)`` runs on the last stage's stream on
    microbatch ``m``'s output; returns its results, which the caller's
    current stream may read.  A backward op runs on its forward op's
    stream, so each stage's backward is its own stream's work too."""
    S, M = len(stage_fns), x_mb.shape[0]
    cuda = devices[0].type == "cuda"
    streams = [None] * S
    if cuda:
        streams = [_stage_stream(d, s) for s, d in enumerate(devices)]
        done = [torch.cuda.Event() for _ in devices]
        begin = torch.cuda.Event()
        begin.record(torch.cuda.current_stream(devices[0]))
        for st in streams:
            st.wait_event(begin)
        x_mb.record_stream(streams[0])

    held: List[Optional[torch.Tensor]] = [None] * S
    results: List[Optional[torch.Tensor]] = [None] * M
    for t in range(M + S - 1):
        for s in reversed(range(S)):     # each hand-off: last tick's output
            m = t - s
            if not 0 <= m < M:
                continue
            with _on_stream(devices[s], streams[s]):
                if s == 0:
                    x = x_mb[m].to(devices[0])
                else:
                    if cuda:
                        streams[s].wait_event(done[s - 1])
                    x = held[s - 1]
                y = stage_fns[s](x)
                if s == S - 1:
                    results[m] = last_fn(m, y)
                else:
                    held[s] = y.to(devices[s + 1])
                    if cuda:
                        held[s].record_stream(streams[s + 1])
                if cuda:
                    done[s].record(streams[s])
    if cuda:
        caller = torch.cuda.current_stream(devices[-1])
        caller.wait_event(done[-1])
        for r in results:
            r.record_stream(caller)
    return results


def gpipe_train_step(layer_fn: Callable, loss_fn: Callable, params_staged,
                     x_mb: torch.Tensor, y_mb: torch.Tensor, *, mesh,
                     axis: str = "model"):
    """GPipe: every microbatch forward through the stage ring, the mean
    over microbatches of ``loss_fn(out[m], y_mb[m])``, and its gradient
    by autograd through the same schedule.  Returns ``(loss, grads)``:
    ``grads`` a tree shaped like ``params_staged`` ([S, L/S, ...]), on
    its leaves' devices.

    ``layer_fn`` and ``params_staged`` are ``pipeline_apply``'s, with its
    errors.  Stage ``s`` differentiates a detached copy of its slice of
    the params on its device, so the caller's tensors are neither
    mutated nor given a ``.grad``.  On CUDA devices each stage's forward
    and backward run on the stage's own stream (``_recording_round``);
    on the CPU the same schedule runs in one thread, and the result
    equals the sequential composition of the stages' autograd."""
    n_stages = _validate_mesh_axis(mesh, axis)
    _check_microbatches(x_mb)
    _check_staged(params_staged, n_stages, axis)
    devices = mesh.axis_devices(axis)
    leaves = _tree_leaves(params_staged)
    local = [_tree_map(lambda a, _s=s, _d=dev:
                       a[_s].detach().to(_d).requires_grad_(True),
                       params_staged)
             for s, dev in enumerate(devices)]
    fns = [lambda x, _l=local[s]: layer_fn(_l, x) for s in range(n_stages)]
    y_mb = y_mb.to(devices[-1])
    losses = _recording_round(fns, devices, x_mb,
                              lambda m, y: loss_fn(y, y_mb[m]))
    loss = torch.stack(losses).mean()
    inputs = [t for tree in local for t in _tree_leaves(tree)]
    got = torch.autograd.grad(loss, inputs, allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g
           for t, g in zip(inputs, got)]
    per = len(leaves)
    stacked = iter([torch.stack([got[s * per + i].to(a.device)
                                 for s in range(n_stages)])
                    for i, a in enumerate(leaves)])
    return loss.detach(), _tree_map(lambda _: next(stacked), params_staged)
