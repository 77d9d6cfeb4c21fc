"""Meshes: named axes over devices.

The JAX package builds ``jax.sharding.Mesh`` objects over TPU (or forced
host) devices; the stage ring of :mod:`repro_torch.core.dataflow` needs
only their shape, their axis names and which device holds each slot, and
the dry run (``launch/dryrun.py``) their axis sizes.
Here a :class:`Mesh` is that: ``axis_names`` and a numpy object array
``devices`` of :class:`torch.device`, one per slot.  A device may repeat:
``["cuda:0"] * 4`` is a 4-stage mesh on one card (each slot gets its own
CUDA stream there), ``["cpu"] * 4`` one on the CPU; entered, ``(1, 4)``
over ``["cuda:0"] * 4`` is a 4-way model axis on one card, whose slots
the expert-parallel MoE runs one after another.

Building a mesh touches no device state at import time.
``make_production_mesh`` gives the JAX package's production meshes, (16,
16) or (2, 16, 16), over ``meta`` devices: abstract, as the JAX dry run's
512 forced host devices are.  ``make_local_mesh`` covers the cards of
this process.  Both record their axis sizes for the spec builders
(``models.layers.set_mesh_axis_sizes``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.layers import (enter_mesh, exit_mesh,
                                      set_mesh_axis_sizes)


@dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over a grid of devices (``devices.shape`` is the mesh
    shape, one name per dimension).

    ``with mesh:`` makes it the active mesh of the thread, as in JAX:
    inside, ``models.layers._current_physical_mesh()`` returns it where
    it has more than one slot (the expert-parallel MoE and the flash
    call's mesh rule read it), and its axis sizes are the spec builders'.
    Leaving restores the mesh and sizes before it, on an exception too;
    meshes nest."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __enter__(self) -> "Mesh":
        enter_mesh(self)
        return self

    def __exit__(self, *exc) -> None:
        exit_mesh(self)

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis``, at index 0 of every other axis:
        slot ``s`` of a stage ring over ``axis`` runs on entry ``s``."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}; available axes: "
                             f"{mesh_axis_sizes(self)}")
        k = self.axis_names.index(axis)
        moved = np.moveaxis(self.devices, k, 0)
        return tuple(moved.reshape(moved.shape[0], -1)[:, 0])


def canonical_device(device) -> torch.device:
    """``device`` as a :class:`torch.device` with its index: a bare
    ``"cuda"`` names the current card, as a tensor's ``.device`` does."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def compat_make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
                     devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` named ``axes``.  With no ``devices`` it takes
    the first ``prod(shape)`` CUDA devices and raises if there are fewer
    (there is no CPU default); ``devices`` names them explicitly, in
    row-major order, and may repeat one."""
    shape = tuple(int(n) for n in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh shape {shape} must be positive")
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a {shape} mesh needs {n} CUDA device(s), {have} "
                f"available; pass devices=[...] (a device may repeat, "
                f"e.g. ['cuda:0'] * {n} or ['cpu'] * {n})")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = [canonical_device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"{len(devs)} device(s) for a {shape} mesh of {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(devices=arr.reshape(shape), axis_names=axes)


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The single-pod (data 16, model 16) or two-pod (pod 2, data 16,
    model 16) production mesh, every slot a ``meta`` device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = compat_make_mesh(shape, axes,
                            devices=["meta"] * math.prod(shape))
    set_mesh_axis_sizes(dict(zip(axes, shape)))
    return mesh


def make_local_mesh(model: int = 1, data: Optional[int] = None, *,
                    device=None) -> Mesh:
    """(data, model) over this process's cards (``torch.cuda.
    device_count()``); raises without a card.  ``device="cpu"`` gives the
    one-slot (1, 1) mesh on the CPU instead."""
    if device is not None and torch.device(device).type == "cpu":
        n, devices = 1, ["cpu"]
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_local_mesh: no CUDA device; pass "
                               "device='cpu' for the CPU")
        devices = None
    data = data or (n // model)
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh does not cover {n} "
                         f"device(s)")
    mesh = compat_make_mesh((data, model), ("data", "model"),
                            devices=devices)
    set_mesh_axis_sizes({"data": data, "model": model})
    return mesh
