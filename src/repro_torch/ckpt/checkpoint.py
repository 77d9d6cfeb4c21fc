"""Atomic, async, keep-N checkpoints — the port of ``repro.ckpt.checkpoint``
(``save``, ``AsyncCheckpointer``, ``available_steps``,
``restore_latest`` with its elastic-rescale hook ``shardings``: where the
JAX package takes a tree of ``NamedSharding``, the port takes a matching
tree of devices and restores each leaf onto its device).

The same durability contract and layout as the JAX package:

* a checkpoint directory ``step_<8 digits>`` becomes visible only by an
  atomic rename of ``step_<...>.tmp``, after every leaf, ``manifest.json``
  and the ``COMMITTED`` marker are written, so a crash mid-save never
  corrupts the newest restorable state;
* ``restore_latest`` walks checkpoints newest first and skips any that
  fail verification (missing marker, missing or truncated leaves);
* ``AsyncCheckpointer`` writes on a background thread.

Leaves are ``.npy`` files in the order of the tree's sorted keys, as JAX
flattens dicts.  numpy has no bf16: a bf16 leaf is stored as its raw 16
bits (int16) and the manifest records ``"dtype": "bfloat16"``.  The port
need not read the JAX package's checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import flatten_with_paths

MANIFEST = "manifest.json"
COMMIT = "COMMITTED"


def _unflat(like, by_key: Dict[str, Any], prefix: str = ""):
    """``like``'s structure, in its own key order, with the leaves of
    ``by_key`` (key path -> leaf)."""
    if isinstance(like, dict):
        return {k: _unflat(v, by_key, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    return by_key[prefix]


def _host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of one tensor (never a view of it) and its dtype name."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().copy(), "bfloat16"
    arr = t.cpu().numpy().copy()
    return arr, str(arr.dtype)


def _host_tree(tree) -> List[Tuple[str, np.ndarray, str]]:
    return [(key, *_host(leaf)) for key, leaf in flatten_with_paths(tree)]


def _write(path: str, step: int, host: List[Tuple[str, np.ndarray, str]],
           keep_n: int) -> str:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names = []
    for i, (key, arr, dtype) in enumerate(host):
        name = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, name), arr)
        names.append({"key": key, "file": name, "dtype": dtype,
                      "shape": list(arr.shape)})
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump({"step": step, "leaves": names, "time": time.time()}, f)
    with open(os.path.join(tmp, COMMIT), "w") as f:
        f.write(str(step))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic commit
    _gc(path, keep_n)
    return final


def save(path: str, step: int, tree, *, keep_n: int = 3) -> str:
    """Synchronous atomic save.  Returns the committed directory."""
    return _write(path, step, _host_tree(tree), keep_n)


class AsyncCheckpointer:
    """Background-thread saver.  ``save`` copies every leaf to host memory
    before it returns, so an in-place update right after it cannot reach
    the checkpoint (JAX's arrays are immutable; the port's optimizer
    updates in place), and writes the files off-thread.  ``wait()`` joins
    the pending save and raises its error, if any."""

    def __init__(self, path: str, keep_n: int = 3):
        self.path = path
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree) -> None:
        host = _host_tree(tree)
        self.wait()

        def work():
            try:
                _write(self.path, step, host, self.keep_n)
            except BaseException as e:       # surfaced by wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def _gc(path: str, keep_n: int) -> None:
    steps = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_n]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def _verify(d: str) -> bool:
    if not os.path.exists(os.path.join(d, COMMIT)):
        return False
    try:
        with open(os.path.join(d, MANIFEST)) as f:
            man = json.load(f)
        for leaf in man["leaves"]:
            p = os.path.join(d, leaf["file"])
            if not os.path.exists(p):
                return False
            a = np.load(p, mmap_mode="r")
            if list(a.shape) != leaf["shape"]:
                return False
        return True
    except (OSError, ValueError, KeyError):
        return False


def available_steps(path: str) -> List[int]:
    if not os.path.isdir(path):
        return []
    return [int(d.split("_")[1]) for d in sorted(os.listdir(path))
            if d.startswith("step_") and not d.endswith(".tmp")
            and _verify(os.path.join(path, d))]


def _tensor(arr: np.ndarray, dtype_name: str, like: torch.Tensor,
            device) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, copy=True))
    if dtype_name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device=device, dtype=like.dtype)


def restore_latest(path: str, like_tree, *,
                   shardings=None) -> Optional[Tuple[int, Any]]:
    """Restore the newest verifiable checkpoint into the structure, dtypes
    and devices of ``like_tree`` (a tree of tensors).  ``shardings``: a
    matching tree of devices (or None) — the elastic-rescale hook: pass
    the new placement and each leaf is restored onto its device.  Returns
    (step, tree), or None when there is none."""
    like = flatten_with_paths(like_tree)
    devices = ([ref.device for _, ref in like] if shardings is None
               else [torch.device(d) for _, d in flatten_with_paths(shardings)])
    if len(devices) != len(like):
        raise ValueError(f"shardings has {len(devices)} leaves, like_tree "
                         f"{len(like)}")
    for step in sorted(available_steps(path), reverse=True):
        d = os.path.join(path, f"step_{step:08d}")
        try:
            with open(os.path.join(d, MANIFEST)) as f:
                man = json.load(f)
            if len(man["leaves"]) != len(like):
                continue
            leaves = [_tensor(np.load(os.path.join(d, leaf["file"])),
                              leaf["dtype"], ref, dev)
                      for leaf, (_, ref), dev in zip(man["leaves"], like,
                                                     devices)]
        except (OSError, ValueError, KeyError):
            continue                          # corrupt -> try older
        return step, _unflat(like_tree, {key: leaf for (key, _), leaf
                                         in zip(like, leaves)})
    return None
