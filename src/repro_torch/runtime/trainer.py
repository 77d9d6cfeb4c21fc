"""Training runtime — the port of ``repro.runtime.trainer``
(``TrainConfig``, ``make_train_step``, ``Trainer``).

One step: loss -> grads -> clip -> AdamW, with microbatch gradient
accumulation as a Python loop into f32 sums; remat on by default (each
layer saves only its input and runs again in the backward).  Attention
runs through the flash kernels where kernel mode routes it (K9 forward,
K10/K11 backward).  The data are counter-based (``TokenDataset``), so a
restart at step k replays exactly the batches the failed run saw, and
recovery from the newest checkpoint is bitwise.

Deliberate differences from the JAX package:

* the optimizer updates params and moments in place
  (``repro_torch.optim.adamw``); ``AsyncCheckpointer.save`` copies to the
  host before it returns, so no checkpoint mixes two steps;
* recovery catches only the injected failure (:class:`InjectedFailure`)
  and ``OSError``, and re-raises a second failure of the same step.  The
  JAX loop catches every ``RuntimeError``; here a failed nvcc build, a
  launch error or a CUDA fault is a ``RuntimeError`` too, and retrying it
  would hide it and loop forever.

Runs on the card by default (``device="cuda"``; raises without one) and
turns TF32 off for the process there, once, because the f32 loss
product must be full f32 as in the reference.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import TokenDataset
from repro_torch.models import transformer as tmod
from repro_torch.optim import adamw
from repro_torch.runtime.pipeline import resolve_device


def _default_ckpt_path() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1            # gradient accumulation factor
    ckpt_every: int = 50
    ckpt_path: str = field(default_factory=_default_ckpt_path)
    keep_n: int = 3
    log_every: int = 10
    remat: bool = True
    adamw: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)


class InjectedFailure(RuntimeError):
    """The crash ``Trainer.run(fail_at=...)`` injects (chaos drills)."""


def value_and_grad(params, arch: ArchConfig, batch: Dict[str, Any], *,
                   remat: bool = True) -> Tuple[torch.Tensor, Any]:
    """``loss_fn`` and its gradient with respect to every leaf of
    ``params`` (a tree of the same structure, each leaf in its param's
    dtype), as ``jax.value_and_grad(loss_fn)``."""
    leaves, spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss = tmod.loss_fn(pytree.tree_unflatten(req, spec), arch, batch,
                            remat=remat)
        grads = torch.autograd.grad(loss, req)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def make_train_step(arch: ArchConfig, tcfg: TrainConfig):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``.  ``batch`` has a leading ``[microbatches]``
    axis when accumulating; then the grads are f32 means, else each in
    its param's dtype, as in the JAX package."""
    acfg = tcfg.adamw

    def step_fn(params, opt_state, batch):
        m = tcfg.microbatches
        if m > 1:
            gsum, lsum = None, None
            for i in range(m):
                loss, g = value_and_grad(
                    params, arch, {k: v[i] for k, v in batch.items()},
                    remat=tcfg.remat)
                if gsum is None:
                    gsum = pytree.tree_map(lambda x: x.float(), g)
                    lsum = loss.float()
                else:
                    pytree.tree_map(lambda s, x: s.add_(x), gsum, g)
                    lsum = lsum + loss
            grads = pytree.tree_map(lambda s: s.div_(m), gsum)
            loss = lsum / m
        else:
            loss, grads = value_and_grad(params, arch, batch,
                                         remat=tcfg.remat)
        params, opt_state, metrics = adamw.apply(grads, opt_state, params,
                                                 acfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step_fn


class Trainer:
    """Step loop with checkpoint/restore and crash recovery.

    ``params``: the initial weights (e.g. carried across from the JAX
    package by ``convert.lm_params_from_numpy``), already on ``device``;
    by default they are drawn from ``seed``."""

    def __init__(self, arch: ArchConfig, tcfg: TrainConfig,
                 data: TokenDataset, *, seed: int = 0, device="cuda",
                 params=None):
        self.arch = arch
        self.tcfg = tcfg
        self.data = data
        self.seed = seed
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        # the restart point when no checkpoint exists yet: a host copy of
        # given params, else the seed
        self._params0 = None if params is None else pytree.tree_map(
            lambda t: t.detach().to("cpu", copy=True), params)
        self._init_state()
        self.step = 0
        self.ckpt = ckpt_lib.AsyncCheckpointer(tcfg.ckpt_path,
                                               keep_n=tcfg.keep_n)
        self._step_fn = make_train_step(arch, tcfg)
        self.history: list = []

    def _init_state(self) -> None:
        if self._params0 is None:
            gen = torch.Generator(self.device).manual_seed(self.seed)
            self.params = tmod.init_params(gen, self.arch, self.device)
        else:
            self.params = pytree.tree_map(lambda t: t.to(self.device),
                                          self._params0)
        self.opt_state = adamw.init(self.params, self.tcfg.adamw)

    # -- checkpoint plumbing ------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self, sync: bool = False):
        if sync:
            ckpt_lib.save(self.tcfg.ckpt_path, self.step, self._state_tree(),
                          keep_n=self.tcfg.keep_n)
        else:
            self.ckpt.save(self.step, self._state_tree())

    def restore(self) -> bool:
        got = ckpt_lib.restore_latest(self.tcfg.ckpt_path, self._state_tree())
        if got is None:
            return False
        self.step, tree = got
        self.params, self.opt_state = tree["params"], tree["opt"]
        return True

    # -- batches ------------------------------------------------------------
    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        gb = self.data.global_batch(step)
        b = {k: torch.from_numpy(v).to(self.device, torch.int64)
             for k, v in gb.items()}
        m = self.tcfg.microbatches
        if m > 1:
            b = {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
                 for k, v in b.items()}
        return b

    # -- loop ---------------------------------------------------------------
    def run(self, n_steps: Optional[int] = None,
            fail_at: Optional[int] = None) -> list:
        """Run the loop.  ``fail_at``: inject a crash at that step;
        recovery restores the newest checkpoint (or starts again from the
        initial weights) and continues."""
        target = self.step + (n_steps or self.tcfg.steps)
        failed = set()
        while self.step < target:
            try:
                if fail_at is not None and self.step == fail_at:
                    fail_at = None
                    raise InjectedFailure("injected node failure")
                batch = self._batch(self.step)
                self.params, self.opt_state, m = self._step_fn(
                    self.params, self.opt_state, batch)
                self.step += 1
                if self.step % self.tcfg.log_every == 0 or \
                        self.step == target:
                    self.history.append(
                        {"step": self.step,
                         "loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"])})
                if self.step % self.tcfg.ckpt_every == 0:
                    self.save()
            except (InjectedFailure, OSError):
                # node failure: restore and resume (the counter-based data
                # make the replay exact); a step that fails twice is not
                # a node failure
                if self.step in failed:
                    raise
                failed.add(self.step)
                self.ckpt.wait()
                if not self.restore():
                    self._init_state()
                    self.step = 0
        self.ckpt.wait()
        return self.history
