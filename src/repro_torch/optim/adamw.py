"""AdamW with optional int8 gradient compression — the port of
``repro.optim.adamw`` (``AdamWConfig``, ``lr_schedule``, ``init``,
``global_norm``, ``compress_int8``, ``apply``).

Where the JAX package returns new trees, ``apply`` updates the params and
the optimizer state IN PLACE under ``torch.no_grad()``, one leaf, and for
an ``[L]``-stacked leaf one layer's slab, at a time: at Phi-4-mini's full
width a stacked FFN leaf is 3.2 GB in f32, and a literal port of the
update would hold several f32 temporaries of that size on top of the
46 GB that params, grads and moments take.  The order of operations in
the update is the reference's, step for step; the scalars (learning
rate, bias corrections, clip scale) are 0-d f32 tensors on the params'
device, so a step never waits for the host.

``state_specs`` gives the JAX package's ZeRO-1 partition specs of the
state (each moment's param spec with a ``data``-axis sharding on its
first free, evenly divisible dim); the port has no partitioner, so they
drive the dry run's per-device bytes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.models.layers import P, axis_size

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_int8: bool = False
    # the gradient in bf16 before the update (halves the bytes a data-
    # parallel collective would move; the moments still accumulate f32)
    grad_wire_bf16: bool = False


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``lr_min``; f32 arithmetic on
    the 0-d step tensor, as the reference's."""
    s = step.to(torch.float32)
    warm = cfg.lr_peak * (s + 1) / max(cfg.warmup_steps, 1)
    t = ((s - cfg.warmup_steps)
         / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * \
        (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero f32 moments (and int8 residuals) shaped like ``params``, and
    step 0 (int32) on the params' device."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = pytree.tree_leaves(params)[0].device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "mu": pytree.tree_map(zeros32, params),
             "nu": pytree.tree_map(zeros32, params)}
    if cfg.compress_int8:
        state["residual"] = pytree.tree_map(zeros32, params)
    return state


def _shard_extra_dim(spec: P, shape) -> P:
    """Extend a param spec with a ``data``-axis sharding on the first free,
    evenly-divisible dim (ZeRO-1 partitioning)."""
    d_sz = axis_size("data")
    if d_sz <= 1:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for p in parts if p is not None
            for a in (p if isinstance(p, tuple) else (p,))}
    if "data" in used:
        return spec
    for i, (p, dim) in enumerate(zip(parts, shape)):
        if p is None and dim % d_sz == 0:
            parts[i] = "data"
            return P(*parts)
    return spec


def _map_specs(fn, specs, params):
    """``fn(spec, param)`` over a spec tree and the param tree of the same
    structure (dicts and lists; a ``P`` is a leaf)."""
    if isinstance(specs, P):
        return fn(specs, params)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, params[k]) for k, v in specs.items()}
    return [_map_specs(fn, s, p) for s, p in zip(specs, params)]


def state_specs(params: Params, param_specs: Params,
                cfg: AdamWConfig) -> Dict[str, Any]:
    """The partition specs of ``init(params, cfg)``'s state.  ``params``
    needs only shapes (meta tensors do)."""
    mom_specs = _map_specs(lambda spec, p: _shard_extra_dim(spec, p.shape),
                           param_specs, params)
    specs = {"step": P(), "mu": mom_specs, "nu": mom_specs}
    if cfg.compress_int8:
        specs["residual"] = mom_specs
    return specs


def _slabs(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of t to work on one at a time: the layers of an [L]-stacked
    leaf (rank 3 and up), else t itself."""
    if t.dim() >= 3:
        yield from t.unbind(0)
    else:
        yield t


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    total = None
    for x in pytree.tree_leaves(tree):
        for s in _slabs(x):
            part = s.float().square().sum()
            total = part if total is None else total + part
    return total.sqrt()


def compress_int8(g: torch.Tensor, residual: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization with error feedback.
    Returns (the dequantized value, the new residual)."""
    g = g.float() + residual
    scale = g.abs().max().clamp_min(1e-12) / 127.0
    q = torch.round(g / scale).clamp(-127, 127)
    deq = q * scale
    return deq, g - deq


def _update(p, g, mu, nu, *, cfg: AdamWConfig, scale, lr, bc1, bc2) -> None:
    """One slab of the AdamW update, in place, in the reference's order:
    g *= scale; mu = b1 mu + (1-b1) g; nu = b2 nu + (1-b2) g^2;
    p -= lr (mu/bc1 / (sqrt(nu/bc2) + eps) + wd p), the last in f32 and
    rounded to p's dtype."""
    t = g.float() * scale
    mu.mul_(cfg.b1).add_(t * (1 - cfg.b1))
    nu.mul_(cfg.b2).add_(t.square_().mul_(1 - cfg.b2))
    step_v = mu / bc1
    torch.div(nu, bc2, out=t).sqrt_().add_(cfg.eps)
    step_v.div_(t)
    pf = p.float()
    step_v.add_(torch.mul(pf, cfg.weight_decay, out=t))
    p.copy_(pf.sub_(step_v.mul_(lr)))


@torch.no_grad()
def apply(grads: Params, state: Dict[str, Any], params: Params,
          cfg: AdamWConfig) -> Tuple[Params, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step: updates ``params`` and ``state`` in place and
    returns them with the metrics ``grad_norm`` and ``lr`` (0-d f32
    tensors)."""
    step = state["step"] + 1
    g_leaves, spec = pytree.tree_flatten(grads)
    if cfg.grad_wire_bf16:
        g_leaves = [g.to(torch.bfloat16) for g in g_leaves]
    if cfg.compress_int8:
        r_leaves = pytree.tree_leaves(state["residual"])
        for i, (g, r) in enumerate(zip(g_leaves, r_leaves)):
            g_leaves[i], new_r = compress_int8(g, r)
            r.copy_(new_r)
    gnorm = global_norm(g_leaves)
    scale = torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-12), max=1.0)
    lr = lr_schedule(cfg, state["step"])
    stepf = step.to(torch.float32)
    # the betas as 0-d tensors made on the device itself (``torch.full``):
    # no host copy, and the same aten op on every device
    bc1 = 1 - torch.pow(torch.full((), cfg.b1, dtype=torch.float32,
                                   device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.full((), cfg.b2, dtype=torch.float32,
                                   device=stepf.device), stepf)
    p_leaves = pytree.tree_leaves(params)
    mu_leaves = pytree.tree_leaves(state["mu"])
    nu_leaves = pytree.tree_leaves(state["nu"])
    if not len(p_leaves) == len(g_leaves) == len(mu_leaves):
        raise ValueError("grads, params and moments differ in structure")
    for p, g, mu, nu in zip(p_leaves, g_leaves, mu_leaves, nu_leaves):
        for ps, gs, ms, ns in zip(_slabs(p), _slabs(g), _slabs(mu),
                                  _slabs(nu)):
            _update(ps, gs, ms, ns, cfg=cfg, scale=scale, lr=lr, bc1=bc1,
                    bc2=bc2)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
