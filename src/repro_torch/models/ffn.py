"""Gated FFN (SwiGLU / GeGLU) and the mixture-of-experts FFN — the port of
``repro.models.ffn``.

The MoE routes each token to its top-k experts.  At most ``MOE_DENSE_T``
tokens take the dropless path (every expert computes every token, the
gates zero the ones not chosen); more tokens take the grouped path:
groups of ``MOE_GROUP`` tokens, a capacity per expert and group, the
choices past it dropped, gathers in and out.  The expert-parallel
``shard_map`` path waits for a later slice (ROADMAP Queue 1); on one
device the JAX package takes the grouped path too.  ``ffn_spec`` and
``moe_spec`` give the init trees of ``Leaf``; ``ffn_specs`` and
``moe_specs`` the partition specs, copies of the JAX package's.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import MODEL_AXIS, P, dense_leaf, maybe_axis

Params = Dict[str, Any]


def _act(name: str):
    if name == "silu":
        return lambda x: x * torch.sigmoid(x)       # jax.nn.silu's form
    return lambda x: F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


# ---------------------------------------------------------------------------
# dense FFN
# ---------------------------------------------------------------------------


def ffn_spec(d: int, d_ff: int, dtype) -> Params:
    return {
        "w_gate": dense_leaf((d, d_ff), dtype),
        "w_up": dense_leaf((d, d_ff), dtype),
        "w_down": dense_leaf((d_ff, d), dtype),
    }


def ffn_specs(d_ff: int) -> Params:
    ax = maybe_axis(d_ff, MODEL_AXIS)
    return {"w_gate": P(None, ax), "w_up": P(None, ax), "w_down": P(ax, None)}


def ffn(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = _act(act)(torch.einsum("bsd,df->bsf", x, params["w_gate"]))
    u = torch.einsum("bsd,df->bsf", x, params["w_up"])
    return torch.einsum("bsf,fd->bsd", g * u, params["w_down"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_spec(cfg) -> Params:
    """The router in f32, experts ``[E, d, f]``, and the shared experts as
    one dense FFN of width ``f * n_shared``."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    dtype = getattr(torch, cfg.dtype)
    p = {
        "router": dense_leaf((d, E), torch.float32),
        "w_gate": dense_leaf((E, d, f), dtype),
        "w_up": dense_leaf((E, d, f), dtype),
        "w_down": dense_leaf((E, f, d), dtype),
    }
    if m.n_shared:
        p["shared"] = ffn_spec(d, f * m.n_shared, dtype)
    return p


def moe_specs(cfg) -> Params:
    m = cfg.moe
    e_ax = maybe_axis(m.n_experts, MODEL_AXIS)
    f_ax = maybe_axis(m.d_ff_expert, MODEL_AXIS) if e_ax is None else None
    p = {
        "router": P(None, None),
        "w_gate": P(e_ax, None, f_ax),
        "w_up": P(e_ax, None, f_ax),
        "w_down": P(e_ax, f_ax, None),
    }
    if m.n_shared:
        p["shared"] = ffn_specs(m.d_ff_expert * m.n_shared)
    return p


MOE_GROUP = 1024          # tokens per dispatch group (GShard-style grouping)
MOE_DENSE_T = 256         # below this token count, run the dropless path


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``'s order: values descending, the lower index first
    on a tie (a stable sort; ``torch.topk`` promises no order on ties)."""
    p, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return p[..., :k], e[..., :k]


def moe_router(params: Params, cfg, xt: torch.Tensor):
    """Router probabilities ``[..., E]`` (f32 products: TF32 must be off on
    the card), the top-k gates renormalised to sum to 1, and the top-k
    experts ``[..., k]``."""
    logits = torch.matmul(xt.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, cfg.moe.top_k)
    return probs, top_p / top_p.sum(-1, keepdim=True), top_e


def moe_capacity(cfg, tg: int) -> int:
    m = cfg.moe
    return max(1, int(m.capacity_factor * tg * m.top_k / m.n_experts))


def capacity_positions(top_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """``top_e [G, tg, k]`` -> each choice's position in its expert's buffer
    of its group: the count of earlier choices of that expert in the
    token-major, k-minor order (an exclusive cumsum)."""
    G, tg, k = top_e.shape
    flat = top_e.reshape(G, tg * k)
    onehot = F.one_hot(flat, n_experts)
    pos = (onehot.cumsum(1) - onehot).gather(2, flat[..., None])[..., 0]
    return pos.reshape(G, tg, k)


def _experts(params: Params, xe: torch.Tensor, act: str) -> torch.Tensor:
    """Every expert's gated FFN on its own rows: ``xe [E, n, d]`` ->
    ``[E, n, d]``, batched products over the contiguous ``[E, d, f]``
    weights (no copy of them)."""
    g = _act(act)(torch.matmul(xe, params["w_gate"]))
    u = torch.matmul(xe, params["w_up"])
    return torch.matmul(g * u, params["w_down"])


def _moe_dense_small(params: Params, cfg, xt: torch.Tensor, act: str,
                     with_aux: bool):
    """Dropless path for small token counts (decode steps, tiny batches):
    every expert processes every token, the gates zero the ones not
    chosen.  At decode a batch of tokens touches about every expert, so
    the step is bound by reading the expert weights either way."""
    m = cfg.moe
    probs, top_p, top_e = moe_router(params, cfg, xt)
    gates = torch.zeros_like(probs).scatter(1, top_e, top_p)    # [T,E]
    ye = _experts(params, xt.expand(m.n_experts, *xt.shape), act)  # [E,T,d]
    y = torch.einsum("etd,te->td", ye, gates.to(ye.dtype))
    return y, (_aux_loss(probs, top_e, m.n_experts) if with_aux else 0.0)


def moe_ffn(params: Params, cfg, x: torch.Tensor, act: str = "silu", *,
            with_aux: bool = True):
    """Grouped, gather-based top-k dispatch.  Returns (y [B,S,d], the
    load-balance loss: 0.0 without ``with_aux``, as ``decode_step`` runs
    it).

    Tokens are split into groups of ``MOE_GROUP``; within a group each
    expert takes at most ``moe_capacity`` choices, in token-major,
    k-minor order, and the choices past it are dropped.  The slot ->
    token map is a scatter-max (dropped choices point at slot (0, 0) with
    token 0, which the max leaves alone), so the drop set is the JAX
    package's.  The gather, the experts' products and the combine weight
    by the kept gates."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    if T <= MOE_DENSE_T:
        y, aux = _moe_dense_small(params, cfg, xt, act, with_aux)
    else:
        tg = min(MOE_GROUP, T)
        if T % tg:
            raise ValueError(f"{T} tokens do not split into groups of {tg}")
        G, E, k = T // tg, m.n_experts, m.top_k
        cap = moe_capacity(cfg, tg)
        xg = xt.reshape(G, tg, d)
        probs, top_p, top_e = moe_router(params, cfg, xg)     # [G,tg,.]
        pos = capacity_positions(top_e, E)                     # [G,tg,k]
        keep = pos < cap
        flat_keep = keep.reshape(G, tg * k)
        slot = torch.where(flat_keep, (top_e * cap + pos).reshape(G, -1), 0)
        tok = torch.arange(tg * k, device=x.device) // k
        slot_tok = torch.zeros((G, E * cap), dtype=torch.int64,
                               device=x.device).scatter_reduce_(
            1, slot, torch.where(flat_keep, tok, 0), "amax")
        valid = torch.zeros((G, E * cap), dtype=torch.int64,
                            device=x.device).scatter_reduce_(
            1, slot, flat_keep.long(), "amax")
        xe = torch.gather(xg, 1, slot_tok[..., None].expand(G, E * cap, d))
        xe = xe * valid[..., None].to(xe.dtype)                # [G,E*C,d]
        ye = _experts(params, xe.reshape(G, E, cap, d).transpose(0, 1)
                      .reshape(E, G * cap, d), act)
        ye = ye.reshape(E, G, cap, d).transpose(0, 1)          # [G,E,C,d]
        gate = torch.where(keep, top_p, 0.0)
        g_idx = torch.arange(G, device=x.device)[:, None, None]
        back = ye[g_idx, top_e, pos.clamp(0, cap - 1)]         # [G,tg,k,d]
        y = torch.einsum("gtkd,gtk->gtd", back,
                         gate.to(back.dtype)).reshape(T, d)
        aux = (_aux_loss(probs.reshape(T, E), top_e.reshape(T, k), E)
               if with_aux else 0.0)
    if m.n_shared:
        y = y + ffn(params["shared"], xt[None], act)[0]
    return y.reshape(B, S, d), aux


def _aux_loss(probs: torch.Tensor, top_e: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    me = probs.mean(0)
    ce = F.one_hot(top_e[:, 0], n_experts).float().mean(0)
    return n_experts * (me * ce).sum()
