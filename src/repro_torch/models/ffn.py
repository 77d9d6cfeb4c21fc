"""Gated FFN (SwiGLU / GeGLU) and the mixture-of-experts FFN — the port of
``repro.models.ffn``.

The MoE routes each token to its top-k experts.  At most ``MOE_DENSE_T``
tokens take the dropless path (every expert computes every token, the
gates zero the ones not chosen); more tokens take the grouped path:
groups of ``MOE_GROUP`` tokens, a capacity per expert and group, the
choices past it dropped, gathers in and out.  Under an entered mesh
whose ``model`` axis has more than one slot and divides the experts
(``_ep_available``) the grouped path's experts run expert-parallel, as
the JAX package's ``shard_map`` region does: each slot of the axis runs
its own E/n experts on the choices routed to them, and the partial
outputs are summed in slot order (``_moe_ep_shardmap``).  ``ffn_spec`` and
``moe_spec`` give the init trees of ``Leaf``; ``ffn_specs`` and
``moe_specs`` the partition specs, copies of the JAX package's.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (MODEL_AXIS, P,
                                      _current_physical_mesh, axis_size,
                                      dense_leaf, maybe_axis)

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
        gate = torch.where(keep, top_p, 0.0)
        if _ep_available(m):
            y = _moe_ep_shardmap(params, cfg, xg, top_e, pos, gate, cap,
                                 act).reshape(T, d)
        else:
            ye = _routed_experts(params, xg, top_e, pos, keep, E, cap, act)
            g_idx = torch.arange(G, device=x.device)[:, None, None]
            back = ye[g_idx, top_e, pos.clamp(0, cap - 1)]     # [G,tg,k,d]
            y = torch.einsum("gtkd,gtk->gtd", back,
                             gate.to(back.dtype)).reshape(T, d)
        aux = (_aux_loss(probs.reshape(T, E), top_e.reshape(T, k), E)
               if with_aux else 0.0)
    if m.n_shared:
        y = y + ffn(params["shared"], xt[None], act)[0]
    return y.reshape(B, S, d), aux


def _routed_experts(params: Params, xg: torch.Tensor, rel: torch.Tensor,
                 pos: torch.Tensor, mine: torch.Tensor, n_experts: int,
                 cap: int, act: str) -> torch.Tensor:
    """``n_experts`` experts (``params``' leading dim) on the choices
    ``mine`` routes to them: ``xg [G, tg, d]``, each choice's expert
    ``rel`` and buffer position ``pos`` ``[G, tg, k]`` -> the experts'
    outputs ``[G, E, C, d]``.  The slot -> token map is a scatter-max
    over zeros (a choice not ``mine`` writes token 0 to slot (0, 0),
    which a real token there wins), as the JAX package's
    ``.at[...].max``."""
    G, tg, d = xg.shape
    k = rel.shape[-1]
    flat = mine.reshape(G, tg * k)
    slot = torch.where(flat, (rel * cap + pos).reshape(G, -1), 0)
    tok = torch.arange(tg * k, device=xg.device) // k
    slot_tok = torch.zeros((G, n_experts * cap), dtype=torch.int64,
                           device=xg.device).scatter_reduce_(
        1, slot, torch.where(flat, tok, 0), "amax")
    valid = torch.zeros((G, n_experts * cap), dtype=torch.int64,
                        device=xg.device).scatter_reduce_(
        1, slot, flat.long(), "amax")
    xe = torch.gather(xg, 1, slot_tok[..., None].expand(G, n_experts * cap,
                                                        d))
    xe = xe * valid[..., None].to(xe.dtype)                    # [G,E*C,d]
    ye = _experts(params, xe.reshape(G, n_experts, cap, d).transpose(0, 1)
                  .reshape(n_experts, G * cap, d), act)
    return ye.reshape(n_experts, G, cap, d).transpose(0, 1)    # [G,E,C,d]


def _ep_available(m) -> bool:
    """The expert-parallel path: an entered mesh of more than one slot
    whose ``model`` axis has more than one slot and divides the
    experts."""
    mesh = _current_physical_mesh()
    return (mesh is not None and "model" in mesh.axis_names
            and axis_size("model") > 1
            and m.n_experts % axis_size("model") == 0)


def _moe_ep_shardmap(params: Params, cfg, xg: torch.Tensor,
                     top_e: torch.Tensor, pos: torch.Tensor,
                     gate: torch.Tensor, cap: int, act: str) -> torch.Tensor:
    """Expert parallelism, the JAX package's ``shard_map`` region as a
    loop over the ``model`` axis's slots (``mesh.axis_devices``; a
    device may repeat).  Slot ``c`` holds experts ``[c·E/n, (c+1)·E/n)``:
    it gathers the choices routed to them (the routing, positions and
    kept gates are global and computed once, outside), runs its experts
    and combines back through the clipped indices, weighted by its kept
    gates in the model dtype.  The partial ``[G, tg, d]`` outputs are
    summed in slot order on ``xg``'s device, as the region's ``psum``
    over ``model``, in f32 and rounded once to the model dtype, as the
    grouped path's combine rounds: the JAX package's ``psum`` adds the
    partials in the model dtype, which in bf16 rounds each token's
    output twice (in f32 the two agree).  One process runs every group,
    so the data axes split nothing here."""
    m = cfg.moe
    mesh = _current_physical_mesh()
    slots = mesh.axis_devices("model")
    E_local = m.n_experts // len(slots)
    G = xg.shape[0]
    y = None
    for c, dev in enumerate(slots):
        lo = c * E_local
        local = {n: params[n][lo:lo + E_local].to(dev)
                 for n in ("w_gate", "w_up", "w_down")}
        te, p_, gt = top_e.to(dev), pos.to(dev), gate.to(dev)
        rel = te - lo
        mine = (rel >= 0) & (rel < E_local) & (p_ < cap)
        ye = _routed_experts(local, xg.to(dev), rel, p_, mine, E_local, cap,
                          act)
        g_idx = torch.arange(G, device=dev)[:, None, None]
        back = ye[g_idx, rel.clamp(0, E_local - 1), p_.clamp(0, cap - 1)]
        w = (gt * mine.to(gt.dtype)).to(back.dtype)
        part = torch.einsum("gtkd,gtk->gtd", back.float(),
                            w.float()).to(xg.device)
        y = part if y is None else y + part
    return y.to(xg.dtype)


def _aux_loss(probs: torch.Tensor, top_e: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    me = probs.mean(0)
    ce = F.one_hot(top_e[:, 0], n_experts).float().mean(0)
    return n_experts * (me * ce).sum()
