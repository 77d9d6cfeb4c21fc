"""Core LM building blocks: RMSNorm, RoPE, embeddings and attention (GQA,
sliding window, logit softcap; blockwise or through the flash kernel) —
the port of ``repro.models.layers``.

Conventions, as in the JAX package:

* params are nested dicts of tensors;
* activations are ``[B, S, d]``; q/k/v ``[B, S, heads, hd]``;
* KV caches are stacked over layers: ``[L, B, S, n_kv, head_dim]``.

Rounding follows the JAX package where it matters: the score einsums of
the blockwise and decode routes produce the model dtype and are then cast
to f32; RoPE and RMSNorm compute in f32; the unembed multiplies f32 casts
(TF32 kept off).

Two kinds of tree per module.  The singular ``*_spec`` functions
(``rmsnorm_spec``, ``attention_spec``, ...) give the init tree of
:class:`Leaf` that ``draw`` fills; the plural ``*_specs`` functions
(``rmsnorm_specs``, ``attention_specs``, ...) give the partition specs,
trees of :class:`P` of the same structure, copied from the JAX package:
``DP_AXES = ("pod", "data")`` shards batch, ``MODEL_AXIS = "model"``
heads, ffn hidden, experts and vocab, and a dim that the mesh axis does
not divide is replicated (``maybe_axis``).  The port has no SPMD
partitioner: the specs drive the dry run's per-device bytes, its
collective term (``roofline/collectives.py``) and the placement plan
(``core/streaming.py``), and ``constrain`` is a no-op.
A mesh entered with ``with mesh:`` (``launch/mesh.py``) is the active
one of its thread and sets the axis sizes while it is entered;
``_current_physical_mesh`` returns it where it has more than one slot,
and the flash call's mesh rule and the expert-parallel MoE
(``models/ffn.py``) read it, as in the JAX package.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

Params = Dict[str, Any]

DP_AXES = ("pod", "data")
MODEL_AXIS = "model"

# ---------------------------------------------------------------------------
# kernel mode: route prefill attention through the flash kernel.  The JAX
# package defaults to off and turns it on per run (``--kernels on``); the
# port defaults to on, since running the kernel is what the port is for.
# Where the routing rule does not hold, ``blockwise_attention`` runs, as
# in the JAX package.
# ---------------------------------------------------------------------------

_KERNEL_MODE = {"enabled": True}


def set_kernel_mode(enabled: bool) -> None:
    _KERNEL_MODE["enabled"] = enabled


def kernel_mode_enabled() -> bool:
    return _KERNEL_MODE["enabled"]


# ---------------------------------------------------------------------------
# sharding helpers (copies of the JAX package's)
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec: one entry per tensor dim, a mesh axis name, a
    tuple of names, or None (replicated) — the counterpart of
    ``jax.sharding.PartitionSpec``, compared as a tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


_MESH_AXIS_SIZES: Dict[str, int] = {}


def set_mesh_axis_sizes(sizes: Dict[str, int]) -> None:
    """Record the active mesh axis sizes so spec builders can check
    divisibility.  Called by the launcher before building specs."""
    _MESH_AXIS_SIZES.clear()
    _MESH_AXIS_SIZES.update(sizes)


# the meshes entered with ``with mesh:`` (``launch/mesh.py``), innermost
# last, each beside the axis sizes it replaced: the counterpart of JAX's
# thread-local physical mesh
_ACTIVE_MESHES = threading.local()


def _mesh_stack() -> list:
    stack = getattr(_ACTIVE_MESHES, "stack", None)
    if stack is None:
        stack = _ACTIVE_MESHES.stack = []
    return stack


def enter_mesh(mesh) -> None:
    """Make ``mesh`` the active mesh of this thread and record its axis
    sizes; ``exit_mesh`` restores the previous mesh and sizes."""
    _mesh_stack().append((mesh, dict(_MESH_AXIS_SIZES)))
    set_mesh_axis_sizes(dict(zip(mesh.axis_names, mesh.devices.shape)))


def exit_mesh(mesh) -> None:
    stack = _mesh_stack()
    if not stack or stack[-1][0] is not mesh:
        raise RuntimeError("meshes must be left in the reverse order they "
                           "were entered")
    _, sizes = stack.pop()
    set_mesh_axis_sizes(sizes)


def _current_physical_mesh():
    """The innermost entered mesh where it has more than one slot, else
    None (one slot is no physical mesh), as the JAX package's."""
    stack = _mesh_stack()
    if not stack:
        return None
    mesh = stack[-1][0]
    return mesh if mesh.devices.size > 1 else None


def axis_size(name) -> int:
    if isinstance(name, (tuple, list)):
        return math.prod(axis_size(n) for n in name)
    return _MESH_AXIS_SIZES.get(name, 1)


def maybe_axis(dim: int, name):
    """Return the mesh axis name if ``dim`` is divisible by its size (so the
    tensor dim can be sharded), else None (replicate)."""
    s = axis_size(name)
    return name if (s > 1 and dim % s == 0) else None


def dp_spec(batch: int):
    """Batch sharding over the data-parallel axes present in the active
    mesh (("pod","data"), ("data",) or none), with divisibility fallback.
    ``batch == 0`` means 'unknown, assume divisible' (spec builders)."""
    present = tuple(a for a in DP_AXES if a in _MESH_AXIS_SIZES)
    if not present:
        return None
    full = axis_size(present)
    if full > 1 and (batch == 0 or batch % full == 0):
        return present if len(present) > 1 else present[-1]
    if "data" in present and axis_size("data") > 1 and \
            (batch == 0 or batch % axis_size("data") == 0):
        return "data"
    return None


def constrain(x, spec: P):
    """The JAX package's ``with_sharding_constraint``: a no-op here, since
    the port has no SPMD partitioner to hand the constraint to (the dry
    run's collectives follow the weights' and the cache's specs:
    ``roofline/collectives.py``)."""
    return x


def spec_shard_count(spec: Optional[P]) -> int:
    """How many shards a tensor with ``spec`` is cut into on the active
    mesh (the product of the sizes of the axes it names)."""
    n = 1
    for ax in spec or ():
        if ax is not None:
            n *= axis_size(ax)
    return n


# ---------------------------------------------------------------------------
# initializers: a module's params are first a tree of ``Leaf`` (shape,
# dtype, the normal's std), then drawn, so that a stack of layers can be
# allocated once and each layer drawn straight into its slice
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Leaf:
    """One parameter: drawn as a normal times ``std`` (in f32, then cast),
    or zeros where ``std`` is 0 (no draw), or by ``fill``: ``fill(gen,
    shape, device)`` gives its f32 values (the SSM blocks' structured
    init, ``models/ssm.py``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    std: float = 0.0
    fill: Optional[Callable[..., torch.Tensor]] = None


def dense_leaf(shape, dtype, scale: Optional[float] = None) -> Leaf:
    """A normal times ``1/sqrt(fan_in)`` (or ``scale``), as the JAX
    package's ``_dense_init`` draws it (other numbers: a torch.Generator)."""
    fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[:-1])
    if len(shape) >= 3:                    # [d, H, hd] style
        fan_in = shape[0]
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return Leaf(tuple(shape), dtype, std)


def map_leaves(fn, tree):
    """``fn`` on every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order and ``keystr``'s spelling.  A ``P`` is a leaf, as is anything
    that is not a dict, list or tuple."""
    if isinstance(tree, P):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in flatten_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def map_with_paths(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; the same
    containers, in their own key order."""
    if isinstance(tree, P):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_paths(fn, v, f"{prefix}[{i}]")
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(prefix, tree)


def draw(gen: torch.Generator, spec, device, out=None):
    """A tree of ``Leaf`` -> the same tree of tensors on ``device`` (``gen``
    must live there too), leaves drawn in the tree's order.  With ``out``
    (a tree of tensors of the same shapes) each leaf is written into its
    tensor in place; a leaf's f32 draw is the only transient."""
    if isinstance(spec, dict):
        return {k: draw(gen, s, device, None if out is None else out[k])
                for k, s in spec.items()}
    if out is None:
        out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    if spec.fill is not None:
        out.copy_(spec.fill(gen, spec.shape, device))
    elif spec.std:
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        out.copy_(x.mul_(spec.std))
    else:
        out.zero_()
    return out


def draw_stacked(gen: torch.Generator, spec, n: int, device):
    """``n`` draws of ``spec`` stacked on a leading axis, equal bit for bit
    to ``torch.stack`` of ``n`` separate draws: each stacked leaf is
    allocated once and each layer drawn straight into its slice, in the
    same order, so the peak is the stack plus one leaf's f32 draw."""
    stack = map_leaves(lambda leaf: torch.empty(
        (n,) + leaf.shape, dtype=leaf.dtype, device=device), spec)
    for i in range(n):
        draw(gen, spec, device, out=map_leaves(lambda t: t[i], stack))
    return stack


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> Params:
    return {"scale": Leaf((d,), torch.float32)}


def rmsnorm_specs() -> Params:
    return {"scale": P(None)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].float())).to(dtype)


# ---------------------------------------------------------------------------
# RoPE (rotate halves, not interleaved pairs; angles in f32)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    angles = positions[..., :, None].float() * freqs          # [..., S, hd/2]
    angles = angles[..., None, :]                            # [..., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def pad_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def embedding_spec(vocab: int, d: int, dtype) -> Params:
    return {"table": dense_leaf((pad_vocab(vocab), d), dtype,
                                scale=d ** -0.5)}


def embedding_specs(vocab: int) -> Params:
    return {"table": P(maybe_axis(pad_vocab(vocab), MODEL_AXIS), None)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: Params, x: torch.Tensor, softcap: float = 0.0):
    """f32 logits over the padded vocab, from f32 casts of both operands.
    The reference multiplies in full f32: on the card that needs TF32 off
    (PyTorch's default; ``ServingEngine`` sets it when it starts)."""
    logits = torch.matmul(x.float(), params["table"].float().t())
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


# ---------------------------------------------------------------------------
# Attention (GQA, sliding window, logit softcap)
# ---------------------------------------------------------------------------


def attention_spec(cfg) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dtype = getattr(torch, cfg.dtype)
    p = {
        "wq": dense_leaf((d, cfg.n_heads, hd), dtype),
        "wk": dense_leaf((d, cfg.n_kv_heads, hd), dtype),
        "wv": dense_leaf((d, cfg.n_kv_heads, hd), dtype),
        "wo": dense_leaf((cfg.n_heads, hd, d), dtype),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = Leaf((heads, hd), dtype)
    return p


def attention_specs(cfg) -> Params:
    h_ax = maybe_axis(cfg.n_heads, MODEL_AXIS)
    kv_ax = maybe_axis(cfg.n_kv_heads, MODEL_AXIS)
    p = {
        "wq": P(None, h_ax, None),
        "wk": P(None, kv_ax, None),
        "wv": P(None, kv_ax, None),
        "wo": P(h_ax, None, None),
    }
    if cfg.qkv_bias:
        p["bq"] = P(h_ax, None)
        p["bk"] = P(kv_ax, None)
        p["bv"] = P(kv_ax, None)
    return p


def _qkv(params, cfg, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa_block(q, k, v, mask, scale, softcap):
    """One (q-block, kv-block) tile with running softmax stats.

    q: [B,Sq,H,hd]  k/v: [B,Sk,H,hd] (kv already repeated to H)
    Returns (unnormalized out f32, rowmax, rowsum)."""
    scores = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask, scores, -1e30)
    m = scores.amax(-1)                                        # [B,H,Sq]
    e = torch.exp(scores - m[..., None])
    e = torch.where(mask, e, 0.0)
    s = e.sum(-1)
    out = torch.einsum("bhqs,bshk->bqhk", e.to(v.dtype), v)
    return out.float(), m, s


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def blockwise_attention(q, k, v, *, causal: bool, window=None,
                        softcap: float = 0.0, q_block: int = 1024,
                        kv_block: int = 1024) -> torch.Tensor:
    """Memory-efficient attention: double loop over (q-block, kv-block)
    with online softmax — the JAX package's route where the flash kernel
    does not run.

    q: [B,Sq,H,hd], k/v: [B,Sk,KV,hd].  ``window``: None = full causal;
    otherwise a sliding-window size (an int or a 0-d tensor)."""
    B, Sq, H, hd = q.shape
    hd_v = v.shape[-1]
    Sk = k.shape[1]
    n_rep = H // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(hd)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    if Sq % q_block or Sk % kv_block:
        raise ValueError(f"S ({Sq}, {Sk}) not a multiple of the blocks "
                         f"({q_block}, {kv_block})")
    dev = q.device
    outs = []
    for q0 in range(0, Sq, q_block):
        qs = q[:, q0:q0 + q_block]
        q_pos = q0 + torch.arange(q_block, device=dev)
        acc = torch.zeros((B, q_block, H, hd_v), dtype=torch.float32,
                          device=dev)
        m_run = torch.full((B, H, q_block), -math.inf, device=dev)
        s_run = torch.zeros((B, H, q_block), device=dev)
        for k0 in range(0, Sk, kv_block):
            k_pos = k0 + torch.arange(kv_block, device=dev)
            mask = torch.ones((q_block, kv_block), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            out, m, s = _sdpa_block(qs, k[:, k0:k0 + kv_block],
                                    v[:, k0:k0 + kv_block], mask[None, None],
                                    scale, softcap)
            m_new = torch.maximum(m_run, m)
            alpha = torch.exp(m_run - m_new)
            beta = torch.exp(m - m_new)
            acc = acc * alpha.transpose(1, 2)[..., None] + \
                out * beta.transpose(1, 2)[..., None]
            s_run = s_run * alpha + s * beta
            m_run = m_new
        denom = s_run.clamp_min(1e-30).transpose(1, 2)[..., None]
        outs.append((acc / denom).to(q.dtype))
    return torch.cat(outs, dim=1)


def attention_forward(params: Params, cfg, x, positions, *, window=None,
                      kv_cache: Optional[Tuple] = None,
                      cache_index: Optional[int] = None,
                      ring: bool = False, causal: bool = True):
    """Full attention sublayer.  Returns (out, new_kv).

    prefill: kv_cache None -> self-attend over x; new_kv = (k, v).
    decode: kv_cache = (k_cache, v_cache) [B,S_c,kv,hd]; x is [B,1,d];
    the new token's K/V are written into the caches IN PLACE at
    ``cache_index`` (mod S_c when ``ring``), where the JAX package
    returns updated copies; new_kv is the same two tensors.
    ``window``: None = full causal, else sliding-window size."""
    q, k, v = _qkv(params, cfg, x, positions)
    if kv_cache is None:
        S = q.shape[1]
        use_kernel = (_KERNEL_MODE["enabled"]
                      and (window is None or isinstance(window, int))
                      and q.shape[-1] == v.shape[-1]
                      and S % min(128, S) == 0)
        out = None
        if use_kernel:
            out = _flash_call(q, k, v, causal=causal,
                              window=int(window or 0),
                              softcap=cfg.attn_logit_softcap)
        if out is None:
            out = blockwise_attention(q, k, v, causal=causal, window=window,
                                      softcap=cfg.attn_logit_softcap)
        new_kv = (k, v)
    else:
        kc, vc = kv_cache
        S = kc.shape[1]
        slot = cache_index % S if ring else cache_index
        kc[:, slot] = k[:, 0].to(kc.dtype)
        vc[:, slot] = v[:, 0].to(vc.dtype)
        n_rep = cfg.n_heads // cfg.n_kv_heads
        KV = cfg.n_kv_heads
        B, hd = q.shape[0], q.shape[-1]
        scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
        # grouped-query form: q's head groups against the unrepeated cache
        qg = q.reshape(B, 1, KV, n_rep, hd)
        scores = torch.einsum("bqgrd,bsgd->bgrqs", qg, kc).float() * scale
        if cfg.attn_logit_softcap:
            scores = torch.tanh(scores / cfg.attn_logit_softcap) * \
                cfg.attn_logit_softcap
        kpos = torch.arange(S, device=q.device)
        if ring:
            # entry j holds absolute position pos - ((slot - j) mod S)
            age = (slot - kpos) % S
            valid = (cache_index - age) >= 0
        else:
            valid = kpos <= cache_index
            if window is not None:
                valid &= kpos > cache_index - window
        scores = torch.where(valid, scores, -1e30)
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bgrqs,bsgd->bqgrd", w.to(vc.dtype), vc)
        out = out.reshape(B, 1, cfg.n_heads, hd)
        new_kv = (kc, vc)
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), params["wo"])
    return y, new_kv


def _flash_call(q, k, v, *, causal: bool, window: int, softcap: float):
    """Route through the flash kernel.  Where autograd records (grad
    enabled and an input requires it) the differentiable wrapper runs:
    K9 forward, K10/K11 backward, as the JAX package's
    ``flash_attention_vjp``; otherwise the forward alone.  On CPU tensors
    the plain versions run at the JAX call's blocks, ``min(128, S)``.

    The JAX package's mesh rule: under an active mesh that shards the
    batch (``dp_spec`` of it is not None) the kernel's region shards the
    heads over ``model``, so where the query or the KV heads do not
    divide that axis this returns None and the caller takes the
    blockwise path.  Otherwise the kernel runs on the whole batch: one
    process needs no split by heads or batch, and each head's output is
    the same either way."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_vjp)
    if _current_physical_mesh() is not None and \
            dp_spec(q.shape[0]) is not None and \
            (maybe_axis(q.shape[2], MODEL_AXIS) is None
             or maybe_axis(k.shape[2], MODEL_AXIS) is None):
        return None
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attention_vjp.apply(q, k, v, causal, window, softcap)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_attention_kv(params: Params, cfg, memory):
    """Project the encoder output once; the (k, v) pair is cached for the
    whole decode.  memory: [B,Sm,d] -> k, v [B,Sm,KV,hd]."""
    k = torch.einsum("bsd,dhk->bshk", memory, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", memory, params["wv"])
    if cfg.qkv_bias:
        k = k + params["bk"]
        v = v + params["bv"]
    return k, v


def cross_attention_forward(params: Params, cfg, x, kv):
    """Non-causal attention of decoder states x [B,S,d] over the cached
    encoder K/V (no RoPE), as plain einsums with f32 scores."""
    k, v = kv
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if cfg.qkv_bias:
        q = q + params["bq"]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    kr, vr = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    scores = torch.einsum("bqhk,bshk->bhqs", q, kr).float() * scale
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshk->bqhk", w.to(vr.dtype), vr)
    return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), params["wo"])
