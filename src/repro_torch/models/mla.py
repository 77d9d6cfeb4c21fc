"""Multi-head Latent Attention (DeepSeek-V2) — the port of
``repro.models.mla``.

MLA compresses K/V into a low-rank latent ``c_kv`` (rank
``kv_lora_rank``) plus one RoPE key ``k_pe`` shared by every head.
Prefill decompresses K and V and runs the flash kernel with split head
dims (qk ``nope + rope``, v ``v_head_dim``) where the JAX package's rule
holds, else the blockwise attention.  Decode uses the absorbed form
(``W_UK`` folded into the query, ``W_UV`` into the output), so a step
reads only the latent cache ``[S, kv_lora_rank + rope]``.  ``mla_spec``
gives the init tree of ``Leaf``, ``mla_specs`` the partition specs (a
copy of the JAX package's).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers
from repro_torch.models.layers import (MODEL_AXIS, P, apply_rope,
                                       blockwise_attention, dense_leaf,
                                       maybe_axis, rmsnorm, rmsnorm_spec,
                                       rmsnorm_specs)

Params = Dict[str, Any]


def mla_spec(cfg) -> Params:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dtype = getattr(torch, cfg.dtype)
    return {
        "wq_a": dense_leaf((d, m.q_lora_rank), dtype),
        "q_norm": rmsnorm_spec(m.q_lora_rank),
        "wq_b": dense_leaf((m.q_lora_rank, H,
                            m.qk_nope_head_dim + m.qk_rope_head_dim), dtype),
        "wkv_a": dense_leaf((d, m.kv_lora_rank + m.qk_rope_head_dim), dtype),
        "kv_norm": rmsnorm_spec(m.kv_lora_rank),
        "wk_b": dense_leaf((m.kv_lora_rank, H, m.qk_nope_head_dim), dtype),
        "wv_b": dense_leaf((m.kv_lora_rank, H, m.v_head_dim), dtype),
        "wo": dense_leaf((H, m.v_head_dim, d), dtype),
    }


def mla_specs(cfg) -> Params:
    """The partition specs (``mla_spec`` is the init tree)."""
    h_ax = maybe_axis(cfg.n_heads, MODEL_AXIS)
    return {
        "wq_a": P(None, None),
        "q_norm": rmsnorm_specs(),
        "wq_b": P(None, h_ax, None),
        "wkv_a": P(None, None),
        "kv_norm": rmsnorm_specs(),
        "wk_b": P(None, h_ax, None),
        "wv_b": P(None, h_ax, None),
        "wo": P(h_ax, None, None),
    }


def _project_q(params, cfg, x, positions):
    m = cfg.mla
    q_lat = torch.einsum("bsd,dr->bsr", x, params["wq_a"])
    q_lat = rmsnorm(params["q_norm"], q_lat, cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", q_lat, params["wq_b"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_pe = apply_rope(q[..., m.qk_nope_head_dim:], positions, cfg.rope_theta)
    return q_nope, q_pe


def _project_kv_latent(params, cfg, x, positions):
    m = cfg.mla
    kv = torch.einsum("bsd,dr->bsr", x, params["wkv_a"])
    c_kv = rmsnorm(params["kv_norm"], kv[..., :m.kv_lora_rank], cfg.norm_eps)
    k_pe = apply_rope(kv[..., None, m.kv_lora_rank:], positions,
                      cfg.rope_theta)
    return c_kv, k_pe[:, :, 0]


def mla_forward(params: Params, cfg, x, positions, *,
                kv_cache: Optional[Tuple] = None,
                cache_index: Optional[int] = None):
    """Returns (out, new_cache).  Prefill (``kv_cache`` None): new_cache =
    (c_kv [B,S,r], k_pe [B,S,rope]).  Decode: ``kv_cache`` = the latent
    caches (c [B,S_c,r], pe [B,S_c,rope]); x is [B,1,d]; the new token's
    latents are written into them IN PLACE at ``cache_index``, where the
    JAX package returns updated copies."""
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_pe = _project_q(params, cfg, x, positions)
    c_new, kpe_new = _project_kv_latent(params, cfg, x, positions)

    if kv_cache is None:
        k_nope = torch.einsum("bsr,rhk->bshk", c_new, params["wk_b"])
        v = torch.einsum("bsr,rhk->bshk", c_new, params["wv_b"])
        # k_pe copied to every head by cat (contiguous: the kernel reads
        # the head dim contiguous, never a broadcast view)
        k = torch.cat([k_nope, kpe_new[:, :, None].expand(
            *k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        S = q.shape[1]
        out = None
        if layers.kernel_mode_enabled() and S % min(128, S) == 0:
            # the flash kernel with split head dims (qk 192 / v 128 at
            # full width); None under a mesh whose model axis the heads
            # do not divide
            out = layers._flash_call(q, k, v, causal=True, window=0,
                                     softcap=0.0)
        if out is None:
            out = blockwise_attention(q, k, v, causal=True)
        new_cache = (c_new, kpe_new)
    else:
        cc, pc = kv_cache
        cc[:, cache_index] = c_new[:, 0].to(cc.dtype)
        pc[:, cache_index] = kpe_new[:, 0].to(pc.dtype)
        # absorbed decode: q_abs[b,1,h,r] = q_nope . W_UK
        q_abs = torch.einsum("bqhk,rhk->bqhr", q_nope, params["wk_b"])
        scores = (torch.einsum("bqhr,bsr->bhqs", q_abs, cc)
                  + torch.einsum("bqhk,bsk->bhqs", q_pe, pc)).float()
        scores = scores * scale
        valid = torch.arange(cc.shape[1], device=x.device) <= cache_index
        scores = torch.where(valid, scores, -1e30)
        w = torch.softmax(scores, dim=-1)
        o_lat = torch.einsum("bhqs,bsr->bqhr", w.to(cc.dtype), cc)
        out = torch.einsum("bqhr,rhk->bqhk", o_lat, params["wv_b"])
        new_cache = (cc, pc)

    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), params["wo"])
    return y, new_cache
