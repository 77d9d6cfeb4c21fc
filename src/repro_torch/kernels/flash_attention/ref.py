"""Plain PyTorch versions of the flash-attention forward (K9).

``flash_attention_ref``    the O(S^2) oracle: one materialised softmax
``flash_attention_plain``  the plain version of the kernel: a loop over
                           (q-block, k-block) that follows the JAX kernel
                           ``_flash_kernel`` step by step

Layout: q ``[B,H,Sq,hd]``; k ``[B,KV,Sk,hd]``; v ``[B,KV,Sk,hd_v]``.
Query head ``h`` reads KV head ``h // (H // KV)``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def _mask(q_pos, k_pos, causal: bool, window: int):
    mask = torch.ones((q_pos.numel(), k_pos.numel()), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    return mask


def _repeat_heads(k: torch.Tensor, H: int) -> torch.Tensor:
    rep = H // k.shape[1]
    return k if rep == 1 else k.repeat_interleave(rep, dim=1)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Direct softmax attention in f32, O(S^2) memory: oracle only.
    Returns ``[B,H,Sq,hd_v]`` in q's dtype."""
    H, Sq, hd = q.shape[1], q.shape[2], q.shape[3]
    Sk = k.shape[2]
    k = _repeat_heads(k, H).float()
    v = _repeat_heads(v, H).float()
    s = torch.matmul(q.float(), k.transpose(-1, -2)) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    dev = q.device
    mask = _mask(torch.arange(Sq, device=dev), torch.arange(Sk, device=dev),
                 causal, window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    out = torch.matmul(p / p.sum(-1, keepdim=True).clamp_min(1e-30), v)
    return out.to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, bq: int = 128, bk: int = 128
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic, block by block: scores in f32 straight from
    the operands, running max ``m`` and sum ``l`` in f32, ``p`` rounded to
    v's dtype before the PV product, masked scores at -1e30 with their
    ``p`` zeroed, the denominator clamped at 1e-30.  Returns
    ``(o [B,H,Sq,hd_v] in q's dtype, lse [B,H,Sq] f32)``."""
    B, H, Sq, hd = q.shape
    Sk, hd_v = k.shape[2], v.shape[3]
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads do not share {k.shape[1]} KV "
                         f"heads evenly")
    bq, bk = min(bq, Sq), min(bk, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"S ({Sq}, {Sk}) not a multiple of the blocks "
                         f"({bq}, {bk})")
    scale = 1.0 / math.sqrt(hd)
    k = _repeat_heads(k, H)
    v = _repeat_heads(v, H)
    dev = q.device
    o = torch.empty((B, H, Sq, hd_v), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, bq):
        qb = q[:, :, q0:q0 + bq].float()
        q_pos = torch.arange(q0, q0 + bq, device=dev)
        acc = torch.zeros((B, H, bq, hd_v), dtype=torch.float32, device=dev)
        m = torch.full((B, H, bq, 1), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, bq, 1), dtype=torch.float32, device=dev)
        for k0 in range(0, Sk, bk):
            kb = k[:, :, k0:k0 + bk]
            vb = v[:, :, k0:k0 + bk]
            s = torch.matmul(qb, kb.float().transpose(-1, -2)) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            mask = _mask(q_pos, torch.arange(k0, k0 + bk, device=dev),
                         causal, window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(v.dtype).float(),
                                             vb.float())
            m = m_new
        denom = l.clamp_min(1e-30)
        o[:, :, q0:q0 + bq] = (acc / denom).to(q.dtype)
        lse[:, :, q0:q0 + bq] = (m + torch.log(denom))[..., 0]
    return o, lse
