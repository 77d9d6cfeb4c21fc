"""Plain PyTorch versions of the flash-attention kernels (K9, K10, K11).

``flash_attention_ref``    the O(S^2) oracle: one materialised softmax
``flash_attention_plain``  the plain version of the forward: a loop over
                           (q-block, k-block) that follows the JAX kernel
                           ``_flash_kernel`` step by step
``flash_attention_bwd_plain``  the plain version of the backward pair:
                           the JAX kernels ``_flash_bwd_dq_kernel`` and
                           ``_flash_bwd_dkv_kernel`` step by step
``split3_bf16``            the exact three-way bf16 split of f32 p and ds
                           that the tensor-core backward kernels multiply

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


def _tile_visible(q0: int, bq: int, k0: int, bk: int, causal: bool,
                  window: int) -> bool:
    """Whether the mask lets any (q, k) of the tile through, decided on
    the host: q - k takes every value in [q0 - k0 - bk + 1, q0 + bq - 1 -
    k0], and a visible pair needs it in [0 if causal, window - 1 if
    window]."""
    lo, hi = q0 - k0 - bk + 1, q0 + bq - 1 - k0
    if causal:
        lo = max(lo, 0)
    if window:
        hi = min(hi, window - 1)
    return lo <= hi


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
    ``p`` zeroed, the denominator clamped at 1e-30.  Tiles the mask hides
    entirely are skipped, as the CUDA kernel skips them (exact: there p
    is zero and the running max does not move, so m, l and acc keep
    their bits).  Returns
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
            if not _tile_visible(q0, bq, k0, bk, causal, window):
                continue
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


def split3_bf16(x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 ``x`` as three bf16 tensors ``(hi, mid, lo)`` whose f32 sum is
    ``x`` bit for bit, as ``csrc/flash_attention_bwd.cu::split3`` computes
    them: ``hi = bf16(x)``, ``mid = bf16(x - hi)``, ``lo = x - hi - mid``
    (f32 has 24 significant bits, the two residuals at most 16 and 8)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 ``a`` taken as its three bf16 parts, each part's
    product added smallest first, as the tensor-core kernels add them."""
    hi, mid, lo = split3_bf16(a)
    out = torch.matmul(lo.float(), b)
    out = out + torch.matmul(mid.float(), b)
    return out + torch.matmul(hi.float(), b)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0,
                              bq: int = 128, bk: int = 128, out_dtype=None,
                              split3: bool = False):
    """dq, dk, dv of the flash forward, block by block as the JAX backward
    kernels compute them: operands cast to f32; scores recomputed with the
    softcap derivative ``dcap = 1 - (s/softcap)^2`` taken before masking;
    ``p = exp(s - lse)`` zeroed where masked; ``ds = p (dp - delta) dcap``
    with ``delta = sum(do * o)`` in f32; per tile ``dq += (ds k) scale``,
    ``dk += (ds^T q) scale`` and ``dv += p^T do``, with p and ds kept in
    f32.  Tiles the mask hides entirely are skipped (exact: there p and ds
    are zero).

    ``split3=True`` runs the three accumulating products as the
    tensor-core kernels do: p and ``ds * scale`` split by ``split3_bf16``,
    one product per part, smallest first.

    q ``[B,H,Sq,hd]``, o and do ``[B,H,Sq,hd_v]``, lse ``[B,H,Sq]`` f32;
    k ``[B,KV,Sk,hd]`` and v ``[B,KV,Sk,hd_v]``, repeated to H heads
    here when KV < H (the JAX kernel takes them repeated).  Returns
    ``(dq [B,H,Sq,hd] in q's dtype, dk [B,H,Sk,hd] and dv [B,H,Sk,hd_v]
    per query head in k's and v's dtype)``, or all three in ``out_dtype``
    where one is given; the GQA fold is the caller's."""
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
    dev = q.device
    qf, dof = q.float(), do.float()
    kf = _repeat_heads(k, H).float()
    vf = _repeat_heads(v, H).float()
    delta = (dof * o.float()).sum(-1)
    dq = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, H, Sk, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros((B, H, Sk, hd_v), dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, bq):
        qb, dob = qf[:, :, q0:q0 + bq], dof[:, :, q0:q0 + bq]
        lse_b = lse[:, :, q0:q0 + bq, None]
        delta_b = delta[:, :, q0:q0 + bq, None]
        q_pos = torch.arange(q0, q0 + bq, device=dev)
        for k0 in range(0, Sk, bk):
            if not _tile_visible(q0, bq, k0, bk, causal, window):
                continue
            mask = _mask(q_pos, torch.arange(k0, k0 + bk, device=dev),
                         causal, window)
            kb, vb = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            dcap = None
            if softcap:
                s = torch.tanh(s / softcap) * softcap
                dcap = 1.0 - (s / softcap) ** 2
            s = torch.where(mask, s, NEG_INF)
            p = torch.where(mask, torch.exp(s - lse_b), 0.0)
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            ds = p * (dp - delta_b)
            if softcap:
                ds = ds * dcap
            if split3:
                dss = ds * scale
                dq[:, :, q0:q0 + bq] += _split_matmul(dss, kb)
                dk[:, :, k0:k0 + bk] += _split_matmul(
                    dss.transpose(-1, -2), qb)
                dv[:, :, k0:k0 + bk] += _split_matmul(p.transpose(-1, -2),
                                                      dob)
                continue
            dq[:, :, q0:q0 + bq] += torch.matmul(ds, kb) * scale
            dk[:, :, k0:k0 + bk] += torch.matmul(ds.transpose(-1, -2),
                                                 qb) * scale
            dv[:, :, k0:k0 + bk] += torch.matmul(p.transpose(-1, -2), dob)
    return (dq.to(out_dtype or q.dtype), dk.to(out_dtype or k.dtype),
            dv.to(out_dtype or v.dtype))
