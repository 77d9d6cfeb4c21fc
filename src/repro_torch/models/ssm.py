"""State-space and recurrent blocks: Mamba (Hymba's SSM heads) and the
xLSTM pair (mLSTM / sLSTM) — the port of ``repro.models.ssm``.

Plain PyTorch, with the JAX package's dtype flow: projections in the
model dtype; gates, ``dt``, the scans and the memories in f32; outputs
cast back where the JAX code casts.  The recurrences run in chunks of
``CHUNK`` positions (a sequence of at most ``CHUNK`` or a multiple of it)
with the carry threaded from chunk to chunk:

* Mamba's selective scan pairs the terms of a chunk as
  ``jax.lax.associative_scan`` does (``associative_scan`` below, the
  same recursion, so the same order of f32 operations), then adds the
  carry-in;
* mLSTM evaluates a chunk as masked quadratic attention plus a read of
  the carried matrix memory, its running max by ``torch.cummax``; it
  masks the chunk's log-weights before their exp, so its gradient stays
  finite where the JAX package's turns NaN (0 x inf past one chunk of
  forget gates);
* sLSTM is a true recurrence through ``h``: a Python loop over time, as
  the JAX package's ``lax.scan``.

The in-chunk cumulative sums are ``torch.cumsum`` (sequential), where
XLA pairs the terms as an associative scan: the two differ by f32
rounding.  Decode carries an explicit state, so a token costs
O(d_inner * d_state).

``mamba_spec``, ``mlstm_spec`` and ``slstm_spec`` give the init trees of
``Leaf``; ``mamba_specs``, ``mlstm_specs`` and ``slstm_specs`` the
partition specs (copies of the JAX package's).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (MODEL_AXIS, Leaf, P, Params,
                                       dense_leaf, maybe_axis)

CHUNK = 128


def _inner_dim(cfg) -> int:
    return int(cfg.d_model * cfg.ssm.expand)


def _dt_rank(cfg) -> int:
    return max(1, _inner_dim(cfg) // 16)


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _chunk(S: int) -> int:
    chunk = min(CHUNK, S)
    if S % chunk:
        raise ValueError(f"sequence of {S} is neither at most {CHUNK} nor a "
                         f"multiple of it")
    return chunk


def associative_scan(fn, elems: List[torch.Tensor],
                     dim: int) -> List[torch.Tensor]:
    """Inclusive scan of ``fn`` over ``dim`` of each tensor in ``elems``,
    with the pairing of ``jax.lax.associative_scan``: combine adjacent
    pairs, scan the pairs recursively, then fill in the even positions."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    reduced = fn([sl(e, 0, -1, 2) for e in elems],
                 [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn([sl(e, 0, -1) for e in odd],
                  [sl(e, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim) for e, r in zip(elems, even)]
    out = []
    for e, o in zip(even, odd):
        m = o.shape[dim]
        woven = torch.stack([sl(e, 0, m), o], dim + 1).flatten(dim, dim + 1)
        out.append(torch.cat([woven, sl(e, m)], dim) if e.shape[dim] > m
                   else woven)
    return out


# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------


def _ones(gen, shape, device) -> torch.Tensor:
    return torch.ones(shape, device=device)


def _a_log(gen, shape, device) -> torch.Tensor:
    """log(1..N) along the last axis."""
    n = shape[-1]
    return torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                  device=device)).expand(shape)


def _dt_bias(gen, shape, device) -> torch.Tensor:
    """softplus^-1 of a log-uniform draw in [1e-3, 1e-1]."""
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=device) * (hi - lo) + lo
    return torch.log(torch.expm1(torch.exp(u)))


def mamba_spec(cfg) -> Params:
    s = cfg.ssm
    d, inner, dtr = cfg.d_model, _inner_dim(cfg), _dt_rank(cfg)
    dtype = _dtype(cfg)
    return {
        "in_proj": dense_leaf((d, 2 * inner), dtype),
        "conv_w": dense_leaf((s.conv_width, inner), dtype,
                             scale=1.0 / math.sqrt(s.conv_width)),
        "conv_b": Leaf((inner,), dtype),
        # x -> (dt_rank, B, C)
        "x_proj": dense_leaf((inner, dtr + 2 * s.state_dim), dtype),
        "dt_proj": dense_leaf((dtr, inner), dtype),
        "dt_bias": Leaf((inner,), torch.float32, fill=_dt_bias),
        "A_log": Leaf((inner, s.state_dim), torch.float32, fill=_a_log),
        "D": Leaf((inner,), torch.float32, fill=_ones),
        "out_proj": dense_leaf((inner, d), dtype),
    }


def mamba_specs(cfg) -> Params:
    """The partition specs (``mamba_spec`` is the init tree)."""
    inner = _inner_dim(cfg)
    ax = maybe_axis(inner, MODEL_AXIS)
    return {
        "in_proj": P(None, ax),     # 2*inner divisible iff inner is
        "conv_w": P(None, ax),
        "conv_b": P(ax),
        "x_proj": P(ax, None),
        "dt_proj": P(None, ax),
        "dt_bias": P(ax),
        "A_log": P(ax, None),
        "D": P(ax),
        "out_proj": P(ax, None),
    }


def _causal_conv(x, w, b, state: Optional[torch.Tensor]):
    """Depthwise causal conv over time.  x: [B,S,inner]; w: [K,inner];
    state: [B,K-1,inner] trailing context (decode) or None.  Returns
    (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[:1] + (K - 1,) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # [B,S+K-1,inner]
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(K)) + b
    new_state = xp[:, xp.shape[1] - (K - 1):] if K > 1 else pad[:, :0]
    return y, new_state


def _ssm_combine(left, right):
    al, bl = left
    ar, br = right
    return [al + ar, bl * torch.exp(ar) + br]


def _ssm_scan_chunked(u, dt, Bc, Cc, A, h0):
    """u, dt: [B,S,inner]; Bc, Cc: [B,S,state]; A: [inner,state]; h0:
    [B,inner,state].  h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t;
    y_t = C_t . h_t, in f32.  Returns (y [B,S,inner], h_S)."""
    S = u.shape[1]
    chunk = _chunk(S)
    u, dt, Bc, Cc = (t.float() for t in (u, dt, Bc, Cc))
    h = h0.float()
    ys = []
    for c0 in range(0, S, chunk):
        uc, dtc = u[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        bc, cc = Bc[:, c0:c0 + chunk], Cc[:, c0:c0 + chunk]
        log_a = dtc[..., None] * A                        # [B,c,inner,state]
        cum = torch.cumsum(log_a, dim=1)
        x_t = dtc[..., None] * bc[:, :, None, :] * uc[..., None]
        _, hs = associative_scan(_ssm_combine, [log_a, x_t], 1)
        hs = hs + torch.exp(cum) * h[:, None]             # carry-in
        ys.append(torch.einsum("bcis,bcs->bci", hs, cc))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_forward(params: Params, cfg, x, *, state: Optional[Tuple] = None):
    """x: [B,S,d].  state = (conv_state [B,K-1,inner], h [B,inner,state])
    for decode, or None.  Returns (y, new_state)."""
    s = cfg.ssm
    inner, dtr = _inner_dim(cfg), _dt_rank(cfg)
    xz = torch.einsum("bsd,de->bse", x, params["in_proj"])
    xin, z = xz[..., :inner], xz[..., inner:]
    xc, new_conv = _causal_conv(xin, params["conv_w"], params["conv_b"],
                                None if state is None else state[0])
    xc = F.silu(xc)
    proj = torch.einsum("bsi,ie->bse", xc, params["x_proj"])
    dt = F.softplus(torch.einsum("bsr,ri->bsi", proj[..., :dtr],
                                 params["dt_proj"]).float()
                    + params["dt_bias"])
    Bc = proj[..., dtr:dtr + s.state_dim]
    Cc = proj[..., dtr + s.state_dim:]
    A = -torch.exp(params["A_log"])                       # [inner,state]
    h0 = (state[1] if state is not None else
          torch.zeros((x.shape[0], inner, s.state_dim), dtype=torch.float32,
                      device=x.device))
    y, hN = _ssm_scan_chunked(xc, dt, Bc, Cc, A, h0)
    y = y + xc.float() * params["D"]
    y = y.to(x.dtype) * F.silu(z)
    out = torch.einsum("bsi,id->bsd", y, params["out_proj"])
    return out, (new_conv, hN)


def init_mamba_state(cfg, batch: int, device="cuda"):
    s = cfg.ssm
    inner = _inner_dim(cfg)
    return (torch.zeros((batch, s.conv_width - 1, inner), dtype=_dtype(cfg),
                        device=device),
            torch.zeros((batch, inner, s.state_dim), dtype=torch.float32,
                        device=device))


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunked) and sLSTM (scalar memory,
# sequential)
# ---------------------------------------------------------------------------


def _mlstm_dims(cfg):
    dm = int(cfg.d_model * cfg.ssm.mlstm_proj_factor)
    return dm, dm // cfg.n_heads


def mlstm_spec(cfg) -> Params:
    d = cfg.d_model
    dm, _ = _mlstm_dims(cfg)
    dtype = _dtype(cfg)
    return {
        "up": dense_leaf((d, 2 * dm), dtype),             # x and gate path
        "wq": dense_leaf((dm, dm), dtype),
        "wk": dense_leaf((dm, dm), dtype),
        "wv": dense_leaf((dm, dm), dtype),
        "w_if": dense_leaf((dm, 2 * cfg.n_heads), dtype),  # i, f gates
        "b_if": Leaf((2 * cfg.n_heads,), torch.float32),
        "down": dense_leaf((dm, d), dtype),
    }


def mlstm_specs(cfg) -> Params:
    dm, _ = _mlstm_dims(cfg)
    ax = maybe_axis(dm, MODEL_AXIS)
    h_ax = maybe_axis(cfg.n_heads, MODEL_AXIS)
    return {
        "up": P(None, ax), "wq": P(None, ax), "wk": P(None, ax),
        "wv": P(None, ax), "w_if": P(None, h_ax), "b_if": P(h_ax),
        "down": P(ax, None),
    }


def mlstm_forward(params: Params, cfg, x, *, state=None):
    """mLSTM = gated linear attention with matrix memory C [B,H,hd,hd].

    Chunkwise: within a chunk, masked quadratic attention against the
    chunk's keys plus a read of the carried memory; the memory is updated
    once a chunk.  state = (C [B,H,hd,hd], n [B,H,hd], m [B,H]) for
    decode.  Returns (y, new_state)."""
    H = cfg.n_heads
    dm, hd = _mlstm_dims(cfg)
    Bsz, S, _ = x.shape
    ug = torch.einsum("bsd,de->bse", x, params["up"])
    u, g = ug[..., :dm], ug[..., dm:]

    def heads(w):
        return torch.einsum("bse,ef->bsf", u, params[w]).reshape(Bsz, S, H,
                                                                 hd)
    q, k, v = heads("wq"), heads("wk"), heads("wv")
    gates = torch.einsum("bse,eg->bsg", u, params["w_if"]).float() + \
        params["b_if"]
    i_g = gates[..., :H]                                  # log-space input
    f_g = F.logsigmoid(gates[..., H:])                    # log forget
    q = q.float() / math.sqrt(hd)
    k = k.float() / math.sqrt(hd)
    v = v.float()
    chunk = _chunk(S)
    if state is None:
        C, n, m = init_mlstm_state(cfg, Bsz, x.device)
    else:
        C, n, m = state
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    ys = []
    for c0 in range(0, S, chunk):
        qc, kc, vc = (t[:, c0:c0 + chunk] for t in (q, k, v))
        ic, fc = i_g[:, c0:c0 + chunk], f_g[:, c0:c0 + chunk]
        Fc = torch.cumsum(fc, dim=1)                      # [B,c,H]
        # stabiliser m_t = max(F_t + m_in, max_{s<=t} (F_t - F_s + i_s))
        lse_in = Fc + m[:, None]
        run_max = torch.cummax(ic - Fc, dim=1).values
        m_t = torch.maximum(lse_in, Fc + run_max)
        # intra-chunk: D[t,s] = F_t - F_s + i_s  (s <= t)
        D = Fc[:, :, None] - Fc[:, None, :] + ic[:, None, :, :]  # [B,t,s,H]
        # masked before the exp, where the JAX package masks after it:
        # above the diagonal D - m_t sums up to a chunk of -log(forget)
        # and overflows, and the gradient of its where, 0 x inf, is NaN.
        # The same W bit for bit; the gradient finite
        W = torch.exp(torch.where(mask, D - m_t[:, :, None], -math.inf))
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * W
        y_intra = torch.einsum("btsh,bshd->bthd", scores, vc)
        n_intra = torch.einsum("btsh,bshd->bthd", scores, kc)
        # inter-chunk: read the carried memory
        decay = torch.exp(lse_in - m_t)                   # [B,c,H]
        y_inter = torch.einsum("bthd,bhde->bthe", qc, C) * decay[..., None]
        n_inter = torch.einsum("bthd,bhd->bth", qc, n) * decay
        num = y_intra + y_inter
        den = torch.abs(torch.einsum("bthd,bthd->bth", qc, n_intra)
                        + n_inter)
        ys.append(num / torch.maximum(den, torch.exp(-m_t))[..., None])
        # the memory at the end of the chunk
        m_new = m_t[:, -1]                                # [B,H]
        Ftot = Fc[:, -1]
        w_upd = torch.exp(ic + (Ftot[:, None] - Fc) - m_new[:, None])
        carry = torch.exp(Ftot + m - m_new)
        C = C * carry[..., None, None] + \
            torch.einsum("bsh,bshd,bshe->bhde", w_upd, kc, vc)
        n = n * carry[..., None] + torch.einsum("bsh,bshd->bhd", w_upd, kc)
        m = m_new
    y = torch.cat(ys, dim=1).reshape(Bsz, S, dm)
    y = y.to(x.dtype) * F.silu(g)
    out = torch.einsum("bse,ed->bsd", y, params["down"])
    return out, (C, n, m)


def init_mlstm_state(cfg, batch: int, device="cuda"):
    _, hd = _mlstm_dims(cfg)
    H = cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, H, hd, hd), **f32),
            torch.zeros((batch, H, hd), **f32),
            torch.full((batch, H), -1e30, **f32))


def slstm_spec(cfg) -> Params:
    d = cfg.d_model
    ds = int(cfg.d_model * cfg.ssm.slstm_proj_factor)
    dtype = _dtype(cfg)
    return {
        # 4 gates (i, f, z, o) from the input and recurrent paths
        "w_x": dense_leaf((d, 4 * d), dtype),
        "w_h": dense_leaf((d, 4 * d), dtype),
        "b": Leaf((4 * d,), torch.float32),
        "up": dense_leaf((d, ds), dtype),
        "down": dense_leaf((ds, d), dtype),
    }


def slstm_specs(cfg) -> Params:
    d = cfg.d_model
    ds = int(d * cfg.ssm.slstm_proj_factor)
    ax4 = maybe_axis(4 * d, MODEL_AXIS)
    axs = maybe_axis(ds, MODEL_AXIS)
    return {"w_x": P(None, ax4), "w_h": P(None, ax4), "b": P(ax4),
            "up": P(None, axs), "down": P(axs, None)}


def slstm_forward(params: Params, cfg, x, *, state=None):
    """Scalar-memory LSTM with exponential gating and a stabiliser state,
    sequential over time.  state = (c, n, m, h), each [B,d] f32.
    Returns (y, new_state)."""
    Bsz, S, _ = x.shape
    xg = torch.einsum("bsd,de->bse", x, params["w_x"]).float()
    c, n, m, h = (init_slstm_state(cfg, Bsz, x.device) if state is None
                  else state)
    w_h = params["w_h"].float()
    b = params["b"]
    hs = []
    for t in range(S):
        g = xg[:, t] + h @ w_h + b
        i_t, f_t, z_t, o_t = g.chunk(4, dim=-1)
        f_log = F.logsigmoid(f_t)
        m_new = torch.maximum(f_log + m, i_t)
        i_e = torch.exp(i_t - m_new)
        f_e = torch.exp(f_log + m - m_new)
        c = f_e * c + i_e * torch.tanh(z_t)
        n = f_e * n + i_e
        h = torch.sigmoid(o_t) * c / torch.clamp_min(n, 1.0)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)                # [B,S,d]
    y = torch.einsum("bsd,de->bse", y, params["up"])
    y = F.gelu(y, approximate="tanh")                     # jax.nn.gelu
    out = torch.einsum("bse,ed->bsd", y, params["down"])
    return out, (c, n, m, h)


def init_slstm_state(cfg, batch: int, device="cuda"):
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros((batch, cfg.d_model), **f32)
    return (z, z, torch.full((batch, cfg.d_model), -1e30, **f32), z)
