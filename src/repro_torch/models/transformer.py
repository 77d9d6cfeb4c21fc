"""The dense decoder-only LM — the port of ``repro.models.transformer``.

Layer params are stacked on a leading ``[L]`` axis as in the JAX package,
so carrying its params across is leaf for leaf; the layer scan is a
Python loop over the stack.  Per-layer attention windows are an ``[L]``
tensor (0-d entries), which routes windowed layers to the blockwise
attention as the JAX package's traced windows do.

Public API
----------
init_params(gen, cfg, device)            seeded random weights
forward(params, cfg, batch, remat=)      -> (hidden [B,S,d], aux dict)
lm_loss / loss_fn                        chunked causal-LM cross-entropy
logits_from_hidden                       last-token f32 logits
init_cache / prefill / decode_step       the serving path

The dense and MoE families run, with global, windowed or latent (MLA)
attention.  Families ``hybrid``, ``ssm``, ``vlm`` and ``audio``, the
encoder-decoder and ``attn_kind="none"`` raise ``NotImplementedError``:
they wait for the remaining-LM-families item of ROADMAP Queue 1.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.ffn import ffn, ffn_spec, moe_ffn, moe_spec
from repro_torch.models.layers import (Params, attention_forward,
                                       attention_spec, draw, draw_stacked,
                                       embed, embedding_spec, rmsnorm,
                                       rmsnorm_spec, unembed)
from repro_torch.models.mla import mla_forward, mla_spec


def _check_supported(cfg: ArchConfig) -> None:
    what = None
    if cfg.enc_dec:
        what = "the encoder-decoder family"
    elif cfg.family not in ("dense", "moe"):
        what = f"family {cfg.family!r}"
    elif (cfg.family == "moe") != (cfg.moe is not None):
        what = f"family {cfg.family!r} with moe={cfg.moe!r}"
    elif cfg.attn_kind == "none":
        what = f"attn_kind {cfg.attn_kind!r}"
    elif (cfg.attn_kind == "mla") != (cfg.mla is not None):
        what = f"attn_kind {cfg.attn_kind!r} with mla={cfg.mla!r}"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet (ROADMAP Queue 1, the "
            f"remaining LM families)")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_spec(cfg: ArchConfig) -> Params:
    p: Params = {"ln1": rmsnorm_spec(cfg.d_model),
                 "ln2": rmsnorm_spec(cfg.d_model),
                 "attn": (mla_spec(cfg) if cfg.attn_kind == "mla"
                          else attention_spec(cfg))}
    if cfg.moe is not None:
        p["ffn"] = moe_spec(cfg)
    elif cfg.d_ff:
        p["ffn"] = ffn_spec(cfg.d_model, cfg.d_ff, _dtype(cfg))
    return p


def _unstack(stack: Params, n: int) -> List[Params]:
    """The [L]-stacked tree as n per-layer trees, through one ``unbind``
    per leaf: under autograd each stacked leaf then gets its gradient
    stacked once, where indexing layer by layer would write a zeroed
    full-size gradient per layer."""
    layers: List[Params] = [{} for _ in range(n)]
    for k, v in stack.items():
        parts = (_unstack(v, n) if isinstance(v, dict)
                 else torch.unbind(v, 0))
        for layer, part in zip(layers, parts):
            layer[k] = part
    return layers


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device="cuda") -> Params:
    """Seeded random weights drawn on ``device`` (``gen`` must live there
    too): normals times 1/sqrt(fan_in) in the model dtype (the MoE router
    in f32), RMSNorm scales zero in f32, as the JAX package initialises
    (other numbers).  Each ``[L]``-stacked leaf is allocated once and
    every layer drawn into its slice (``draw_stacked``): the peak is the
    weights plus one leaf's f32 draw."""
    _check_supported(cfg)
    table = embedding_spec(cfg.vocab_size, cfg.d_model, _dtype(cfg))
    spec: Params = {"embed": table, "ln_f": rmsnorm_spec(cfg.d_model)}
    if not cfg.tie_embeddings:
        spec["unembed"] = table
    params = draw(gen, spec, device)
    params["layers"] = draw_stacked(gen, _layer_spec(cfg), cfg.n_layers,
                                    device)
    return params


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------


def layer_windows(cfg: ArchConfig, full: int,
                  device=None) -> Optional[torch.Tensor]:
    """Per-layer sliding-window sizes as an [L] tensor, or None.  ``full``
    stands in for 'no window' on global layers."""
    if cfg.attn_kind not in ("local_global", "sliding"):
        return None
    if cfg.attn_kind == "sliding":
        return torch.full((cfg.n_layers,), cfg.window, dtype=torch.int32,
                          device=device)
    idx = torch.arange(cfg.n_layers, device=device)
    return torch.where(idx % 2 == 0, cfg.window, full).to(torch.int32)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _scale_embedding(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x * sqrt(d_model), the factor rounded to the model dtype first (in
    bf16, sqrt(3072) = 55.43 becomes 55.5), as the JAX package does."""
    f = torch.full((), float(cfg.d_model), dtype=torch.float32,
                   device=x.device).sqrt()   # no host copy: graph-safe
    return x * f.to(x.dtype)


def _embed_inputs(params, cfg: ArchConfig, batch: Dict[str, Any]):
    x = embed(params["embed"], batch["tokens"]).to(_dtype(cfg))
    return _scale_embedding(cfg, x)


def _attn_block(cfg: ArchConfig, x, layer_params, window, positions, *,
                causal=True):
    """x + the attention (or MLA) sublayer of one layer.  Returns (x, kv):
    kv the layer's (k, v), or MLA's latents (c_kv, k_pe)."""
    h = rmsnorm(layer_params["ln1"], x, cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a, kv = mla_forward(layer_params["attn"], cfg, h, positions)
    else:
        a, kv = attention_forward(layer_params["attn"], cfg, h, positions,
                                  window=window, causal=causal)
    return x + a, kv


def _ffn_block(cfg: ArchConfig, x, layer_params, with_aux=True):
    """x + the FFN (or MoE) sublayer of one layer.  Returns (x, aux): aux
    the MoE load-balance loss, 0.0 for a dense FFN or without ``with_aux``
    (``decode_step``: no request needs it)."""
    aux = 0.0
    if "ffn" in layer_params:
        h2 = rmsnorm(layer_params["ln2"], x, cfg.norm_eps)
        if cfg.moe is not None:
            f, aux = moe_ffn(layer_params["ffn"], cfg, h2, cfg.act,
                             with_aux=with_aux)
        else:
            f = ffn(layer_params["ffn"], h2, cfg.act)
        x = x + f
    return x, aux


def _dense_layer_body(cfg: ArchConfig, x, layer_params, window, positions,
                      *, causal=True):
    """One transformer layer (attention or MLA + FFN or MoE).  Returns
    (x, aux, kv)."""
    x, kv = _attn_block(cfg, x, layer_params, window, positions,
                        causal=causal)
    x, aux = _ffn_block(cfg, x, layer_params)
    return x, aux, kv


def _scan_layers(params_stack, cfg: ArchConfig, x, positions, windows, *,
                 causal=True, remat=False, collect_kv=False):
    """The layer loop over the stacked params.  Returns (x, aux_sum, kvs):
    aux_sum the layers' MoE losses summed (0.0 for a dense FFN), kvs the
    per-layer (k, v) (or MLA latents) stacked to [L,B,S,...] when
    ``collect_kv``.

    ``remat``: each layer saves only its input for the backward and runs
    again during it, as ``jax.checkpoint(policy=nothing_saveable)`` on the
    JAX package's scan body (with the flash kernels: K9 twice per layer
    and step, K10 and K11 once)."""
    n = next(iter(params_stack["ln1"].values())).shape[0]
    ks, vs = [], []
    aux_sum = 0.0
    for i, lp in enumerate(_unstack(params_stack, n)):
        w = None if windows is None else windows[i]
        if remat:
            # no random numbers in a layer: nothing to replay
            x, aux, (k, v) = torch.utils.checkpoint.checkpoint(
                _dense_layer_body, cfg, x, lp, w, positions, causal=causal,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux, (k, v) = _dense_layer_body(cfg, x, lp, w, positions,
                                               causal=causal)
        aux_sum = aux_sum + aux
        if collect_kv:
            ks.append(k)
            vs.append(v)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, aux_sum, kvs


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, Any], *,
            remat: bool = False, collect_kv: bool = False):
    """Returns (hidden [B,S,d], aux): aux["moe_loss"] the layers' MoE
    load-balance losses summed (0.0 for a dense FFN), aux["kv"] the
    stacked per-layer K/V (MLA: latents) when ``collect_kv``.  ``remat``:
    see ``_scan_layers``."""
    _check_supported(cfg)
    x = _embed_inputs(params, cfg, batch)
    B, S = batch["tokens"].shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    windows = layer_windows(cfg, S, x.device)
    x, aux_sum, kvs = _scan_layers(params["layers"], cfg, x, positions,
                                   windows, remat=remat,
                                   collect_kv=collect_kv)
    aux: Dict[str, Any] = {"moe_loss": aux_sum}
    if collect_kv:
        aux["kv"] = kvs
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux


def _unembed_table(params, cfg: ArchConfig):
    return params["embed" if cfg.tie_embeddings else "unembed"]


def logits_from_hidden(params, cfg: ArchConfig, hidden):
    """Logits for a few positions (decode / last token), f32, padded
    vocab."""
    return unembed(_unembed_table(params, cfg), hidden,
                   cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# loss (sequence-chunked: at most LOSS_CHUNK positions of [B, chunk, V]
# logits at a time)
# ---------------------------------------------------------------------------

LOSS_CHUNK = 1024


def lm_loss(params, cfg: ArchConfig, hidden, labels, mask):
    """Causal-LM cross-entropy over chunks of the sequence, in f32 (an f32
    copy of the table; full-f32 products need TF32 off on the card, which
    the trainer sets).  hidden: [B,S,d]; labels/mask: [B,S].  Padded vocab
    columns are excluded from the logsumexp.  Returns (mean_loss, denom)."""
    S = hidden.shape[1]
    table = _unembed_table(params, cfg)["table"].float()
    vp = table.shape[0]
    col_ok = torch.arange(vp, device=hidden.device) < cfg.vocab_size
    chunk = min(LOSS_CHUNK, S)
    if S % chunk:
        raise ValueError(f"S = {S} is not a multiple of the loss chunk "
                         f"{chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    den = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        h = hidden[:, c0:c0 + chunk]
        y = labels[:, c0:c0 + chunk]
        m = mask[:, c0:c0 + chunk]
        logits = torch.matmul(h.float(), table.t())
        if cfg.final_logit_softcap:
            logits = torch.tanh(logits / cfg.final_logit_softcap) * \
                cfg.final_logit_softcap
        logits = torch.where(col_ok, logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
        tot = tot + ((lse - gold) * m).sum()
        den = den + m.sum()
    return tot / den.clamp_min(1.0), den


def loss_fn(params, cfg: ArchConfig, batch: Dict[str, Any], *,
            remat: bool = True, moe_loss_weight: float = 0.01):
    """Mean next-token loss of ``batch`` (``tokens``, ``labels`` and an
    optional f32 ``mask``), plus for the MoE family ``moe_loss_weight``
    times the load-balance loss a layer."""
    hidden, aux = forward(params, cfg, batch, remat=remat)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(batch["labels"].shape, dtype=torch.float32,
                          device=hidden.device)
    loss, _ = lm_loss(params, cfg, hidden, batch["labels"], mask)
    if cfg.moe is not None:
        loss = loss + moe_loss_weight * aux["moe_loss"] / max(cfg.n_layers,
                                                              1)
    return loss


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode_step
# ---------------------------------------------------------------------------


def kv_cache_len(cfg: ArchConfig, max_seq: int) -> int:
    """Ring buffer of size window for pure sliding-window archs."""
    if cfg.attn_kind == "sliding":
        return min(max_seq, cfg.window)
    return max_seq


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device="cuda") -> Params:
    """Zeroed caches in the model dtype: K/V [L, B, S_c, n_kv, hd], or for
    MLA the latents c [L, B, S_c, kv_lora_rank] and pe [L, B, S_c,
    rope]."""
    _check_supported(cfg)
    lead = (cfg.n_layers, batch, kv_cache_len(cfg, max_seq))
    if cfg.attn_kind == "mla":
        m = cfg.mla
        shapes = {"c": lead + (m.kv_lora_rank,),
                  "pe": lead + (m.qk_rope_head_dim,)}
    else:
        kv = lead + (cfg.n_kv_heads, cfg.resolved_head_dim)
        shapes = {"k": kv, "v": kv}
    return {name: torch.zeros(shape, dtype=_dtype(cfg), device=device)
            for name, shape in shapes.items()}


def _cache_seq_len(cfg: ArchConfig, cache: Params) -> int:
    return cache["c" if cfg.attn_kind == "mla" else "k"].shape[2]


def decode_step(params: Params, cfg: ArchConfig, cache: Params,
                tokens: torch.Tensor, pos: int):
    """One decode step.  tokens: [B,1]; pos: absolute position of the new
    token (every sequence of the batch is at the same position).  Writes
    the new K/V (MLA: latents) into ``cache`` in place.  Returns (logits
    [B,vocab_pad], cache)."""
    _check_supported(cfg)
    B = tokens.shape[0]
    x = _scale_embedding(cfg, embed(params["embed"], tokens).to(_dtype(cfg)))
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    ring = cfg.attn_kind == "sliding"
    windows = layer_windows(cfg, _cache_seq_len(cfg, cache), x.device)
    for i, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if cfg.attn_kind == "mla":
            a, _ = mla_forward(lp["attn"], cfg, h, positions,
                               kv_cache=(cache["c"][i], cache["pe"][i]),
                               cache_index=pos)
        else:
            a, _ = attention_forward(
                lp["attn"], cfg, h, positions,
                window=None if windows is None else windows[i],
                kv_cache=(cache["k"][i], cache["v"][i]), cache_index=pos,
                ring=ring)
        x, _ = _ffn_block(cfg, x + a, lp, with_aux=False)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x[:, 0]), cache


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
            max_seq: int):
    """Run the full prompt, build the decode cache, return last-token
    logits.  For ring-buffer (sliding) archs only the last ``window``
    positions go into the cache; MLA stores its latents."""
    hidden, aux = forward(params, cfg, batch, collect_kv=True)
    B, S = batch["tokens"].shape
    cache = init_cache(cfg, B, max_seq, hidden.device)
    k, v = aux["kv"]              # [L,B,S,kv,hd] each, or MLA's latents
    names = ("c", "pe") if cfg.attn_kind == "mla" else ("k", "v")
    S_c = cache[names[0]].shape[2]
    if S_c < S:
        if cfg.attn_kind != "sliding":
            raise ValueError(f"prompt of {S} tokens exceeds max_seq "
                             f"{max_seq}")
        # ring: keep the tail, rolled so that slot = pos % S_c
        shift = (S - S_c) % S_c
        k = torch.roll(k[:, :, S - S_c:], shift, dims=2)
        v = torch.roll(v[:, :, S - S_c:], shift, dims=2)
    cache[names[0]][:, :, :k.shape[2]] = k
    cache[names[1]][:, :, :v.shape[2]] = v
    return logits_from_hidden(params, cfg, hidden[:, -1]), cache
