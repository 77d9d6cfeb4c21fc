"""The LM for every assigned architecture — the port of
``repro.models.transformer``.

Layer params are stacked on a leading ``[L]`` axis as in the JAX package,
so carrying its params across is leaf for leaf; the layer scan is a
Python loop over the stack.  xLSTM's heterogeneous blocks (mLSTM on even
blocks, sLSTM on odd ones) are a Python list, as in the JAX package.
Per-layer attention windows are an ``[L]`` tensor (0-d entries), which
routes windowed layers to the blockwise attention as the JAX package's
traced windows do.

Public API
----------
init_params(gen, cfg, device)            seeded random weights
param_specs(cfg) / cache_specs(cfg, b)   partition specs (trees of ``P``)
abstract_params(cfg)                     the params as meta tensors
forward(params, cfg, batch, remat=)      -> (hidden [B,S,d], aux dict)
lm_loss / loss_fn                        chunked causal-LM cross-entropy
logits_from_hidden                       last-token f32 logits
init_cache / prefill / decode_step       the serving path

Families: dense and MoE (global, windowed or latent attention), hybrid
(attention and Mamba side by side in every layer, mixed by a learned
gate), ssm (xLSTM), vlm (patch embeddings replace the first token
slots) and the encoder-decoder (``audio``: a non-causal encoder over the
frames, cross-attention in every decoder layer).

``_layer_spec`` / ``_dec_layer_spec`` give a layer's init tree of
``Leaf``; ``_layer_specs``, ``_dec_layer_specs``, ``_stack_specs``,
``param_specs`` and ``cache_specs`` the partition specs (copies of the
JAX package's).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.ffn import (ffn, ffn_spec, ffn_specs, moe_ffn,
                                    moe_spec, moe_specs)
from repro_torch.models.layers import (MODEL_AXIS, Leaf, P, Params,
                                       attention_forward, attention_spec,
                                       attention_specs,
                                       cross_attention_forward,
                                       cross_attention_kv, dp_spec, draw,
                                       draw_stacked, embed, embedding_spec,
                                       embedding_specs, map_leaves,
                                       maybe_axis, rmsnorm, rmsnorm_spec,
                                       rmsnorm_specs, unembed)
from repro_torch.models.mla import mla_forward, mla_spec, mla_specs
from repro_torch.roofline import collectives


def _check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a config that lacks the sub-config its
    family or attention kind needs."""
    what = None
    if cfg.family in ("hybrid", "ssm") and cfg.ssm is None:
        what = f"family {cfg.family!r} without an ssm config"
    elif cfg.family == "moe" and cfg.moe is None:
        what = "family 'moe' without a moe config"
    elif cfg.attn_kind == "mla" and cfg.mla is None:
        what = "attn_kind 'mla' without an mla config"
    if what is not None:
        raise ValueError(f"{cfg.name}: {what}")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_spec(cfg: ArchConfig) -> Params:
    p: Params = {"ln1": rmsnorm_spec(cfg.d_model),
                 "ln2": rmsnorm_spec(cfg.d_model)}
    if cfg.attn_kind == "mla":
        p["attn"] = mla_spec(cfg)
    elif cfg.attn_kind != "none":
        p["attn"] = attention_spec(cfg)
    if cfg.family == "hybrid":
        p["mamba"] = ssm_mod.mamba_spec(cfg)
        p["alpha"] = Leaf((), torch.float32)     # sigmoid(0) = .5 mix
    if cfg.moe is not None:
        p["ffn"] = moe_spec(cfg)
    elif cfg.d_ff:
        p["ffn"] = ffn_spec(cfg.d_model, cfg.d_ff, _dtype(cfg))
    return p


def _dec_layer_spec(cfg: ArchConfig) -> Params:
    """A decoder layer with cross-attention (encoder-decoder archs)."""
    p = _layer_spec(cfg)
    p["lnx"] = rmsnorm_spec(cfg.d_model)
    p["cross"] = attention_spec(cfg)
    return p


# ---------------------------------------------------------------------------
# partition specs (copies of the JAX package's; ``_layer_spec`` above is
# the init tree, ``_layer_specs`` below the specs)
# ---------------------------------------------------------------------------


def _layer_specs(cfg: ArchConfig) -> Params:
    p: Params = {"ln1": rmsnorm_specs(), "ln2": rmsnorm_specs()}
    if cfg.attn_kind == "mla":
        p["attn"] = mla_specs(cfg)
    elif cfg.attn_kind != "none":
        p["attn"] = attention_specs(cfg)
    if cfg.family == "hybrid":
        p["mamba"] = ssm_mod.mamba_specs(cfg)
        p["alpha"] = P()
    if cfg.moe is not None:
        p["ffn"] = moe_specs(cfg)
    elif cfg.d_ff:
        p["ffn"] = ffn_specs(cfg.d_ff)
    return p


def _dec_layer_specs(cfg: ArchConfig) -> Params:
    p = _layer_specs(cfg)
    p["lnx"] = rmsnorm_specs()
    p["cross"] = attention_specs(cfg)
    return p


def _stack_specs(tree):
    """Prepend the stacked layer axis (unsharded) to every leaf spec."""
    return map_leaves(lambda s: P(None, *s), tree)


def param_specs(cfg: ArchConfig) -> Params:
    specs: Params = {
        "embed": embedding_specs(cfg.vocab_size),
        "ln_f": rmsnorm_specs(),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = embedding_specs(cfg.vocab_size)
    if cfg.family == "ssm":
        specs["blocks"] = [
            {"ln": rmsnorm_specs(),
             "core": (ssm_mod.mlstm_specs(cfg) if i % 2 == 0
                      else ssm_mod.slstm_specs(cfg))}
            for i in range(cfg.n_layers)]
        return specs
    if cfg.enc_dec:
        specs["enc_layers"] = _stack_specs(_layer_specs(cfg))
        specs["dec_layers"] = _stack_specs(_dec_layer_specs(cfg))
        specs["ln_enc"] = rmsnorm_specs()
        return specs
    specs["layers"] = _stack_specs(_layer_specs(cfg))
    return specs


def cache_specs(cfg: ArchConfig, batch: int = 0) -> Params:
    """PartitionSpecs for the cache: batch over DP (when divisible);
    kv-heads over model where divisible, else the sequence axis over model
    (context-parallel decode: keeps the 32k x 128 caches inside per-chip
    HBM)."""
    dp = dp_spec(batch)
    kv_ax = maybe_axis(cfg.n_kv_heads, MODEL_AXIS)
    seq_ax = None if kv_ax is not None else MODEL_AXIS
    cache: Params = {}
    if cfg.family == "ssm":
        cache["states"] = [
            tuple(P(dp) for _ in range(3)) if i % 2 == 0
            else tuple(P(dp) for _ in range(4))
            for i in range(cfg.n_layers)]
        return cache
    if cfg.attn_kind == "mla":
        cache["c"] = P(None, dp, MODEL_AXIS, None)
        cache["pe"] = P(None, dp, MODEL_AXIS, None)
    elif cfg.attn_kind != "none":
        cache["k"] = P(None, dp, seq_ax, kv_ax, None)
        cache["v"] = P(None, dp, seq_ax, kv_ax, None)
    if cfg.family == "hybrid":
        cache["conv"] = P(None, dp, None, None)
        cache["h"] = P(None, dp, None, None)
    if cfg.enc_dec:
        cache["cross_k"] = P(None, dp, None, kv_ax, None)
        cache["cross_v"] = P(None, dp, None, kv_ax, None)
    return cache


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


def _param_tree(cfg: ArchConfig) -> Params:
    """The init tree, in draw order: ``Leaf`` trees, xLSTM's list of
    blocks, and each ``[L]`` stack as ``(layer tree, L)``."""
    _check_supported(cfg)
    table = embedding_spec(cfg.vocab_size, cfg.d_model, _dtype(cfg))
    spec: Params = {"embed": table, "ln_f": rmsnorm_spec(cfg.d_model)}
    if not cfg.tie_embeddings:
        spec["unembed"] = table
    if cfg.family == "ssm":               # xLSTM: alternating blocks
        spec["blocks"] = [{
            "ln": rmsnorm_spec(cfg.d_model),
            "core": (ssm_mod.mlstm_spec(cfg) if i % 2 == 0
                     else ssm_mod.slstm_spec(cfg))}
            for i in range(cfg.n_layers)]
    elif cfg.enc_dec:
        spec["enc_layers"] = (_layer_spec(cfg), cfg.n_enc_layers)
        spec["dec_layers"] = (_dec_layer_spec(cfg), cfg.n_layers)
        spec["ln_enc"] = rmsnorm_spec(cfg.d_model)
    else:
        spec["layers"] = (_layer_spec(cfg), cfg.n_layers)
    return spec


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device="cuda") -> Params:
    """Seeded random weights drawn on ``device`` (``gen`` must live there
    too): normals times 1/sqrt(fan_in) in the model dtype (the MoE router
    in f32), RMSNorm scales zero in f32, as the JAX package initialises
    (other numbers); the SSM blocks' structured leaves (``A_log``,
    ``dt_bias``, ``D``, zero biases and mix gates) as the JAX package
    sets them.  Each ``[L]``-stacked leaf is allocated once and every
    layer drawn into its slice (``draw_stacked``): the peak is the
    weights plus one leaf's f32 draw."""
    params: Params = {}
    for name, v in _param_tree(cfg).items():
        if isinstance(v, tuple):
            params[name] = draw_stacked(gen, v[0], v[1], device)
        elif isinstance(v, list):
            params[name] = [draw(gen, b, device) for b in v]
        else:
            params[name] = draw(gen, v, device)
    return params


def abstract_params(cfg: ArchConfig) -> Params:
    """The params of ``init_params`` as ``meta`` tensors (shapes and
    dtypes only, nothing drawn): the counterpart of the JAX package's
    ``jax.eval_shape(init_params)``, each stack on a leading ``[L]`` as
    ``draw_stacked`` lays it out."""
    def meta(leaf, lead=()):
        return torch.empty(lead + leaf.shape, dtype=leaf.dtype,
                           device="meta")

    params: Params = {}
    for name, v in _param_tree(cfg).items():
        if isinstance(v, tuple):
            params[name] = map_leaves(lambda l, n=v[1]: meta(l, (n,)), v[0])
        elif isinstance(v, list):
            params[name] = [map_leaves(meta, b) for b in v]
        else:
            params[name] = map_leaves(meta, v)
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
    """Token embeddings; for the VLM, the patch embeddings replace the
    first ``n_patches`` token slots."""
    x = _scale_embedding(cfg, embed(params["embed"],
                                    batch["tokens"]).to(_dtype(cfg)))
    if cfg.family == "vlm" and "patches" in batch:
        p = batch["patches"].to(x.dtype)
        if p.shape[1] > x.shape[1]:
            raise ValueError(f"{p.shape[1]} patches do not fit a prompt of "
                             f"{x.shape[1]} tokens")
        x = torch.cat([p, x[:, p.shape[1]:]], dim=1)
    return x


def _mix(a, m, alpha):
    """The hybrid layer's gate: sigmoid(alpha) attention + the rest
    Mamba, in the model dtype."""
    mix = torch.sigmoid(alpha).to(m.dtype)
    return mix * a + (1.0 - mix) * m


def _attn_block(cfg: ArchConfig, x, layer_params, window, positions, *,
                causal=True):
    """x + the attention (or MLA; for the hybrid, mixed with Mamba on the
    same normed input) sublayer of one layer.  Returns (x, kv, mstate):
    kv the layer's (k, v), or MLA's latents (c_kv, k_pe), or None without
    attention; mstate the hybrid's Mamba state (conv, h), else None."""
    h = rmsnorm(layer_params["ln1"], x, cfg.norm_eps)
    if cfg.attn_kind == "mla":
        a, kv = mla_forward(layer_params["attn"], cfg, h, positions)
    elif cfg.attn_kind == "none":
        a, kv = 0.0, None
    else:
        a, kv = attention_forward(layer_params["attn"], cfg, h, positions,
                                  window=window, causal=causal)
    mstate = None
    if cfg.family == "hybrid":
        m, mstate = ssm_mod.mamba_forward(layer_params["mamba"], cfg, h)
        a = _mix(a, m, layer_params["alpha"])
    return x + a, kv, mstate


def _cross_block(cfg: ArchConfig, x, layer_params, cross_kv):
    """x + the cross-attention sublayer of a decoder layer over the
    encoder's (k, v)."""
    hx = rmsnorm(layer_params["lnx"], x, cfg.norm_eps)
    return x + cross_attention_forward(layer_params["cross"], cfg, hx,
                                       cross_kv)


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
                      *, causal=True, memory=None):
    """One transformer layer (attention or MLA [+ Mamba] [+ cross-attention
    over ``memory``, the encoder output] + FFN or MoE).  Returns (x, aux,
    kv, mstate)."""
    x, kv, mstate = _attn_block(cfg, x, layer_params, window, positions,
                                causal=causal)
    if memory is not None:
        x = _cross_block(cfg, x, layer_params, cross_attention_kv(
            layer_params["cross"], cfg, memory))
    x, aux = _ffn_block(cfg, x, layer_params)
    return x, aux, kv, mstate


def _stack_pairs(pairs):
    """[(a, b)] per layer -> (a stacked, b stacked) on a leading [L]."""
    return tuple(torch.stack(t) for t in zip(*pairs))


def _scan_layers(params_stack, cfg: ArchConfig, x, positions, windows, *,
                 causal=True, memory=None, remat=False, collect_kv=False):
    """The layer loop over the stacked params.  Returns (x, aux_sum, kvs,
    mstates): aux_sum the layers' MoE losses summed (0.0 for a dense
    FFN); when ``collect_kv``, kvs the per-layer (k, v) (or MLA latents)
    stacked to [L,B,S,...] and for the hybrid mstates its Mamba states
    (conv [L,B,K-1,inner], h [L,B,inner,state]), else None.

    ``remat``: each layer saves only its input for the backward and runs
    again during it, as ``jax.checkpoint(policy=nothing_saveable)`` on the
    JAX package's scan body (with the flash kernels: K9 twice per layer
    and step, K10 and K11 once)."""
    n = next(iter(params_stack["ln1"].values())).shape[0]
    kvs, mstates = [], []
    aux_sum = 0.0
    for i, lp in enumerate(_unstack(params_stack, n)):
        w = None if windows is None else windows[i]
        if remat:
            # no random numbers in a layer: nothing to replay
            x, aux, kv, mstate = torch.utils.checkpoint.checkpoint(
                collectives.rerun_visible(_dense_layer_body), cfg, x, lp, w,
                positions, causal=causal,
                memory=memory, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, aux, kv, mstate = _dense_layer_body(
                cfg, x, lp, w, positions, causal=causal, memory=memory)
        aux_sum = aux_sum + aux
        if collect_kv:
            kvs.append(kv)
            mstates.append(mstate)
    if not collect_kv:
        return x, aux_sum, None, None
    return (x, aux_sum, _stack_pairs(kvs),
            _stack_pairs(mstates) if cfg.family == "hybrid" else None)


def _ssm_blocks(params, cfg: ArchConfig, x, states=None):
    """xLSTM's blocks: mLSTM on even blocks, sLSTM on odd ones, each a
    pre-norm residual.  ``states``: per block, the state to start from
    (decode), or None.  Returns (x, the blocks' new states)."""
    new_states = []
    for i, blk in enumerate(params["blocks"]):
        h = rmsnorm(blk["ln"], x, cfg.norm_eps)
        fwd = ssm_mod.mlstm_forward if i % 2 == 0 else ssm_mod.slstm_forward
        y, st = fwd(blk["core"], cfg, h,
                    state=None if states is None else states[i])
        new_states.append(st)
        x = x + y
    return x, new_states


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, Any], *,
            remat: bool = False, collect_kv: bool = False):
    """Returns (hidden [B,S,d], aux): aux["moe_loss"] the layers' MoE
    load-balance losses summed (0.0 for a dense FFN); with
    ``collect_kv``, aux["kv"] the stacked per-layer K/V (MLA: latents),
    and for the hybrid aux["mstate"] its Mamba states, for xLSTM
    aux["states"] the blocks' states.  The encoder-decoder reads
    batch["frames"] [B,F,d] (the stub front end's frame embeddings) and
    puts the encoder's output in aux["enc_memory"]; the VLM reads
    batch["patches"] [B,n_patches,d] where given.  ``remat``: see
    ``_scan_layers``."""
    _check_supported(cfg)
    aux: Dict[str, Any] = {"moe_loss": 0.0}
    x = _embed_inputs(params, cfg, batch)
    if cfg.family == "ssm":
        x, states = _ssm_blocks(params, cfg, x)
        if collect_kv:
            aux["states"] = states
        return rmsnorm(params["ln_f"], x, cfg.norm_eps), aux
    B, S = batch["tokens"].shape
    positions = _positions(B, S, x.device)
    if cfg.enc_dec:
        frames = batch["frames"]
        enc_x, _, _, _ = _scan_layers(
            params["enc_layers"], cfg, frames.to(_dtype(cfg)),
            _positions(frames.shape[0], frames.shape[1], x.device), None,
            causal=False, remat=remat)
        memory = rmsnorm(params["ln_enc"], enc_x, cfg.norm_eps)
        aux["enc_memory"] = memory
        x, aux["moe_loss"], kvs, _ = _scan_layers(
            params["dec_layers"], cfg, x, positions, None, memory=memory,
            remat=remat, collect_kv=collect_kv)
    else:
        x, aux["moe_loss"], kvs, mstates = _scan_layers(
            params["layers"], cfg, x, positions,
            layer_windows(cfg, S, x.device), remat=remat,
            collect_kv=collect_kv)
        if collect_kv:
            aux["mstate"] = mstates
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


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, device="cuda",
               enc_len: int = 0) -> Params:
    """Zeroed caches: K/V [L, B, S_c, n_kv, hd] in the model dtype, or for
    MLA the latents c [L, B, S_c, kv_lora_rank] and pe [L, B, S_c,
    rope]; for the hybrid also its Mamba states, conv [L, B, K-1, inner]
    (model dtype) and h [L, B, inner, state] (f32); for the
    encoder-decoder also the cross K/V [L, B, enc_len, n_kv, hd]; for
    xLSTM only "states", a list of each block's state (mLSTM (C, n, m),
    sLSTM (c, n, m, h), f32)."""
    _check_supported(cfg)
    if cfg.family == "ssm":
        return {"states": [
            ssm_mod.init_mlstm_state(cfg, batch, device) if i % 2 == 0
            else ssm_mod.init_slstm_state(cfg, batch, device)
            for i in range(cfg.n_layers)]}
    L = cfg.n_layers
    lead = (L, batch, kv_cache_len(cfg, max_seq))
    kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
    shapes = {}
    if cfg.attn_kind == "mla":
        m = cfg.mla
        shapes = {"c": lead + (m.kv_lora_rank,),
                  "pe": lead + (m.qk_rope_head_dim,)}
    elif cfg.attn_kind != "none":
        shapes = {"k": lead + kv, "v": lead + kv}
    if cfg.enc_dec:
        shapes["cross_k"] = shapes["cross_v"] = (L, batch, enc_len) + kv
    cache = {name: torch.zeros(shape, dtype=_dtype(cfg), device=device)
             for name, shape in shapes.items()}
    if cfg.family == "hybrid":
        conv, h = ssm_mod.init_mamba_state(cfg, batch, device)
        cache["conv"] = conv.expand((L,) + conv.shape).clone()
        cache["h"] = h.expand((L,) + h.shape).clone()
    return cache


def _cache_seq_len(cfg: ArchConfig, cache: Params) -> int:
    if cfg.attn_kind == "mla":
        return cache["c"].shape[2]
    return cache["k"].shape[2] if "k" in cache else 0


def decode_step(params: Params, cfg: ArchConfig, cache: Params,
                tokens: torch.Tensor, pos: int):
    """One decode step.  tokens: [B,1]; pos: absolute position of the new
    token (every sequence of the batch is at the same position).  Writes
    the new K/V (MLA: latents) and the hybrid's Mamba states into
    ``cache`` in place; xLSTM's block states are replaced.  Returns
    (logits [B,vocab_pad], cache)."""
    _check_supported(cfg)
    B = tokens.shape[0]
    x = _scale_embedding(cfg, embed(params["embed"], tokens).to(_dtype(cfg)))
    if cfg.family == "ssm":
        x, states = _ssm_blocks(params, cfg, x, cache["states"])
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return logits_from_hidden(params, cfg, x[:, 0]), {"states": states}
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    ring = cfg.attn_kind == "sliding"
    windows = layer_windows(cfg, _cache_seq_len(cfg, cache), x.device)
    stack = params["dec_layers" if cfg.enc_dec else "layers"]
    for i, lp in enumerate(_unstack(stack, cfg.n_layers)):
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if cfg.attn_kind == "mla":
            a, _ = mla_forward(lp["attn"], cfg, h, positions,
                               kv_cache=(cache["c"][i], cache["pe"][i]),
                               cache_index=pos)
        elif cfg.attn_kind == "none":
            a = 0.0
        else:
            a, _ = attention_forward(
                lp["attn"], cfg, h, positions,
                window=None if windows is None else windows[i],
                kv_cache=(cache["k"][i], cache["v"][i]), cache_index=pos,
                ring=ring)
        if cfg.family == "hybrid":
            m, (conv, hs) = ssm_mod.mamba_forward(
                lp["mamba"], cfg, h, state=(cache["conv"][i],
                                            cache["h"][i]))
            cache["conv"][i].copy_(conv)
            cache["h"][i].copy_(hs)
            a = _mix(a, m, lp["alpha"])
        x = x + a
        if cfg.enc_dec:
            x = _cross_block(cfg, x, lp, (cache["cross_k"][i],
                                          cache["cross_v"][i]))
        x, _ = _ffn_block(cfg, x, lp, with_aux=False)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x[:, 0]), cache


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
            max_seq: int):
    """Run the full prompt, build the decode cache, return last-token
    logits.  For ring-buffer (sliding) archs only the last ``window``
    positions go into the cache; MLA stores its latents; the hybrid its
    Mamba states, xLSTM its blocks' states, the encoder-decoder the
    cross K/V of every decoder layer."""
    hidden, aux = forward(params, cfg, batch, collect_kv=True)
    B, S = batch["tokens"].shape
    cache = init_cache(cfg, B, max_seq, hidden.device,
                       enc_len=batch["frames"].shape[1] if cfg.enc_dec
                       else 0)
    logits = logits_from_hidden(params, cfg, hidden[:, -1])
    if cfg.family == "ssm":
        cache["states"] = aux["states"]
        return logits, cache
    if cfg.attn_kind != "none":
        k, v = aux["kv"]          # [L,B,S,kv,hd] each, or MLA's latents
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
    if cfg.family == "hybrid":
        cache["conv"], cache["h"] = aux["mstate"]
    if cfg.enc_dec:
        memory = aux["enc_memory"]
        ck, cv = _stack_pairs(
            cross_attention_kv(lp["cross"], cfg, memory)
            for lp in _unstack(params["dec_layers"], cfg.n_layers))
        cache["cross_k"].copy_(ck)
        cache["cross_v"].copy_(cv)
    return logits, cache
