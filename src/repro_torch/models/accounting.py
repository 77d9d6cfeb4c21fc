"""Parameter / FLOP / traffic accounting for LM architectures.

These closed-form counts drive the H2PIPE placement algorithm (Eq. 1 analogue),
the weight-traffic roofline (Eq. 2 analogue: decode throughput <= HBM_bw /
weight bytes touched per token) and the MODEL_FLOPS figures of the roofline
report (6·N·D dense, 6·N_active·D MoE).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig


def _attn_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    if cfg.attn_kind == "mla":
        m = cfg.mla
        q = d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * (
            m.qk_nope_head_dim + m.qk_rope_head_dim)
        kv = d * (m.kv_lora_rank + m.qk_rope_head_dim)
        kv += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
        o = cfg.n_heads * m.v_head_dim * d
        return q + kv + o
    if cfg.attn_kind == "none":
        return 0
    q = d * cfg.n_heads * hd
    kv = 2 * d * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * d
    bias = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd if cfg.qkv_bias else 0
    return q + kv + o + bias


def _ffn_params(cfg: ArchConfig) -> Dict[str, int]:
    """Returns {'total': ..., 'active': ...} for one layer's FFN."""
    d = cfg.d_model
    if cfg.moe is not None:
        m = cfg.moe
        per_expert = 3 * d * m.d_ff_expert            # gate/up/down
        router = d * m.n_experts
        total = (m.n_experts + m.n_shared) * per_expert + router
        active = (m.top_k + m.n_shared) * per_expert + router
        return {"total": total, "active": active}
    if cfg.d_ff == 0:
        return {"total": 0, "active": 0}
    n = 3 * d * cfg.d_ff
    return {"total": n, "active": n}


def _ssm_params(cfg: ArchConfig) -> int:
    if cfg.ssm is None:
        return 0
    s = cfg.ssm
    d = cfg.d_model
    if cfg.family == "ssm":                            # xlstm blocks
        dm = int(d * s.mlstm_proj_factor)
        mlstm = d * 2 * dm + 3 * dm * dm // cfg.n_heads + dm * d  # in/qkv/out
        ds = int(d * s.slstm_proj_factor)
        slstm = 4 * d * d + d * ds + ds * d            # gates + ffn up/down
        return (mlstm + slstm) // 2                    # alternating -> average
    inner = int(d * s.expand)
    # mamba: in_proj (x & z), conv, x->(dt,B,C), dt_proj, out_proj, A, D
    p = d * 2 * inner
    p += inner * s.conv_width
    p += inner * (s.state_dim * 2 + inner // 16)
    p += inner * d
    p += inner * s.state_dim + inner
    return p


def layer_param_counts(cfg: ArchConfig) -> Dict[str, int]:
    """Per-layer breakdown: attn / ffn_total / ffn_active / ssm / norms."""
    return {
        "attn": _attn_params(cfg),
        "ffn_total": _ffn_params(cfg)["total"],
        "ffn_active": _ffn_params(cfg)["active"],
        "ssm": _ssm_params(cfg),
        "norms": 4 * cfg.d_model,
    }


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    lc = layer_param_counts(cfg)
    per_layer = (lc["attn"] + (lc["ffn_active"] if active_only else lc["ffn_total"])
                 + lc["ssm"] + lc["norms"])
    n_layers = cfg.n_layers + cfg.n_enc_layers
    embed = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        embed *= 2
    cross = 0
    if cfg.enc_dec:
        # decoder cross-attention per decoder layer
        cross = cfg.n_layers * _attn_params(cfg)
    return n_layers * per_layer + cross + embed + cfg.d_model


def model_flops_per_token(cfg: ArchConfig) -> int:
    """6·N_active·(1 token) — the 'useful FLOPs' convention."""
    return 6 * count_params(cfg, active_only=True)


def weight_bytes(cfg: ArchConfig, bytes_per_param: int = 2) -> int:
    return count_params(cfg) * bytes_per_param


def active_weight_bytes_per_token(cfg: ArchConfig, bytes_per_param: int = 2) -> int:
    """Eq. 2 analogue for decode: weight bytes that must be read from HBM to
    produce one token (batch=1).  This is the H2PIPE 'weight traffic' term."""
    return count_params(cfg, active_only=True) * bytes_per_param
