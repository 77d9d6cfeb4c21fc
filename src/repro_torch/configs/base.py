"""Config dataclasses of the LM architectures: a copy of the JAX package's
framework-free ``configs/base.py``.

One ``ArchConfig`` describes any of the supported architectures (dense / MoE /
hybrid / VLM / audio enc-dec / SSM LMs, plus the paper's CNNs via
``configs/cnn.py``).  Configs are frozen dataclasses so they can be hashed and
used as dictionary keys.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN."""

    n_experts: int
    top_k: int
    n_shared: int = 0               # shared (always-on) experts
    d_ff_expert: int = 0            # per-expert hidden size
    router_dtype: str = "float32"
    # capacity factor used for the dense-dispatch (dropless einsum) path
    capacity_factor: float = 1.25
    jitter: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """State-space / recurrent block parameters (mamba-style and xLSTM)."""

    state_dim: int = 16
    conv_width: int = 4
    expand: float = 2.0             # inner dim = expand * d_model
    # xLSTM specifics
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0


@dataclass(frozen=True)
class ArchConfig:
    """A complete architecture description.

    Attention kinds:
      ``global``        full causal attention in every layer
      ``local_global``  alternating sliding-window / global (gemma2)
      ``sliding``       sliding-window attention in every layer (hymba attn part)
      ``mla``           multi-head latent attention (deepseek-v2)
      ``none``          no attention (pure recurrent, xlstm)
    Families: dense | moe | hybrid | vlm | audio | ssm
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0               # 0 -> d_model // n_heads
    attn_kind: str = "global"
    window: int = 4096              # sliding-window size where applicable
    attn_logit_softcap: float = 0.0   # 0 disables (gemma2: 50.0)
    final_logit_softcap: float = 0.0  # (gemma2: 30.0)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU)
    tie_embeddings: bool = True

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # encoder-decoder (seamless): n_layers is the decoder depth
    enc_dec: bool = False
    n_enc_layers: int = 0

    # multimodal stubs: the frontend supplies precomputed embeddings
    n_patches: int = 0              # vlm: image patch embeddings per sample
    n_frames: int = 0               # audio: frames fed to the encoder

    # numerics
    dtype: str = "bfloat16"
    # sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Total parameter count (embedding included once if tied)."""
        from repro_torch.models.accounting import count_params

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.accounting import count_params

        return count_params(self, active_only=True)

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        changes = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=128,
            window=16,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            n_frames=min(self.n_frames, 16) if self.n_frames else 0,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, n_shared=min(self.moe.n_shared, 1),
                d_ff_expert=32,
            )
        if self.mla is not None:
            changes["mla"] = MLAConfig(
                kv_lora_rank=16, q_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16,
            )
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(self.ssm, state_dim=4, conv_width=2)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One (seq_len, global_batch) evaluation cell.

    ``kind``: train | prefill | decode.  Decode shapes lower ``serve_step``
    (one new token against a KV cache of ``seq_len``), not ``train_step``.
    """

    name: str
    seq_len: int
    global_batch: int
    kind: str


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention; full-attention archs skip it."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, (
            "long_500k skipped: full (quadratic) attention arch; run only for "
            "SSM/hybrid/sliding-window archs (DESIGN.md §4)"
        )
    return True, ""


def reduced_shape(shape: ShapeConfig) -> ShapeConfig:
    return ShapeConfig(shape.name + "_reduced", min(shape.seq_len, 32),
                       min(shape.global_batch, 2), shape.kind)
