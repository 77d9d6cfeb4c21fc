"""DeepSeek-V2 (236B) — MoE decoder LM with Multi-head Latent Attention.
[arXiv:2405.04434; hf]

60L d_model=5120 128H (MLA kv_lora=512) d_ff=1536 (per expert)
vocab=102400, MoE 2 shared + 160 routed, top-6.

Deviation from the HF checkpoint: the real model's first layer is a dense FFN;
all 60 layers are MoE here, so the layer stack is uniform (one
``[L]``-stacked tree).  Parameter count changes by <0.1%.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,                 # MLA: latent KV shared by all heads
    head_dim=128,
    d_ff=1536,                      # per-expert hidden
    vocab_size=102400,
    attn_kind="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536),
    act="silu",
    tie_embeddings=False,
    subquadratic=False,
)
