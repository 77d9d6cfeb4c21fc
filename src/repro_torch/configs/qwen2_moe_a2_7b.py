"""Qwen1.5/2-MoE-A2.7B — MoE decoder LM: 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

24L d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert) vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,                      # per-expert hidden
    vocab_size=151936,
    attn_kind="global",
    qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_ff_expert=1408),
    act="silu",
    tie_embeddings=True,
    subquadratic=False,
)
