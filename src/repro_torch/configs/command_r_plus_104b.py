"""Cohere Command R+ (104B) — dense decoder LM.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000 — GQA, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    attn_kind="global",
    qkv_bias=False,
    rope_theta=75_000.0,
    act="silu",
    tie_embeddings=True,
    subquadratic=False,
)
