"""Hymba-1.5B — hybrid LM: parallel attention + mamba heads in every block.
[arXiv:2411.13676; hf]

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Attention heads use a sliding window (the HF model keeps 3 global layers; we
use sliding-window everywhere so the stack is uniform and the arch is
sub-quadratic, per the long_500k requirement for hybrids).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_kind="sliding",
    window=1024,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2.0),
    act="silu",
    tie_embeddings=True,
    subquadratic=True,
)
