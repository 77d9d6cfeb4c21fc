"""Gemma 2 9B — dense decoder LM with alternating local/global attention and
logit soft-capping.  [arXiv:2408.00118; hf]

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    attn_kind="local_global",   # even layers sliding-window, odd layers global
    window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
    subquadratic=False,         # half the layers are global -> still quadratic
)
