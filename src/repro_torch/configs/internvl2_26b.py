"""InternVL2-26B — VLM: InternViT frontend (STUB) + InternLM2-20B backbone.
[arXiv:2404.16821; hf]

Backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
Per the assignment spec the modality frontend is a stub: ``input_specs()``
provides precomputed patch embeddings [B, n_patches, d_model] which the
backbone consumes as a prefix.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    attn_kind="global",
    n_patches=256,                  # 448x448 / 28px patches after pixel-shuffle
    act="silu",
    tie_embeddings=False,
    subquadratic=False,
)
