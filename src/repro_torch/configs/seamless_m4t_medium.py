"""SeamlessM4T-medium — encoder-decoder multimodal (speech/text) transformer.
[arXiv:2308.11596; hf]

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.  We implement the
transformer BACKBONE only (12 encoder + 12 decoder layers); the speech
frontend is a stub supplying precomputed frame embeddings [B, n_frames, d].
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                    # decoder depth
    n_enc_layers=12,
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    attn_kind="global",
    n_frames=1024,                  # encoder frames fed by the stub frontend
    act="silu",
    tie_embeddings=True,
    subquadratic=False,
)
