"""xLSTM-125M — recurrent LM with alternating sLSTM and mLSTM blocks.
[arXiv:2405.04517; unverified]

12L d_model=768 4H vocab=50304, d_ff=0 (no separate FFN: the blocks contain
their own up/down projections — mLSTM proj factor 2, sLSTM proj factor 4/3).
Pure recurrent (no attention) -> sub-quadratic, runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    attn_kind="none",
    ssm=SSMConfig(state_dim=16, conv_width=4,
                  mlstm_proj_factor=2.0, slstm_proj_factor=4.0 / 3.0),
    act="gelu",
    tie_embeddings=True,
    subquadratic=True,
)
