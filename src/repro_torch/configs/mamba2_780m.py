"""mamba2-780m [arXiv:2405.21060; unverified] — SSD (state-space duality).

48L d_model=1536 attn-free, vocab=50280, ssm_state=128, head_dim 64,
expand 2 → d_inner 3072 → 48 SSD heads.
"""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
))
