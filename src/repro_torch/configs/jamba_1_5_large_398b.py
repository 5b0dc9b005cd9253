"""jamba-1.5-large-398b [arXiv:2403.19887; hf] — Mamba+attn 1:7, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536. Period of 8 layers:
1 attention (offset 4) + 7 mamba; MoE replaces the MLP every 2nd layer.
Published Jamba uses Mamba-1 mixers; the zoo uses its Mamba-2 SSD block
(d_state 16, conv 4, expand 2), as the reference config does.
"""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
))
