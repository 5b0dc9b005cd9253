"""qwen3-8b [hf:Qwen/Qwen3-8B] — qk-norm, GQA.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936, head_dim 128,
qk RMS-norm, rope_theta 1e6.
"""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
))
