"""mistral-nemo-12b [hf:mistralai/Mistral-Nemo-Base-2407; hf] — 128k ctx.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072; head_dim is an
explicit 128 (q_dim 4096 != d_model), rope_theta 1e6.
"""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1_000_000.0,
))
