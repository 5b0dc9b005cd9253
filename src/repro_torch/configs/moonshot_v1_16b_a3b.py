"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B; hf] — 64e top-6.

48L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=163840, MoE 64e top-6.
(The published model keeps its first layer dense; the stack is kept uniform,
as the reference config keeps it.)
"""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    vocab=163840,
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
))
