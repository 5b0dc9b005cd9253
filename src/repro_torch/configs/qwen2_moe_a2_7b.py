"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 4 shared + 60 routed top-4.

24L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=151936, MoE 60e top-4,
shared-expert intermediate 4×1408=5632. 60 experts are padded to 64 on the
16-way model axis (EP divisibility) with -inf router logits — exact numerics.
"""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    vocab=151936,
    n_experts=60,
    top_k=4,
    moe_d_ff=1408,
    n_shared_experts=4,
    attn_bias=True,
))
