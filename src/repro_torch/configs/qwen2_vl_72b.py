"""qwen2-vl-72b [arXiv:2409.12191; hf] — M-RoPE, dynamic-resolution VLM.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. The vision frontend
(ViT) is a STUB per the assignment: input_specs provide precomputed patch
embeddings [B, T, d_model] plus 3-D M-RoPE position ids (t, h, w); sections
(16, 24, 24) over head_dim/2 = 64 per the published config. qkv biases on.
"""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="dense",
    modality="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    attn_bias=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
))
