"""musicgen-large [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (MHA, kv=32) d_ff=8192 vocab=2048. The EnCodec audio
frontend is a STUB per the assignment: input_specs provide precomputed frame
embeddings [B, T, d_model]. MusicGen's backbone uses LayerNorm + GELU FFN.
"""
from repro_torch.configs.registry import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="dense",
    modality="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    mlp_act="gelu",
    norm_type="layernorm",
))
