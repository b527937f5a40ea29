"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias. A copy of
``repro.configs.qwen2_5_3b``. [hf:Qwen/Qwen2.5-3B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1e6,
    tie_embeddings=True,
)
