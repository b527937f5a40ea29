"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, QKV bias. FSDP enabled: replicated f32 master params +
Adam states would exceed per-chip HBM. A copy of
``repro.configs.qwen2_5_14b``. [hf:Qwen/Qwen2.5-14B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1e6,
)

FSDP = True
