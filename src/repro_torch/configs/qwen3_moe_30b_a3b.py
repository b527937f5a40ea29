"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4)
expert d_ff=768 vocab=151936, 128 experts top-8, head_dim=128, QK-norm.
A copy of ``repro.configs.qwen3_moe_30b_a3b``. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab=151936,
    qk_norm=True,
    mlp="swiglu",
    rope_theta=1e6,
    n_experts=128,
    top_k=8,
    d_ff_expert=768,
)
