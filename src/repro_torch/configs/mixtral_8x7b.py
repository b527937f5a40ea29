"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, SWA 4096. Experts < mesh-model ⇒ the
sharding rules fall back to expert-TP. A copy of
``repro.configs.mixtral_8x7b``. [arXiv:2401.04088; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=0,
    vocab=32000,
    mlp="swiglu",
    rope_theta=1e6,
    sliding_window=4096,
    n_experts=8,
    top_k=2,
    d_ff_expert=14336,
)
