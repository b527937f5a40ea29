"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000, RG-LRU + local attention 1:2 (every third
block is window-2048 attention), temporal conv k=4. A copy of
``repro.configs.recurrentgemma_9b``. [arXiv:2402.19427; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    mlp="geglu",
    rope_theta=1e4,
    hybrid_pattern=3,
    lru_width=4096,
    local_window=2048,
    ssm_conv_kernel=4,
    uses_stencil_kernel=True,
)
