"""qwen2-vl-7b [vlm] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE; dynamic-resolution vision frontend STUBBED —
input_specs provides patch embeddings + (3, b, s) M-RoPE position
streams. A copy of
``repro.configs.qwen2_vl_7b``. [arXiv:2409.12191; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    mlp="swiglu",
    rope_style="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    n_patches=256,
)
