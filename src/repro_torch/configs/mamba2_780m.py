"""mamba2-780m [ssm] — 48L d_model=1536, attention-free SSD
(state-space duality), ssm_state=128, vocab=50280, depthwise causal
conv k=4 (on the card: ``csrc/conv1d_depthwise.cu``). A copy of
``repro.configs.mamba2_780m``. [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_kernel=4,
    ssm_chunk=256,
    ssm_n_groups=1,
    uses_stencil_kernel=True,
)
