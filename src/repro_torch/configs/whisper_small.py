"""whisper-small [audio] — enc-dec 12+12L d_model=768 12H (MHA)
d_ff=3072 vocab=51865; the conv/mel frontend is stubbed (the inputs are
frame embeddings (b, 1500, 768)); no decode past the contract's 448
target tokens. A copy of ``repro.configs.whisper_small``.
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    rope_style="none",
    tie_embeddings=True,
    n_encoder_layers=12,
    encoder_seq=1500,
    max_target_len=448,
    uses_stencil_kernel=True,  # the conv frontend (stubbed) is a stencil
)
