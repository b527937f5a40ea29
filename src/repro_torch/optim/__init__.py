"""Optimizer (port of ``repro.optim``): AdamW, LR schedules, global-norm
clipping."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)
