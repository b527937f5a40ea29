"""Model building blocks the port needs so far (port of
``repro.models.layers``): ``rms_norm`` and ``dense_init``. The rest of
the reference's layers (RoPE, attention, MLPs, the KV cache) wait for
the dense models (ROADMAP A13)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a zero-centred gain: statistics and scaling in
    float32, the result in ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def dense_init(
    generator: torch.Generator,
    shape: tuple[int, ...],
    scale: float | None = None,
) -> torch.Tensor:
    """Normal float32 init scaled by fan_in^-1/2, drawn from ``generator``
    on its device. For stacked layer params (L, d_in, d_out) the fan-in
    is the SECOND-TO-LAST dim, not the layer axis."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else max(fan_in, 1) ** -0.5
    return torch.randn(shape, generator=generator,
                       device=generator.device) * scale
