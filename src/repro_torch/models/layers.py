"""Model building blocks the port needs so far (port of
``repro.models.layers``): ``rms_norm``, ``dense_init`` and the training
loss ``token_xent``. The rest of the reference's layers (RoPE,
attention, MLPs, the KV cache) wait for the dense models (ROADMAP
A13)."""
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


def token_xent(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean next-token cross-entropy over the positions ``mask`` keeps
    (all when None): logsumexp of the float32 logits minus the gold
    logit. The gold logit is a ``gather``; the reference's iota compare
    and masked sum exist only to keep vocab-sharded logits sharded under
    GSPMD, and the port's logits lie whole on one card."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    if mask is None:
        mask = torch.ones_like(lse)
    mask = mask.float()
    return ((lse - gold) * mask).sum() / mask.sum().clamp_min(1.0)
