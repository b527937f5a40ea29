"""Step makers for serving (port of ``repro.launch.steps``):
``make_prefill_step`` and ``make_serve_step``.

PyTorch runs eagerly, so there is no jit or sharding assembly; the
train step waits for ROADMAP A13. Each maker fixes the device its
step runs on (the card by default; it raises without one unless the
caller passes ``device="cpu"``) and refuses tokens elsewhere.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_model
from repro_torch.models.config import ModelConfig


def _tokens_on(batch: dict, device: torch.device) -> torch.Tensor:
    tokens = batch["tokens"]
    if tokens.device != device:
        raise ValueError(
            f"tokens are on {tokens.device}; this step runs on {device}"
        )
    return tokens


def make_prefill_step(cfg: ModelConfig, *,
                      device: str | torch.device | None = None,
                      use_pallas_conv: bool | None = None):
    """``prefill_step(params, batch)`` → the last position's logits
    (b, vocab) in float32. ``use_pallas_conv`` goes to ``forward``
    (None: the B7 kernel on the card, the plain conv on the CPU)."""
    api = get_model(cfg)
    dev = resolve_device(device)

    def prefill_step(params, batch):
        logits, _ = api.forward(
            params, cfg, _tokens_on(batch, dev),
            use_pallas_conv=use_pallas_conv,
        )
        return logits[:, -1].float()

    return prefill_step


def make_serve_step(cfg: ModelConfig, *,
                    device: str | torch.device | None = None):
    """``serve_step(params, cache, batch)`` → (logits (b, vocab) float32,
    next cache): one decode step of ``batch["tokens"]`` (b, 1)."""
    api = get_model(cfg)
    dev = resolve_device(device)

    def serve_step(params, cache, batch):
        logits, cache = api.decode_step(
            params, cfg, _tokens_on(batch, dev), cache
        )
        return logits.float(), cache

    return serve_step
