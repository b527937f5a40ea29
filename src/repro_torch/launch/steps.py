"""Step makers (port of ``repro.launch.steps``): ``make_train_step``
(with its gradient half, ``make_grad_step``), ``make_prefill_step`` and
``make_serve_step``.

PyTorch runs eagerly, so there is no jit, donation or sharding
assembly; the data-parallel train step waits for the next slice of
ROADMAP A13. Each maker fixes the device its step runs on (the card by
default; it raises without one unless the caller passes
``device="cpu"``) and refuses tokens elsewhere.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.tree import tree_map


def _tokens_on(batch: dict, device: torch.device) -> torch.Tensor:
    tokens = batch["tokens"]
    if tokens.device != device:
        raise ValueError(
            f"tokens are on {tokens.device}; this step runs on {device}"
        )
    return tokens


def make_grad_step(cfg: ModelConfig, *,
                   device: str | torch.device | None = None,
                   use_pallas_conv: bool | None = None):
    """``grad_step(params, batch)`` → (loss, metrics, grads): the
    reference's ``jax.value_and_grad(api.lm_loss, has_aux=True)``. The
    gradients (float32 for the float32 master parameters) come from one
    ``backward`` through leaves that alias ``params``; ``params`` is
    left as it was. ``use_pallas_conv`` goes to ``lm_loss`` (None: the
    B7 kernel on the card, the plain conv on the CPU)."""
    api = get_model(cfg)
    dev = resolve_device(device)

    def grad_step(params, batch):
        _tokens_on(batch, dev)
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = api.lm_loss(leaves, cfg, batch,
                                    use_pallas_conv=use_pallas_conv)
        loss.backward()
        grads = tree_map(lambda p: p.grad, leaves)
        return (loss.detach(),
                {k: v.detach() for k, v in metrics.items()}, grads)

    return grad_step


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    device: str | torch.device | None = None):
    """``train_step(params, opt_state, batch)`` → (params, opt_state,
    metrics): the gradient of ``lm_loss`` (:func:`make_grad_step`; the
    B7 kernel on the card), then one ``adamw_update``; metrics ``xent``,
    ``loss``, ``grad_norm`` and ``lr`` (tensors on the device, read by
    the caller when it wants)."""
    grad_step = make_grad_step(cfg, device=device)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grad_step(params, batch)
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, grads, opt_state, params
        )
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


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
