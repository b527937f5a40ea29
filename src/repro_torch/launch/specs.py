"""Input specs (port of ``repro.launch.specs``): stand-ins for every
model input of an (arch, shape) cell, and the abstract parameter,
optimizer-state and decode-cache trees, all tensors on the ``meta``
device: the reference's shapes and dtypes, no storage allocated, so the
dry run (``launch.dryrun``) never materializes a weight.

The reference's ``jax.ShapeDtypeStruct`` stand-ins become meta tensors,
and ``jax.eval_shape`` becomes the model code run on them. One dtype
differs, once, here: the reference's token ids, labels and M-RoPE
positions are ``int32``, the port's :data:`INDEX` ``int64`` (the index
type of ``torch.nn.functional.embedding`` and ``gather``); every other
dtype is the reference's.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.registry import ShapeSpec, get_config, get_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptState, adamw_init

# The port's index type, where the reference's is int32.
INDEX = torch.int64
BF16 = torch.bfloat16


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _vlm_extras(cfg: ModelConfig, b: int, s: int) -> dict[str, Any]:
    if cfg.family != "vlm":
        return {}
    return {"patch_embeds": _meta((b, cfg.n_patches, cfg.d_model), BF16),
            "positions": _meta((3, b, s), INDEX)}


def train_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, Any]:
    """{tokens, labels, ...} for one global training batch (whisper's
    target of ``max_target_len`` tokens and its encoder frames)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        return {
            "tokens": _meta((b, cfg.max_target_len), INDEX),
            "labels": _meta((b, cfg.max_target_len), INDEX),
            "frames": _meta((b, cfg.encoder_seq, cfg.d_model), BF16),
        }
    return {"tokens": _meta((b, s), INDEX), "labels": _meta((b, s), INDEX),
            **_vlm_extras(cfg, b, s)}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeSpec
                        ) -> dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        return {"frames": _meta((b, cfg.encoder_seq, cfg.d_model), BF16),
                "tokens": _meta((b, cfg.max_target_len), INDEX)}
    return {"tokens": _meta((b, s), INDEX), **_vlm_extras(cfg, b, s)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeSpec
                       ) -> dict[str, Any]:
    """One new token against a seq_len-deep cache (serve_step)."""
    del cfg
    return {"tokens": _meta((shape.global_batch, 1), INDEX)}


def abstract_params(cfg: ModelConfig) -> Any:
    """The model's parameter tree on meta (its family's
    ``abstract_params``)."""
    return get_model(cfg).abstract_params(cfg)


def abstract_opt_state(params_abs: Any) -> OptState:
    """AdamW's state beside ``params_abs``: an int32 step and float32
    moments, on meta."""
    return adamw_init(params_abs)


def abstract_decode_cache(cfg: ModelConfig, shape: ShapeSpec) -> Any:
    """``init_decode_cache`` for the shape's batch and ``seq_len`` on
    meta (whisper's, whose cache holds the cross K/V, from meta encoder
    outputs of ``encoder_seq`` frames)."""
    b = shape.global_batch
    if cfg.is_encdec:
        from repro_torch.models import encdec

        return encdec.init_decode_cache(
            abstract_params(cfg), cfg,
            _meta((b, cfg.encoder_seq, cfg.d_model), BF16))
    return get_model(cfg).init_decode_cache(cfg, b, shape.seq_len,
                                            device="meta")


def input_specs(arch_id: str, shape: ShapeSpec) -> dict[str, Any]:
    """All model inputs for (arch, shape)."""
    cfg = get_config(arch_id)
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
