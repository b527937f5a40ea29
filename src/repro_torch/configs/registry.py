"""Registry (port of ``repro.configs.registry``): arch lookup, the
input-shape grid, reduced smoke-test configs and the model API.

Only mamba2-780m is ported; the reference's other nine architectures
raise ``NotImplementedError`` naming ROADMAP A13. The model API has no
``lm_loss``: training waits for A13 too.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, NamedTuple

from repro_torch.models.config import ModelConfig

# The reference's architectures (``repro.configs.registry.ARCH_MODULES``).
ARCH_IDS = (
    "qwen2.5-3b", "qwen2.5-14b", "gemma-2b", "llama3-8b", "mixtral-8x7b",
    "qwen3-moe-30b-a3b", "qwen2-vl-7b", "recurrentgemma-9b",
    "whisper-small", "mamba2-780m",
)
# Those the port has, with their module under ``repro_torch.configs``.
ARCH_MODULES = {"mamba2-780m": "mamba2_780m"}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _not_ported(arch_id: str) -> NotImplementedError:
    return NotImplementedError(
        f"{arch_id} is not ported yet: ROADMAP A13 (the dense, MoE, "
        "hybrid and encoder-decoder models); the port has "
        f"{sorted(ARCH_MODULES)}"
    )


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; want one of {ARCH_IDS}")
    if arch_id not in ARCH_MODULES:
        raise _not_ported(arch_id)
    mod = importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[arch_id]}"
    )
    return mod.CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Same family/topology, toy sizes: a few layers, narrow width, tiny
    vocab (the reference's rules for the ssm family; the other families'
    come with their ROADMAP A13 slices)."""
    if cfg.family != "ssm":
        raise _not_ported(f"reduced_config for {cfg.arch_id}")
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        vocab=512,
        dtype="float32",
        remat="none",
        ssm_state=16,
        ssm_head_dim=8,
        ssm_chunk=16,
    )


class ModelAPI(NamedTuple):
    init_params: Callable
    forward: Callable
    init_decode_cache: Callable
    decode_step: Callable


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "ssm":
        from repro_torch.models import ssm as m

        return ModelAPI(
            m.init_params, m.forward, m.init_decode_cache, m.decode_step,
        )
    raise _not_ported(f"the {cfg.family!r} family ({cfg.arch_id})")
