"""Registry (port of ``repro.configs.registry``): arch lookup, the
input-shape grid and the 40-cell (arch x shape) matrix with its
documented skips, reduced smoke-test configs and the model API, for all
ten of the reference's architectures: the dense transformers
(qwen2.5-3b, qwen2.5-14b, gemma-2b, llama3-8b), the MoE transformers
(mixtral-8x7b, qwen3-moe-30b-a3b), the VLM qwen2-vl-7b, mamba2-780m,
the hybrid recurrentgemma-9b and the encoder-decoder whisper-small.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, NamedTuple

from repro_torch.models.config import ModelConfig

# The reference's architectures, with their module under
# ``repro_torch.configs`` (``repro.configs.registry.ARCH_MODULES``).
ARCH_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen2.5-14b": "qwen2_5_14b",
    "gemma-2b": "gemma_2b",
    "llama3-8b": "llama3_8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-small": "whisper_small",
    "mamba2-780m": "mamba2_780m",
}

ARCH_IDS = tuple(ARCH_MODULES)


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


# Archs with sub-quadratic sequence mixing — the only ones that run
# long_500k (everything else would need a mechanism the model doesn't
# define). mixtral qualifies through its sliding window: ring-buffer
# decode is O(window), independent of context length.
SUBQUADRATIC = ("mamba2-780m", "recurrentgemma-9b", "mixtral-8x7b")


def _module(arch_id: str):
    if arch_id not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; want one of {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def uses_fsdp(arch_id: str) -> bool:
    return getattr(_module(arch_id), "FSDP", False)


def cell_status(arch_id: str, shape_name: str) -> str:
    """'run' or a documented skip reason for the 40-cell matrix (the
    reference's statuses, word for word)."""
    cfg = get_config(arch_id)
    shape = SHAPES[shape_name]
    if cfg.is_encdec:
        if shape.kind == "decode":
            return "skip: enc-dec short-form (max target 448) has no long decode"
        return "run"  # seq adapted to encoder contract, see input_specs
    if shape_name == "long_500k" and arch_id not in SUBQUADRATIC:
        return "skip: full quadratic attention at 524k — no sub-quadratic mechanism"
    return "run"


def all_cells() -> list[tuple[str, str, str]]:
    """(arch, shape, status) of every cell, arch-major."""
    return [(a, s, cell_status(a, s)) for a in ARCH_IDS for s in SHAPES]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Same family/topology, toy sizes: a few layers, narrow width, tiny
    vocab (the reference's rules)."""
    kw: dict[str, Any] = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        vocab=512,
        dtype="float32",
        remat="none",
    )
    if cfg.n_heads:
        ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
        kw["n_heads"] = min(cfg.n_heads, 4)
        kw["n_kv_heads"] = max(1, kw["n_heads"] // ratio)
        kw["head_dim"] = 16
    if cfg.d_ff:
        kw["d_ff"] = 128
    if cfg.family == "moe":
        kw["n_experts"] = min(cfg.n_experts, 8)
        kw["top_k"] = min(cfg.top_k, 2)
        kw["d_ff_expert"] = 96
    if cfg.family == "ssm":
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 8
        kw["ssm_chunk"] = 16
    if cfg.hybrid_pattern:
        kw["n_layers"] = 5  # 1 super-block (rec, rec, att) + 2 tail rec
        kw["lru_width"] = 64
        kw["local_window"] = 16
    if cfg.is_encdec:
        kw["n_encoder_layers"] = 2
        kw["n_layers"] = 2
        kw["encoder_seq"] = 32
        kw["max_target_len"] = 24
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    if cfg.n_patches:
        kw["n_patches"] = 8
    if cfg.rope_style == "mrope":
        kw["mrope_sections"] = (2, 3, 3)  # sums to head_dim // 2 = 8
    return dataclasses.replace(cfg, **kw)


class ModelAPI(NamedTuple):
    init_params: Callable
    lm_loss: Callable
    forward: Callable
    init_decode_cache: Callable
    decode_step: Callable
    abstract_params: Callable


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as m
    elif cfg.family == "ssm":
        from repro_torch.models import ssm as m
    elif cfg.family == "hybrid":
        from repro_torch.models import hybrid as m
    elif cfg.family == "audio":
        from repro_torch.models import encdec as m
    else:
        raise ValueError(cfg.family)
    return ModelAPI(
        m.init_params, m.lm_loss, m.forward,
        m.init_decode_cache, m.decode_step, m.abstract_params,
    )
