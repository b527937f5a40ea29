"""Registered shapes for cache pre-warming (port of
``repro.tuning.shapes``).

``python -m repro_torch.tuning warm`` drives every entry through the
real ``"auto"`` call sites, so the tuner measures (on the card) and the
winners persist, with the exact key derivation the hot paths use: warm
once, every later ``FusedStencilOp``/kernel call hits the cache. The
``--full`` extents are the main path's (``chip_smoke.py``): diffusion at
512³, 8192² and 2^26 (order 6), the MHD RHS at 256³ f32, B6 at 2^24
with r = 1024; the small ones run in seconds. A CPU device resolves
every entry by the model alone. (The reference's static-audit shapes
wait for the port's auditor, ROADMAP A12.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class WarmEntry:
    name: str
    run: Callable[[bool, object], None]  # run(full, device)


def _diffusion(shape, strategies, device) -> None:
    from repro_torch.physics.diffusion import DiffusionProblem

    p = DiffusionProblem(shape, accuracy=6)
    f0 = p.init_field(device=device)
    for strategy in strategies:
        if strategy == "auto":
            p.step_op("auto", fuse_steps="auto", device=device).resolved(f0)
        else:
            p.step_op(strategy, block="auto", device=device)(f0)


def _warm_diffusion3d(full: bool, device) -> None:
    _diffusion((512,) * 3 if full else (16, 16, 64),
               ("swc", "swc_stream", "tc", "auto"), device)


def _warm_diffusion2d(full: bool, device) -> None:
    _diffusion((8192, 8192) if full else (64, 128),
               ("swc", "swc_stream", "tc", "auto"), device)


def _warm_diffusion1d(full: bool, device) -> None:
    _diffusion((1 << 26,) if full else (1 << 14,), ("swc", "tc", "auto"),
               device)


def _warm_mhd(full: bool, device) -> None:
    from repro_torch.physics.mhd import MHDSolver

    n = 256 if full else 16
    solver = MHDSolver((n, n, n), strategy="auto", device=device)
    solver.rhs(solver.init_fields())


def _warm_xcorr1d(full: bool, device) -> None:
    from repro_torch import resolve_device
    from repro_torch.kernels import ops as kops

    device = resolve_device(device)
    n, radius = (1 << 24, 1024) if full else (1 << 16, 32)
    rng = np.random.default_rng(0)
    f = torch.as_tensor(rng.standard_normal(n + 2 * radius),
                        dtype=torch.float32, device=device)
    g = torch.as_tensor(rng.standard_normal(2 * radius + 1),
                        dtype=torch.float32, device=device)
    kops.xcorr1d(f, g, strategy="elementwise", block_size="auto")


def warm_model_kernels(cfg, batch: int, seq_len: int, dtype=None,
                       device=None) -> int:
    """Resolve the kernel blocks a model's hot path requests under
    ``--auto-tune`` (mamba2's depthwise conv; the other families launch
    no stencil kernel) at its (batch, seq_len) in its compute dtype, so
    the later steps hit the cache. Returns the number of shapes warmed.
    B7's ``block_seq`` changes nothing in its launch, so its record is
    the model's (``tuning.session.auto_block_conv1d``)."""
    if cfg.family != "ssm":
        return 0
    from repro_torch import as_dtype, resolve_device
    from repro_torch.kernels import ops as kops
    from repro_torch.models.ssm import _dims

    device = resolve_device(device)
    dtype = as_dtype(dtype or cfg.dtype)
    conv_ch = _dims(cfg)[-1]
    x = torch.zeros((batch, seq_len, conv_ch), dtype=dtype, device=device)
    w = torch.zeros((cfg.ssm_conv_kernel, conv_ch), dtype=dtype,
                    device=device)
    kops.conv1d_depthwise(x, w, block_seq="auto")
    return 1


def _warm_mamba2(full: bool, device) -> None:
    from repro_torch.configs.registry import get_config, reduced_config

    cfg = get_config("mamba2-780m")
    if not full:
        cfg = reduced_config(cfg)
    warm_model_kernels(cfg, 4, 8192 if full else 64, device=device)


REGISTRY: tuple[WarmEntry, ...] = (
    WarmEntry("diffusion3d/swc,swc_stream,tc,auto", _warm_diffusion3d),
    WarmEntry("diffusion2d/swc,swc_stream,tc,auto", _warm_diffusion2d),
    WarmEntry("diffusion1d/swc,tc,auto", _warm_diffusion1d),
    WarmEntry("mhd/auto", _warm_mhd),
    WarmEntry("xcorr1d/elementwise", _warm_xcorr1d),
    WarmEntry("mamba2/conv1d_depthwise", _warm_mamba2),
)
