"""Dispatch of a fused stencil call to its regime (port of
``repro.kernels.ops.fused_stencil_nd``/``plan_for_nd``), and of the 1-D
cross-correlation (``repro.kernels.ops.xcorr1d``).

``hwc`` goes to the plain PyTorch version (``ref``); ``swc``,
``swc_stream`` and ``tc`` go to their CUDA kernels through
:class:`~repro_torch.kernels.plan.StencilPlan` and
``emit.fused_stencil_swc``; the cross-correlation's ``baseline``,
``pointwise`` and ``elementwise`` go to ``csrc/xcorr1d.cu`` through
``xcorr1d.xcorr1d_cuda``; mamba2's depthwise causal conv goes to
``csrc/conv1d_depthwise.cu`` through
``conv1d_depthwise.conv1d_depthwise_cuda``. Every reference option whose
kernel is not ported yet raises ``NotImplementedError`` naming its
ROADMAP item.

Block parameters accept ``"auto"``, resolved through the tuner
(``repro_torch.tuning.session``): the persistent per-device cache on a
hit; on a miss the Hopper cost model's candidates, timed on the card
(the model's winner for a CPU tensor), the winner persisted.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import dtype_name
from repro_torch.core.stencil import OperatorSet
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.conv1d_depthwise import (
    DEFAULT_BLOCK_SEQ,
    conv1d_depthwise_cuda,
)
from repro_torch.kernels.emit import TapTable, fused_stencil_swc
from repro_torch.kernels.phi import DevicePhi
from repro_torch.kernels.plan import (
    MAX_THREADS,
    StencilPlan,
    is_ensemble,
    plan_stencil,
)
from repro_torch.kernels.xcorr1d import xcorr1d_cuda


def xcorr1d(
    f_padded: torch.Tensor,
    g: torch.Tensor,
    *,
    strategy: str = "baseline",
    block_size: int | str = 2048,
    unroll: int = 4,
) -> torch.Tensor:
    """1-D cross-correlation over the valid region (paper Eq. 3):
    ``f_padded`` (n + 2r,) and ``g`` (2r + 1,) give (n,), f'_i = Σ_j g_j
    f̂_{i+j}.

    Accepts any n (the kernel masks the ragged last block).
    ``strategy='hwc'`` is the plain PyTorch version; ``baseline``,
    ``pointwise`` and ``elementwise`` launch ``csrc/xcorr1d.cu`` on a
    CUDA tensor (float32, float64, bfloat16 or float16, any ``unroll``)
    and take the plain version on a CPU tensor. An unknown strategy, or ``elementwise`` with a
    ``block_size`` that ``unroll`` does not divide, raises
    ``ValueError``; ``block_size="auto"`` resolves through the tuner
    (``tuning.session.auto_block_xcorr1d``).
    """
    if strategy == "hwc":
        return _ref.xcorr1d(f_padded, g)
    if block_size == "auto":
        from repro_torch.tuning.session import auto_block_xcorr1d

        block_size = auto_block_xcorr1d(
            f_padded, g, strategy=strategy, unroll=unroll
        )
    return xcorr1d_cuda(
        f_padded, g, strategy=strategy, block_size=block_size, unroll=unroll
    )


def conv1d_depthwise(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    activation: str = "none",
    block_seq: int | str | None = None,
) -> torch.Tensor:
    """Fused depthwise causal conv1d (+ SiLU) — mamba2 frontend stencil:
    ``x`` (b, s, c) and ``w`` (k, c) give (b, s, c).

    Any s (the kernel masks the ragged last run). ``block_seq=None``
    (model call sites) is 512, the reference's default, unless the tuner
    is globally enabled (``tuning.session.enable_auto()``, the serve
    drivers' ``--auto-tune``): then it resolves like ``"auto"``, through
    ``tuning.session.auto_block_conv1d``. On a CUDA tensor it launches
    ``csrc/conv1d_depthwise.cu`` (float32, float64, bfloat16 or float16,
    any k >= 1); on a CPU tensor it takes the plain version. When a gradient is wanted it goes
    through ``conv1d_depthwise.Conv1dDepthwise`` (the same forward, the
    plain version's gradient).
    """
    if block_seq is None:
        from repro_torch.tuning import session

        block_seq = "auto" if session.AUTO_ENABLED else DEFAULT_BLOCK_SEQ
    if block_seq == "auto":
        from repro_torch.tuning.session import auto_block_conv1d

        block_seq = auto_block_conv1d(x, w, activation=activation)
    return conv1d_depthwise_cuda(
        x, w, activation=activation, block_seq=block_seq
    )


def fused_stencil_nd(
    f_padded: torch.Tensor,
    ops: OperatorSet,
    phi: Callable[..., torch.Tensor],
    n_out: int,
    *,
    aux: torch.Tensor | None = None,
    strategy: str = "swc",
    block: tuple[int, ...] | str | None = None,
    unroll: int = 1,
    fuse_steps: int = 1,
    taps: TapTable | None = None,
) -> torch.Tensor:
    """Fused φ(A·B) over a padded (n_f, *spatial) domain of rank 1-3
    (paper Eq. 9).

    ``strategy``: ``"hwc"`` (plain PyTorch), ``"swc"`` (the CUDA
    kernels), ``"swc_stream"`` (the CUDA kernel that walks the slowest
    axis — z at rank 3, y at rank 2 — carrying its halo planes from chunk
    to chunk; ranks 2 and 3, no aux, no unroll) or ``"tc"`` (the
    derivatives as banded contractions on the tensor cores; float32 or
    bfloat16, no unroll, any rank, depth, batch and aux); on the CUDA
    strategies ``phi`` must be a
    :class:`~repro_torch.kernels.phi.DevicePhi`.
    ``block`` is a rank-length tile, ``None`` for the per-rank
    default, or ``"auto"`` (the tuner: ``tuning.session.auto_block_nd``);
    on ``swc_stream`` ``block[0]`` is the chunk (planes per step of the
    walk) and ``block[1:]`` the cross-stream tile, and the planner
    shrinks both until the working set fits shared memory.

    ``fuse_steps`` is the temporal depth: ``f_padded`` is padded by
    ``radius * fuse_steps`` (and ``aux``, if any, by ``radius *
    (fuse_steps - 1)``), the op is applied that many times in one call
    (one launch on ``swc``), and ``phi`` may be a sequence of per-step
    maps (of one ``DevicePhi`` kind on ``swc``).

    An ensemble operand is detected by rank: ``f_padded`` of shape
    (batch, n_f, *spatial_padded), ``ops.ndim + 2`` axes, goes through
    one launch of the same kernel with the member as an outer grid index
    (``hwc``: the batched plain versions); ``aux`` then carries the same
    leading axis. Returns (batch, n_out, *interior).
    """
    if strategy == "hwc":
        if is_ensemble(ops.ndim, f_padded.ndim):
            if fuse_steps == 1:
                return _ref.fused_stencil_batched(f_padded, ops, phi, aux=aux)
            return _ref.fused_stencil_steps_batched(
                f_padded, ops, phi, fuse_steps, aux=aux
            )
        if fuse_steps == 1:
            return _ref.fused_stencil(f_padded, ops, phi, aux=aux)
        return _ref.fused_stencil_steps(
            f_padded, ops, phi, fuse_steps, aux=aux
        )
    if block == "auto":
        from repro_torch.tuning.session import auto_block_nd

        block = auto_block_nd(
            f_padded, ops, phi, n_out, aux=aux, strategy=strategy,
            unroll=unroll, fuse_steps=fuse_steps, taps=taps,
        )
    plan = plan_for_nd(
        ops, tuple(f_padded.shape), n_out,
        aux_shape=None if aux is None else tuple(aux.shape),
        strategy=strategy, block=block, dtype=dtype_name(f_padded.dtype),
        unroll=unroll, fuse_steps=fuse_steps,
        max_threads=_max_threads_of(phi), n_slots=_slots_of(phi),
    )
    return fused_stencil_swc(f_padded, ops, phi, plan, aux=aux, taps=taps)


def plan_for_nd(
    ops: OperatorSet,
    padded_shape: tuple[int, ...],
    n_out: int,
    *,
    aux_shape: tuple[int, ...] | None = None,
    strategy: str = "swc",
    block: tuple[int, ...] | None = None,
    dtype: str = "float32",
    unroll: int = 1,
    fuse_steps: int = 1,
    max_threads: int = MAX_THREADS,
    n_slots: int = 1,
) -> StencilPlan | None:
    """The :class:`StencilPlan` a :func:`fused_stencil_nd` call with these
    arguments launches; ``None`` for ``strategy="hwc"``. ``max_threads``
    (the φ kind's limit) bounds the default tile; ``n_slots`` (the
    operators φ reads) sizes ``tc``'s operator sums. A (batch, n_f,
    *padded) shape plans a batched launch; ``aux_shape`` then has the
    leading member axis too. ``block="auto"`` raises ``ValueError``:
    resolve it through the tuner first."""
    if strategy == "hwc":
        return None
    if block == "auto":
        raise ValueError(
            "plan_for_nd needs a concrete block — resolve 'auto' through "
            "repro_torch.tuning first"
        )
    n_aux = 0
    if aux_shape is not None:
        n_aux = aux_shape[1 if is_ensemble(ops.ndim, len(padded_shape)) else 0]
    return plan_stencil(
        ops, padded_shape, n_out, strategy=strategy, block=block,
        dtype=dtype, n_aux=n_aux, unroll=unroll, fuse_steps=fuse_steps,
        max_threads=max_threads, n_slots=n_slots,
    )


def _max_threads_of(phi) -> int:
    """Threads-per-block limit of the kernel that runs ``phi`` (or the
    first φ of a per-step sequence)."""
    if isinstance(phi, (tuple, list)) and phi:
        phi = phi[0]
    return phi.max_threads if isinstance(phi, DevicePhi) else MAX_THREADS


def _slots_of(phi) -> int:
    """Operators the kernel evaluates for ``phi`` (or the first φ of a
    per-step sequence)."""
    if isinstance(phi, (tuple, list)) and phi:
        phi = phi[0]
    return len(phi.operators) if isinstance(phi, DevicePhi) else 1
