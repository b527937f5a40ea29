"""Boundary value functions β(f, i) — paper Eq. 2 — as ghost-cell
padding (port of ``repro.core.boundary.pad``/``unpad``).

Modes and the accuracy order of their ghost fill near a wall:

* ``periodic``  — exact: the wrap IS the solution's continuation.
* ``dirichlet`` — constant ghost value (0th-order extrapolation).
* ``neumann``   — edge replicate, a FIRST-order zero-gradient fill.
* ``neumann2``  — mirror about the boundary NODE (ghost ``f(-h) =
  f(h)``), second-order zero gradient.
* ``reflect``   — the same even extension as ``neumann2``.

Each mode is a gather along one axis with an index map equal to
``numpy.pad``'s (``wrap``/``edge``/``reflect``), so the padded array
matches the reference element for element, at any radius. The
boundary-modified weight rows (``derivative_matrix_1d``,
``apply_operator_set_bc``) serve ``boundary_weights=True`` and wait for
a later slice.
"""
from __future__ import annotations

from typing import Sequence

import torch

_MODES = ("periodic", "dirichlet", "neumann", "neumann2", "reflect")


def _normalize_modes(
    mode: str | Sequence[str], n_axes: int
) -> tuple[str, ...]:
    """Per-axis mode tuple from a scalar or per-axis spec."""
    modes = (mode,) * n_axes if isinstance(mode, str) else tuple(mode)
    if len(modes) != n_axes:
        raise ValueError(
            f"got {len(modes)} boundary modes for {n_axes} spatial axes"
        )
    for m in modes:
        if m not in _MODES:
            raise ValueError(
                f"unknown boundary mode {m!r}; want one of {_MODES}"
            )
    return modes


def _ghost_index(
    n: int, r: int, mode: str, device: torch.device | None = None
) -> torch.Tensor:
    """Source index of every padded position ``-r .. n + r - 1``, built
    on ``device``: the map is as long as the axis (512 MB of int64 at
    2^26 points), too large to build on the host and copy at every
    pad."""
    i = torch.arange(-r, n + r, device=device)
    if mode == "periodic":
        return i % n
    if mode == "neumann":
        return i.clamp(0, n - 1)
    # neumann2 / reflect: numpy's "reflect" (mirror without repeating
    # the edge sample), periodic with period 2(n-1).
    if n == 1:
        return torch.zeros_like(i)
    m = 2 * (n - 1)
    j = i % m
    return torch.where(j < n, j, m - j)


def _pad_axis(
    f: torch.Tensor, axis: int, r: int, mode: str, value: float
) -> torch.Tensor:
    if r == 0:
        return f
    if mode == "dirichlet":
        shape = list(f.shape)
        shape[axis] = r
        ghost = torch.full(shape, value, dtype=f.dtype, device=f.device)
        return torch.cat([ghost, f, ghost], dim=axis)
    idx = _ghost_index(f.shape[axis], r, mode, f.device)
    return torch.index_select(f, axis, idx)


def pad(
    f: torch.Tensor,
    radius: int | Sequence[int],
    mode: str | Sequence[str] = "periodic",
    *,
    spatial_axes: Sequence[int] | None = None,
    value: float = 0.0,
) -> torch.Tensor:
    """Construct f̂ by padding ``f`` with ``radius`` ghost cells per
    spatial axis.

    ``spatial_axes`` defaults to all axes. ``radius`` may be per-axis,
    and so may ``mode`` (one entry per spatial axis). Axes are padded
    one after another, so corner ghost regions are filled by
    composition — what ``numpy.pad`` does for one mode, and the
    reference's treatment of mixed modes.
    """
    axes = tuple(range(f.ndim)) if spatial_axes is None else tuple(spatial_axes)
    modes = _normalize_modes(mode, len(axes))
    if isinstance(radius, int):
        radius = [radius] * len(axes)
    if len(radius) != len(axes):
        raise ValueError("radius/spatial_axes length mismatch")
    out = f
    for a, r, m in zip(axes, radius, modes):
        out = _pad_axis(out, a, int(r), m, value)
    return out


def unpad(
    f: torch.Tensor,
    radius: int | Sequence[int],
    *,
    spatial_axes: Sequence[int] | None = None,
) -> torch.Tensor:
    """Inverse of :func:`pad` — strip ghost cells."""
    axes = tuple(range(f.ndim)) if spatial_axes is None else tuple(spatial_axes)
    if isinstance(radius, int):
        radius = [radius] * len(axes)
    slicer: list[slice] = [slice(None)] * f.ndim
    for a, r in zip(axes, radius):
        slicer[a] = slice(int(r), f.shape[a] - int(r)) if r else slice(None)
    return f[tuple(slicer)]
