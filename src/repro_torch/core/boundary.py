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
matches the reference element for element, at any radius.

Any ghost fill caps the wall accuracy at its own order. To keep the
FULL interior order up to the wall, :func:`derivative_matrix_1d` builds
boundary-MODIFIED weight rows: within ``r`` cells of a non-periodic
face the centered stencil is replaced by an offset (one-sided) stencil
of the same order on interior samples only
(``repro_torch.core.stencil.offset_difference_coeffs``).
:func:`apply_operator_set_bc` evaluates a whole generated operator set
that way, as dense contractions on the field's device (float64 sums,
rounded once to the field's dtype); the fusion layer writes it over the
wall-adjacent cells of the kernel's output
(``FusedStencilOp(boundary_weights=True)``), evaluating only those
cells (``rows``).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.stencil import (
    central_difference_coeffs,
    offset_difference_coeffs,
)

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


# ---------------------------------------------------------------------------
# Boundary-modified weight rows (the full-order alternative to ghost
# fills near non-periodic surfaces).
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def derivative_matrix_1d(
    n: int,
    deriv: int,
    accuracy: int,
    spacing: float = 1.0,
    mode: str = "dirichlet",
) -> np.ndarray:
    """Dense ``(n, n)`` derivative matrix with boundary-modified rows.

    Interior rows (``r ≤ i < n − r``) carry the centered Fornberg
    weights of the requested ``accuracy``; for ``mode="periodic"`` the
    off-grid columns wrap, and for any non-periodic mode the first/last
    ``r`` rows are OFFSET stencils of the same nominal order: row
    ``i < r`` reads columns ``0..deriv+accuracy−1`` with the evaluation
    point at position ``i``, and symmetrically at the high wall. Offset
    rows use no ghost data, so every non-periodic mode shares one table.

    Rows scale by ``spacing**-deriv``; ``deriv=0`` is the identity. The
    cached array is shared: do not write to it.

    Raises:
        ValueError: for an unknown mode, or a grid too small to hold
            the stencil.
    """
    if mode not in _MODES:
        raise ValueError(
            f"unknown boundary mode {mode!r}; want one of {_MODES}"
        )
    if deriv == 0:
        return np.eye(n)
    center = central_difference_coeffs(deriv, accuracy)
    r = (len(center) - 1) // 2
    scale = float(spacing) ** (-deriv)
    D = np.zeros((n, n))
    if mode == "periodic":
        if n < len(center):
            raise ValueError(
                f"periodic grid of {n} points cannot hold the "
                f"{len(center)}-tap centered stencil"
            )
        for i in range(n):
            for k, w in enumerate(center, start=-r):
                D[i, (i + k) % n] += w * scale
        return D
    npts = deriv + accuracy
    if n < npts:
        raise ValueError(
            f"non-periodic grid of {n} points cannot hold the "
            f"{npts}-point offset stencil (deriv={deriv}, "
            f"accuracy={accuracy})"
        )
    for i in range(n):
        if r <= i < n - r:
            for k, w in enumerate(center, start=-r):
                D[i, i + k] += w * scale
        else:
            # Offset row: window pinned inside the domain, evaluation
            # point at `left` within it.
            left = i if i < r else i - (n - npts)
            w = offset_difference_coeffs(deriv, accuracy, left)
            D[i, i - left:i - left + npts] = np.asarray(w) * scale
    return D


@lru_cache(maxsize=128)
def _matrix_rows(
    n: int, deriv: int, accuracy: int, spacing: float, mode: str,
    rows: tuple[int, ...] | None, dtype: torch.dtype, device: torch.device,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """``(cols, D[rows][:, cols])`` on ``device``: the ``rows`` of
    :func:`derivative_matrix_1d` (``None``: all of them) cut to the
    columns ``cols`` they read (``None``: all), each weight rounded to
    ``dtype`` (the field's, as the reference's are) and held in float64;
    kept so a step copies no matrix to the card."""
    D = derivative_matrix_1d(n, deriv, accuracy, spacing, mode)
    cols = None
    if rows is not None:
        D = D[list(rows)]
        read = np.flatnonzero(np.abs(D).sum(axis=0))
        if read.size < n:
            D = D[:, read]
            cols = torch.as_tensor(read, device=device)
    D = torch.as_tensor(D, dtype=dtype)
    return cols, D.to(device=device, dtype=torch.float64)


@lru_cache(maxsize=128)
def device_index(rows: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``rows`` as an index tensor on ``device``, kept: a copy from the
    host's pageable memory would wait for the card's queue to drain."""
    return torch.as_tensor(rows, device=device)


def _apply_matrix(
    f: torch.Tensor, D: torch.Tensor, axis: int
) -> torch.Tensor:
    """Contract ``D`` (rows×cols) against ``f`` along ``axis``."""
    g = torch.tensordot(f, D, dims=([axis], [1]))
    return torch.movedim(g, -1, axis)


def apply_operator_spec(
    f: torch.Tensor,
    spec,
    mode: str | Sequence[str],
    *,
    spatial_axes: Sequence[int] | None = None,
    rows: tuple[int, Sequence[int]] | None = None,
) -> torch.Tensor:
    """Evaluate one :class:`~repro_torch.core.stencil.OperatorSpec` on
    the UNPADDED field with boundary-modified weight rows.

    Each term's per-axis derivative is a dense
    :func:`derivative_matrix_1d` contraction along that spatial axis on
    ``f``'s device; terms are summed with their coefficients. The
    weights are rounded to ``f``'s dtype, as the reference's are, but
    products and sums run in float64 and the result is rounded once to
    ``f``'s dtype: an offset row sums terms up to ~1e4 times its result
    (order 4 at h = 1/15), so in float32 the summation order alone moves
    a wall cell by ~5e-4 and the MMS slope by ±0.5. ``mode`` is scalar
    or per spatial axis; ``spatial_axes`` defaults to all of ``f``'s
    axes.

    ``rows = (a, indices)`` evaluates only the output rows ``indices``
    (ascending) along spatial axis ``a`` (an index into
    ``spatial_axes``): the result has ``len(indices)`` entries there and
    equals those rows of the whole evaluation up to summation order.
    That axis is contracted first, with the matrix rows cut to the
    columns they read, so the wall slabs cost O(slab) and not O(domain).
    """
    axes = (
        tuple(range(f.ndim))
        if spatial_axes is None
        else tuple(spatial_axes)
    )
    modes = _normalize_modes(mode, len(axes))
    cut, picked = (None, None) if rows is None else (
        rows[0], tuple(int(i) for i in rows[1]))
    first: dict[int, torch.Tensor] = {}  # the cut axis's result by deriv

    def h_of(a):
        return float(spec.spacing[a]) if spec.spacing else 1.0

    def along_cut(d: int) -> torch.Tensor:
        if d not in first:
            if d == 0:
                g = f.index_select(axes[cut], device_index(picked, f.device))
                first[d] = g.double()
            else:
                cols, D = _matrix_rows(
                    int(f.shape[axes[cut]]), d, int(spec.accuracy),
                    h_of(cut), modes[cut], picked, f.dtype, f.device,
                )
                g = f if cols is None else f.index_select(axes[cut], cols)
                first[d] = _apply_matrix(g.double(), D, axes[cut])
        return first[d]

    whole = f.double() if cut is None else None
    out = None
    for dmi, coeff in spec.terms:
        if len(dmi) != len(axes):
            raise ValueError(
                f"term multi-index {dmi} does not match {len(axes)} "
                "spatial axes"
            )
        if any(dmi) and not spec.accuracy:
            raise ValueError(
                "OperatorSpec with derivative terms must carry a "
                "nonzero accuracy order for boundary-modified "
                "evaluation"
            )
        term = whole if cut is None else along_cut(int(dmi[cut]))
        for a, d in enumerate(dmi):
            if d == 0 or a == cut:
                continue
            _, D = _matrix_rows(
                int(f.shape[axes[a]]), int(d), int(spec.accuracy), h_of(a),
                modes[a], None, f.dtype, f.device,
            )
            term = _apply_matrix(term, D, axes[a])
        term = coeff * term
        out = term if out is None else out + term
    if out is None:
        raise ValueError("OperatorSpec has no terms")
    return out.to(f.dtype)


def apply_operator_set_bc(
    f: torch.Tensor,
    ops,
    mode: str | Sequence[str],
    *,
    spatial_axes: Sequence[int] | None = None,
    rows: tuple[int, Sequence[int]] | None = None,
) -> dict[str, torch.Tensor]:
    """Boundary-accurate evaluation of a whole operator set: ``{name:
    derivative}`` on the UNPADDED field, each member through
    :func:`apply_operator_spec` (offset rows at non-periodic walls, wrap
    on periodic axes; ``rows`` as there) — the full-order counterpart of
    ``repro_torch.kernels.ref.apply_operator_set``.

    Raises:
        ValueError: for an operator without :class:`OperatorSpec`
            metadata (hand-built tap sets).
    """
    out = {}
    for s in ops.ops:
        if s.spec is None:
            raise ValueError(
                f"operator {s.name!r} has no OperatorSpec metadata — "
                "boundary-modified weights need the generated "
                "(derivative, accuracy, spacing) description, not raw "
                "taps; build it with axis_stencil/laplacian_stencil/"
                "derivative_operator_set"
            )
        out[s.name] = apply_operator_spec(
            f, s.spec, mode, spatial_axes=spatial_axes, rows=rows
        )
    return out
