"""Method-of-manufactured-solutions (MMS) convergence harness (port of
``repro.verify.mms``).

Pick a smooth field f with a known Laplacian, evaluate the generated ∇²
operator through the SAME :class:`~repro_torch.core.fusion.FusedStencilOp`
pipeline production code uses (pad → plan → kernel → φ, any strategy),
and fit the slope of log(error) against log(h) over a grid refinement
sweep. A correct order-A pipeline shows slope ≈ A; a systematic defect
(wrong weights, a mis-scaled spacing, ghost cells reaching wall cells,
offset rows at the wrong seat, a kernel reading the wrong tap) bends the
slope away from nominal, which is why the fitted order, not a point-wise
tolerance, is the gate.

Manufactured fields:

* ``periodic`` — f = ∏ₐ sin(xₐ + φₐ) on [0, 2π)ʳ (x_j = j·2π/n), so
  ∇²f = −rank·f exactly and the wrap IS the continuation.
* ``dirichlet`` — f = ∏ₐ sin(ωₐ xₐ + φₐ) on the vertex-centered unit
  cube (h = 1/(n−1)), run with ``boundary_weights=True`` so the wall
  cells take the offset weight rows at full interior order.
* ``neumann`` / ``neumann2`` — f = ∏ₐ cos(π xₐ) (zero normal gradient
  at every wall), through the ghost FILL itself: the edge-replicate
  ``neumann`` fill is 1st order and caps the slope, the mirror
  ``neumann2`` fill releases the interior order.

The φ is ``select_phi("lap")``, which every strategy runs (the CUDA
kernels take no Python callable).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import as_dtype, resolve_device
from repro_torch.core.fusion import FusedStencilOp
from repro_torch.core.stencil import OperatorSet, laplacian_stencil
from repro_torch.kernels.phi import select_phi

# Incommensurate per-axis phases/frequencies: no axis's error term
# cancels by symmetry, no two axes alias.
_PHASES = (0.3, 1.1, 2.2)
_FREQS = (1.7, 2.3, 1.3)

# Default refinement sweeps per rank (coarse → fine): f64 errors stay
# far above roundoff. Order 8 reaches the f64 floor (~1e-13 relative) by
# n ≈ 48, so its sweep stays coarse; n = 12 still holds the 10-point
# offset rows (deriv + accuracy samples).
DEFAULT_NS = {
    1: (32, 48, 64, 96),
    2: (24, 32, 48, 64),
    3: (16, 24, 32),
}
DEFAULT_NS_ORDER8 = {
    1: (12, 16, 20, 24),
    2: (12, 16, 20, 24),
    3: (12, 16, 20),
}


@dataclasses.dataclass(frozen=True)
class MMSResult:
    """One convergence sweep: the fitted slope and its evidence."""

    rank: int
    accuracy: int
    boundary: str
    dtype: str
    strategy: str
    boundary_weights: bool
    ns: tuple[int, ...]
    hs: tuple[float, ...]
    errors: tuple[float, ...]  # normalized RMS per grid
    slope: float  # fitted observed order
    nominal: int  # the order the pipeline claims

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def fit_slope(hs: Sequence[float], errors: Sequence[float]) -> float:
    """Least-squares slope of log(error) vs log(h), the observed
    convergence order. Grids whose error is exactly zero are dropped;
    ``inf`` when fewer than two remain."""
    pts = [
        (np.log(h), np.log(e))
        for h, e in zip(hs, errors)
        if e > 0.0
    ]
    if len(pts) < 2:
        return float("inf")
    x, y = zip(*pts)
    return float(np.polyfit(x, y, 1)[0])


def manufactured_solution(
    rank: int,
    boundary: str,
    n: int,
    dtype: str = "float64",
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor, float]:
    """The manufactured field and its exact Laplacian on an n-per-axis
    grid: ``(f, lap_exact, h)`` with f of shape (1, *spatial), built in
    float64 with numpy and cast once to ``dtype`` on ``device`` (``None``:
    the card, raising without one).
    """
    device = resolve_device(device)
    if boundary == "periodic":
        h = 2.0 * np.pi / n
        x = np.arange(n) * h
        axes = [np.sin(x + _PHASES[a]) for a in range(rank)]
        f = _outer(axes)
        lap = -float(rank) * f
    elif boundary == "dirichlet":
        h = 1.0 / (n - 1)
        x = np.linspace(0.0, 1.0, n)
        axes = [np.sin(_FREQS[a] * x + _PHASES[a]) for a in range(rank)]
        f = _outer(axes)
        lap = np.zeros_like(f)
        for a in range(rank):
            parts = list(axes)
            parts[a] = -(_FREQS[a] ** 2) * parts[a]
            lap += _outer(parts)
    elif boundary in ("neumann", "neumann2"):
        h = 1.0 / (n - 1)
        x = np.linspace(0.0, 1.0, n)
        axes = [np.cos(np.pi * x) for _ in range(rank)]
        f = _outer(axes)
        lap = -rank * np.pi**2 * f
    else:
        raise ValueError(
            f"no manufactured solution for boundary {boundary!r}"
        )
    dt = as_dtype(dtype)
    f = torch.as_tensor(f[None], dtype=dt, device=device)
    lap = torch.as_tensor(lap[None], dtype=dt, device=device)
    return f, lap, float(h)


def _outer(axes_1d: Sequence[np.ndarray]) -> np.ndarray:
    out = axes_1d[0]
    for g in axes_1d[1:]:
        out = np.multiply.outer(out, g)
    return out


def normalized_rms_error(out: torch.Tensor, lap_exact: torch.Tensor) -> float:
    """RMS of ``out − lap_exact`` (the difference taken in their dtype)
    over the RMS of ``lap_exact``, in float64: one grid's error."""
    err = (out - lap_exact).to(torch.float64)
    ref = torch.sqrt(torch.mean(lap_exact.to(torch.float64) ** 2))
    return float(torch.sqrt(torch.mean(err**2)) / ref)


def laplacian_op(
    rank: int,
    accuracy: int,
    h: float,
    boundary: str,
    *,
    strategy: str = "hwc",
    boundary_weights: bool = False,
    device: str | torch.device | None = None,
) -> FusedStencilOp:
    """The op one grid of :func:`run_convergence` applies: the generated
    order-``accuracy`` ∇² at spacing ``h``, φ = ``select_phi("lap")``."""
    ops = OperatorSet((laplacian_stencil(rank, accuracy, spacing=h),))
    return FusedStencilOp(
        ops, select_phi("lap"), n_out=1, boundary_mode=boundary,
        strategy=strategy, boundary_weights=boundary_weights,
        device=device,
    )


def run_convergence(
    rank: int,
    accuracy: int,
    boundary: str = "periodic",
    *,
    dtype: str = "float64",
    strategy: str = "hwc",
    ns: Sequence[int] | None = None,
    boundary_weights: bool | None = None,
    device: str | torch.device | None = None,
) -> MMSResult:
    """One refinement sweep of the generated ∇² at the given order.

    ``boundary_weights`` defaults to True on ``dirichlet`` (the wall
    cells must run the offset rows to see the interior order at all)
    and False on the Neumann family (whose point is to measure the ghost
    fill) and periodic (no walls). ``strategy`` selects the regime the
    sweep lowers through; ``swc_stream`` refuses rank 1 and ``tc`` runs
    float32 only, as their kernels do. ``device``: ``None`` is the card
    (raising without one).
    """
    device = resolve_device(device)
    if ns is None:
        ns = (DEFAULT_NS_ORDER8 if accuracy >= 8 else DEFAULT_NS)[rank]
    if boundary_weights is None:
        boundary_weights = boundary == "dirichlet"
    hs, errors = [], []
    for n in ns:
        f, lap_exact, h = manufactured_solution(
            rank, boundary, n, dtype, device
        )
        op = laplacian_op(
            rank, accuracy, h, boundary, strategy=strategy,
            boundary_weights=boundary_weights, device=device,
        )
        errors.append(normalized_rms_error(op(f), lap_exact))
        hs.append(h)
    return MMSResult(
        rank=rank, accuracy=accuracy, boundary=boundary, dtype=dtype,
        strategy=strategy, boundary_weights=bool(boundary_weights),
        ns=tuple(int(n) for n in ns), hs=tuple(hs),
        errors=tuple(errors),
        slope=fit_slope(hs, errors), nominal=int(accuracy),
    )
