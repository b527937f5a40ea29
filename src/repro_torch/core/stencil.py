"""Stencil specifications and finite-difference coefficient generation.

This module implements the paper's Sec. 2.4/3 formalism:

* a stencil is a set of (offset, coefficient) taps around a point of
  interest; the *influence radius* r is the max Chebyshev distance of any
  tap (paper Sec. 2.4);
* a set of n_s linear stencil operators over the same neighborhood is a
  coefficient matrix  A ∈ R^{n_s × n_k}  acting on the flattened
  neighborhood B ∈ R^{n_k × n_f} (paper Sec. 3.3, Eq. 8);
* central-difference coefficients of arbitrary order are generated with
  Fornberg's algorithm, so radius-1..4 (2nd..8th order) stencils used by
  the diffusion/MHD benchmarks all come from one generator.

Everything here is static (numpy) metadata — no tensors. This is the
PyTorch port's own copy of ``repro.core.stencil`` (the port imports
nothing from the JAX package); it must generate the same weights, tap
for tap, so both packages lower the same operators. The CUDA kernel
receives these taps as a flattened table with runtime trip counts
(``repro_torch.kernels.emit.tap_table``).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Sequence

import numpy as np

Offset = tuple[int, ...]


def fornberg_weights(z: float, x: Sequence[float], m: int) -> np.ndarray:
    """Fornberg (1988) finite-difference weights.

    Returns ``w`` of shape ``(len(x), m + 1)`` where ``w[:, k]`` are the
    weights approximating the k-th derivative at ``z`` from samples at
    grid locations ``x``.
    """
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if m >= n:
        raise ValueError(f"need at least {m + 1} points for derivative {m}")
    w = np.zeros((n, m + 1))
    c1, c4 = 1.0, x[0] - z
    w[0, 0] = 1.0
    for i in range(1, n):
        mn = min(i, m)
        c2, c5, c4 = 1.0, c4, x[i] - z
        for j in range(i):
            c3 = x[i] - x[j]
            c2 *= c3
            if j == i - 1:
                for k in range(mn, 0, -1):
                    w[i, k] = c1 * (k * w[i - 1, k - 1] - c5 * w[i - 1, k]) / c2
                w[i, 0] = -c1 * c5 * w[i - 1, 0] / c2
            for k in range(mn, 0, -1):
                w[j, k] = (c4 * w[j, k] - k * w[j, k - 1]) / c3
            w[j, 0] = c4 * w[j, 0] / c3
        c1 = c2
    return w


@lru_cache(maxsize=None)
def offset_difference_coeffs(
    deriv: int, accuracy: int, left: int
) -> np.ndarray:
    """One-sided/offset finite-difference coefficients (the boundary-
    modified weight rows of ``core.boundary``).

    Weights approximating the ``deriv``-th derivative at a point with
    only ``left`` grid neighbors available toward the low side (a point
    ``left`` cells from a non-periodic wall): the Fornberg window spans
    offsets ``-left .. -left + npts - 1`` with ``npts = deriv +
    accuracy`` samples, which guarantees formal order ≥ ``accuracy``
    for any window placement — fully one-sided rows (``left = 0``) and
    every offset row up to the first centered one use the same point
    count, so the operator order is uniform across the domain.

    Returns coefficients in units of ``h**-deriv``; ``deriv = 0``
    returns the single-tap identity. Raises ``ValueError`` on an odd
    ``accuracy`` (same contract as :func:`central_difference_coeffs`).
    """
    if accuracy % 2 != 0:
        raise ValueError("finite differences here need even accuracy order")
    if left < 0:
        raise ValueError(f"left must be >= 0, got {left}")
    if deriv == 0:
        return np.array([1.0])
    npts = deriv + accuracy
    offsets = np.arange(-left, npts - left, dtype=np.float64)
    w = fornberg_weights(0.0, offsets, deriv)[:, deriv]
    w[np.abs(w) < 1e-12] = 0.0
    return w


@lru_cache(maxsize=None)
def central_difference_coeffs(deriv: int, accuracy: int) -> np.ndarray:
    """1-D central-difference coefficients.

    ``deriv``: derivative order (0 = identity, 1, 2, ...).
    ``accuracy``: even accuracy order (2, 4, 6, 8). Radius is
    ``(deriv + 1) // 2 + accuracy // 2 - 1`` for central stencils; for the
    first/second derivatives used throughout this is ``accuracy // 2``.

    Returns coefficients over offsets ``-r .. r`` (length 2r + 1), in units
    of ``h**-deriv`` (caller scales by grid spacing).
    """
    if accuracy % 2 != 0:
        raise ValueError("central differences need even accuracy order")
    if deriv == 0:
        return np.array([1.0])
    r = (deriv - 1) // 2 + accuracy // 2
    offsets = np.arange(-r, r + 1, dtype=np.float64)
    w = fornberg_weights(0.0, offsets, deriv)[:, deriv]
    # Clean tiny fp noise so symmetric entries are exactly symmetric.
    w[np.abs(w) < 1e-12] = 0.0
    return w


@dataclasses.dataclass(frozen=True)
class OperatorSpec:
    """Analytic identity of a generated stencil operator.

    ``terms`` is the operator as a sum of scaled partial derivatives:
    each entry is ``(deriv, coeff)`` where ``deriv`` is the per-axis
    derivative multi-index (e.g. ``(0, 2)`` for ∂²/∂x² at rank 2) and
    ``coeff`` its scalar weight — so the merged diffusion stencil
    ``1 + Δt·α·∇²`` carries ``((0,…), 1.0)`` plus one ``(2·e_a, Δt·α)``
    term per axis. ``accuracy`` is the even finite-difference order the
    tap weights were generated at (0 = exact/unknown, e.g. the identity)
    and ``spacing`` the per-axis grid spacing baked into the weights.

    This is what lets downstream layers treat the *operator* as a plan
    axis: the accuracy joins strategy ids / tuning keys (``:o{A}``),
    and the boundary module can regenerate order-preserving one-sided
    weight rows (:func:`offset_difference_coeffs`) for the same
    analytic operator near non-periodic walls.
    """

    terms: tuple[tuple[tuple[int, ...], float], ...]
    accuracy: int = 0
    spacing: tuple[float, ...] = ()

    def scaled(self, s: float) -> "OperatorSpec":
        return OperatorSpec(
            tuple((d, c * s) for d, c in self.terms),
            self.accuracy, self.spacing,
        )

    def merged(self, other: "OperatorSpec") -> "OperatorSpec | None":
        """Metadata of the SUM of two operators, or None when their
        identities can't be combined (different spacings, or two
        distinct nonzero accuracies)."""
        if self.spacing and other.spacing and self.spacing != other.spacing:
            return None
        accs = {a for a in (self.accuracy, other.accuracy) if a}
        if len(accs) > 1:
            return None
        taps: dict[tuple[int, ...], float] = {}
        for d, c in self.terms + other.terms:
            taps[d] = taps.get(d, 0.0) + c
        return OperatorSpec(
            tuple(sorted(taps.items())),
            accs.pop() if accs else 0,
            self.spacing or other.spacing,
        )


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A single linear stencil operator: taps[offset] = coefficient.

    ``offsets``: (n_taps, ndim) int array. ``coeffs``: (n_taps,) float64.

    ``spec`` optionally carries the operator's analytic identity
    (:class:`OperatorSpec` — derivative terms, generation accuracy,
    spacing). It is metadata: excluded from equality/hash, attached by
    the generator entry points (``axis_stencil`` & friends), and
    propagated through ``pruned``/``scaled``/``__add__``.
    """

    offsets: tuple[Offset, ...]
    coeffs: tuple[float, ...]
    name: str = ""
    spec: OperatorSpec | None = dataclasses.field(
        default=None, compare=False
    )

    def __post_init__(self):
        if len(self.offsets) != len(self.coeffs):
            raise ValueError("offsets/coeffs length mismatch")
        if self.offsets:
            ndims = {len(o) for o in self.offsets}
            if len(ndims) != 1:
                raise ValueError("inconsistent offset dimensionality")

    @property
    def ndim(self) -> int:
        return len(self.offsets[0]) if self.offsets else 0

    @property
    def radius(self) -> int:
        """Chebyshev influence radius (paper Sec. 2.4)."""
        if not self.offsets:
            return 0
        return int(max(max(abs(c) for c in o) for o in self.offsets))

    def radius_per_axis(self) -> tuple[int, ...]:
        if not self.offsets:
            return ()
        return tuple(
            int(max(abs(o[a]) for o in self.offsets)) for a in range(self.ndim)
        )

    def pruned(self, tol: float = 0.0) -> "StencilSpec":
        """Drop zero taps (paper Sec. 4.4: OPTIMIZE_MEM_ACCESSES pruning)."""
        keep = [i for i, c in enumerate(self.coeffs) if abs(c) > tol]
        return StencilSpec(
            tuple(self.offsets[i] for i in keep),
            tuple(self.coeffs[i] for i in keep),
            self.name,
            self.spec,
        )

    def scaled(self, s: float, name: str | None = None) -> "StencilSpec":
        return StencilSpec(
            self.offsets, tuple(float(c) * s for c in self.coeffs),
            self.name if name is None else name,
            None if self.spec is None else self.spec.scaled(s),
        )

    def __add__(self, other: "StencilSpec") -> "StencilSpec":
        taps: dict[Offset, float] = {}
        for o, c in zip(self.offsets, self.coeffs):
            taps[o] = taps.get(o, 0.0) + c
        for o, c in zip(other.offsets, other.coeffs):
            taps[o] = taps.get(o, 0.0) + c
        items = sorted(taps.items())
        spec = None
        if self.spec is not None and other.spec is not None:
            spec = self.spec.merged(other.spec)
        return StencilSpec(
            tuple(o for o, _ in items), tuple(c for _, c in items),
            f"({self.name}+{other.name})",
            spec,
        )

    def compose_outer(self, other: "StencilSpec", name: str = "") -> "StencilSpec":
        """Tensor-product composition (e.g. d/dx ∘ d/dy for mixed partials)."""
        taps: dict[Offset, float] = {}
        for o1, c1 in zip(self.offsets, self.coeffs):
            for o2, c2 in zip(other.offsets, other.coeffs):
                o = tuple(a + b for a, b in zip(o1, o2))
                taps[o] = taps.get(o, 0.0) + c1 * c2
        items = sorted(taps.items())
        return StencilSpec(
            tuple(o for o, _ in items), tuple(c for _, c in items), name
        ).pruned(1e-14)


def axis_stencil(
    ndim: int, axis: int, deriv: int, accuracy: int, spacing: float = 1.0,
    name: str = "",
) -> StencilSpec:
    """A 1-D central-difference stencil embedded along ``axis`` of an
    ``ndim``-dimensional domain, scaled by ``spacing**-deriv``."""
    w = central_difference_coeffs(deriv, accuracy) / spacing**deriv
    r = (len(w) - 1) // 2
    offsets, coeffs = [], []
    for k, c in enumerate(w):
        if c == 0.0 and deriv > 0:
            continue
        o = [0] * ndim
        o[axis] = k - r
        offsets.append(tuple(o))
        coeffs.append(float(c))
    dmi = tuple(deriv if a == axis else 0 for a in range(ndim))
    # Only the differentiated axis's spacing entry is meaningful here
    # (the caller passes a scalar h for this axis alone).
    sp = tuple(float(spacing) if a == axis else 1.0 for a in range(ndim))
    return StencilSpec(
        tuple(offsets), tuple(coeffs), name,
        OperatorSpec(((dmi, 1.0),), accuracy if deriv else 0, sp),
    )


def laplacian_stencil(
    ndim: int, accuracy: int, spacing: Sequence[float] | float = 1.0,
    name: str = "lap",
) -> StencilSpec:
    """∇² as the sum of per-axis second-derivative stencils (paper Eq. 7:
    distributivity of cross-correlation over addition lets the per-axis
    kernels be summed into ONE stencil)."""
    if np.isscalar(spacing):
        spacing = [float(spacing)] * ndim
    out = axis_stencil(ndim, 0, 2, accuracy, spacing[0])
    for a in range(1, ndim):
        out = out + axis_stencil(ndim, a, 2, accuracy, spacing[a])
    spec = OperatorSpec(
        tuple(
            (tuple(2 if b == a else 0 for b in range(ndim)), 1.0)
            for a in range(ndim)
        ),
        accuracy,
        tuple(float(s) for s in spacing),
    )
    return StencilSpec(out.offsets, out.coeffs, name, spec).pruned(0.0)


def mixed_partial_stencil(
    ndim: int, axis_a: int, axis_b: int, accuracy: int,
    spacing: Sequence[float] | float = 1.0, name: str = "",
) -> StencilSpec:
    """∂²/∂a∂b as the outer composition of two first-derivative stencils."""
    if np.isscalar(spacing):
        spacing = [float(spacing)] * ndim
    sa = axis_stencil(ndim, axis_a, 1, accuracy, spacing[axis_a])
    sb = axis_stencil(ndim, axis_b, 1, accuracy, spacing[axis_b])
    out = sa.compose_outer(sb, name)
    dmi = tuple(
        int(a == axis_a) + int(a == axis_b) for a in range(ndim)
    )
    spec = OperatorSpec(
        ((dmi, 1.0),), accuracy, tuple(float(s) for s in spacing)
    )
    return dataclasses.replace(out, spec=spec)


def identity_stencil(ndim: int, name: str = "val") -> StencilSpec:
    return StencilSpec(
        (tuple([0] * ndim),), (1.0,), name,
        OperatorSpec(((tuple([0] * ndim), 1.0),), 0, ()),
    )


@dataclasses.dataclass(frozen=True)
class OperatorSet:
    """A named set of linear stencil operators sharing one neighborhood.

    This is the paper's coefficient matrix A (Eq. 8): ``matrix()`` returns
    A ∈ R^{n_s × n_k} over the union of all tap offsets (columns), pruned
    to offsets used by at least one operator. Kernels either

    * iterate taps (offset-MAC, the VPU-friendly form), or
    * materialize A and run Q = A·B on the MXU (implicit-GEMM form).
    """

    ops: tuple[StencilSpec, ...]

    def __post_init__(self):
        names = [s.name for s in self.ops]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate operator names: {names}")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.ops)

    @property
    def ndim(self) -> int:
        return self.ops[0].ndim

    @property
    def radius(self) -> int:
        return max(s.radius for s in self.ops)

    def radius_per_axis(self) -> tuple[int, ...]:
        per = [s.radius_per_axis() for s in self.ops]
        return tuple(max(p[a] for p in per) for a in range(self.ndim))

    @property
    def n_s(self) -> int:
        return len(self.ops)

    def tap_union(self) -> tuple[Offset, ...]:
        """Sorted union of offsets used by any operator (pruned n_k)."""
        taps: set[Offset] = set()
        for s in self.ops:
            taps.update(s.offsets)
        return tuple(sorted(taps))

    @property
    def n_k(self) -> int:
        return len(self.tap_union())

    def matrix(self) -> tuple[np.ndarray, tuple[Offset, ...]]:
        """A ∈ R^{n_s × n_k} and the column offset order."""
        cols = self.tap_union()
        col_ix = {o: i for i, o in enumerate(cols)}
        A = np.zeros((self.n_s, len(cols)))
        for si, s in enumerate(self.ops):
            for o, c in zip(s.offsets, s.coeffs):
                A[si, col_ix[o]] = c
        return A, cols

    def by_name(self, name: str) -> StencilSpec:
        for s in self.ops:
            if s.name == name:
                return s
        raise KeyError(name)

    def flops_per_point(self, n_f: int) -> int:
        """Multiply-add FLOPs per grid point for the pruned tap set."""
        return int(2 * n_f * sum(len(s.offsets) for s in self.ops))

    @property
    def taps_per_point(self) -> int:
        """Total taps every grid point evaluates across the set — the
        tap-count input of the cost model's VPU compute term (one
        multiply-add per tap per field)."""
        return int(sum(len(s.offsets) for s in self.ops))

    @property
    def accuracy(self) -> int:
        """The finite-difference accuracy order the set's derivative
        operators were generated at — the ``:o{A}`` plan/tuning-key
        axis. 0 when unknown (hand-built taps without
        :class:`OperatorSpec` metadata, or no derivative operators) or
        mixed (members generated at different orders)."""
        accs = {
            s.spec.accuracy
            for s in self.ops
            if s.spec is not None and s.spec.accuracy
        }
        return accs.pop() if len(accs) == 1 else 0


def derivative_operator_set(
    ndim: int, accuracy: int, spacing: Sequence[float] | float = 1.0,
    include_mixed: bool = True, include_value: bool = True,
) -> OperatorSet:
    """The full derivative-operator set used by the MHD solver:
    {val, d/dxi, d²/dxi², d²/dxi dxj}. With accuracy=6 and ndim=3 this is
    the paper's 10-operator, 127-tap (pruned) configuration.

    Array-axis convention: spatial axes are ordered slowest→fastest as
    (z, y, x) for 3-D, (y, x) for 2-D, (x,) for 1-D — x is always the
    contiguous (lane) dimension. ``spacing`` follows the same order.
    """
    if np.isscalar(spacing):
        spacing = [float(spacing)] * ndim
    axes = {1: ("x",), 2: ("y", "x"), 3: ("z", "y", "x")}[ndim]
    ops: list[StencilSpec] = []
    if include_value:
        ops.append(identity_stencil(ndim))
    for a in range(ndim):
        ops.append(axis_stencil(ndim, a, 1, accuracy, spacing[a], f"d{axes[a]}"))
    for a in range(ndim):
        ops.append(axis_stencil(ndim, a, 2, accuracy, spacing[a], f"d{axes[a]}{axes[a]}"))
    if include_mixed:
        for a in range(ndim):
            for b in range(a + 1, ndim):
                na, nb = sorted([axes[a], axes[b]])
                ops.append(
                    mixed_partial_stencil(
                        ndim, a, b, accuracy, spacing, f"d{na}{nb}"
                    )
                )
    return OperatorSet(tuple(ops))


def xcorr_operator_set(g: np.ndarray, ndim: int = 1) -> OperatorSet:
    """Single cross-correlation operator from a dense 1-D kernel ``g``
    (paper Eq. 3) embedded along the last axis."""
    g = np.asarray(g, dtype=np.float64)
    r = (len(g) - 1) // 2
    offsets = []
    for k in range(len(g)):
        o = [0] * ndim
        o[-1] = k - r
        offsets.append(tuple(o))
    return OperatorSet(
        (StencilSpec(tuple(offsets), tuple(float(c) for c in g), "xcorr"),)
    )


def diffusion_kernel_1d(accuracy: int, dt: float, alpha: float,
                        spacing: float = 1.0) -> np.ndarray:
    """The paper's Eq. 5: g = c^(1) + Δt·α·c^(2) — identity plus scaled
    second-derivative coefficients, as a dense 1-D kernel."""
    c2 = central_difference_coeffs(2, accuracy) / spacing**2
    g = dt * alpha * c2
    g[len(g) // 2] += 1.0
    return g


def diffusion_kernel_nd(ndim: int, accuracy: int, dt: float, alpha: float,
                        spacing: Sequence[float] | float = 1.0) -> StencilSpec:
    """The paper's Eq. 7: one merged stencil for f' = f + Δt·α·∇²f."""
    lap = laplacian_stencil(ndim, accuracy, spacing)
    return (identity_stencil(ndim) + lap.scaled(dt * alpha)).pruned(0.0)
