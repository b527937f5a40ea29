"""Plain PyTorch versions of the fused stencil (port of
``repro.kernels.ref``).

These are the ``hwc`` regime of the fusion engine (PyTorch's own
elementwise kernels, residency left to the caches) and the plain
version every CUDA kernel of the port is held against. Each operator
accumulates its taps in the reference's order, with each coefficient
cast to the field dtype BEFORE the multiply (``ref.py:55`` and
``emit.py:92`` of the reference), so float32 results round like the
reference's; in bfloat16 every product and every sum is rounded to
bfloat16, as the reference's elementwise arithmetic is.

The ``tc`` regime's plain version (:func:`apply_operator_set_tc` and
the ``fused_stencil_tc*`` forms) rounds as ``_block_derivs_tc`` of the
reference does: multi-tap groups contracted in float32 with the band in
the field dtype, lone taps rounded in the field dtype, the groups summed
in float32 in sorted order and cast back once per operator.

:func:`xcorr1d` is the 1-D cross-correlation's plain version (the
``hwc`` strategy of ``ops.xcorr1d`` and the oracle of the B6 kernel
``csrc/xcorr1d.cu``), :func:`xcorr1d_numpy` its float64 numpy oracle.
:func:`conv1d_depthwise_causal` is mamba2's depthwise causal conv (the
reference's ``conv1d_depthwise_causal``), and :func:`conv1d_depthwise`
that conv with the optional SiLU: the plain version of the B7 kernel
``csrc/conv1d_depthwise.cu``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.stencil import OperatorSet
from repro_torch.kernels.plan import tc_axis_groups


def xcorr1d(f_padded: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """1-D discrete cross-correlation, paper Eq. 3.

    ``f_padded`` has shape (n + 2r,); ``g`` has shape (2r + 1,).
    Returns (n,): f'_i = Σ_j g_j · f̂_{i+j}, the taps summed in order,
    each coefficient cast to the field dtype before the multiply.
    """
    n = f_padded.shape[0] - (g.shape[0] - 1)
    g = g.to(f_padded.dtype)
    acc = torch.zeros((n,), dtype=f_padded.dtype, device=f_padded.device)
    for k in range(g.shape[0]):
        acc = acc + g[k] * f_padded[k : k + n]
    return acc


def xcorr1d_numpy(f_padded: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Float64 numpy oracle-of-the-oracle (used by property tests)."""
    f_padded = np.asarray(f_padded, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    n = f_padded.shape[0] - (g.shape[0] - 1)
    out = np.zeros(n)
    for k in range(g.shape[0]):
        out += g[k] * f_padded[k : k + n]
    return out


def conv1d_depthwise_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1-D convolution (mamba2 frontend stencil).

    ``x``: (batch, seq, channels), any strides; ``w``: (k, channels).
    Output (b, s, c), contiguous: y[b, t, c] = Σ_{j<k} w[j, c] ·
    x[b, t - (k-1) + j, c], zero-padded left; the k terms are summed in
    that order in ``x.dtype`` (each product and each sum rounded to it),
    ``w`` cast to ``x.dtype`` first.
    """
    k = w.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    seq = x.shape[1]
    acc = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    for j in range(k):
        acc = acc + w[j][None, None, :].to(x.dtype) * xp[:, j : j + seq, :]
    return acc


def conv1d_depthwise(
    x: torch.Tensor, w: torch.Tensor, activation: str = "none"
) -> torch.Tensor:
    """:func:`conv1d_depthwise_causal`, then ``y * sigmoid(y)`` in
    ``x.dtype`` when ``activation="silu"`` (the TPU kernel's fused gate,
    ``repro/kernels/conv1d_depthwise.py:_kernel``)."""
    if activation not in ("none", "silu"):
        raise ValueError(f"activation {activation!r} not in ('none', 'silu')")
    y = conv1d_depthwise_causal(x, w)
    if activation == "silu":
        y = y * torch.sigmoid(y)
    return y


def _coeff(c: float, dtype: torch.dtype) -> torch.Tensor:
    """A tap coefficient in ``dtype``, as the kernels cast it
    (``cast_coef``): bfloat16 through float32."""
    if dtype == torch.bfloat16:
        return torch.tensor(c, dtype=torch.float32).to(dtype)
    return torch.tensor(c, dtype=dtype)


def apply_operator_set(
    f_padded: torch.Tensor, ops: OperatorSet
) -> dict[str, torch.Tensor]:
    """Evaluate every operator of ``ops`` over a padded multi-field array.

    ``f_padded``: (n_f, *spatial_padded), each spatial axis padded by the
    set's per-axis radius. Returns {op_name: (n_f, *spatial)}.
    """
    rad = ops.radius_per_axis()
    spatial = tuple(
        f_padded.shape[1 + a] - 2 * rad[a] for a in range(ops.ndim)
    )
    out: dict[str, torch.Tensor] = {}
    for spec in ops.ops:
        acc = torch.zeros(
            (f_padded.shape[0],) + spatial,
            dtype=f_padded.dtype, device=f_padded.device,
        )
        for off, c in zip(spec.offsets, spec.coeffs):
            sl = tuple(
                slice(rad[a] + off[a], rad[a] + off[a] + spatial[a])
                for a in range(ops.ndim)
            )
            acc = acc + _coeff(c, f_padded.dtype) * f_padded[
                (slice(None),) + sl
            ]
        out[spec.name] = acc
    return out


def apply_operator_set_tc(
    f_padded: torch.Tensor, ops: OperatorSet
) -> dict[str, torch.Tensor]:
    """:func:`apply_operator_set` as the ``tc`` regime rounds it (port
    of the reference's ``_block_derivs_tc``).

    Each operator's taps are split by ``tc_axis_groups``; groups are
    taken in sorted ``(axis, rest)`` order. A multi-tap group is the
    banded contraction of the window along its axis in float32: each
    coefficient rounded to the field dtype (the band), window and band
    widened to float32, the taps' products summed in float32 — the
    band's zeros add nothing, so this is the contraction without them.
    A lone tap is ``(c in dtype) × value`` rounded in the field dtype,
    then widened. The float32 sum over groups is cast to the field
    dtype once per operator.
    """
    rank = ops.ndim
    rad = ops.radius_per_axis()
    spatial = tuple(
        f_padded.shape[1 + a] - 2 * rad[a] for a in range(rank)
    )
    dtype = f_padded.dtype

    def window(off):
        return f_padded[(slice(None),) + tuple(
            slice(rad[a] + off[a], rad[a] + off[a] + spatial[a])
            for a in range(rank)
        )]

    out: dict[str, torch.Tensor] = {}
    for spec in ops.ops:
        acc = None
        for (axis, rest), taps in sorted(tc_axis_groups(spec, rank).items()):
            term = None
            for j, c in taps:
                off = tuple(j if a == axis else rest[a] for a in range(rank))
                if len(taps) == 1:
                    term = (_coeff(c, dtype) * window(off)).float()
                else:
                    prod = _coeff(c, dtype).float() * window(off).float()
                    term = prod if term is None else term + prod
            acc = term if acc is None else acc + term
        out[spec.name] = acc.to(dtype)
    return out


def fused_stencil(
    f_padded: torch.Tensor,
    ops: OperatorSet,
    phi: Callable[..., torch.Tensor],
    aux: torch.Tensor | None = None,
    *,
    tc: bool = False,
) -> torch.Tensor:
    """The paper's fused φ(A·B) evaluation (Eq. 9), plain form.

    ``phi`` maps {op_name: (n_f, *spatial)} (and ``aux``, (n_aux,
    *spatial), when given) to (n_out, *spatial). ``tc`` takes the
    derivatives as the ``tc`` regime rounds them
    (:func:`apply_operator_set_tc`).
    """
    derivs = (apply_operator_set_tc if tc else apply_operator_set)(
        f_padded, ops
    )
    if aux is None:
        return phi(derivs)
    return phi(derivs, aux)


def fused_stencil_steps(
    f_padded: torch.Tensor,
    ops: OperatorSet,
    phi,
    n_steps: int,
    aux: torch.Tensor | None = None,
    *,
    tc: bool = False,
) -> torch.Tensor:
    """Sequential reference for temporal fusion: apply the fused op
    ``n_steps`` times, the valid region shrinking by one radius per
    application (``tc``: each with the ``tc`` regime's rounding).

    ``f_padded`` is padded by ``radius * n_steps`` per axis; ``aux`` (if
    given) by ``radius * (n_steps - 1)``. ``phi`` is one callable or a
    sequence of ``n_steps``. Steps before the last must be self-maps:
    output rows 0..n_f feed the next step's fields, the following n_aux
    rows the next carry. Returns (n_out, *interior).
    """
    phis = (
        tuple(phi) if isinstance(phi, (tuple, list)) else (phi,) * n_steps
    )
    if len(phis) != n_steps:
        raise ValueError(
            f"got {len(phis)} phi callables for {n_steps} fused steps"
        )
    rad = ops.radius_per_axis()
    n_f = f_padded.shape[0]
    cur, cur_aux = f_padded, aux
    for s, phi_s in enumerate(phis):
        out = fused_stencil(cur, ops, phi_s, aux=cur_aux, tc=tc)
        if s == n_steps - 1:
            break
        cur = out[:n_f]
        if cur_aux is not None:
            n_aux = cur_aux.shape[0]
            carry = out[n_f : n_f + n_aux]
            cur_aux = carry[
                (slice(None),)
                + tuple(
                    slice(r, carry.shape[1 + a] - r) if r else slice(None)
                    for a, r in enumerate(rad)
                )
            ]
    return out


def fused_stencil_batched(
    f_padded: torch.Tensor,
    ops: OperatorSet,
    phi: Callable[..., torch.Tensor],
    aux: torch.Tensor | None = None,
    *,
    tc: bool = False,
) -> torch.Tensor:
    """Batched (ensemble) plain version: :func:`fused_stencil` on each
    member of a leading member axis.

    ``f_padded``: (batch, n_f, *spatial_padded); ``aux`` (if given):
    (batch, n_aux, *spatial). Returns (batch, n_out, *interior). This is
    the oracle the batched kernels are held against: member m of the
    batched output is the single-member path applied to member m alone.
    """
    return torch.stack([
        fused_stencil(
            f_padded[m], ops, phi, aux=None if aux is None else aux[m],
            tc=tc,
        )
        for m in range(f_padded.shape[0])
    ])


def fused_stencil_steps_batched(
    f_padded: torch.Tensor,
    ops: OperatorSet,
    phi,
    n_steps: int,
    aux: torch.Tensor | None = None,
    *,
    tc: bool = False,
) -> torch.Tensor:
    """Batched sequential reference for temporal fusion:
    :func:`fused_stencil_steps` on each member (see
    :func:`fused_stencil_batched` for the operand convention)."""
    return torch.stack([
        fused_stencil_steps(
            f_padded[m], ops, phi, n_steps,
            aux=None if aux is None else aux[m], tc=tc,
        )
        for m in range(f_padded.shape[0])
    ])


def fused_stencil_tc(f_padded, ops, phi, aux=None):
    """The ``tc`` regime's plain version (:func:`fused_stencil` with
    ``tc=True``): the oracle of ``csrc/fused_stencil_tc.cu``."""
    return fused_stencil(f_padded, ops, phi, aux=aux, tc=True)


def fused_stencil_tc_steps(f_padded, ops, phi, n_steps, aux=None):
    """:func:`fused_stencil_steps` with the ``tc`` regime's rounding."""
    return fused_stencil_steps(f_padded, ops, phi, n_steps, aux=aux, tc=True)


def fused_stencil_tc_batched(f_padded, ops, phi, aux=None):
    """:func:`fused_stencil_batched` with the ``tc`` regime's rounding."""
    return fused_stencil_batched(f_padded, ops, phi, aux=aux, tc=True)

