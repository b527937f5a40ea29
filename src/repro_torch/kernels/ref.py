"""Plain PyTorch versions of the fused stencil (port of
``repro.kernels.ref``).

These are the ``hwc`` regime of the fusion engine (PyTorch's own
elementwise kernels, residency left to the caches) and the plain
version every CUDA kernel of the port is held against. Each operator
accumulates its taps in the reference's order, with each coefficient
cast to the field dtype BEFORE the multiply (``ref.py:55`` and
``emit.py:92`` of the reference), so float32 results round like the
reference's.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.stencil import OperatorSet


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
            coeff = torch.tensor(c, dtype=f_padded.dtype)
            acc = acc + coeff * f_padded[(slice(None),) + sl]
        out[spec.name] = acc
    return out


def fused_stencil(
    f_padded: torch.Tensor,
    ops: OperatorSet,
    phi: Callable[..., torch.Tensor],
    aux: torch.Tensor | None = None,
) -> torch.Tensor:
    """The paper's fused φ(A·B) evaluation (Eq. 9), plain form.

    ``phi`` maps {op_name: (n_f, *spatial)} (and ``aux``, (n_aux,
    *spatial), when given) to (n_out, *spatial).
    """
    derivs = apply_operator_set(f_padded, ops)
    if aux is None:
        return phi(derivs)
    return phi(derivs, aux)


def fused_stencil_steps(
    f_padded: torch.Tensor,
    ops: OperatorSet,
    phi,
    n_steps: int,
    aux: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sequential reference for temporal fusion: apply the fused op
    ``n_steps`` times, the valid region shrinking by one radius per
    application.

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
        out = fused_stencil(cur, ops, phi_s, aux=cur_aux)
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
            f_padded[m], ops, phi, aux=None if aux is None else aux[m]
        )
        for m in range(f_padded.shape[0])
    ])


def fused_stencil_steps_batched(
    f_padded: torch.Tensor,
    ops: OperatorSet,
    phi,
    n_steps: int,
    aux: torch.Tensor | None = None,
) -> torch.Tensor:
    """Batched sequential reference for temporal fusion:
    :func:`fused_stencil_steps` on each member (see
    :func:`fused_stencil_batched` for the operand convention)."""
    return torch.stack([
        fused_stencil_steps(
            f_padded[m], ops, phi, n_steps,
            aux=None if aux is None else aux[m],
        )
        for m in range(f_padded.shape[0])
    ])
