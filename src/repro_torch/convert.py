"""Carry the reference's state across to the port.

The stencil engine has no learned weights: its state is the operator
tap tables (offsets and coefficients), the MHD parameters, and the field
stacks. A language model's state is its parameter tree and, in
training, its AdamW state. These helpers rebuild each from plain
numpy/dict data, so an object of the JAX package (an ``OperatorSet``,
``MHDParams``, a jax array, the nested dict of a model's
``init_params``) can be handed to the port through
``dataclasses.asdict``/``numpy`` without the port importing the JAX
package.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch import as_dtype, resolve_device
from repro_torch.core.stencil import OperatorSet, StencilSpec
from repro_torch.optim import OptState
from repro_torch.physics.mhd import MHDParams


def operator_set_from_arrays(
    names: Sequence[str],
    offsets: Sequence[Sequence[Sequence[int]]],
    coeffs: Sequence[Sequence[float]],
) -> OperatorSet:
    """An :class:`OperatorSet` from per-operator names, (n_taps, ndim)
    integer offsets and (n_taps,) coefficients, taps in the given order
    (the order each operator accumulates in).

    The analytic ``OperatorSpec`` metadata is not carried (it plays no
    part in the lowering), so ``accuracy`` of the result is 0.
    """
    if not len(names) == len(offsets) == len(coeffs):
        raise ValueError("names, offsets and coeffs differ in length")
    specs = []
    for name, off, c in zip(names, offsets, coeffs):
        off = np.asarray(off, dtype=np.int64)
        c = np.asarray(c, dtype=np.float64)
        if off.ndim != 2 or off.shape[0] != c.shape[0]:
            raise ValueError(
                f"operator {name!r}: offsets {off.shape} do not match "
                f"coeffs {c.shape}"
            )
        specs.append(
            StencilSpec(
                tuple(tuple(int(v) for v in o) for o in off),
                tuple(float(v) for v in c),
                str(name),
            )
        )
    return OperatorSet(tuple(specs))


def mhd_params_from_dict(d: Mapping[str, float]) -> MHDParams:
    """:class:`MHDParams` from ``dataclasses.asdict`` of the reference's
    (unknown keys raise, so a renamed field cannot be dropped silently)."""
    return MHDParams(**{k: float(v) for k, v in d.items()})


def fields_from_numpy(
    a: np.ndarray,
    device: str | torch.device | None = None,
    dtype: str | torch.dtype | None = None,
) -> torch.Tensor:
    """A field stack (any array-like, e.g. ``np.asarray`` of a jax array)
    as a tensor on ``device`` (the card by default), in ``dtype`` (the
    array's own when None). A bfloat16 array (numpy's ml_dtypes type,
    which torch cannot read) crosses exactly through float32."""
    arr = np.asarray(a)
    bf16 = arr.dtype.name == "bfloat16"
    if bf16:
        arr = np.asarray(arr, np.float32)  # every bf16 value is an f32
    t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    if bf16:
        t = t.to(torch.bfloat16)
    dt = as_dtype(dtype) if dtype is not None else t.dtype
    return t.to(device=resolve_device(device), dtype=dt)


def model_params_from_numpy(
    tree: Mapping[str, Any],
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Any model family's parameter tree (nested dicts of arrays, e.g.
    the JAX ``init_params`` output with every leaf through
    ``np.asarray``) as the same nested dicts of tensors on ``device``
    (the card by default), each leaf in its own dtype, copied exactly."""
    dev = resolve_device(device)

    def one(leaf):
        if isinstance(leaf, Mapping):
            return {k: one(v) for k, v in leaf.items()}
        return fields_from_numpy(leaf, device=dev)

    return one(tree)


# mamba2's name for it, from before the other families were ported.
ssm_params_from_numpy = model_params_from_numpy


def opt_state_from_numpy(
    state: Any,
    device: str | torch.device | None = None,
) -> OptState:
    """The reference's AdamW ``OptState`` (step, mu, nu; e.g. through
    ``jax.tree.map(np.asarray, ...)``, which keeps the NamedTuple) as
    the port's :class:`~repro_torch.optim.OptState` on ``device`` (the
    card by default): the step an int32 scalar, the moments as
    :func:`model_params_from_numpy` carries a parameter tree, exactly."""
    dev = resolve_device(device)
    return OptState(
        step=fields_from_numpy(state.step, device=dev),
        mu=model_params_from_numpy(state.mu, device=dev),
        nu=model_params_from_numpy(state.nu, device=dev),
    )
