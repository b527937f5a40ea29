"""φ descriptors the CUDA kernel can run (no counterpart in the reference).

In the JAX package φ is a Python closure traced into the Pallas kernel.
A CUDA kernel is compiled ahead of time, so the port names each φ it
supports: a :class:`DevicePhi` carries a ``kind`` (which φ the kernel
instantiates), a flat tuple of float parameters, the operator names the
kind reads (in the kernel's slot order), and ``torch_fn`` — the same
map in plain PyTorch, used on CPU tensors and as the plain version the
kernel is held against.

Kinds (the kernels in ``csrc/`` switch on :data:`KIND_IDS`):

* ``select`` — output row k = operator ``operators[0]`` applied to
  field k (diffusion's ``lambda d: d["step"]``); no parameters; float32,
  float64 and bfloat16 (on ``tc`` the operator's float32 sum is rounded
  once to bfloat16 on the store; on ``swc`` every tap rounds in
  bfloat16, as the reference's elementwise path does).
* ``mhd_rhs`` — the 8-field MHD right-hand side
  (``csrc/phi_mhd.cuh``); reads the 10 operators of
  :data:`MHD_OPERATORS`.
* ``mhd_substep`` — one fused-axpy RK substep on top of ``mhd_rhs``:
  with aux = w, ``w' = αw + Δt·rhs``, ``f' = f + βw'``; writes 16 rows
  (f', w').

The MHD kinds run in float32 and float64; bfloat16 raises
``NotImplementedError`` (ROADMAP B4b), though the reference takes it.

MHD parameters are laid out as :data:`MHD_PARAM_NAMES`: the
``MHDParams`` fields in declaration order, the derived ``lnT0``, then
α, β and Δt (zero for ``mhd_rhs``).

At temporal depth S > 1 a launch takes one φ per sweep
(:func:`phi_sequence`): all of one kind and one operator list, their
parameters free to differ (the RK3 substeps' α and β).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

KIND_IDS = {"select": 0, "mhd_rhs": 1, "mhd_substep": 2}

# Slot order of the MHD kernel's derivative registers (phi_mhd.cuh).
MHD_OPERATORS = (
    "val", "dx", "dy", "dz", "dxx", "dyy", "dzz", "dxy", "dxz", "dyz",
)
MHD_N_FIELDS = 8
MHD_PARAM_NAMES = (
    "nu", "zeta", "eta", "mu0", "cp", "gamma", "cs0", "lnrho0", "kappa",
    "heat", "cool", "lnT0", "alpha", "beta", "dt",
)
MAX_PARAMS = 16  # kernel-side parameter array length
MAX_SLOTS = 16  # kernel-side operator slot array length

NEEDS_DEVICE_PHI = (
    "strategy='swc', 'swc_stream' or 'tc' runs a compiled CUDA kernel, which "
    "cannot call a Python φ: pass a DevicePhi (repro_torch.kernels.phi), "
    "or use "
    "strategy='hwc' for an arbitrary φ callable"
)


@dataclasses.dataclass(frozen=True)
class DevicePhi:
    """A φ the CUDA kernel implements, plus its plain PyTorch version.

    ``torch_fn`` has the reference φ signature: ``torch_fn(derivs)`` or
    ``torch_fn(derivs, aux)`` with ``derivs = {op_name: (n_f, *tile)}``.
    """

    kind: str
    params: tuple[float, ...]
    torch_fn: Callable[..., torch.Tensor]
    operators: tuple[str, ...]

    def __post_init__(self):
        if self.kind not in KIND_IDS:
            raise ValueError(
                f"unknown DevicePhi kind {self.kind!r}; want one of "
                f"{tuple(KIND_IDS)}"
            )
        if len(self.params) > MAX_PARAMS:
            raise ValueError(f"at most {MAX_PARAMS} parameters")
        if not 1 <= len(self.operators) <= MAX_SLOTS:
            raise ValueError(f"need 1..{MAX_SLOTS} operator names")
        if self.kind != "select" and (
            self.operators != MHD_OPERATORS
            or len(self.params) != len(MHD_PARAM_NAMES)
        ):
            raise ValueError(
                f"{self.kind} reads operators {MHD_OPERATORS} and "
                f"parameters {MHD_PARAM_NAMES}"
            )

    def __call__(self, derivs, aux=None):
        if aux is None:
            return self.torch_fn(derivs)
        return self.torch_fn(derivs, aux)

    @property
    def kind_id(self) -> int:
        return KIND_IDS[self.kind]

    @property
    def max_threads(self) -> int:
        """Most points a tile may hold for this kind's kernel: the MHD
        kinds keep 80 derivative values per point in registers and are
        compiled for 256-thread blocks."""
        return 1024 if self.kind == "select" else 256

    @property
    def needs_aux(self) -> bool:
        return self.kind == "mhd_substep"

    def n_out(self, n_f: int) -> int:
        """Output rows for an ``n_f``-field input."""
        if self.kind == "select":
            return n_f
        return 2 * MHD_N_FIELDS if self.kind == "mhd_substep" else MHD_N_FIELDS


def select_phi(name: str) -> DevicePhi:
    """φ(d) = d[name]: each field's output is one operator of the set
    (forward-Euler diffusion with the merged stencil of Eq. 7)."""
    return DevicePhi("select", (), lambda d: d[name], (name,))


def phi_sequence(phi, n_steps: int) -> tuple[DevicePhi, ...]:
    """The φ of each of ``n_steps`` sweeps of one launch: one
    :class:`DevicePhi` repeated, or a sequence of ``n_steps`` of them
    sharing one kind and one operator list (parameters may differ).

    Raises:
        ValueError: for a bare callable, a sequence of the wrong length,
            or sweeps of different kinds or operator lists.
    """
    phis = tuple(phi) if isinstance(phi, (tuple, list)) else (phi,) * n_steps
    if not all(isinstance(p, DevicePhi) for p in phis):
        raise ValueError(NEEDS_DEVICE_PHI)
    if len(phis) != n_steps:
        raise ValueError(
            f"got {len(phis)} φs for {n_steps} fused sweeps"
        )
    if len({(p.kind, p.operators) for p in phis}) > 1:
        raise ValueError(
            "the sweeps of one launch run one compiled φ: every DevicePhi "
            "of the sequence needs the same kind and operators, got "
            f"{[(p.kind, p.operators) for p in phis]}"
        )
    return phis
