"""FusedStencilOp — the paper's fused stencil step as a PyTorch module
(port of ``repro.core.fusion``).

A fused stencil operation is the paper's chain φ(γ(ψ(f))) (Sec. 3.3):

  ψ  pad the spatial dimensions (boundary module),
  γ  evaluate ALL linear stencil operators for ALL fields — Q = A·B
     with A ∈ R^{n_s×n_k}, B ∈ R^{n_k×n_f} per point (Eq. 8),
  φ  point-wise map producing the n_out field updates (Eq. 9).

``strategy`` selects the caching regime:

  ============  =========  =================================================
  strategy      ranks      on-chip residency
  ============  =========  =================================================
  ``hwc``        1, 2, 3   plain PyTorch: residency left to the caches; any
                           φ callable; ``fuse_steps > 1`` by repetition
  ``swc``        1, 2, 3   the hand-written CUDA kernels: one field's halo
                           window staged in shared memory at a time, all
                           operator values in registers, φ compiled in —
                           φ must be a :class:`~repro_torch.kernels.phi.
                           DevicePhi`; ``fuse_steps > 1`` runs all sweeps
                           in one launch, the intermediate fields in
                           shared memory
  ``swc_stream``   2, 3   the CUDA kernel that walks the slowest axis (z at
                           rank 3, y at rank 2) chunk by chunk: all fields'
                           working set resident in shared memory, the
                           halo planes carried from chunk to chunk, the
                           next chunk copied in while this one computes
                           (paper Fig. 5b); a DevicePhi, no aux; composes
                           with ``fuse_steps``
  ``tc``         1, 2, 3   the CUDA kernel whose derivatives are banded
                           contractions on the tensor cores (float32 or
                           bfloat16, f32 accumulation, as the reference's
                           ``_block_derivs_tc``); a DevicePhi; composes
                           with ``fuse_steps``, batch and aux, one launch
                           per call at any depth
  ============  =========  =================================================

The operator set's tap table is a buffer of the module, so ``.to(device)``
moves it with the module. The reference's other regimes, ``"auto"``
resolution, sharding and ``boundary_weights`` raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Callable, Mapping, Union

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import boundary
from repro_torch.core.stencil import OperatorSet
from repro_torch.kernels import ops as kops
from repro_torch.kernels import plan as kplan
from repro_torch.kernels.emit import device_tap_table
from repro_torch.kernels.phi import phi_sequence

Phi = Callable[[Mapping[str, torch.Tensor]], torch.Tensor]
PhiLike = Union[Phi, tuple]

STRATEGIES = ("hwc", "swc", "swc_stream", "tc")
DEVICE_STRATEGIES = ("swc", "swc_stream", "tc")  # the CUDA kernels
# Reference strategies not ported yet → ROADMAP item.
NOT_PORTED = {**kplan.NOT_PORTED, "auto": "A9 (cross-strategy tuning)"}


class FusedStencilOp(nn.Module):
    """One fused update step over an (n_f, *spatial) field stack, or a
    (batch, n_f, *spatial) ensemble of them (one launch for all members
    on the CUDA strategies).

    Args:
        ops: the :class:`~repro_torch.core.stencil.OperatorSet` (γ).
        phi: point-wise map from ``{op_name: (n_f, *spatial)}`` (plus an
            optional aux tensor) to the (n_out, *spatial) update; a
            :class:`~repro_torch.kernels.phi.DevicePhi` for ``swc``,
            ``swc_stream`` and ``tc``; at depth > 1 it may be a sequence of
            per-step maps (on the CUDA strategies DevicePhis of one
            kind).
        n_out: number of output fields φ produces.
        boundary_mode: ψ — how ghost cells are filled ("periodic", …);
            scalar or one mode per spatial axis.
        strategy: ``"hwc"``, ``"swc"``, ``"swc_stream"`` or ``"tc"``
            (see the module docstring).
        block: rank-length tile (x last) or None (per-rank default); on
            ``swc_stream`` ``block[0]`` is the chunk of the walk.
        fuse_steps: applications per call (on ``swc`` one launch of
            the temporal kernel, on ``swc_stream`` one launch of the
            stream kernel, on ``tc`` one launch of the tc kernel;
            periodic boundaries only).
        boundary_weights: not ported yet (must be False).
        device: where the tap-table buffers live (``None``: the card,
            raising without one; pass ``"cpu"`` for the plain path;
            move with ``.to(device)``).

    Raises:
        ValueError: on an invalid strategy, boundary mode, block,
            depth, a φ the chosen regime cannot run (a CUDA strategy
            with a bare callable), or ``swc_stream`` on a rank-1 set.
        NotImplementedError: for a reference option not ported yet.
    """

    def __init__(
        self,
        ops: OperatorSet,
        phi: PhiLike,
        n_out: int,
        boundary_mode: str | tuple[str, ...] = "periodic",
        strategy: str = "hwc",
        block: tuple[int, ...] | None = None,
        fuse_steps: int = 1,
        boundary_weights: bool = False,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        if isinstance(block, str):
            raise NotImplementedError(
                f"block={block!r} (the tuner) is not ported yet: ROADMAP A9"
            )
        self.ops = ops
        self.phi = phi
        self.n_out = int(n_out)
        self.boundary_mode = boundary_mode
        self.strategy = strategy
        self.block = None if block is None else tuple(block)
        self.fuse_steps = fuse_steps
        self._validate(boundary_weights)
        device = resolve_device(device)
        offsets, coeffs, starts = device_tap_table(ops, device)
        self.register_buffer("tap_offsets", offsets)
        self.register_buffer("tap_coeffs", coeffs)
        self.register_buffer("tap_starts", starts)

    def _validate(self, boundary_weights: bool) -> None:
        if self.strategy in NOT_PORTED:
            raise NotImplementedError(
                f"strategy {self.strategy!r} is not ported yet: ROADMAP "
                f"{NOT_PORTED[self.strategy]}"
            )
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"strategy {self.strategy!r} not in {STRATEGIES}"
            )
        if self.strategy == "swc_stream" and self.ops.ndim < 2:
            raise ValueError(
                "swc_stream walks the slowest axis of a 2-D or 3-D "
                f"operator set; got ndim={self.ops.ndim} — use "
                "strategy='swc'"
            )
        modes = self.boundary_modes  # validates names and count
        if boundary_weights:
            raise NotImplementedError(
                "boundary_weights (boundary-modified weight rows) is not "
                "ported yet: ROADMAP A3"
            )
        if isinstance(self.fuse_steps, str):
            raise NotImplementedError(
                "fuse_steps='auto' (the tuner) is not ported yet: ROADMAP A9"
            )
        if self.fuse_steps < 1:
            raise ValueError(
                f"fuse_steps must be >= 1, got {self.fuse_steps}"
            )
        if self.fuse_steps > 1:
            if any(m != "periodic" for m in modes):
                raise ValueError(
                    "temporal fusion requires boundary_mode='periodic' "
                    "on every axis: intermediate sweeps consume "
                    "pre-padded ghost cells and never re-impose the "
                    "boundary, which only composes exactly for the "
                    f"periodic wrap (got {self.boundary_mode!r})"
                )
        if isinstance(self.phi, (tuple, list)) and len(self.phi) != (
            self.fuse_steps
        ):
            raise ValueError(
                f"phi sequence has {len(self.phi)} entries for "
                f"fuse_steps={self.fuse_steps}"
            )
        if self.strategy in DEVICE_STRATEGIES:
            phi_sequence(self.phi, self.fuse_steps)  # DevicePhis, one kind

    @property
    def radius_per_axis(self) -> tuple[int, ...]:
        """Per-axis halo radius of the operator set."""
        return self.ops.radius_per_axis()

    @property
    def boundary_modes(self) -> tuple[str, ...]:
        """``boundary_mode`` normalized to one mode per spatial axis."""
        return boundary._normalize_modes(self.boundary_mode, self.ops.ndim)

    def apply_padded(
        self, f_padded: torch.Tensor, aux: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Apply to an already-padded field stack (``radius *
        fuse_steps`` ghost cells per axis). ``aux`` (n_aux, *interior),
        padded by ``radius * (fuse_steps - 1)``, is forwarded to φ (the
        fused RK axpy carry). A batched (batch, n_f, *padded) stack, and
        its (batch, n_aux, …) aux, pass through as they are: the
        dispatch detects the member axis by rank."""
        if self.strategy in DEVICE_STRATEGIES:
            return kops.fused_stencil_nd(
                f_padded, self.ops, self.phi, self.n_out, aux=aux,
                strategy=self.strategy, block=self.block,
                fuse_steps=self.fuse_steps,
                taps=(self.tap_offsets, self.tap_coeffs, self.tap_starts),
            )
        return kops.fused_stencil_nd(
            f_padded, self.ops, self.phi, self.n_out, aux=aux,
            strategy="hwc", fuse_steps=self.fuse_steps,
        )

    def forward(
        self, f: torch.Tensor, aux: torch.Tensor | None = None
    ) -> torch.Tensor:
        """ψ then φ(A·B): pad with the boundary function and apply,
        advancing ``fuse_steps`` steps per call.

        ``f`` is (n_f, *spatial), or (batch, n_f, *spatial) for an
        ensemble: the member axis is detected by rank, only the spatial
        axes are padded, and ``aux`` then carries the same leading
        axis."""
        lead = 2 if kplan.is_ensemble(self.ops.ndim, f.ndim) else 1
        if f.ndim != self.ops.ndim + lead:
            raise ValueError(
                f"f must be (n_f, *spatial) or (batch, n_f, *spatial) with "
                f"{self.ops.ndim} spatial axes, got shape {tuple(f.shape)}"
            )
        depth = self.fuse_steps
        rads = self.radius_per_axis
        modes = self.boundary_modes
        fp = boundary.pad(
            f, [r * depth for r in rads], modes,
            spatial_axes=range(lead, f.ndim),
        )
        if aux is not None and depth > 1:
            aux = boundary.pad(
                aux, [r * (depth - 1) for r in rads], modes,
                spatial_axes=range(lead, aux.ndim),
            )
        return self.apply_padded(fp, aux=aux)

    def with_depth(self, fuse_steps: int) -> "FusedStencilOp":
        """The same op at another depth, buffers on the same device."""
        return FusedStencilOp(
            self.ops, self.phi, self.n_out, self.boundary_mode,
            self.strategy, self.block, fuse_steps,
            device=self.tap_offsets.device,
        )

    def apply_sharded(self, *args, **kwargs):
        """Not ported yet (ROADMAP A11: halos over torch.distributed)."""
        raise NotImplementedError(
            "apply_sharded is not ported yet: ROADMAP A11"
        )


def integrate(
    op: FusedStencilOp, f0: torch.Tensor, n_steps: int
) -> torch.Tensor:
    """Iterate f ← φ(A·B(ψ(f))) for ``n_steps`` TIME steps (paper Fig. 1).

    Each call of the op advances ``op.fuse_steps`` steps; a remainder
    ``n_steps % fuse_steps`` is finished with a shallower op so the step
    count is exact.

    Raises:
        ValueError: when ``op.phi`` is a per-step sequence at depth > 1.
    """
    depth = op.fuse_steps
    if depth > 1 and isinstance(op.phi, (tuple, list)):
        raise ValueError(
            "integrate() iterates one uniform map — per-step phi "
            "sequences (RK substep fusion) are driven by their solver"
        )
    full, rem = divmod(n_steps, depth)
    f = f0
    for _ in range(full):
        f = op(f)
    if rem:
        f = op.with_depth(rem)(f)
    return f
