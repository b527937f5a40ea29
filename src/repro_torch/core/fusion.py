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

``strategy="auto"`` closes the loop over the regimes themselves (the
paper's "no single caching regime wins everywhere"): the tuner's
cross-strategy search (``repro_torch.tuning.session.auto_strategy_nd``)
ranks ``hwc``, ``swc``, ``swc_stream`` and ``tc`` launches jointly over
(tile, depth) with the Hopper cost model, times the best of them on the
card (the model decides for a CPU tensor), and persists the decision in
one record, replayed on every later call. It owns the block (``None`` is
read as ``"auto"``) and composes with ``fuse_steps`` an int (the search
at that depth) or ``"auto"``. ``block="auto"`` alone tunes the tile of a
fixed strategy and depth; ``fuse_steps="auto"`` the tile and depth
jointly.

The operator set's tap table is a buffer of the module, so ``.to(device)``
moves it with the module. ``boundary_weights=True`` replaces the ghost
fill's values within ``r`` cells of every non-periodic face by
boundary-modified weight rows (``core.boundary.apply_operator_set_bc``)
after the launch, evaluating only those wall slabs.

:meth:`FusedStencilOp.apply_sharded` runs the op on one rank's block of
a field sharded over a ``torch.distributed`` mesh (``launch.mesh``): the
halos travel by ring exchange (``core.halo``), the launch is the op's
own, and with ``overlap=True`` the halo-independent interior launches
while the exchange is in flight.
"""
from __future__ import annotations

import collections
from typing import Callable, Mapping, Union

import torch
import torch.distributed as dist
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import boundary, halo
from repro_torch.core.stencil import OperatorSet
from repro_torch.kernels import ops as kops
from repro_torch.kernels import plan as kplan
from repro_torch.kernels.emit import device_tap_table
from repro_torch.kernels.phi import phi_sequence

Phi = Callable[[Mapping[str, torch.Tensor]], torch.Tensor]
PhiLike = Union[Phi, tuple]

STRATEGIES = ("hwc", "swc", "swc_stream", "tc", "auto")
DEVICE_STRATEGIES = ("swc", "swc_stream", "tc")  # the CUDA kernels
# Sharded applications since the last reset_sharded_counts(), by path:
# "overlap" (the interior-first decomposition engaged) or "plain"
# (exchange, then one launch).
sharded_counts: collections.Counter = collections.Counter()


def reset_sharded_counts() -> None:
    """Zero :data:`sharded_counts`."""
    sharded_counts.clear()


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
        strategy: ``"hwc"``, ``"swc"``, ``"swc_stream"``, ``"tc"`` or
            ``"auto"`` (see the module docstring).
        block: rank-length tile (x last), ``"auto"`` (the tuner), or
            None (per-rank default; ``"auto"`` under
            ``strategy="auto"``, which owns the block); on
            ``swc_stream`` ``block[0]`` is the chunk of the walk.
        fuse_steps: applications per call (on ``swc`` one launch of
            the temporal kernel, on ``swc_stream`` one launch of the
            stream kernel, on ``tc`` one launch of the tc kernel;
            periodic boundaries only), or ``"auto"`` (the joint tile
            and depth search; needs ``block="auto"`` and a CUDA
            strategy or ``"auto"``).
        boundary_weights: replace the ghost-cell values within ``r``
            cells of every non-periodic face by boundary-MODIFIED weight
            rows (offset stencils of the full interior order), written
            over the kernel's output after the launch; needs generated
            operators (OperatorSpec metadata) and, on non-periodic
            axes, depth 1; nothing is blended on all-periodic axes.
        device: where the tap-table buffers live (``None``: the card,
            raising without one; pass ``"cpu"`` for the plain path;
            move with ``.to(device)``).

    Raises:
        ValueError: on an invalid strategy, boundary mode, block,
            depth, a φ the chosen regime cannot run (a CUDA strategy
            with a bare callable), ``swc_stream`` on a rank-1 set,
            ``boundary_weights`` on operators without OperatorSpec, an
            explicit tile under ``strategy="auto"``, or
            ``fuse_steps="auto"`` without ``block="auto"``.
    """

    def __init__(
        self,
        ops: OperatorSet,
        phi: PhiLike,
        n_out: int,
        boundary_mode: str | tuple[str, ...] = "periodic",
        strategy: str = "hwc",
        block: tuple[int, ...] | str | None = None,
        fuse_steps: int | str = 1,
        boundary_weights: bool = False,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        if strategy == "auto" and block is None:
            block = "auto"  # the cross-strategy search owns the block
        self.ops = ops
        self.phi = phi
        self.n_out = int(n_out)
        self.boundary_mode = boundary_mode
        self.strategy = strategy
        self.block = block if block is None or isinstance(block, str) else (
            tuple(block))
        self.fuse_steps = fuse_steps
        self.boundary_weights = bool(boundary_weights)
        self._validate()
        # Concrete ops resolved per operand (shape, dtype, device, aux
        # shape): a later call on such an operand resolves by lookup.
        self._resolved: dict[tuple, FusedStencilOp] = {}
        # Pinned host buffers of the sharded path's gloo exchanges.
        self._staging = halo.Staging()
        device = resolve_device(device)
        offsets, coeffs, starts = device_tap_table(ops, device)
        self.register_buffer("tap_offsets", offsets)
        self.register_buffer("tap_coeffs", coeffs)
        self.register_buffer("tap_starts", starts)

    def _validate(self) -> None:
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
        if self.boundary_weights:
            missing = [s.name for s in self.ops.ops if s.spec is None]
            if missing:
                raise ValueError(
                    "boundary_weights=True needs OperatorSpec metadata "
                    "(derivative, accuracy, spacing) on every operator "
                    "to build the offset weight rows — missing on "
                    f"{missing}; build the set with axis_stencil/"
                    "laplacian_stencil/derivative_operator_set"
                )
        if self.strategy == "auto" and self.block != "auto":
            raise ValueError(
                "strategy='auto' resolves the block through the "
                "cross-strategy tuning search — pass block='auto' "
                f"(or None), not {self.block!r}"
            )
        if isinstance(self.block, str) and self.block != "auto":
            raise ValueError(
                f"block must be a rank-length tuple, 'auto', or None, "
                f"got {self.block!r}"
            )
        if isinstance(self.fuse_steps, str):
            if self.fuse_steps != "auto":
                raise ValueError(
                    f"fuse_steps must be an int >= 1 or 'auto', got "
                    f"{self.fuse_steps!r}"
                )
            if self.strategy == "hwc" or self.block != "auto":
                raise ValueError(
                    "fuse_steps='auto' resolves through the joint "
                    "(block, depth) tuning search — it requires "
                    "strategy='swc', 'swc_stream', 'tc' or 'auto' and "
                    "block='auto'"
                )
        elif self.fuse_steps < 1:
            raise ValueError(
                f"fuse_steps must be >= 1, got {self.fuse_steps}"
            )
        depth = self._depth_or_none()
        if depth != 1:
            if any(m != "periodic" for m in modes):
                raise ValueError(
                    "temporal fusion requires boundary_mode='periodic' "
                    "on every axis: intermediate sweeps consume "
                    "pre-padded ghost cells and never re-impose the "
                    "boundary, which only composes exactly for the "
                    f"periodic wrap (got {self.boundary_mode!r})"
                )
        if isinstance(self.phi, (tuple, list)):
            if depth is None:
                raise ValueError(
                    "a per-step phi sequence pins the fusion depth to "
                    f"len(phi) = {len(self.phi)} — pass that as "
                    "fuse_steps instead of 'auto'"
                )
            if len(self.phi) != depth:
                raise ValueError(
                    f"phi sequence has {len(self.phi)} entries for "
                    f"fuse_steps={depth}"
                )
        if self.strategy in DEVICE_STRATEGIES:
            phi_sequence(self.phi, depth or 1)  # DevicePhis, one kind

    def _depth_or_none(self) -> int | None:
        """The concrete fusion depth, or None while it is tuned."""
        return None if self.fuse_steps == "auto" else int(self.fuse_steps)

    @property
    def needs_resolution(self) -> bool:
        """Whether a launch decision (strategy, depth, or a kernel's
        tile) is still ``"auto"``: :meth:`resolved` turns such an op
        concrete."""
        return (self.strategy == "auto" or self.fuse_steps == "auto"
                or (self.block == "auto"
                    and self.strategy in DEVICE_STRATEGIES))

    def resolved(
        self, f: torch.Tensor, aux: torch.Tensor | None = None
    ) -> "FusedStencilOp":
        """An equivalent, concrete op for the UNPADDED stack ``f`` (and
        its ``aux``): itself when nothing is ``"auto"``; with
        ``strategy="auto"`` the cross-strategy search's (strategy,
        block, depth), with ``fuse_steps="auto"`` the joint (block,
        depth) search's, with only ``block="auto"`` the tile search's at
        the fixed strategy and depth (on ``f`` padded as :meth:`forward`
        pads it). Timed on the card on a cache miss, the model's on a
        CPU tensor, replayed from the persistent record after that — so
        the op is the same on every call. The concrete op is kept per
        operand signature, so a later call resolves by a dict lookup,
        its tap tables on this op's device."""
        if not self.needs_resolution:
            return self
        sig = (tuple(f.shape), f.dtype, f.device,
               None if aux is None else tuple(aux.shape))
        if sig in self._resolved:
            return self._resolved[sig]
        from repro_torch.tuning import session

        if self.strategy == "auto":
            strategy, block, depth = session.auto_strategy_nd(
                f, self.ops, self.phi, self.n_out, aux=aux,
                fuse_steps=self.fuse_steps,
            )
        elif self.fuse_steps == "auto":
            strategy = self.strategy
            block, depth = session.auto_fuse_nd(
                f, self.ops, self.phi, self.n_out, aux=aux,
                strategy=self.strategy,
            )
        else:
            strategy, depth = self.strategy, int(self.fuse_steps)
            fp, aux_p = self._pad(f, aux)
            block = session.auto_block_nd(
                fp, self.ops, self.phi, self.n_out, aux=aux_p,
                strategy=strategy, fuse_steps=depth,
                taps=(self.tap_offsets, self.tap_coeffs, self.tap_starts),
            )
        self._resolved[sig] = self._replace(
            strategy=strategy, block=tuple(block), fuse_steps=int(depth))
        return self._resolved[sig]

    def _replace(self, **changes) -> "FusedStencilOp":
        """A copy with ``changes`` to its constructor arguments, its tap
        tables on this op's device."""
        args = dict(
            ops=self.ops, phi=self.phi, n_out=self.n_out,
            boundary_mode=self.boundary_mode, strategy=self.strategy,
            block=self.block, fuse_steps=self.fuse_steps,
            boundary_weights=self.boundary_weights,
            device=self.tap_offsets.device,
        )
        args.update(changes)
        return FusedStencilOp(**args)

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
        dispatch detects the member axis by rank. Needs a concrete
        strategy and depth (the ghost-cell width depends on them):
        resolve an ``"auto"`` op first."""
        if self.needs_resolution:
            raise ValueError(
                "apply_padded needs a concrete strategy and fuse_steps "
                "(the kernel and its ghost-cell width depend on them) "
                "— resolve via op.resolved(f)(f) or call the op"
            )
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
        axis. An ``"auto"`` op resolves first (:meth:`resolved`)."""
        if self.needs_resolution:
            return self.resolved(f, aux)(f, aux)
        fp, aux_p = self._pad(f, aux)
        out = self.apply_padded(fp, aux=aux_p)
        if self.boundary_weights and any(
                m != "periodic" for m in self.boundary_modes):
            out = self.blend_boundary_weights(f, out, aux_p)
        return out

    def _pad(
        self, f: torch.Tensor, aux: torch.Tensor | None
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """``f`` padded by ``radius * fuse_steps`` ghost cells with the
        boundary function, ``aux`` by ``radius * (fuse_steps - 1)``."""
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
        return fp, aux

    def blend_boundary_weights(
        self,
        f: torch.Tensor,
        out: torch.Tensor,
        aux: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """Overwrite, in place, the cells of ``out`` within ``r`` of a
        non-periodic face with φ of the boundary-accurate derivatives
        of ``f`` (the post-pass of ``boundary_weights=True``, depth 1:
        ``_validate`` pins non-periodic ops there); returns ``out``.

        Every other cell keeps the kernel's value bit for bit. The
        reference evaluates the whole domain with dense matrices and
        masks; this evaluates only the wall slabs: for each non-periodic
        axis the r planes at each face, through D's rows for those
        planes along that axis and the whole D along the others. A cell
        in two slabs gets the same value from either, up to summation
        order. A batched (batch, n_f, …) stack is blended member by
        member, as the reference's ``vmap`` does. Both faces of an axis
        go through one evaluation.
        """
        phi = self.phi[0] if isinstance(self.phi, (tuple, list)) else self.phi
        lead = out.ndim - self.ops.ndim
        members = (
            [(f[m], out[m], None if aux is None else aux[m])
             for m in range(f.shape[0])]
            if lead == 2 else [(f, out, aux)]
        )
        modes = self.boundary_modes
        for a, (r, mode) in enumerate(zip(self.radius_per_axis, modes)):
            n = f.shape[lead + a]
            if mode == "periodic" or r == 0:
                continue
            picked = tuple(range(r)) + tuple(range(n - r, n))
            index = boundary.device_index(picked, out.device)
            for fm, om, am in members:
                derivs = boundary.apply_operator_set_bc(
                    fm, self.ops, modes,
                    spatial_axes=tuple(range(1, fm.ndim)),
                    rows=(a, picked),
                )
                if am is None:
                    slab = phi(derivs)
                else:
                    slab = phi(derivs, am.index_select(1 + a, index))
                om.index_copy_(1 + a, index, slab.to(om.dtype))
        return out

    def with_depth(self, fuse_steps: int) -> "FusedStencilOp":
        """The same op at another depth, buffers on the same device."""
        return self._replace(fuse_steps=fuse_steps)

    # -- distributed --------------------------------------------------------

    def apply_sharded(
        self,
        f_local: torch.Tensor,
        mesh_axes,
        aux: torch.Tensor | None = None,
        *,
        overlap: bool = False,
        mesh=None,
    ) -> torch.Tensor:
        """Exchange halos over the mesh dimensions assigned to each
        spatial axis, then run the local fused launch on this rank's
        block (on the card: the kernel the strategy names).

        Args:
            f_local: this rank's (n_f, *local_spatial) block
                (``launch.mesh.local_block``).
            mesh_axes: one entry per spatial axis — the name of the mesh
                dimension sharding it, or None (local periodic wrap).
            aux: optional (n_aux, *local_spatial) point-wise inputs
                forwarded to φ (exchanged at ``radius·(fuse_steps-1)``
                when depth > 1).
            overlap: post the exchange, launch the halo-independent
                interior from local data, then wait and launch the
                ``2 x (sharded axes)`` edge slabs from the exchanged
                array; numerics unchanged.
            mesh: the :class:`~torch.distributed.device_mesh.DeviceMesh`
                whose dimensions ``mesh_axes`` names (``shard_map``'s
                scope carries it in the reference; here it is passed).

        Returns:
            The (n_out, *local_spatial) update for this rank's block.

        Raises:
            ValueError: when ``mesh_axes`` does not have exactly one
                entry per spatial dimension, or names an axis without a
                ``mesh``.
            NotImplementedError: for non-periodic boundary modes.

        Periodic boundaries compose exactly with the ring exchange: the
        wrap-around neighbour IS the periodic image. At depth S the
        exchanged halo is ``radius * S`` per sharded axis: one exchange
        buys S time steps. An ``"auto"`` op resolves on the mesh's first
        rank and broadcasts the (strategy, block, depth) it chose to
        every rank, so all ranks run one plan (and only one process
        tunes the shared card and writes the tuning cache).
        """
        n_spatial = f_local.ndim - 1
        if len(mesh_axes) != n_spatial:
            raise ValueError(
                f"mesh_axes has {len(mesh_axes)} entries but the field "
                f"stack has {n_spatial} spatial dims — pass one mesh-axis "
                "name (or None) per spatial dimension"
            )
        if any(m != "periodic" for m in self.boundary_modes):
            raise NotImplementedError(
                "sharded stencils currently support periodic boundaries "
                "(the paper's simulation setup)"
            )
        if self.needs_resolution:
            return self._resolved_on_mesh(f_local, aux, mesh).apply_sharded(
                f_local, mesh_axes, aux, overlap=overlap, mesh=mesh)
        if overlap:
            out = self._apply_sharded_overlap(f_local, mesh_axes, aux, mesh)
            if out is not None:
                sharded_counts["overlap"] += 1
                return out
        sharded_counts["plain"] += 1
        depth = int(self.fuse_steps)
        fp = halo.exchange_halos_nd(
            f_local, [r * depth for r in self.radius_per_axis], mesh_axes,
            spatial_axes=tuple(range(1, f_local.ndim)), mesh=mesh,
            staging=self._staging,
        )
        if aux is not None and depth > 1:
            aux = halo.exchange_halos_nd(
                aux, [r * (depth - 1) for r in self.radius_per_axis],
                mesh_axes, spatial_axes=tuple(range(1, aux.ndim)),
                mesh=mesh, staging=self._staging,
            )
        return self.apply_padded(fp, aux=aux)

    def _resolved_on_mesh(self, f_local, aux, mesh) -> "FusedStencilOp":
        """:meth:`resolved` on the mesh's first rank, its (strategy,
        block, depth) broadcast to every rank and kept under the same
        operand signature there. The mesh must hold every rank of the
        process group (``launch.mesh.make_mesh`` builds such meshes)."""
        if mesh is None:
            return self.resolved(f_local, aux)
        sig = (tuple(f_local.shape), f_local.dtype, f_local.device,
               None if aux is None else tuple(aux.shape))
        if sig in self._resolved:
            return self._resolved[sig]
        if mesh.mesh.numel() != dist.get_world_size():
            raise ValueError(
                "an 'auto' op resolves on a mesh that holds every rank of "
                f"the process group ({dist.get_world_size()}); this mesh "
                f"holds {mesh.mesh.numel()}"
            )
        src = int(mesh.mesh.flatten()[0])
        plan = [None]
        if dist.get_rank() == src:
            op = self.resolved(f_local, aux)
            plan = [(op.strategy, op.block, op.fuse_steps)]
        dist.broadcast_object_list(plan, src=src)
        strategy, block, depth = plan[0]
        if dist.get_rank() != src:
            self._resolved[sig] = self._replace(
                strategy=strategy, block=tuple(block), fuse_steps=int(depth))
        return self._resolved[sig]

    def _apply_sharded_overlap(
        self, f_local: torch.Tensor, mesh_axes, aux, mesh
    ) -> torch.Tensor | None:
        """The compute/communication overlap decomposition at depth
        ``S = fuse_steps``: the halo every output point consumes is
        ``radius·S`` per sharded axis, so the halo-independent interior
        shrinks by that much per side and the dependent edge slabs are
        that wide; the carry ``aux`` is consumed at ``radius·(S-1)``
        ghost cells, so it is exchanged at that width and every launch
        slices its aligned aux window.

        Returns None when the decomposition doesn't apply (no sharded
        axis, or a local extent too small to hold an interior); the
        caller then takes the plain exchange-then-apply path.
        """
        depth = int(self.fuse_steps)
        rads = self.radius_per_axis
        wrads = [r * depth for r in rads]  # halo consumed per output
        arads = [r * (depth - 1) for r in rads]  # aux ghost width
        spatial_axes = tuple(range(1, f_local.ndim))
        sharded = [
            (ax, w)
            for ax, w, name in zip(spatial_axes, wrads, mesh_axes)
            if name is not None and w > 0
        ]
        if not sharded:
            return None  # nothing to overlap with
        if any(f_local.shape[ax] <= 2 * w for ax, w in sharded):
            return None  # no interior: every point depends on halos

        # Post the exchange FIRST: its sends read only edge planes, the
        # interior launch below only local data.
        pending = halo.post_halos_nd(
            f_local, wrads, mesh_axes, spatial_axes=spatial_axes,
            mesh=mesh, staging=self._staging,
        )
        # Interior: along each sharded axis the local block IS the
        # interior plus its (not-yet-arrived) halo, so it only needs the
        # local periodic wrap on the unsharded axes; its aux window lies
        # inside the local aux (radius·S >= radius·(S-1)).
        unsharded = [0 if name is not None else w
                     for w, name in zip(wrads, mesh_axes)]
        f_interior_padded = boundary.pad(
            f_local, unsharded, "periodic", spatial_axes=spatial_axes
        ).contiguous()
        int_sl = [slice(None)] * f_local.ndim
        aux_sl = [slice(None)] * f_local.ndim
        for ax, w in sharded:
            a = arads[ax - 1]
            int_sl[ax] = slice(w, f_local.shape[ax] - w)
            aux_sl[ax] = slice(w - a, f_local.shape[ax] - w + a)
        aux_int = None
        if aux is not None:
            aux_int = boundary.pad(
                aux, [0 if name is not None else a
                      for a, name in zip(arads, mesh_axes)],
                "periodic", spatial_axes=spatial_axes,
            )[tuple(aux_sl)].contiguous()
        try:
            out_interior = self.apply_padded(f_interior_padded, aux=aux_int)
        finally:  # complete the exchange even if the launch raised
            fp = pending.wait()
        aux_p = None
        if aux is not None:
            aux_p = halo.exchange_halos_nd(
                aux, arads, mesh_axes, spatial_axes=spatial_axes,
                mesh=mesh, staging=self._staging,
            )
        out = out_interior.new_empty((self.n_out,) + f_local.shape[1:])
        out[tuple(int_sl)] = out_interior
        # Edge slabs depend on the exchanged halos: each from the padded
        # array. Slabs span the full extent of the other axes, so corner
        # regions are (idempotently) covered.
        _, edges = halo.interior_first(
            f_local, [w for _, w in sharded], [ax for ax, _ in sharded])
        for ax, sl in edges:
            s = sl.start or 0
            e = f_local.shape[ax] if sl.stop is None else sl.stop
            w_ax, a_ax = wrads[ax - 1], arads[ax - 1]
            # The kernels read contiguous stacks: each slab is copied out.
            slab_aux = None
            if aux_p is not None:
                slab_aux = aux_p.narrow(ax, s, e - s + 2 * a_ax).contiguous()
            slab_out = self.apply_padded(
                fp.narrow(ax, s, e - s + 2 * w_ax).contiguous(), aux=slab_aux)
            out.narrow(ax, s, e - s).copy_(slab_out)
        return out


def integrate(
    op: FusedStencilOp, f0: torch.Tensor, n_steps: int
) -> torch.Tensor:
    """Iterate f ← φ(A·B(ψ(f))) for ``n_steps`` TIME steps (paper Fig. 1).

    Each call of the op advances ``op.fuse_steps`` steps; a remainder
    ``n_steps % fuse_steps`` is finished with a shallower op so the step
    count is exact. An ``"auto"`` strategy or depth is resolved once, up
    front, against ``f0``; the remainder does not reuse a block tuned
    for the full depth: when the caller asked for ``block="auto"`` it
    resolves under its own depth's key (an explicit block is reused).

    Raises:
        ValueError: when ``op.phi`` is a per-step sequence at depth > 1.
    """
    requested_block = op.block  # before resolution makes it concrete
    op = op.resolved(f0)
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
        block = "auto" if requested_block == "auto" else op.block
        f = op._replace(fuse_steps=rem, block=block)(f)
    return f
