"""Halo exchange over ``torch.distributed`` (port of ``repro.core.halo``).

Astaroth's MPI halo exchange (paper Sec. 4.4): each rank owns a
contiguous block of the domain; before a stencil application it receives
the ``r`` boundary planes of its neighbours along every decomposed axis.
The rank's position comes from a
:class:`~torch.distributed.device_mesh.DeviceMesh` (``launch.mesh``),
each sharded spatial axis named by one of its dimensions; the exchange
along that axis is a ring over the dimension's process group: every rank
sends its right edge to rank ``(i + 1) % n`` and its left edge to rank
``(i - 1) % n`` in one ``dist.batch_isend_irecv``. The ring's wrap IS the
periodic image, so the padded block equals the slice of the globally
padded field bit for bit.

Routes, by the group's backend and the field's device (none falls back
to another):

* ``gloo`` and a CPU tensor, ``nccl`` and a CUDA tensor: the edge slabs
  (made contiguous; a slab cut along an inner axis is strided) travel as
  they are.
* ``gloo`` and a CUDA tensor: gloo's point-to-point calls take host
  memory, so each slab is staged through pinned host buffers
  (:class:`Staging`, allocated once per shape and dtype and reused): a
  device-to-host copy on the staging's side stream, a wait on its
  event, the send and receive, then a host-to-device copy on the side
  stream, which the caller's stream waits on before it reads the
  padded array. Work queued on the caller's stream meanwhile (the
  interior launch of ``FusedStencilOp.apply_sharded(..., overlap=True)``)
  runs beside the whole exchange.

An axis of one rank wraps locally and sends nothing (``ppermute`` over
one device is the identity). On an axis of two ranks both neighbours are
the same rank, so the two directions carry distinct tags and every rank
posts them in one fixed order.

:func:`post_halos_nd` starts an exchange and returns a
:class:`PendingHalos`; its ``wait()`` completes it. Counts
(:data:`counts`: exchanges, messages, bytes this rank sent) let a caller
read what an exchange moved; :func:`reset_counts` zeroes them.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core import boundary
from repro_torch.distrib import comm

# Tags of the two directions: a message travelling to the right (a
# rank's right edge, its neighbour's left halo) and one travelling left.
TAG_RIGHTWARD = 1
TAG_LEFTWARD = 2

# exchanges (1-D exchanges that sent messages), messages and bytes sent
# by this process since the last reset_counts().
counts: collections.Counter = collections.Counter()


def reset_counts() -> None:
    """Zero :data:`counts`."""
    counts.clear()


def axis_size(mesh, axis_name: str) -> int:
    """Size of the mesh dimension named ``axis_name``."""
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


class Staging:
    """Pinned host buffers (a ``distrib.comm.PinnedPool`` of its own) and
    a side stream for the gloo route of CUDA tensors. An exchange's
    roles name the field's shape and axis, so each buffer is allocated
    once per (role, shape, dtype) and reused by every later exchange of
    that shape; the exchanges of one :class:`Staging` must not run
    concurrently (one op's exchanges run one after another)."""

    def __init__(self):
        self._pool = comm.PinnedPool()
        self._streams: dict[torch.device, torch.cuda.Stream] = {}

    def buffer(self, role: str, shape, dtype: torch.dtype) -> torch.Tensor:
        return self._pool.buffer(role, shape, dtype)

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device=device)
        return self._streams[device]


class _Exchange1D:
    """One ring exchange along one sharded axis, posted at construction
    (messages in flight), completed by :meth:`wait`. Runs on the current
    stream (the exchange's side stream for a CUDA tensor)."""

    def __init__(self, f, radius, mesh, axis_name, axis, staging):
        n_ax = f.shape[axis]
        if radius > n_ax:
            raise ValueError(
                f"halo radius {radius} exceeds the local extent {n_ax} "
                f"of axis {axis}: each rank's block must hold the "
                "planes its neighbours need"
            )
        self.f, self.axis = f, axis
        group = mesh.get_group(axis_name)
        n = axis_size(mesh, axis_name)
        i = mesh.get_local_rank(axis_name)
        right = dist.get_global_rank(group, (i + 1) % n)
        left = dist.get_global_rank(group, (i - 1) % n)
        self.staged = comm.route(group, f) == "staged"
        right_edge = f.narrow(axis, n_ax - radius, radius)  # goes right
        left_edge = f.narrow(axis, 0, radius)  # goes left
        shape = list(f.shape)
        shape[axis] = radius
        if self.staged:
            key = f"{tuple(f.shape)}:{axis}"
            send_r, send_l, recv_l, recv_r = (
                staging.buffer(role + key, shape, f.dtype)
                for role in ("send_r", "send_l", "recv_l", "recv_r"))
            send_r.copy_(right_edge, non_blocking=True)
            send_l.copy_(left_edge, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            copied.synchronize()
        else:
            send_r = right_edge.contiguous()
            send_l = left_edge.contiguous()
            recv_l = torch.empty(shape, dtype=f.dtype, device=f.device)
            recv_r = torch.empty(shape, dtype=f.dtype, device=f.device)
        self.recv_l, self.recv_r = recv_l, recv_r
        self._sends = (send_r, send_l)  # alive until the sends complete
        # One order on every rank: the rightward pair, then the leftward.
        self.works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send_r, right, group, TAG_RIGHTWARD),
            dist.P2POp(dist.irecv, recv_l, left, group, TAG_RIGHTWARD),
            dist.P2POp(dist.isend, send_l, left, group, TAG_LEFTWARD),
            dist.P2POp(dist.irecv, recv_r, right, group, TAG_LEFTWARD),
        ])
        counts["exchanges"] += 1
        counts["messages"] += 2
        counts["bytes"] += 2 * send_r.numel() * send_r.element_size()

    def wait(self) -> torch.Tensor:
        for work in self.works:
            work.wait()
        self._sends = None
        from_left, from_right = self.recv_l, self.recv_r
        if self.staged:
            dev = self.f.device
            from_left = from_left.to(dev, non_blocking=True)
            from_right = from_right.to(dev, non_blocking=True)
        return torch.cat([from_left, self.f, from_right], dim=self.axis)


class PendingHalos:
    """An N-D exchange in flight: the unsharded axes before the first
    sharded one are wrapped and that axis's messages are posted; the
    rest of the chain runs in :meth:`wait`, axis by axis on the already
    padded array (a later axis's sends carry the earlier axes' halos,
    so they wait on its receives)."""

    def __init__(self, f, radii, mesh_axes, spatial_axes, mesh, staging):
        if not (len(radii) == len(mesh_axes) == len(spatial_axes)):
            raise ValueError(
                f"radii ({len(radii)}), mesh_axes ({len(mesh_axes)}) and "
                f"spatial_axes ({len(spatial_axes)}) must have one entry "
                "per spatial dimension"
            )
        self.steps = [
            (int(r), name, ax)
            for r, name, ax in zip(radii, mesh_axes, spatial_axes) if r
        ]
        if mesh is None and any(name is not None for _, name, _ in self.steps):
            raise ValueError(
                "a sharded axis needs the DeviceMesh that names it "
                "(pass mesh=...)"
            )
        self.mesh = mesh
        self.staging = staging if staging is not None else Staging()
        self.caller = self.stream = None
        if f.device.type == "cuda":
            # The chain runs on a side stream that first waits for the
            # caller's (f's producer), so the caller's later work runs
            # beside it.
            self.caller = torch.cuda.current_stream(f.device)
            self.stream = self.staging.stream(f.device)
            self.stream.wait_stream(self.caller)
            f.record_stream(self.stream)
        self.out = f
        self.pending: _Exchange1D | None = None
        with self._on_side():
            self._advance()

    def _on_side(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _advance(self) -> None:
        """Wrap unsharded axes until the next sharded one, and post it."""
        while self.steps:
            r, name, ax = self.steps.pop(0)
            if name is None or axis_size(self.mesh, name) == 1:
                self.out = boundary.pad(
                    self.out, [r], "periodic", spatial_axes=[ax])
                continue
            self.pending = _Exchange1D(
                self.out, r, self.mesh, name, ax, self.staging)
            return

    def wait(self) -> torch.Tensor:
        """Complete the chain and return the padded array, ready on the
        caller's stream."""
        with self._on_side():
            while self.pending is not None:
                self.out = self.pending.wait()
                self.pending = None
                self._advance()
        if self.stream is not None:
            self.caller.wait_stream(self.stream)
            self.out.record_stream(self.caller)
            self.stream = None
        return self.out


def post_halos_nd(
    f: torch.Tensor,
    radii: Sequence[int],
    mesh_axes: Sequence[str | None],
    *,
    spatial_axes: Sequence[int],
    mesh=None,
    staging: Staging | None = None,
) -> PendingHalos:
    """Start :func:`exchange_halos_nd`; ``.wait()`` on the result returns
    the padded array. Work the caller queues between the two overlaps
    the exchange."""
    return PendingHalos(f, radii, mesh_axes, spatial_axes, mesh, staging)


def exchange_halo_1d(
    f: torch.Tensor,
    radius: int,
    mesh,
    axis_name: str,
    *,
    axis: int,
    staging: Staging | None = None,
) -> torch.Tensor:
    """Exchange ``radius`` planes with both ring neighbours along one
    sharded array axis (the mesh dimension ``axis_name``). Returns the
    locally padded array (local + 2·radius along ``axis``).

    Periodic global boundary: the ring wrap supplies the periodic image.
    """
    return post_halos_nd(
        f, [radius], [axis_name], spatial_axes=[axis], mesh=mesh,
        staging=staging,
    ).wait()


def exchange_halos_nd(
    f: torch.Tensor,
    radii: Sequence[int],
    mesh_axes: Sequence[str | None],
    *,
    spatial_axes: Sequence[int],
    mesh=None,
    staging: Staging | None = None,
) -> torch.Tensor:
    """Pad every spatial axis: the ring exchange where sharded, the
    local periodic wrap where not. Corner and edge regions come out
    right because the exchanges run one axis after another on the
    already-padded array — the dimension-by-dimension halo
    factorization.

    Raises:
        ValueError: when ``radii``, ``mesh_axes`` and ``spatial_axes``
            differ in length, or a sharded axis has no ``mesh``.
    """
    return post_halos_nd(
        f, radii, mesh_axes, spatial_axes=spatial_axes, mesh=mesh,
        staging=staging,
    ).wait()


def interior_first(
    f_local: torch.Tensor,
    radii: Sequence[int],
    spatial_axes: Sequence[int],
) -> tuple[torch.Tensor, list[tuple[int, slice]]]:
    """Split the local block into interior (computable before any halo
    arrives) and the dependent edge slabs — the compute/communication
    overlap decomposition. Returns the interior view and the edge slab
    slices (axis, slice) for the caller to schedule after the exchange.
    """
    slicer: list[slice] = [slice(None)] * f_local.ndim
    edges: list[tuple[int, slice]] = []
    for r, ax in zip(radii, spatial_axes):
        if r == 0:
            continue
        slicer[ax] = slice(r, f_local.shape[ax] - r)
        edges.append((ax, slice(0, r)))
        edges.append((ax, slice(f_local.shape[ax] - r, None)))
    return f_local[tuple(slicer)], edges
