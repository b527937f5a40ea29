"""Process meshes for the sharded stencil and data-parallel training
(port of ``repro.launch.mesh``).

JAX's single controller names mesh axes for ``shard_map``; here every
rank is a process of an initialized ``torch.distributed`` group, and
:func:`make_mesh` names the group's dimensions with a
:class:`~torch.distributed.device_mesh.DeviceMesh`. The counterparts of
``shard_map``'s specs: :func:`local_block` cuts the block of a global
``(n_f, *spatial)`` tensor that this rank owns under ``mesh_axes`` (one
mesh-dimension name, or None, per spatial axis), and
:func:`assemble_blocks` puts the ranks' blocks back together.

:func:`run_on_mesh` is the launcher: it spawns one process per mesh
position (the ``spawn`` start method, which CUDA needs), initializes the
group through a ``FileStore`` in a temporary directory (no port number,
so concurrent launches never collide), builds the mesh, calls
``fn(mesh, *args)`` on every rank and returns each rank's small result.
The caller names the backend: ``gloo`` (CPU tensors, or CUDA tensors
staged through host memory, several ranks on one card) or ``nccl``
(one card per rank).

:func:`make_production_mesh` is the reference's production layout,
``(data=16, model=16)`` or ``(pod=2, data=16, model=16)`` with ``pod``
outermost, over a group of exactly 256 or 512 ranks; :func:`parse_mesh`
reads the train CLI's ``--mesh DxM`` / ``PxDxM`` into a shape and axis
names (each rank then builds the mesh itself, in :func:`run_on_mesh`).
"""
from __future__ import annotations

import math
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device


def make_mesh(shape, axes, *, device=None):
    """A DeviceMesh of ``shape`` over the initialized process group's
    ranks in order, its dimensions named ``axes``, on ``device``'s type
    (``None``: the card; ``"cpu"`` for CPU ranks).

    Raises:
        RuntimeError: without an initialized process group.
        ValueError: when ``shape`` and ``axes`` differ in length or the
            mesh does not hold exactly the group's ranks.
    """
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process "
            "group (run_on_mesh starts one per rank)"
        )
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh {shape} holds {math.prod(shape)} ranks; the group has "
            f"{world}"
        )
    device = resolve_device(device)
    return DeviceMesh(
        device.type, torch.arange(world).reshape(shape),
        mesh_dim_names=axes,
    )


# The reference's production meshes (``repro.launch.mesh:30``).
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh over the initialized group: ``(data=16,
    model=16)``, or ``(pod=2, data=16, model=16)`` with ``multi_pod``.

    Raises:
        RuntimeError: without an initialized process group.
        ValueError: when the group does not hold exactly its 256 (512)
            ranks.
    """
    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    if not dist.is_initialized():
        raise RuntimeError(
            "make_production_mesh needs an initialized torch.distributed "
            "process group of one rank per chip"
        )
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} holds "
            f"{math.prod(shape)} ranks; this group has {world} (use "
            "make_mesh for any other layout)"
        )
    return make_mesh(shape, axes, device=device)


def parse_mesh(s: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"DxM"`` → ((D, M), ("data", "model")); ``"PxDxM"`` → ((P, D, M),
    ("pod", "data", "model")): the reference's ``--mesh`` grammar
    (``repro.launch.train:32``), as a shape and axis names.

    Raises:
        ValueError: for any other form, or a size below 1.
    """
    try:
        dims = tuple(int(x) for x in s.lower().split("x"))
    except ValueError:
        dims = ()
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(
            f"--mesh {s!r}: want DxM or PxDxM with sizes of at least 1")
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return dims, axes


def mesh_chip_count(mesh) -> int:
    """Ranks in the mesh."""
    return int(mesh.mesh.numel())


def _mesh_dims(mesh_axes: Sequence[str | None], names: Sequence[str]):
    used = [a for a in mesh_axes if a is not None]
    unknown = [a for a in used if a not in names]
    if unknown or len(set(used)) != len(used):
        raise ValueError(
            f"mesh_axes {tuple(mesh_axes)} must name distinct dimensions "
            f"of the mesh {tuple(names)} (or None)"
        )
    return [None if a is None else list(names).index(a) for a in mesh_axes]


def _block_slices(global_shape, mesh_axes, dims, sizes, coords):
    """Per-axis slices of the block at mesh coordinates ``coords``."""
    slices = [slice(None)] * len(global_shape)
    for a, dim in enumerate(dims):
        if dim is None:
            continue
        n, ax = sizes[dim], 1 + a
        if global_shape[ax] % n:
            raise ValueError(
                f"axis {ax} of extent {global_shape[ax]} does not split "
                f"into {n} equal blocks over mesh dimension "
                f"{mesh_axes[a]!r}"
            )
        width = global_shape[ax] // n
        slices[ax] = slice(coords[dim] * width, (coords[dim] + 1) * width)
    return tuple(slices)


def local_block(
    f: torch.Tensor, mesh, mesh_axes: Sequence[str | None]
) -> torch.Tensor:
    """This rank's block of the global (n_f, *spatial) ``f``, one entry
    of ``mesh_axes`` per spatial axis: each named axis cut into equal
    blocks over its mesh dimension, as ``shard_map``'s
    ``in_specs=P(None, *mesh_axes)`` gives it. A view of ``f``."""
    names = mesh.mesh_dim_names
    if f.ndim != 1 + len(mesh_axes):
        raise ValueError(
            f"f of shape {tuple(f.shape)} is not (n_f, *spatial) with "
            f"{len(mesh_axes)} spatial axes"
        )
    dims = _mesh_dims(mesh_axes, names)
    sizes = [mesh.size(d) for d in range(len(names))]
    coords = [mesh.get_local_rank(n) for n in names]
    return f[_block_slices(f.shape, mesh_axes, dims, sizes, coords)]


def assemble_blocks(
    blocks: Sequence[torch.Tensor],
    mesh_shape: Sequence[int],
    mesh_dim_names: Sequence[str],
    mesh_axes: Sequence[str | None],
) -> torch.Tensor:
    """The global tensor from the blocks of every rank (``blocks[rank]``,
    ranks in :func:`make_mesh`'s order), as ``shard_map``'s
    ``out_specs=P(None, *mesh_axes)`` joins them; ranks that differ
    only along a dimension no axis names hold copies, of which the
    first is kept."""
    mesh_shape = tuple(int(n) for n in mesh_shape)
    if len(blocks) != math.prod(mesh_shape):
        raise ValueError(
            f"{len(blocks)} blocks for a mesh of {math.prod(mesh_shape)}")
    dims = _mesh_dims(mesh_axes, mesh_dim_names)
    shape = list(blocks[0].shape)
    for a, dim in enumerate(dims):
        if dim is not None:
            shape[1 + a] *= mesh_shape[dim]
    out = blocks[0].new_empty(shape)
    for rank, block in enumerate(blocks):
        coords = [int(c) for c in torch.unravel_index(
            torch.tensor(rank), mesh_shape)]
        if any(c and d not in dims for d, c in enumerate(coords)):
            continue  # a copy along an unnamed dimension
        out[_block_slices(shape, mesh_axes, dims, mesh_shape, coords)] = block
    return out


def _rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: the CPU for ``"cpu"``, else card ``rank
    % device_count`` (several ranks share a card when there are fewer
    cards than ranks)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        resolve_device(device)  # raises: no card
    return torch.device("cuda", rank % count)


def _rank_main(rank, world, store_path, shape, axes, backend, device, fn,
               args, results):
    """One rank: the group, the mesh, ``fn(mesh, *args)``; reports
    ``(rank, ok, result or traceback)`` on ``results``."""
    try:
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world)
        try:
            out = fn(make_mesh(shape, axes, device=dev), *args)
        finally:
            dist.destroy_process_group()
    except Exception as err:  # the rank's boundary: report, then fail
        results.put((rank, False, "".join(traceback.format_exception(err))))
        raise
    # Pickled by value here: a tensor put on the queue as it is would
    # travel as a shared-memory handle that dies with this process.
    results.put((rank, True, pickle.dumps(out)))


def run_on_mesh(
    fn: Callable,
    shape: Sequence[int],
    axes: Sequence[str],
    *,
    backend: str,
    device=None,
    args: tuple = (),
    timeout: float = 600.0,
) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a fresh ``shape`` mesh,
    one spawned process per rank, and return the ranks' results in rank
    order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path: a
    module-level function). ``device``: ``"cpu"`` for CPU ranks, else
    each rank takes card ``rank % device_count``. Every process is
    stopped before this returns.

    Raises:
        RuntimeError: when a rank raises (with its traceback) or exits
            without a result.
        TimeoutError: when the ranks have not all reported after
            ``timeout`` seconds.
    """
    import multiprocessing

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    world = math.prod(shape)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro-mesh-") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [
            ctx.Process(
                target=_rank_main, daemon=True,
                args=(rank, world, store_path, shape, axes, backend,
                      device, fn, args, results),
            )
            for rank in range(world)
        ]
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        try:
            deadline = time.monotonic() + timeout
            while len(got) < world:
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue_mod.Empty:
                    lost = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if lost:
                        raise RuntimeError(
                            f"rank {lost[0]} exited with code "
                            f"{procs[lost[0]].exitcode} without a result"
                        ) from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world - len(got)} of {world} ranks did not "
                            f"report within {timeout} s"
                        ) from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = pickle.loads(payload)  # written by our rank
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
            results.close()
    return [got[r] for r in range(world)]
