"""The collectives the data-parallel path calls, by route (the counterpart
of XLA's collectives that GSPMD and ``shard_map`` emit in the reference).

Three calls on a ``torch.distributed`` process group: :func:`all_reduce_`
(a sum in place over a list of tensors, packed into flat buckets of at
most :data:`BUCKET_BYTES`), :func:`reduce_scatter` and
:func:`all_gather` (along dim 0, rank ``i`` of the group owning rows
``[i·k, (i+1)·k)``, as ``psum_scatter`` / ``all_gather`` with
``tiled=True`` do). Only calls that exist in every PyTorch this port
runs on are used: ``all_reduce``, ``reduce_scatter_tensor`` and
``all_gather_into_tensor`` (newer builds mark the last two deprecated in
favour of ``*_single`` names that older ones lack; the warning is
silenced where they are called).

Routes, by the group's backend and the tensor's device (none falls back
to another):

* ``gloo`` and a CPU tensor, ``nccl`` and a CUDA tensor: the collective
  runs on the tensors (the flat bucket on their device) as they are.
* ``fake`` (``torch.testing``'s backend whose collectives move
  nothing: the dry run's single-process mesh, ``launch.dryrun``), any
  tensor, meta ones included: the call is made as it is and counted.
* ``gloo`` and a CUDA tensor: gloo reduces host memory, so each bucket
  is staged through pinned host buffers (:class:`PinnedPool`; the
  collectives share :data:`STAGING`'s two, a send and a receive buffer
  per dtype of at most one bucket each): copied to the host, reduced
  there, copied back. A large reduce-scatter or all-gather runs in
  column chunks of the ``(ranks, k)`` view so that each staging buffer
  stays one bucket. ``core.halo.Staging`` keeps its buffers in a pool of
  its own.

:data:`counts` holds, per process since :func:`reset_counts`, the calls
made and the bytes this rank sends by the ring algorithms' count: an
all-reduce of B bytes over n ranks sends 2(n−1)/n·B, a reduce-scatter of
B input bytes (n−1)/n·B, an all-gather of B output bytes (n−1)/n·B.
"""
from __future__ import annotations

import collections
import contextlib
import math
import warnings

import torch
import torch.distributed as dist

# A flat bucket of one collective call, in bytes.
BUCKET_BYTES = 256 * 2**20

# calls and modelled bytes sent by this process since reset_counts().
counts: collections.Counter = collections.Counter()


def reset_counts() -> None:
    """Zero :data:`counts`."""
    counts.clear()


def group_size(group) -> int:
    """Ranks in ``group`` (None: a group of this rank alone)."""
    return 1 if group is None else dist.get_world_size(group)


def route(group, t: torch.Tensor) -> str:
    """``"direct"`` or ``"staged"`` for ``group``'s backend and ``t``'s
    device; raises for a pairing neither route covers."""
    backend = dist.get_backend(group)
    cuda = t.device.type == "cuda"
    if backend == "gloo":
        return "staged" if cuda else "direct"
    if (backend == "nccl" and cuda) or backend == "fake":
        return "direct"
    raise ValueError(
        f"no collective route for backend {backend!r} and a tensor on "
        f"{t.device}: use gloo (CPU or CUDA tensors, CUDA staged through "
        "pinned host memory), nccl (CUDA tensors) or fake (a dry run)"
    )


class PinnedPool:
    """Pinned host buffers for the gloo route of CUDA tensors: one per
    (role, dtype), grown to the largest request it has served and reused
    by every later one. Calls that take the same role's buffer must not
    run concurrently."""

    def __init__(self):
        self._buffers: dict[tuple, torch.Tensor] = {}

    def buffer(self, role: str, shape, dtype: torch.dtype) -> torch.Tensor:
        """A pinned host tensor of ``shape`` and ``dtype``: the head of
        this role's buffer."""
        shape = tuple(shape)
        numel = math.prod(shape)
        key = (role, dtype)
        if key not in self._buffers or self._buffers[key].numel() < numel:
            self._buffers.pop(key, None)
            self._buffers[key] = torch.empty(numel, dtype=dtype,
                                             pin_memory=True)
        return self._buffers[key][:numel].view(shape)


# The collectives' staging: roles "send" and "recv", each at most a bucket.
STAGING = PinnedPool()


@contextlib.contextmanager
def _quiet_deprecations():
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message=".*is deprecated.*", category=FutureWarning)
        yield


def _bucket_numel(dtype: torch.dtype) -> int:
    return BUCKET_BYTES // torch.empty((), dtype=dtype).element_size()


def _pieces(tensors, cap: int):
    """The flat ``(tensor index, lo, hi)`` pieces of ``tensors`` packed
    into buckets of at most ``cap`` elements, bucket by bucket."""
    bucket, used = [], 0
    for i, t in enumerate(tensors):
        lo, n = 0, t.numel()
        while lo < n:
            take = min(n - lo, cap - used)
            bucket.append((i, lo, lo + take))
            used += take
            lo += take
            if used == cap:
                yield bucket
                bucket, used = [], 0
    if bucket:
        yield bucket


def all_reduce_(tensors, group) -> None:
    """Sum each tensor of ``tensors`` over ``group`` in place, packed into
    flat buckets by dtype. Each tensor must be contiguous. A group of one
    rank (or None) leaves them as they are."""
    n = group_size(group)
    if n == 1 or not tensors:
        return
    by_dtype: dict[torch.dtype, list] = {}
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("all_reduce_ takes contiguous tensors")
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        staged = route(group, ts[0]) == "staged"
        cap = _bucket_numel(dtype)
        flats = [t.view(-1) for t in ts]
        for bucket in _pieces(flats, cap):
            size = sum(hi - lo for _, lo, hi in bucket)
            if staged:
                buf = STAGING.buffer("send", (size,), dtype)
            else:
                buf = torch.empty(size, dtype=dtype, device=ts[0].device)
            at = 0
            for i, lo, hi in bucket:
                buf[at:at + hi - lo].copy_(flats[i][lo:hi])
                at += hi - lo
            dist.all_reduce(buf, group=group)
            at = 0
            for i, lo, hi in bucket:
                flats[i][lo:hi].copy_(buf[at:at + hi - lo])
                at += hi - lo
            counts["all_reduce"] += 1
            counts["bytes"] += 2 * (n - 1) * size * buf.element_size() // n


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of rank ``i``'s rows ``[i·k, (i+1)·k)`` of
    ``x`` (``(n·k, ...)``, contiguous): a new ``(k, ...)`` tensor."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split into "
                         f"{n} equal blocks")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    counts["reduce_scatter"] += 1
    counts["bytes"] += (n - 1) * x.numel() * x.element_size() // n
    if route(group, x) == "direct":
        with _quiet_deprecations():
            dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out
    blocks, flat_out = x.reshape(n, -1), out.view(-1)
    k = blocks.shape[1]
    step = max(1, _bucket_numel(x.dtype) // n)
    for lo in range(0, k, step):
        hi = min(k, lo + step)
        send = STAGING.buffer("send", (n * (hi - lo),), x.dtype)
        recv = STAGING.buffer("recv", (hi - lo,), x.dtype)
        send.view(n, hi - lo).copy_(blocks[:, lo:hi])
        with _quiet_deprecations():
            dist.reduce_scatter_tensor(recv, send, group=group)
        flat_out[lo:hi].copy_(recv)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (``(k, ...)``) stacked along dim 0 in group rank
    order: a new ``(n·k, ...)`` tensor."""
    n = group_size(group)
    if n == 1:
        return x.clone()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    counts["all_gather"] += 1
    counts["bytes"] += (n - 1) * out.numel() * out.element_size() // n
    if route(group, x) == "direct":
        with _quiet_deprecations():
            dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    flat_in, blocks = x.reshape(-1), out.view(n, -1)
    k = flat_in.numel()
    step = max(1, _bucket_numel(x.dtype) // n)
    for lo in range(0, k, step):
        hi = min(k, lo + step)
        send = STAGING.buffer("send", (hi - lo,), x.dtype)
        recv = STAGING.buffer("recv", (n * (hi - lo),), x.dtype)
        send.copy_(flat_in[lo:hi])
        with _quiet_deprecations():
            dist.all_gather_into_tensor(recv, send, group=group)
        blocks[:, lo:hi].copy_(recv.view(n, hi - lo))
    return out
