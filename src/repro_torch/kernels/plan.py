"""StencilPlan — the lowering contract between the fusion engine and the
CUDA ``swc`` kernel (port of ``repro.kernels.plan`` for ``strategy="swc"``).

A plan captures what the kernel launch needs: rank, tile (at depth 1
one CUDA thread per output point of a tile; at depth > 1 the φ kind's
thread count, looping over each sweep's points), element-wise unroll
along x, temporal depth, halo radii, field/output/aux counts, dtype,
and the size of the tap table the block stages beside its halo window.

Array-axis convention (matches ``repro_torch.core.stencil``): spatial
axes are ordered slowest→fastest, x always last and contiguous; tiles
follow the same order, e.g. (τz, τy, τx) at rank 3.

Hopper limits replace the TPU's: a tile is one thread block, so its
point count is bounded by 1024 threads, and the staged working set —
at depth 1 two buffers of ONE field's halo window plus the tap table,
since the kernel stages fields one at a time; at temporal depth S > 1
also every intermediate sweep's fields (:func:`temporal_smem_bytes`) —
must fit the 227 KB of shared memory a block can use. At depth S the
halo is ``radii * S`` and the planner halves a tile that does not fit.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.stencil import OperatorSet

STRATEGIES = ("swc",)

# Strategies of the reference that have no Hopper kernel yet, with the
# ROADMAP queue item that ports each.
NOT_PORTED = {
    "swc_stream": "B3 (_kernel_stream, slowest-axis streaming)",
    "tc": "B4 (_kernel_tc, banded contractions on the tensor cores)",
}

# Per-rank default tiles: 1024 threads, one output point each, x a
# multiple of the 32-thread warp so neighbouring threads read
# neighbouring addresses. Register-heavy φ kinds (MHD: 80 derivative
# values per point) need smaller tiles; their solver passes its own.
DEFAULT_BLOCKS: dict[int, tuple[int, ...]] = {
    1: (1024,),
    2: (16, 64),
    3: (4, 8, 32),
}

MAX_THREADS = 1024  # CUDA threads per block
ONE_WARP = 32  # the smallest tile the temporal planner shrinks to
MAX_FUSE_STEPS = 8  # sweeps per launch (rows of the kernels' parameter table)
MAX_TILE_Z = 64  # blockDim.z limit
SMEM_PER_BLOCK = 232_448  # 227 KB: the most shared memory one Hopper block can use

ITEMSIZE = {"float32": 4, "float64": 8}


def default_block(rank: int, max_threads: int = MAX_THREADS) -> tuple[int, ...]:
    """``DEFAULT_BLOCKS[rank]`` with the slowest axis of extent > 1
    halved (x last) until the tile holds at most ``max_threads``
    points: (4, 8, 32) → (1, 8, 32) for a 256-thread kernel."""
    block = list(DEFAULT_BLOCKS[rank])
    while _prod(block) > max_threads:
        a = next(i for i, b in enumerate(block) if b > 1)
        block[a] //= 2
    return tuple(block)


def _prod(t) -> int:
    n = 1
    for v in t:
        n *= v
    return n


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def sweep_regions(
    block: Sequence[int], radii: Sequence[int], fuse_steps: int
) -> tuple[tuple[int, ...], ...]:
    """Extents of the region each of ``fuse_steps`` sweeps evaluates:
    sweep s covers the tile widened by ``radii * (S - 1 - s)``, so the
    last lands on the tile (``emit.py:_temporal_sweeps`` of the
    reference)."""
    return tuple(
        tuple(t + 2 * r * (fuse_steps - 1 - s) for t, r in zip(block, radii))
        for s in range(fuse_steps)
    )


def temporal_smem_bytes(
    block: Sequence[int],
    radii: Sequence[int],
    fuse_steps: int,
    *,
    n_f: int,
    n_aux: int,
    itemsize: int,
    n_taps: int,
    n_ops: int,
    stage_buffers: int,
) -> int:
    """Shared memory of one block of ``csrc/fused_stencil_temporal.cu``
    (its ``layout``), each buffer padded to 16 B: ``stage_buffers``
    windows of one field (tile + 2rS); all n_f fields of sweep 0's and,
    from depth 3, sweep 1's region (the sweeps' outputs go to these two
    in turn); the n_aux carry rows of those sweeps cut by r; the tap
    table (coefficient and int32 offset, aligned to twice the itemsize)
    and the int32 operator starts."""
    regions = sweep_regions(block, radii, fuse_steps)
    window = tuple(t + 2 * r * fuse_steps for t, r in zip(block, radii))
    total = stage_buffers * _round16(_prod(window) * itemsize)
    for i in range(min(2, fuse_steps - 1)):
        total += _round16(n_f * _prod(regions[i]) * itemsize)
    if n_aux:
        for i in range(min(2, fuse_steps - 1)):
            total += _round16(n_aux * _prod(regions[i + 1]) * itemsize)
    return total + n_taps * 2 * itemsize + (n_ops + 1) * 4


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is ≤ ``cap`` (≥ 1)."""
    for t in range(min(cap, n), 0, -1):
        if n % t == 0:
            return t
    return 1


@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """One lowered fused-stencil configuration (see module docstring).

    ``block`` is the per-block tile; the kernel computes ``unroll``
    adjacent x sub-tiles per block from one staged window, so the x
    extent a block covers is ``block[-1] * unroll``. ``fuse_steps`` is
    the temporal depth: S sweeps per launch on a tile staged with a
    ``radii * S`` halo (``csrc/fused_stencil_temporal.cu`` for S > 1).

    Raises:
        ValueError: from ``__post_init__`` for any inconsistent
            combination — rank, tuple lengths, non-divisible tiles, a
            tile over the thread limit, a depth beyond
            ``MAX_FUSE_STEPS``, ``unroll > 1`` or a map that is not a
            self-map (``n_out != n_f + n_aux``) at depth > 1, or a
            staged working set over the shared-memory limit.
        NotImplementedError: for a strategy of the reference whose
            kernel is not ported yet.
    """

    rank: int
    strategy: str  # "swc"
    block: tuple[int, ...]  # rank-length tile, x last
    radii: tuple[int, ...]  # halo width per axis
    interior: tuple[int, ...]  # unpadded spatial extents
    n_f: int
    n_out: int
    dtype: str
    n_aux: int = 0
    unroll: int = 1  # element-wise unroll along x
    accuracy: int = 0
    n_ops: int = 0  # operators in the tap table
    n_taps: int = 0  # taps in the tap table (all operators)
    fuse_steps: int = 1  # temporal depth: sweeps per launch
    max_threads: int = MAX_THREADS  # the φ kind's threads per block

    def __post_init__(self) -> None:
        if self.strategy in NOT_PORTED:
            raise NotImplementedError(
                f"strategy {self.strategy!r} has no Hopper kernel yet: "
                f"ROADMAP {NOT_PORTED[self.strategy]}"
            )
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"strategy {self.strategy!r} not in {STRATEGIES}"
            )
        if self.accuracy < 0 or self.accuracy % 2:
            raise ValueError(
                "accuracy must be 0 (unknown) or a positive even "
                f"finite-difference order, got {self.accuracy}"
            )
        if self.rank not in (1, 2, 3):
            raise ValueError(f"rank must be 1, 2 or 3, got {self.rank}")
        if self.dtype not in ITEMSIZE:
            raise ValueError(
                f"dtype {self.dtype!r} not in {tuple(ITEMSIZE)} (bfloat16 "
                "waits for a later slice)"
            )
        for name, t in (
            ("block", self.block),
            ("radii", self.radii),
            ("interior", self.interior),
        ):
            if len(t) != self.rank:
                raise ValueError(
                    f"{name} {t} must have rank {self.rank} entries"
                )
        if self.unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {self.unroll}")
        if not 1 <= self.max_threads <= MAX_THREADS:
            raise ValueError(
                f"max_threads must be in 1..{MAX_THREADS}, got "
                f"{self.max_threads}"
            )
        if not 1 <= self.fuse_steps <= MAX_FUSE_STEPS:
            raise ValueError(
                f"fuse_steps must be in 1..{MAX_FUSE_STEPS}, got "
                f"{self.fuse_steps}"
            )
        if self.fuse_steps > 1:
            if self.unroll != 1:
                raise ValueError(
                    "temporal fusion composes with the staged halo "
                    "window, not element-wise unrolling — use unroll=1 "
                    "with fuse_steps > 1"
                )
            if self.n_out != self.n_f + self.n_aux:
                raise ValueError(
                    "fuse_steps > 1 requires a self-map op with "
                    f"n_out == n_f + n_aux (got n_out={self.n_out}, "
                    f"n_f={self.n_f}, n_aux={self.n_aux}) so each "
                    "in-kernel sweep can feed the next"
                )
        step = self.x_step
        for a in range(self.rank):
            t = self.block[a] if a < self.rank - 1 else step
            if t < 1 or self.interior[a] % t:
                raise ValueError(
                    f"axis {a} extent {self.interior[a]} not divisible "
                    f"by tile {t}"
                )
        if self.threads > MAX_THREADS:
            raise ValueError(
                f"tile {self.block} has {self.threads} points, one CUDA "
                f"thread each; a block holds at most {MAX_THREADS}"
            )
        if self.rank == 3 and self.block[0] > MAX_TILE_Z:
            raise ValueError(
                f"tile z extent {self.block[0]} exceeds blockDim.z "
                f"limit {MAX_TILE_Z}"
            )
        if self.smem_bytes > SMEM_PER_BLOCK:
            raise ValueError(
                f"staged working set {self.smem_bytes} B (one field's "
                f"halo window {self.window}, the intermediate sweeps and "
                "the tap table) exceeds "
                f"the {SMEM_PER_BLOCK} B of shared memory a Hopper block "
                "can use — shrink the tile"
            )

    @property
    def x_step(self) -> int:
        """Output extent covered along x per block."""
        return self.block[-1] * self.unroll

    @property
    def threads(self) -> int:
        """CUDA threads per block. Depth 1: one per point of one
        sub-tile. Depth > 1: ``max_threads`` (the φ kind's limit), at
        most the points of sweep 0's region — the threads loop over
        each sweep's points, so a tile shrunk to fit shared memory keeps
        a full block."""
        if self.fuse_steps == 1:
            return _prod(self.block)
        region = sweep_regions(self.block, self.radii, self.fuse_steps)[0]
        return min(self.max_threads, _prod(region))

    @property
    def halo(self) -> tuple[int, ...]:
        """Staged halo width per axis: one radius per fused sweep."""
        return tuple(r * self.fuse_steps for r in self.radii)

    @property
    def window(self) -> tuple[int, ...]:
        """Staged halo window of one field (spatial extents)."""
        return tuple(
            (self.x_step if a == self.rank - 1 else self.block[a])
            + 2 * self.halo[a]
            for a in range(self.rank)
        )

    @property
    def aux_window(self) -> tuple[int, ...] | None:
        """The aux extents a block reads: the tile at depth 1, the
        sweep-0 region (tile + 2r(S-1)) at depth S > 1; ``None``
        without aux (``lowering_windows`` of the reference)."""
        if not self.n_aux:
            return None
        return sweep_regions(
            self.block[:-1] + (self.x_step,), self.radii, self.fuse_steps
        )[0]

    @property
    def stage_buffers(self) -> int:
        """Window buffers the kernel stages fields into: two (the next
        field lands while this one is read) at depth 1, and at depth
        > 1 when there is a next field and two windows fit; else one."""
        if self.fuse_steps == 1:
            return 2
        if self.n_f > 1 and self._temporal_bytes(2) <= SMEM_PER_BLOCK:
            return 2
        return 1

    def _temporal_bytes(self, stage_buffers: int) -> int:
        return temporal_smem_bytes(
            self.block, self.radii, self.fuse_steps, n_f=self.n_f,
            n_aux=self.n_aux, itemsize=ITEMSIZE.get(self.dtype, 8),
            n_taps=self.n_taps, n_ops=self.n_ops,
            stage_buffers=stage_buffers,
        )

    @property
    def smem_bytes(self) -> int:
        """Shared memory one block uses. Depth 1, the layout of
        ``csrc/fused_stencil.cu``: two buffers of one field's window
        (each padded to 16 B; the next field lands while this one is
        read), the tap table (coefficient in the field dtype and int32
        window offset, aligned to twice the itemsize) and the int32
        operator start table. Depth > 1: :func:`temporal_smem_bytes`."""
        if self.fuse_steps > 1:
            return self._temporal_bytes(self.stage_buffers)
        itemsize = ITEMSIZE.get(self.dtype, 8)
        window = _round16(_prod(self.window) * itemsize)
        return 2 * window + self.n_taps * 2 * itemsize + (self.n_ops + 1) * 4


def plan_stencil(
    ops: OperatorSet,
    padded_shape: Sequence[int],
    n_out: int,
    *,
    strategy: str = "swc",
    block: Sequence[int] | int | None = None,
    dtype: str = "float32",
    n_aux: int = 0,
    unroll: int = 1,
    fuse_steps: int = 1,
    accuracy: int | None = None,
    max_threads: int = MAX_THREADS,
) -> StencilPlan:
    """Lower a fused-stencil problem to a :class:`StencilPlan`.

    ``padded_shape`` is the (n_f, *spatial_padded) operand shape, each
    spatial axis padded by ``ops.radius_per_axis() * fuse_steps`` (one
    radius of ghost cells per in-kernel sweep). ``block`` may be
    ``None`` (per-rank Hopper default, its slower axes halved until it
    holds at most ``max_threads`` points — the limit of the φ kind's
    kernel), an int (rank-1 shorthand), or a tuple; a tuple longer than
    the rank keeps its trailing entries (x last), and each axis is
    clamped to the largest divisor of the interior extent, so
    non-divisible domains shrink the tile instead of failing. If no
    unrolled tiling of x fits, unroll degrades to 1. At depth > 1 a
    tile whose temporal layout does not fit shared memory is halved
    along its slowest axis of extent > 1 (x last, each axis again
    clamped to a divisor), down to one warp; if even that does not
    fit, this raises ``ValueError``.
    """
    rank = ops.ndim
    if accuracy is None:
        accuracy = ops.accuracy
    radii = ops.radius_per_axis()
    padded_shape = tuple(int(n) for n in padded_shape)
    if len(padded_shape) != rank + 1:
        raise ValueError(
            f"padded operand must be (n_f, *spatial) with {rank} spatial "
            f"dims, got shape {padded_shape}"
        )
    interior = tuple(
        padded_shape[1 + a] - 2 * radii[a] * fuse_steps for a in range(rank)
    )
    if any(n <= 0 for n in interior):
        raise ValueError(
            f"padded shape {padded_shape} leaves no interior for radii "
            f"{radii} at fuse_steps={fuse_steps}"
        )

    if block is None:
        block = default_block(rank, max_threads)
    if isinstance(block, int):
        block = (block,)
    block = tuple(int(b) for b in block)
    if len(block) > rank:
        block = block[-rank:]
    if len(block) != rank:
        raise ValueError(
            f"block {block} must have {rank} entries (or more, trailing "
            "kept; x last)"
        )

    clamped = [
        largest_divisor_leq(interior[a], block[a]) for a in range(rank - 1)
    ]
    nx = interior[-1]
    if unroll > 1 and nx % unroll == 0:
        tx = largest_divisor_leq(nx // unroll, block[-1])
    else:
        unroll = 1
        tx = largest_divisor_leq(nx, block[-1])
    clamped.append(tx)
    if fuse_steps > 1:
        clamped = _fit_temporal(
            clamped, interior, radii, fuse_steps, n_f=padded_shape[0],
            n_aux=int(n_aux), itemsize=ITEMSIZE.get(str(dtype), 8),
            n_taps=ops.taps_per_point, n_ops=ops.n_s,
        )

    return StencilPlan(
        rank=rank,
        strategy=strategy,
        block=tuple(clamped),
        radii=radii,
        interior=interior,
        n_f=padded_shape[0],
        n_out=int(n_out),
        dtype=str(dtype),
        n_aux=int(n_aux),
        unroll=int(unroll),
        accuracy=int(accuracy),
        n_ops=ops.n_s,
        n_taps=ops.taps_per_point,
        fuse_steps=int(fuse_steps),
        max_threads=int(max_threads),
    )


def _fit_temporal(tile, interior, radii, fuse_steps, **layout) -> list[int]:
    """Halve ``tile``'s slowest axis of extent > 1 (clamped to a divisor
    of the interior) until the temporal layout with one window buffer
    fits shared memory; raise once a one-warp tile does not."""
    tile = list(tile)
    while True:
        need = temporal_smem_bytes(
            tile, radii, fuse_steps, stage_buffers=1, **layout
        )
        if need <= SMEM_PER_BLOCK:
            return tile
        if _prod(tile) <= ONE_WARP:
            raise ValueError(
                f"no tile fits shared memory at fuse_steps={fuse_steps}: "
                f"tile {tuple(tile)} needs {need} B of the "
                f"{SMEM_PER_BLOCK} B a Hopper block can use (one warp is "
                "the smallest tile the planner tries)"
            )
        a = next(i for i, t in enumerate(tile) if t > 1)
        tile[a] = largest_divisor_leq(interior[a], tile[a] // 2)
