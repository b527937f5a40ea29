"""StencilPlan — the lowering contract between the fusion engine and the
CUDA kernels (port of ``repro.kernels.plan`` for ``strategy="swc"``,
``"swc_stream"`` and ``"tc"``).

A plan captures what the kernel launch needs: rank, tile (at depth 1 a
step of the persistent kernel's walk, its threads computing several
outputs each; at depth > 1 and on ``swc_stream`` the φ kind's thread
count, looping over each sweep's points), element-wise unroll along x,
temporal depth, halo radii,
field/output/aux counts, dtype, the size of the tap table the block
stages beside its halo window and, on ``swc_stream``, the segments the
stream axis is cut into.

``swc_stream`` (paper Fig. 5b) walks the slowest axis (z at rank 3, y
at rank 2): ``block[0]`` is the chunk τ₀ (planes per step of the walk)
and ``block[1:]`` the cross-stream tile one block owns, as in the
reference. Its rules are the reference's: ranks 2 and 3 only, no aux,
no unroll, and at depth S > 1 a stream extent of at least ``2·r₀·S +
τ₀`` (the carried halo plus one chunk).

Array-axis convention (matches ``repro_torch.core.stencil``): spatial
axes are ordered slowest→fastest, x always last and contiguous; tiles
follow the same order, e.g. (τz, τy, τx) at rank 3.

Hopper limits replace the TPU's: the staged working set — at depth 1
on ``swc`` a ring of ONE field's halo windows, the tap table and, for
MHD, φ's inputs (:func:`swc_smem_bytes`; the kernel stages fields one
at a time); at temporal depth S > 1 also every intermediate sweep's
fields (:func:`temporal_smem_bytes`) — must fit the 227 KB of shared
memory a block can use. At depth S the
halo is ``radii * S`` and the planner halves a tile that does not fit.
A stream block keeps every field's working set resident: at depth 1
(select, and the MHD RHS in float32) a ring of plane slots per field
filled chunks ahead, with a tap row per slot (:func:`stream_ring`,
:func:`stream_ring_smem_bytes`; its threads each compute
:func:`stream_outputs` points a round), the MHD RHS in float64 the
one-buffer layout (:func:`stream_smem_bytes`), deeper the walk of
``swc`` (select only: the MHD kinds are refused there); its planner
halves the chunk, then the cross tile, until it fits.

``batch`` is the ensemble's member count (port of the reference's
``StencilPlan.batch``): the kernels take the member as an outer grid
index folded into ``blockIdx.z`` (members × z tiles, or members ×
stream segments), one block serving one member, so a batched launch
needs no more shared memory per block than a single member's; the
member count only multiplies the grid. The persistent depth-1 kernels
(``swc`` and ``tc``) take it as the outermost index of the steps their
blocks walk (:func:`persistent_walk`), which no grid limit bounds.

``tc`` (the tensor-core regime, ``csrc/fused_stencil_tc.cu`` at every
depth) follows the reference's rules: float32 or bfloat16, ``unroll ==
1``, any rank, composing with ``fuse_steps``, ``batch`` and aux. Its
taps are split by :func:`tc_axis_groups` (the port's copy of the
reference's), every multi-tap group a banded contraction on the tensor
cores. At depth 1 the kernel is persistent: ``threads`` is the φ
kind's (:data:`TC_THREADS`), the launch walks the steps of
:func:`tc_step` (a tile, at rank 1 several consecutive tiles) with a
ring of ``stage_buffers`` windows in flight, and shared memory holds
the ring, the group table with the band's MMA fragments
(``tc_table_words``) and, for the MHD kinds, φ's f32 inputs
(:func:`tc_smem_bytes`). At depth > 1 (select at ranks 2 and 3, the
f32 MHD kinds) it walks tile columns as ``swc``'s walk does, its planes
cut into MMA patches (:func:`tc_walk_smem_bytes`, :func:`tc_walk_patches`);
at rank 1 (select only; a depth > 1 MHD plan that does not walk is
refused) its block is 1-D (:attr:`StencilPlan.threads`, a whole number
of warps) and loops over the points of each sweep's region, so its tile
is bounded by shared memory, not by the thread limit: the staged windows
and the intermediate sweeps of :func:`temporal_smem_bytes` plus the f32
operator sums the contractions write between axes
(:func:`tc_acc_points`). The reference's ``TC_MAX_TILE`` cap is kept to
plan the same tiles. ``swc_stream`` at depth > 1 walks as ``swc`` does
(:attr:`StencilPlan.stream_walk`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

from repro_torch.core.stencil import OperatorSet, StencilSpec
from repro_torch.core.trafficmodel import stencil_redundant_compute_fraction

STRATEGIES = ("swc", "swc_stream", "tc")

# Axis names by rank, slowest first (the stream axis letter of a key).
AXIS_LETTERS: dict[int, tuple[str, ...]] = {
    1: ("x",),
    2: ("y", "x"),
    3: ("z", "y", "x"),
}

# The paper's fixed operator order: accuracy-6 plans key UNMARKED; any
# other generated order joins the key as ``:o{A}``. 0 means "unknown"
# (hand-built taps without OperatorSpec metadata) and keys unmarked too.
DEFAULT_ACCURACY = 6


def strategy_sid(
    strategy: str,
    rank: int,
    unroll: int = 1,
    fuse_steps: int | str = 1,
    batch: int = 1,
    accuracy: int = 0,
    n_aux: int = 0,
) -> str:
    """Canonical strategy-id derivation (the reference's, suffix for
    suffix) — the ONE place the stream axis, unroll factor, temporal
    depth, ensemble batch extent, aux count and operator order join the
    tuning key, shared by :attr:`StencilPlan.strategy_id` and
    ``repro_torch.tuning.session.fused_nd_key``.

    ``swc_stream`` appends ``:s{axis}`` (``:sz`` at rank 3, ``:sy`` at
    rank 2); ``"auto"`` (the cross-strategy search, which owns the
    stream decision) ``:sauto``; ``unroll != 1`` ``:u{N}``;
    ``fuse_steps`` ``:f{S}`` for S > 1 or ``:fauto`` for the joint
    block/depth search; ``batch > 1`` ``:b{B}``; ``n_aux > 0``
    ``:a{N}``; an accuracy other than 0 or :data:`DEFAULT_ACCURACY`
    ``:o{A}``. ``tc`` needs no marker of its own: the bare name
    distinguishes it and the suffixes compose (``tc:f2:b4``).
    """
    sid = strategy
    if strategy == "swc_stream":
        sid += f":s{AXIS_LETTERS[rank][0]}"
    elif strategy == "auto":
        sid += ":sauto"
    if unroll != 1:
        sid += f":u{unroll}"
    if fuse_steps == "auto":
        sid += ":fauto"
    elif fuse_steps != 1:
        sid += f":f{fuse_steps}"
    if batch != 1:
        sid += f":b{batch}"
    if n_aux:
        sid += f":a{n_aux}"
    if accuracy not in (0, DEFAULT_ACCURACY):
        sid += f":o{accuracy}"
    return sid


# Per-rank default tiles: 1024 threads, one output point each, x a
# multiple of the 32-thread warp so neighbouring threads read
# neighbouring addresses. Register-heavy φ kinds (MHD: 80 derivative
# values per point) need smaller tiles; their solver passes its own.
DEFAULT_BLOCKS: dict[int, tuple[int, ...]] = {
    1: (1024,),
    2: (16, 64),
    3: (4, 8, 32),
}

# swc_stream's default (chunk, *cross tile) at depth > 1: its threads
# loop over a chunk's points, so the thread limit does not bound the chunk
# τ₀; a long chunk spreads each chunk's fixed cost (barriers, the landing
# and carry copies, the wait for the next chunk) and its recomputed z
# margin over more outputs. The fit halves τ₀ to what shared memory holds.
DEFAULT_STREAM_BLOCKS: dict[int, tuple[int, ...]] = {
    2: (64, 64),
    3: (16, 8, 32),
}
# Depth 1 on swc_stream (csrc/stream_body.cuh, a ring of planes read where
# they land), by φ kind ("select", or "mhd" for the MHD RHS in the dtypes
# of STREAM_RING_MHD_DTYPES: :func:`stream_ring_kind`):
# - threads per block: MHD 512, two fields of a plane a round for the
#   taps, one thread a point for φ;
# - outputs per thread, halved to fit the tile (:func:`stream_outputs`;
#   the kernel is built for 1, 2 or 4 on select and 1 on MHD);
# - chunks the ring holds: select 3, one read while two are in flight
#   (fewer where more would leave under two blocks an SM); MHD 1, the next
#   fetched while φ runs, since eight fields' planes and φ's inputs fill
#   the block.
# Default tiles: a plane of a multiple of a warp's 32 x 4 outputs, so that
# a thread's outputs share one tap row (f64 at rank 3 a narrower cross
# tile, whose ring of two still lets two blocks share an SM; rank 2 128
# wide, measured faster than 64 in tools/stream_times.py); MHD one plane
# of 8 x 32 points.
STREAM_THREADS = {"select": 256, "mhd": 512}
STREAM_RING_MHD_DTYPES = ("float32", "bfloat16")
STREAM_OUTPUTS = {"select": 4, "mhd": 1}
STREAM_STAGES = {"select": 3, "mhd": 1}
DEFAULT_STREAM_D1_BLOCKS: dict[int, tuple[int, ...]] = {
    2: (32, 128),
    3: (8, 16, 32),
}
DEFAULT_STREAM_D1_F64_BLOCK3 = (8, 8, 32)
STREAM_MHD_BLOCK = (1, 8, 32)

# tc's default tiles: the block's threads loop over the tile's points,
# so the tile is sized for shared memory, with x a multiple of the MMA's
# 8-wide output segment (TC_SEGMENT).
DEFAULT_TC_BLOCKS: dict[int, tuple[int, ...]] = {
    1: (512,),
    2: (32, 64),
    3: (8, 8, 32),
}
TC_MAX_TILE = 512  # the reference's per-axis cap on tc tiles
TC_SEGMENT = 8  # outputs per MMA segment (mma.sync's n)
TC_DTYPES = ("float32", "bfloat16")
# Depth 1 on tc (the persistent kernel). MMA rows (lines of a patch):
# 8 on the f64 m8n8k4 that f32 fields take, 16 on bf16 m16n8k16. bf16
# rank-3 tiles are 16 rows deep in y so that no patch row is idle.
TC_MMA_ROWS = {"float32": 8, "bfloat16": 16}
DEFAULT_TC_BF16_BLOCK3 = (4, 16, 32)
# Threads of a depth-1 block: select contracts with 8 warps; the MHD kinds
# run one point per thread through φ, 512 points a tile (TC_MHD_BLOCK),
# its 80 f32 inputs in shared memory.
TC_THREADS = {"select": 256, "mhd": 512}
# Patches a warp of the depth-1 kernel contracts at once (PB of
# csrc/tc_body.cuh): 4 for f32 select, 2 for bf16 select and MHD. A last
# batch short of patches repeats the last one, issued and not stored.
TC_PATCH_BATCH = {("select", "float32"): 4, ("select", "bfloat16"): 2,
                  ("mhd", "float32"): 2, ("mhd", "bfloat16"): 2}
TC_MHD_BLOCK = (4, 8, 16)
# At rank 1 a step takes consecutive tiles up to this many points, so that
# a step gives every warp MMAs (a 512-point tile is 8 f64 patches).
TC_STEP_POINTS = 4096
TC_VECTOR_BYTES = 16  # cp.async copy width of the staging
TC_LANES = 32
# Depth 1 on swc (the persistent kernel, csrc/swc_body.cuh), by φ kind
# ("select", or "mhd" for φs that read several operators) and dtype:
# threads per block, and the outputs each thread computes per round of a
# step (each tap read once for that many multiply-adds; the kernel is
# built for these and refuses others). The MHD kinds run φ one point per
# thread with its inputs in shared memory: 512 threads in f32 (at most
# 128 registers each), 256 in f64 (its φ takes ~210).
SWC_THREADS = {"select": 256, "mhd": 512, ("mhd", "float64"): 256}
SWC_OUTPUTS = {"select": 4, "mhd": 1}
# Default tiles of depth-1 swc (select): larger than DEFAULT_BLOCKS, whose
# tile is one thread per point, so that a window's halo adds less (at
# order 6 an (8, 16, 32) window holds 2.86 times its outputs, a (4, 8,
# 32) one 5.2); f64 at rank 3 keeps (4, 8, 32), whose ring of two still
# lets two blocks share an SM. MHD: φ's n_slots x n_f inputs (80 values)
# of every point of a step sit in shared memory beside the ring.
DEFAULT_SWC_BLOCKS = {1: (1024,), 2: (64, 64), 3: (8, 16, 32)}
DEFAULT_SWC_F64_BLOCK3 = (4, 8, 32)
SWC_MHD_BLOCK = {"float32": (2, 8, 32), "float64": (1, 8, 32)}
# Window buffers of the depth-1 swc ring (the kernel takes 2 or 3):
# select keeps two units in flight while one is read where that leaves two
# blocks resident per SM (else one), MHD one.
SWC_STAGES = {"select": 3, "mhd": 2}
# At rank 1 a depth-1 swc step takes consecutive tiles up to this many
# points, so that each window copy stays long.
SWC_STEP_POINTS = 4096
# Depth > 1 on swc (B2's walk, csrc/temporal_walk_body.cuh, for the kinds
# :func:`walk_kind` takes): persistent blocks walk tile columns along the
# slowest axis, ``block[0]`` planes a step (rank 2 lifted to (Y, 1, X),
# the walk along Y), each sweep's planes in a ring of its own. By φ kind
# ("select", or "mhd"): threads per block (at most 128 registers each:
# select two blocks an SM, MHD one, φ taking ~120), outputs per thread
# (the kernel is built for these: 4 on select, 1 on MHD), steps of input
# planes the ring holds (the kernel takes 1-3: with two or more one is
# read while the next is in flight; MHD holds one, the next fetched once
# sweep 0 has read it, since eight fields' rings fill the block). MHD's φ
# inputs sit in shared memory for WALK_MHD_BATCH points at a time (the
# kernel is built for it), in float32 and bfloat16 (WALK_MHD_DTYPES: in
# f64 the rings fit no tile beside them). Threads and default tiles, from
# tools/temporal_times.py (PERF.md section 6): f32 select one 512-thread block
# an SM on a (32, 32) cross tile, four planes a step at depth 2 and two deeper
# (bf16 takes f32's tiles); f64 two 256-thread blocks on (16, 32), four planes
# a step at depth 2 and two deeper (halved to fit); rank 2 four rows a step of
# 256 points; MHD one plane of (4, 16). The fit halves the cross tile's y, then
# the step, then x. The column segments follow swc_stream's rule with
# MIN_WALK_ITEMS columns.
WALK_THREADS = {"select": 512, ("select", "float64"): 256, "mhd": 512}
WALK_OUTPUTS = {"select": 4, "mhd": 1}
WALK_STAGES = {"select": 2, "mhd": 1}
WALK_DTYPES = ("float32", "float64", "bfloat16")
WALK_MHD_DTYPES = ("float32", "bfloat16")
WALK_MHD_BATCH = 128
# Rank-3 select tiles by (dtype, depth 2 or deeper).
DEFAULT_WALK_BLOCKS3 = {
    ("float32", 2): (4, 32, 32), ("float32", 3): (2, 32, 32),
    ("float64", 2): (4, 16, 32), ("float64", 3): (2, 16, 32),
    ("bfloat16", 2): (4, 32, 32), ("bfloat16", 3): (2, 32, 32),
}
DEFAULT_WALK_BLOCK2 = (4, 256)
DEFAULT_WALK_MHD_BLOCK = (1, 4, 16)
MIN_WALK_X = 8  # the narrowest cross tile the walk's fit tries
MIN_WALK_ITEMS = 4 * 132
# swc_stream at depth > 1 runs the same walk body under the stream
# kernel's name for the select kind (f32, f64, bf16, ranks 2 and 3): its
# chunk is
# the walk's step, with swc's threads, outputs, stages and default tiles.
# tc at depth > 1 (csrc/tc_walk_body.cuh) walks the same columns with
# the same rings, the derivatives contracted in patches of TC_MMA_ROWS
# lines x 8 outputs as at depth 1 (the band as ready fragments of the
# depth-1 table): select in f32 and bf16 at ranks 2 and 3, the MHD kinds
# in f32 and bf16 at rank 3. Threads per block (the kernel is built for
# them: 16 warps, at most 128 registers each, one block an SM), swc's
# WALK_STAGES and WALK_MHD_DTYPES, and for MHD the patches whose f32 φ
# inputs sit in shared memory at once (TC_WALK_MHD_PATCHES patches of
# TC_MMA_ROWS x 8 points). Tiles from tools/tc_times.py: select
# swc's f32 walk tiles in both dtypes; MHD one plane of (8, 8), whose
# regions fill 8 x 8 patches better than (4, 16) and whose rings fit
# beside the table and φ's inputs.
TC_WALK_THREADS = 512
TC_WALK_MHD_PATCHES = 2
DEFAULT_TC_WALK_MHD_BLOCK = (1, 8, 8)
SMEM_PER_SM = 233_472  # 228 KB per SM, shared by its resident blocks
SMEM_BLOCK_RESERVED = 1_024  # the runtime's own per resident block

MAX_THREADS = 1024  # CUDA threads per block
ONE_WARP = 32  # the smallest tile the temporal planner shrinks to
SMEM_PER_BLOCK = 232_448  # 227 KB: the most shared memory one Hopper block can use
# swc_stream cuts its stream axis into segments until the grid has
# MIN_STREAM_BLOCKS blocks (two for each of an H100's 132 SMs), keeping
# each segment at least STREAM_SEGMENT_HALOS times its carried halo long
# (the extra halo reads stay under 1/8 of a column's).
MIN_STREAM_BLOCKS = 2 * 132
STREAM_SEGMENT_HALOS = 8
MAX_GRID_Z = 65_535  # gridDim.z limit: members x z tiles (or segments)

ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}
# float16 runs on B6 and B7 (their own item sizes); the fused-stencil
# kernels have no float16 body yet, and every plan in it raises this
# (``tc`` first raises the reference's own dtype rule).
B9_NOT_PORTED = (
    "float16 in the fused stencil is not ported yet: ROADMAP B9 (float16 "
    "in B1-B3 (select, the MHD φ)); use float32, float64 or bfloat16, or "
    "strategy='hwc'"
)


def tc_axis_groups(
    spec: StencilSpec, rank: int
) -> dict[tuple[int, tuple[int, ...]], list[tuple[int, float]]]:
    """Decompose one stencil's taps into per-axis contraction groups —
    the lowering contract of the ``tc`` regime (port of the reference's
    ``tc_axis_groups``).

    Each tap is assigned a contraction axis: the LAST nonzero axis of
    its offset (x for the center tap), so every arm of a star stencil
    becomes one dense 1-D contraction along its own axis, and a mixed
    partial like ∂xy falls apart into one x-contraction per y-offset.
    The group key is ``(axis, rest)``, ``rest`` being the offset with
    the contraction-axis component zeroed; the value lists
    ``(offset_along_axis, coeff)`` taps in table order. Multi-tap groups
    are banded contractions on the tensor cores; singleton groups stay
    scalar multiplies.
    """
    groups: dict[
        tuple[int, tuple[int, ...]], list[tuple[int, float]]
    ] = {}
    for off, c in zip(spec.offsets, spec.coeffs):
        nonzero = [a for a in range(rank) if off[a] != 0]
        axis = nonzero[-1] if nonzero else rank - 1
        rest = tuple(0 if a == axis else off[a] for a in range(rank))
        groups.setdefault((axis, rest), []).append(
            (int(off[axis]), float(c))
        )
    return groups


def tc_groups_per_axis(ops: OperatorSet) -> tuple[int, ...]:
    """Number of multi-tap (tensor-core) contraction groups per axis
    across an operator set."""
    counts = [0] * ops.ndim
    for spec in ops.ops:
        for (axis, _), taps in tc_axis_groups(spec, ops.ndim).items():
            if len(taps) > 1:
                counts[axis] += 1
    return tuple(counts)


def _tap_bytes(itemsize: int) -> int:
    """Bytes of one tap of the shared tap table (``Tap<T>``: the
    coefficient and an int32 offset, aligned to twice the itemsize)."""
    return 2 * max(itemsize, 4)


def _cdiv(n: int, m: int) -> int:
    return -(-n // m)


def _round_up(n: int, m: int) -> int:
    return _cdiv(n, m) * m


def _lift3(t: Sequence[int], fill: int) -> tuple[int, ...]:
    return (fill,) * (3 - len(t)) + tuple(t)


def tc_threads(
    block: Sequence[int], radii: Sequence[int], fuse_steps: int,
    max_threads: int,
) -> int:
    """Threads of a ``tc`` block: sweep 0's points rounded up to whole
    warps (the MMAs run per warp), at most the φ kind's ``max_threads``."""
    region = sweep_regions(block, radii, fuse_steps)[0]
    return min(max_threads, _round_up(_prod(region), 32))


def tc_acc_points(
    block: Sequence[int], radii: Sequence[int], fuse_steps: int,
) -> int:
    """Points of the f32 operator-sum tile of the ``tc`` kernel's one-tile
    body at depth > 1 (``acc_points`` of ``csrc/fused_stencil_tc.cu``;
    rank 1, select only): sweep 0's region, whose fields are contracted
    whole."""
    return _prod(sweep_regions(block, radii, fuse_steps)[0])


def tc_band_ksteps(radius: int, dtype: str, axis: str) -> int:
    """k-steps of one banded contraction of the depth-1 ``tc`` kernel
    along ``axis`` ("y" or "x"): the f64 m8n8k4 takes the band of
    8 + 2r rows in steps of 4 on either axis; bf16 m16n8k16 in steps of
    16 — 8 + 2r rows along x (8 outputs, the MMA's n), 16 + 2r along y
    (16 outputs, the MMA's m)."""
    if dtype == "bfloat16":
        width = (TC_MMA_ROWS[dtype] if axis == "y" else TC_SEGMENT) + 2 * radius
        return _cdiv(width, 16)
    return _cdiv(TC_SEGMENT + 2 * radius, 4)


def tc_k_extent(radius: int, dtype: str, axis: str) -> int:
    """Window lines one contraction reads: its k-steps times their k."""
    return tc_band_ksteps(radius, dtype, axis) * (
        16 if dtype == "bfloat16" else 4
    )


def tc_fragment_words(radius: int, dtype: str, axis: str) -> int:
    """32-bit words of one group's band as ready MMA fragments
    (``emit.tc_table``): per k-step and lane one double (f64 B or A
    fragment), two bf16 pairs (bf16 B fragment, x) or four (bf16 A
    fragment, y)."""
    per_lane = 4 if (dtype == "bfloat16" and axis == "y") else 2
    return tc_band_ksteps(radius, dtype, axis) * TC_LANES * per_lane


def tc_table_header_words(ops: OperatorSet) -> int:
    """Words before the groups' data in the depth-1 ``tc`` kernel's
    table: the operator starts (n_ops + 1, padded to 16 bytes) and 8 per
    contraction group."""
    groups = sum(len(tc_axis_groups(spec, ops.ndim)) for spec in ops.ops)
    return _round_up(ops.n_s + 1, 4) + 8 * groups


def tc_group_words(n_taps: int, lifted_axis: int, radius: int,
                   dtype: str) -> int:
    """Words of one group's data in the depth-1 table: a lone tap's
    coefficient in the field dtype (one double, padded to 16 bytes); a z
    arm's 2r + 1 (doubles, padded); a y or x contraction's fragments
    (:func:`tc_fragment_words`)."""
    if n_taps == 1:
        return 4
    if lifted_axis == 0:
        return _round_up(2 * (2 * radius + 1), 4)
    return tc_fragment_words(radius, dtype, "y" if lifted_axis == 1 else "x")


def tc_lifted_axes(rank: int, walk: bool = False) -> tuple[int, ...]:
    """The kernel axis (0 z, 1 y, 2 x) of each of a rank's axes in
    ``emit.tc_table``: the leading axes lifted, or for the walk at rank 2
    (``walk``) (Y, X) as (Y, 1, X), Y the walked axis: its groups become z
    arms."""
    if walk and rank == 2:
        return (0, 2)
    return tuple(a + 3 - rank for a in range(rank))


@functools.lru_cache(maxsize=256)
def tc_table_words(ops: OperatorSet, dtype: str, walk: bool = False) -> int:
    """Words of ``emit.tc_table(ops, dtype, walk)``'s table, which a
    depth-1 ``tc`` block and the tc walk keep in shared memory:
    :func:`tc_table_header_words`, then every group's data
    (:func:`tc_group_words`)."""
    rank = ops.ndim
    axes = tc_lifted_axes(rank, walk)
    radii = [0, 0, 0]
    for a, r in zip(axes, ops.radius_per_axis()):
        radii[a] = r
    words = tc_table_header_words(ops)
    for spec in ops.ops:
        for (axis, _), taps in tc_axis_groups(spec, rank).items():
            lifted = axes[axis]
            words += tc_group_words(len(taps), lifted, radii[lifted], dtype)
    return words


@dataclasses.dataclass(frozen=True)
class TcStep:
    """One step of the depth-1 ``tc`` kernel (``tc_shape`` of
    ``csrc/tc_body.cuh``): the outputs it covers, its window in shared
    memory, and its MMA patches.

    A patch is ``rows`` lines × 8 outputs. At rank 1 (``line1d``) the
    lines are consecutive 8-point segments of x; otherwise they are
    consecutive y rows of one z plane and the patch is rows (y) × 8 (x),
    so that the x contraction (window · band) and the y contraction
    (bandᵀ · window) land on the same C fragment. The window buffer is
    ``window[0]`` planes × ``rows_padded`` rows of ``pitch`` elements: rows and
    columns past the staged window (the k-steps' padding and ragged
    patches) are zero-filled, and each row keeps its global alignment
    modulo 16 bytes (up to ``16 / itemsize - 1`` elements of shift)."""

    line1d: bool
    rows: int  # MMA rows: lines per patch
    extent: tuple[int, int, int]  # outputs (z, y, x) of a step
    window: tuple[int, int, int]  # staged extents (z, y, x)
    rows_padded: int  # window rows per plane in the buffer
    pitch: int  # elements per buffer row
    patches: int
    buffer_bytes: int

    @property
    def points(self) -> int:
        return _prod(self.extent)


def tc_step(
    block: Sequence[int], radii: Sequence[int], tiles_per_step: int,
    dtype: str,
) -> TcStep:
    """The :class:`TcStep` of a depth-1 ``tc`` plan."""
    tz, ty, tx = _lift3(block, 1)
    tx *= tiles_per_step
    rz, ry, rx = _lift3(radii, 0)
    rows = TC_MMA_ROWS[dtype]
    item = ITEMSIZE[dtype]
    vec = TC_VECTOR_BYTES // item
    kx = tc_k_extent(rx, dtype, "x")
    line1d = tz == 1 and ty == 1 and rz == 0 and ry == 0
    if line1d:
        patches = _cdiv(_cdiv(tx, TC_SEGMENT), rows)
        rows_padded = 1
        width = max((patches * rows - 1) * TC_SEGMENT + kx,
                    patches * rows * TC_SEGMENT + 2 * rx)
    else:
        segy, segx = _cdiv(ty, rows), _cdiv(tx, TC_SEGMENT)
        patches = tz * segy * segx
        rows_padded = (segy - 1) * rows + tc_k_extent(ry, dtype, "y")
        width = max((segx - 1) * TC_SEGMENT + kx,
                    segx * TC_SEGMENT + 2 * rx)
    pitch = _round_up(width + vec - 1, vec)
    window = (tz + 2 * rz, ty + 2 * ry, tx + 2 * rx)
    return TcStep(
        line1d=line1d, rows=rows, extent=(tz, ty, tx), window=window,
        rows_padded=rows_padded, pitch=pitch, patches=patches,
        buffer_bytes=_round16(window[0] * rows_padded * pitch * item),
    )


def tc_smem_bytes(
    step: TcStep, stages: int, table_words: int, n_slots: int, n_f: int
) -> int:
    """Shared memory of one depth-1 ``tc`` block (``tc_layout`` of
    ``csrc/tc_body.cuh``): the ring of ``stages`` window buffers, the
    group table with the fragments (padded to 16 B) and, for φ kinds that
    read several operators (MHD), the f32 operator sums of every slot and
    field at every point of a step."""
    total = stages * step.buffer_bytes + _round16(4 * table_words)
    if n_slots > 1:
        total += 4 * n_slots * n_f * step.points
    return total


def tc_tiles_per_step(block: Sequence[int], interior: Sequence[int]) -> int:
    """Consecutive tiles one depth-1 step takes: at rank 1 as many as
    divide the tile count within ``TC_STEP_POINTS`` points, else 1."""
    if len(block) != 1:
        return 1
    cap = max(1, TC_STEP_POINTS // block[0])
    return largest_divisor_leq(interior[0] // block[0], cap)


def tc_blocks_per_sm(smem_bytes: int, threads: int) -> int:
    """Resident blocks per SM that shared memory and threads allow (the
    kernel's registers may allow fewer: the launch asks the occupancy)."""
    by_smem = SMEM_PER_SM // (smem_bytes + SMEM_BLOCK_RESERVED)
    return max(1, min(by_smem, 2048 // threads))


def swc_kind(n_slots: int) -> str:
    """The φ kind the depth-1 ``swc`` kernel runs for ``n_slots``
    operators: "select" (one) or "mhd"."""
    return "select" if n_slots == 1 else "mhd"


def swc_launch(n_slots: int, dtype: str) -> tuple[int, int]:
    """(threads per block, outputs per thread) of the depth-1 ``swc``
    kernel (:data:`SWC_THREADS`, :data:`SWC_OUTPUTS`)."""
    kind = swc_kind(n_slots)
    threads = SWC_THREADS.get((kind, dtype), SWC_THREADS[kind])
    return threads, SWC_OUTPUTS[kind]


def _congruent_up(n: int, m: int, v: int) -> int:
    """Smallest n' >= n with n' = m (mod v)."""
    return n + (m - n) % v


@dataclasses.dataclass(frozen=True)
class SwcStep:
    """One step of the depth-1 ``swc`` kernel (``swc_shape`` of
    ``csrc/swc_body.cuh``): the outputs it covers (its x extent the tile's
    times ``unroll`` times the tiles per step) and its window buffer.

    A buffer row holds ``pitch`` elements and a plane ``plane``, each
    congruent to the padded field's row and plane pitch modulo 16 bytes,
    so every global 16 bytes lands on 16 shared bytes and a tap sits at
    one linear offset from every point; a row's copies reach up to ``16 /
    itemsize - 1`` elements either side of it, so the pitch leaves that
    much room."""

    extent: tuple[int, int, int]  # outputs (z, y, x) of a step
    window: tuple[int, int, int]  # staged extents (z, y, x)
    pitch: int  # buffer elements per row
    plane: int  # buffer elements per plane
    buffer_bytes: int

    @property
    def points(self) -> int:
        return _prod(self.extent)


def swc_step(
    block: Sequence[int], radii: Sequence[int], padded: Sequence[int],
    x_tiles: int, dtype: str,
) -> SwcStep:
    """The :class:`SwcStep` of a depth-1 ``swc`` plan: ``block`` the tile,
    ``padded`` the padded spatial extents, ``x_tiles`` the tile's x
    extents a step takes (``unroll`` times the tiles per step)."""
    tz, ty, tx = _lift3(block, 1)
    tx *= x_tiles
    rz, ry, rx = _lift3(radii, 0)
    _, py, px = _lift3(padded, 1)
    v = TC_VECTOR_BYTES // ITEMSIZE[dtype]
    wz, wy, wx = tz + 2 * rz, ty + 2 * ry, tx + 2 * rx
    pitch = _congruent_up(wx + v - 1, px % v, v)
    plane = _congruent_up(wy * pitch, (py * px) % v, v)
    elements = _cdiv(v - 1 + (wz - 1) * plane + (wy - 1) * pitch + wx, v) * v
    return SwcStep(extent=(tz, ty, tx), window=(wz, wy, wx), pitch=pitch,
                   plane=plane, buffer_bytes=elements * ITEMSIZE[dtype])


def swc_smem_bytes(
    step: SwcStep, stages: int, *, n_taps: int, n_ops: int, n_slots: int,
    n_f: int, itemsize: int,
) -> int:
    """Shared memory of one depth-1 ``swc`` block (``swc_layout`` of
    ``csrc/swc_body.cuh``): the ring of ``stages`` window buffers, the tap
    table (coefficient in the field dtype and int32 linear offset, aligned
    to twice the itemsize), the int32 operator starts and, for φ kinds
    that read several operators (MHD), from a 16-byte boundary φ's
    ``n_slots × n_f`` inputs in the field dtype at every point of a
    step."""
    total = (stages * step.buffer_bytes + n_taps * _tap_bytes(itemsize)
             + (n_ops + 1) * 4)
    if n_slots > 1:
        total = _round16(total) + n_slots * n_f * step.points * itemsize
    return total


def swc_tiles_per_step(x_step: int, interior: Sequence[int]) -> int:
    """Consecutive tiles (each ``x_step`` long) one depth-1 ``swc`` step
    takes: at rank 1 as many as divide the tile count within
    ``SWC_STEP_POINTS`` points, else 1."""
    if len(interior) != 1:
        return 1
    cap = max(1, SWC_STEP_POINTS // x_step)
    return largest_divisor_leq(interior[0] // x_step, cap)


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
    tc: bool = False,
) -> int:
    """Shared memory of one block of ``csrc/fused_stencil_temporal.cu``
    (``temporal_layout`` of ``csrc/temporal_body.cuh``), each buffer
    padded to 16 B: ``stage_buffers`` windows of one field (tile +
    2rS); all n_f fields of sweep 0's and, from depth 3, sweep 1's
    region (the sweeps' outputs go to these two in turn); the n_aux
    carry rows of those sweeps cut by r; then the derivative
    evaluator's own: the tap table (coefficient and int32 offset,
    aligned to twice the itemsize) and the int32 operator starts, or,
    for ``csrc/fused_stencil_tc.cu`` (``tc``: rank 1 at depth > 1, select
    only), the f32 operator sums (:func:`tc_acc_points`)."""
    regions = sweep_regions(block, radii, fuse_steps)
    window = tuple(t + 2 * r * fuse_steps for t, r in zip(block, radii))
    total = stage_buffers * _round16(_prod(window) * itemsize)
    for i in range(min(2, fuse_steps - 1)):
        total += _round16(n_f * _prod(regions[i]) * itemsize)
    if n_aux:
        for i in range(min(2, fuse_steps - 1)):
            total += _round16(n_aux * _prod(regions[i + 1]) * itemsize)
    if tc:
        return total + 4 * tc_acc_points(block, radii, fuse_steps)
    return total + n_taps * _tap_bytes(itemsize) + (n_ops + 1) * 4


def stream_smem_bytes(
    block: Sequence[int],
    radii: Sequence[int],
    *,
    n_f: int,
    itemsize: int,
    n_taps: int,
    n_ops: int,
) -> int:
    """Shared memory of one block of ``csrc/fused_stencil_stream.cu``'s
    one-buffer body (its ``layout``; depth 1, the f64 MHD RHS), each
    buffer padded to 16 B: the working set (all n_f fields of τ₀ + 2r₀
    planes of the cross window); the prefetch buffer (n_f fields of τ₀
    planes); the tap table (coefficient and int32 offset, aligned to
    twice the itemsize) and the int32 operator starts."""
    window = tuple(t + 2 * r for t, r in zip(block, radii))
    total = _round16(n_f * _prod(window) * itemsize)
    total += _round16(n_f * block[0] * _prod(window[1:]) * itemsize)
    return total + n_taps * _tap_bytes(itemsize) + (n_ops + 1) * 4


def stream_ring_kind(n_slots: int, dtype: str) -> bool:
    """Whether the depth-1 stream body (``csrc/stream_body.cuh``) takes the
    φ kind of ``n_slots`` operators in ``dtype``: select (one operator) in
    any dtype the stream kernel takes, the MHD RHS in float32 or bfloat16.
    In float64
    the MHD ring and φ's inputs leave a 64-point tile, so the one-buffer
    body (:func:`stream_smem_bytes`) keeps it."""
    return n_slots == 1 or dtype in STREAM_RING_MHD_DTYPES


def stream_outputs(block: Sequence[int], n_slots: int) -> int:
    """Outputs a thread of the depth-1 stream body computes per round: the
    φ kind's (:data:`STREAM_OUTPUTS`), halved until a plane's points (the
    cross tile's y × x) are a multiple of a warp's 32 × U, so that each
    warp's run of points lies in one plane and a thread's outputs share
    one tap row (the kernel refuses other tiles)."""
    u = STREAM_OUTPUTS[swc_kind(n_slots)]
    _, ty, tx = _stream3(block, 1)
    while u > 1 and (ty * tx) % (32 * u):
        u //= 2
    return u


def _stream3(t: Sequence[int], fill: int) -> tuple[int, int, int]:
    """``t`` lifted to rank 3 as the stream kernel sees it: at rank 2 a
    unit y inserted, so the stream axis stays z (``emit._rank3``)."""
    t = tuple(t)
    return (t[0], fill, t[1]) if len(t) == 2 else t


@dataclasses.dataclass(frozen=True)
class StreamRing:
    """The ring of the depth-1 stream body (``ring_shape`` of
    ``csrc/stream_body.cuh``): per field ``period`` plane slots of the
    cross window, plane j of a segment in slot j mod ``period``.

    A slot's rows hold ``pitch`` elements and a slot ``plane``, each
    congruent to the padded field's row and plane pitch modulo 16 bytes
    (and ``period × plane`` a multiple of 16 bytes), so every global 16
    bytes land on 16 shared bytes in every pass of the ring; fields are
    ``field_stride`` elements apart, congruent to the padded field's size.
    ``period`` holds the chunks resident at once and the 2h₀ leading
    planes: at least ``stages × τ₀ + 2h₀``."""

    chunk: tuple[int, int, int]  # outputs (τ₀, y, x) of a chunk
    window: tuple[int, int]  # the cross window (y, x)
    lead: int  # carried planes, 2h₀
    pitch: int  # buffer elements per row
    plane: int  # buffer elements per plane slot
    period: int  # plane slots
    field_stride: int  # buffer elements per field
    ring_bytes: int  # all fields, padded to 16 B

    @property
    def points(self) -> int:
        return _prod(self.chunk)


def stream_ring(
    block: Sequence[int], radii: Sequence[int], padded: Sequence[int],
    n_f: int, stages: int, dtype: str,
) -> StreamRing:
    """The :class:`StreamRing` of a depth-1 stream plan: ``block`` the
    chunk and cross tile, ``padded`` the padded spatial extents,
    ``stages`` the chunks resident at once."""
    tz, ty, tx = _stream3(block, 1)
    rz, ry, rx = _stream3(radii, 0)
    pz, py, px = _stream3(padded, 1)
    item = ITEMSIZE[dtype]
    v = TC_VECTOR_BYTES // item
    wy, wx = ty + 2 * ry, tx + 2 * rx
    pitch = _congruent_up(wx + v - 1, px % v, v)
    plane = _congruent_up(wy * pitch, (py * px) % v, v)
    period = stages * tz + 2 * rz
    while period * plane % v:
        period += 1
    elements = _cdiv(v - 1 + (period - 1) * plane + (wy - 1) * pitch + wx,
                     v) * v
    stride = _congruent_up(elements, (pz * py * px) % v, v)
    return StreamRing(
        chunk=(tz, ty, tx), window=(wy, wx), lead=2 * rz, pitch=pitch,
        plane=plane, period=period, field_stride=stride,
        ring_bytes=_round16(n_f * stride * item),
    )


def stream_ring_smem_bytes(
    ring: StreamRing, *, n_taps: int, n_ops: int, n_slots: int, n_f: int,
    itemsize: int,
) -> int:
    """Shared memory of one block of the depth-1 stream body
    (``ring_layout`` of ``csrc/stream_body.cuh``): the ring of all fields,
    the tap table with one row per plane slot (coefficient in the field
    dtype and int32 offset, aligned to twice the itemsize), the int32
    operator starts and, for the MHD kind, from a 16-byte boundary φ's
    ``n_slots × n_f`` inputs in the field dtype at every point of a
    chunk."""
    total = (ring.ring_bytes + ring.period * n_taps * _tap_bytes(itemsize)
             + (n_ops + 1) * 4)
    if n_slots > 1:
        total = _round16(total) + n_slots * n_f * ring.points * itemsize
    return total


def stream_tap_rows(
    ring: StreamRing, radii: Sequence[int], offsets: Sequence[Sequence[int]]
) -> list[list[int]]:
    """The depth-1 stream body's tap table, mirrored: for each plane slot q
    of the ring, each tap's offset in the ring from a point whose plane
    sits in slot q, ``((q + dz) mod period − q) × plane + dy × pitch +
    dx``. ``offsets`` are the (dz, dy, dx) rows of ``emit.tap_table``; at
    rank 2 these are (0, dy, dx) with dy along the stream axis, which the
    kernel, lifting (Y, X) to (Y, 1, X), reads as dz (no radius along its
    y)."""
    lifted_y = _stream3(radii, 0)[1] == 0
    rows = []
    for q in range(ring.period):
        row = []
        for dz, dy, dx in offsets:
            if lifted_y:
                dz, dy = dz + dy, 0
            slot = (q + dz) % ring.period
            row.append((slot - q) * ring.plane + dy * ring.pitch + dx)
        rows.append(row)
    return rows


def stream_schedule(plan: "StencilPlan") -> list[tuple]:
    """The depth-1 stream body's walk of one column segment, mirrored: its
    events in program order, ``("fetch", i, ((j, slot), ...))`` when the
    planes of chunk i not yet staged are issued (plane j of the segment's
    window to ``slot``; the first chunk brings the 2h₀ leading planes)
    and ``("read", i, q0)`` when chunk i is read, its window's first
    plane in slot ``q0``. Select issues chunk i + stages − 1 before
    reading chunk i (that fetch is in flight while chunk i is read); MHD
    issues chunk i + stages after it."""
    ring = plan.stream_ring
    tz, lead, period = ring.chunk[0], ring.lead, ring.period
    chunks = plan.n_chunks // plan.segments
    stages = plan.stage_buffers
    select = plan.n_slots == 1

    def fetch(i):
        planes = range(tz + lead) if i == 0 else range(i * tz + lead,
                                                       (i + 1) * tz + lead)
        return ("fetch", i, tuple((j, j % period) for j in planes))

    ahead = stages - 1 if select else stages
    events = [fetch(i) for i in range(min(ahead, chunks))]
    q0 = 0
    for i in range(chunks):
        if select and i + stages - 1 < chunks:
            events.append(fetch(i + stages - 1))
        events.append(("read", i, q0))
        if not select and i + stages < chunks:
            events.append(fetch(i + stages))
        q0 = (q0 + tz) % period
    return events


def walk_kind(rank: int, n_slots: int, n_aux: int, dtype: str,
              strategy: str = "swc") -> bool:
    """Whether a depth > 1 plan of ``strategy`` walks tile columns
    (``csrc/temporal_walk_body.cuh``; on ``tc`` ``csrc/tc_walk_body.cuh``).
    ``swc``: the select kind (one operator, no aux) at ranks 2 and 3 in
    float32, float64 or bfloat16, and the MHD kinds (the RHS applied twice,
    the substep pair with its aux carry) at rank 3 in float32 or bfloat16.
    ``swc_stream``: the select kind at ranks 2 and 3 in float32, float64
    or bfloat16. ``tc``: the select kind at ranks 2 and 3 in float32 or
    bfloat16, the MHD kinds at rank 3 in float32 or bfloat16. Rank 1
    (tiles of 1024 points, 1.01-1.02 evaluations per output-step
    already) and, on ``swc``, the MHD kinds in float64
    keep the one-tile body (:func:`temporal_smem_bytes`; ``tc`` at rank 1
    with its TcEval, select only). An MHD plan at depth > 1 that does not
    walk is refused on ``tc`` and ``swc_stream`` (:class:`StencilPlan`).
    A plan with aux rows or several operator slots is an MHD plan (the
    wrapper holds its slots to φ's)."""
    mhd = n_slots > 1 or n_aux
    if strategy == "swc_stream":
        return not mhd and rank > 1 and dtype in WALK_DTYPES
    if strategy == "tc":
        if mhd:
            return rank == 3 and dtype in WALK_MHD_DTYPES
        return rank > 1 and dtype in TC_DTYPES
    if mhd:
        return rank == 3 and dtype in WALK_MHD_DTYPES
    return rank > 1 and dtype in WALK_DTYPES


@dataclasses.dataclass(frozen=True)
class WalkRing:
    """The rings of the temporal walk (``walk_shape`` of
    ``csrc/temporal_walk_body.cuh``). ``inp`` is the input ring: the
    stream body's ring (:class:`StreamRing`) of the cross window tile +
    2rS, its period at least ``stages × τ + 2rz`` plane slots. Sweep s <
    S − 1 keeps its planes of its region across the walk, ``regions[s]``
    = tile + 2r(S − 1 − s), in a ring of ``mid_slots`` = τ + 2rz slots,
    unpadded (``mid_bytes[s]`` for all fields, padded to 16 B), and the
    aux rows it carries (the substep's w′), cut to sweep s + 1's region,
    in a ring of ``carry_slots`` = τ + rz slots (``carry_bytes[s]``)."""

    inp: StreamRing
    mid_slots: int
    regions: tuple[tuple[int, int], ...]  # (y, x) of sweeps 0 .. S-1
    mid_bytes: tuple[int, ...]  # rings of sweeps 0 .. S-2
    carry_slots: int  # τ + rz: the substep's w' rings
    carry_bytes: tuple[int, ...]  # of sweeps 0 .. S-2 (0 without aux)


def walk_ring(
    block: Sequence[int], radii: Sequence[int], padded: Sequence[int],
    n_f: int, stages: int, fuse_steps: int, dtype: str, n_aux: int = 0,
) -> WalkRing:
    """The :class:`WalkRing` of a walk plan: ``block`` the step (τ planes)
    and cross tile, ``padded`` the padded spatial extents (halo r·S),
    ``stages`` the steps of planes the input ring holds, ``n_aux`` the aux
    rows carried."""
    tz, ty, tx = _stream3(block, 1)
    rz, ry, rx = _stream3(radii, 0)
    s = fuse_steps
    widened = (tz, ty + 2 * ry * (s - 1), tx + 2 * rx * (s - 1))
    inp = stream_ring(widened, (rz, ry, rx), _stream3(padded, 1), n_f,
                      stages, dtype)
    regions = tuple((ty + 2 * ry * (s - 1 - i), tx + 2 * rx * (s - 1 - i))
                    for i in range(s))
    slots, item = tz + 2 * rz, ITEMSIZE[dtype]
    mids = tuple(_round16(n_f * slots * y * x * item)
                 for y, x in regions[:-1])
    carry = tuple(_round16(n_aux * (tz + rz) * y * x * item)
                  for y, x in regions[1:])
    return WalkRing(inp=inp, mid_slots=slots, regions=regions,
                    mid_bytes=mids, carry_slots=tz + rz, carry_bytes=carry)


def walk_smem_bytes(ring: WalkRing, *, n_taps: int, itemsize: int,
                    n_slots: int = 1, n_f: int = 1) -> int:
    """Shared memory of one block of the walk (``walk_layout`` of
    ``csrc/temporal_walk_body.cuh``): the input ring, the intermediate
    rings, the carry rings, two 8-byte divisors per sweep, a tap row per
    ring slot (the input ring's period, then ``mid_slots`` per
    intermediate ring; coefficient in the field dtype and int32 offset,
    aligned to twice the itemsize) and, for φ kinds that read several
    operators (MHD), from a 16-byte boundary φ's ``n_slots × n_f`` inputs
    in the field dtype for ``WALK_MHD_BATCH`` points."""
    sweeps = len(ring.regions)
    rows = ring.inp.period + (sweeps - 1) * ring.mid_slots
    total = (ring.inp.ring_bytes + sum(ring.mid_bytes)
             + sum(ring.carry_bytes) + 16 * sweeps
             + rows * n_taps * _tap_bytes(itemsize))
    if n_slots > 1:
        total = _round16(total) + n_slots * n_f * WALK_MHD_BATCH * itemsize
    return total


def tc_walk_smem_bytes(ring: WalkRing, *, table_words: int,
                       n_slots: int = 1, n_f: int = 1,
                       dtype: str = "float32") -> int:
    """Shared memory of one block of the tc walk (``tc_walk_layout`` of
    ``csrc/tc_walk_body.cuh``): the input ring, the intermediate rings, the
    carry rings, two 8-byte divisors per sweep, the depth-1 group table
    with the band's fragments (padded to 16 B) and, for the MHD kinds, φ's
    ``n_slots × n_f`` f32 inputs for ``TC_WALK_MHD_PATCHES`` patches of
    ``TC_MMA_ROWS[dtype]`` × 8 points."""
    sweeps = len(ring.regions)
    total = (ring.inp.ring_bytes + sum(ring.mid_bytes)
             + sum(ring.carry_bytes) + 16 * sweeps + _round16(4 * table_words))
    if n_slots > 1:
        total += (4 * n_slots * n_f * TC_WALK_MHD_PATCHES
                  * TC_MMA_ROWS[dtype] * TC_SEGMENT)
    return total


def walk_schedule(plan: "StencilPlan") -> list[tuple]:
    """The walk of one column segment, mirrored: its events in program
    order, ``("fetch", i, ((j, slot), ...))`` when step i's input planes
    not yet staged are issued (plane j of the segment's window, which
    starts at its first output plane's padded plane, to ``slot``; the
    first step brings the 2rz leading planes) and ``("sweep", i, s, lo,
    hi)`` when sweep s computes its planes [lo, hi) (numbered from its
    region's first, rz(S − 1 − s) before the segment's first output
    plane) at step i. Step i's planes are fetched ``stages − 1`` steps
    ahead, after the barrier that starts step i − stages + 1; with one
    stage (MHD) once sweep 0 of step i − 1 has read the ring."""
    ring = plan.walk_ring
    tau, lead, period = ring.inp.chunk[0], ring.inp.lead, ring.inp.period
    depth = plan.fuse_steps
    seg = plan.interior[0] // plan.segments
    planes = seg + lead * depth
    steps = _cdiv(seg + lead * (depth - 1), tau)
    stages = plan.stage_buffers

    def fetch(i):
        j0 = 0 if i == 0 else i * tau + lead
        n = tau + lead if i == 0 else min(tau, planes - j0)
        return ("fetch", i, tuple((j, j % period) for j in range(j0, j0 + n)))

    ahead = max(stages - 1, 1)
    events = [fetch(i) for i in range(min(ahead, steps))]
    for i in range(steps):
        if stages > 1 and i + stages - 1 < steps:
            events.append(fetch(i + stages - 1))
        for s in range(depth):
            k = seg + lead * (depth - 1 - s)
            hi = min(k, (i + 1) * tau - lead * s)
            lo = max(0, min(k, i * tau - lead * s))
            if hi > lo:
                events.append(("sweep", i, s, lo, hi))
            if s == 0 and stages == 1 and i + 1 < steps:
                events.append(fetch(i + 1))
    return events


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
    On ``swc_stream`` (``csrc/fused_stencil_stream.cu``, any depth)
    ``block[0]`` is the chunk τ₀ of the walk along axis 0 and
    ``segments`` the pieces that axis is cut into, one block each per
    cross tile (the reference walks it whole: ``segments=1``).
    ``batch`` is the number of ensemble members one launch serves, each
    block serving one member (the member is the outer part of
    ``blockIdx.z``, :attr:`grid_z`).

    Raises:
        ValueError: from ``__post_init__`` for any inconsistent
            combination — rank, tuple lengths, non-divisible tiles, a
            tile over the thread limit, a depth below 1, ``unroll > 1``
            or a map that is not a self-map (``n_out != n_f + n_aux``)
            at depth > 1, or a
            staged working set over the shared-memory limit; on
            ``swc_stream`` also rank 1, aux, ``unroll > 1``, a stream
            extent shorter than the carried halo plus one chunk at
            depth > 1, and segments that do not divide the chunks; a
            batch below 1, aux with ``batch > 1`` at depth > 1 (as the
            reference), and a grid whose members × z tiles (or × stream
            segments) exceed the ``MAX_GRID_Z`` blocks CUDA allows; on
            ``tc`` a dtype other than float32/bfloat16 (the reference's
            rule) and ``unroll > 1``. No depth or radius is capped
            otherwise: the shared-memory fit decides what a block
            holds.
    """

    rank: int
    strategy: str  # "swc", "swc_stream" or "tc"
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
    segments: int = 1  # swc_stream: pieces of the stream axis
    batch: int = 1  # ensemble members per launch
    n_slots: int = 1  # tc: operators φ reads (its f32 sum tiles)
    tc_table_words: int = 0  # tc depth 1 and walk: its table's words

    def __post_init__(self) -> None:
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"strategy {self.strategy!r} not in {STRATEGIES}"
            )
        stream = self.strategy == "swc_stream"
        tc = self.strategy == "tc"
        if tc and self.dtype not in TC_DTYPES:
            raise ValueError(
                "strategy='tc' contracts the derivatives on the tensor "
                "cores with float32 accumulation — dtype must be "
                "'float32' or 'bfloat16' (bf16 inputs, f32 accumulate); "
                f"got {self.dtype!r}. For float64 fields use "
                "strategy='swc' or 'hwc'."
            )
        if tc and self.unroll != 1:
            raise ValueError(
                "tc lowers each axis to banded contractions per block — "
                "element-wise unrolling does not compose; use unroll=1 "
                "with strategy='tc'"
            )
        if stream and self.rank == 1:
            raise ValueError(
                "swc_stream walks the slowest spatial axis chunk by chunk "
                "under a fixed cross-stream tile, so it needs rank 2 "
                "(y-stream) or 3 (z-stream); at rank 1 use strategy='swc'"
            )
        if stream and self.n_aux:
            raise ValueError("aux inputs: use strategy='swc'")
        if self.accuracy < 0 or self.accuracy % 2:
            raise ValueError(
                "accuracy must be 0 (unknown) or a positive even "
                f"finite-difference order, got {self.accuracy}"
            )
        if self.rank not in (1, 2, 3):
            raise ValueError(f"rank must be 1, 2 or 3, got {self.rank}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.dtype == "float16":
            raise NotImplementedError(B9_NOT_PORTED)
        if self.dtype not in ITEMSIZE:
            raise ValueError(
                f"dtype {self.dtype!r} not in {tuple(ITEMSIZE)}"
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
        if stream and self.unroll != 1:
            raise ValueError("swc_stream does not support unroll > 1")
        if not 1 <= self.max_threads <= MAX_THREADS:
            raise ValueError(
                f"max_threads must be in 1..{MAX_THREADS}, got "
                f"{self.max_threads}"
            )
        if self.fuse_steps < 1:
            raise ValueError(
                f"fuse_steps must be >= 1, got {self.fuse_steps}"
            )
        if self.batch > 1 and self.n_aux and self.fuse_steps > 1:
            raise ValueError(
                "batched temporal fusion with aux carries is not "
                "supported (the reference's rule) — use batch=1 or "
                "fuse_steps=1 with aux inputs"
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
            carried = 2 * self.radii[0] * self.fuse_steps
            if stream and self.interior[0] < carried + self.block[0]:
                raise ValueError(
                    "swc_stream at fuse_steps > 1 carries 2·r·fuse_steps "
                    f"= {carried} halo planes along the stream axis, which "
                    "must hold them plus one chunk "
                    f"(block[0]={self.block[0]}): extent "
                    f"{self.interior[0]} < {carried + self.block[0]} — "
                    "shrink fuse_steps or block[0], grow the domain, or "
                    "use strategy='swc'"
                )
        mhd = self.n_slots > 1 or self.n_aux
        if (stream or tc) and self.fuse_steps > 1 and mhd and not self.walk:
            if stream:
                raise ValueError(
                    "swc_stream at fuse_steps > 1 runs the select kind on "
                    "its walk; the MHD kinds there fit no tile of its "
                    "one-buffer body — use strategy='swc'")
            raise ValueError(
                "tc at fuse_steps > 1 runs the MHD kinds on its walk only "
                "(rank 3, float32 or bfloat16) — use strategy='swc' "
                "otherwise")
        step = self.x_step
        for a in range(self.rank):
            t = self.block[a] if a < self.rank - 1 else step
            if t < 1 or self.interior[a] % t:
                raise ValueError(
                    f"axis {a} extent {self.interior[a]} not divisible "
                    f"by tile {t}"
                )
        if self.segments < 1 or self.n_chunks % self.segments:
            raise ValueError(
                f"segments {self.segments} must be >= 1 and divide the "
                f"{self.n_chunks} chunks of the stream axis"
            )
        if self.segments > 1 and not (stream or self.walk):
            raise ValueError(
                "segments cut the stream axis of swc_stream or the walk "
                "of swc and tc at depth > 1")
        if not self.persistent and self.grid_z > MAX_GRID_Z:
            raise ValueError(
                f"{self.batch} members x {self.grid_z // self.batch} "
                f"{'stream segments' if stream else 'z tiles'} = "
                f"{self.grid_z} blocks along gridDim.z, over CUDA's "
                f"{MAX_GRID_Z} — serve the ensemble in smaller batches"
            )
        if self.threads > MAX_THREADS:
            raise ValueError(
                f"tile {self.block} has {self.threads} points, one CUDA "
                f"thread each; a block holds at most {MAX_THREADS}"
            )
        if self.smem_bytes > SMEM_PER_BLOCK:
            raise ValueError(
                f"staged working set {self.smem_bytes} B (the halo "
                f"window {self.window}, the intermediate sweeps and "
                "the tap table) exceeds "
                f"the {SMEM_PER_BLOCK} B of shared memory a Hopper block "
                "can use — shrink the tile"
            )

    @property
    def strategy_id(self) -> str:
        """Strategy component of the tuning key (:func:`strategy_sid`):
        the stream axis, unroll, depth, batch, aux count and operator
        order are launch configuration, so they join the key."""
        return strategy_sid(
            self.strategy, self.rank, self.unroll, self.fuse_steps,
            self.batch, self.accuracy, self.n_aux,
        )

    def tuning_key(self, backend: str | None = None):
        """The persistent-cache key of this plan's problem identity (the
        block excluded: it is the tuned value); ``backend`` defaults to
        the port's device (``tuning.cache.current_backend``)."""
        from repro_torch.tuning.cache import TuningKey, current_backend

        return TuningKey(
            kernel=f"fused_stencil{self.rank}d",
            strategy=self.strategy_id,
            domain=self.interior,
            radii=self.radii,
            n_f=self.n_f,
            n_out=self.n_out,
            dtype=self.dtype,
            backend=backend if backend is not None else current_backend(),
        )

    @property
    def tc_depth1(self) -> bool:
        """Whether the persistent depth-1 ``tc`` kernel runs the plan."""
        return self.strategy == "tc" and self.fuse_steps == 1

    @property
    def swc_depth1(self) -> bool:
        """Whether the persistent depth-1 ``swc`` kernel runs the plan."""
        return self.strategy == "swc" and self.fuse_steps == 1

    @property
    def temporal_walk(self) -> bool:
        """Whether the temporal kernel's walk body
        (``csrc/temporal_walk_body.cuh``) runs the plan: ``swc`` at depth >
        1 for the kinds :func:`walk_kind` takes."""
        return self.strategy == "swc" and self.walk

    @property
    def stream_walk(self) -> bool:
        """Whether the stream kernel runs the plan on the walk body
        (``csrc/temporal_walk_body.cuh``, the chunk its step): ``swc_stream``
        at depth > 1 for the kinds :func:`walk_kind` takes."""
        return self.strategy == "swc_stream" and self.walk

    @property
    def tc_walk(self) -> bool:
        """Whether the tc kernel runs the plan on its walk body
        (``csrc/tc_walk_body.cuh``): ``tc`` at depth > 1 for the kinds
        :func:`walk_kind` takes."""
        return self.strategy == "tc" and self.walk

    @property
    def walk(self) -> bool:
        """Whether the plan walks tile columns (any of the three walks)."""
        return self.fuse_steps > 1 and walk_kind(
            self.rank, self.n_slots, self.n_aux, self.dtype, self.strategy)

    @property
    def evaluations_per_output_step(self) -> float:
        """Operator evaluations per output point and fused step at depth S
        (1.0 at depth 1): sweep s evaluates its region, tile + 2r(S-1-s)
        (one plus :func:`stencil_redundant_compute_fraction` on the
        one-tile body); on a walk only across the walk, a column segment
        of L planes covering L + 2rz(S-1-s) planes of it."""
        depth = self.fuse_steps
        if self.walk:
            seg = self.interior[0] // self.segments
            lead = 2 * _stream3(self.radii, 0)[0]
            ring = self.walk_ring
            done = sum((seg + lead * (depth - 1 - s)) * y * x
                       for s, (y, x) in enumerate(ring.regions))
            return done / (depth * seg * _prod(ring.regions[-1]))
        return 1.0 + stencil_redundant_compute_fraction(
            self.block, self.radii, depth)

    @property
    def walk_ring(self) -> WalkRing:
        """A walk's rings (:func:`walk_ring`)."""
        return self._walk_ring(self.stage_buffers)

    def _walk_ring(self, stages: int) -> WalkRing:
        padded = tuple(n + 2 * h for n, h in zip(self.interior, self.halo))
        return walk_ring(self.block, self.radii, padded, self.n_f, stages,
                         self.fuse_steps, self.dtype, self.n_aux)

    @property
    def stream_depth1(self) -> bool:
        """Whether the depth-1 stream body (``csrc/stream_body.cuh``: a
        ring of planes read where they land) runs the plan: ``swc_stream``
        at depth 1 for the kinds :func:`stream_ring_kind` takes."""
        return (self.strategy == "swc_stream" and self.fuse_steps == 1
                and stream_ring_kind(self.n_slots, self.dtype))

    @property
    def stream_ring(self) -> StreamRing:
        """The depth-1 stream body's ring (:func:`stream_ring`)."""
        return self._stream_ring(self.stage_buffers)

    def _stream_ring(self, stages: int) -> StreamRing:
        padded = tuple(n + 2 * h for n, h in zip(self.interior, self.halo))
        return stream_ring(self.block, self.radii, padded, self.n_f, stages,
                           self.dtype)

    @property
    def persistent(self) -> bool:
        """Whether a persistent kernel runs the plan (depth 1 on ``swc``
        or ``tc``, and the walks): a grid of resident blocks walks the
        steps (the walks: columns), so neither ``gridDim.z`` nor the
        tile's point count binds it."""
        return self.tc_depth1 or self.swc_depth1 or self.walk

    @property
    def tiles_per_step(self) -> int:
        """Consecutive tiles one step of a depth-1 kernel takes
        (:func:`tc_tiles_per_step`, :func:`swc_tiles_per_step`); 1
        elsewhere."""
        if self.tc_depth1:
            return tc_tiles_per_step(self.block, self.interior)
        if self.swc_depth1:
            return swc_tiles_per_step(self.x_step, self.interior)
        return 1

    @property
    def swc_step(self) -> SwcStep:
        """The depth-1 ``swc`` kernel's step (:func:`swc_step`)."""
        padded = tuple(n + 2 * r for n, r in zip(self.interior, self.radii))
        return swc_step(self.block, self.radii, padded,
                        self.unroll * self.tiles_per_step, self.dtype)

    @property
    def outputs_per_thread(self) -> int:
        """Outputs a thread of the depth-1 ``swc`` kernel computes per
        round of a step (:func:`swc_launch`), of the depth-1 stream body
        per round of a chunk (:func:`stream_outputs`), or of the temporal
        and stream walks per run (:data:`WALK_OUTPUTS`); 1 elsewhere (the
        tc walk contracts patches: :data:`TC_PATCH_BATCH` a warp)."""
        if self.stream_depth1:
            return stream_outputs(self.block, self.n_slots)
        if self.temporal_walk or self.stream_walk:
            return WALK_OUTPUTS[swc_kind(self.n_slots)]
        if not self.swc_depth1:
            return 1
        return swc_launch(self.n_slots, self.dtype)[1]

    @property
    def tc_step(self) -> TcStep:
        """The depth-1 ``tc`` kernel's step (:func:`tc_step`)."""
        return tc_step(self.block, self.radii, self.tiles_per_step,
                       self.dtype)

    @property
    def walk_items(self) -> int:
        """Steps of one persistent launch: members × z × y tiles × x steps
        at depth 1, members × segments × cross tiles on a walk (its
        columns), the order the persistent blocks walk them in."""
        if self.walk:
            return self.batch * self.segments * _prod(
                n // t for n, t in zip(self.interior[1:], self.block[1:]))
        tiles = self.batch * _prod(
            n // t for n, t in zip(self.interior,
                                   self.block[:-1] + (self.x_step,))
        )
        return tiles // self.tiles_per_step

    @property
    def x_step(self) -> int:
        """Output extent covered along x per block."""
        return self.block[-1] * self.unroll

    @property
    def stream_axis(self) -> int | None:
        """Array axis the ``swc_stream`` kernel walks (0: z at rank 3,
        y at rank 2), or None for other strategies."""
        return 0 if self.strategy == "swc_stream" else None

    @property
    def grid_z(self) -> int:
        """Blocks along ``gridDim.z``: the members times the z tiles (1
        below rank 3, where the kernels lift the tile to rank 3 with
        unit leading extents) or, on ``swc_stream``, times the
        segments."""
        if self.stream_axis is not None:
            per_member = self.segments
        elif self.rank == 3:
            per_member = self.interior[0] // self.block[0]
        else:
            per_member = 1
        return self.batch * per_member

    @property
    def n_chunks(self) -> int:
        """Chunks of τ₀ planes along axis 0 (the walk of swc_stream)."""
        return self.interior[0] // self.block[0]

    @property
    def threads(self) -> int:
        """CUDA threads per block. Depth > 1, and ``swc_stream`` at any depth:
        ``max_threads`` (the φ kind's limit), at most the points of
        sweep 0's region (of one chunk) — the threads loop over each
        sweep's points, so a tile shrunk to fit shared memory keeps a
        full block. ``tc`` at depth 1: the persistent kernel's
        (:data:`TC_THREADS`); deeper: those points rounded up to whole
        warps (:func:`tc_threads`). ``swc`` at depth 1: the persistent
        kernel's (:func:`swc_launch`). ``swc_stream`` at depth 1 on the ring
        body: its kind's (:data:`STREAM_THREADS`). The temporal and stream
        walks: :data:`WALK_THREADS`; the tc walk :data:`TC_WALK_THREADS`."""
        if self.tc_walk:
            return TC_WALK_THREADS
        if self.walk:
            kind = swc_kind(self.n_slots)
            return WALK_THREADS.get((kind, self.dtype), WALK_THREADS[kind])
        if self.stream_depth1:
            return STREAM_THREADS[swc_kind(self.n_slots)]
        if self.tc_depth1:
            return TC_THREADS["select" if self.n_slots == 1 else "mhd"]
        if self.swc_depth1:
            return swc_launch(self.n_slots, self.dtype)[0]
        if self.strategy == "tc":
            return tc_threads(
                self.block, self.radii, self.fuse_steps, self.max_threads
            )
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
        """Window buffers the kernel stages fields into: at depth > 1
        (``swc`` and ``tc``) two when there is a next field and two
        windows fit, else one. At depth 1 the persistent kernels' rings
        (:meth:`_tc_stages`, :meth:`_swc_stages`). ``swc_stream``: on the
        depth-1 ring body the chunks its ring holds (:meth:`_stream_stages`),
        else its one prefetch buffer of τ₀ planes. The walks: the steps of
        input planes the ring holds (:data:`WALK_STAGES`)."""
        if self.walk:
            return WALK_STAGES[swc_kind(self.n_slots)]
        if self.stream_depth1:
            return self._stream_stages()
        if self.stream_axis is not None:
            return 1
        if self.tc_depth1:
            return self._tc_stages()
        if self.swc_depth1:
            return self._swc_stages()
        if self.n_f > 1 and self._temporal_bytes(2) <= SMEM_PER_BLOCK:
            return 2
        return 1

    def _tc_stages(self) -> int:
        """Window buffers of the depth-1 ``tc`` ring: three (two steps in
        flight while one is contracted) where that keeps two select blocks
        resident per SM, else two."""
        if self.n_slots == 1:
            three = self._tc_bytes(3)
            if tc_blocks_per_sm(three, self.threads) >= 2:
                return 3
        return 2

    def _swc_stages(self) -> int:
        """Window buffers of the depth-1 ``swc`` ring: the φ kind's
        (:data:`SWC_STAGES`), fewer (down to two) where more would leave
        fewer than two blocks resident per SM."""
        stages = SWC_STAGES[swc_kind(self.n_slots)]
        while stages > 2 and tc_blocks_per_sm(
            self._swc_bytes(stages), self.threads
        ) < 2:
            stages -= 1
        return stages

    def _stream_stages(self) -> int:
        """Chunks the depth-1 stream ring holds: the φ kind's
        (:data:`STREAM_STAGES`), fewer (down to two for select) where more
        would leave fewer than two blocks resident per SM or not fit."""
        kind = swc_kind(self.n_slots)
        stages = STREAM_STAGES[kind]
        least = 2 if kind == "select" else 1
        while stages > least and (
            self._stream_bytes(stages) > SMEM_PER_BLOCK
            or tc_blocks_per_sm(self._stream_bytes(stages), self.threads) < 2
        ):
            stages -= 1
        return stages

    def _stream_bytes(self, stages: int) -> int:
        return stream_ring_smem_bytes(
            self._stream_ring(stages), n_taps=self.n_taps, n_ops=self.n_ops,
            n_slots=self.n_slots, n_f=self.n_f,
            itemsize=ITEMSIZE[self.dtype])

    def _swc_bytes(self, stages: int) -> int:
        return swc_smem_bytes(
            self.swc_step, stages, n_taps=self.n_taps, n_ops=self.n_ops,
            n_slots=self.n_slots, n_f=self.n_f,
            itemsize=ITEMSIZE[self.dtype])

    def _tc_bytes(self, stages: int) -> int:
        return tc_smem_bytes(self.tc_step, stages, self.tc_table_words,
                             self.n_slots, self.n_f)

    def _temporal_bytes(self, stage_buffers: int) -> int:
        return temporal_smem_bytes(
            self.block, self.radii, self.fuse_steps, n_f=self.n_f,
            n_aux=self.n_aux, itemsize=ITEMSIZE.get(self.dtype, 8),
            n_taps=self.n_taps, n_ops=self.n_ops,
            stage_buffers=stage_buffers, tc=self.strategy == "tc",
        )

    @property
    def smem_bytes(self) -> int:
        """Shared memory one block uses. Depth 1: :func:`swc_smem_bytes`
        (``swc``) and :func:`tc_smem_bytes` (``tc``). Depth > 1 (``tc``
        too): :func:`temporal_smem_bytes`. ``swc_stream``:
        :func:`stream_ring_smem_bytes` on the depth-1 ring body, else
        :func:`stream_smem_bytes`. The temporal and stream walks:
        :func:`walk_smem_bytes`; the tc walk :func:`tc_walk_smem_bytes`."""
        if self.tc_walk:
            return tc_walk_smem_bytes(
                self.walk_ring, table_words=self.tc_table_words,
                n_slots=self.n_slots, n_f=self.n_f, dtype=self.dtype)
        if self.walk:
            return walk_smem_bytes(self.walk_ring, n_taps=self.n_taps,
                                   itemsize=ITEMSIZE[self.dtype],
                                   n_slots=self.n_slots, n_f=self.n_f)
        if self.stream_depth1:
            return self._stream_bytes(self.stage_buffers)
        if self.tc_depth1:
            return self._tc_bytes(self.stage_buffers)
        if self.swc_depth1:
            return self._swc_bytes(self.stage_buffers)
        if self.stream_axis is not None:
            return stream_smem_bytes(
                self.block, self.radii, n_f=self.n_f,
                itemsize=ITEMSIZE.get(self.dtype, 8), n_taps=self.n_taps,
                n_ops=self.n_ops,
            )
        return self._temporal_bytes(self.stage_buffers)


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
    batch: int | None = None,
    n_slots: int = 1,
) -> StencilPlan:
    """Lower a fused-stencil problem to a :class:`StencilPlan`.

    ``padded_shape`` is the (n_f, *spatial_padded) operand shape, each
    spatial axis padded by ``ops.radius_per_axis() * fuse_steps`` (one
    radius of ghost cells per in-kernel sweep), or the batched (batch,
    n_f, *spatial_padded) shape of an ensemble operand: a leading extent
    beyond rank + 1 axes is read as the batch. An explicit ``batch``
    must agree with a batched shape (and turns a rank + 1 shape into a
    plan for a B-member launch), as in the reference. ``block`` may be
    ``None`` (per-rank Hopper default, its slower axes halved until it
    holds at most ``max_threads`` points — the limit of the φ kind's
    kernel; on ``swc_stream`` ``DEFAULT_STREAM_BLOCKS``), an int (rank-1 shorthand), or a tuple; a tuple longer than
    the rank keeps its trailing entries (x last), and each axis is
    clamped to the largest divisor of the interior extent, so
    non-divisible domains shrink the tile instead of failing. If no
    unrolled tiling of x fits, unroll degrades to 1. At depth > 1 a
    tile whose temporal layout does not fit shared memory is halved
    along its slowest axis of extent > 1 (x last, each axis again
    clamped to a divisor), down to one warp; if even that does not
    fit, this raises ``ValueError``.

    ``swc_stream``: at depth > 1 the chunk ``block[0]`` is clamped to
    leave room for the carried halo (a smaller divisor of the stream
    extent, as the reference's planner does); a working set that does
    not fit shared memory halves the chunk, then the cross tile's
    slowest axis, down to one chunk plane and a one-warp cross tile,
    then raises ``ValueError``. The plan's ``segments`` cut the stream
    axis into pieces walked by separate blocks: the fewest that give
    ``MIN_STREAM_BLOCKS`` blocks while each piece stays
    ``STREAM_SEGMENT_HALOS`` carried halos long, the members counted
    among the blocks. At depth > 1 the select kind walks as ``swc`` does
    (its tiles, ``_fit_walk`` and ``MIN_WALK_ITEMS`` columns), the
    chunk clamp kept; the MHD kinds there raise ``ValueError``.

    ``swc`` at depth 1: ``block=None`` is ``DEFAULT_SWC_BLOCKS[rank]``
    (``DEFAULT_SWC_F64_BLOCK3`` for float64 at rank 3, ``SWC_MHD_BLOCK``
    for a φ of several operators), halved until the persistent kernel's
    ring of two, tap table and (MHD) φ's inputs fit shared memory
    (``_fit_swc``); an explicit tile that does not fit raises.

    ``tc``: ``block=None`` is ``DEFAULT_TC_BLOCKS[rank]`` (at depth 1
    and rank 3 ``DEFAULT_TC_BF16_BLOCK3`` in bfloat16 and
    ``TC_MHD_BLOCK`` for a φ of several operators), each axis capped at
    ``TC_MAX_TILE`` as in the reference. At depth 1 the tile is halved
    until the persistent kernel's ring of two windows, its table and
    (MHD) φ's f32 inputs fit shared memory (``_fit_tc``); deeper, on the
    walk, the f32 ``DEFAULT_WALK_BLOCKS3`` (rank 2 ``DEFAULT_WALK_BLOCK2``, MHD
    ``DEFAULT_TC_WALK_MHD_BLOCK``) fitted by ``_fit_walk`` to
    :func:`tc_walk_smem_bytes`; at rank 1 (select only) as the temporal
    planner fits it, with the operator's f32 sums counted.
    """
    rank = ops.ndim
    if accuracy is None:
        accuracy = ops.accuracy
    radii = ops.radius_per_axis()
    padded_shape = tuple(int(n) for n in padded_shape)
    if is_ensemble(rank, len(padded_shape)):
        shape_batch = padded_shape[0]
        if batch is not None and int(batch) != shape_batch:
            raise ValueError(
                f"explicit batch={batch} disagrees with the batched "
                f"operand shape {padded_shape} (leading extent "
                f"{shape_batch})"
            )
        batch = shape_batch
        padded_shape = padded_shape[1:]
    elif batch is None:
        batch = 1
    if len(padded_shape) != rank + 1:
        raise ValueError(
            f"padded operand must be (n_f, *spatial) or (batch, n_f, "
            f"*spatial) with {rank} spatial dims, got shape {padded_shape}"
        )
    interior = tuple(
        padded_shape[1 + a] - 2 * radii[a] * fuse_steps for a in range(rank)
    )
    if any(n <= 0 for n in interior):
        raise ValueError(
            f"padded shape {padded_shape} leaves no interior for radii "
            f"{radii} at fuse_steps={fuse_steps}"
        )

    planner_tile = block is None
    ring = (strategy == "swc_stream" and fuse_steps == 1
            and stream_ring_kind(int(n_slots), str(dtype)))
    walk = (fuse_steps > 1 and strategy in STRATEGIES and walk_kind(
        rank, int(n_slots), int(n_aux), str(dtype), strategy))
    if block is None and walk:
        tc_walk = strategy == "tc"
        if n_slots > 1:
            block = (DEFAULT_TC_WALK_MHD_BLOCK if tc_walk
                     else DEFAULT_WALK_MHD_BLOCK)
        elif rank == 3:
            key = "float32" if tc_walk else str(dtype)
            block = DEFAULT_WALK_BLOCKS3[key, min(fuse_steps, 3)]
        else:
            block = DEFAULT_WALK_BLOCK2
    elif block is None and ring and rank > 1:
        block = DEFAULT_STREAM_D1_BLOCKS[rank]
        if n_slots > 1:
            block = STREAM_MHD_BLOCK
        elif rank == 3 and dtype == "float64":
            block = DEFAULT_STREAM_D1_F64_BLOCK3
    elif block is None and strategy == "swc_stream" and rank > 1:
        block = DEFAULT_STREAM_BLOCKS[rank]
    elif block is None and strategy == "tc":
        block = DEFAULT_TC_BLOCKS[rank]
        if fuse_steps == 1 and rank == 3:
            if n_slots > 1:
                block = TC_MHD_BLOCK
            elif dtype == "bfloat16":
                block = DEFAULT_TC_BF16_BLOCK3
    elif block is None and strategy == "swc" and fuse_steps == 1:
        block = DEFAULT_SWC_BLOCKS[rank]
        if rank == 3 and n_slots > 1:
            block = SWC_MHD_BLOCK.get(str(dtype), SWC_MHD_BLOCK["float32"])
        elif rank == 3 and dtype == "float64":
            block = DEFAULT_SWC_F64_BLOCK3
    elif block is None:
        block = default_block(rank, max_threads)
    if isinstance(block, int):
        block = (block,)
    block = tuple(int(b) for b in block)
    if len(block) > rank:
        block = block[-rank:]
    if strategy == "tc":
        block = tuple(min(b, TC_MAX_TILE) for b in block)
    if len(block) != rank:
        raise ValueError(
            f"block {block} must have {rank} entries (or more, trailing "
            "kept; x last)"
        )

    clamped = [
        largest_divisor_leq(interior[a], block[a]) for a in range(rank - 1)
    ]
    stream = strategy == "swc_stream" and rank > 1 and not n_aux
    if stream and fuse_steps > 1:
        # Leave room for the carried halo (2·r·S planes) plus one chunk;
        # when no chunk fits, StencilPlan raises with the bound.
        cap = interior[0] - 2 * radii[0] * fuse_steps
        if cap >= 1:
            clamped[0] = largest_divisor_leq(interior[0], min(clamped[0], cap))
    nx = interior[-1]
    if unroll > 1 and nx % unroll == 0:
        tx = largest_divisor_leq(nx // unroll, block[-1])
    else:
        unroll = 1
        tx = largest_divisor_leq(nx, block[-1])
    clamped.append(tx)
    itemsize = ITEMSIZE.get(str(dtype), 8)
    segments = 1
    table_words = 0
    if walk:
        padded = [n + 2 * r * fuse_steps for n, r in zip(interior, radii)]
        if strategy == "tc":
            table_words = tc_table_words(ops, str(dtype), walk=True)
        stages = WALK_STAGES[swc_kind(int(n_slots))]

        def need(tile):
            ring_ = walk_ring(tile, radii, padded, padded_shape[0], stages,
                              fuse_steps, str(dtype), int(n_aux))
            if strategy == "tc":
                return tc_walk_smem_bytes(ring_, table_words=table_words,
                                          n_slots=int(n_slots),
                                          n_f=padded_shape[0],
                                          dtype=str(dtype))
            return walk_smem_bytes(ring_, n_taps=ops.taps_per_point,
                                   itemsize=ITEMSIZE[str(dtype)],
                                   n_slots=int(n_slots),
                                   n_f=padded_shape[0])

        clamped = _fit_walk(clamped, interior, fuse_steps, need)
        segments = _stream_segments(clamped, interior, radii, fuse_steps,
                                    int(batch), MIN_WALK_ITEMS)
    elif stream and unroll == 1 and fuse_steps == 1:
        layout = dict(n_f=padded_shape[0], n_taps=ops.taps_per_point,
                      n_ops=ops.n_s)
        if ring and dtype in ITEMSIZE:
            # The ring of the fewest chunks the kind takes: two for select,
            # one for MHD.
            padded = [n + 2 * r for n, r in zip(interior, radii)]

            def need(tile):
                ring_ = stream_ring(tile, radii, padded, layout["n_f"],
                                    2 if n_slots == 1 else 1, str(dtype))
                return stream_ring_smem_bytes(
                    ring_, n_slots=int(n_slots),
                    itemsize=ITEMSIZE[str(dtype)], **layout)
        else:
            def need(tile):
                return stream_smem_bytes(tile, radii, itemsize=itemsize,
                                         **layout)
        clamped = _fit_stream(clamped, interior, fuse_steps, need)
        segments = _stream_segments(
            clamped, interior, radii, fuse_steps, int(batch)
        )
    elif strategy == "tc" and fuse_steps == 1:
        table_words = tc_table_words(ops, str(dtype))
        clamped = _fit_tc(clamped, interior, radii, dtype=str(dtype),
                          table_words=table_words, n_slots=int(n_slots),
                          n_f=padded_shape[0])
    elif strategy == "swc" and fuse_steps == 1 and planner_tile and (
        dtype in ITEMSIZE
    ):
        clamped = _fit_swc(clamped, interior, radii, unroll=unroll,
                           dtype=str(dtype), n_taps=ops.taps_per_point,
                           n_ops=ops.n_s, n_slots=int(n_slots),
                           n_f=padded_shape[0])
    elif fuse_steps > 1 and strategy != "swc_stream":
        clamped = _fit_temporal(
            clamped, interior, radii, fuse_steps, n_f=padded_shape[0],
            n_aux=int(n_aux), itemsize=itemsize,
            n_taps=ops.taps_per_point, n_ops=ops.n_s, tc=strategy == "tc",
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
        segments=segments,
        batch=int(batch),
        n_slots=int(n_slots),
        tc_table_words=table_words,
    )


def plan_from_record(
    ops: OperatorSet,
    interior_shape: Sequence[int],
    n_out: int,
    record,
    *,
    dtype: str = "float32",
    n_aux: int = 0,
    max_threads: int = MAX_THREADS,
    n_slots: int = 1,
) -> StencilPlan | None:
    """The :class:`StencilPlan` a resolved tuning record launches (port
    of the reference's): ``interior_shape`` is the UNPADDED (n_f,
    *spatial) or batched (batch, n_f, *spatial) operand shape, and
    ``record`` a ``tuning.cache.TuningRecord`` whose resolved strategy,
    block, depth and unroll were persisted by the search. ``None`` for a
    record resolved to ``hwc`` (the plain version has no plan). The
    plan is built as the dispatch builds it, so its ``strategy_id`` and
    ``tuning_key()`` round-trip the decision; ``max_threads`` and
    ``n_slots`` are the φ kind's (``kernels.ops``)."""
    strategy = record.resolved_strategy
    if strategy == "hwc":
        return None
    depth = int(record.fuse_steps)
    radii = ops.radius_per_axis()
    lead = len(tuple(interior_shape)) - ops.ndim  # 1, or 2 when batched
    padded = tuple(interior_shape[:lead]) + tuple(
        n + 2 * r * depth for n, r in zip(interior_shape[lead:], radii)
    )
    return plan_stencil(
        ops, padded, n_out, strategy=strategy,
        block=tuple(record.block), dtype=dtype, n_aux=n_aux,
        unroll=int(record.unroll), fuse_steps=depth,
        max_threads=max_threads, n_slots=n_slots,
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


def _fit_tc(tile, interior, radii, *, dtype, table_words, n_slots,
            n_f) -> list[int]:
    """Halve ``tile``'s slowest axis of extent > 1 (clamped to a divisor
    of the interior) until the depth-1 ``tc`` layout with a ring of two
    fits shared memory; raise once a one-warp tile does not."""
    tile = list(tile)
    if dtype not in TC_DTYPES:
        return tile  # StencilPlan raises with the tc dtype rule
    while True:
        tps = tc_tiles_per_step(tile, interior)
        need = tc_smem_bytes(tc_step(tile, radii, tps, dtype), 2,
                             table_words, n_slots, n_f)
        if need <= SMEM_PER_BLOCK:
            return tile
        if _prod(tile) <= ONE_WARP:
            raise ValueError(
                f"no tc tile fits shared memory: tile {tuple(tile)} needs "
                f"{need} B of the {SMEM_PER_BLOCK} B a Hopper block can use "
                "(one warp is the smallest tile the planner tries)"
            )
        a = next(i for i, t in enumerate(tile) if t > 1)
        tile[a] = largest_divisor_leq(interior[a], tile[a] // 2)


def _fit_swc(tile, interior, radii, *, unroll, dtype, n_slots,
             **layout) -> list[int]:
    """Halve ``tile``'s slowest axis of extent > 1 (clamped to a divisor
    of the interior) until the depth-1 ``swc`` layout with a ring of two
    fits shared memory; raise once a one-warp tile does not."""
    tile = list(tile)
    padded = [n + 2 * r for n, r in zip(interior, radii)]
    while True:
        x_tiles = unroll * swc_tiles_per_step(tile[-1] * unroll, interior)
        need = swc_smem_bytes(
            swc_step(tile, radii, padded, x_tiles, dtype), 2,
            n_slots=n_slots, itemsize=ITEMSIZE[dtype], **layout)
        if need <= SMEM_PER_BLOCK:
            return tile
        if _prod(tile) <= ONE_WARP:
            raise ValueError(
                f"no swc tile fits shared memory: tile {tuple(tile)} needs "
                f"{need} B of the {SMEM_PER_BLOCK} B a Hopper block can use "
                "(one warp is the smallest tile the planner tries)"
            )
        a = next(i for i, t in enumerate(tile) if t > 1)
        extent = interior[a] // (unroll if a == len(tile) - 1 else 1)
        tile[a] = largest_divisor_leq(extent, tile[a] // 2)


def _fit_walk(tile, interior, fuse_steps, need) -> list[int]:
    """Halve the temporal walk's cross tile along y, then its step
    ``tile[0]``, then x (each clamped to a divisor of the interior) until
    its rings (``need(tile)`` bytes) fit shared memory; raise once a
    one-plane step of a 1 x ``MIN_WALK_X`` cross tile does not."""
    tile = list(tile)
    order = (1, 0, 2) if len(tile) == 3 else (0, 1)
    while True:
        need_ = need(tile)
        if need_ <= SMEM_PER_BLOCK:
            return tile
        a = next((i for i in order if tile[i] > (
            MIN_WALK_X if i == len(tile) - 1 else 1)), None)
        if a is None:
            raise ValueError(
                f"no tile fits shared memory at fuse_steps={fuse_steps}: "
                f"step and cross tile {tuple(tile)} need {need_} B of the "
                f"{SMEM_PER_BLOCK} B a Hopper block can use (a one-plane "
                f"step of a 1 x {MIN_WALK_X} cross tile is the smallest the "
                "planner tries)")
        tile[a] = largest_divisor_leq(interior[a], tile[a] // 2)


def _fit_stream(tile, interior, fuse_steps, need) -> list[int]:
    """Halve the chunk ``tile[0]``, then the cross tile's slowest axis of
    extent > 1 (x last; each clamped to a divisor of the interior),
    until the stream layout (``need(tile)`` bytes: the depth-1 ring
    body's or the one-buffer body's) fits shared memory; raise once one
    plane of a one-warp cross tile does not."""
    tile = list(tile)
    while True:
        need_ = need(tile)
        if need_ <= SMEM_PER_BLOCK:
            return tile
        if tile[0] > 1:
            tile[0] = largest_divisor_leq(interior[0], tile[0] // 2)
            continue
        if _prod(tile[1:]) <= ONE_WARP:
            raise ValueError(
                f"no swc_stream tile fits shared memory at fuse_steps="
                f"{fuse_steps}: chunk and cross tile {tuple(tile)} need "
                f"{need_} B of the {SMEM_PER_BLOCK} B a Hopper block can use "
                "(one plane of a one-warp cross tile is the smallest the "
                "planner tries) — use strategy='swc'"
            )
        a = next(i for i, t in enumerate(tile) if i > 0 and t > 1)
        tile[a] = largest_divisor_leq(interior[a], tile[a] // 2)


def is_ensemble(rank: int, ndim: int) -> bool:
    """Whether an operand of ``ndim`` axes over a rank-``rank`` domain is
    an ensemble stack (batch, n_f, *spatial) rather than (n_f,
    *spatial): detected by rank, as in the reference. The planner, the
    ops, ``FusedStencilOp`` and the kernel wrappers all ask this one
    rule."""
    return ndim == rank + 2


def _stream_segments(tile, interior, radii, fuse_steps, batch=1,
                     min_blocks=MIN_STREAM_BLOCKS) -> int:
    """The fewest pieces of the stream axis (a divisor of its chunks)
    that give the grid ``min_blocks`` blocks (``MIN_STREAM_BLOCKS``; the
    temporal walk's columns: ``MIN_WALK_ITEMS``), each piece at least
    ``STREAM_SEGMENT_HALOS`` carried halos long; 1 when the cross tiles
    alone suffice. The block count includes the member axis (``batch``
    members × cross tiles × segments): a batch that already fills the
    card is not cut, since every segment re-reads its 2h₀ leading
    planes."""
    n_chunks = interior[0] // tile[0]
    cross = batch * _prod(n // t for n, t in zip(interior[1:], tile[1:]))
    longest = max(1, STREAM_SEGMENT_HALOS * 2 * radii[0] * fuse_steps)
    best = 1
    for seg in range(1, n_chunks + 1):
        if n_chunks % seg or interior[0] // seg < longest:
            continue
        best = seg
        if cross * seg >= min_blocks:
            break
    return best


def tc_issued_macs(
    plan: StencilPlan, ops: OperatorSet, operators: Sequence[str]
) -> tuple[int, int]:
    """Multiply-adds of one ``tc`` launch: ``(issued, needed)``.

    ``issued`` counts what the kernel's MMAs issue for the multi-tap
    groups of ``operators`` (the ones φ reads), band zeros, the padding
    of k to 16 and the masked outputs of ragged segments included: per
    field, per sweep and per box the kernel contracts (the sweep's
    region for one operator; for several, each batch of ``threads``
    points widened to its whole planes), ``ceil(row-segments / rows)``
    tiles of ``rows × 8 × k`` — 16 rows and k = 16·ceil((8 + 2r) / 16)
    in bf16, 8 rows and k = 4·ceil((8 + 2r) / 4) on the f64 MMA of f32
    fields (the band's k-steps). ``needed`` counts one multiply-add per
    tap of those groups per output point.
    Both cover every block and member of the launch; lone taps are in
    neither.

    At depth 1 (the persistent kernel, :func:`tc_step`) every patch of
    ``rows`` lines × 8 outputs issues, per field, for each group of each
    operator φ reads: along y or x ``rows × 8 × k`` on the MMA (k the
    window lines of :func:`tc_k_extent`), along z its taps × ``rows × 8``
    FMAs (the z arm), ragged patches' masked outputs included, and a
    last batch of patches (``TC_PATCH_BATCH``) short of patches filled
    with repeats.
    """
    if plan.tc_depth1:
        return _tc_depth1_macs(plan, ops, operators)
    if plan.tc_walk:
        return _tc_walk_macs(plan, ops, operators)
    bf16 = plan.dtype == "bfloat16"
    rows = 16 if bf16 else 8
    radii = _lift3(plan.radii, 0)
    specs = [ops.ops[ops.names.index(n)] for n in operators]
    groups = []  # (lifted axis, taps) of every multi-tap group
    for spec in specs:
        for (axis, _), taps in tc_axis_groups(spec, plan.rank).items():
            if len(taps) > 1:
                groups.append((axis + 3 - plan.rank, len(taps)))
    issued = needed = 0
    regions = sweep_regions(plan.block, plan.radii, plan.fuse_steps)
    for region in regions:
        rb = _lift3(region, 1)
        size, plane = _prod(rb), rb[1] * rb[2]
        if len(operators) == 1:
            boxes = [rb]
        else:
            boxes = []
            for p0 in range(0, size, plan.threads):
                last = min(p0 + plan.threads, size) - 1
                zlo, zhi = p0 // plane, last // plane
                boxes.append((zhi - zlo + 1, rb[1], rb[2]))
        for box in boxes:
            for axis, n_taps in groups:
                step = 16 if bf16 else 4
                k = step * -(-(TC_SEGMENT + 2 * radii[axis]) // step)
                nseg = -(-box[axis] // TC_SEGMENT)
                segs = nseg * _prod(box) // box[axis]
                issued += -(-segs // rows) * rows * TC_SEGMENT * k
        needed += _prod(region) * sum(n for _, n in groups)
    blocks = plan.batch * _prod(
        n // t for n, t in zip(plan.interior, plan.block)
    )
    return issued * plan.n_f * blocks, needed * plan.n_f * blocks


def _tc_depth1_macs(
    plan: StencilPlan, ops: OperatorSet, operators: Sequence[str]
) -> tuple[int, int]:
    step = plan.tc_step
    radii = _lift3(plan.radii, 0)
    lift = 3 - plan.rank
    per_patch = needed_taps = 0
    for name in operators:
        spec = ops.ops[ops.names.index(name)]
        for (axis, _), taps in tc_axis_groups(spec, plan.rank).items():
            if len(taps) == 1:
                continue
            lifted = axis + lift
            needed_taps += len(taps)
            outputs = step.rows * TC_SEGMENT
            if lifted == 0:
                per_patch += len(taps) * outputs
            else:
                per_patch += outputs * tc_k_extent(
                    radii[lifted], plan.dtype, "y" if lifted == 1 else "x"
                )
    items = plan.walk_items
    batch = TC_PATCH_BATCH[
        "select" if plan.n_slots == 1 else "mhd", plan.dtype]
    issued = per_patch * _round_up(step.patches, batch) * plan.n_f * items
    needed = needed_taps * step.points * plan.n_f * items
    return issued, needed


def tc_walk_patches(plan: StencilPlan, sweep: int) -> tuple[bool, int]:
    """(line patches, patches per plane) of sweep ``sweep`` of the tc walk
    (``tc_sweep`` of ``csrc/tc_walk_body.cuh``): its region cut into
    patches of ``TC_MMA_ROWS`` lines × 8 outputs — consecutive y rows of
    one 8-wide column strip, or, where the walk has no y radius (rank 2
    lifted), consecutive 8-wide segments of its rows (``line``)."""
    ry = _stream3(plan.radii, 0)[1]
    y, x = plan.walk_ring.regions[sweep]
    rows = TC_MMA_ROWS[plan.dtype]
    segx = _cdiv(x, TC_SEGMENT)
    if ry == 0:
        return True, _cdiv(y * segx, rows)
    return False, _cdiv(y, rows) * segx


def _tc_walk_macs(
    plan: StencilPlan, ops: OperatorSet, operators: Sequence[str]
) -> tuple[int, int]:
    """The tc walk's count (:func:`tc_issued_macs`): per sweep, per plane
    of its region a column segment computes, per field, its patches (a
    warp's last batch of :data:`TC_PATCH_BATCH` repeating the last patch;
    MHD batches run over the step's planes) times each group's
    multiply-adds per patch as at depth 1 (y and x on the MMA, the z arm
    on FMAs)."""
    rows = TC_MMA_ROWS[plan.dtype]
    axes = tc_lifted_axes(plan.rank, walk=True)
    radii = [0, 0, 0]
    for a, r in zip(axes, plan.radii):
        radii[a] = r
    per_patch = needed_taps = 0
    for name in operators:
        spec = ops.ops[ops.names.index(name)]
        for (axis, _), taps in tc_axis_groups(spec, plan.rank).items():
            if len(taps) == 1:
                continue
            lifted = axes[axis]
            needed_taps += len(taps)
            if lifted == 0:
                per_patch += len(taps) * rows * TC_SEGMENT
            else:
                per_patch += rows * TC_SEGMENT * tc_k_extent(
                    radii[lifted], plan.dtype, "y" if lifted == 1 else "x")
    select = plan.n_slots == 1
    batch = TC_PATCH_BATCH["select" if select else "mhd", plan.dtype]
    ring = plan.walk_ring
    patches = points = 0
    for ev in walk_schedule(plan):
        if ev[0] != "sweep":
            continue
        _, _, s, lo, hi = ev
        ppp = tc_walk_patches(plan, s)[1]
        if select:
            patches += (hi - lo) * _round_up(ppp, batch)
        else:
            patches += _round_up((hi - lo) * ppp, batch)
        points += (hi - lo) * _prod(ring.regions[s])
    items = plan.walk_items * plan.n_f
    return (per_patch * patches * items, needed_taps * points * items)


def persistent_walk(
    plan: StencilPlan, grid: int
) -> list[list[tuple[int, ...]]]:
    """The walk of a persistent kernel (``swc`` or ``tc`` at depth 1, the
    temporal walk), mirrored: for each of ``grid`` blocks, the (member,
    z0, y0, x0) output origin of every step it takes, in order. Block b
    takes steps b, b + grid, ...; step i is x fastest, then y, z, member
    (B5's order), its x extent ``x_step × tiles_per_step`` (``Walker`` of
    ``csrc/persistent.cuh``). A step of the temporal walk is a column: a
    segment of the slowest axis (z0 its first output plane) under a cross
    tile, rank 2 lifted to (Y, 1, X)."""
    if plan.walk:
        _, ty, tx = _stream3(plan.block, 1)
        tz = plan.interior[0] // plan.segments
        extents = _stream3(plan.interior, 1)
    else:
        tz, ty, tx = _lift3(plan.block[:-1] + (plan.x_step,), 1)
        tx *= plan.tiles_per_step
        extents = _lift3(plan.interior, 1)
    nz, ny, nx = (n // t for n, t in zip(extents, (tz, ty, tx)))
    walks = []
    for b in range(grid):
        steps = []
        for i in range(b, plan.walk_items, grid):
            ix, rest = i % nx, i // nx
            iy, rest = rest % ny, rest // ny
            iz, member = rest % nz, rest // nz
            steps.append((member, iz * tz, iy * ty, ix * tx))
        walks.append(steps)
    return walks
