"""Wrapper of the hand-written CUDA 1-D cross-correlation (port of
``repro.kernels.stencil1d.xcorr1d_pallas``, the TPU kernel B6; paper
Sec. 4.1, Figs. 7-9).

:func:`xcorr1d_cuda` computes f'_i = Σ_j g_j f̂_{i+j} over the valid
region, (n + 2r,) and (2r + 1,) → (n,), with the paper's three tuning
strategies (``csrc/xcorr1d.cu``):

* ``baseline``: one output per thread per pass, the tap loop rolled;
* ``pointwise``: the tap loop unrolled by ``unroll``, the tail exact;
* ``elementwise``: ``unroll`` outputs per thread from one load of each
  coefficient. From ``RING_MIN_TAPS`` taps at ``unroll`` > 1, unlike the
  reference, whose thread takes one output in each of ``unroll``
  sub-blocks (a TPU lane layout), a thread's outputs are consecutive, so
  its window slides through registers (register tiling); with fewer
  taps, or ``unroll`` = 1, a thread keeps the reference's sub-blocks.
  Each output sums its taps in the reference's order either way.

Any float dtype (float32, float64, bfloat16, float16) and any ``unroll``
the reference takes: the kernel instantiates register widths 1..16 and
runs ``unroll`` as its largest divisor of at most 16 in passes
(:func:`register_unroll`). In bfloat16 and float16 each product and each
sum is rounded to the type, as the plain version rounds them, so the
kernel equals it bit for bit.

``block_size`` is outputs per tile; the threads per block follow from it
(:func:`launch_threads`). The launch follows from the strategy and the
taps (:func:`ring_route`): baseline, pointwise and elementwise below
``RING_MIN_TAPS`` taps (or at ``unroll`` = 1) run one block a tile, its
window of ``block_size + 2r`` inputs staged element by element before
any compute; register-tiled elementwise runs persistent blocks
(:func:`launch_grid`) that walk the tiles with a ring of window buffers
in shared memory (:func:`ring_stages`), beside the taps
(:func:`smem_bytes`), staged by 16-byte copies where f and the tiles are
aligned (:func:`wide_staging`). Any n is taken: the kernel masks the
ragged last tile.

A CPU tensor goes to the plain version (``ref.xcorr1d``); a CUDA tensor
goes to the kernel, or the wrapper raises — there is no fallback from
one to the other.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from repro_torch import ITEMSIZE, cast, dtype_name
from repro_torch.kernels import build, ref
from repro_torch.kernels.emit import DTYPE_CODES, check_out, decode_layout
from repro_torch.kernels.plan import MAX_THREADS, SMEM_PER_BLOCK

STRATEGIES = ("baseline", "pointwise", "elementwise")
MODES = {s: i for i, s in enumerate(STRATEGIES)}  # MODE_* of xcorr1d.cu
KERNEL = "xcorr1d"  # csrc/xcorr1d.cu
MAX_UNROLL = 16  # the register widths xcorr1d.cu instantiates: 1..16
# Taps from which elementwise at unroll > 1 runs the persistent ring
# (RING_MIN_TAPS of xcorr1d.cu); with fewer, the one-tile launch. Set on
# f32 and f64; bf16 and f16 cross over between the same radii (both
# launches timed at r = 5, 10 and 32 by tools/xcorr_times.py: the
# one-tile launch ahead at 11 taps, the ring from 21), so every dtype
# shares it.
RING_MIN_TAPS = 21
KERNEL_DTYPES = tuple(ITEMSIZE)  # float32, float64, bfloat16, float16


def kernel_unroll(strategy: str, unroll: int) -> int:
    """The unroll factor the kernel runs: 1 on ``baseline`` (the
    reference's rule), ``unroll`` otherwise."""
    return 1 if strategy == "baseline" else unroll


def register_unroll(unroll: int) -> int:
    """The register width U_r the kernel runs ``unroll`` at
    (``register_unroll`` of ``csrc/xcorr1d.cu``): its largest divisor of
    at most ``MAX_UNROLL``, in ``unroll / U_r`` passes (24 → 12 x 2, 64
    → 16 x 4, 17 → 1 x 17)."""
    u = min(unroll, MAX_UNROLL)
    while unroll % u:
        u -= 1
    return u


def ring_route(strategy: str, unroll: int, n_taps: int) -> bool:
    """Which launch the kernel runs (``ring_route`` of
    ``csrc/xcorr1d.cu``): the persistent ring with register tiling on
    ``elementwise`` at a register width (:func:`register_unroll`) > 1
    from ``RING_MIN_TAPS`` taps on; else one block a tile. Baseline and
    pointwise are held back by two shared-memory loads per FMA, which a
    ring does not cut, and at few taps register tiling took longer than
    the reference's sub-blocks on an H100."""
    can = strategy == "elementwise" and register_unroll(unroll) > 1
    return can and n_taps >= RING_MIN_TAPS


def launch_threads(block_size: int, strategy: str, unroll: int,
                   n_taps: int) -> int:
    """Threads per block (``launch_threads`` of ``csrc/xcorr1d.cu``):
    ``min(block_size / U_e, 1024)``, U_e = ``unroll`` on ``elementwise``
    (a thread's U outputs) and 1 otherwise (one output per thread per
    pass); on the ring (:func:`ring_route`) at most 512 past a register
    width of 8 (its registers). A thread loops over its outputs when the
    tile has more (on the ring, above U = 16, over U / U_r lanes of U_r
    outputs each)."""
    elementwise = strategy == "elementwise"
    lanes = block_size // unroll if elementwise else block_size
    most = (MAX_THREADS // 2 if ring_route(strategy, unroll, n_taps)
            and register_unroll(unroll) > 8 else MAX_THREADS)
    return min(lanes, most)


def window_pad(strategy: str, unroll: int, dtype: str) -> int:
    """The empty-slot period of a ring window (``window_pad`` of
    ``csrc/xcorr1d.cu``): on ``elementwise``, a lane's U outputs (U the
    register width, :func:`register_unroll`) are U / V vectors of V =
    gcd(U, 16 B / itemsize) elements; when V fills 16 bytes and U / V is
    even, one 16-byte slot stays empty after every U / V vectors (so a
    quarter warp's vector loads hit distinct banks), and the period is U /
    V; else 0 (the window in order)."""
    unroll = register_unroll(unroll)
    vmax = 16 // ITEMSIZE[dtype]
    v = math.gcd(unroll, vmax)
    if strategy == "elementwise" and v == vmax and (unroll // v) % 2 == 0:
        return unroll // v
    return 0


def window_bytes(n_taps: int, block_size: int, dtype: str,
                 strategy: str = "baseline", unroll: int = 1) -> int:
    """One window buffer: ``block_size + n_taps - 1`` inputs padded to 16
    bytes, q slots of 16 bytes, and with a period p
    (:func:`window_pad`) (q - 1) // p empty slots more."""
    item = ITEMSIZE[dtype]
    q = -(-(block_size + n_taps - 1) * item // 16)
    pad = window_pad(strategy, unroll, dtype)
    return 16 * (q + (q - 1) // pad if pad else q)


def warp_scratch_bytes(strategy: str, unroll: int, dtype: str) -> int:
    """One warp's output scratch (``warp_scratch_bytes`` of
    ``csrc/xcorr1d.cu``): on ``elementwise``, where a thread's U outputs
    are more than one vector of V = gcd(U, 16 B / itemsize) elements, the
    warp's 32 U outputs pass through shared memory to be stored contiguous
    across the warp: 32 x (U / V + 1) slots of 16 bytes with the window's
    empty slots (:func:`window_pad`), else 32 U elements; 0 otherwise (U
    the register width, :func:`register_unroll`)."""
    unroll = register_unroll(unroll)
    item = ITEMSIZE[dtype]
    v = math.gcd(unroll, 16 // item)
    if strategy != "elementwise" or unroll == v:
        return 0
    if window_pad(strategy, unroll, dtype):
        return 32 * (unroll // v + 1) * 16
    return 32 * unroll * item


def ring_smem_bytes(n_taps: int, block_size: int, dtype: str,
                    strategy: str, unroll: int, stages: int) -> int:
    """Shared memory of a ring block with ``stages`` window buffers
    (:func:`window_bytes`): the buffers, each warp's output scratch
    (:func:`warp_scratch_bytes`), then the ``n_taps`` taps."""
    u = kernel_unroll(strategy, unroll)
    warps = -(-launch_threads(block_size, strategy, u, n_taps) // 32)
    return (stages * window_bytes(n_taps, block_size, dtype, strategy, u)
            + warps * warp_scratch_bytes(strategy, u, dtype)
            + n_taps * ITEMSIZE[dtype])


def ring_stages(n_taps: int, block_size: int, dtype: str, strategy: str,
                unroll: int) -> int:
    """Window buffers of a ring block (``ring_stages`` of
    ``csrc/xcorr1d.cu``): 2 (one tile computing while the next lands)
    when two fit 227 KB beside the scratch and taps, else 1."""
    fits = ring_smem_bytes(n_taps, block_size, dtype, strategy, unroll,
                           2) <= SMEM_PER_BLOCK
    return 2 if fits else 1


@functools.lru_cache(maxsize=256)
def smem_bytes(n_taps: int, block_size: int, dtype: str,
               strategy: str = "baseline", unroll: int = 1) -> int:
    """Shared memory of one block (``smem_bytes`` of ``csrc/xcorr1d.cu``):
    on the ring (:func:`ring_route`) its :func:`ring_stages` buffers,
    scratch and taps (:func:`ring_smem_bytes`); on the one-tile launch the
    window of ``block_size + n_taps - 1`` inputs padded to 16 bytes, then
    the taps. Cached: every launch's check asks it."""
    if ring_route(strategy, kernel_unroll(strategy, unroll), n_taps):
        return ring_smem_bytes(
            n_taps, block_size, dtype, strategy, unroll,
            ring_stages(n_taps, block_size, dtype, strategy, unroll))
    item = ITEMSIZE[dtype]
    return -(-(block_size + n_taps - 1) * item // 16) * 16 + n_taps * item


def wide_staging(f_padded: torch.Tensor, block_size: int) -> bool:
    """Whether the ring's windows stage with 16-byte copies (the kernel's
    own test): ``f_padded`` starts on 16 bytes and every tile starts
    ``block_size`` x itemsize bytes, a multiple of 16, after the last;
    else element by element, as the one-tile launch always does."""
    return (f_padded.data_ptr() % 16 == 0
            and block_size * f_padded.element_size() % 16 == 0)


def launch_grid(n: int, n_taps: int, block_size: int, strategy: str,
                unroll: int, resident: int) -> int:
    """Blocks of a launch: the ``ceil(n / block_size)`` tiles on the
    one-tile launch; on the ring (:func:`ring_route`) the kernel's
    resident blocks (its occupancy times the SMs, :func:`kernel_grid`
    with ``n = 0``), at most the tiles, block b taking tiles b, b + grid,
    ..."""
    tiles = -(-n // block_size)
    if ring_route(strategy, kernel_unroll(strategy, unroll), n_taps):
        return max(1, min(resident, tiles))
    return tiles


def check_args(strategy: str, block_size, unroll: int) -> None:
    """The reference's rules, on every device: a known strategy, and on
    ``elementwise`` a ``block_size`` that ``unroll`` divides."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r} not in {STRATEGIES}")
    if not isinstance(block_size, int) or block_size < 1:
        raise ValueError(
            f"block_size must be a positive int, got {block_size!r}"
        )
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    if strategy == "elementwise" and block_size % unroll:
        raise ValueError("block_size must divide by unroll for elementwise")


def check_launch(n_taps: int, block_size: int, strategy: str, unroll: int,
                 dtype: str) -> None:
    """What the card's kernel takes beyond the reference's rules: a float
    dtype (``KERNEL_DTYPES``) and a block whose shared memory
    (:func:`smem_bytes`) fits 227 KB. Any unroll runs
    (:func:`register_unroll`)."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"xcorr1d takes {KERNEL_DTYPES}, got {dtype}")
    need = smem_bytes(n_taps, block_size, dtype, strategy, unroll)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"block_size {block_size} with {n_taps} taps needs {need} B of "
            f"shared memory (window and taps), over the {SMEM_PER_BLOCK} B "
            "a Hopper block can use — use a smaller block_size"
        )


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build/load ``csrc/xcorr1d.cu`` and declare its C signatures."""
    lib = build.load(KERNEL)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_xcorr1d.argtypes = [
        vp, vp, vp, ll, ci, ci, ci, ci, ci, ci, vp,
    ]
    lib.repro_xcorr1d.restype = ci
    lib.repro_xcorr1d_smem_bytes.argtypes = [ci] * 5
    lib.repro_xcorr1d_smem_bytes.restype = ll
    lib.repro_xcorr1d_threads.argtypes = [ci] * 4
    lib.repro_xcorr1d_threads.restype = ci
    lib.repro_xcorr1d_grid.argtypes = [ll] + [ci] * 6
    lib.repro_xcorr1d_grid.restype = ll
    lib.repro_xcorr1d_layout.argtypes = [ci] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.repro_xcorr1d_layout.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def layout_fields(n_taps: int, block_size: int, strategy: str, unroll: int,
                  dtype: str) -> tuple[str, dict[str, int]]:
    """(body, fields) of a launch by the kernel's own
    ``repro_xcorr1d_layout`` (needs the built library; host only): the
    route, threads, empty-slot period, window and scratch bytes, stages,
    shared bytes, the register width and its passes, which
    ``repro_torch.analysis.bodies.xcorr1d`` mirrors."""
    out = (ctypes.c_longlong * 16)()
    n = _lib().repro_xcorr1d_layout(
        n_taps, block_size, MODES[strategy], kernel_unroll(strategy, unroll),
        DTYPE_CODES[dtype], out)
    if n < 1:
        raise RuntimeError(f"{KERNEL} layout query failed")
    return decode_layout(out[:n])


def kernel_layout(n_taps: int, block_size: int, strategy: str, unroll: int,
                  dtype: str) -> tuple[int, int]:
    """(threads, shared bytes) of one block by the kernel's own layout
    (needs the built library; :func:`launch_threads` and
    :func:`smem_bytes` must equal it)."""
    lib = _lib()
    u = kernel_unroll(strategy, unroll)
    return (
        int(lib.repro_xcorr1d_threads(n_taps, block_size, MODES[strategy],
                                      u)),
        int(lib.repro_xcorr1d_smem_bytes(n_taps, block_size,
                                         MODES[strategy], u,
                                         DTYPE_CODES[dtype])),
    )


def kernel_grid(n: int, n_taps: int, block_size: int, strategy: str,
                unroll: int, dtype: str, device: int = 0) -> int:
    """Blocks the kernel launches for n outputs by its own occupancy
    (needs the built library and the card; :func:`launch_grid` must equal
    it); on the ring ``n = 0`` gives its resident blocks alone."""
    grid = int(_lib().repro_xcorr1d_grid(
        n, n_taps, block_size, MODES[strategy],
        kernel_unroll(strategy, unroll), DTYPE_CODES[dtype], device))
    if grid < 0:
        raise RuntimeError(f"{KERNEL} grid query failed: CUDA error {-grid}")
    return grid


def xcorr1d_cuda(
    f_padded: torch.Tensor,
    g: torch.Tensor,
    *,
    strategy: str = "baseline",
    block_size: int = 2048,
    unroll: int = 4,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """f'_i = Σ_j g_j f̂_{i+j} over the valid region of ``f_padded``:
    (n + 2r,) and (2r + 1,) → (n,), ``g`` cast to ``f_padded``'s dtype
    (``repro_torch.cast``: float64 to float16 rounded once);
    into ``out`` when given (contiguous, the result's shape, dtype and
    device: ``emit.check_out``).

    On a CUDA tensor: one launch of ``csrc/xcorr1d.cu`` on the current
    stream, adding one to ``xcorr1d_cuda.launches`` and to
    ``xcorr1d_cuda.launches_by_strategy[strategy]``; the kernel picks its
    launch from the strategy and the taps (:func:`ring_route`), and
    recording the launch in ``xcorr1d_cuda.launched`` (n, taps, block,
    strategy, unroll, dtype, 16-byte staging; kept across
    :func:`reset_launch_counts`, for the static auditor). On a CPU
    tensor: the plain version, ``ref.xcorr1d``.
    """
    check_args(strategy, block_size, unroll)
    if f_padded.ndim != 1 or g.ndim != 1:
        raise ValueError(
            f"f_padded and g must be 1-D, got shapes {tuple(f_padded.shape)} "
            f"and {tuple(g.shape)}"
        )
    n_taps = g.shape[0]
    n = f_padded.shape[0] - (n_taps - 1)
    if n_taps < 1 or n < 1:
        raise ValueError(
            f"f_padded of {f_padded.shape[0]} points leaves no output for "
            f"{n_taps} taps"
        )
    if g.device != f_padded.device:
        raise ValueError(
            f"g is on {g.device}, f_padded on {f_padded.device}"
        )
    if out is not None:
        check_out(out, (n,), f_padded)
    if f_padded.device.type == "cpu":
        res = ref.xcorr1d(f_padded, g)
        return res if out is None else out.copy_(res)
    if f_padded.device.type != "cuda":
        raise ValueError(f"unsupported device {f_padded.device}")
    dtype = dtype_name(f_padded.dtype)
    check_launch(n_taps, block_size, strategy, unroll, dtype)
    if not f_padded.is_contiguous():
        raise ValueError("f_padded must be contiguous")
    g = cast(g, f_padded.dtype).contiguous()
    if out is None:
        out = torch.empty((n,), dtype=f_padded.dtype, device=f_padded.device)
    lib = _lib()
    err = lib.repro_xcorr1d(
        f_padded.data_ptr(), g.data_ptr(), out.data_ptr(), n, n_taps,
        block_size, MODES[strategy], kernel_unroll(strategy, unroll),
        DTYPE_CODES[dtype], f_padded.device.index or 0,
        torch.cuda.current_stream(f_padded.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"{KERNEL} kernel launch failed: CUDA error {err} "
            f"({lib.repro_cuda_error_string(err).decode()})"
        )
    xcorr1d_cuda.launches += 1
    xcorr1d_cuda.launches_by_strategy[strategy] += 1
    xcorr1d_cuda.launched.add((n, n_taps, block_size, strategy, unroll,
                               dtype, wide_staging(f_padded, block_size)))
    return out


xcorr1d_cuda.launches = 0
xcorr1d_cuda.launches_by_strategy = collections.Counter()
xcorr1d_cuda.launched = set()


def reset_launch_counts() -> None:
    """Zero ``xcorr1d_cuda.launches`` and its per-strategy counts."""
    xcorr1d_cuda.launches = 0
    xcorr1d_cuda.launches_by_strategy.clear()
