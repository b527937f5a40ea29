"""Wrapper of the hand-written CUDA 1-D cross-correlation (port of
``repro.kernels.stencil1d.xcorr1d_pallas``, the TPU kernel B6; paper
Sec. 4.1, Figs. 7-9).

:func:`xcorr1d_cuda` computes f'_i = Σ_j g_j f̂_{i+j} over the valid
region, (n + 2r,) and (2r + 1,) → (n,), with the paper's three tuning
strategies (``csrc/xcorr1d.cu``):

* ``baseline``: one output per thread per pass, the tap loop rolled;
* ``pointwise``: the tap loop unrolled by ``unroll``, the tail exact;
* ``elementwise``: ``unroll`` outputs per thread, one in each of
  ``unroll`` adjacent sub-blocks, from one load of each coefficient.

``block_size`` is outputs per CUDA block; the threads per block follow
from it (:func:`launch_threads`) and the block's shared memory holds its
window of ``block_size + 2r`` inputs and the taps (:func:`smem_bytes`).
Any n is taken: the kernel masks the ragged last block.

A CPU tensor goes to the plain version (``ref.xcorr1d``); a CUDA tensor
goes to the kernel, or the wrapper raises — there is no fallback from
one to the other.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch import dtype_name
from repro_torch.kernels import build, ref
from repro_torch.kernels.emit import DTYPE_CODES
from repro_torch.kernels.plan import ITEMSIZE, MAX_THREADS, SMEM_PER_BLOCK

STRATEGIES = ("baseline", "pointwise", "elementwise")
MODES = {s: i for i, s in enumerate(STRATEGIES)}  # MODE_* of xcorr1d.cu
KERNEL = "xcorr1d"  # csrc/xcorr1d.cu
MAX_UNROLL = 16  # the unroll factors xcorr1d.cu instantiates: 1..16
KERNEL_DTYPES = ("float32", "float64")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP B6b (xcorr1d in bfloat16 and "
        "float16, and unroll factors above 16, on the card)"
    )


def kernel_unroll(strategy: str, unroll: int) -> int:
    """The unroll factor the kernel runs: 1 on ``baseline`` (the
    reference's rule), ``unroll`` otherwise."""
    return 1 if strategy == "baseline" else unroll


def launch_threads(block_size: int, strategy: str, unroll: int) -> int:
    """Threads per block (``launch_threads`` of ``csrc/xcorr1d.cu``):
    ``min(block_size / U_e, 1024)``, U_e = ``unroll`` on ``elementwise``
    (a thread's U outputs) and 1 otherwise (one output per thread per
    pass); a thread loops over its outputs when the block has more."""
    lanes = block_size // unroll if strategy == "elementwise" else block_size
    return min(lanes, MAX_THREADS)


def smem_bytes(n_taps: int, block_size: int, dtype: str) -> int:
    """Shared memory of one block (``smem_bytes`` of ``csrc/xcorr1d.cu``):
    the window of ``block_size + n_taps - 1`` inputs padded to 16 B, then
    the ``n_taps`` taps."""
    item = ITEMSIZE[dtype]
    window = -(-(block_size + n_taps - 1) * item // 16) * 16
    return window + n_taps * item


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
    """What the card's kernel takes beyond the reference's rules: float32
    or float64, an unroll factor it instantiates, and a block whose
    window and taps fit 227 KB of shared memory."""
    if dtype in ("bfloat16", "float16"):
        raise _not_ported(f"xcorr1d in {dtype}")
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"xcorr1d takes float32 or float64, got {dtype}")
    if kernel_unroll(strategy, unroll) > MAX_UNROLL:
        raise _not_ported(f"unroll={unroll}")
    need = smem_bytes(n_taps, block_size, dtype)
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
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repro_xcorr1d.argtypes = [
        vp, vp, vp, ctypes.c_longlong, ci, ci, ci, ci, ci, ci, vp,
    ]
    lib.repro_xcorr1d.restype = ci
    lib.repro_xcorr1d_smem_bytes.argtypes = [ci, ci, ci]
    lib.repro_xcorr1d_smem_bytes.restype = ctypes.c_longlong
    lib.repro_xcorr1d_threads.argtypes = [ci, ci, ci]
    lib.repro_xcorr1d_threads.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_layout(n_taps: int, block_size: int, strategy: str, unroll: int,
                  dtype: str) -> tuple[int, int]:
    """(threads, shared bytes) of one block by the kernel's own layout
    (needs the built library; :func:`launch_threads` and
    :func:`smem_bytes` must equal it)."""
    lib = _lib()
    u = kernel_unroll(strategy, unroll)
    return (
        int(lib.repro_xcorr1d_threads(block_size, MODES[strategy], u)),
        int(lib.repro_xcorr1d_smem_bytes(n_taps, block_size,
                                         DTYPE_CODES[dtype])),
    )


def xcorr1d_cuda(
    f_padded: torch.Tensor,
    g: torch.Tensor,
    *,
    strategy: str = "baseline",
    block_size: int = 2048,
    unroll: int = 4,
) -> torch.Tensor:
    """f'_i = Σ_j g_j f̂_{i+j} over the valid region of ``f_padded``:
    (n + 2r,) and (2r + 1,) → (n,), ``g`` cast to ``f_padded``'s dtype.

    On a CUDA tensor: one launch of ``csrc/xcorr1d.cu`` on the current
    stream, adding one to ``xcorr1d_cuda.launches`` and to
    ``xcorr1d_cuda.launches_by_strategy[strategy]``. On a CPU tensor:
    the plain version, ``ref.xcorr1d``.
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
    if f_padded.device.type == "cpu":
        return ref.xcorr1d(f_padded, g)
    if f_padded.device.type != "cuda":
        raise ValueError(f"unsupported device {f_padded.device}")
    dtype = dtype_name(f_padded.dtype)
    check_launch(n_taps, block_size, strategy, unroll, dtype)
    if not f_padded.is_contiguous():
        raise ValueError("f_padded must be contiguous")
    g = g.to(f_padded.dtype).contiguous()
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
    return out


xcorr1d_cuda.launches = 0
xcorr1d_cuda.launches_by_strategy = collections.Counter()


def reset_launch_counts() -> None:
    """Zero ``xcorr1d_cuda.launches`` and its per-strategy counts."""
    xcorr1d_cuda.launches = 0
    xcorr1d_cuda.launches_by_strategy.clear()
