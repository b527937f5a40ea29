"""Wrapper of the hand-written CUDA depthwise causal conv1d (port of
``repro.kernels.conv1d_depthwise.conv1d_depthwise_pallas``, the TPU
kernel B7: mamba2's conv frontend).

:func:`conv1d_depthwise_cuda` computes y[b, t, c] = Σ_{j<k} w[j, c] ·
x[b, t-(k-1)+j, c] with zeros left of each sequence, then optionally
``y * sigmoid(y)`` (``activation="silu"``): (b, s, c) and (k, c) give
(b, s, c) (``csrc/conv1d_depthwise.cu``). ``x`` may be strided along its
batch and sequence axes (mamba2's xBC is a column slice of the
in-projection); its channels must be adjacent. One thread walks a run of
``block_seq`` positions of one channel (f32) or of two (bf16, when
:func:`vector_width` allows), and the runs need not divide the sequence.

A CPU tensor goes to the plain version (``ref.conv1d_depthwise``); a
CUDA tensor goes to the kernel, or the wrapper raises — there is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import dtype_name
from repro_torch.kernels import build, ref
from repro_torch.kernels.emit import DTYPE_CODES

KERNEL = "conv1d_depthwise"  # csrc/conv1d_depthwise.cu
ACTIVATIONS = ("none", "silu")  # ACT_* of conv1d_depthwise.cu
KERNEL_DTYPES = ("float32", "bfloat16")
MAX_K = 8  # the tap counts conv1d_depthwise.cu instantiates: 1..8
MAX_THREADS = 128  # threads per block (whole warps, at most this)
MAX_GRID_YZ = 65_535  # CUDA's limit on gridDim.y and gridDim.z
DEFAULT_BLOCK_SEQ = 512  # the reference's block_seq


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP B7b (conv1d_depthwise on the "
        f"card in dtypes other than float32 and bfloat16, and more than "
        f"{MAX_K} taps)"
    )


def check_launch(b: int, s: int, c: int, k: int, block_seq: int,
                 dtype: str) -> None:
    """What the card's kernel takes: float32 or bfloat16, 1 to ``MAX_K``
    taps, and a grid within CUDA's limits (``ceil(s / block_seq)`` runs
    and ``b`` sequences, each at most 65,535)."""
    if dtype not in KERNEL_DTYPES:
        raise _not_ported(f"conv1d_depthwise in {dtype}")
    if k > MAX_K:
        raise _not_ported(f"conv1d_depthwise with k={k}")
    if k < 1:
        raise ValueError(f"need at least one tap, got k={k}")
    if not isinstance(block_seq, int) or block_seq < 1:
        raise ValueError(f"block_seq must be a positive int, got {block_seq!r}")
    runs = -(-s // block_seq)
    if runs > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(
            f"{b} sequences of {runs} runs of {block_seq} exceed CUDA's "
            f"grid limit of {MAX_GRID_YZ} — use a larger block_seq"
        )


def vector_width(x: torch.Tensor, w: torch.Tensor) -> int:
    """Channels per thread: 2 for bf16 when the channel count and both of
    ``x``'s outer strides are even and ``x`` and ``w`` start on 4 bytes
    (so a ``__nv_bfloat162`` access is aligned), else 1."""
    if x.dtype != torch.bfloat16:
        return 1
    even = x.shape[2] % 2 == 0 and x.stride(0) % 2 == 0 \
        and x.stride(1) % 2 == 0
    aligned = x.data_ptr() % 4 == 0 and w.data_ptr() % 4 == 0
    return 2 if even and aligned else 1


def launch_layout(b: int, s: int, c: int, block_seq: int,
                  vec: int) -> tuple[tuple[int, int, int], int]:
    """(grid, threads) of a launch: ``ceil(c / vec)`` lanes in whole warps
    of at most ``MAX_THREADS`` threads along x, ``ceil(s / block_seq)``
    runs along y, the batch along z."""
    lanes = -(-c // vec)
    threads = min(-(-lanes // 32) * 32, MAX_THREADS)
    return (-(-lanes // threads), -(-s // block_seq), b), threads


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build/load ``csrc/conv1d_depthwise.cu`` and declare its C
    signatures."""
    lib = build.load(KERNEL)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_conv1d_depthwise.argtypes = [
        vp, vp, vp, ci, ci, ci, ci, ll, ll, ci, ci, ci, ci, ci, vp,
    ]
    lib.repro_conv1d_depthwise.restype = ci
    lib.repro_conv1d_depthwise_threads.argtypes = [ci, ci]
    lib.repro_conv1d_depthwise_threads.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_threads(c: int, vec: int) -> int:
    """Threads per block by the kernel's own layout (needs the built
    library; :func:`launch_layout` must equal it)."""
    return int(_lib().repro_conv1d_depthwise_threads(c, vec))


def conv1d_depthwise_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    activation: str = "none",
    block_seq: int = DEFAULT_BLOCK_SEQ,
) -> torch.Tensor:
    """Causal depthwise conv of ``x`` (b, s, c) with ``w`` (k, c), ``w``
    cast to ``x``'s dtype, then ``activation`` (``"none"`` or
    ``"silu"``); returns a contiguous (b, s, c) tensor.

    On a CUDA tensor: one launch of ``csrc/conv1d_depthwise.cu`` on the
    current stream, adding one to ``conv1d_depthwise_cuda.launches``. On
    a CPU tensor: the plain version, ``ref.conv1d_depthwise``.
    """
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
    if x.ndim != 3 or w.ndim != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(
            f"want x (b, s, c) and w (k, c), got {tuple(x.shape)} and "
            f"{tuple(w.shape)}"
        )
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.device.type == "cpu":
        return ref.conv1d_depthwise(x, w, activation)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, s, c = x.shape
    k = w.shape[0]
    dtype = dtype_name(x.dtype)
    check_launch(b, s, c, k, block_seq, dtype)
    if x.stride(2) != 1 and c > 1:
        raise ValueError(
            f"x's channels must be adjacent (stride 1), got strides "
            f"{x.stride()}"
        )
    w = w.to(x.dtype).contiguous()
    y = torch.empty((b, s, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    err = lib.repro_conv1d_depthwise(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), b, s, c, k,
        x.stride(0), x.stride(1), block_seq, ACTIVATIONS.index(activation),
        DTYPE_CODES[dtype], vector_width(x, w), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"{KERNEL} kernel launch failed: CUDA error {err} "
            f"({lib.repro_cuda_error_string(err).decode()})"
        )
    conv1d_depthwise_cuda.launches += 1
    return y


conv1d_depthwise_cuda.launches = 0


def reset_launch_counts() -> None:
    """Zero ``conv1d_depthwise_cuda.launches``."""
    conv1d_depthwise_cuda.launches = 0
