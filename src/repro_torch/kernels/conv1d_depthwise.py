"""Wrapper of the hand-written CUDA depthwise causal conv1d (port of
``repro.kernels.conv1d_depthwise.conv1d_depthwise_pallas``, the TPU
kernel B7: mamba2's conv frontend).

:func:`conv1d_depthwise_cuda` computes y[b, t, c] = Σ_{j<k} w[j, c] ·
x[b, t-(k-1)+j, c] with zeros left of each sequence, then optionally
``y * sigmoid(y)`` (``activation="silu"``): (b, s, c) and (k, c) give
(b, s, c) (``csrc/conv1d_depthwise.cu``). ``x`` may be strided along its
batch and sequence axes (mamba2's xBC is a column slice of the
in-projection); its channels must be adjacent. Each lane of a warp takes
:func:`vector_width` channels (16 bytes when the shapes, strides and
pointers allow); a persistent grid (:func:`launch_layout`) gives each
warp one contiguous run of the (warp column, batch, position) space
(:func:`warp_runs`), which it walks along the sequence. Any float dtype
(float32, float64, bfloat16, float16) and any k >= 1: up to ``MAX_K``
taps the kernel holds them and a window of k - 1 inputs in registers;
more taps run its body with k at run time (:func:`tap_body`).

A CPU tensor goes to the plain version (``ref.conv1d_depthwise``); a
CUDA tensor goes to the kernel, or the wrapper raises — there is no
fallback from one to the other. Under autograd (training) the call goes
through :class:`Conv1dDepthwise`: the kernel forward, the plain
version's gradient backward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import ITEMSIZE, cast, dtype_name
from repro_torch.kernels import build, ref
from repro_torch.kernels.emit import DTYPE_CODES, check_out, decode_layout

KERNEL = "conv1d_depthwise"  # csrc/conv1d_depthwise.cu
ACTIVATIONS = ("none", "silu")  # ACT_* of conv1d_depthwise.cu
KERNEL_DTYPES = tuple(ITEMSIZE)  # float32, float64, bfloat16, float16
MAX_K = 8  # the tap counts conv1d_depthwise.cu instantiates: 1..8
THREADS = 256  # threads per block (8 warps)
WARPS = THREADS // 32
MIN_WARP_POSITIONS = 32  # the grid gives each warp at least this many
DEFAULT_BLOCK_SEQ = 512  # the reference's block_seq


def tap_body(k: int) -> int:
    """The kernel's tap body for k taps (the layout's ``taps`` field):
    k itself where it is instantiated (1..``MAX_K``: taps and window in
    registers), else 0 (k at run time, the earlier inputs read again
    through L1)."""
    return k if k <= MAX_K else 0


def check_launch(b: int, s: int, c: int, k: int, block_seq: int,
                 dtype: str) -> None:
    """What the card's kernel takes: a float dtype (``KERNEL_DTYPES``),
    at least one tap, and a positive int ``block_seq`` (the reference's
    run length; the kernel's persistent grid splits the sequence its own
    way, so any ``b`` and ``s`` fit)."""
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"conv1d_depthwise takes {KERNEL_DTYPES}, got "
                         f"{dtype}")
    if k < 1:
        raise ValueError(f"need at least one tap, got k={k}")
    if not isinstance(block_seq, int) or block_seq < 1:
        raise ValueError(f"block_seq must be a positive int, got {block_seq!r}")


def vector_width(x: torch.Tensor, w: torch.Tensor) -> int:
    """Channels per lane: 16 bytes (8 bf16/f16, 4 f32, 2 f64) when the
    channel count and both of ``x``'s outer strides are multiples of it
    and ``x`` and ``w`` start on 16 bytes; else, in a 2-byte type, 2 when
    they are even and both start on 4 bytes (a ``__nv_bfloat162`` or
    ``__half2`` access); else 1."""
    c = x.shape[2]

    def fits(vec: int, align: int) -> bool:
        return (c % vec == 0 and x.stride(0) % vec == 0
                and x.stride(1) % vec == 0 and x.data_ptr() % align == 0
                and w.data_ptr() % align == 0)

    wide = 16 // x.element_size()
    if fits(wide, 16):
        return wide
    if x.element_size() == 2 and fits(2, 4):
        return 2
    return 1


def positions(b: int, s: int, c: int, vec: int) -> int:
    """Positions of the (warp column, batch, position) space: a warp
    column is 32 lanes of ``vec`` channels."""
    lanes = -(-c // vec)
    return -(-lanes // 32) * b * s


def launch_layout(b: int, s: int, c: int, vec: int,
                  resident: int) -> tuple[int, int]:
    """(grid, threads) of a launch: ``THREADS`` threads, and blocks
    enough for one warp per ``MIN_WARP_POSITIONS`` positions, at least 1
    and at most ``resident`` (the kernel's resident blocks per SM times
    the SMs, :func:`kernel_grid` with ``b = 0``)."""
    per_block = WARPS * MIN_WARP_POSITIONS
    work = max(1, -(-positions(b, s, c, vec) // per_block))
    return min(work, resident), THREADS


def warp_runs(b: int, s: int, c: int, vec: int, grid: int):
    """The runs the kernel's warps walk, in the kernel's order: (warp,
    column, batch, t0, t1). Warp w of W = ``grid`` x 8 takes positions
    [w P / W, (w + 1) P / W) of the (column, batch, position) space,
    positions fastest, cut where a sequence ends."""
    seq = b * s
    total = positions(b, s, c, vec)
    n_warps = grid * WARPS
    for warp in range(n_warps):
        p, p_end = warp * total // n_warps, (warp + 1) * total // n_warps
        while p < p_end:
            col, rem = divmod(p, seq)
            bi, t0 = divmod(rem, s)
            t1 = min(s, t0 + (p_end - p))
            yield warp, col, bi, t0, t1
            p += t1 - t0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build/load ``csrc/conv1d_depthwise.cu`` and declare its C
    signatures."""
    lib = build.load(KERNEL)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_conv1d_depthwise.argtypes = [
        vp, vp, vp, ci, ci, ci, ci, ll, ll, ci, ci, ci, ci, vp,
    ]
    lib.repro_conv1d_depthwise.restype = ci
    lib.repro_conv1d_depthwise_threads.argtypes = []
    lib.repro_conv1d_depthwise_threads.restype = ci
    lib.repro_conv1d_depthwise_grid.argtypes = [ci] * 8
    lib.repro_conv1d_depthwise_grid.restype = ll
    lib.repro_conv1d_depthwise_layout.argtypes = [ci] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.repro_conv1d_depthwise_layout.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def layout_fields(b: int, s: int, c: int, k: int, vec: int
                  ) -> tuple[str, dict[str, int]]:
    """(body, fields) of a launch by the kernel's own
    ``repro_conv1d_depthwise_layout`` (needs the built library; host
    only): threads, vec, positions, the work's blocks, shared bytes and
    the tap body (:func:`tap_body`), which
    ``repro_torch.analysis.bodies.conv1d_depthwise`` mirrors."""
    out = (ctypes.c_longlong * 16)()
    n = _lib().repro_conv1d_depthwise_layout(b, s, c, k, vec, out)
    return decode_layout(out[:n])


def kernel_threads() -> int:
    """Threads per block by the kernel's own layout (needs the built
    library; ``THREADS`` must equal it)."""
    return int(_lib().repro_conv1d_depthwise_threads())


def kernel_grid(b: int, s: int, c: int, k: int, activation: str,
                dtype: str, vec: int, device: int = 0) -> int:
    """Blocks the kernel launches for (b, s, c) by its own occupancy
    (needs the built library and the card; :func:`launch_layout` must
    equal it); ``b = 0`` gives its resident blocks alone."""
    grid = int(_lib().repro_conv1d_depthwise_grid(
        b, s, c, k, ACTIVATIONS.index(activation), DTYPE_CODES[dtype], vec,
        device))
    if grid < 0:
        raise RuntimeError(f"{KERNEL} grid query failed: CUDA error {-grid}")
    return grid


def conv1d_depthwise_cuda(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    activation: str = "none",
    block_seq: int = DEFAULT_BLOCK_SEQ,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Causal depthwise conv of ``x`` (b, s, c) with ``w`` (k, c), ``w``
    cast to ``x``'s dtype (``repro_torch.cast``), then ``activation``
    (``"none"`` or ``"silu"``); returns a contiguous (b, s, c) tensor, ``out`` when
    given (contiguous, the result's shape, dtype and device:
    ``emit.check_out``; with 16-byte or paired lanes, aligned as ``x``).

    On a CUDA tensor: one launch of ``csrc/conv1d_depthwise.cu`` on the
    current stream, adding one to ``conv1d_depthwise_cuda.launches``, at
    :func:`vector_width` channels per lane, and recording (b, s, c, k,
    dtype, vec, strides) in ``conv1d_depthwise_cuda.launched`` (kept
    across :func:`reset_launch_counts`, for the static auditor). On a CPU
    tensor: the plain version, ``ref.conv1d_depthwise``.

    When a gradient is wanted (grad mode on and ``x`` or ``w`` requiring
    one), the call goes through :class:`Conv1dDepthwise`: the same
    forward (the launch on the card), the plain version's gradient
    backward. Otherwise (serving under ``no_grad``) it is the bare
    forward, with no graph.
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
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if out is not None:
            raise ValueError("out= takes no gradient; call under no_grad")
        return Conv1dDepthwise.apply(x, w, activation, block_seq)
    return _forward(x, w, activation, block_seq, out)


def _forward(x: torch.Tensor, w: torch.Tensor, activation: str,
             block_seq: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """The forward of :func:`conv1d_depthwise_cuda` on checked shapes:
    the plain version on a CPU tensor, the kernel's launch on a CUDA
    one (raising on what the kernel does not take)."""
    if out is not None:
        check_out(out, tuple(x.shape), x)
    if x.device.type == "cpu":
        res = ref.conv1d_depthwise(x, w, activation)
        return res if out is None else out.copy_(res)
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
    w = cast(w, x.dtype).contiguous()
    y = out if out is not None else torch.empty(
        (b, s, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _lib()
    vec = vector_width(x, w)
    err = lib.repro_conv1d_depthwise(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), b, s, c, k,
        x.stride(0), x.stride(1), ACTIVATIONS.index(activation),
        DTYPE_CODES[dtype], vec, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"{KERNEL} kernel launch failed: CUDA error {err} "
            f"({lib.repro_cuda_error_string(err).decode()})"
        )
    conv1d_depthwise_cuda.launches += 1
    conv1d_depthwise_cuda.launched.add(
        (b, s, c, k, dtype, vec, x.stride(0), x.stride(1)))
    return y


class Conv1dDepthwise(torch.autograd.Function):
    """B7 under autograd: ``apply(x, w, activation, block_seq)``.

    Forward: :func:`_forward`, the kernel's launch on a CUDA tensor (a
    shape or dtype it refuses raises, as without a gradient; nothing
    drops to the plain forward) and the plain version on a CPU one.
    Backward: the plain version's gradient, ``ref.conv1d_depthwise``
    run again on the saved ``x`` and ``w`` under ``enable_grad`` and
    differentiated with ``torch.autograd.grad``. The TPU kernel has no
    backward kernel (the reference differentiates its plain conv), so
    this has none either; the forward rounds as the plain version does,
    so the gradient is that of the function the kernel computed.
    """

    @staticmethod
    def forward(ctx, x, w, activation, block_seq):
        ctx.activation = activation
        ctx.save_for_backward(x, w)
        return _forward(x, w, activation, block_seq)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xd = x.detach().requires_grad_(need_x)
            wd = w.detach().requires_grad_(need_w)
            y = ref.conv1d_depthwise(xd, wd, ctx.activation)
            wanted = [t for t in (xd, wd) if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, gy))
        gx = next(grads) if need_x else None
        gw = next(grads) if need_w else None
        return gx, gw, None, None


conv1d_depthwise_cuda.launches = 0
conv1d_depthwise_cuda.launched = set()


def reset_launch_counts() -> None:
    """Zero ``conv1d_depthwise_cuda.launches``."""
    conv1d_depthwise_cuda.launches = 0
