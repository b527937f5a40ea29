"""PyTorch/CUDA port of the fused-stencil engine (``repro`` is the JAX
reference it is held against).

Layout mirrors ``repro``: ``core`` (stencil weights, boundary padding,
the :class:`~repro_torch.core.fusion.FusedStencilOp` module),
``kernels`` (plan, plain reference, hand-written CUDA kernel and its
wrapper), ``physics`` (diffusion, MHD). The package imports torch and
numpy only — never JAX, never ``repro``.

Every entry point runs on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``; :func:`resolve_device` raises when a
card is asked for and there is none, so nothing falls back to the CPU
silently.
"""
from __future__ import annotations

import torch

DTYPES: dict[str, torch.dtype] = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}
# Bytes a value of each dtype (B6 and B7 take all four; the fused
# stencil's planner keeps its own table, without float16: ROADMAP B9).
ITEMSIZE: dict[str, int] = {name: dt.itemsize for name, dt in DTYPES.items()}


def default_device() -> torch.device:
    """The port's device: the first CUDA card. Raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None``/``"cuda"`` → the current card (raising without one);
    anything else is taken as the caller's explicit choice. A CUDA
    device comes back with its index, so it compares equal to a
    tensor's ``.device``."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda":
        current = default_device()
        if device.index is None:
            return current
    return device


def as_dtype(dtype: str | torch.dtype) -> torch.dtype:
    """``"float32"``/``"float64"``/``"bfloat16"``/``"float16"`` (or the
    torch dtype itself) → dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in DTYPES.values():
            raise ValueError(f"unsupported dtype {dtype}; want {list(DTYPES)}")
        return dtype
    try:
        return DTYPES[dtype]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {dtype!r}; want one of {list(DTYPES)}"
        ) from None


def dtype_name(dtype: torch.dtype) -> str:
    """Inverse of :func:`as_dtype` (``torch.float32`` → ``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, float64 to float16 rounded once, as numpy and
    JAX round it. PyTorch's own cast goes through float32 and rounds
    twice, which can land one float16 ulp away (7 of 200,000 standard
    normals): here the float32 step rounds to odd (the neighbour toward
    zero, its last bit set, where float32 is inexact), which keeps the
    bits the second rounding needs, so float32 to float16 rounds as once.
    Every other pair of dtypes is ``t.to(dtype)``. A float64 ``t`` that
    requires a gradient is refused on the way to float16 (no caller
    casts one; this cast takes no gradient)."""
    if t.dtype != torch.float64 or dtype != torch.float16:
        return t.to(dtype)
    if t.requires_grad:
        raise ValueError("float64 to float16 with a gradient: cast the "
                         "weights to float16 first")
    t32 = t.to(torch.float32)
    inexact = t32.to(torch.float64) != t
    toward0 = torch.where(t32.to(torch.float64).abs() > t.abs(),
                          torch.nextafter(t32, torch.zeros_like(t32)), t32)
    odd = (toward0.view(torch.int32) | 1).view(torch.float32)
    return torch.where(inexact, odd, t32).to(torch.float16)
