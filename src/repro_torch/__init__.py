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
}


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
    """``"float32"``/``"float64"``/``"bfloat16"`` (or the torch dtype
    itself) → dtype."""
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
