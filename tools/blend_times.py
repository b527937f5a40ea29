#!/usr/bin/env python3
"""Times of the ``boundary_weights`` blend on the card.

The order-6 Laplacian (``select``) at 512³ f32 with walls on every axis
(``dirichlet``) and on z alone (``("dirichlet", "periodic",
"periodic")``), on ``swc``, ``swc_stream`` and ``tc``: the kernel's
launch, the blend (``FusedStencilOp.blend_boundary_weights``) and the
whole step (pad + launch + blend), medians of CUDA events; then the
blend once under ``torch.profiler``: its device time summed over its
kernels, their count, and the share of the blend's CUDA-event time the
device was busy (the rest is the host issuing the launches).

    PYTHONPATH=src python3 tools/blend_times.py

Needs one CUDA card; builds the kernels at first use.
"""
from __future__ import annotations

import statistics
import subprocess
import sys

import torch

N = 512
MODES = ("dirichlet", ("dirichlet", "periodic", "periodic"))
STRATEGIES = ("swc", "swc_stream", "tc")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_time(fn) -> tuple[float, int]:
    """(device ms summed over the kernels ``fn`` launches, their count)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.device_time for e in kernels) / 1e3, len(kernels)


def main() -> int:
    if not torch.cuda.is_available():
        print("blend_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.boundary import pad
    from repro_torch.core.fusion import FusedStencilOp
    from repro_torch.core.stencil import OperatorSet, laplacian_stencil
    from repro_torch.kernels.phi import select_phi

    dev = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    ops = OperatorSet((laplacian_stencil(3, 6, spacing=1.0 / (N - 1)),))
    r = ops.radius_per_axis()
    gen = torch.Generator(device=dev).manual_seed(0)
    f = torch.randn((1, N, N, N), generator=gen, device=dev)
    for modes in MODES:
        fp = pad(f, r, modes, spatial_axes=range(1, 4))
        for strategy in STRATEGIES:
            op = FusedStencilOp(ops, select_phi("lap"), 1,
                                boundary_mode=modes, strategy=strategy,
                                boundary_weights=True, device=dev)
            out = op.apply_padded(fp)
            kernel = time_ms(lambda: op.apply_padded(fp))
            blend = time_ms(lambda: op.blend_boundary_weights(f, out))
            step = time_ms(lambda: op(f))
            busy, count = device_time(
                lambda: op.blend_boundary_weights(f, out))
            print(f"{modes!s:<38} {strategy:<10} kernel {kernel:.4f} ms  "
                  f"blend {blend:.4f} ms ({count} kernels, device busy "
                  f"{busy:.4f} ms, {busy / blend:.1%})  step {step:.4f} ms  "
                  f"blend share {blend / step:.1%}")
            del out
        del fp
    return 0


if __name__ == "__main__":
    sys.exit(main())
