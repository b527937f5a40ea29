#!/usr/bin/env python3
"""Digest the outputs of the port's CUDA kernels on the card, so that two
trees can be shown to give the same outputs bit for bit.

    PYTHONPATH=src python3 tools/port_digest.py > digest.txt

Runs a fixed set of launches, with inputs made from seeds, through
``repro_torch`` as the import path finds it (point ``PYTHONPATH`` at
another tree's ``src`` to digest that tree's kernels, built into that
tree's ``build/``): diffusion on ``tc`` at orders 2-8, ranks 1-3, depth 1
and 2, in float32 and bfloat16; diffusion on ``swc`` at depth 1-3 and on
``swc_stream`` at depth 1-2, in float32 and float64; one MHD RK3 step on
``swc`` (plain, fused axpy, ``fuse_rk_pairs``), ``swc_stream`` (plain)
and ``tc`` (all three), whose φ reads its parameter rows. It prints one
line per case: the label and the sha256 of the output's bytes. Compare
two trees' files with ``diff``. Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import hashlib
import sys


def _digest(t) -> str:
    """sha256 of a tensor's bytes (any dtype, bfloat16 included)."""
    import torch

    raw = t.detach().contiguous().cpu().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def cases(dev):
    """(label, output) of every case, in a fixed order."""
    import torch

    from repro_torch.physics.diffusion import DiffusionProblem
    from repro_torch.physics.mhd import MHDSolver

    shapes = ((65536,), (512, 400), (64, 96, 120))
    for order in (2, 4, 6, 8):
        for shape in shapes:
            p = DiffusionProblem(shape, accuracy=order)
            for dtype in ("float32", "bfloat16"):
                f = p.init_field(seed=order, device=dev, dtype=dtype)
                for depth in (1, 2):
                    op = p.step_op("tc", fuse_steps=depth, device=dev)
                    yield f"tc o{order} {shape} {dtype} S{depth}", op(f)
    for strategy, depths in (("swc", (1, 2, 3)), ("swc_stream", (1, 2))):
        for shape in shapes[1:]:
            p = DiffusionProblem(shape, accuracy=6)
            for dtype in ("float32", "float64"):
                f = p.init_field(seed=1, device=dev, dtype=dtype)
                for depth in depths:
                    op = p.step_op(strategy, fuse_steps=depth, device=dev)
                    yield f"{strategy} {shape} {dtype} S{depth}", op(f)
    forms = (("plain", {}), ("fuse_rk_axpy", {"fuse_rk_axpy": True}),
             ("fuse_rk_pairs", {"fuse_rk_pairs": True}))
    for strategy, names in (("swc", ("plain", "fuse_rk_axpy", "fuse_rk_pairs")),
                            ("swc_stream", ("plain",)),
                            ("tc", ("plain", "fuse_rk_axpy", "fuse_rk_pairs"))):
        for name, kw in forms:
            if name not in names:
                continue
            solver = MHDSolver((32, 32, 64), strategy=strategy, device=dev,
                               **kw)
            f = solver.init_fields(seed=2, dtype="float32")
            dt = float(solver.cfl_dt(f))
            yield f"mhd {strategy} {name}", solver.step(f, dt)
    torch.cuda.synchronize()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_digest: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    build.build_all()  # one nvcc per source, all at once
    dev = torch.device("cuda", torch.cuda.current_device())
    for label, out in cases(dev):
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{label}: non-finite output")
        print(f"{label}: {_digest(out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
