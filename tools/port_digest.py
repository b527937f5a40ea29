#!/usr/bin/env python3
"""Digest the outputs of the port's CUDA kernels on the card, so that two
trees can be shown to give the same outputs bit for bit.

    PYTHONPATH=src python3 tools/port_digest.py > digest.txt
    PYTHONPATH=src python3 tools/port_digest.py --errors  # and errors

Runs a fixed set of launches, with inputs made from seeds, through
``repro_torch`` as the import path finds it (point ``PYTHONPATH`` at
another tree's ``src`` to digest that tree's kernels, built into that
tree's ``build/``): diffusion on ``tc`` at orders 2-8, ranks 1-3, depth 1
and 2, in float32 and bfloat16; diffusion on ``swc`` and ``swc_stream``
at depth 1-3, in float32 and float64; one MHD RK3 step on
``swc`` (plain, fused axpy, ``fuse_rk_pairs``), ``swc_stream`` (plain)
and ``tc`` (all three), whose φ reads its parameter rows; the B6
cross-correlation (``ops.xcorr1d``) on baseline and on pointwise and
elementwise at U = 1, 4, 8, 16, r = 0, 3, 10, 64, 1024 (r = 10 the
first radius of elementwise's ring), float32 and float64,
n = 2^20 + 123 (a ragged last tile); the B7 conv (``ops.conv1d_depthwise``)
on mamba2's xBC view (2, 1024, 3328) of a (2, 1024, 6448) in-projection,
k = 4, bfloat16 and float32, none and silu. It prints one
line per case: the label and the sha256 of the output's bytes (with
``--errors`` also its max |err| over max |plain| against the plain
version, the same case on the CPU, where the wrapper takes it). Compare
two trees' files (without ``--errors``) with ``diff``. The ``swc``,
``swc_stream``, ``xcorr1d`` and ``conv1d`` lines must not differ between
a change that keeps these kernels' arithmetic and its parent: each sums
in a fixed order (B6 one FMA a tap in tap order, B7 each product and sum
rounded to the input type), whatever the kernel's loop shape. Needs a
CUDA card; exits 2 without one.
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
    """(label, run) of every case, in a fixed order: ``run(device)`` gives
    the case's output on ``device`` from the same inputs (made on the card,
    moved there)."""
    import torch

    from repro_torch.physics.diffusion import DiffusionProblem
    from repro_torch.physics.mhd import MHDSolver

    def stepper(p, strategy, depth, f):
        return lambda device: p.step_op(strategy, fuse_steps=depth,
                                        device=device)(f.to(device))

    shapes = ((65536,), (512, 400), (64, 96, 120))
    for order in (2, 4, 6, 8):
        for shape in shapes:
            p = DiffusionProblem(shape, accuracy=order)
            for dtype in ("float32", "bfloat16"):
                f = p.init_field(seed=order, device=dev, dtype=dtype)
                for depth in (1, 2):
                    yield (f"tc o{order} {shape} {dtype} S{depth}",
                           stepper(p, "tc", depth, f))
    for strategy, depths in (("swc", (1, 2, 3)), ("swc_stream", (1, 2, 3))):
        for shape in shapes[1:]:
            p = DiffusionProblem(shape, accuracy=6)
            for dtype in ("float32", "float64"):
                f = p.init_field(seed=1, device=dev, dtype=dtype)
                for depth in depths:
                    yield (f"{strategy} {shape} {dtype} S{depth}",
                           stepper(p, strategy, depth, f))
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

            def run(device, kw=kw, strategy=strategy, f=f, dt=dt):
                s = MHDSolver((32, 32, 64), strategy=strategy, device=device,
                              **kw)
                return s.step(f.to(device), dt)

            yield f"mhd {strategy} {name}", run
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cpu").manual_seed(5)
    n = (1 << 20) + 123
    for dtype in (torch.float32, torch.float64):
        for r in (0, 3, 10, 64, 1024):
            f = torch.randn(n + 2 * r, generator=gen, dtype=torch.float64)
            g = torch.randn(2 * r + 1, generator=gen, dtype=torch.float64)
            f, g = f.to(dev, dtype), g.to(dev, dtype)
            for strategy, unrolls in (("baseline", (1,)),
                                      ("pointwise", (1, 4, 8, 16)),
                                      ("elementwise", (1, 4, 8, 16))):
                for u in unrolls:
                    def run(device, f=f, g=g, strategy=strategy, u=u):
                        return ops.xcorr1d(f.to(device), g.to(device),
                                           strategy=strategy, unroll=u)

                    yield (f"xcorr1d {strategy} u{u} r={r} "
                           f"{str(dtype)[6:]}", run)
    for dtype in (torch.bfloat16, torch.float32):
        proj = torch.randn((2, 1024, 6448), generator=gen).to(dev, dtype)
        w = torch.randn((4, 3328), generator=gen).to(dev, dtype)
        for act in ("none", "silu"):
            def run(device, proj=proj, w=w, act=act):
                x = proj.to(device)[..., 3072:3072 + 3328]
                return ops.conv1d_depthwise(x, w.to(device), activation=act)

            yield f"conv1d xBC (2, 1024, 3328) {str(dtype)[6:]} {act}", run
    torch.cuda.synchronize()


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_digest: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    build.build_all()  # one nvcc per source, all at once
    dev = torch.device("cuda", torch.cuda.current_device())
    for label, run in cases(dev):
        out = run(dev)
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{label}: non-finite output")
        line = f"{label}: {_digest(out)}"
        if "--errors" in argv:  # against the plain version (the CPU path)
            plain = run("cpu").float()
            err = float((out.float().cpu() - plain).abs().max())
            line += f"  rel {err / max(float(plain.abs().max()), 1e-300):.3e}"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
