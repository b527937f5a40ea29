#!/usr/bin/env python3
"""Time the ``tc`` kernel's launches on the card at the main path's
shapes, each held to its plain version first.

    PYTHONPATH=src python3 tools/tc_times.py

Rows (CUDA events, median of 10 after 2 warm-ups, per launch): diffusion
512³ f32 and bf16, 8192² and 2^26 f32 (order 6), the serve launches
(order 2, B = 8) at 256³ and 4096², the MHD RHS and fused substep at
256³ f32 on the solver's tile, and the depth-2 rows (512³ f32 and the
MHD pair at 128³). Prints the card's name and power limit first. Needs a
CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tc_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.emit import fused_stencil_swc

    print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]))
    build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    cases = [
        ("diffusion 512^3 f32", lambda: cs.diffusion_case(
            (512,) * 3, "float32", dev, strategy="tc")),
        ("diffusion 512^3 bf16", lambda: cs.diffusion_case(
            (512,) * 3, "bfloat16", dev, strategy="tc")),
        ("diffusion 8192^2 f32", lambda: cs.diffusion_case(
            (8192, 8192), "float32", dev, strategy="tc")),
        ("diffusion 2^26 f32", lambda: cs.diffusion_case(
            (1 << 26,), "float32", dev, strategy="tc")),
        ("serve 256^3 B=8", lambda: cs.diffusion_case(
            (256,) * 3, "float32", dev, strategy="tc", batch=8, accuracy=2)),
        ("serve 4096^2 B=8", lambda: cs.diffusion_case(
            (4096, 4096), "float32", dev, strategy="tc", batch=8,
            accuracy=2)),
        ("MHD rhs 256^3", lambda: cs.mhd_case(
            (256,) * 3, "float32", dev, False, smooth=False, strategy="tc")),
        ("MHD substep 256^3", lambda: cs.mhd_case(
            (256,) * 3, "float32", dev, True, smooth=False, strategy="tc")),
        ("diffusion 512^3 f32 S=2", lambda: cs.diffusion_case(
            (512,) * 3, "float32", dev, strategy="tc", fuse_steps=2)),
        ("MHD pair 128^3", lambda: cs.mhd_pair_case(
            (128,) * 3, "float32", dev, substeps=(0, 1), smooth=False,
            strategy="tc")),
    ]
    for label, make in cases:
        fp, ops, phi, plan, aux = make()
        dtype = plan.dtype
        got = fused_stencil_swc(fp, ops, phi, plan, aux=aux)
        err, rel = cs.rel_err(got, cs.plain((fp, ops, phi, plan, aux)))
        if rel > cs.TOL[dtype]:
            raise AssertionError(f"{label}: rel err {rel:.3e}")
        ms = cs.time_ms(lambda: fused_stencil_swc(fp, ops, phi, plan,
                                                  aux=aux), 10)
        first = phi[0] if isinstance(phi, tuple) else phi
        print(f"{label:<26} {ms:9.4f} ms  rel {rel:.3e}  "
              f"{cs.tc_launch_info(plan, first)}", flush=True)
        del fp, got, aux
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
