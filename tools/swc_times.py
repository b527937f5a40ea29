#!/usr/bin/env python3
"""Time the depth-1 ``swc`` kernel (B1, ``csrc/fused_stencil.cu``) on the
card at the main path's shapes, in the planner's launch and in variants
of it, each held to its plain version first.

    PYTHONPATH=src python3 tools/swc_times.py            # every row
    PYTHONPATH=src python3 tools/swc_times.py --default  # planner's only
    PYTHONPATH=<other tree>/src python3 tools/swc_times.py --default

With another tree's package on the path (say the parent commit) the
planner's rows time that tree's kernel, so two trees compare within one
call on one card.

Rows (CUDA events, median of 10 after 2 warm-ups, per launch): diffusion
2^26, 8192² and 512³ f32 (order 6), 512³ bf16, 256³ f64, the serve
launches (order 2, B = 8) at 4096² and 256³, the MHD RHS and fused
substep at 256³ f32 and the RHS at 128³ f64, each on the planner's tile.
A variant sets the kernel's threads, ring stages, the rank-1 step's
points (``plan.SWC_THREADS``, ``SWC_STAGES``, ``SWC_STEP_POINTS``) or
the tile for the row's launch (the outputs per thread are the kernel's
own: ``SWC_OUTPUTS``).
Each row prints the persistent grid, the ring, threads, outputs per
thread and registers (``chip_smoke.swc_launch_info``). Prints the card's
name and power limit first. Needs a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SELECT_VARIANTS = ({}, {"stages": 2}, {"stages": 3})
VARIANTS = {
    "diffusion 2^26 f32": SELECT_VARIANTS + ({"step": 2048}, {"step": 8192}),
    "diffusion 8192^2 f32": SELECT_VARIANTS + ({"block": (16, 64)},
                                               {"block": (32, 64)}),
    "serve 4096^2 B=8": SELECT_VARIANTS + ({"block": (16, 64)},
                                           {"block": (32, 64)}),
    "serve 256^3 B=8": SELECT_VARIANTS + ({"block": (4, 8, 32)},
                                          {"block": (8, 8, 32)}),
    "diffusion 512^3 f32": SELECT_VARIANTS + ({"block": (4, 8, 32)},
                                              {"block": (8, 8, 32)}),
    "diffusion 512^3 bf16": SELECT_VARIANTS + ({"block": (4, 8, 32)},
                                               {"block": (8, 8, 32)}),
    "diffusion 256^3 f64": SELECT_VARIANTS + ({"block": (8, 8, 32)},),
    "MHD rhs 256^3 f32": ({}, {"block": (1, 8, 32), "threads": 256},
                          {"block": (1, 16, 32)}, {"stages": 3}),
    "MHD substep 256^3 f32": ({},),
    "MHD rhs 128^3 f64": ({}, {"block": (1, 4, 32), "threads": 128}),
}


def _apply(plan_mod, variant, kind):
    """Set the plan constants of ``variant``; returns the old values (None
    for the planner's own launch, which another tree may time)."""
    if not variant:
        return None
    old = (dict(plan_mod.SWC_THREADS), dict(plan_mod.SWC_STAGES),
           plan_mod.SWC_STEP_POINTS)
    if "threads" in variant:
        plan_mod.SWC_THREADS = {k: variant["threads"] for k in old[0]}
    if "stages" in variant:
        plan_mod.SWC_STAGES[kind] = variant["stages"]
    if "step" in variant:
        plan_mod.SWC_STEP_POINTS = variant["step"]
    return old


def _restore(plan_mod, old):
    if old is None:
        return
    plan_mod.SWC_THREADS, plan_mod.SWC_STAGES, plan_mod.SWC_STEP_POINTS = old


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("swc_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import plan as plan_mod
    from repro_torch.kernels.emit import fused_stencil_swc

    print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]))
    build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    makers = {
        "diffusion 2^26 f32": lambda b: cs.diffusion_case(
            (1 << 26,), "float32", dev, block=b),
        "diffusion 8192^2 f32": lambda b: cs.diffusion_case(
            (8192, 8192), "float32", dev, block=b),
        "serve 4096^2 B=8": lambda b: cs.diffusion_case(
            (4096, 4096), "float32", dev, block=b, batch=8, accuracy=2),
        "serve 256^3 B=8": lambda b: cs.diffusion_case(
            (256,) * 3, "float32", dev, block=b, batch=8, accuracy=2),
        "diffusion 512^3 f32": lambda b: cs.diffusion_case(
            (512,) * 3, "float32", dev, block=b),
        "diffusion 512^3 bf16": lambda b: cs.diffusion_case(
            (512,) * 3, "bfloat16", dev, block=b),
        "diffusion 256^3 f64": lambda b: cs.diffusion_case(
            (256,) * 3, "float64", dev, block=b),
        "MHD rhs 256^3 f32": lambda b: cs.mhd_case(
            (256,) * 3, "float32", dev, False, block=b, smooth=False),
        "MHD substep 256^3 f32": lambda b: cs.mhd_case(
            (256,) * 3, "float32", dev, True, block=b, smooth=False),
        "MHD rhs 128^3 f64": lambda b: cs.mhd_case(
            (128,) * 3, "float64", dev, False, block=b, smooth=False),
    }
    for label, make in makers.items():
        variants = VARIANTS[label][:1] if "--default" in argv else (
            VARIANTS[label])
        for variant in variants:
            kind = "mhd" if label.startswith("MHD") else "select"
            old = _apply(plan_mod, variant, kind)
            try:
                case = make(variant.get("block"))
                fp, ops, phi, plan, aux = case
                got = fused_stencil_swc(fp, ops, phi, plan, aux=aux)
                want = cs.plain(case)
                err, rel = cs.rel_err(got, want)
                if rel > cs.TOL[plan.dtype]:
                    raise AssertionError(f"{label} {variant}: rel err "
                                         f"{rel:.3e}")
                del want, got
                ms = cs.time_ms(lambda: fused_stencil_swc(
                    fp, ops, phi, plan, aux=aux), 10)
                name = ",".join(f"{k}={v}" for k, v in variant.items())
                info = (cs.swc_launch_info(plan, phi)
                        if getattr(plan, "persistent", False)
                        else "one tile per block")
                print(f"{label:<22} {name or 'planner':<22} {ms:9.4f} ms  "
                      f"rel {rel:.3e}  tile {plan.block}  {info}",
                      flush=True)
                del fp, aux, case
            finally:
                _restore(plan_mod, old)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
