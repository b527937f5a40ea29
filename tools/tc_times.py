#!/usr/bin/env python3
"""Time the ``tc`` kernel's launches on the card at the main path's
shapes, in the planner's launch and (depth > 1) in variants of it, each
held to its plain version first.

    PYTHONPATH=src python3 tools/tc_times.py            # every row
    PYTHONPATH=src python3 tools/tc_times.py --default  # planner's only
    PYTHONPATH=<other tree>/src python3 tools/tc_times.py --default

With another tree's package on the path (say the parent commit) the
planner's rows time that tree's kernel, so two trees compare within one
call on one card.

Rows (CUDA events, median of 10 after 2 warm-ups, per launch; the MHD
pairs of 3): diffusion 512³ f32 and bf16, 8192² and 2^26 f32 (order 6),
the serve launches (order 2, B = 8) at 256³ and 4096², the MHD RHS and
fused substep at 256³ f32 on the planner's tile, and the depth > 1 rows
(512³ f32 at depth 2 and 3, bf16 at depth 2, the MHD pair at 128³ and
256³). A variant of a depth > 1 row (the walk, ``csrc/tc_walk_body.cuh``)
sets the tile (step planes and cross tile), the steps of planes the input
ring holds (``plan.WALK_STAGES``, the walks' own) or the segments. Each row prints its
launch (``chip_smoke.tc_launch_info``: at depth 1 the persistent grid,
ring, registers; on the walk its grid, columns, rings, patches a warp,
registers, spills, evaluations per output-step and the banded
multiply-adds issued against the taps'). Prints the card's name and power
limit first. Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

WALK_VARIANTS = ({}, {"block": (2, 32, 32)}, {"block": (4, 16, 32)},
                 {"block": (8, 32, 32)}, {"block": (4, 32, 64)},
                 {"stages": 1}, {"segments": 1})
VARIANTS = {
    "diffusion 512^3 f32 S=2": WALK_VARIANTS,
    "diffusion 512^3 f32 S=3": ({}, {"block": (4, 32, 32)},
                                {"block": (2, 16, 32)}, {"stages": 1}),
    "diffusion 512^3 bf16 S=2": ({}, {"block": (4, 16, 32)},
                                 {"block": (2, 32, 64)}),
    "MHD pair 256^3": ({}, {"block": (1, 4, 16)}, {"block": (1, 4, 8)},
                       {"block": (1, 8, 16)}, {"block": (2, 8, 8)}),
}


def _apply(plan_mod, variant, kind):
    """Set the walk's stages of ``variant`` for the φ kind ``kind``;
    returns the old table (None for a variant that sets none, which
    another tree may time)."""
    if "stages" not in variant:
        return None
    old = dict(plan_mod.WALK_STAGES)
    plan_mod.WALK_STAGES[kind] = variant["stages"]
    return old


def _restore(plan_mod, old):
    if old is not None:
        plan_mod.WALK_STAGES.update(old)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("tc_times: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.kernels import build
    from repro_torch.kernels import plan as plan_mod
    from repro_torch.kernels.emit import fused_stencil_swc

    print(cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]))
    build.build_all()
    dev = torch.device("cuda", torch.cuda.current_device())
    def diffusion(shape, dtype, depth=1, **kw):
        return lambda b: cs.diffusion_case(shape, dtype, dev, block=b,
                                           strategy="tc", fuse_steps=depth,
                                           **kw)

    def pair(n):
        return lambda b: cs.mhd_pair_case((n,) * 3, "float32", dev,
                                          substeps=(0, 1), block=b,
                                          smooth=False, strategy="tc")

    makers = {
        "diffusion 512^3 f32": diffusion((512,) * 3, "float32"),
        "diffusion 512^3 bf16": diffusion((512,) * 3, "bfloat16"),
        "diffusion 8192^2 f32": diffusion((8192, 8192), "float32"),
        "diffusion 2^26 f32": diffusion((1 << 26,), "float32"),
        "serve 256^3 B=8": diffusion((256,) * 3, "float32", batch=8,
                                     accuracy=2),
        "serve 4096^2 B=8": diffusion((4096, 4096), "float32", batch=8,
                                      accuracy=2),
        "MHD rhs 256^3": lambda b: cs.mhd_case(
            (256,) * 3, "float32", dev, False, smooth=False, strategy="tc"),
        "MHD substep 256^3": lambda b: cs.mhd_case(
            (256,) * 3, "float32", dev, True, smooth=False, strategy="tc"),
        "diffusion 512^3 f32 S=2": diffusion((512,) * 3, "float32", 2),
        "diffusion 512^3 f32 S=3": diffusion((512,) * 3, "float32", 3),
        "diffusion 512^3 bf16 S=2": diffusion((512,) * 3, "bfloat16", 2),
        "MHD pair 128^3": pair(128),
        "MHD pair 256^3": pair(256),
    }
    for label, make in makers.items():
        variants = VARIANTS.get(label, ({},))
        if "--default" in argv:
            variants = variants[:1]
        mhd = label.startswith("MHD")
        for variant in variants:
            old = _apply(plan_mod, variant, "mhd" if mhd else "select")
            try:
                fp, ops, phi, plan, aux = make(variant.get("block"))
                if "segments" in variant:
                    plan = dataclasses.replace(plan,
                                               segments=variant["segments"])
                dtype = plan.dtype
                got = fused_stencil_swc(fp, ops, phi, plan, aux=aux)
                err, rel = cs.rel_err(got, cs.plain((fp, ops, phi, plan,
                                                     aux)))
                if rel > cs.TOL[dtype]:
                    raise AssertionError(f"{label}: rel err {rel:.3e}")
                del got
                ms = cs.time_ms(lambda: fused_stencil_swc(
                    fp, ops, phi, plan, aux=aux),
                    3 if mhd and plan.fuse_steps > 1 else 10)
                first = phi[0] if isinstance(phi, tuple) else phi
                name = ",".join(f"{k}={v}" for k, v in variant.items())
                info = cs.tc_launch_info(plan, first, ops)
                print(f"{label:<26} {name or 'planner':<18} {ms:9.4f} ms "
                      f"({ms / plan.fuse_steps:.4f} a step)  rel {rel:.3e}  "
                      f"tile {plan.block}  {info}", flush=True)
                del fp, aux
            finally:
                _restore(plan_mod, old)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
