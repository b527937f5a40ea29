#!/usr/bin/env python3
"""Time the ``swc_stream`` kernel at depth 1 (B3,
``csrc/fused_stencil_stream.cu`` and its ring body
``csrc/stream_body.cuh``) on the card at the main
path's shapes, in the planner's launch and in variants of it, each held
to its plain version first.

    PYTHONPATH=src python3 tools/stream_times.py            # every row
    PYTHONPATH=src python3 tools/stream_times.py --default  # planner's only
    PYTHONPATH=<other tree>/src python3 tools/stream_times.py --default

With another tree's package on the path (say the parent commit) the
planner's rows time that tree's kernel, so two trees compare within one
call on one card.

Rows (CUDA events, median of 10 after 2 warm-ups, per launch; the MHD
rows of 5): diffusion 512³ f32 (order 6), 8192² f32 (the y-stream), 256³
f64, the serve launches (order 2, B = 8) at 4096² and 256³, the MHD RHS
at 256³ f32 and 128³ f64, each on the planner's tile. A variant sets the
ring's chunks, the outputs per thread or the threads
(``plan.STREAM_STAGES``, ``STREAM_OUTPUTS``, ``STREAM_THREADS``), the
tile (chunk and cross tile), the segments, or (``ring=False``) sends the
MHD RHS to the one-buffer body. Each row prints the grid, chunk and cross
tile, the ring, threads x outputs per thread, registers and spills
(``chip_smoke.stream_launch_info``).
Prints the card's name and power limit first. Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RANK2 = ({}, {"stages": 4}, {"outputs": 2}, {"block": (16, 128)},
         {"block": (32, 128)}, {"block": (64, 128)}, {"block": (32, 256)},
         {"block": (32, 128), "stages": 4}, {"block": (32, 64)}, {})
VARIANTS = {
    "diffusion 512^3 f32": ({}, {"stages": 2}, {"stages": 4}, {"outputs": 2},
                            {"block": (4, 16, 32)}, {"block": (8, 8, 64)},
                            {}),
    "diffusion 8192^2 f32": RANK2,
    "serve 4096^2 B=8": RANK2,
    "serve 256^3 B=8": ({}, {"stages": 4}, {"block": (16, 16, 32)},
                        {"block": (8, 8, 64)}, {}),
    "diffusion 256^3 f64": ({}, {"stages": 3}, {"block": (8, 16, 32)},
                            {"block": (4, 16, 32)}, {"block": (8, 8, 64)},
                            {}),
    "MHD rhs 256^3 f32": ({}, {"ring": False}, {"threads": 256},
                          {"block": (1, 4, 32)}, {}),
    "MHD rhs 128^3 f64": ({},),
}
_KNOBS = ("STREAM_STAGES", "STREAM_OUTPUTS", "STREAM_THREADS",
          "STREAM_RING_MHD_DTYPES")


def _apply(plan_mod, variant, kind):
    """Set the plan constants of ``variant``; returns the old values (None
    for the planner's own launch, which another tree may time)."""
    if not variant:
        return None
    old = {k: getattr(plan_mod, k) for k in _KNOBS}
    for key, knob in (("stages", "STREAM_STAGES"),
                      ("outputs", "STREAM_OUTPUTS"),
                      ("threads", "STREAM_THREADS")):
        if key in variant:
            setattr(plan_mod, knob, {**old[knob], kind: variant[key]})
    if variant.get("ring") is False:
        plan_mod.STREAM_RING_MHD_DTYPES = ()
    return old


def _restore(plan_mod, old):
    if old is not None:
        for k, v in old.items():
            setattr(plan_mod, k, v)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("stream_times: no CUDA device", file=sys.stderr)
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
    stream = "swc_stream"
    makers = {
        "diffusion 512^3 f32": lambda b: cs.diffusion_case(
            (512,) * 3, "float32", dev, block=b, strategy=stream),
        "diffusion 8192^2 f32": lambda b: cs.diffusion_case(
            (8192, 8192), "float32", dev, block=b, strategy=stream),
        "serve 4096^2 B=8": lambda b: cs.diffusion_case(
            (4096, 4096), "float32", dev, block=b, batch=8, accuracy=2,
            strategy=stream),
        "serve 256^3 B=8": lambda b: cs.diffusion_case(
            (256,) * 3, "float32", dev, block=b, batch=8, accuracy=2,
            strategy=stream),
        "diffusion 256^3 f64": lambda b: cs.diffusion_case(
            (256,) * 3, "float64", dev, block=b, strategy=stream),
        "MHD rhs 256^3 f32": lambda b: cs.mhd_case(
            (256,) * 3, "float32", dev, False, block=b, smooth=False,
            strategy=stream),
        "MHD rhs 128^3 f64": lambda b: cs.mhd_case(
            (128,) * 3, "float64", dev, False, block=b, smooth=False,
            strategy=stream),
    }
    for label, make in makers.items():
        variants = VARIANTS[label][:1] if "--default" in argv else (
            VARIANTS[label])
        mhd = label.startswith("MHD")
        for variant in variants:
            old = _apply(plan_mod, variant, "mhd" if mhd else "select")
            try:
                case = make(variant.get("block"))
                fp, ops, phi, plan, aux = case
                if "segments" in variant:
                    plan = dataclasses.replace(plan,
                                               segments=variant["segments"])
                    case = (fp, ops, phi, plan, aux)
                got = fused_stencil_swc(fp, ops, phi, plan, aux=aux)
                want = cs.plain(case)
                err, rel = cs.rel_err(got, want)
                if rel > cs.TOL[plan.dtype]:
                    raise AssertionError(f"{label} {variant}: rel err "
                                         f"{rel:.3e}")
                del want, got
                ms = cs.time_ms(lambda: fused_stencil_swc(
                    fp, ops, phi, plan, aux=aux), 5 if mhd else 10)
                name = ",".join(f"{k}={v}" for k, v in variant.items())
                print(f"{label:<22} {name or 'planner':<22} {ms:9.4f} ms  "
                      f"rel {rel:.3e}  {cs.stream_launch_info(plan, phi)}",
                      flush=True)
                del fp, aux, case
            finally:
                _restore(plan_mod, old)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
