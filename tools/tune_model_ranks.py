#!/usr/bin/env python3
"""Print the tuner's Hopper cost model ranking (``repro_torch.tuning.
costmodel``) for each ``"auto"`` case of ``chip_smoke.py`` phase 3
(tune): the candidates in the session's order, their modeled ms per step
and which are the planner's own tiles. The model needs no card: run it
anywhere, and hold its order against the measured timing tables the chip
phase prints (which candidates the card timed, which won).

    PYTHONPATH=src python3 tools/tune_model_ranks.py [--top 8]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.core.stencil import OperatorSet
from repro_torch.physics.diffusion import DiffusionProblem
from repro_torch.physics.mhd import MHDSolver, mhd_rhs_device_phi
from repro_torch.tuning.cache import candidate_label
from repro_torch.tuning.costmodel import (
    enumerate_candidates_1d,
    enumerate_candidates_nd,
    enumerate_cross_strategy_nd,
)
from repro_torch.tuning.session import phi_traits


def _ops(shape, accuracy=6) -> OperatorSet:
    p = DiffusionProblem(shape, accuracy=accuracy)
    return OperatorSet((dataclasses.replace(p.merged_stencil(),
                                            name="step"),))


def cases():
    select = dict(operators=("step",))
    yield ("block=auto 512^3 swc", lambda: enumerate_candidates_nd(
        _ops((512,) * 3), (512,) * 3, 1, 1, strategies=("swc",), **select))
    yield ("fuse_steps=auto 512^3 swc", lambda: enumerate_candidates_nd(
        _ops((512,) * 3), (512,) * 3, 1, 1, strategies=("swc",),
        fuse_steps_options=(1, 2, 3, 4), **select))
    for shape in ((512,) * 3, (8192, 8192), (1 << 26,)):
        yield (f"strategy=auto {'x'.join(map(str, shape))}",
               lambda shape=shape: enumerate_cross_strategy_nd(
                   _ops(shape), shape, 1, 1,
                   fuse_steps_options=(1, 2, 3, 4), **select))
    solver = MHDSolver((256,) * 3, device="cpu")
    traits = phi_traits(mhd_rhs_device_phi(solver.params))
    yield ("strategy=auto MHD rhs 256^3", lambda: enumerate_cross_strategy_nd(
        solver.operator_set, (256,) * 3, 8, 8, **traits))
    for shape in ((256,) * 3, (4096, 4096)):
        yield (f"SimServer(strategy=auto) {'x'.join(map(str, shape))} B=8",
               lambda shape=shape: enumerate_cross_strategy_nd(
                   _ops(shape, 2), shape, 1, 1, batch=8, **select))
    yield ("block_size=auto xcorr 2^24 r=1024", lambda: enumerate_candidates_1d(
        1 << 24, 2049, strategy="elementwise", unroll=4))


def label(c) -> str:
    return candidate_label(c.block, getattr(c, "fuse_steps", 1),
                           getattr(c, "stream", False),
                           getattr(c, "strategy", ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    for name, enumerate_ in cases():
        ranked = enumerate_()
        print(f"{name}: {len(ranked)} candidates")
        for i, c in enumerate(ranked):
            default = getattr(c, "default", False)
            if i < args.top or default or getattr(c, "strategy", "") == "hwc":
                mark = " (planner's tile)" if default else ""
                print(f"  {i + 1:4d}  {label(c):>18s}  {c.score:9.4f} ms{mark}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
