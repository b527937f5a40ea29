#!/usr/bin/env python3
"""Readings for the limit of ``chip_smoke.py``'s 256³ spectral check.

The 8-field MHD RHS at 256³ in float32, on the plain version (``hwc``:
``ref.fused_stencil`` on the card) and on each kernel (``swc``,
``swc_stream``, ``tc``), against the spectral RHS in float64 of the same
fields (``physics.spectral.spectral_rhs``): max |err| over max |spectral|,
as ``chip_smoke.py`` phase 3 (verify) reads it. The fields are
``chip_smoke.smooth_fields`` (``tests/test_physics.py``'s smooth fields
at amplitude 1e-2) for each seed. At 256³ the 6th-order truncation is
far below float32 roundoff, so the plain version's reading is the floor
the kernels are held to: the limit is twice its largest reading.

    PYTHONPATH=src python3 tools/spectral_limit.py

Needs one CUDA card; builds the kernels at first use.
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
SEEDS = (0, 1)
N = 256
STRATEGIES = ("hwc", "swc", "swc_stream", "tc")


def main() -> int:
    if not torch.cuda.is_available():
        print("spectral_limit: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from repro_torch.physics.mhd import MHDSolver, mhd_rhs_phi
    from repro_torch.physics.spectral import spectral_rhs

    dev = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    worst = {s: 0.0 for s in STRATEGIES}
    for seed in SEEDS:
        f64 = chip_smoke.smooth_fields(N, seed, dev)
        solver = MHDSolver((N,) * 3, device=dev)
        sp = spectral_rhs(f64, solver.spacing, mhd_rhs_phi(solver.params))
        scale = float(sp.abs().max())
        f = f64.float()
        del f64
        for strategy in STRATEGIES:
            solver = MHDSolver((N,) * 3, strategy=strategy, device=dev)
            rhs = solver.rhs(f)
            err = float((rhs.double() - sp).abs().max()) / scale
            worst[strategy] = max(worst[strategy], err)
            print(f"seed {seed} {strategy:<10} rel {err:.4e}")
            del rhs
        del sp, f
        torch.cuda.empty_cache()
    for strategy, err in worst.items():
        print(f"largest {strategy:<10} {err:.4e}")
    print(f"limit (twice the plain version's largest): "
          f"{2 * worst['hwc']:.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
