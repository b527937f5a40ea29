"""Decaying MHD turbulence on a 32³ periodic box with the PyTorch/CUDA
port, the counterpart of ``examples/mhd_simulation.py``: CFL-stepped
RK3 integration through the fused stencil kernel (``swc``, B1 on the
card), kinetic/magnetic energy diagnostics, and a cross-check between
caching strategies mid-run (the plain ``hwc`` path against ``swc`` with
its tile from the tuner).

Run:  PYTHONPATH=src python examples/torch_mhd_simulation.py [--device cpu]
"""
import argparse
import math
import time

import torch

from repro_torch import resolve_device
from repro_torch.kernels import emit
from repro_torch.physics.mhd import (
    AX, AZ, LNRHO, MHDParams, MHDSolver, UX, UZ,
)


def energies(f):
    rho = torch.exp(f[LNRHO])
    u2 = torch.sum(f[UX : UZ + 1] ** 2, dim=0)
    e_kin = float(torch.mean(0.5 * rho * u2))
    # B = ∇×A by central differences at 2nd order on the periodic box.
    a = f[AX : AZ + 1]

    def d(q, ax):
        return (torch.roll(q, -1, ax) - torch.roll(q, 1, ax)) * (
            16 / (4 * math.pi))

    bx = d(a[2], 1) - d(a[1], 0)
    by = d(a[0], 0) - d(a[2], 2)
    bz = d(a[1], 2) - d(a[0], 1)
    e_mag = float(torch.mean(0.5 * (bx**2 + by**2 + bz**2)))
    return e_kin, e_mag


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--amplitude", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' for the plain path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    params = MHDParams(nu=2e-2, eta=2e-2, kappa=2e-3)
    solver = MHDSolver((args.n,) * 3, params=params, strategy="swc",
                       device=device)
    f = solver.init_smooth(seed=3, amplitude=args.amplitude,
                           dtype=torch.float32)

    print(f"MHD {args.n}^3, nu=eta=2e-2, RK3 + 6th-order FD on {device}")
    print(f"{'step':>5} {'t':>8} {'dt':>9} {'E_kin':>12} {'E_mag':>12} "
          f"{'max|u|':>9}")
    emit.reset_launch_counts()
    t_sim, t0 = 0.0, time.time()
    for i in range(args.steps):
        dt = float(solver.cfl_dt(f))
        f = solver.step(f, dt)
        t_sim += dt
        if i % 8 == 0 or i == args.steps - 1:
            ek, em = energies(f)
            umax = float(f[UX : UZ + 1].abs().max())
            print(f"{i:5d} {t_sim:8.3f} {dt:9.5f} {ek:12.4e} {em:12.4e} "
                  f"{umax:9.4f}", flush=True)
        assert math.isfinite(float(f.max())), "simulation blew up"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    ups = args.steps * args.n**3 / wall
    launches = emit.fused_stencil_swc.launches
    print(f"\n{args.steps} steps in {wall:.1f}s "
          f"({ups/1e6:.2f} Mupdates/s on {device}); fused-stencil "
          f"launches: {launches} {dict(emit.fused_stencil_swc.launches_by_kernel)}")

    # Strategy cross-check on the evolved state (the paper's verification
    # protocol), the swc tile resolved by the persistent tuner: a cache
    # hit replays the recorded winner, a miss runs the rank-then-measure
    # search once and persists it.
    from repro_torch.tuning import format_block, lookup_fused_nd

    hwc = MHDSolver((args.n,) * 3, params=params, strategy="hwc",
                    device=device)
    swc = MHDSolver((args.n,) * 3, params=params, strategy="swc",
                    block="auto", device=device)
    want = hwc.rhs(f)
    err = float((want - swc.rhs(f)).abs().max())
    scale = float(want.abs().max())
    rec = lookup_fused_nd(f, swc.operator_set, f.shape[0], "swc")
    if rec is not None:
        print(f"auto-tuned SWC block: {format_block(rec.block)} "
              f"[{rec.source}]")
    print(f"HWC vs SWC on evolved state: max abs diff {err:.2e} "
          f"(field scale {scale:.2e})")
    assert err <= 1e-4 * max(scale, 1.0)
    print("mhd_simulation OK")


if __name__ == "__main__":
    main()
