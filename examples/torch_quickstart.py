"""Quickstart for the PyTorch/CUDA port (``repro_torch``), the
counterpart of ``examples/quickstart.py``: the three layers of the
framework in about a minute.

1. The paper's fused stencil engine (φ(A·B)) on a 3-D multiphysics RHS:
   the plain ``hwc`` path against ``strategy="auto"``, which the tuner
   resolves to a kernel on the card (B1, B3 or B4 in ``kernels/csrc``).
2. The diffusion equation solved with ONE merged stencil (paper Eq.
   5-7) on the ``swc`` kernel (B1), validated against the exact
   discrete eigenvalue.
3. Reduced LMs from the zoo taking a real train step (mamba2's conv is
   the B7 kernel on the card).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import emit


def stencil_demo(device):
    print("=== 1. fused multiphysics stencil (paper Sec. 4.4) ===")
    from repro_torch.physics.mhd import MHDSolver

    solver_hwc = MHDSolver((16, 16, 16), strategy="hwc", device=device)
    # strategy="auto": the persistent tuner (repro_torch.tuning) picks
    # the caching regime (hwc, swc, swc_stream or tc) jointly with the
    # tile, timed on the card on first use and cached under
    # ~/.cache/repro-torch-tune (or $REPRO_TORCH_TUNE_CACHE).
    solver_auto = MHDSolver((16, 16, 16), strategy="auto", device=device)
    f = solver_hwc.init_smooth(seed=0, amplitude=1e-2, dtype=torch.float32)
    r1 = solver_hwc.rhs(f)
    r2 = solver_auto.rhs(f)
    err = float((r1 - r2).abs().max())
    rop = solver_auto.rhs_op().resolved(f)  # warm cache hit
    print("  8-field MHD RHS, 10 operators, 127 taps fused in one kernel")
    print(f"  strategy='auto' resolved to {rop.strategy!r} "
          f"(block={rop.block}, depth={rop.fuse_steps})")
    print(f"  plain (hwc) vs auto-tuned strategy max diff: {err:.2e}")
    dt = float(solver_hwc.cfl_dt(f))
    f1 = solver_auto.step(f, dt)
    print(f"  one RK3 step (dt={dt:.3f}): max|Δf| = "
          f"{float((f1 - f).abs().max()):.3e}\n")


def diffusion_demo(device):
    print("=== 2. diffusion as one merged stencil (paper Eq. 5-7) ===")
    from repro_torch.physics.diffusion import DiffusionProblem, simulate

    p = DiffusionProblem((16, 16, 32), accuracy=6)
    k = (1, 2, 1)
    f0 = p.fourier_mode(k, device=device)
    out = simulate(p, f0, 50, strategy="swc", device=device)
    decay = float(torch.linalg.norm(out) / torch.linalg.norm(f0))
    spec = p.merged_stencil()
    lam = sum(
        c * np.cos(sum(ki * oi * hi for ki, oi, hi in zip(k, o, p.spacing)))
        for o, c in zip(spec.offsets, spec.coeffs)
    )
    print(f"  mode {k}: measured decay {decay:.6f}, "
          f"exact eigenvalue^50 {lam**50:.6f}\n")
    assert abs(decay - lam**50) <= 1e-6 * max(abs(lam**50), 1.0)


def lm_demo(device):
    print("=== 3. architecture zoo (beyond-paper; not the stencil "
          "pipeline): one real train step ===")
    from repro_torch.configs.registry import (
        get_config,
        get_model,
        reduced_config,
    )
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    for arch in ("qwen2.5-3b", "mamba2-780m", "mixtral-8x7b"):
        cfg = reduced_config(get_config(arch))
        params = get_model(cfg).init_params(cfg, seed=0, device=device)
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
        batch = {"tokens": tokens.to(device),
                 "labels": torch.roll(tokens, -1, 1).to(device)}
        loss, _, grads = make_grad_step(cfg, device=device)(params, batch)
        params, _, m = adamw_update(
            AdamWConfig(), grads, adamw_init(params), params
        )
        print(f"  {arch:16s} [{cfg.family}] loss={float(loss):.3f} "
              f"gnorm={float(m['grad_norm']):.2f}")
    print()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' for the plain path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    emit.reset_launch_counts()
    stencil_demo(device)
    diffusion_demo(device)
    lm_demo(device)
    print(f"fused-stencil launches: {emit.fused_stencil_swc.launches} "
          f"{dict(emit.fused_stencil_swc.launches_by_kernel)}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
