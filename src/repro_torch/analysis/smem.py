"""Shared-memory fidelity: the bytes the auditor measures against the
planner's (the port's counterpart of ``repro.analysis.vmem``).

Each body's mirror counts the shared bytes of one block from the buffers
it staged into, the tap table, the operator starts and φ's inputs
(:mod:`repro_torch.analysis.bodies`). :func:`check_smem` holds that to
``StencilPlan.smem_bytes`` (``kernels/plan.py:1621``), the value each
launch passes as its dynamic shared memory and the planner fits against
the 227 KB of ``SMEM_PER_BLOCK`` (``plan.py:307``); for B6 to
``xcorr1d.smem_bytes`` (``kernels/xcorr1d.py:162``). Divergence means the
launch asks for a different layout than the body uses, or the planner
fits a different one. Byte-equal by default: ``tol`` (``--smem-tol``)
is a relative tolerance for deliberate model edits.
"""
from __future__ import annotations

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import plan as plan_mod


def model_smem(plan) -> int:
    """The planner's shared bytes for ``plan`` (resolved through the
    module at call time, so the mutation harness's seeded defects run)."""
    return int(plan.smem_bytes)


def model_smem_launch(launch) -> int:
    """B6's ``xcorr1d.smem_bytes`` for a launch (B7 uses none)."""
    from repro_torch.analysis.bodies import XcorrLaunch
    from repro_torch.kernels import xcorr1d as kx

    if isinstance(launch, XcorrLaunch):
        return int(kx.smem_bytes(launch.n_taps, launch.block_size,
                                 launch.dtype, launch.strategy,
                                 launch.unroll))
    return 0


def check_smem(label: str, measured: int | None, model: int, *,
               tol: float = 0.0) -> list[Finding]:
    """A ``smem`` finding if the measured bytes and the model's differ
    beyond ``tol`` (relative), or either exceeds a block's limit."""
    if measured is None:
        return []  # the bounds audit aborted; its finding reports
    out = []
    if abs(measured - model) > tol * max(measured, model):
        out.append(Finding("smem", label, f"the body stages {measured} B, "
                           f"the planner asks for {model} B (tol {tol:g})"))
    if max(measured, model) > plan_mod.SMEM_PER_BLOCK:
        out.append(Finding("smem", label, f"{max(measured, model)} B over the "
                           f"{plan_mod.SMEM_PER_BLOCK} B a block can use"))
    return out
