"""Bounds, coverage, uninit and φ proofs for every plan the port can
launch (the port's counterpart of ``repro.analysis.bounds``).

:func:`audit_plan` proves six obligations for one
:class:`~repro_torch.kernels.plan.StencilPlan`:

* **placement** — the padded extent is the interior plus 2r·S per axis,
  and the tiles (depth 1), chunks and segments (``swc_stream``) or
  columns and segments (the walks) cover the interior once;
* **bounds** — every global read lies in the input, by the granule rule
  for 16-byte copies, and every shared read inside its slot's window
  (:mod:`repro_torch.analysis.bodies` mirrors each CUDA body);
* **coverage** — the stores of a step, chunk or sweep cover it exactly
  once, members and segments included, and the persistent walks take
  every item once for any grid;
* **uninit** — every read is of landed data, and no copy into a slot is
  issued before the barrier that follows its read;
* **phi** — each sweep's extent is τ + 2r·(S-1-s), and the aux carry
  matches it;
* the **measured shared bytes**, which :mod:`repro_torch.analysis.smem`
  holds to the planner's.

:func:`audit_launch` does the same for B6 and B7 launches, which have no
StencilPlan.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.analysis import bodies
from repro_torch.analysis.findings import AuditError, Finding


@dataclasses.dataclass
class PlanAudit:
    """One audited plan or launch: its findings, the body it runs, the
    shared bytes the mirror measured and the body's layout fields."""

    sid: str
    body: str
    findings: list[Finding]
    measured_smem: int | None
    layout: dict[str, int] = dataclasses.field(default_factory=dict)
    classes: int = 0


def plan_label(plan) -> str:
    """The strategy id and the launch: tile, interior, dtype, slots."""
    return (f"{plan.strategy_id}[{'x'.join(map(str, plan.block))} on "
            f"{'x'.join(map(str, plan.interior))} {plan.dtype}"
            + (f" n_f{plan.n_f} slots{plan.n_slots}" if plan.n_slots > 1
               else "")
            + (f" seg{plan.segments}" if plan.segments > 1 else "") + "]")


def _placement(plan) -> None:
    S = plan.fuse_steps
    if plan.halo != tuple(r * S for r in plan.radii):
        raise AuditError("bounds", f"halo {plan.halo} is not the radii "
                         f"{plan.radii} times the depth {S}")
    steps = list(plan.block)
    if plan.walk or plan.stream_axis is not None:
        steps[0] = plan.interior[0] // plan.segments
        if plan.interior[0] % plan.segments:
            raise AuditError("coverage", f"{plan.segments} segments do not "
                             f"cut axis 0 of {plan.interior[0]}")
        if plan.stream_axis is not None and not plan.walk and (
                steps[0] % plan.block[0]):
            raise AuditError("coverage", f"chunks of {plan.block[0]} do not "
                             f"fill a segment of {steps[0]}")
    else:
        steps[-1] = plan.x_step * plan.tiles_per_step
    for a, (n, t) in enumerate(zip(plan.interior, steps)):
        if t < 1 or n % t:
            raise AuditError("coverage", f"axis {a}: steps of {t} do not "
                             f"cover the interior {n} once")


def audit_plan(plan, ops) -> PlanAudit:
    """Prove the obligations for one plan against the body it launches."""
    label = plan_label(plan)
    body = bodies.body_of(plan)
    try:
        _placement(plan)
        run = bodies.run_body(plan, ops)
    except AuditError as e:
        return PlanAudit(label, body, [Finding(e.cls, label, e.detail)],
                         None)
    return PlanAudit(label, run.body, [], run.measured, run.layout,
                     run.classes)


def audit_launch(launch: Any) -> PlanAudit:
    """The obligations for a B6 (:class:`bodies.XcorrLaunch`) or B7
    (:class:`bodies.Conv1dLaunch`) launch."""
    fn = (bodies.xcorr1d if isinstance(launch, bodies.XcorrLaunch)
          else bodies.conv1d_depthwise)
    try:
        run = fn(launch)
    except AuditError as e:
        return PlanAudit(launch.label, fn.__name__,
                         [Finding(e.cls, launch.label, e.detail)], None)
    return PlanAudit(launch.label, run.body, [], run.measured, run.layout,
                     run.classes)
