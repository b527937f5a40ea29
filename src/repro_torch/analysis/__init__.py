"""The port's static plan auditor (counterpart of ``repro.analysis``):
machine-checkable proofs about every plan the planner and the tuner can
make, against the geometry of the CUDA bodies, with no kernel run.

* :mod:`~repro_torch.analysis.bodies` mirrors each CUDA body (swc,
  stream ring and one-buffer, the column walks, tc and its walk, the
  one-tile temporal body, B6, B7) and drives its copies, reads, ring
  protocol and stores through :mod:`~repro_torch.analysis.shadow`;
* :mod:`~repro_torch.analysis.bounds` proves placement, bounds,
  coverage, uninit and φ for a plan; :mod:`~repro_torch.analysis.smem`
  holds the measured shared bytes to the planner's;
  :mod:`~repro_torch.analysis.keys` proves the tuning keys injective and
  ``plan_from_record`` a left inverse;
* :mod:`~repro_torch.analysis.mutants` seeds one defect per class and
  checks each is caught.

``python -m repro_torch.analysis`` audits the registry
(``tuning.shapes.AUDIT_SHAPES``) and the tuner's candidate spaces;
``--mutants`` runs the harness.
"""
from repro_torch.analysis.bounds import PlanAudit, audit_launch, audit_plan
from repro_torch.analysis.driver import run_audit, run_mutants
from repro_torch.analysis.findings import CLASSES, AuditError, Finding
from repro_torch.analysis.keys import (
    audit_key_uniqueness,
    audit_record_roundtrip,
    audit_sid_injectivity,
    parse_sid,
)
from repro_torch.analysis.smem import check_smem, model_smem

__all__ = [
    "AuditError",
    "CLASSES",
    "Finding",
    "PlanAudit",
    "audit_key_uniqueness",
    "audit_launch",
    "audit_plan",
    "audit_record_roundtrip",
    "audit_sid_injectivity",
    "check_smem",
    "model_smem",
    "parse_sid",
    "run_audit",
    "run_mutants",
]
