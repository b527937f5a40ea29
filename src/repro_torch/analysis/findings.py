"""Finding records of the port's static plan auditor (the port's copy of
``repro.analysis.findings``).

Every failed proof obligation is a :class:`Finding`: a defect class from
the closed :data:`CLASSES` set, the plan (strategy id and launch) it was
proved against, and a detail string. ``python -m repro_torch.analysis``
reports the list and exits nonzero if any survive; the mutation harness
(:mod:`repro_torch.analysis.mutants`) checks that each class fires on its
seeded defect.
"""
from __future__ import annotations

import dataclasses
from typing import Any

# The closed set of defect classes. "bounds": an access outside the
# staged window, a ring slot or the input, a 16-byte copy that breaks the
# granule rule, or a slot that holds another plane than the one a tap
# names (carry provenance, as the reference treats it); "uninit": a read
# of a slot or buffer whose copy has not landed (committed, waited on and
# followed by a barrier), or a copy into a slot issued before the barrier
# that follows its last read; "smem": the shared bytes the auditor
# measures differ from the planner's (the bytes each launch asks for) or
# exceed a block's limit; "key": a strategy id or tuning-key collision, a
# sid the grammar does not parse back, or a ``plan_from_record`` that does
# not rebuild its plan; "coverage": outputs not stored exactly once; "phi":
# a sweep's extent, or its aux carry, off the schedule τ + 2r·(S-1-s).
CLASSES = ("bounds", "uninit", "smem", "key", "coverage", "phi")


@dataclasses.dataclass(frozen=True)
class Finding:
    cls: str  # one of CLASSES
    plan: str  # strategy id / label of the audited plan
    detail: str

    def __post_init__(self) -> None:
        if self.cls not in CLASSES:
            raise ValueError(f"unknown finding class {self.cls!r}")

    def to_json(self) -> dict[str, Any]:
        return {"cls": self.cls, "plan": self.plan, "detail": self.detail}


class AuditError(Exception):
    """Raised inside a body's mirror when a proof obligation fails; the
    audit turns it into a :class:`Finding` and moves on to the next
    plan."""

    def __init__(self, cls: str, detail: str):
        if cls not in CLASSES:
            raise ValueError(f"unknown finding class {cls!r}")
        super().__init__(f"[{cls}] {detail}")
        self.cls = cls
        self.detail = detail
