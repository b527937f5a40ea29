"""The audit driver: every plan of the registry, of the tuner's candidate
spaces and of a run's launches (the port's counterpart of
``repro.analysis.driver``).

Plan sources, all held to the same obligations:

* the static-audit registry (``repro_torch.tuning.shapes.AUDIT_SHAPES``),
  each entry expanded over its axes and built as the dispatch builds it;
* the tuner's candidate spaces: every non-``hwc`` candidate of
  ``costmodel.enumerate_cross_strategy_nd`` (``tuning/costmodel.py:360``)
  for each fused entry, and every block of ``enumerate_candidates_1d``
  (``:408``) for each B6 entry, so no plan the tuner can pick is
  unproved;
* the plans a run launched (``emit.launched_plans()``,
  ``xcorr1d.launched``, ``conv1d_depthwise.launched``), passed in by
  ``chip_smoke.py`` phase 3 (audit).

A combination the port raises ``NotImplementedError`` for is counted
under the ROADMAP item it names; a planner's ``ValueError`` (a launch
the planner refuses, as the reference's rules allow) is counted as
refused. Neither is a finding. The key obligations run over the union.
The report is a JSON-ready dict; a nonzero exit of ``python -m
repro_torch.analysis`` means a finding survived.
"""
from __future__ import annotations

import collections
import json
import time
from typing import Any, Iterable

from repro_torch.analysis.bounds import PlanAudit, audit_launch, audit_plan
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.keys import (
    audit_key_uniqueness,
    audit_record_roundtrip,
    audit_sid_injectivity,
)
from repro_torch.analysis.smem import (
    check_smem,
    model_smem,
    model_smem_launch,
)


def bf16_item(plan) -> str | None:
    """The ROADMAP item whose bf16 kernel a stencil plan runs: B4b (an
    MHD kind), B3c (``swc_stream``), B2c (``swc`` at depth > 1); None
    for any other plan or launch."""
    if getattr(plan, "dtype", None) != "bfloat16" or not hasattr(
            plan, "n_slots"):
        return None
    if plan.n_slots > 1 or plan.n_aux:
        return "B4b"
    if plan.strategy == "swc_stream":
        return "B3c"
    if plan.strategy == "swc" and plan.fuse_steps > 1:
        return "B2c"
    return None


class Auditor:
    """Audits each distinct plan or launch once, and keeps the results
    (``results[plan] = PlanAudit``) and the counts."""

    def __init__(self, smem_tol: float = 0.0):
        self.smem_tol = smem_tol
        self.results: dict[Any, PlanAudit] = {}
        self.ops: dict[Any, Any] = {}
        self.not_ported: collections.Counter = collections.Counter()
        self.refused: collections.Counter = collections.Counter()

    def plan(self, plan, ops) -> PlanAudit:
        res = self.results.get(plan)
        if res is None:
            res = audit_plan(plan, ops)
            res.findings += check_smem(res.sid, res.measured_smem,
                                       model_smem(plan), tol=self.smem_tol)
            self.results[plan] = res
            self.ops[plan] = ops
        return res

    def launch(self, launch) -> PlanAudit:
        res = self.results.get(launch)
        if res is None:
            res = audit_launch(launch)
            res.findings += check_smem(res.sid, res.measured_smem,
                                       model_smem_launch(launch),
                                       tol=self.smem_tol)
            self.results[launch] = res
        return res

    def findings(self) -> list[Finding]:
        return [f for r in self.results.values() for f in r.findings]

    def plans(self) -> list:
        return [p for p in self.results if p in self.ops]


def _fuse_options(entry) -> tuple[int, ...]:
    return entry.fuse if entry.n_out == entry.n_f + entry.n_aux else (1,)


def _timed(cands: list, top_k: int) -> list:
    """The candidates a session times (``tuning/session.py:174-178``): the
    model's top k and every planner's own tile."""
    return cands[:top_k] + [c for c in cands[top_k:]
                            if getattr(c, "default", False)]


def candidate_plans(entry, domain, timed_only: bool = False
                    ) -> Iterable[tuple]:
    """Every non-``hwc`` candidate of the cross-strategy space of one
    fused entry at ``domain`` (with ``timed_only``, those a session times:
    the only ones it can pick), lowered as ``ops.fused_stencil_nd`` lowers
    a resolved record: ("plan", plan, ops), ("not_ported", ...) or
    ("finding", ...)."""
    from repro_torch.tuning.session import TuningSession

    from repro_torch.kernels.ops import plan_for_nd
    from repro_torch.tuning.costmodel import enumerate_cross_strategy_nd
    from repro_torch.tuning.shapes import PHI_KINDS, not_ported_item

    ops = entry.operator_set()
    radii = ops.radius_per_axis()
    max_threads, n_slots = PHI_KINDS[entry.phi]
    for b in entry.batch:
        try:
            cands = enumerate_cross_strategy_nd(
                ops, domain, entry.n_f, entry.n_out, entry.dtype,
                fuse_steps_options=_fuse_options(entry), batch=b,
                n_aux=entry.n_aux, n_slots=n_slots, max_threads=max_threads,
                backend="audit")
        except NotImplementedError as e:
            yield "not_ported", not_ported_item(e), f"{entry.name}:cand"
            continue
        if timed_only:
            cands = _timed(cands, TuningSession.top_k)
        lead = (b,) if b > 1 else ()
        for c in cands:
            if c.strategy == "hwc":
                continue
            f = c.fuse_steps
            padded = tuple(n + 2 * r * f for n, r in zip(domain, radii))
            aux = None
            if entry.n_aux:
                aux = lead + (entry.n_aux,) + tuple(
                    n + 2 * r * (f - 1) for n, r in zip(domain, radii))
            label = f"{entry.name}:cand:{c.strategy}:f{f}:{c.block}"
            try:
                plan = plan_for_nd(
                    ops, lead + (entry.n_f,) + padded, entry.n_out,
                    aux_shape=aux, strategy=c.strategy, block=c.block,
                    dtype=entry.dtype, fuse_steps=f,
                    max_threads=max_threads, n_slots=n_slots)
            except NotImplementedError as e:
                yield "not_ported", not_ported_item(e), label
                continue
            except ValueError as e:
                # The search ranks only launches the planner accepts: a
                # candidate that does not lower again is a key finding.
                yield "finding", Finding("key", label, "enumerated candidate "
                                         f"does not lower: {e}"), label
                continue
            yield "plan", plan, ops


def candidate_launches(entry, extents, timed_only: bool = False
                       ) -> Iterable:
    """B6's ``block_size`` candidates (``enumerate_candidates_1d``) of one
    entry; with ``timed_only`` the top k and the default 2048."""
    from repro_torch.analysis.bodies import XcorrLaunch
    from repro_torch.tuning.costmodel import enumerate_candidates_1d
    from repro_torch.tuning.session import TuningSession

    (n,) = extents
    for s in entry.strategies:
        for u in entry.unroll:
            cands = enumerate_candidates_1d(n, entry.taps, strategy=s,
                                            unroll=u, dtype=entry.dtype,
                                            backend="audit")
            if timed_only:
                cands = cands[:TuningSession.top_k] + [
                    c for c in cands[TuningSession.top_k:]
                    if c.block == 2048]
            for c in cands:
                yield XcorrLaunch(n, entry.taps, c.block, s, u, entry.dtype)


# The main path's problems whose candidate spaces the full audit also
# enumerates at their full extents (the sizes chip_smoke.py's tuner runs).
FULL_SPACES = ("fig11/diffusion3d_o6", "fig11/diffusion2d",
               "fig11/diffusion1d", "fig13-14/mhd8f", "b6/xcorr1d-r1024-32")


def run_audit(
    *,
    full: bool = False,
    smem_tol: float = 0.0,
    enumerate_candidates: bool = True,
    launched: Iterable[tuple] = (),
    launched_1d: Iterable = (),
    shapes=None,
) -> dict[str, Any]:
    """Run the whole audit; return the report. ``launched`` holds (plan,
    ops) pairs and ``launched_1d`` B6/B7 launches a run made (phase 3
    (audit) of ``chip_smoke.py``). The candidate spaces are enumerated
    whole at the smoke extents (as the reference's: the space only
    shrinks as extents grow past shared memory); with ``full`` also, at
    the full extents of :data:`FULL_SPACES`, the candidates a session
    times there."""
    from repro_torch.tuning.shapes import AUDIT_SHAPES

    t0 = time.perf_counter()
    aud = Auditor(smem_tol)
    extra: list[Finding] = []
    n_reg = n_cand = 0
    reg_keys, cand_keys = set(), set()
    for entry in AUDIT_SHAPES if shapes is None else shapes:
        domain = entry.full if full else entry.smoke
        spaces = [(entry.smoke, False)]
        if full and entry.name in FULL_SPACES:
            spaces.append((entry.full, True))
        if entry.kernel != "fused":
            for kind, *rest in entry.launches(domain):
                if kind == "not_ported":
                    aud.not_ported[rest[0]] += 1
                    continue
                aud.launch(rest[0])
                reg_keys.add(rest[0])
            if enumerate_candidates and entry.kernel == "xcorr1d":
                for ext, timed in spaces:
                    for lc in candidate_launches(entry, ext, timed):
                        aud.launch(lc)
                        cand_keys.add(lc)
            continue
        for kind, obj, ops_or_label in entry.plans(domain):
            if kind == "plan":
                aud.plan(obj, ops_or_label)
                reg_keys.add(obj)
            elif kind == "not_ported":
                aud.not_ported[obj] += 1
            else:
                aud.refused[entry.name] += 1
        for ext, timed in spaces if enumerate_candidates else ():
            for kind, obj, third in candidate_plans(entry, ext, timed):
                if kind == "plan":
                    aud.plan(obj, third)
                    cand_keys.add(obj)
                elif kind == "not_ported":
                    aud.not_ported[obj] += 1
                else:
                    extra.append(obj)
    n_reg, n_cand = len(reg_keys), len(cand_keys)
    launched = list(launched)
    launched_1d = list(launched_1d)
    for plan, ops in launched:
        aud.plan(plan, ops)
    for lc in launched_1d:
        aud.launch(lc)
    unaudited = sum(1 for p, _ in launched if p not in aud.results) + sum(
        1 for lc in launched_1d if lc not in aud.results)

    sid_findings, n_combos, _ = audit_sid_injectivity()
    plans = aud.plans()
    keyf = sid_findings + audit_key_uniqueness(plans)
    # The round trip holds for the plans the planner and the tuner make; a
    # launched plan with its segments forced by hand (chip_smoke.py's
    # segment cases) has no record field to come back from.
    seen = set()
    n_round = 0
    for plan in (p for p in plans if p in reg_keys or p in cand_keys):
        k = (plan.strategy_id, plan.interior, plan.block, plan.dtype,
             plan.n_slots)
        if k in seen:
            continue
        seen.add(k)
        keyf += audit_record_roundtrip(plan, aud.ops[plan])
        n_round += 1
    findings = aud.findings() + extra + keyf
    bodies = collections.Counter(r.body for r in aud.results.values())
    items = collections.Counter(bf16_item(p) for p in aud.results)
    items.pop(None, None)
    return {
        "schema": 1,
        "mode": "full" if full else "smoke",
        "smem_tol": smem_tol,
        "counts": {
            "registry": n_reg,
            "candidates": n_cand,
            "launched": len({p for p, _ in launched}) + len(set(launched_1d)),
            "audited": len(aud.results),
            "unaudited": unaudited,
            "findings": len(findings),
            "classes": sum(r.classes for r in aud.results.values()),
            "sid_combos": n_combos,
            "record_roundtrips": n_round,
        },
        "bodies": dict(sorted(bodies.items())),
        "not_ported": dict(sorted(aud.not_ported.items())),
        "bf16_items": dict(sorted(items.items())),
        "refused": dict(sorted(aud.refused.items())),
        "seconds": round(time.perf_counter() - t0, 3),
        "findings": [f.to_json() for f in findings],
        "_auditor": aud,
    }


def run_mutants() -> dict[str, Any]:
    """The mutation harness's report."""
    from repro_torch.analysis.mutants import run_harness

    results = run_harness()
    return {
        "schema": 1,
        "mode": "mutants",
        "mutants": results,
        "undetected": sorted(n for n, r in results.items()
                             if not r["detected"]),
    }


def write_report(report: dict[str, Any], path: str) -> None:
    with open(path, "w") as fh:
        json.dump({k: v for k, v in report.items() if not k.startswith("_")},
                  fh, indent=2, sort_keys=True)
        fh.write("\n")
