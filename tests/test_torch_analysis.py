"""The port's static plan auditor (``repro_torch.analysis``) against the
JAX package's (``repro.analysis``) on the CPU, and against its own mutants.

The keys: the port's ``strategy_sid`` is proved injective over the same
axis product as the reference's, with the same sids, and the two
``parse_sid`` agree on every one. The registry: the reference's eight
``AUDIT_SHAPES`` entries keep their names and smoke extents, and at those
extents both packages' plans agree on interior, halo and padded extents.
The audit: every registry plan is finding-free and measures the shared
bytes ``StencilPlan.smem_bytes`` asks for; every mutant is caught with its
expected class and every class fires. The existing mirror tests of the
bodies (``test_torch_swc.py``, ``test_torch_stream_ring.py``,
``test_torch_temporal_walk.py``, ``test_torch_tc_walk.py``) also hold
``audit_plan`` finding-free on their own plans.
"""
import dataclasses

import numpy as np
import pytest

from repro.analysis import keys as rkeys
from repro.kernels import plan as rplan
from repro.tuning.shapes import AUDIT_SHAPES as REF_SHAPES
from repro_torch.analysis import (
    CLASSES,
    audit_plan,
    audit_sid_injectivity,
    parse_sid,
    run_audit,
)
from repro_torch.analysis import bodies, shadow
from repro_torch.analysis.findings import AuditError
from repro_torch.analysis.mutants import mutants, run_harness
from repro_torch.core import stencil as ts
from repro_torch.kernels import plan as tplan
from repro_torch.kernels.ops import plan_for_nd
from repro_torch.tuning.shapes import AUDIT_SHAPES


def _ref_sids() -> set[str]:
    return {rplan.strategy_sid(*c) for c in rkeys.enumerate_combos()}


def test_sid_injectivity_covers_the_references_axis_product():
    """Same combos, same sids, no finding; the two grammars agree."""
    findings, n, sids = audit_sid_injectivity()
    ref_findings, ref_n = rkeys.audit_sid_injectivity()
    assert findings == [] and ref_findings == []
    assert n == ref_n
    assert sids == _ref_sids()
    for sid in sorted(sids):
        assert parse_sid(sid) == rkeys.parse_sid(sid), sid


@pytest.mark.parametrize("name", [e.name for e in REF_SHAPES])
def test_shared_audit_shapes_agree_with_the_reference(name):
    """The reference's entries keep their smoke extents, and each plan
    both packages build there has the same interior, halo and padded
    extents (the port's tiles are its own)."""
    ref = next(e for e in REF_SHAPES if e.name == name)
    port = next(e for e in AUDIT_SHAPES if e.name == name)
    assert (port.ndim, port.accuracy, port.smoke) == (ref.ndim, ref.accuracy,
                                                      ref.smoke)
    ref_plans = {(p.strategy, p.fuse_steps, p.unroll, p.batch): p
                 for p, _ in ref.plans(ref.smoke)}
    seen = 0
    for kind, plan, _ in port.plans(port.smoke):
        if kind != "plan":
            continue
        key = (plan.strategy, plan.fuse_steps, plan.unroll, plan.batch)
        if key not in ref_plans:
            continue
        r = ref_plans[key]
        assert plan.interior == r.interior, key
        assert plan.halo == tuple(r.halo), key
        assert tuple(n + 2 * h for n, h in zip(plan.interior, plan.halo)) \
            == tuple(n + 2 * h for n, h in zip(r.interior, r.halo)), key
        seen += 1
    assert seen >= 1


def test_registry_audits_clean_with_the_planners_bytes():
    """Every registry plan at its smoke extents: no finding, and the
    mirror's shared bytes are the planner's, byte for byte."""
    report = run_audit(full=False, enumerate_candidates=False)
    assert report["findings"] == []
    aud = report["_auditor"]
    plans = aud.plans()
    assert len(plans) > 100
    for plan in plans:
        assert aud.results[plan].measured_smem == plan.smem_bytes, plan
    assert set(report["bodies"]) == {
        "swc_body", "stream_body", "stream_buffer", "temporal_walk_body",
        "tc_walk_body", "tc_body", "temporal_body", "xcorr1d",
        "conv1d_depthwise"}
    assert set(report["not_ported"]) <= {"B9"}


def test_every_mutant_is_caught_and_every_class_fires():
    results = run_harness()
    assert results.pop("__clean__")["detected"]
    assert len(results) == 11
    for name, r in results.items():
        assert r["detected"], (name, r)
    fired = set().union(*(set(r["classes"]) & set(r["expected"])
                          for r in results.values()))
    assert fired == set(CLASSES)
    assert {m.name for m in mutants()} == set(results)


# --- the abstract domain ---------------------------------------------------------


def test_boxes_are_strict():
    assert shadow.check_box(((0, 2), (1, 3)), (2, 3), "ok") == ((0, 2),
                                                                (1, 3))
    for box in (((0, 3), (0, 1)), ((-1, 1), (0, 1)), ((1, 1), (0, 1))):
        with pytest.raises(AuditError) as e:
            shadow.check_box(box, (2, 3), "bad")
        assert e.value.cls == "bounds"


def test_slot_tracker_classes():
    """A read before its copy landed or before the barrier is uninit; of
    another plane bounds; a copy into a slot read since the last barrier
    uninit."""
    blk = shadow.Block({"ring": 2})
    blk.copy("ring", 0, "p0")
    blk.commit()
    with pytest.raises(AuditError, match="before its copy") as e:
        blk.read("ring", 0, "p0", "early")
    assert e.value.cls == "uninit"
    blk.wait(0)
    blk.barrier()
    blk.read("ring", 0, "p0", "landed")
    with pytest.raises(AuditError) as e:
        blk.copy("ring", 0, "p2")
    assert e.value.cls == "uninit"
    blk.barrier()
    blk.copy("ring", 0, "p2")
    blk.commit()
    blk.wait(0)
    blk.barrier()
    with pytest.raises(AuditError) as e:
        blk.read("ring", 0, "p0", "stale")
    assert e.value.cls == "bounds"
    with pytest.raises(AuditError) as e:
        blk.read("ring", 1, "p1", "never")
    assert e.value.cls == "uninit"


def test_granule_rule_and_congruence():
    """Rows landing off 16 bytes, rows whose copies meet, and copies past
    the buffer are bounds; a congruent layout passes at either
    alignment."""
    G = 100 * np.arange(4)
    for base in (0, 1):
        s0 = base % 4
        shadow.congruent_rows(G, s0 + 48 * np.arange(4), 40,
                              4, base, 4 * 48 + 8, "ok")
    with pytest.raises(AuditError) as e:  # pitch 47: not congruent
        shadow.congruent_rows(G, 47 * np.arange(4), 40, 4,
                              0, 400, "skew")
    assert e.value.cls == "bounds"
    with pytest.raises(AuditError) as e:  # 11 chunks a row, 40 apart
        shadow.congruent_rows(G + 1, 1 + 40 * np.arange(4), 40, 4,
                              0, 400, "meet")
    assert e.value.cls == "bounds"


def test_persistent_walk_for_every_grid():
    shadow.prove_persistent_walk(37, lambda g: g, "ok", sample=(1, 5, 37))
    with pytest.raises(AuditError) as e:
        shadow.prove_persistent_walk(37, lambda g: max(g - 1, 1), "short")
    assert e.value.cls == "coverage"
    assert bodies.walker_advance(4, 3, 2, 17) == 17


@pytest.mark.parametrize("shape,kw,body", (
    ((16, 20, 40), dict(block=(4, 5, 20)), "swc_body"),
    ((1200,), dict(block=(12,)), "swc_body"),
    ((64, 128), dict(strategy="swc_stream"), "stream_body"),
    ((48, 64), dict(fuse_steps=3), "temporal_walk_body"),
    ((4096,), dict(fuse_steps=2), "temporal_body"),
    ((8, 16, 32), dict(strategy="tc"), "tc_body"),
    ((16, 16, 32), dict(strategy="tc", fuse_steps=2), "tc_walk_body"),
    ((244, 8, 64), dict(block=(4, 4, 32), fuse_steps=2),
     "temporal_walk_body"),
))
def test_odd_tiles_and_slabs_audit_clean(shape, kw, body):
    ops = ts.derivative_operator_set(len(shape), 6)
    fuse = kw.get("fuse_steps", 1)
    padded = (1,) + tuple(n + 6 * fuse for n in shape)
    plan = plan_for_nd(ops, padded, 1, **kw)
    res = audit_plan(plan, ops)
    assert res.findings == [] and res.body == body
    assert res.measured_smem == plan.smem_bytes


def test_segments_and_members_audit_clean():
    ops = ts.derivative_operator_set(3, 2)
    plan = plan_for_nd(ops, (3, 1, 66, 18, 34), 1, strategy="swc_stream")
    for seg in (1, 2, 4):
        res = audit_plan(dataclasses.replace(plan, segments=seg), ops)
        assert res.findings == [], seg
    plan = plan_for_nd(ops, (3, 1, 36, 20, 36), 1, fuse_steps=2)
    for seg in (1, 4):
        assert audit_plan(dataclasses.replace(plan, segments=seg),
                          ops).findings == []


def test_a_ring_too_short_is_caught():
    """A stream ring one plane slot short of its chunks and lead: its
    fetch overwrites a plane the chunk still reads."""
    ops = ts.derivative_operator_set(2, 6)
    plan = plan_for_nd(ops, (1, 70, 134), 1, strategy="swc_stream")
    real = tplan.stream_ring

    def short(*a, **k):
        ring = real(*a, **k)
        return dataclasses.replace(ring, period=ring.period - 4)

    tplan.stream_ring = short
    try:
        res = audit_plan(plan, ops)
    finally:
        tplan.stream_ring = real
    assert {f.cls for f in res.findings} & {"bounds", "uninit"}
