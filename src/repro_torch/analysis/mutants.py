"""Mutation harness: each defect class the auditor claims to catch, caught
(the port's counterpart of ``repro.analysis.mutants``).

An auditor that has never seen a bug cannot be told from one that cannot
see bugs. Each entry of :func:`mutants` replaces one piece of the
geometry the CUDA bodies run (a ``kernels/plan.py`` mirror or a hook of
:mod:`repro_torch.analysis.bodies`, both resolved at call time) with a
copy holding one seeded defect, audits a small fixed set of plans, and
checks that a finding of the expected class appears. The eight mutants of
the reference, on the port's mirrors, and three for Hopper:

* halo-slice-overrun — a tap one element past the window;
* stream-prologue-short — the ring's first fetch brings h0 leading planes
  instead of 2h0;
* stream-carry-skew — the ring slot of a plane off by one;
* temporal-margin-skew — the walk's sweeps before the last one margin too
  narrow;
* unroll-store-gap — the last output of a thread's round never stored;
* smem-model-legacy — the planner's shared bytes without the tap table;
* sid-drops-batch — the strategy id without its ``:b{B}`` suffix;
* record-drops-unroll — ``plan_from_record`` ignoring the record's unroll;
* pitch-not-congruent — a buffer pitch not congruent to the input's
  modulo 16 bytes;
* ring-fetch-ahead — a ring issuing ``n_buf`` units ahead instead of
  ``n_buf - 1``;
* walk-stride-short — a persistent walk advancing by ``grid - 1``.

Every patch is restored on exit. ``python -m repro_torch.analysis
--mutants`` runs :func:`run_harness`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterator

import numpy as np

from repro_torch.analysis import bodies
from repro_torch.analysis.bounds import audit_plan
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.keys import (
    audit_record_roundtrip,
    audit_sid_injectivity,
)
from repro_torch.analysis.smem import check_smem, model_smem
from repro_torch.kernels import plan as plan_mod


@contextlib.contextmanager
def _patched(module: Any, attr: str, value: Any) -> Iterator[None]:
    saved = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, saved)


def fixture_plans() -> dict[str, Any]:
    """Small fixed plans, one per body the mutants hit: depth-1 swc (a
    padded row of 66 elements, 2 mod 4), swc unrolled, the stream ring,
    the column walk and depth-1 tc."""
    from repro_torch.core.stencil import derivative_operator_set
    from repro_torch.kernels.ops import plan_for_nd

    ops2 = derivative_operator_set(2, accuracy=2)
    ops3 = derivative_operator_set(3, accuracy=2)
    return {
        "ops2": ops2,
        "ops3": ops3,
        "swc": (plan_for_nd(ops3, (1, 18, 18, 66), 1), ops3),
        "unrolled": (plan_for_nd(ops2, (2, 10, 258), 2, block=(8, 128),
                                 unroll=2), ops2),
        "stream": (plan_for_nd(ops2, (2, 66, 258), 2,
                               strategy="swc_stream"), ops2),
        "temporal": (plan_for_nd(ops2, (2, 68, 260), 2, fuse_steps=2),
                     ops2),
        "tc": (plan_for_nd(ops3, (1, 18, 18, 66), 1, strategy="tc"), ops3),
    }


def _audit(fix: dict, *which: str) -> list[Finding]:
    out: list[Finding] = []
    for w in which:
        plan, ops = fix[w]
        res = audit_plan(plan, ops)
        out += res.findings + check_smem(res.sid, res.measured_smem,
                                         model_smem(plan))
    return out


# --- the seeded defects ------------------------------------------------------


def _taps_overrun(ops, rank, lift_y=False):
    offs = bodies._tap_offsets(ops, rank, lift_y).copy()
    i = int(np.argmax(offs[:, 2]))
    offs[i, 2] += 1  # the widest x tap one element further
    return offs


def _schedule_short(plan):
    events = list(_REAL["stream_schedule"](plan))
    lead = plan.stream_ring.lead
    for n, ev in enumerate(events):
        if ev[0] == "fetch" and ev[1] == 0:
            keep = len(ev[2]) - lead // 2  # h0 leading planes, not 2 h0
            events[n] = ("fetch", 0, ev[2][:keep])
            break
    return events


def _slot_skew(c, d, per):
    return (c + d + 1) % per


def _walk_ring_skewed(block, radii, padded, n_f, stages, fuse_steps, dtype,
                      n_aux=0):
    ring = _REAL["walk_ring"](block, radii, padded, n_f, stages, fuse_steps,
                              dtype, n_aux)
    _, ry, rx = plan_mod._stream3(radii, 0)
    regions = tuple(
        (y - 2 * ry, x - 2 * rx) if s < fuse_steps - 1 else (y, x)
        for s, (y, x) in enumerate(ring.regions))
    return dataclasses.replace(ring, regions=regions)


def _store_gap(u):
    return range(max(u - 1, 0))


def _swc_smem_legacy(step, stages, *, n_taps, n_ops, n_slots, n_f,
                     itemsize):
    total = stages * step.buffer_bytes + (n_ops + 1) * 4  # no tap table
    if n_slots > 1:
        total = plan_mod._round16(total) + n_slots * n_f * step.points \
            * itemsize
    return total


def _sid_no_batch(strategy, rank, unroll=1, fuse_steps=1, batch=1,
                  accuracy=0, n_aux=0):
    return _REAL["strategy_sid"](strategy, rank, unroll, fuse_steps, 1,
                                 accuracy, n_aux)


def _record_no_unroll(ops, shape, n_out, record, **kw):
    return _REAL["plan_from_record"](
        ops, shape, n_out, dataclasses.replace(record, unroll=1), **kw)


def _not_congruent(n, m, v):
    return n  # the pitch as wide as the row needs, whatever its residue


def _ahead_full(n_buf):
    return n_buf


def _stride_short(nx, ny, nz, grid):
    return grid - 1


_REAL: dict[str, Callable] = {}


@dataclasses.dataclass(frozen=True)
class Mutant:
    name: str
    description: str
    expected: frozenset[str]
    module: Any
    attr: str
    value: Callable
    audit: Callable[[dict], list[Finding]]


def mutants() -> tuple[Mutant, ...]:
    return (
        Mutant("halo-slice-overrun", "a tap one element past the window",
               frozenset({"bounds"}), bodies, "tap_offsets", _taps_overrun,
               lambda fix: _audit(fix, "swc")),
        Mutant("stream-prologue-short", "the ring's first fetch brings h0 "
               "leading planes instead of 2 h0", frozenset({"uninit"}),
               plan_mod, "stream_schedule", _schedule_short,
               lambda fix: _audit(fix, "stream")),
        Mutant("stream-carry-skew", "the ring slot of a plane off by one",
               frozenset({"bounds"}), bodies, "ring_slot", _slot_skew,
               lambda fix: _audit(fix, "stream")),
        Mutant("temporal-margin-skew", "sweeps before the last evaluated "
               "one margin too narrow", frozenset({"phi", "bounds"}),
               plan_mod, "walk_ring", _walk_ring_skewed,
               lambda fix: _audit(fix, "temporal")),
        Mutant("unroll-store-gap", "the last output of a thread's round "
               "never stored", frozenset({"coverage"}), bodies,
               "thread_outputs", _store_gap,
               lambda fix: _audit(fix, "swc", "unrolled")),
        Mutant("smem-model-legacy", "the planner's shared bytes without "
               "the tap table", frozenset({"smem"}), plan_mod,
               "swc_smem_bytes", _swc_smem_legacy,
               lambda fix: _audit(fix, "swc")),
        Mutant("sid-drops-batch", "the strategy id omits the :b{B} "
               "ensemble suffix", frozenset({"key"}), plan_mod,
               "strategy_sid", _sid_no_batch,
               lambda fix: audit_sid_injectivity()[0]),
        Mutant("record-drops-unroll", "plan_from_record ignores the "
               "persisted unroll", frozenset({"key"}), plan_mod,
               "plan_from_record", _record_no_unroll,
               lambda fix: audit_record_roundtrip(*fix["unrolled"])),
        Mutant("pitch-not-congruent", "a buffer pitch not congruent to the "
               "input's modulo 16 bytes", frozenset({"bounds"}), plan_mod,
               "_congruent_up", _not_congruent,
               lambda fix: _audit(fix, "swc")),
        Mutant("ring-fetch-ahead", "a ring issues n_buf units ahead "
               "instead of n_buf - 1", frozenset({"uninit"}), bodies,
               "ring_ahead", _ahead_full,
               lambda fix: _audit(fix, "swc", "tc")),
        Mutant("walk-stride-short", "a persistent walk advances by "
               "grid - 1", frozenset({"coverage"}), bodies,
               "walker_advance", _stride_short,
               lambda fix: _audit(fix, "swc", "temporal")),
    )


def run_harness() -> dict[str, dict[str, Any]]:
    """Audit the clean fixtures (they must be finding-free: a noisy
    auditor detects everything vacuously), then each mutant. Returns
    ``{name: {detected, expected, classes, description}}``."""
    _REAL.update(stream_schedule=plan_mod.stream_schedule,
                 walk_ring=plan_mod.walk_ring,
                 strategy_sid=plan_mod.strategy_sid,
                 plan_from_record=plan_mod.plan_from_record)
    fix = fixture_plans()
    clean = _audit(fix, "swc", "unrolled", "stream", "temporal", "tc")
    clean += audit_sid_injectivity()[0]
    clean += audit_record_roundtrip(*fix["unrolled"])
    results = {"__clean__": {
        "detected": not clean, "expected": [],
        "classes": sorted({f.cls for f in clean}),
        "description": "the fixture plans audit clean before any mutation",
    }}
    for m in mutants():
        with _patched(m.module, m.attr, m.value):
            found = m.audit(fix)
        classes = {f.cls for f in found}
        results[m.name] = {
            "detected": bool(classes & m.expected),
            "expected": sorted(m.expected),
            "classes": sorted(classes),
            "description": m.description,
        }
    return results
