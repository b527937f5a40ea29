"""Tuning-key injectivity and ``plan_from_record`` round trips (the port's
copy of ``repro.analysis.keys``).

Four checks, each by exhaustive enumeration:

1. **sid injectivity** — ``plan.strategy_sid`` (``kernels/plan.py:97``)
   is injective over the reference's axis product (strategy × rank ×
   unroll × fuse × batch × accuracy × n_aux) modulo its one documented
   alias: accuracy 0 ("unknown") and ``DEFAULT_ACCURACY`` both key
   unmarked; rank joins the key through the kernel name except on
   ``swc_stream``, whose stream letter must tell the ranks apart.
2. **sid parsability** — the suffix grammar parses every sid back to its
   axes.
3. **key uniqueness** — no two audited plans that differ in identity
   share a TuningKey (the block aside: it is the tuned value).
4. **record left-inverse** — ``plan_from_record`` (``plan.py:1905``)
   rebuilds every audited plan exactly from the record the tuner would
   persist for it: a warm cache hit launches the kernel that was timed.
"""
from __future__ import annotations

import itertools
import re
from typing import Any, Iterator

from repro_torch.analysis.findings import Finding
# Resolved through the module at call time, so the mutation harness's
# seeded key defects are what runs.
from repro_torch.kernels import plan as plan_mod

# The reference's axis values (repro/analysis/keys.py), over-approximating
# what any registry uses.
_STRATEGIES = ("swc", "swc_stream", "tc", "auto")
_RANKS = (1, 2, 3)
_UNROLLS = (1, 2, 4)
_FUSES: tuple[Any, ...] = (1, 2, 3, "auto")
_BATCHES = (1, 2, 4)
_ACCURACIES = (0, 2, 4, 6, 8)
_AUXES = (0, 1, 2)

Combo = tuple[str, int, int, Any, int, int, int]
# (strategy, rank, unroll, fuse, batch, accuracy, n_aux)


def _valid(c: Combo) -> bool:
    """The plan layer's constraints on the axis product, restated (the
    reference's, kept independent of ``StencilPlan.__post_init__``)."""
    strategy, rank, unroll, fuse, batch, _acc, n_aux = c
    if strategy == "swc_stream" and (rank == 1 or n_aux or unroll != 1):
        return False
    if strategy in ("tc", "auto") and unroll != 1:
        return False
    if unroll != 1 and fuse != 1:
        return False
    if batch != 1 and n_aux and fuse != 1:
        return False
    return True


def enumerate_combos() -> Iterator[Combo]:
    for c in itertools.product(_STRATEGIES, _RANKS, _UNROLLS, _FUSES,
                               _BATCHES, _ACCURACIES, _AUXES):
        if _valid(c):
            yield c


_SID_RE = re.compile(
    r"^(?P<strategy>swc_stream|swc|tc|auto)"
    r"(?::s(?P<stream>auto|[zyx]))?"
    r"(?::u(?P<unroll>\d+))?"
    r"(?::f(?P<fuse>auto|\d+))?"
    r"(?::b(?P<batch>\d+))?"
    r"(?::a(?P<aux>\d+))?"
    r"(?::o(?P<acc>\d+))?$"
)


def parse_sid(sid: str) -> dict[str, Any] | None:
    """A strategy id's axes by the suffix grammar; ``None`` if it does not
    match (a grammar break)."""
    m = _SID_RE.match(sid)
    if m is None:
        return None
    fuse = m["fuse"]
    return {
        "strategy": m["strategy"],
        "stream": m["stream"],
        "unroll": int(m["unroll"] or 1),
        "fuse": fuse if fuse == "auto" else int(fuse or 1),
        "batch": int(m["batch"] or 1),
        "n_aux": int(m["aux"] or 0),
        "accuracy": int(m["acc"]) if m["acc"] is not None else None,
    }


def _alias_ok(a: Combo, b: Combo) -> bool:
    sa, ra, ua, fa, ba, aa, xa = a
    sb, rb, ub, fb, bb, ab, xb = b
    if (sa, ua, fa, ba, xa) != (sb, ub, fb, bb, xb):
        return False
    if sa == "swc_stream" and ra != rb:
        return False
    return aa == ab or {aa, ab} == {0, plan_mod.DEFAULT_ACCURACY}


def audit_sid_injectivity() -> tuple[list[Finding], int, set[str]]:
    """Checks 1 and 2 over the axis product: (findings, combos checked,
    the sids)."""
    findings: list[Finding] = []
    by_sid: dict[str, list[Combo]] = {}
    n = 0
    for c in enumerate_combos():
        strategy, rank, unroll, fuse, batch, acc, n_aux = c
        sid = plan_mod.strategy_sid(strategy, rank, unroll, fuse, batch, acc,
                                    n_aux)
        n += 1
        by_sid.setdefault(sid, []).append(c)
        parsed = parse_sid(sid)
        if parsed is None:
            findings.append(Finding("key", sid, "sid does not match the "
                                    f"suffix grammar (combo {c})"))
            continue
        stream = ({2: "y", 3: "z"}[rank] if strategy == "swc_stream"
                  else "auto" if strategy == "auto" else None)
        default = acc in (0, plan_mod.DEFAULT_ACCURACY)
        ok = (parsed["strategy"] == strategy and parsed["stream"] == stream
              and parsed["unroll"] == unroll and parsed["fuse"] == fuse
              and parsed["batch"] == batch and parsed["n_aux"] == n_aux
              and (parsed["accuracy"] is None if default
                   else parsed["accuracy"] == acc))
        if not ok:
            findings.append(Finding("key", sid, f"sid parse {parsed} does not "
                                    f"round-trip combo {c}"))
    for sid, combos in by_sid.items():
        for a, b in itertools.combinations(combos, 2):
            if not _alias_ok(a, b):
                findings.append(Finding(
                    "key", sid, f"sid collision: combos {a} and {b} share "
                    "the id beyond the documented accuracy alias"))
                break
    return findings, n, set(by_sid)


def _identity(plan) -> tuple:
    """All of a plan's identity but the block, accuracy through the
    alias."""
    acc = (plan_mod.DEFAULT_ACCURACY
           if plan.accuracy in (0, plan_mod.DEFAULT_ACCURACY)
           else plan.accuracy)
    return (plan.rank, plan.strategy, plan.radii, plan.interior, plan.n_f,
            plan.n_out, plan.dtype, plan.n_aux, plan.unroll,
            plan.fuse_steps, plan.batch, acc)


def audit_key_uniqueness(plans) -> list[Finding]:
    """No two audited plans of different identity share a TuningKey."""
    findings: list[Finding] = []
    seen: dict[Any, tuple] = {}
    for p in plans:
        key = p.tuning_key(backend="audit")
        prev = seen.setdefault(key, _identity(p))
        if prev != _identity(p):
            findings.append(Finding(
                "key", p.strategy_id, f"TuningKey collision: identities "
                f"{prev} and {_identity(p)} share one cache key"))
    return findings


def audit_record_roundtrip(plan, ops) -> list[Finding]:
    """Check 4 for one plan: the record the tuner would persist for its
    decision rebuilds it."""
    from repro_torch.tuning.cache import TuningRecord

    rec = TuningRecord(
        block=plan.block, timings_us={}, source="model",
        fuse_steps=plan.fuse_steps, stream=plan.strategy == "swc_stream",
        strategy_resolved=plan.strategy, unroll=plan.unroll)
    lead = (plan.batch,) if plan.batch > 1 else ()
    back = plan_mod.plan_from_record(
        ops, lead + (plan.n_f,) + plan.interior, plan.n_out, rec,
        dtype=plan.dtype, n_aux=plan.n_aux, max_threads=plan.max_threads,
        n_slots=plan.n_slots)
    if back != plan:
        return [Finding(
            "key", plan.strategy_id, "plan_from_record is not a left "
            f"inverse: rebuilt {back and back.strategy_id} block "
            f"{back and back.block} unroll {back and back.unroll} from the "
            f"decision block {plan.block} unroll {plan.unroll}")]
    return []
