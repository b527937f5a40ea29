"""Seeded, deterministic fault injection — the chaos layer under the
serving failure domains (port of ``repro.ft.faults``, a copy: the port
imports nothing of ``repro``).

The failures the serving path must survive: a batch whose kernel fails
to build or launch, a member whose field blows up to NaN/inf, a batch
that stalls. This module makes each of them *injectable, targeted, and
deterministic*, so the recovery machinery (retry/backoff, the strategy
degradation ladder, batch bisection + quarantine) is tested against the
exact failure it claims to handle.

Design:

* A :class:`FaultSpec` names a **site** (where in the pipeline the
  fault fires), a **kind** (what happens), selectors (which request /
  batch / strategy / candidate it targets), and a ``times`` budget
  (``1`` = transient, ``0`` = persistent). No randomness lives here —
  a spec either matches a context or it doesn't.
* A :class:`FaultInjector` holds the specs, consumes their budgets,
  and logs every firing in :attr:`FaultInjector.fired` so tests can
  assert exactly which faults happened.
* :func:`chaos_specs` derives the reference's standard chaos plan (one
  NaN-poisoned request, one transient compile failure, one slow batch,
  one failing tuning candidate, one corrupted cache file) from a single
  seed via ``random.Random(seed)`` — same seed, same plan, every run.

Sites and kinds:

=================  =========================  ==============================
site               kinds                      fires in
=================  =========================  ==============================
``serve.batch``    compile | oom | slow       ``SimServer`` batch execution
``serve.output``   nan | inf                  post-integrate member output
``tune.candidate`` compile | oom              the tuner's measure loop
``cache.file``     truncate | garbage         the tuner's on-disk cache
=================  =========================  ==============================

The serving side receives the injector explicitly
(``SimServer(faults=...)``). The tuner and its cache are not ported yet
(ROADMAP A9), so the two tuning sites have no caller in the port: the
specs validate and :meth:`FaultInjector.on_candidate` /
:meth:`FaultInjector.corrupt_cache` fire as in the reference, but the
module-level active injector the reference's tuning session consults,
and with it ``serve_sim --chaos``, wait for A9.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import time
from pathlib import Path
from typing import Iterable, Sequence

log = logging.getLogger("repro_torch.ft.faults")

SITES = {
    "serve.batch": ("compile", "oom", "slow"),
    "serve.output": ("nan", "inf"),
    "tune.candidate": ("compile", "oom"),
    "cache.file": ("truncate", "garbage"),
}


class InjectedFault(RuntimeError):
    """Base class for every injected failure (never raised by real
    hardware paths — catching it is always safe in tests)."""

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        self.detail = detail
        super().__init__(f"injected fault at {site}: {detail}")


class InjectedCompileFailure(InjectedFault):
    """Stand-in for a kernel that fails to build or launch."""


class InjectedResourceExhausted(InjectedFault):
    """Stand-in for an allocation or shared-memory launch failure."""


_RAISING = {
    "compile": InjectedCompileFailure,
    "oom": InjectedResourceExhausted,
}


@dataclasses.dataclass
class FaultSpec:
    """One injectable fault: site + kind + selectors + firing budget.

    Selectors are conjunctive — a ``None`` selector matches anything,
    so ``FaultSpec("serve.batch", "compile", req_id=3)`` fires on every
    batch containing request 3 (any index, any strategy), while adding
    ``strategy="swc"`` restricts it to ``swc`` launches (the
    degradation-ladder trigger shape).

    ``times`` bounds how often the spec fires: ``1`` models a transient
    (a retry succeeds), ``0`` a persistent fault (every matching
    context fires — the poison-request shape).
    """

    site: str
    kind: str
    req_id: int | None = None  # fires when this request is in the batch
    index: int | None = None  # fires on this batch index
    strategy: str | None = None  # fires only under this strategy
    label: str | None = None  # candidate-label substring ("*" = any)
    times: int = 1  # firing budget; 0 = unlimited
    fired: int = 0  # consumed budget (mutated by the injector)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.kind not in SITES[self.site]:
            raise ValueError(
                f"fault kind {self.kind!r} invalid for site {self.site!r}"
                f" (expected one of {SITES[self.site]})"
            )

    def exhausted(self) -> bool:
        return self.times > 0 and self.fired >= self.times

    def matches(
        self,
        *,
        req_ids: Sequence[int] = (),
        index: int | None = None,
        strategy: str | None = None,
        label: str | None = None,
    ) -> bool:
        if self.req_id is not None and self.req_id not in req_ids:
            return False
        if self.index is not None and self.index != index:
            return False
        if self.strategy is not None and self.strategy != strategy:
            return False
        if self.label is not None and self.label != "*":
            if label is None or self.label not in label:
                return False
        return True


class FaultInjector:
    """Deterministic fault scheduler over a list of :class:`FaultSpec`.

    The injector is pure bookkeeping: it never decides randomly whether
    to fire (determinism comes from the specs; seeding happens once, in
    :func:`chaos_specs`). Every firing is appended to :attr:`fired` as
    ``(site, kind, detail)`` so callers can assert the exact fault
    sequence after the fact.
    """

    def __init__(
        self, specs: Iterable[FaultSpec] = (), *, slow_s: float = 0.25
    ):
        self.specs = list(specs)
        self.slow_s = slow_s  # injected stall for "slow" batch faults
        self.fired: list[tuple[str, str, str]] = []

    def _take(self, site: str, detail: str, **ctx) -> FaultSpec | None:
        """First non-exhausted spec matching ``ctx`` at ``site`` —
        consumes one unit of its budget and logs the firing."""
        for spec in self.specs:
            if spec.site != site or spec.exhausted():
                continue
            if not spec.matches(**ctx):
                continue
            spec.fired += 1
            self.fired.append((site, spec.kind, detail))
            log.warning("injected %s fault at %s (%s)", spec.kind, site,
                        detail)
            return spec
        return None

    # -- serving hooks ------------------------------------------------------

    def on_batch(self, index: int, req_ids: Sequence[int], strategy: str):
        """Fires inside a batch execution: raise (compile/oom) or stall
        (slow). Called by ``SimServer`` in the per-batch try block."""
        spec = self._take(
            "serve.batch",
            f"index={index} reqs={list(req_ids)} strategy={strategy}",
            req_ids=req_ids, index=index, strategy=strategy,
        )
        if spec is None:
            return
        if spec.kind == "slow":
            time.sleep(self.slow_s)
            return
        raise _RAISING[spec.kind](
            "serve.batch", f"batch {index} under {strategy}"
        )

    def corrupt_output(self, req_ids: Sequence[int], out):
        """Poison matching members of a (B, ...) output stack with
        NaN/inf on its device — the injected analogue of a member whose
        field blew up inside the kernel. Returns ``out`` (cloned when
        modified)."""
        poisoned = out
        for member, rid in enumerate(req_ids):
            spec = self._take(
                "serve.output", f"req={rid}", req_ids=(rid,)
            )
            if spec is None:
                continue
            if poisoned is out:
                poisoned = out.clone()
            poisoned[member] = (
                float("nan") if spec.kind == "nan" else float("inf")
            )
        return poisoned

    # -- tuning hooks -------------------------------------------------------

    def on_candidate(self, label: str):
        """Fires inside the per-candidate measurement: raise a compile
        or resource-exhausted failure for a matching candidate label."""
        spec = self._take(
            "tune.candidate", f"candidate={label}", label=label
        )
        if spec is not None:
            raise _RAISING[spec.kind](
                "tune.candidate", f"candidate {label}"
            )

    # -- cache hooks --------------------------------------------------------

    def corrupt_cache(self, path) -> bool:
        """Corrupt an on-disk cache file in place (truncate to half, or
        overwrite with non-JSON garbage). Returns True if a fault
        fired. The file is created if missing — a garbage file where a
        cache is expected is exactly the crash-mid-write shape."""
        path = Path(path)
        spec = self._take("cache.file", f"path={path}")
        if spec is None:
            return False
        if spec.kind == "truncate":
            data = path.read_bytes() if path.exists() else b'{"records'
            path.write_bytes(data[: max(1, len(data) // 2)])
        else:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text("{garbage: definitely, not json\x00")
        return True


# ---------------------------------------------------------------------------
# The standard seeded chaos plan.
# ---------------------------------------------------------------------------


def chaos_specs(
    seed: int, req_ids: Sequence[int]
) -> tuple[list[FaultSpec], dict]:
    """The chaos-smoke fault plan, derived deterministically from
    ``seed``: one persistent NaN-poisoned request, one transient
    compile failure (its batch recovers on retry), one slow batch, one
    failing tuning candidate, and one garbled ``cache.json``.

    Returns ``(specs, plan)`` where ``plan`` names the chosen targets
    so the caller can assert exact quarantine/retry attribution.
    """
    ids = sorted(int(r) for r in req_ids)
    if not ids:
        raise ValueError("chaos_specs needs at least one request id")
    rng = random.Random(seed)
    poison = ids[rng.randrange(len(ids))]
    others = [r for r in ids if r != poison] or [poison]
    transient = others[rng.randrange(len(others))]
    slow_index = rng.randrange(2, 5)
    specs = [
        FaultSpec("serve.output", "nan", req_id=poison, times=0),
        FaultSpec("serve.batch", "compile", req_id=transient, times=1),
        FaultSpec("serve.batch", "slow", index=slow_index, times=1),
        FaultSpec("tune.candidate", "compile", label="*", times=1),
        FaultSpec("cache.file", "garbage", times=1),
    ]
    plan = {
        "seed": seed,
        "poison": poison,
        "transient": transient,
        "slow_index": slow_index,
    }
    return specs, plan
