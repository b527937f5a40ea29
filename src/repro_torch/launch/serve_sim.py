"""Ensemble simulation serving on the card (port of
``repro.launch.serve_sim``): the stencil-workload front door.

Thousands of concurrent scenarios (parameter sweeps, Monte-Carlo
ensembles, per-user simulations) funneled through the batched fused
stencil engine:

* ``SimRequest`` / ``RequestQueue`` — FIFO request intake with
  shape-bucketed draining: requests sharing (spatial shape, dtype,
  n_steps) form one plan-compatible group, and the oldest request's
  bucket is served first (head-of-line FIFO, no starvation).
* ``SimServer`` — one ``FusedStencilOp`` per (bucket, strategy), the
  bucket's requests stacked on the server's device to a (B, n_f,
  *spatial) ensemble, so each diffusion step is ONE launch of the
  hand-written kernel for all B members (the member is an outer grid
  index of every kernel, ``StencilPlan.batch``).
* **Failure domains** — one poisoned request must cost one request,
  never the queue. Every batch runs under a :class:`RetryPolicy`:
  transient failures retry with backoff; repeated failures degrade the
  bucket down the strategy ladder (``tc → swc_stream → swc → hwc``,
  rungs whose op does not build for the bucket skipped: ``swc_stream``
  at rank 1). On the card the ladder stops above ``hwc``: the
  plain PyTorch version never stands in for a failing kernel. A batch
  that fails even at the lowest rung it may take is bisected until the
  poison request is isolated and quarantined (its error lands in
  ``SimServer.error_reports``, everyone else completes).
  Outputs are checked for NaN/inf per member before results are handed
  back, and every request carries a status (``ok | retried | degraded |
  quarantined``) in ``BatchReport``.
* ``StragglerMonitor`` (``repro_torch.ft.supervisor``) — per-batch wall
  times feed the trailing-median monitor; a slow batch is flagged in its
  report.
* ``repro_torch.ft.faults`` — the seeded deterministic fault-injection
  layer (``SimServer(faults=...)``); ``--chaos`` drives the standard
  seeded fault plan through a live serve and asserts the recovery
  contract.
* ``block="auto"`` (``--auto-tune``) and ``strategy="auto"`` resolve
  through the tuner (``repro_torch.tuning``): the first batch of each
  bucket runs once before its timed region, so a cache miss measures
  (on the card) and persists a ``:b{B}``-keyed record there, and the
  straggler monitor never sees a tuning batch; later batches replay it.
  ``strategy="tc"`` serves each bucket through the tensor-core kernel,
  one batched launch per step.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_sim --smoke
      (on the card; add ``--device cpu`` for the plain PyTorch path)

``--smoke`` serves a small mixed-shape queue and checks every request
against the per-member plain version (:func:`member_reference`).
``--chaos`` also injects the seeded fault plan (a poison request, a
transient build failure, a slow batch, a failing tuning candidate, a
garbled ``cache.json``) with the tuning cache in a temporary directory.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import logging
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import dtype_name, resolve_device
from repro_torch.core.fusion import FusedStencilOp, integrate
from repro_torch.ft import faults as ftfaults
from repro_torch.ft.faults import FaultInjector
from repro_torch.ft.supervisor import StragglerMonitor
from repro_torch.physics.diffusion import DiffusionProblem

log = logging.getLogger("repro_torch.serve")

# (spatial shape, dtype string, n_steps): requests sharing a key run
# through ONE batched plan (same domain/dtype) for the SAME step count.
BucketKey = tuple[tuple[int, ...], str, int]

# Graceful-degradation order: most specialized caching regime first,
# the plain PyTorch baseline (which always runs) last; ``"auto"``
# re-enters at ``swc`` (``RetryPolicy.degrade``).
DEGRADATION_LADDER = ("tc", "swc_stream", "swc", "hwc")

# The rung that is the plain PyTorch version, not a kernel: skipped on
# the card, where a kernel that fails must not be hidden behind it.
PLAIN_RUNG = "hwc"

# Per-request status severity: a request that was ever quarantined
# stays quarantined; degraded beats retried beats ok.
_SEVERITY = {"ok": 0, "retried": 1, "degraded": 2, "quarantined": 3}


@dataclasses.dataclass(frozen=True)
class SimRequest:
    """One ensemble member: advance ``f0`` (n_f, *spatial) by
    ``n_steps`` diffusion steps."""

    req_id: int
    f0: torch.Tensor
    n_steps: int

    @property
    def bucket_key(self) -> BucketKey:
        return (
            tuple(int(n) for n in self.f0.shape[1:]),
            dtype_name(self.f0.dtype),
            int(self.n_steps),
        )


class RequestQueue:
    """FIFO request queue with bucket-aware batch draining, backed by a
    ``collections.deque`` (O(1) single-request pops)."""

    def __init__(self, items=()):
        self._items = collections.deque(items)

    def push(self, item) -> None:
        self._items.append(item)

    def pop(self):
        """Oldest request, or None when empty."""
        return self._items.popleft() if self._items else None

    def snapshot(self) -> list:
        """Copy of the queued items in FIFO order (non-draining)."""
        return list(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def next_bucket(self, bucket_of: Callable, max_batch: int):
        """Drain up to ``max_batch`` requests sharing the OLDEST
        request's bucket key (head-of-line FIFO: the oldest waiting
        request is always served in the next batch). Returns
        ``(key, requests)`` or None when empty."""
        if not self._items:
            return None
        key = bucket_of(self._items[0])
        taken, kept = [], []
        for item in self._items:
            if len(taken) < max_batch and bucket_of(item) == key:
                taken.append(item)
            else:
                kept.append(item)
        self._items = collections.deque(kept)
        return key, taken


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-batch failure policy: how a failing batch is retried,
    degraded, and finally bisected.

    1. **Retry** the batch up to ``max_retries`` times at the current
       strategy, sleeping ``backoff_s · 2^(attempt-1)`` between tries.
    2. **Degrade** the bucket one rung down ``ladder`` when retries are
       exhausted; the rung sticks for later batches of the bucket until
       a quarantine re-attributes the fault to a request.
    3. **Bisect** the batch when even the bottom rung fails (on the
       card the lowest kernel rung: ``SimServer`` skips ``hwc`` there):
       halves are
       re-served independently, so a single poison request is isolated
       in O(log B) sub-batches and quarantined while every healthy
       member completes.
    """

    max_retries: int = 2
    backoff_s: float = 0.05
    ladder: tuple[str, ...] = DEGRADATION_LADDER

    def backoff(self, attempt: int) -> float:
        return self.backoff_s * (2 ** max(0, attempt - 1))

    def degrade(self, strategy: str) -> str | None:
        """Next rung down the ladder, or None at the bottom.
        ``"auto"`` re-enters at the ``swc`` rung."""
        if strategy == "auto":
            return "swc"
        if strategy not in self.ladder:
            return None
        i = self.ladder.index(strategy)
        return self.ladder[i + 1] if i + 1 < len(self.ladder) else None


@dataclasses.dataclass
class BatchReport:
    """One executed batch: bucket, members, the timing the straggler
    monitor saw, and the failure-domain outcome (strategy actually
    used, retries consumed, per-request status)."""

    index: int
    key: BucketKey
    batch: int
    seconds: float
    straggler: bool
    strategy: str = ""
    retries: int = 0
    statuses: dict[int, str] = dataclasses.field(default_factory=dict)


class SimServer:
    """Shape-bucketed batch server over the batched fused engine.

    One ``FusedStencilOp`` per (bucket, strategy), built lazily on the
    server's device and cached for its lifetime (``op_builds`` counts
    builds); requests are stacked on that device to (B, n_f, *spatial)
    and integrated in one batched call per bucket, one kernel launch per
    step on ``swc``/``swc_stream``/``tc``. Results stay tensors on the
    device.

    Failure domains: every batch executes inside a try/except driven by
    ``retry`` (:class:`RetryPolicy` — retry with backoff, then the
    strategy degradation ladder, then bisection + quarantine; on a CUDA
    device the ladder skips the plain ``hwc`` rung, so a kernel that
    does not build or launch ends in quarantine, never in a batch
    served without it), outputs
    are NaN/inf-checked per member before being handed back
    (``validate_output``), and per-request outcomes accumulate in
    ``request_status`` and ``error_reports`` (quarantined requests
    only).

    ``batch_hook(index, requests)`` runs inside the timed region (the
    straggler tests' seam); ``faults`` (a
    :class:`repro_torch.ft.faults.FaultInjector`) fires its batch faults
    inside the same timed try block and its output faults on the
    result stack.

    ``device`` is where ops, stacks and results live: ``None`` (or
    ``"cuda"``) is the card, raising without one; ``"cpu"`` takes the
    kernels' plain PyTorch versions.

    ``block="auto"`` and ``strategy="auto"`` resolve through the tuner:
    the first batch of each (bucket, batch size, strategy) runs once
    outside its timed region, so the tuning (timed on the card on a
    cache miss) never counts as the batch's seconds.
    """

    def __init__(
        self,
        *,
        strategy: str = "swc",
        block=None,
        accuracy: int = 2,
        alpha: float = 1.0,
        max_batch: int = 8,
        straggler: StragglerMonitor | None = None,
        batch_hook: Callable[[int, list], None] | None = None,
        retry: RetryPolicy | None = None,
        faults: FaultInjector | None = None,
        validate_output: bool = True,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.strategy = strategy
        self.block = block
        self.accuracy = accuracy
        self.alpha = alpha
        self.max_batch = max_batch
        self.straggler = straggler or StragglerMonitor()
        self.batch_hook = batch_hook
        self.retry = retry or RetryPolicy()
        self.faults = faults
        self.validate_output = validate_output
        self.reports: list[BatchReport] = []
        self.op_builds = 0
        self.request_status: dict[int, str] = {}
        self.error_reports: dict[int, dict] = {}
        self._ops: dict[tuple, FusedStencilOp] = {}
        self._warmed: set = set()
        # Current degradation rung per bucket (absent = configured
        # strategy). Written when a batch only completes after
        # degrading; cleared when a quarantine re-attributes the
        # failure to a poison request rather than the strategy.
        self._strategy_for: dict[tuple, str] = {}

    def _op_for(self, key: BucketKey, strategy: str) -> FusedStencilOp:
        shape, dtype, _ = key
        op_key = (shape, dtype, strategy)  # n_steps lives in integrate
        if op_key not in self._ops:
            problem = DiffusionProblem(
                shape, accuracy=self.accuracy, alpha=self.alpha
            )
            block = None if strategy == "hwc" else self.block
            self._ops[op_key] = problem.step_op(
                strategy, block, device=self.device
            )
            self.op_builds += 1
        return self._ops[op_key]

    def serve(self, queue: RequestQueue) -> dict[int, torch.Tensor]:
        """Drain the queue; returns {req_id: final (n_f, *spatial)} on
        the server's device for every request that completed
        (quarantined requests are reported in ``error_reports``)."""
        results: dict[int, torch.Tensor] = {}
        while queue:
            key, reqs = queue.next_bucket(
                lambda r: r.bucket_key, self.max_batch
            )
            self._serve_batch(key, reqs, results)
        return results

    # -- failure-domain core ------------------------------------------------

    def _serve_batch(
        self, key: BucketKey, reqs: list, results: dict
    ) -> None:
        """Serve one plan-compatible batch through the retry →
        degrade → bisect → quarantine ladder."""
        bucket = (key[0], key[1])
        strategy = self._strategy_for.get(bucket, self.strategy)
        retries = 0
        while True:
            try:
                out, dt = self._run_batch(key, reqs, strategy)
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                last_err = e
                log.warning(
                    "batch of %d over %s failed under %s: %s: %s",
                    len(reqs), bucket, strategy, type(e).__name__, e,
                )
                if retries < self.retry.max_retries:
                    retries += 1
                    pause = self.retry.backoff(retries)
                    if pause:
                        time.sleep(pause)
                    continue
                nxt = self._next_viable(strategy, key)
                if nxt is not None:
                    log.warning(
                        "degrading bucket %s: %s -> %s", bucket,
                        strategy, nxt,
                    )
                    strategy = nxt
                    self._strategy_for[bucket] = nxt
                    retries = 0
                    continue
                if len(reqs) > 1:
                    # Ladder exhausted: a member is poisoning the
                    # batch. Bisect to isolate it.
                    mid = len(reqs) // 2
                    log.warning(
                        "bisecting failing batch of %d over %s",
                        len(reqs), bucket,
                    )
                    self._serve_batch(key, reqs[:mid], results)
                    self._serve_batch(key, reqs[mid:], results)
                    return
                self._quarantine(key, reqs[0], last_err, strategy)
                # The fault was request-attributable: later batches of
                # this bucket restart at the configured strategy.
                self._strategy_for.pop(bucket, None)
                self.reports.append(BatchReport(
                    index=len(self.reports), key=key, batch=1,
                    seconds=0.0, straggler=False, strategy=strategy,
                    retries=retries,
                    statuses={reqs[0].req_id: "quarantined"},
                ))
                return

        # Success: check member outputs, then hand results back.
        base = "ok"
        if strategy != self.strategy:
            base = "degraded"
        elif retries:
            base = "retried"
        bad = (
            self._nonfinite_members(out) if self.validate_output else ()
        )
        statuses: dict[int, str] = {}
        for member, req in enumerate(reqs):
            if member in bad:
                self._quarantine(
                    key, req,
                    ValueError("non-finite output (NaN/inf)"),
                    strategy,
                )
                statuses[req.req_id] = "quarantined"
            else:
                results[req.req_id] = out[member]
                statuses[req.req_id] = base
                self._mark(req.req_id, base)
        index = len(self.reports)
        flagged = self.straggler.record(index, dt)
        self.reports.append(BatchReport(
            index=index, key=key, batch=len(reqs), seconds=dt,
            straggler=flagged, strategy=strategy, retries=retries,
            statuses=statuses,
        ))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_batch(self, key: BucketKey, reqs: list, strategy: str):
        """One batched integrate under ``strategy``: stack the requests
        on the device, warm the tuning cache if needed (outside the timed
        region), fire injected batch faults inside the timed region
        (which ends once the card is done), and return ``(output stack,
        seconds)``."""
        op = self._op_for(key, strategy)
        fb = torch.stack([r.f0.to(self.device) for r in reqs])
        warm_key = (key[0], key[1], len(reqs), strategy)
        if (
            (self.block == "auto" or strategy == "auto")
            and strategy != "hwc"
            and warm_key not in self._warmed
        ):
            # A cache miss runs the rank-then-measure search here and
            # persists the :b{B} record; the timed batch replays it.
            op(fb)
            self._sync()
            self._warmed.add(warm_key)
        index = len(self.reports)
        req_ids = [r.req_id for r in reqs]
        self._sync()
        t0 = time.perf_counter()
        if self.batch_hook is not None:
            self.batch_hook(index, reqs)
        if self.faults is not None:
            self.faults.on_batch(index, req_ids, strategy)
        out = integrate(op, fb, key[2])
        self._sync()
        dt = time.perf_counter() - t0
        if self.faults is not None:
            out = self.faults.corrupt_output(req_ids, out)
        return out, dt

    def _next_viable(self, strategy: str, key: BucketKey) -> str | None:
        """First rung below ``strategy`` whose op actually builds for
        this bucket (``swc_stream`` needs rank ≥ 2 — invalid rungs are
        skipped, not crashed into). On a CUDA device the plain ``hwc``
        rung is skipped too."""
        nxt = self.retry.degrade(strategy)
        while nxt is not None:
            if nxt == PLAIN_RUNG and self.device.type == "cuda":
                nxt = self.retry.degrade(nxt)
                continue
            try:
                self._op_for(key, nxt)
                return nxt
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                log.warning(
                    "ladder rung %s not viable for %s: %s",
                    nxt, key[0], e,
                )
                nxt = self.retry.degrade(nxt)
        return None

    @staticmethod
    def _nonfinite_members(out: torch.Tensor) -> set[int]:
        """Member indices of a (B, ...) stack carrying NaN/inf — the
        output check before results are handed back (one reduction per
        member, read back once)."""
        finite = torch.isfinite(out.reshape(out.shape[0], -1)).all(dim=1)
        return {m for m, ok in enumerate(finite.tolist()) if not ok}

    def _mark(self, req_id: int, status: str) -> None:
        cur = self.request_status.get(req_id, "ok")
        if _SEVERITY[status] >= _SEVERITY[cur]:
            self.request_status[req_id] = status

    def _quarantine(
        self, key: BucketKey, req, err: BaseException, strategy: str
    ) -> None:
        """Fail exactly one request: record its error report and mark
        it quarantined. Its batchmates are unaffected."""
        self._mark(req.req_id, "quarantined")
        self.error_reports[req.req_id] = {
            "req_id": req.req_id,
            "bucket": "x".join(map(str, key[0]))
            + f"/{key[1]}/n{key[2]}",
            "strategy": strategy,
            "error": f"{type(err).__name__}: {err}",
        }
        log.error(
            "quarantined request %d (%s under %s): %s: %s",
            req.req_id, key[0], strategy, type(err).__name__, err,
        )


# ---------------------------------------------------------------------------
# CLI: smoke queue and its per-member check.
# ---------------------------------------------------------------------------


def demo_queue(
    shapes, n_steps: int, requests: int, seed: int = 0, *,
    device: str | torch.device | None = None,
) -> RequestQueue:
    """Mixed-shape request stream: round-robin over ``shapes`` so every
    bucket interleaves with the others in FIFO order. Fields are the
    reference's numpy draw (uniform in (-1e-5, 1e-5), float32), placed
    on ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    queue = RequestQueue()
    for rid in range(requests):
        shape = shapes[rid % len(shapes)]
        f0 = rng.uniform(-1e-5, 1e-5, size=(1,) + tuple(shape))
        queue.push(SimRequest(
            rid, torch.as_tensor(f0, dtype=torch.float32, device=device),
            n_steps,
        ))
    return queue


def member_reference(server: SimServer, reqs: list[SimRequest]):
    """The oracle the batched path must match (port of the reference's
    ``_vmap_reference``): the SINGLE-member plain op integrated on each
    request alone, on the server's device, stacked to (B, n_f,
    *spatial)."""
    key = reqs[0].bucket_key
    problem = DiffusionProblem(
        key[0], accuracy=server.accuracy, alpha=server.alpha
    )
    op = problem.step_op("hwc", device=server.device)
    return torch.stack([
        integrate(op, r.f0.to(server.device), key[2]) for r in reqs
    ])


def check_parity(server, by_id, results, tol: float = 1e-5) -> float:
    """Batched-vs-per-member parity over every COMPLETED request,
    bounded relative to each bucket's field scale (an f32 workload);
    raises ``AssertionError`` past ``tol``. Returns the max abs
    error."""
    max_err = 0.0
    for key in {r.bucket_key for r in by_id.values()}:
        reqs = [
            r for r in by_id.values()
            if r.bucket_key == key and r.req_id in results
        ]
        if not reqs:
            continue
        expect = member_reference(server, reqs)
        got = torch.stack([results[r.req_id] for r in reqs])
        scale = float(expect.abs().max())
        err = float((got - expect).abs().max())
        max_err = max(max_err, err)
        if not err <= tol * max(scale, 1e-30):
            raise AssertionError(
                f"batched-vs-member parity failed for bucket {key}: "
                f"max abs err {err:.2e} at field scale {scale:.2e}"
            )
    return max_err


def assert_chaos_contract(server, injector, plan, by_id, results, cache):
    """The chaos acceptance contract (the reference's): every healthy
    request completed, exactly the poison request is quarantined, the
    transient failure was retried to completion, the slow batch's fault
    fired, the garbled ``cache.json`` was quarantined aside and rebuilt
    — and, on the card, where ``"auto"`` times candidates, a candidate
    really failed (a ``failed`` row of a record) while ``"auto"`` still
    resolved. On the CPU no candidate is launched, so that fault stays
    unfired."""
    quarantined = set(server.error_reports)
    poison = plan["poison"]
    if quarantined != {poison}:
        raise AssertionError(
            f"expected exactly the poison request {poison} quarantined, "
            f"got {quarantined}")
    if server.request_status[poison] != "quarantined" or poison in results:
        raise AssertionError(f"poison request {poison} was served")
    healthy = set(by_id) - {poison}
    if set(results) != healthy:
        raise AssertionError(
            f"missing healthy results: {healthy - set(results)}")
    if server.request_status.get(plan["transient"]) != "retried":
        raise AssertionError(
            f"transient failure not retried: {plan}, "
            f"{server.request_status}")
    sites = [site for site, _, _ in injector.fired]
    if not any(s == "serve.batch" and k == "slow"
               for s, k, _ in injector.fired):
        raise AssertionError(f"slow-batch fault never fired: {sites}")
    from repro_torch.tuning.cache import TuningCache

    records = TuningCache(cache.dir).items()
    if server.device.type == "cuda":
        if "tune.candidate" not in sites:
            raise AssertionError(
                f"tune.candidate fault never fired: {injector.fired}")
        if not any(rec.failed for rec in records.values()):
            raise AssertionError("no failed row in any tuning record")
    corpses = list(cache.file.parent.glob(cache.file.name + ".corrupt*"))
    if not corpses:
        raise AssertionError("corrupt cache.json was not quarantined aside")
    if not (cache.file.exists() and records):
        raise AssertionError("tuning cache was not rebuilt after quarantine")
    print(
        f"chaos contract OK: {len(injector.fired)} fault(s) fired, "
        f"request {poison} quarantined, request {plan['transient']} "
        f"retried, cache quarantined to {corpses[0].name}"
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Batched stencil-simulation serving loop"
    )
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--steps", type=int, default=8,
                    help="diffusion steps per request")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="largest ensemble batch per kernel launch")
    ap.add_argument("--strategy", default="swc",
                    choices=("hwc", "swc", "swc_stream", "tc", "auto"))
    ap.add_argument("--auto-tune", action="store_true",
                    help="resolve the batched kernel's block through the "
                         "tuner (block='auto': the first batch of each "
                         "bucket tunes and persists a :b{B}-keyed record, "
                         "later batches replay it)")
    ap.add_argument("--smoke", action="store_true",
                    help="small mixed-shape queue + batched-vs-member "
                         "parity check")
    ap.add_argument("--chaos", action="store_true",
                    help="inject the seeded fault plan "
                         "(repro_torch.ft.faults.chaos_specs) and assert "
                         "the recovery contract; forces strategy='auto' "
                         "and block='auto', the tuning cache in a "
                         "temporary directory unless "
                         "$REPRO_TORCH_TUNE_CACHE is set")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the --chaos fault plan")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card) or 'cpu'")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    shapes = [(16, 32), (12, 24)] if args.smoke else [(32, 64), (24, 48)]
    strategy = args.strategy
    block = "auto" if (args.auto_tune or strategy == "auto") else None
    if args.chaos:
        strategy, block = "auto", "auto"
    device = resolve_device(args.device)
    queue = demo_queue(shapes, args.steps, args.requests, device=device)
    by_id = {r.req_id: r for r in queue.snapshot()}

    injector = plan = cache = None
    if args.chaos:
        from repro_torch.tuning.cache import ENV_VAR, TuningCache

        # Chaos garbles cache.json on purpose: never the user's cache.
        if ENV_VAR not in os.environ:
            os.environ[ENV_VAR] = tempfile.mkdtemp(
                prefix="repro-torch-chaos-cache-")
            print(f"chaos: tuning cache redirected to {os.environ[ENV_VAR]}")
        specs, plan = ftfaults.chaos_specs(args.fault_seed, list(by_id))
        injector = FaultInjector(specs, slow_s=0.3)
        # Crashed-writer stand-in: garble cache.json BEFORE serving, so
        # the first tuning read must quarantine and rebuild it.
        cache = TuningCache()
        injector.corrupt_cache(cache.file)
        print(f"chaos plan (seed {args.fault_seed}): {plan}")

    server = SimServer(
        strategy=strategy, block=block, max_batch=args.max_batch,
        faults=injector, device=device,
    )
    t0 = time.perf_counter()
    if injector is not None:
        with ftfaults.active(injector):
            results = server.serve(queue)
    else:
        results = server.serve(queue)
    wall = time.perf_counter() - t0

    quarantined = set(server.error_reports)
    if set(results) != set(by_id) - quarantined or (
        quarantined and not args.chaos
    ):
        raise AssertionError(f"quarantined: {server.error_reports}")
    members = sum(rep.batch for rep in server.reports)
    stragglers = sum(rep.straggler for rep in server.reports)
    status_counts = collections.Counter(
        server.request_status.get(rid, "ok") for rid in by_id
    )
    print(
        f"served {len(results)}/{args.requests} request(s) on "
        f"{server.device} in {len(server.reports)} batch(es) / "
        f"{server.op_builds} op build(s), {wall:.2f}s "
        f"({members * args.steps / wall:.1f} member-steps/s, "
        f"{stragglers} straggler(s), "
        + ", ".join(f"{k}={v}" for k, v in sorted(status_counts.items()))
        + ")"
    )
    if args.smoke or args.chaos:
        max_err = check_parity(server, by_id, results)
        print(f"batched-vs-member parity OK (max abs err {max_err:.2e})")
    if args.chaos:
        assert_chaos_contract(server, injector, plan, by_id, results, cache)
    print("serve_sim OK")


if __name__ == "__main__":
    main()
