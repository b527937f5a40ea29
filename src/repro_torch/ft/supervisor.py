"""Fault-tolerant training supervision and straggler monitoring (port
of ``repro.ft.supervisor``, a copy: the port imports nothing of
``repro``).

The failure model: a host dies mid-step, the job restarts, and training
resumes from the last durable step with bit-identical data order.

* ``Supervisor.run`` drives the step loop, checkpoints every
  ``ckpt_every`` steps, and on failure restores the last checkpoint and
  REPLAYS from its step — with the deterministic data pipeline
  (``repro_torch.data.pipeline``) the recovery is exact.
* ``SimulatedFailure`` + ``failure_at`` inject crashes for tests and the
  train CLI's ``--simulate-failure-at`` (the stand-in for a node loss).
  ``Supervisor.recoverable`` widens the restore trigger to real runtime
  errors (``torch.cuda.OutOfMemoryError``, ``OSError``);
  ``SimulatedFailure`` is only the default.
* ``StragglerMonitor`` tracks per-step (or per-batch) wall times; a step
  slower than ``factor ×`` the trailing median is flagged as a
  straggler, logged with its ``rank``, counted and handed to the
  optional ``on_straggler`` callback. The serving loop
  (``repro_torch.launch.serve_sim``) feeds it each batch's seconds, the
  supervisor each step's; in a data-parallel run each rank keeps its
  own.
* Over the ranks of an initialized ``torch.distributed`` group the
  supervisor runs in lockstep: every rank fails at ``failure_at``, a
  barrier lets rank 0's last checkpoint land before any rank reads the
  latest step, all restore the same step, and a barrier follows the
  restore. ``shardings`` (the checkpointed subtree's) makes each save
  the manager's sharded save (gathered leaves, rank 0 writes, a
  barrier).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import torch.distributed as dist

log = logging.getLogger("repro_torch.ft")


def _barrier() -> None:
    """A barrier over the initialized group; nothing on a single
    process."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests, ``--simulate-failure-at``)."""


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 1.5
    window: int = 20
    on_straggler: Callable[[int, float, float], None] | None = None
    rank: int = 0
    _times: list = dataclasses.field(default_factory=list)
    flagged: list = dataclasses.field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        self._times.append(seconds)
        hist = self._times[-self.window - 1 : -1]
        if len(hist) >= 5:
            med = sorted(hist)[len(hist) // 2]
            if seconds > self.factor * med:
                self.flagged.append((step, seconds, med))
                log.warning(
                    "straggler at step %d on rank %d: %.3fs vs median "
                    "%.3fs", step, self.rank, seconds, med,
                )
                if self.on_straggler:
                    self.on_straggler(step, seconds, med)
                return True
        return False


@dataclasses.dataclass
class Supervisor:
    """Restart-on-failure loop around a step function.

    ``step_fn(state, step) -> state`` must be side-effect-free w.r.t.
    recovery (all persistent state in ``state`` + the step counter).
    """

    ckpt_manager: Any
    ckpt_every: int = 50
    max_restarts: int = 3
    straggler: StragglerMonitor = dataclasses.field(
        default_factory=StragglerMonitor
    )
    # Exception types that trigger checkpoint-restore instead of
    # propagating: only the injected failure by default; a deployment
    # widens it (e.g. ``(SimulatedFailure, OSError)``) so a flaky
    # filesystem also restarts from the last durable step.
    # KeyboardInterrupt/SystemExit are never caught.
    recoverable: tuple[type[BaseException], ...] = (SimulatedFailure,)
    # The checkpointed subtree's shardings in a sharded run (None: each
    # save writes this process's tree as it is).
    shardings: Any = None

    def run(
        self,
        state: Any,
        step_fn: Callable[[Any, int], Any],
        n_steps: int,
        *,
        start_step: int = 0,
        failure_at: int | None = None,
        restore_fn: Callable[[Any, int | None], tuple[Any, int]] | None = None,
        save_filter: Callable[[Any], Any] | None = None,
    ) -> tuple[Any, dict]:
        """Run to ``n_steps`` with checkpoint/restart. Returns
        (final_state, report). ``restore_fn(state_template, step)`` must
        rebuild the state from the checkpoint (``step`` None: none was
        written yet). ``save_filter`` maps state → the checkpointable
        subtree."""
        restarts = 0
        step = start_step
        report = {"restarts": 0, "stragglers": 0, "failed_steps": []}
        injected = failure_at
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                if injected is not None and step == injected:
                    injected = None  # fire once
                    raise SimulatedFailure(f"injected failure at step {step}")
                state = step_fn(state, step)
                dt = time.perf_counter() - t0
                if self.straggler.record(step, dt):
                    report["stragglers"] += 1
                step += 1
                if step % self.ckpt_every == 0 or step == n_steps:
                    to_save = save_filter(state) if save_filter else state
                    if self.shardings is None:
                        self.ckpt_manager.save(step, to_save)
                    else:
                        self.ckpt_manager.save(step, to_save,
                                               shardings=self.shardings)
            except self.recoverable as e:
                restarts += 1
                report["restarts"] = restarts
                report["failed_steps"].append(step)
                log.warning("failure at step %d: %s", step, e)
                if restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.max_restarts}"
                    ) from e
                if restore_fn is None:
                    raise
                self.ckpt_manager.wait()
                _barrier()
                last = self.ckpt_manager.latest_step()
                state, step = restore_fn(state, last)
                _barrier()
                log.warning("restored at step %d, resuming", step)
        self.ckpt_manager.wait()
        return state, report
