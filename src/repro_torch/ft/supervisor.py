"""Straggler monitoring (port of ``StragglerMonitor`` from
``repro.ft.supervisor``, a copy: the port imports nothing of ``repro``).

``StragglerMonitor`` tracks per-step (or per-batch) wall times; a step
slower than ``factor ×`` the trailing median is flagged as a straggler,
logged, counted and handed to the optional ``on_straggler`` callback.
The serving loop (``repro_torch.launch.serve_sim``) feeds it each
batch's seconds.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable

log = logging.getLogger("repro_torch.ft")


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 1.5
    window: int = 20
    on_straggler: Callable[[int, float, float], None] | None = None
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
                    "straggler at step %d: %.3fs vs median %.3fs",
                    step, seconds, med,
                )
                if self.on_straggler:
                    self.on_straggler(step, seconds, med)
                return True
        return False
