"""Straggler watchdog and preemption handling.

A copy of ``repro.train.watchdog`` (plain Python in both packages):

  * ``StragglerWatchdog`` keeps an EWMA of step wall time and flags a
    step that takes more than ``ratio`` x it (after ``warmup_steps``);
    flagged steps count in ``events`` and call ``on_straggle``, healthy
    ones update the baseline.
  * ``PreemptionGuard`` installs SIGTERM/SIGINT handlers that set
    ``requested``; the train loop checkpoints and stops at the next step
    boundary.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerWatchdog:
    ratio: float = 2.0              # flag if step > ratio * EWMA
    alpha: float = 0.1              # EWMA smoothing
    warmup_steps: int = 5
    on_straggle: Optional[Callable[[int, float, float], None]] = None

    _ewma: float = 0.0
    _steps: int = 0
    events: int = 0
    history: List[float] = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; True if it is flagged as a straggle."""
        self.history.append(seconds)
        self._steps += 1
        if self._steps <= self.warmup_steps:
            self._ewma = (seconds if self._ewma == 0.0
                          else (1 - self.alpha) * self._ewma
                          + self.alpha * seconds)
            return False
        flagged = seconds > self.ratio * self._ewma
        if flagged:
            self.events += 1
            if self.on_straggle:
                self.on_straggle(step, seconds, self._ewma)
        else:
            # only healthy steps update the baseline
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * seconds
        return flagged

    @property
    def baseline(self) -> float:
        return self._ewma


class PreemptionGuard:
    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:       # not on the main thread
                    pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self) -> None:
        for sig, h in self._prev.items():
            signal.signal(sig, h)
