"""Fault handling: preemption hooks, straggler watchdog, failure injection.

The port's own copy of ``src/repro/train/fault.py`` (pure Python):

* ``PreemptionGuard`` installs SIGTERM handlers that flip a flag the
  training loop polls; on preemption the loop writes a final checkpoint and
  exits (the scheduler restarts the job, which resumes).
* ``StragglerWatchdog`` keeps a per-step wall-time EWMA; a step slower than
  ``threshold`` x the EWMA is recorded as a straggler event.
* ``FailureInjector`` raises at a chosen step, the kill half of the
  kill -> restart -> resume test.
"""
from __future__ import annotations

import signal
from dataclasses import dataclass
from typing import List, Optional

__all__ = ["PreemptionGuard", "StragglerEvent", "StragglerWatchdog", "FailureInjector"]


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = False
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def preempted(self) -> bool:
        return self._flag


@dataclass
class StragglerEvent:
    step: int
    duration: float
    ewma: float


class StragglerWatchdog:
    """Flags steps slower than threshold x EWMA (warmup steps excluded)."""

    def __init__(self, threshold: float = 3.0, alpha: float = 0.2, warmup: int = 3):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.events: List[StragglerEvent] = []
        self._n = 0

    def observe(self, step: int, duration: float) -> Optional[StragglerEvent]:
        self._n += 1
        if self._n <= self.warmup:
            self.ewma = duration if self.ewma is None else (
                self.alpha * duration + (1 - self.alpha) * self.ewma)
            return None
        ev = None
        if self.ewma is not None and duration > self.threshold * self.ewma:
            ev = StragglerEvent(step, duration, self.ewma)
            self.events.append(ev)
        else:
            # stragglers don't poison the EWMA
            self.ewma = self.alpha * duration + (1 - self.alpha) * self.ewma
        return ev


class FailureInjector:
    """Raises at a chosen step: simulates a node loss for resume tests."""

    class Injected(RuntimeError):
        pass

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step

    def check(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise FailureInjector.Injected(f"injected failure at step {step}")
