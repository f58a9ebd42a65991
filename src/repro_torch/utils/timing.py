"""Wall-clock timing helpers: the JAX package's ``utils/timing.py``."""
from __future__ import annotations

import time


class Timer:
    """Context-manager timer; ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


class StepTimer:
    """EWMA step timer with straggler flagging: a step slower than
    ``threshold × ewma`` is a straggler event (the wave scheduler records
    each wave's wall time here)."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.5):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma = None
        self.straggler_events = 0
        self.steps = 0

    def record(self, seconds: float) -> bool:
        """Record one step; returns True if this step is a straggler."""
        self.steps += 1
        if self.ewma is None:
            self.ewma = seconds
            return False
        is_straggler = seconds > self.threshold * self.ewma
        if is_straggler:
            self.straggler_events += 1
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return is_straggler
