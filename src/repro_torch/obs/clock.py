"""The time-source seam: the JAX package's ``obs/clock.py``.

Code that timestamps (the wave scheduler's straggler detector,
``core/multilevel.py``) reads time only through a ``Clock``: production
code gets ``SystemClock`` (monotonic), a simulation swaps in
``VirtualClock``, which moves only when the caller advances it.
"""
from __future__ import annotations

import time


class Clock:
    """Time source seam: timestamping code never reads the wall clock
    directly."""

    def now(self) -> float:
        raise NotImplementedError


class SystemClock(Clock):
    def now(self) -> float:
        return time.monotonic()


class VirtualClock(Clock):
    """Manually advanced clock for deterministic simulation: time moves only
    when the caller says so."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"VirtualClock.advance({dt}): time runs forward")
        self._t += float(dt)
