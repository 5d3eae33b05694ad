"""Clocks of the serving layer (port of ``repro/serving/graph_frontend.py:98-138``).

Every timestamp the LM ``Engine`` takes goes through one of these. The
graph-query frontend itself (Queue 1 item 12 of the ROADMAP) will extend
this file.
"""
from __future__ import annotations

import time


class Clock:
    """Monotonic wall clock (``time.perf_counter``).

    ``time.time()`` is not monotonic (NTP steps move it backwards), so
    latencies computed from it can go negative. Everything that measures
    a duration goes through ``now()`` here or on an injected fake.
    """

    def now(self) -> float:
        return time.perf_counter()

    def wait_until(self, t: float) -> None:
        """Sleep until ``now() >= t`` (benchmarks only; tests use
        ``FakeClock`` and never sleep)."""
        while True:
            dt = t - self.now()
            if dt <= 0:
                return
            time.sleep(min(dt, 0.05))


class FakeClock(Clock):
    """Manually advanced clock: deterministic time for tests.

    ``wait_until`` jumps instead of sleeping.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance a clock backwards: {dt}")
        self._t += dt

    def wait_until(self, t: float) -> None:
        if t > self._t:
            self._t = t
