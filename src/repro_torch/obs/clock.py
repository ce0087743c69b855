"""Injectable clocks for serving, budgeting, and telemetry (DESIGN.md §13).

Every latency the stack reports — queue wait, device step time, Eq. (7)
SLA feedback, trace span timestamps — must come from *one* clock, or the
numbers stop composing: a trace whose spans are stamped by a different
clock than the budgeter's feedback loop cannot explain why alpha moved.
``MicroBatchServer``, ``InflightServer``, the budgeters, and
``Instrumentation`` all accept a ``clock`` callable (seconds, monotonic);
the default is ``time.perf_counter`` everywhere.

``FakeClock`` is the deterministic test double the suites share: each
reading advances a fixed ``dt``, so SLA/queueing assertions do not depend
on container timing noise. It lives here (not copy-pasted per test module)
so library code and tests provably read the same clock type.
"""

from __future__ import annotations

import time

__all__ = ["DEFAULT_CLOCK", "FakeClock"]

DEFAULT_CLOCK = time.perf_counter


class FakeClock:
    """Deterministic clock: every reading advances time by ``dt`` seconds.

    ``clock()`` semantics match ``time.perf_counter``: monotonically
    increasing floats in seconds. ``advance()`` jumps the clock without a
    reading, for tests that model idle wall time.
    """

    def __init__(self, dt: float = 0.0, start: float = 0.0):
        self.t = float(start)
        self.dt = float(dt)

    def __call__(self) -> float:
        self.t += self.dt
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += float(seconds)
