"""Clock seam for the serving stack (DESIGN.md §9).

Every latency interval the engine and scheduler report (TTFT, queue
delay, ``wall_s``, decode tok/s) is measured through one injected clock
object instead of ad-hoc ``time.time()`` calls:

* ``WallClock`` (the default) reads ``time.perf_counter()`` -- a
  *monotonic* clock.  ``time.time()`` is wall time and steps under NTP
  adjustment, which used to make a latency interval negative or inflated
  whenever the host clock corrected mid-serve; perf_counter cannot go
  backwards.  (Interval math still clamps at zero as defense in depth:
  the seam accepts arbitrary injected clocks, including broken ones.)

* ``VirtualClock`` is a deterministic manual clock for tests and the
  open-loop arrival machinery: the engine ticks it once per engine step
  (``on_step``), so arrival offsets expressed in *steps* release at
  exact, reproducible points regardless of host speed, and latency
  stats come out in step units.

The clock also owns the idle-wait policy (``sleep_until``): a wall
clock sleeps the process until the next scheduled arrival (capped, so a
drain stays responsive), while a virtual clock simply jumps -- there is
nothing to wait for in simulated time.
"""

from __future__ import annotations

import time


class Clock:
    """Interface: ``now()`` is the only required method."""

    def now(self) -> float:
        raise NotImplementedError

    def on_step(self) -> None:
        """Engine hook, called once after every engine step."""

    def sleep_until(self, t: float) -> None:
        """Idle-wait toward ``t`` (best effort; may return early)."""


class WallClock(Clock):
    """Monotonic wall-time clock (``time.perf_counter``)."""

    #: cap per sleep so a drain wakes promptly even if an arrival far in
    #: the future is later joined by nearer work
    MAX_SLEEP_S = 0.05

    def now(self) -> float:
        return time.perf_counter()

    def sleep_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(min(dt, self.MAX_SLEEP_S))


class VirtualClock(Clock):
    """Deterministic manual clock: ``tick`` per engine step.

    With the default ``tick=1.0`` virtual time counts engine steps, so a
    request submitted with ``arrival_time=now+k`` enters exactly ``k``
    steps later.  ``tick=0`` freezes time under engine control; tests
    then drive it with ``advance()``.
    """

    def __init__(self, start: float = 0.0, tick: float = 1.0):
        self._t = float(start)
        self.tick = float(tick)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance a clock by {dt}")
        self._t += dt

    def on_step(self) -> None:
        self._t += self.tick

    def sleep_until(self, t: float) -> None:
        # nothing is live and the next arrival is at t: jump straight
        # there (simulated idle time costs no engine steps)
        if t > self._t:
            self._t = t
