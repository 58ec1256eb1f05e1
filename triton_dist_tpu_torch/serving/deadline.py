"""Deadlines, bounded exponential backoff, and the engine stall watchdog.

A copy of ``triton_dist_tpu/serving/deadline.py`` (pure Python). It is the
one vocabulary the serving tier's host-side waits share:

- ``Deadline``: a budget in *engine-step space* — the deterministic clock
  every replayable test runs on — with an optional wall-clock cap as a
  belt-and-braces hang guard for real deployments (wall time is never
  consulted unless explicitly configured, so CI replays stay exact).
- ``Backoff``: a bounded exponential retry schedule. Each expiry asks
  ``next_budget()``; ``None`` means the rungs are exhausted and the
  caller must move down the recovery ladder (degrade, then fail).
- ``EngineStallError``: the typed "the engine as a whole stopped making
  progress" diagnosis raised by ``engine.run``'s watchdog — the backstop
  that turns any residual livelock bug into a loud, described failure
  instead of a hang.
"""

from __future__ import annotations

import time


class EngineStallError(RuntimeError):
    """``engine.run`` made no progress for a full watchdog window.

    Per-request recovery (retry -> degrade -> fail) should consume every
    fault the chaos plans can inject; this error firing means a wait that
    has no deadline, i.e. a bug. The message carries the engine's state
    dump so the report is actionable without a debugger.
    """


class Deadline:
    """A wait budget anchored at creation time.

    ``steps`` is in engine-step space (the deterministic clock); pass the
    current step as ``now``. ``wall_s`` optionally adds a wall-clock cap:
    ``expired()`` then also fires once that much real time has passed,
    whatever the step counter says. Call ``rearm`` to reuse the object
    for the next rung instead of allocating a new one.
    """

    __slots__ = ("expires_step", "_wall_deadline", "_wall_s")

    def __init__(self, steps: int, now: int, wall_s: float | None = None):
        self.expires_step = now + int(steps)
        self._wall_s = wall_s
        self._wall_deadline = (None if wall_s is None
                               else time.perf_counter() + wall_s)

    def rearm(self, steps: int, now: int) -> "Deadline":
        self.expires_step = now + int(steps)
        if self._wall_s is not None:
            self._wall_deadline = time.perf_counter() + self._wall_s
        return self

    def expired(self, now: int) -> bool:
        if now >= self.expires_step:
            return True
        return (self._wall_deadline is not None
                and time.perf_counter() >= self._wall_deadline)

    def remaining(self, now: int) -> int:
        return max(0, self.expires_step - now)


class Backoff:
    """Bounded exponential backoff: budgets ``base, base*factor, ...``
    for up to ``max_retries`` rungs, then ``None`` forever.

    The *attempt* count (how many budgets have been handed out) doubles
    as the ledger generation tag for retried sends.
    """

    __slots__ = ("base", "factor", "max_retries", "attempt")

    def __init__(self, base: int, factor: int = 2, max_retries: int = 3):
        if base < 1:
            raise ValueError(f"backoff base must be >= 1, got {base}")
        self.base = int(base)
        self.factor = int(factor)
        self.max_retries = int(max_retries)
        self.attempt = 0

    def next_budget(self) -> int | None:
        if self.attempt >= self.max_retries:
            return None
        budget = self.base * self.factor ** self.attempt
        self.attempt += 1
        return budget

    @property
    def exhausted(self) -> bool:
        return self.attempt >= self.max_retries


__all__ = ["Deadline", "Backoff", "EngineStallError"]
