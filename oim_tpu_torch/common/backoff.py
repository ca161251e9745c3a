"""Shared retry pacing: the control plane's two backoff disciplines.

Three loops grew three private copies of the same arithmetic — the
controller heartbeat loop's jittered exponential (controller.py), the
registry-row publisher's identical twin (telemetry.py, serving the
serve/<id> and telemetry/<id> registration loops), and the feeder's
decorrelated-jitter StageStatus poll (feeder/driver.py). Three copies
means three clocks to stub when a test — or the chaos ladder
(oim_tpu/chaos) — needs to fast-forward an outage deterministically.
This module is the one copy, with ONE jitter source (`_uniform`) that
``use_rng`` reroutes, so a seeded ``random.Random`` makes every backoff
draw in the process reproducible.

* ``ExponentialBackoff`` — the outage-recovery discipline: delay
  doubles per consecutive failure up to ``cap``, then a multiplicative
  jitter spreads a fleet so a restarting registry is never hit in
  lockstep (the PR 1 heartbeat-loop stance).
* ``DecorrelatedJitter`` — the progress-poll discipline (AWS's
  "decorrelated jitter"): each delay draws uniform(base, prev * mult)
  capped, so a fast stage is noticed in ~ms while a long one is polled
  gently and un-synchronized.
* ``jittered`` — the one-shot multiplicative jitter for healthy-path
  intervals (the router table's poll spread).

The port's copy of ``oim_tpu/common/backoff.py``; it imports nothing of
that package.
"""

from __future__ import annotations

import random
from typing import Callable

# The process-wide jitter source. Tests and the chaos ladder reroute it
# through a seeded random.Random via use_rng() so backoff schedules are
# deterministic; production draws from the module-default PRNG.
_uniform: Callable[[float, float], float] = random.uniform


def use_rng(rng: random.Random | None) -> None:
    """Route every jitter draw through ``rng`` (None restores the
    module default). The chaos ladder's determinism hook: one seeded
    stream feeds every backoff in the process."""
    global _uniform
    _uniform = random.uniform if rng is None else rng.uniform


def jittered(value: float, lo: float = 0.5, hi: float = 1.5) -> float:
    """``value`` scaled by uniform(lo, hi): the healthy-path interval
    spread (a fleet polling "every N seconds" must not mean "all at
    second N")."""
    return value * _uniform(lo, hi)  # noqa: S311 - jitter


class ExponentialBackoff:
    """Jittered exponential backoff for consecutive-failure retry loops.

    The n-th consecutive ``next()`` returns
    ``min(base * factor**(n-1), cap) * uniform(*jitter)`` — exactly the
    heartbeat-loop formula the controller and RegistryRowPublisher each
    hand-rolled. ``reset()`` on success."""

    def __init__(self, base: float, cap: float, factor: float = 2.0,
                 jitter: tuple[float, float] = (0.5, 1.5)):
        if base <= 0 or cap <= 0:
            raise ValueError(f"base and cap must be > 0, got "
                             f"base={base}, cap={cap}")
        if factor < 1.0:
            raise ValueError(f"factor must be >= 1, got {factor}")
        lo, hi = jitter
        if not 0 < lo <= hi:
            raise ValueError(f"need 0 < jitter lo <= hi, got {jitter}")
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = (lo, hi)
        self.failures = 0

    def next(self) -> float:
        """Record one failure and return the delay to sleep before the
        retry."""
        self.failures += 1
        raw = min(self.base * self.factor ** (self.failures - 1), self.cap)
        return raw * _uniform(*self.jitter)  # noqa: S311 - jitter

    def reset(self) -> None:
        self.failures = 0


class DecorrelatedJitter:
    """Decorrelated-jitter pacing for progress polls: each ``next()``
    draws ``min(cap, uniform(base, prev * mult))`` — quick first checks,
    gentle long tails, no fleet lockstep (the feeder's StageStatus
    formula)."""

    def __init__(self, base: float, cap: float, mult: float = 3.0):
        if base <= 0 or cap < base:
            raise ValueError(f"need 0 < base <= cap, got "
                             f"base={base}, cap={cap}")
        if mult <= 1.0:
            raise ValueError(f"mult must be > 1, got {mult}")
        self.base = base
        self.cap = cap
        self.mult = mult
        self._prev = base

    def next(self) -> float:
        self._prev = min(
            self.cap,
            _uniform(self.base, self._prev * self.mult),  # noqa: S311
        )
        return self._prev

    def reset(self) -> None:
        self._prev = self.base
