"""Fault-tolerance runtime: retry supervisor, preemption hook, straggler log.

At thousand-node scale the failure model is: (a) hard worker loss -> the
collective raises; (b) SIGTERM preemption warning; (c) stragglers ->
step-time outliers. The supervisor owns (a) and (b) by
restarting the step loop from the last committed checkpoint; (c) is surfaced
by the StepTimer so the scheduler can evict (synchronous SPMD bounds the cost
of a straggler at the collective -- mitigation = replacement, not async).

The serving runtime (repro_torch.runtime.serve) reuses the same three
primitives at per-batch granularity: Backoff paces its in-place retry
stage, and StepTimer flags straggler batches so the supervisor can evict a
slow layer onto the fallback executor.
"""

from __future__ import annotations

import random
import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class PreemptionGuard:
    """Converts SIGTERM into a checkpoint-and-exit request."""

    def __init__(self):
        self.requested = False
        try:
            signal.signal(signal.SIGTERM, self._handler)
        except ValueError:
            pass  # not main thread (tests)

    def _handler(self, signum, frame):
        self.requested = True


class Backoff:
    """Exponential backoff with deterministic jitter.

    `next()` returns the delay for the next retry: `base * factor**attempt`
    capped at `cap`, scaled by a jitter factor drawn uniformly from
    [1 - jitter, 1] off a seeded RNG -- deterministic per instance (tests,
    reproducible fault drills) while still decorrelating retry storms across
    differently seeded instances.
    """

    def __init__(self, base: float = 0.05, factor: float = 2.0,
                 cap: float = 2.0, jitter: float = 0.5, seed: int = 0):
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.base = base
        self.factor = factor
        self.cap = cap
        self.jitter = jitter
        self.attempt = 0
        self._rng = random.Random(seed)

    def next(self) -> float:
        d = min(self.cap, self.base * self.factor ** self.attempt)
        self.attempt += 1
        return d * (1.0 - self.jitter * self._rng.random())

    def reset(self) -> None:
        self.attempt = 0


@dataclass
class StepTimer:
    """Rolling step-time stats; flags straggler steps (> k sigma).

    Baseline hygiene: the window that judges a sample contains only
    *previously* recorded, *non-straggler* samples -- the current sample
    never contributes to the mean/variance used to flag it, and flagged
    outliers are kept out of the baseline so one straggler cannot inflate
    the stats and mask the next one. `times` still records every sample
    verbatim for reporting.
    """
    window: int = 50
    sigma: float = 3.0
    min_baseline: int = 10
    times: list = field(default_factory=list)      # every sample, in order
    baseline: list = field(default_factory=list)   # non-straggler samples
    stragglers: int = 0

    def record(self, dt: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        hist = self.baseline[-self.window:]
        is_out = False
        if len(hist) >= self.min_baseline:
            mean = sum(hist) / len(hist)
            var = sum((t - mean) ** 2 for t in hist) / len(hist)
            if dt > mean + self.sigma * max(var ** 0.5, 0.05 * mean):
                self.stragglers += 1
                is_out = True
        self.times.append(dt)
        if not is_out:
            self.baseline.append(dt)
        return is_out


def run_with_retries(body: Callable[[int], int], *, max_failures: int = 3,
                     on_failure: Optional[Callable[[Exception], None]] = None,
                     base_delay_s: float = 0.05, max_delay_s: float = 2.0,
                     jitter: float = 0.5,
                     sleep: Callable[[float], None] = time.sleep) -> int:
    """Supervise `body(start_step) -> last_step`, restarting on failure.

    `body` must be restartable from its checkpoint store. Each retry calls
    body again; the restored start step comes from the checkpoint manager
    inside body. Raises after max_failures consecutive failures.

    Consecutive failures are paced by exponential backoff with jitter
    (base_delay_s doubling up to max_delay_s) so a crash-looping fleet does
    not hammer shared infrastructure in lockstep. Only `Exception` is
    caught: `SystemExit` and `KeyboardInterrupt` (preemption, operator
    interrupt) escape immediately instead of burning the retry budget.
    """
    failures = 0
    last = 0
    backoff = Backoff(base=base_delay_s, cap=max_delay_s, jitter=jitter)
    while True:
        try:
            return body(last)
        except Exception as e:
            failures += 1
            if on_failure:
                on_failure(e)
            if failures > max_failures:
                raise
            sleep(backoff.next())
