"""Process-level metrics: counters, gauges, log-bucketed histograms.
Stdlib only.

A `MetricsRegistry` owns a flat namespace of instruments behind ONE
re-entrant lock, so `snapshot()` is atomic: no counter increments, no
histogram records, and no dict-shaped state mutations interleave with the
deep copy it returns. That lock is deliberately exposed (`registry.lock`)
so composite owners -- the serving runtime's ServerStats, whose dict
fields (bucket_batches, ...) live next to its registry counters -- can
extend the same atomicity to their own state.

Instruments:

- `Counter`  -- monotone-by-convention int; `inc(n)` / `set(v)`.
- `Gauge`    -- last-write-wins float.
- `Histogram` -- base-2 log-bucketed distribution of positive floats
  (bucket i covers (2^(i-1), 2^i]); tracks count/sum/min/max and answers
  `percentile(q)` with the upper bound of the covering bucket, which for
  latencies is within 2x of the true quantile at ~200 bytes of state.

The module-level default registry (`registry()`, `count()`, `observe()`)
is always on -- an increment is one dict lookup plus a locked int add, a
few hundred nanoseconds, paid on plan/compile/serve *events* (not per
array element), so it needs no enable switch. `snapshot_all()` merges the
default registry and every live named registry (servers register theirs
on construction) into one JSON-safe dict.
"""

from __future__ import annotations

import math
import threading
import weakref
from typing import Any

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "count", "observe", "gauge", "snapshot_all",
           "reset"]


class Counter:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def set(self, v: int) -> None:
        with self._lock:
            self.value = int(v)

    def get(self) -> int:
        return self.value


class Gauge:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def get(self) -> float:
        return self.value


class Histogram:
    """Log-2 bucketed histogram of positive samples (seconds, bytes, ...).

    Bucket keyed by exponent e = ceil(log2(x)): x in (2^(e-1), 2^e].
    Zero/negative samples land in the dedicated underflow bucket (None)."""

    __slots__ = ("name", "buckets", "n", "total", "min", "max", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self.buckets: dict[int | None, int] = {}
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = lock

    def record(self, x: float) -> None:
        key = None if x <= 0.0 else int(math.ceil(math.log2(x)))
        with self._lock:
            self.buckets[key] = self.buckets.get(key, 0) + 1
            self.n += 1
            self.total += x
            self.min = min(self.min, x)
            self.max = max(self.max, x)

    def percentile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile (0 < q <= 1)."""
        with self._lock:
            if self.n == 0:
                return 0.0
            rank = q * self.n
            seen = 0
            for key in sorted(self.buckets,
                              key=lambda k: -math.inf if k is None else k):
                seen += self.buckets[key]
                if seen >= rank:
                    return 0.0 if key is None else min(2.0 ** key, self.max)
            return self.max

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def state(self) -> dict:
        return {"count": self.n, "sum": self.total,
                "min": self.min if self.n else None,
                "max": self.max if self.n else None,
                "mean": self.mean,
                "p50": self.percentile(0.50),
                "p99": self.percentile(0.99),
                "buckets": {("underflow" if k is None else f"le_2^{k}"): v
                            for k, v in sorted(
                                self.buckets.items(),
                                key=lambda kv: (-math.inf
                                                if kv[0] is None
                                                else kv[0]))}}


class MetricsRegistry:
    """Get-or-create instrument registry; one lock covers every mutation
    and the snapshot, making `snapshot()` an atomic consistent cut."""

    def __init__(self, name: str = "default"):
        self.name = name
        self.lock = threading.RLock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self.lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self.lock)
            return c

    def gauge(self, name: str) -> Gauge:
        with self.lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, self.lock)
            return g

    def histogram(self, name: str) -> Histogram:
        with self.lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, self.lock)
            return h

    def count(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def observe(self, name: str, x: float) -> None:
        self.histogram(name).record(x)

    def snapshot(self) -> dict:
        """JSON-safe deep copy taken under the registry lock: atomic with
        respect to every instrument mutation AND any owner state guarded
        by the same lock (ServerStats dict fields)."""
        with self.lock:
            return {
                "counters": {n: c.value
                             for n, c in sorted(self._counters.items())},
                "gauges": {n: g.value
                           for n, g in sorted(self._gauges.items())},
                "histograms": {n: h.state()
                               for n, h in sorted(
                                   self._histograms.items())},
            }

    def reset(self) -> None:
        with self.lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# ---------------------------------------------------------------------------
# Default registry + the live-registry roster
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry("default")
#: every registry constructed through new_registry(), weakly held, so
#: snapshot_all() sees per-server registries exactly as long as they live.
_LIVE: "weakref.WeakSet[MetricsRegistry]" = weakref.WeakSet()
_LIVE.add(_DEFAULT)


def registry() -> MetricsRegistry:
    return _DEFAULT


def new_registry(name: str) -> MetricsRegistry:
    reg = MetricsRegistry(name)
    _LIVE.add(reg)
    return reg


def count(name: str, n: int = 1) -> None:
    _DEFAULT.count(name, n)


def observe(name: str, x: float) -> None:
    _DEFAULT.observe(name, x)


def gauge(name: str, v: float) -> None:
    _DEFAULT.gauge(name).set(v)


def snapshot_all() -> dict[str, Any]:
    """{registry_name: snapshot} over the default + every live registry.
    Registries sharing a name (several servers) get a numeric suffix."""
    out: dict[str, Any] = {}
    for reg in sorted(_LIVE, key=lambda r: (r.name != "default", r.name)):
        key, i = reg.name, 1
        while key in out:
            i += 1
            key = f"{reg.name}#{i}"
        out[key] = reg.snapshot()
    return out


def reset() -> None:
    """Clear the default registry (tests)."""
    _DEFAULT.reset()
