"""Thread-safe span tracing with chrome://tracing export. Stdlib only.

A `Tracer` records completed spans -- (name, t0, t1, thread, depth, args)
over `time.perf_counter()` timestamps -- into a bounded ring buffer
(oldest spans drop first; `dropped` counts them). Spans come from three
sources:

- `tracer.span(name, **args)`: a context manager; nesting depth is
  tracked per thread so exporters can reconstruct the call tree even for
  zero-duration spans.
- `tracer.add_span(name, t0, t1, **args)`: explicit timestamps, for code
  that already measured an interval (the serving runtime reconstructs
  per-layer spans from `NetworkPlan.apply(layer_hook=)` durations).
- `tracer.instant(name, **args)`: a point event (cache hits, autotune
  decisions).

The module-level API (`enable()` / `disable()` / `span()` / ...) routes
through one global tracer. Disabled -- the default -- every hook is a
single `is None` check and `span()` returns a shared no-op context
manager, so instrumented hot paths pay (provably, see
tests/test_obs.py::test_serve_disabled_emits_zero_spans) nothing.

`export_chrome()` emits the chrome://tracing / Perfetto "traceEvents"
JSON: "X" complete events (ts/dur in microseconds, rebased to the first
span) plus "i" instants, one row per python thread. Load the file at
chrome://tracing or https://ui.perfetto.dev.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Iterator

__all__ = ["Span", "Tracer", "enable", "disable", "get", "is_enabled",
           "span", "add_span", "instant", "export_chrome", "NULL_SPAN"]

DEFAULT_CAPACITY = 65536


class Span:
    """One completed (or instant: t1 == t0) trace event."""

    __slots__ = ("name", "t0", "t1", "tid", "depth", "args", "phase")

    def __init__(self, name: str, t0: float, t1: float, tid: int,
                 depth: int = 0, args: dict | None = None,
                 phase: str = "X"):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.tid = tid
        self.depth = depth
        self.args = args or {}
        self.phase = phase                 # "X" complete | "i" instant

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:            # pragma: no cover - debug aid
        return (f"Span({self.name!r}, dur={self.duration_s * 1e3:.3f}ms, "
                f"depth={self.depth}, args={self.args})")


class _SpanCtx:
    """Context manager recording one nested span on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_SpanCtx":
        self._depth = self._tracer._push()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        self._tracer._pop()
        if exc_type is not None:
            self._args = dict(self._args, error=repr(exc))
        self._tracer._record(Span(self._name, self._t0, t1,
                                  threading.get_ident(), self._depth,
                                  self._args))
        return False

    def set(self, **args: Any) -> None:
        """Attach args discovered mid-span (e.g. the autotune winner)."""
        self._args = dict(self._args, **args)


class _NullSpan:
    """The disabled-path span: no state, no timestamps, shared instance."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **args: Any) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Ring-buffered span recorder; every method is thread-safe."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: deque[Span] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._recorded = 0

    # ---- recording -------------------------------------------------------

    def span(self, name: str, **args: Any) -> _SpanCtx:
        return _SpanCtx(self, name, args)

    def add_span(self, name: str, t0: float, t1: float,
                 tid: int | None = None, **args: Any) -> None:
        """Record an interval measured elsewhere (perf_counter stamps)."""
        self._record(Span(name, t0, t1,
                          tid if tid is not None else threading.get_ident(),
                          self._depth(), args))

    def instant(self, name: str, **args: Any) -> None:
        t = time.perf_counter()
        self._record(Span(name, t, t, threading.get_ident(),
                          self._depth(), args, phase="i"))

    def _record(self, s: Span) -> None:
        with self._lock:
            self._buf.append(s)       # deque(maxlen=) drops oldest itself
            self._recorded += 1

    # ---- per-thread nesting depth ----------------------------------------

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def _push(self) -> int:
        d = getattr(self._local, "depth", 0)
        self._local.depth = d + 1
        return d

    def _pop(self) -> None:
        self._local.depth = max(0, getattr(self._local, "depth", 1) - 1)

    # ---- reading ---------------------------------------------------------

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._recorded - len(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def spans(self, prefix: str | None = None) -> list[Span]:
        """Chronological (by start time) copy, optionally name-filtered."""
        with self._lock:
            out = list(self._buf)
        if prefix is not None:
            out = [s for s in out if s.name.startswith(prefix)]
        out.sort(key=lambda s: s.t0)
        return out

    def __iter__(self) -> Iterator[Span]:
        return iter(self.spans())

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._recorded = 0

    # ---- chrome://tracing export -----------------------------------------

    def export_chrome(self, path: str | None = None) -> dict:
        """The trace as a chrome://tracing JSON object; optionally written
        to `path`. Timestamps rebase to the earliest span so ts starts
        near 0; all times are microseconds per the trace-event spec."""
        spans = self.spans()
        epoch = spans[0].t0 if spans else 0.0
        pid = os.getpid()
        events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": "repro"}}]
        for s in spans:
            ev = {"name": s.name, "ph": s.phase, "pid": pid, "tid": s.tid,
                  "ts": (s.t0 - epoch) * 1e6, "args": dict(s.args)}
            if s.phase == "X":
                ev["dur"] = (s.t1 - s.t0) * 1e6
            else:
                ev["s"] = "t"                       # thread-scoped instant
            ev["args"]["depth"] = s.depth
            events.append(ev)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"dropped_spans": self.dropped}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


# ---------------------------------------------------------------------------
# The global tracer: disabled (None) by default
# ---------------------------------------------------------------------------

_TRACER: Tracer | None = None


def enable(capacity: int = DEFAULT_CAPACITY) -> Tracer:
    """Install (or return the existing) global tracer."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer(capacity)
    return _TRACER


def disable() -> None:
    global _TRACER
    _TRACER = None


def get() -> Tracer | None:
    return _TRACER


def is_enabled() -> bool:
    return _TRACER is not None


def span(name: str, **args: Any):
    """`with trace.span("compile.place"): ...` -- no-op when disabled."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, **args)


def add_span(name: str, t0: float, t1: float, **args: Any) -> None:
    t = _TRACER
    if t is not None:
        t.add_span(name, t0, t1, **args)


def instant(name: str, **args: Any) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, **args)


def export_chrome(path: str | None = None) -> dict:
    t = _TRACER
    if t is None:
        raise RuntimeError("tracing is disabled; call "
                           "repro_torch.obs.trace.enable() before exporting")
    return t.export_chrome(path)
