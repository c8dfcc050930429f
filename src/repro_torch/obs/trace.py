"""Thread-safe span tracing with chrome://tracing export. Stdlib only.

A `Tracer` records completed spans -- (name, t0, t1, thread, depth, args)
over `time.perf_counter()` timestamps -- into a bounded ring buffer
(oldest spans drop first; `dropped` counts them). Spans come from four
sources:

- `tracer.span(name, **args)`: a context manager; nesting depth is
  tracked per thread so exporters can reconstruct the call tree even for
  zero-duration spans.
- `tracer.device_span(name, **args)`: the device time of the work the
  span enqueues on the current CUDA stream, from two timing events
  recorded at entry and exit, recorded as `gpu:<name>` once its end
  event completes (nothing synchronizes for it). `tracer.twin_span`
  opens a host span and, on the card, its `gpu:` twin;
  `tracer.device_chain()` holds a sequence of such spans that share
  their boundary events (one event per boundary: the graph walk's).
- `tracer.add_span(name, t0, t1, **args)`: explicit timestamps, for code
  that already measured an interval (the serving runtime's per-request
  spans share the scheduler's stamps).
- `tracer.instant(name, **args)`: a point event (cache hits, autotune
  decisions).

Device spans are tied to the host clock by an anchor event per card,
recorded on an idle card just after a synchronize (`anchor_device()`,
which `obs.profile.enable()` calls): the soonest-stamped of ANCHORS
such events maps device time to perf_counter time, so `gpu:` spans and
host spans lie on one clock. A device span records nothing on the CPU
(no card initialized in the process) or while the current stream is
capturing a CUDA graph, so no event is ever baked into a graph.
`spans()` resolves every pending device span first, waiting for its end
event where it must.

The module-level API (`enable()` / `disable()` / `span()` / ...) routes
through one global tracer. Disabled -- the default -- every hook is a
single `is None` check and `span()` returns a shared no-op context
manager, so instrumented hot paths pay (provably, see
tests/test_obs.py::test_serve_disabled_emits_zero_spans) nothing.

`export_chrome()` emits the chrome://tracing / Perfetto "traceEvents"
JSON: "X" complete events (ts/dur in microseconds from the first span,
whose perf_counter time `otherData.epoch_perf_counter_s` records, so a
device trace on the same clock overlays it) plus "i" instants, one row
per python thread and one per card for the `gpu:` spans. Load the file
at chrome://tracing or https://ui.perfetto.dev.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Iterator

__all__ = ["Span", "Tracer", "enable", "disable", "get", "is_enabled",
           "span", "add_span", "instant", "export_chrome", "NULL_SPAN"]

DEFAULT_CAPACITY = 65536
#: anchor events recorded per card; the soonest-stamped one ties the clocks
ANCHORS = 4
#: the prefix of a device span's name
DEVICE_PREFIX = "gpu:"
#: chrome export: card d's device spans go on the track of this tid less d
DEVICE_TRACK_TID = 2**31 - 1


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


def _cuda():
    """torch.cuda where this process has initialized a card, else None.
    The tracer imports no torch of its own: without torch loaded no work
    can have been enqueued on a card."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda


def soonest_anchor(marks: list) -> tuple:
    """The (event, host time) of `marks`, each recorded on an idle card
    just after a synchronize, that the device stamped soonest after its
    host time: the least (device time - host time), both measured from
    the first mark."""
    e0, t0 = marks[0]
    return min(marks, key=lambda m: e0.elapsed_time(m[0]) * 1e-3
               - (m[1] - t0))


def host_time(anchor: tuple, event) -> float:
    """The perf_counter time at which the device stamped `event`, from the
    anchor (event, host time) of the same card."""
    a_ev, a_t = anchor
    return a_t + a_ev.elapsed_time(event) * 1e-3


class _ChainSpan:
    """One span of a DeviceChain: a host span (where `host`) and, on the
    card, its `gpu:` twin between two of the chain's boundary events."""

    __slots__ = ("_chain", "_name", "_args", "_host", "_i0", "_closed",
                 "_depth")

    def __init__(self, chain: "DeviceChain", name: str, args: dict,
                 host: bool):
        self._chain = chain
        self._name = name
        # the args go on the host span where there is one, else on gpu:
        self._host = _SpanCtx(chain.tracer, name, args) if host else None
        self._args = {} if host else args

    def __enter__(self) -> "_ChainSpan":
        if self._host is not None:
            self._host.__enter__()
        ch = self._chain
        if ch.stream is not None:
            self._depth = ch.tracer._depth()
            self._i0 = ch.last if ch.last is not None else ch.mark()
            self._closed = ch.closed
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        ch = self._chain
        if ch.stream is not None:
            # a span whose children closed ends where the last one did
            i1 = ch.last if ch.closed > self._closed else ch.mark()
            ch.spans.append((DEVICE_PREFIX + self._name, self._i0, i1,
                             threading.get_ident(), self._depth,
                             self._args))
            ch.closed += 1
        if self._host is not None:
            return self._host.__exit__(exc_type, exc, tb)
        return False


class DeviceChain:
    """Device spans on one stream that share their boundary events: a
    span starts at the chain's last event and records one event where it
    ends, and a span whose children closed ends at the last child's end.
    So one event is recorded per boundary, siblings tile, and each event's
    own device time falls on one side of it. The chain's owner enqueues
    device work only inside spans without child spans (the graph walk:
    every node and every inverted-residual step). Inert -- host spans
    only -- on the CPU or while the stream captures. Pended on exit and
    resolved like any device span (Tracer.spans)."""

    __slots__ = ("tracer", "stream", "events", "spans", "last", "closed")

    def __init__(self, tracer: "Tracer", stream):
        self.tracer = tracer
        self.stream = stream
        self.events: list = []     # timing events, in the order recorded
        self.spans: list = []      # (name, i0, i1, tid, depth, args)
        self.last: int | None = None
        self.closed = 0

    def mark(self) -> int:
        """Record one timing event now on the chain's stream; its index."""
        ev = self.tracer._event()
        ev.record(self.stream)
        self.events.append(ev)
        self.last = len(self.events) - 1
        return self.last

    def span(self, name: str, **args: Any) -> _ChainSpan:
        """A host span `name` and, on the card, its `gpu:` twin."""
        return _ChainSpan(self, name, args, host=True)

    def device_span(self, name: str, **args: Any) -> _ChainSpan:
        """The `gpu:` span alone."""
        return _ChainSpan(self, name, args, host=False)

    def __enter__(self) -> "DeviceChain":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self.spans:
            self.tracer._pend(self)
        return False


class _OneSpan:
    """A span in a chain of its own, pended when it closes."""

    __slots__ = ("_chain", "_span")

    def __init__(self, chain: DeviceChain, span: _ChainSpan):
        self._chain = chain
        self._span = span

    def __enter__(self) -> "_OneSpan":
        self._span.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        out = self._span.__exit__(exc_type, exc, tb)
        self._chain.__exit__(exc_type, exc, tb)
        return out


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
        self._pending: deque[DeviceChain] = deque()
        self._anchors: dict[int, tuple] = {}    # card -> (event, host time)
        self._free_events: list = []            # resolved, for reuse

    # ---- recording -------------------------------------------------------

    def span(self, name: str, **args: Any) -> _SpanCtx:
        return _SpanCtx(self, name, args)

    def device_chain(self, on_card: bool = True) -> DeviceChain:
        """A chain of device spans sharing their boundary events on the
        current stream (see DeviceChain); inert unless `on_card` and a card
        is initialized, and while the current stream is capturing. A
        card's first chain takes its anchor first."""
        cuda = _cuda() if on_card else None
        if cuda is None or cuda.is_current_stream_capturing():
            return DeviceChain(self, None)
        stream = cuda.current_stream()
        if stream.device_index not in self._anchors:
            self.anchor_device()
        return DeviceChain(self, stream)

    def device_span(self, name: str, **args: Any) -> _OneSpan:
        """The device time of the work enqueued inside the span on the
        current stream, recorded as `gpu:<name>` on the host clock once
        its end event completes. Records nothing on the CPU or while the
        current stream is capturing."""
        chain = self.device_chain()
        return _OneSpan(chain, chain.device_span(name, **args))

    def twin_span(self, name: str, on_card: bool, **args: Any) -> _OneSpan:
        """A host span `name` and, when `on_card`, its `gpu:` twin."""
        chain = self.device_chain(on_card)
        return _OneSpan(chain, chain.span(name, **args))

    def anchor_device(self) -> None:
        """Tie the current card's clock to the host's (see the module
        docstring): synchronizes the card. A no-op on the CPU and while
        the current stream is capturing."""
        cuda = _cuda()
        if cuda is None or cuda.is_current_stream_capturing():
            return
        stream = cuda.current_stream()
        events = [cuda.Event(enable_timing=True) for _ in range(ANCHORS)]
        for ev in events:
            ev.record(stream)       # the event exists before its timed record
        marks = []
        for ev in events:
            cuda.synchronize()
            t = time.perf_counter()
            ev.record(stream)
            marks.append((ev, t))
        cuda.synchronize()
        with self._lock:
            self._anchors[stream.device_index] = soonest_anchor(marks)

    def _event(self):
        """A timing event: a resolved chain's, or a new one."""
        with self._lock:
            if self._free_events:
                return self._free_events.pop()
        return _cuda().Event(enable_timing=True)

    def _pend(self, chain: DeviceChain) -> None:
        with self._lock:
            self._pending.append(chain)
        self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        """Record the spans of the pending chains whose last event has
        completed, oldest first; with `wait`, of every one, waiting for
        each last event."""
        with self._lock:
            if wait:
                done = list(self._pending)
                self._pending.clear()
            else:
                done = []
                while (self._pending
                       and self._pending[0].events[-1].query()):
                    done.append(self._pending.popleft())
            anchors = dict(self._anchors)
        for ch in done:
            if wait:
                ch.events[-1].synchronize()   # outside the lock
            device = ch.stream.device_index
            a = anchors[device]
            t = [host_time(a, ev) for ev in ch.events]
            for name, i0, i1, tid, depth, args in ch.spans:
                self._record(Span(name, t[i0], t[i1], tid, depth,
                                  dict(args, device=device)))
        if done:
            with self._lock:
                for ch in done:
                    self._free_events += ch.events

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
        """Chronological (by start time) copy, optionally name-filtered;
        every pending device span is resolved first."""
        if self._pending:
            self._resolve(wait=True)
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
            self._pending.clear()
            self._recorded = 0

    # ---- chrome://tracing export -----------------------------------------

    def export_chrome(self, path: str | None = None) -> dict:
        """The trace as a chrome://tracing JSON object; optionally written
        to `path`. Timestamps count from the earliest span, whose
        perf_counter time `otherData.epoch_perf_counter_s` keeps; all
        times are microseconds per the trace-event spec. `gpu:` spans go
        on one track per card."""
        spans = self.spans()
        epoch = spans[0].t0 if spans else 0.0
        pid = os.getpid()
        events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": "repro"}}]
        cards = set()
        for s in spans:
            tid = s.tid
            if s.name.startswith(DEVICE_PREFIX):
                card = s.args.get("device", 0)
                cards.add(card)
                tid = DEVICE_TRACK_TID - card
            ev = {"name": s.name, "ph": s.phase, "pid": pid, "tid": tid,
                  "ts": (s.t0 - epoch) * 1e6, "args": dict(s.args)}
            if s.phase == "X":
                ev["dur"] = (s.t1 - s.t0) * 1e6
            else:
                ev["s"] = "t"                       # thread-scoped instant
            ev["args"]["depth"] = s.depth
            events.append(ev)
        events[1:1] = [{"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": DEVICE_TRACK_TID - card,
                        "args": {"name": f"card {card} (device time)"}}
                       for card in sorted(cards)]
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"dropped_spans": self.dropped,
                             "epoch_perf_counter_s": epoch}}
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
