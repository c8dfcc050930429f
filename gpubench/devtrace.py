"""The card's activity in a traced run: a torch.profiler trace of the CUDA
activity alone (kernels, copies, fills), read from its raw events, with the
device's clock tied to the host's perf_counter by marker kernels.

A run opens `DeviceTrace()` around the stretch it traces. On exit, `events`
holds (name, start, end) in perf_counter seconds, so host spans the
benchmark recorded can be laid beside them: which layer a kernel ran for,
and what the host was doing while the card sat idle. Where the trace holds
no device event (the CPU, or a profiler that sees nothing) `events` is
empty and every reading below returns None.

The clocks are tied at the trace's close by MARKERS marker kernels, each
launched on an idle card at a known host time; the one that started
soonest after its launch sets the offset. On an H100 the profiler kept
every closing marker, and they started within 5-60 us of each other. What
runs in a trace's first instants is less sure: the first launch after the
profiler starts waited 0.4-0.6 ms, markers there were lost in half the
traces, and kept ones read up to 0.6 ms apart, so a primer kernel takes
those instants and no marker is placed there. The clocks drift by under
0.25 ppm, some 13 us over a 51 s trace, which is left in.
"""

from __future__ import annotations

import bisect
import sys
import time

import torch

#: spin cycles of a marker kernel (a few microseconds on the card)
_MARKER_CYCLES = 10_000
#: spin cycles of the kernel that opens a trace (about a millisecond)
_PRIMER_CYCLES = 2_000_000
#: a spin kernel shorter than this is a marker, a longer one the primer
_MARKER_MAX_S = 1e-4
#: marker kernels at a trace's close
MARKERS = 4
#: the name of the kernel torch.cuda._sleep launches
MARKER_KERNEL = "spin_kernel"


class DeviceTrace:
    def __init__(self, device: torch.device):
        self.device = device
        self.events: list[tuple[str, float, float]] = []
        self._prof = None

    def __enter__(self) -> "DeviceTrace":
        if self.device.type != "cuda":
            return self
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda._sleep(_PRIMER_CYCLES)
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc) -> None:
        if self._prof is None:
            return
        marks = []
        for _ in range(MARKERS):
            torch.cuda.synchronize(self.device)
            marks.append(time.perf_counter())
            torch.cuda._sleep(_MARKER_CYCLES)
        torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        raw = sorted(
            ((e.name(), e.start_ns(), e.duration_ns())
             for e in self._prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA),
            key=lambda e: e[1])
        self._prof = None
        if raw:
            # seconds from the trace's first event, before any float
            base = raw[0][1]
            raw = [(n, (s - base) * 1e-9, d * 1e-9) for n, s, d in raw]
        self.events = align(raw, marks)
        offs = _offsets(raw, marks)
        print(f"device trace: {len(self.events)} events; closing markers "
              f"started {[round(1e6 * (o - min(offs)), 1) for o in offs]} "
              f"us after the soonest", file=sys.stderr)


def align(raw, marks: list[float]):
    """(name, start, end) in perf_counter seconds of the program's device
    events `raw` ((name, start, duration), sorted by start; seconds on the
    device's clock), given the host launch times of the closing marker
    kernels. The offset is the least of the markers' (device start - host
    launch time). Empty unless the trace kept every closing marker (they
    could not be paired with their launches for sure)."""
    prog = [e for e in raw if not _spin(e[0])]
    offs = _offsets(raw, marks)
    if not prog or len(offs) < len(marks):
        if prog:
            print("device trace: a closing marker was lost; device events "
                  "left unread", file=sys.stderr)
        return []
    off = min(offs)
    return [(n, s - off, s + d - off) for n, s, d in prog]


def _spin(name: str) -> bool:
    return MARKER_KERNEL in name


def _offsets(raw, marks: list[float]) -> list[float]:
    """(device start - host launch time) of each closing marker the trace
    kept: the first len(marks) spins of marker length after the program's
    last event, paired in order; none where it kept fewer."""
    prog = [e for e in raw if not _spin(e[0])]
    if not prog:
        return []
    last = max(s + d for _, s, d in prog)
    starts = [s for n, s, d in raw
              if _spin(n) and d < _MARKER_MAX_S and s > last][:len(marks)]
    if len(starts) < len(marks):
        return []
    return [s - t for s, t in zip(starts, marks)]


def _merged(events, t0: float, t1: float) -> list[tuple[float, float]]:
    """The union of the events' intervals, clipped to [t0, t1]."""
    out: list[list[float]] = []
    for _, s, e in events:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(events, t0: float, t1: float) -> float | None:
    if not events:
        return None
    return sum(e - s for s, e in _merged(events, t0, t1))


def top_ops(events, k: int = 10) -> list[list]:
    """The k device operations that took most time, [name, seconds]."""
    by: dict[str, float] = {}
    for n, s, e in events:
        by[n] = by.get(n, 0.0) + (e - s)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[n[:160], t] for n, t in top]


def idle_gaps(events, t0: float, t1: float, spans, k: int = 10,
              other: str = "harness") -> list[list]:
    """The card's idle time in [t0, t1], summed by the host span (label,
    start, end) that covers the middle of each gap, the latest-starting
    such span; the k largest labels, [label, seconds]."""
    if not events:
        return []
    busy = _merged(events, t0, t1)
    gaps, cursor = [], t0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = e
    if cursor < t1:
        gaps.append((cursor, t1))
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]
    by: dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) / 2
        label = other
        i = bisect.bisect_right(starts, mid) - 1
        # spans of one kind do not overlap; look back over a few kinds
        for j in range(i, max(i - 8, -1), -1):
            if spans[j][1] <= mid <= spans[j][2]:
                label = spans[j][0]
                break
        by[label] = by.get(label, 0.0) + (e - s)
    return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])][:k]


def attribute(events, intervals) -> dict[str, float]:
    """Device seconds of the events whose midpoint lies inside each host
    interval (key, start, end); intervals do not overlap. A midpoint is
    further from an interval's ends than a start is: the tie between the
    clocks is good to some microseconds, and a kernel of an unhooked node
    ends before the next node's synchronized start."""
    intervals = sorted(intervals, key=lambda iv: iv[1])
    starts = [iv[1] for iv in intervals]
    out: dict[str, float] = {}
    for n, s, e in events:
        i = bisect.bisect_right(starts, (s + e) / 2) - 1
        if i >= 0 and (s + e) / 2 <= intervals[i][2]:
            key = intervals[i][0]
            out[key] = out.get(key, 0.0) + (e - s)
    return out
