"""The Profiler: wires tracing + metrics through the serving hot path.

`enable()` installs the global tracer (repro_torch.obs.trace) and a
`Profiler` that `runtime/serve.py` and `NetworkPlan.apply` consult via
`active()` -- one global read per hook and batch, scheduler-loop
iteration or apply call, None when profiling is off, so the disabled
serve path and graph walk record nothing (tested). compile()'s pass
phases (core/compile.py) report through the same global tracer directly,
so enabling the profiler lights up compile -> serve in one trace.

Per-request decomposition (`serve_batch`): the server hands over the
batch's boundary timestamps -- submit (per ticket), batch selection,
dispatch start/end, finish (per ticket). The profiler turns those into
spans:

    serve.queue_wait        submit -> batch selection        (per request)
    serve.batch_formation   selection -> dispatch start      (per request)
    serve.dispatch          dispatch start -> end            (per batch)
    serve.respond           dispatch end -> ticket finish    (per request)

Those four intervals tile [submit, finish] exactly (same perf_counter
clock, shared boundaries), so per request they sum to the measured
latency -- the contract tests/test_torch_obs.py asserts.

The server and the graph walk record the rest through the same tracer
while `active()` is not None: the scheduler loop's `serve.idle` (an empty
queue) and `serve.coalesce` (the batch_wait_s wait), the batch's
`serve.stack` (inside batch formation), `serve.copy_in` and
`serve.replay` with its `gpu:serve.replay` device time (inside dispatch),
and NetworkPlan.apply's `layer:<node_id>` with `gpu:layer:<node_id>` for
every graph node it walks (core/compile.py). A CUDA-graph replay walks
nothing, so its dispatch holds no layer spans.

Latency/queue-wait/dispatch histograms go to the default metrics
registry under `serve.*`.
"""

from __future__ import annotations

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = ["Profiler", "enable", "disable", "active", "is_enabled"]


class Profiler:
    """Span + histogram emission for one process; see module docstring."""

    def __init__(self, tracer: _trace.Tracer,
                 registry: _metrics.MetricsRegistry | None = None):
        self.tracer = tracer
        self.registry = registry or _metrics.registry()

    # ---- the serve hot path ----------------------------------------------

    def serve_batch(self, *, bucket: int, batch: list,
                    t_select: float, t0: float, t1: float,
                    jitted: bool, sharded: bool = False) -> None:
        """Record one dispatched batch. `batch` is the ticket list
        (rid / submitted_at / finished_at), `t_select` the batch-selection
        stamp from the scheduler loop, [t0, t1] the dispatch interval."""
        tr, reg = self.tracer, self.registry
        tr.add_span("serve.dispatch", t0, t1, bucket=bucket,
                    batch=len(batch), jitted=jitted, sharded=sharded)
        reg.observe("serve.dispatch_s", t1 - t0)
        for t in batch:
            rid = t.rid
            tr.add_span("serve.queue_wait", t.submitted_at, t_select,
                        rid=rid, bucket=bucket)
            tr.add_span("serve.batch_formation", t_select, t0,
                        rid=rid, bucket=bucket)
            reg.observe("serve.queue_wait_s", t_select - t.submitted_at)
            fin = t.finished_at
            if fin is not None:
                tr.add_span("serve.respond", t1, fin, rid=rid,
                            bucket=bucket)
                reg.observe("serve.latency_s", fin - t.submitted_at)

    def serve_batch_error(self, *, bucket: int, batch: list,
                          error: BaseException) -> None:
        self.tracer.instant("serve.batch_error", bucket=bucket,
                            batch=len(batch), error=repr(error))
        self.registry.count("serve.batch_errors")


# ---------------------------------------------------------------------------
# Global profiler: disabled (None) by default
# ---------------------------------------------------------------------------

_PROFILER: Profiler | None = None


def enable(capacity: int = _trace.DEFAULT_CAPACITY,
           registry: _metrics.MetricsRegistry | None = None) -> Profiler:
    """Turn on profiling: installs the global tracer (lighting up the
    compile/plan spans too) and the serve-path profiler, and ties the
    current card's clock to the host's for device spans (a synchronize;
    nothing on the CPU)."""
    global _PROFILER
    tracer = _trace.enable(capacity)
    tracer.anchor_device()
    if _PROFILER is None or _PROFILER.tracer is not tracer:
        _PROFILER = Profiler(tracer, registry)
    return _PROFILER


def disable(tracing: bool = True) -> None:
    """Turn the profiler off; `tracing=False` keeps the tracer (and its
    recorded spans) alive for inspection/export."""
    global _PROFILER
    _PROFILER = None
    if tracing:
        _trace.disable()


def active() -> Profiler | None:
    """The serve path's single disabled-check: None when profiling is off."""
    return _PROFILER


def is_enabled() -> bool:
    return _PROFILER is not None
