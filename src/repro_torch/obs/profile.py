"""The Profiler: wires tracing + metrics through the serving hot path.

`enable()` installs the global tracer (repro_torch.obs.trace) and a
`Profiler` that `runtime/serve.py` consults via `active()` -- one global
read per batch, None when profiling is off, so the disabled serve path
records nothing (tested). compile()'s pass phases (core/compile.py)
report through the same global tracer directly, so enabling the profiler
lights up compile -> serve in one trace.

Per-request decomposition (`serve_batch`): the server hands over the
batch's boundary timestamps -- submit (per ticket), batch selection,
dispatch start/end, finish (per ticket) -- plus the per-layer wall times
that `NetworkPlan.apply(layer_hook=)` measured on the eager supervised
path. The profiler turns those into spans:

    serve.queue_wait        submit -> batch selection        (per request)
    serve.batch_formation   selection -> dispatch start      (per request)
    serve.dispatch          dispatch start -> end            (per batch)
      layer:<node_id>         sequential children, one per planned layer,
                              tagged with the executing plan's executor
    serve.respond           dispatch end -> ticket finish    (per request)

Those four intervals tile [submit, finish] exactly (same perf_counter
clock, shared boundaries), so per request they sum to the measured
latency -- the contract tests/test_torch_obs.py asserts. Layer spans
exist only when the eager supervised path ran; the graph-dispatch happy
path (a CUDA-graph replay of the whole forward on the card) cannot
observe layer boundaries inside the replay, so its dispatch span stands
alone (`jitted=True`, the reference's name for that path).

Latency/queue-wait/dispatch histograms go to the default metrics
registry under `serve.*`.
"""

from __future__ import annotations

from typing import Any

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = ["Profiler", "enable", "disable", "active", "is_enabled"]


def _executor_of(plan: Any) -> str:
    """Best-effort executor label for a bound layer plan."""
    try:
        return str(plan.describe().get("executor", type(plan).__name__))
    except Exception:
        return type(plan).__name__


class Profiler:
    """Span + histogram emission for one process; see module docstring."""

    def __init__(self, tracer: _trace.Tracer,
                 registry: _metrics.MetricsRegistry | None = None):
        self.tracer = tracer
        self.registry = registry or _metrics.registry()

    # ---- the serve hot path ----------------------------------------------

    def serve_batch(self, *, bucket: int, batch: list, net: Any,
                    t_select: float, t0: float, t1: float,
                    layer_times: dict[str, float],
                    jitted: bool, sharded: bool = False) -> None:
        """Record one dispatched batch. `batch` is the ticket list
        (rid / submitted_at / finished_at), `t_select` the batch-selection
        stamp from the scheduler loop, [t0, t1] the dispatch interval,
        `layer_times` the per-node wall seconds from layer_hook (empty on
        the graph-dispatch path)."""
        tr, reg = self.tracer, self.registry
        tr.add_span("serve.dispatch", t0, t1, bucket=bucket,
                    batch=len(batch), jitted=jitted, sharded=sharded)
        reg.observe("serve.dispatch_s", t1 - t0)
        # Layer children: apply() runs nodes sequentially and the hook
        # fires with each node's own wall time, so laying the durations
        # end-to-end from t0 reconstructs starts to within the (un-hooked)
        # pad/pool/add glue between planned layers.
        cursor = t0
        for nid, dt in layer_times.items():
            plan = net.plans.get(nid) if net is not None else None
            tr.add_span(f"layer:{nid}", cursor, cursor + dt,
                        executor=_executor_of(plan))
            reg.observe("serve.layer_s", dt)
            cursor += dt
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
    compile/plan spans too) and the serve-path profiler."""
    global _PROFILER
    tracer = _trace.enable(capacity)
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
