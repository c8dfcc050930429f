"""The port's observability (repro_torch.obs) on the CPU: the tracer's ring
buffer, nesting and chrome export, the metrics histogram and atomic
snapshots, the server's stats registry, the serve-path profiler's
disabled path and per-request decomposition, per-layer spans on
MobileNet-v2, compile()'s pass spans, and the verify-artifacts CLI -- the
JAX package's tests/test_obs.py cases, against the port's copies."""

import json
import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.core import compile as C
from repro_torch.core import plan as pt_plan
from repro_torch.models import cnn
from repro_torch.obs import metrics, profile, trace
from repro_torch.runtime import inject
from repro_torch.runtime import serve as serve_mod
from repro_torch.runtime.serve import ServeConfig, Server

RES = 16
SPECS = [cnn.Conv("c1", 3, 3, 8), cnn.Conv("c2", 3, 3, 8, relu=False)]


@pytest.fixture(autouse=True)
def _obs_clean_slate():
    """Global observability state (tracer, profiler, default metrics) must
    not leak between tests."""
    profile.disable()
    metrics.reset()
    pt_plan.clear_plan_cache()
    yield
    profile.disable()
    metrics.reset()
    pt_plan.clear_plan_cache()


@pytest.fixture
def params():
    return cnn.init_cnn(torch.Generator().manual_seed(0), SPECS, 3, res=RES,
                        device="cpu")


@pytest.fixture
def xs(rng):
    return [rng.standard_normal((RES, RES, 3)).astype(np.float32)
            for _ in range(4)]


def make_cfg(**kw):
    base = dict(buckets=(1, 2), queue_capacity=16, verbose=False,
                jit_dispatch=False, backoff_base_s=0.002,
                backoff_cap_s=0.01)
    base.update(kw)
    return ServeConfig(**base)


def serve_n(srv, xs, n):
    tickets = []
    for i in range(n):
        t = srv.submit(xs[i % len(xs)])
        t.result(timeout=60)
        tickets.append(t)
    return tickets


def server(params, specs=SPECS, res=RES, **kw):
    return Server(params, specs, res=res, device="cpu", **kw)


# ---------------------------------------------------------------------------
# trace: ring buffer, nesting, chrome export
# ---------------------------------------------------------------------------

def test_tracer_ring_capacity_and_dropped():
    tr = trace.Tracer(capacity=4)
    for i in range(10):
        tr.add_span(f"s{i}", float(i), float(i) + 0.5)
    assert len(tr) == 4
    assert tr.dropped == 6
    # oldest dropped first: only s6..s9 survive
    assert [s.name for s in tr.spans()] == ["s6", "s7", "s8", "s9"]
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0


def test_span_nesting_depth_and_error_capture():
    tr = trace.Tracer()
    with tr.span("outer"):
        with tr.span("inner") as sp:
            sp.set(detail=7)
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("x")
    by_name = {s.name: s for s in tr.spans()}
    assert by_name["outer"].depth == 0
    assert by_name["inner"].depth == 1
    assert by_name["inner"].args["detail"] == 7
    assert "ValueError" in by_name["boom"].args["error"]
    # depth unwound: a fresh span is top-level again
    with tr.span("later"):
        pass
    assert {s.name: s.depth for s in tr.spans()}["later"] == 0


def test_chrome_export_is_valid_and_rebased(tmp_path):
    tr = trace.Tracer()
    with tr.span("a"):
        time.sleep(0.001)
    tr.instant("mark", k=1)
    path = str(tmp_path / "trace.json")
    doc = tr.export_chrome(path)
    with open(path) as f:
        assert json.load(f) == doc          # file round-trips
    events = doc["traceEvents"]
    assert events[0]["ph"] == "M"           # process-name metadata
    xs = [e for e in events if e["ph"] == "X"]
    ins = [e for e in events if e["ph"] == "i"]
    assert len(xs) == 1 and len(ins) == 1
    assert xs[0]["dur"] > 0
    assert all(e["ts"] >= 0 for e in xs + ins)   # rebased to first span
    assert min(e["ts"] for e in xs + ins) == 0
    assert doc["otherData"]["dropped_spans"] == 0


def test_disabled_module_api_is_noop():
    trace.disable()
    assert trace.span("x") is trace.NULL_SPAN
    trace.add_span("x", 0.0, 1.0)            # no-ops, no error
    trace.instant("x")
    assert trace.get() is None and not trace.is_enabled()
    with pytest.raises(RuntimeError, match="disabled"):
        trace.export_chrome()
    tr = trace.enable(capacity=8)
    assert trace.enable() is tr              # enable() reuses the tracer
    trace.disable()


# ---------------------------------------------------------------------------
# metrics: histogram semantics + atomic snapshots
# ---------------------------------------------------------------------------

def test_histogram_percentiles_within_bucket_bound():
    reg = metrics.MetricsRegistry("t")
    h = reg.histogram("lat")
    samples = [0.001 * (i + 1) for i in range(100)]
    for s in samples:
        h.record(s)
    true_p50 = float(np.percentile(samples, 50))
    assert true_p50 <= h.percentile(0.5) <= 2 * true_p50
    assert h.percentile(0.99) <= h.max
    st = h.state()
    assert st["count"] == 100
    assert st["min"] == samples[0] and st["max"] == samples[-1]
    assert sum(st["buckets"].values()) == 100
    h.record(0.0)                            # underflow bucket
    assert h.state()["buckets"]["underflow"] == 1


def test_metrics_snapshot_is_atomic_under_hammer():
    """Two counters incremented together under the registry lock must
    never be observed torn by snapshot()."""
    reg = metrics.MetricsRegistry("t")
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            with reg.lock:
                reg.count("a")
                reg.count("b")

    threads = [threading.Thread(target=writer) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for _ in range(300):
            snap = reg.snapshot()["counters"]
            assert snap.get("a", 0) == snap.get("b", 0), snap
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


def test_snapshot_all_merges_live_server_registries(params):
    srv = server(params, config=make_cfg())
    try:
        merged = metrics.snapshot_all()
        assert "default" in merged
        serve_regs = [k for k in merged if k.startswith("serve")]
        assert serve_regs, merged.keys()
        assert "serve.admitted" in merged[serve_regs[0]]["counters"]
    finally:
        srv.stop()


def test_stats_snapshot_race_stress(params, xs):
    """Hammer snapshot()/in_flight from reader threads while traffic runs:
    no RuntimeError (dict resized during iteration), and every cut is
    internally consistent (in_flight identity holds, never negative)."""
    errors: list[BaseException] = []
    snaps: list[dict] = []
    stop = threading.Event()

    with server(params, config=make_cfg()) as srv:
        def reader():
            try:
                while not stop.is_set():
                    s = srv.stats.snapshot()
                    assert s["in_flight"] == (
                        s["admitted"] - s["completed"] - s["timed_out"]
                        - s["cancelled"] - s["failed"])
                    assert s["in_flight"] >= 0, s
                    assert srv.stats.in_flight >= 0
                    snaps.append(s)
            except BaseException as e:      # noqa: BLE001 - reraised below
                errors.append(e)

        readers = [threading.Thread(target=reader) for _ in range(3)]
        for t in readers:
            t.start()
        try:
            serve_n(srv, xs, 24)
        finally:
            stop.set()
            for t in readers:
                t.join(timeout=10)
    assert not errors, errors[0]
    assert len(snaps) > 50
    final = srv.stats.snapshot()
    assert final["completed"] == 24 and final["in_flight"] == 0
    assert srv.stats.completed == 24
    assert sum(final["bucket_batches"].values()) == final["batches"]


# ---------------------------------------------------------------------------
# profiler: disabled path, per-request decomposition, per-layer spans
# ---------------------------------------------------------------------------

def test_serve_disabled_emits_zero_spans(params, xs):
    """Tracer installed but profiler off: the serve dispatch path records
    NOTHING (the hot path's only obs cost is one `active()` read)."""
    with server(params, config=make_cfg()) as srv:
        tr = trace.enable()                  # after compile, before traffic
        tr.clear()
        serve_n(srv, xs, 6)
        assert trace.get().spans() == []
    trace.disable()


def _spans_by_rid(tracer):
    out: dict[int, dict[str, trace.Span]] = {}
    for s in tracer.spans():
        rid = s.args.get("rid")
        if rid is not None:
            out.setdefault(rid, {})[s.name] = s
    return out


@pytest.mark.parametrize("jit_dispatch", [False, True])
def test_decomposition_sums_to_measured_latency(params, xs, jit_dispatch):
    """queue_wait + batch_formation + dispatch + respond tile
    [submit, finish]: per request the spans sum to the independently
    measured ticket latency, on the eager supervised path and on the
    graph-dispatch path. The walk's layer spans lie inside a dispatch
    (on the CPU the graph path's replay is the eager walk, inside its
    serve.replay span)."""
    with server(params, config=make_cfg(jit_dispatch=jit_dispatch)) as srv:
        serve_n(srv, xs, 2)
        profile.enable()
        tickets = serve_n(srv, xs, 6)
        _wait_for_respond_spans(6)
        tr = trace.get()
        by_rid = _spans_by_rid(tr)
        dispatches = tr.spans("serve.dispatch")
        replays = tr.spans("serve.replay")
        layers = tr.spans("layer:")
    assert all(d.args["jitted"] == jit_dispatch for d in dispatches)
    assert len(replays) == (len(dispatches) if jit_dispatch else 0)
    assert layers
    for s in layers:
        assert any(_inside(s, d) for d in (replays if jit_dispatch
                                           else dispatches)), s
    for t in tickets:
        parts = by_rid[t.rid]
        qw = parts["serve.queue_wait"]
        bf = parts["serve.batch_formation"]
        rp = parts["serve.respond"]
        d = next(d for d in dispatches
                 if abs(d.t0 - bf.t1) < 1e-9)       # its batch's dispatch
        total = (qw.duration_s + bf.duration_s + d.duration_s
                 + rp.duration_s)
        assert abs(total - t.latency_s) <= 1e-6 + 1e-3 * t.latency_s, \
            (total, t.latency_s)
        # the boundaries are shared stamps, not re-measured
        assert qw.t0 == t.submitted_at and rp.t1 == t.finished_at
    profile.disable()


def _inside(s, outer) -> bool:
    return outer.t0 <= s.t0 and s.t1 <= outer.t1


def _wait_for_respond_spans(n: int, timeout_s: float = 60.0) -> None:
    """A ticket finishes before the scheduler records its batch's spans
    (the dispatch span first, the respond spans last): wait for n respond
    spans before reading them."""
    deadline = time.perf_counter() + timeout_s
    while (len(trace.get().spans("serve.respond")) < n
           and time.perf_counter() < deadline):
        time.sleep(0.001)


def _node_spans(tracer):
    """The walk's layer:<nid> spans (not an inverted residual's steps)."""
    return [s for s in tracer.spans("layer:") if "/" not in s.name]


def test_layer_spans_match_plan_node_ids_mbv2():
    """On MobileNet-v2, the walk's layer:<nid> spans of one request name
    every graph node in execution order: the planned nodes tagged with
    each plan's executor, the others with their op -- and after a
    re-placement the NEXT request's spans show the new executor."""
    res = 32
    specs = cnn.mobilenet_v2()
    params = cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                          res=res, device="cpu")
    x = np.zeros((res, res, 3), np.float32)
    with server(params, specs, res=res, algorithm="pallas_winograd",
                config=make_cfg(buckets=(1,))) as srv:
        net = srv.nets[1]
        want = [n.id for n in net.graph[1:]]
        ops = {n.id: n.op for n in net.graph}
        table = net.describe()
        profile.enable()
        srv.submit(x).result(timeout=120)
        _wait_for_respond_spans(1)
        spans = _node_spans(trace.get())
        assert [s.name.removeprefix("layer:") for s in spans] == want
        planned = [s for s in spans
                   if s.name.removeprefix("layer:") in net.plans]
        assert [s.name.removeprefix("layer:") for s in planned] == \
            [n.id for n in net.graph if n.id in net.plans]
        for s in spans:
            nid = s.name.removeprefix("layer:")
            if nid in net.plans:
                assert nid in table
                assert s.args["executor"] == \
                    net.plans[nid].describe()["executor"]
            else:
                assert s.args == {"op": ops[nid]}
        assert {ops[s.name.removeprefix("layer:")] for s in spans} - {
            "conv2d", "inverted_residual"}      # unplanned nodes are in

        # evict the stem conv onto the fallback; spans must follow
        old = net.plans["conv1"].describe()["executor"]
        assert srv._replace_layer("conv1", reason="test")
        new = net.plans["conv1"].describe()["executor"]
        assert new != old
        trace.get().clear()
        srv.submit(x).result(timeout=120)
        _wait_for_respond_spans(1)
        stem = [s for s in trace.get().spans("layer:conv1")]
        assert stem and stem[0].args["executor"] == new
    profile.disable()


class FakeCuda:
    """The surface of torch.cuda the tracer uses, over a device clock that
    runs OFFSET s ahead of perf_counter. Each event is stamped when
    recorded, `lags` (in turn, then 0) after its host time; it completes
    at once unless `complete` is False. Counts events made and
    synchronizes."""

    OFFSET = 5.0

    def __init__(self, lags=(), complete=True, capturing=False):
        self.lags = iter(lags)
        self.complete = complete
        self.capturing = capturing
        self.made = 0
        self.synced = 0
        cuda = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                cuda.made += 1
                self.t = None
                self.done = False

            def record(self, stream=None):
                assert stream is None or stream is cuda.stream
                self.t = (time.perf_counter() + cuda.OFFSET
                          + next(cuda.lags, 0.0))
                self.done = cuda.complete

            def query(self):
                return self.done

            def synchronize(self):
                self.done = True

            def elapsed_time(self, other):
                return (other.t - self.t) * 1e3

        self.Event = Event
        self.stream = types.SimpleNamespace(device_index=0)

    def is_current_stream_capturing(self):
        return self.capturing

    def current_stream(self):
        return self.stream

    def synchronize(self):
        self.synced += 1


class StampedEvent:
    """An event with a fixed device stamp, for the anchor arithmetic."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_anchor_is_the_soonest_stamped_mark_and_maps_device_time():
    """Of marks recorded just after a synchronize, the one the device
    stamped soonest after its host time ties the clocks; a device stamp
    maps to host time through it."""
    host = [10.0, 10.001, 10.002, 10.003]
    lag = [40e-6, 6e-6, 15e-6, 9e-6]
    marks = [(StampedEvent(t + 3.0 + d), t) for t, d in zip(host, lag)]
    a = trace.soonest_anchor(marks)
    assert a is marks[1]
    ev = StampedEvent(10.5 + 3.0 + 6e-6)
    assert trace.host_time(a, ev) == pytest.approx(10.5, abs=1e-9)
    # one mark: it is the anchor
    assert trace.soonest_anchor(marks[:1]) is marks[0]


def test_device_span_resolves_on_the_host_clock(monkeypatch):
    """A device span is pending until its end event completes, then lands
    as gpu:<name> on the host clock through the soonest anchor; spans()
    waits for a pending one; resolved events are reused."""
    untimed = [0.0] * trace.ANCHORS      # each anchor event's first record
    fake = FakeCuda(lags=untimed + [30e-6, 4e-6, 20e-6, 50e-6, 4e-6 + 2e-3,
                                    4e-6 + 7e-3, 9e-3, 9e-3],
                    complete=False)
    monkeypatch.setattr(trace, "_cuda", lambda: fake)
    tr = trace.Tracer()
    tr.anchor_device()
    assert fake.synced == trace.ANCHORS + 1 and fake.made == trace.ANCHORS
    with tr.twin_span("step", True, k=1):
        h0 = time.perf_counter()
    h1 = time.perf_counter()
    assert [s.name for s in tr._buf] == ["step"]     # the twin pends
    spans = tr.spans()
    assert fake.made == trace.ANCHORS + 2
    host = {s.name: s for s in spans}
    assert host["step"].args == {"k": 1}
    dev = host["gpu:step"]
    # stamps 2 ms and 7 ms past their host times, less the anchor's 4 us
    assert h0 - 1e-3 < dev.t0 - 2e-3 < h0 and dev.t1 - 7e-3 < h1
    assert dev.t1 - dev.t0 >= 5e-3 - 1e-9
    assert dev.args == {"device": 0} and dev.depth == 1
    fake.complete = True
    with tr.device_span("again"):
        pass
    assert fake.made == trace.ANCHORS + 2            # events reused
    assert [s.name for s in tr.spans("gpu:")] == ["gpu:step", "gpu:again"]


def test_no_device_span_while_capturing_or_on_the_cpu(monkeypatch):
    """While the current stream captures a CUDA graph a device span
    records no event and takes no anchor; without a card it is a no-op."""
    fake = FakeCuda(capturing=True)
    monkeypatch.setattr(trace, "_cuda", lambda: fake)
    tr = trace.Tracer()
    tr.anchor_device()
    with tr.twin_span("captured", True):
        with tr.device_span("inner"):
            pass
    assert fake.made == 0 and fake.synced == 0
    assert [s.name for s in tr.spans()] == ["captured"]
    monkeypatch.setattr(trace, "_cuda", lambda: None)
    with tr.device_span("cpu"):
        pass
    assert [s.name for s in tr.spans()] == ["captured"]


def test_chrome_export_keeps_epoch_and_puts_gpu_spans_on_a_track():
    tr = trace.Tracer()
    tr.add_span("host", 100.0, 100.5)
    tr._record(trace.Span("gpu:host", 100.1, 100.4, 7, 0, {"device": 1}))
    doc = tr.export_chrome()
    assert doc["otherData"]["epoch_perf_counter_s"] == 100.0
    xs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert xs["host"]["ts"] == 0.0
    assert xs["gpu:host"]["ts"] == pytest.approx(0.1e6)
    assert xs["gpu:host"]["tid"] == trace.DEVICE_TRACK_TID - 1
    assert xs["gpu:host"]["tid"] != xs["host"]["tid"]
    names = [e for e in doc["traceEvents"] if e["name"] == "thread_name"]
    assert [e["tid"] for e in names] == [trace.DEVICE_TRACK_TID - 1]


def _mbv2(res=32, batch=1):
    specs = cnn.mobilenet_v2()
    params = cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                          res=res, device="cpu")
    net = C.compile(params, specs, res=res, batch=batch,
                    algorithm="pallas_winograd", device="cpu")
    return net, torch.zeros((batch, res, res, 3))


def test_profiling_off_apply_and_loop_record_nothing(params, xs,
                                                     monkeypatch):
    """Tracer on, profiler off: NetworkPlan.apply and the scheduler loop
    record no span and create no CUDA event, even with a card present;
    with the profiler on the same calls record spans."""
    fake = FakeCuda()
    monkeypatch.setattr(trace, "_cuda", lambda: fake)
    net, x = _mbv2()
    with server(params, config=make_cfg(jit_dispatch=True)) as srv:
        tr = trace.enable()              # after compile, before traffic
        tr.clear()
        with torch.inference_mode():
            net.apply(x)
        serve_n(srv, xs, 4)
        time.sleep(0.05)                 # the loop idles, unprofiled
    assert tr.spans() == [] and fake.made == 0 and fake.synced == 0
    profile.enable()
    assert fake.synced == trace.ANCHORS + 1     # enable ties the clocks
    with torch.inference_mode():
        net.apply(x)
    assert _node_spans(trace.get())
    assert fake.made == trace.ANCHORS           # CPU tensors: no twins


def test_device_chain_records_one_event_per_boundary(monkeypatch):
    """In a chain shaped like the graph walk -- a node, a block whose
    three steps hold all its work, a node -- each boundary records one
    event, sibling gpu: spans tile, and the block's span runs from its
    first step's start to its last step's end."""
    fake = FakeCuda()
    monkeypatch.setattr(trace, "_cuda", lambda: fake)
    tr = trace.Tracer()
    tr.anchor_device()
    made = fake.made
    parts = ("expand", "separable", "residual")
    with tr.device_chain() as ch:
        with ch.span("layer:a", op="pad"):
            pass
        with ch.span("layer:b", executor="x"):
            for part in parts:
                with ch.span(f"layer:b/{part}"):
                    pass
        with ch.span("layer:c"):
            pass
    assert fake.made - made == 1 + 5    # the first start, each leaf's end
    gpu = {s.name: s for s in tr.spans("gpu:")}
    a, b, c = (gpu[f"gpu:layer:{n}"] for n in "abc")
    steps = [gpu[f"gpu:layer:b/{part}"] for part in parts]
    assert a.t1 == b.t0 == steps[0].t0
    assert b.t1 == steps[-1].t1 == c.t0
    assert all(x.t1 == y.t0 for x, y in zip(steps, steps[1:]))
    assert all(x.t0 < x.t1 for x in [a, c] + steps)
    assert all(x.depth == b.depth + 1 for x in steps)
    host = {s.name: s for s in tr.spans("layer:")}
    assert host["layer:a"].args == {"op": "pad"}
    assert host["layer:b"].args == {"executor": "x"}
    assert all(s.args == {"device": 0} for s in gpu.values())


def test_walk_device_spans_tile_the_forward(monkeypatch):
    """On a card (a fake one: the walk's chain forced on), one forward of
    MobileNet-v2 records one event per span boundary; its gpu:layer:
    node spans tile the forward from the first event to the last, and
    each inverted residual's span is its steps'."""
    fake = FakeCuda()
    monkeypatch.setattr(trace, "_cuda", lambda: fake)
    chain = trace.Tracer.device_chain
    monkeypatch.setattr(trace.Tracer, "device_chain",
                        lambda self, on_card=True: chain(self, True))
    net, x = _mbv2()
    profile.enable()
    made = fake.made
    with torch.inference_mode():
        net.apply(x)
    gpu = trace.get().spans("gpu:layer:")
    nodes = [s for s in gpu if "/" not in s.name]
    steps = [s for s in gpu if "/" in s.name]
    assert [s.name.removeprefix("gpu:") for s in nodes] == \
        [s.name for s in _node_spans(trace.get())]
    blocks = {n.id for n in net.graph if n.op == "inverted_residual"}
    leaves = len(nodes) - len(blocks) + len(steps)
    assert fake.made - made == 1 + leaves
    assert all(a.t1 == b.t0 for a, b in zip(nodes, nodes[1:]))
    for nid in blocks:
        own = [s for s in steps if s.name.startswith(f"gpu:layer:{nid}/")]
        block = next(s for s in nodes if s.name == f"gpu:layer:{nid}")
        assert (own[0].t0, own[-1].t1) == (block.t0, block.t1)
        assert all(a.t1 == b.t0 for a, b in zip(own, own[1:]))


def test_inverted_residual_steps_nest_in_their_block():
    """Each inverted residual's expand / separable / residual spans lie
    inside its layer span, in order, one level deeper; blocks without an
    expansion or a residual have no such step."""
    net, x = _mbv2()
    profile.enable()
    with torch.inference_mode():
        net.apply(x)
    tr = trace.get()
    blocks = [n for n in net.graph if n.op == "inverted_residual"]
    assert len(blocks) == 17
    for node in blocks:
        plan = net.plans[node.id]
        block = tr.spans(f"layer:{node.id}")[0]
        assert block.name == f"layer:{node.id}"
        steps = tr.spans(f"layer:{node.id}/")
        want = (["expand"] if plan.expand is not None else []) + \
            ["separable"] + (["residual"] if plan.residual else [])
        assert [s.name.split("/")[1] for s in steps] == want
        for s in steps:
            assert _inside(s, block) and s.depth == block.depth + 1
        assert all(a.t1 <= b.t0 for a, b in zip(steps, steps[1:]))
    assert any(net.plans[n.id].residual for n in blocks)
    assert any(net.plans[n.id].expand is None for n in blocks)


@pytest.mark.parametrize("jit_dispatch", [False, True])
def test_scheduler_spans_nest_and_do_not_overlap(params, xs, jit_dispatch):
    """serve.stack lies inside its batch's formation, serve.copy_in and
    serve.replay inside its dispatch; on the scheduler thread serve.idle,
    serve.coalesce and each batch (selection to the last answer) do not
    overlap; serve.coalesce records the queue it waited on."""
    cfg = make_cfg(jit_dispatch=jit_dispatch, batch_wait_s=0.05)
    with server(params, config=cfg) as srv:
        serve_n(srv, xs, 2)
        profile.enable()
        for i in range(4):
            tickets = [srv.submit(xs[j]) for j in range(1 + i % 2)]
            for t in tickets:
                t.result(timeout=60)
            time.sleep(0.02)
        _wait_for_respond_spans(6)
        tr = trace.get()
        spans = tr.spans("serve.")
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    dispatches = by["serve.dispatch"]
    assert len(dispatches) == 4 and len(by["serve.stack"]) == 4
    assert len(by["serve.copy_in"]) == 4
    assert len(by.get("serve.replay", [])) == (4 if jit_dispatch else 0)
    assert by["serve.idle"] and by["serve.coalesce"]
    assert all(c.args["queued"] >= 1 and isinstance(c.args["woken"], bool)
               for c in by["serve.coalesce"])
    for st in by["serve.stack"]:
        assert any(_inside(st, f) for f in by["serve.batch_formation"])
    for s in by["serve.copy_in"] + by.get("serve.replay", []):
        assert any(_inside(s, d) for d in dispatches), s
    batches = []
    for d in dispatches:
        formed = [f for f in by["serve.batch_formation"]
                  if f.t1 == d.t0]
        answered = [r for r in by["serve.respond"] if r.t0 == d.t1]
        batches.append((formed[0].t0, max(r.t1 for r in answered)))
    waits = [(s.t0, s.t1) for s in by["serve.idle"] + by["serve.coalesce"]]
    ivs = sorted(waits + batches)
    assert all(a[1] <= b[0] for a, b in zip(ivs, ivs[1:])), ivs
    assert len({s.tid for s in by["serve.idle"] + by["serve.coalesce"]
                + by["serve.stack"]}) == 1


def test_compile_spans(params, tmp_path):
    """compile() phases, and an artifact's cold save and warm load, land
    in the trace."""
    trace.enable()
    trace.get().clear()
    path = str(tmp_path / "net.npz")
    C.compile(params, SPECS, res=RES, batch=1, algorithm="winograd",
              artifact=path, device="cpu")
    names = {s.name for s in trace.get().spans()}
    for phase in ("compile.lower", "compile.fuse", "compile.infer_shapes",
                  "compile.place", "compile.bind", "compile.artifact_save"):
        assert phase in names, names
    assert trace.get().spans("compile.fuse")[0].args["nodes"] == 3
    trace.get().clear()
    C.compile(params, SPECS, res=RES, batch=1, algorithm="winograd",
              artifact=path, device="cpu")
    assert [s.name for s in trace.get().spans()] == ["compile.artifact_load"]
    assert metrics.snapshot_all()["default"]["counters"] == {
        "plan.artifact.hit": 1, "plan.artifact.miss": 1,
        "plan.cache.miss": 2}
    trace.disable()


# ---------------------------------------------------------------------------
# verify-artifacts CLI
# ---------------------------------------------------------------------------

def test_verify_artifacts_cli(params, tmp_path, capsys):
    adir = str(tmp_path / "artifacts")
    with server(params, config=make_cfg(), artifact_dir=adir):
        pass
    names = sorted(os.listdir(adir))
    assert names == ["plan_b1.npz", "plan_b2.npz"], names

    assert serve_mod.main(["verify-artifacts", adir]) == 0
    out = capsys.readouterr().out
    assert "plan_b1.npz: OK" in out and "all digests verified" in out

    inject.flip_bit(os.path.join(adir, "plan_b2.npz"))
    assert serve_mod.main(["verify-artifacts", adir]) == 1
    out = capsys.readouterr().out
    assert "plan_b2.npz: CORRUPT" in out
    assert "plan_b1.npz: OK" in out
    assert "[CORRUPT" in out                 # the per-array status line

    assert serve_mod.main(["verify-artifacts",
                           str(tmp_path / "nope")]) == 2
