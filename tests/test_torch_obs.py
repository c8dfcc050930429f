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
    graph-dispatch path (whose dispatch span stands alone)."""
    with server(params, config=make_cfg(jit_dispatch=jit_dispatch)) as srv:
        serve_n(srv, xs, 2)
        profile.enable()
        tickets = serve_n(srv, xs, 6)
        _wait_for_respond_spans(6)
        tr = trace.get()
        by_rid = _spans_by_rid(tr)
        dispatches = tr.spans("serve.dispatch")
        layers = tr.spans("layer:")
    assert all(d.args["jitted"] == jit_dispatch for d in dispatches)
    assert bool(layers) != jit_dispatch
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


def _wait_for_respond_spans(n: int, timeout_s: float = 60.0) -> None:
    """A ticket finishes before the scheduler records its batch's spans
    (the layer spans first, the respond spans last): wait for n respond
    spans before reading them."""
    deadline = time.perf_counter() + timeout_s
    while (len(trace.get().spans("serve.respond")) < n
           and time.perf_counter() < deadline):
        time.sleep(0.001)


def test_layer_spans_match_plan_node_ids_mbv2():
    """On MobileNet-v2, the layer:<nid> spans of one request name exactly
    the planned nodes, in execution order, tagged with each plan's
    executor -- and after a re-placement the NEXT request's spans show the
    new executor."""
    res = 32
    specs = cnn.mobilenet_v2()
    params = cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                          res=res, device="cpu")
    x = np.zeros((res, res, 3), np.float32)
    with server(params, specs, res=res, algorithm="pallas_winograd",
                config=make_cfg(buckets=(1,))) as srv:
        net = srv.nets[1]
        want = [n.id for n in net.graph if n.id in net.plans]
        table = net.describe()
        profile.enable()
        srv.submit(x).result(timeout=120)
        _wait_for_respond_spans(1)
        got = [s.name.removeprefix("layer:")
               for s in trace.get().spans("layer:")]
        assert got == want
        for s in trace.get().spans("layer:"):
            nid = s.name.removeprefix("layer:")
            assert nid in table
            assert s.args["executor"] == \
                net.plans[nid].describe()["executor"]

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
