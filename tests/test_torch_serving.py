"""The port's serving runtime on the CPU: the JAX package's
tests/test_serving.py suite run against repro_torch.runtime.serve at RES 16
with device="cpu" (admission and backpressure, bucketed batching,
deadlines, the degrade ladder retry -> re-placement -> recompile, the
graph-dispatch happy path -- on the CPU the eager apply under
inference_mode -- and the artifact checksums), then parity with the
reference Server on the same params and images at algorithm="winograd":
answers within 1e-5, the same deterministic counters after the same fault
schedule, and the same precision-probe promotions."""

import os

import jax
import numpy as np
import pytest
import torch

from repro.core import compile as ref_compile
from repro.models import cnn as ref_cnn
from repro.runtime import inject as ref_inject
from repro.runtime import serve as ref_serve
from repro_torch.core import compile as C
from repro_torch.core.compile import (ArtifactMismatchError,
                                      LayerExecutionError, NetworkPlan,
                                      verify_artifact)
from repro_torch.core.plan import clear_plan_cache, plan_cache_info
from repro_torch.models import cnn
from repro_torch.runtime import inject
from repro_torch.runtime.serve import QueueFullError, ServeConfig, Server

RES = 16
SPECS = [cnn.Conv("c1", 3, 3, 8), cnn.Conv("c2", 3, 3, 8, relu=False)]
REF_SPECS = [ref_cnn.Conv("c1", 3, 3, 8),
             ref_cnn.Conv("c2", 3, 3, 8, relu=False)]
#: Port against reference answers, relative max-abs: the same fp32
#: transforms and sums in another order (they read ~1e-7).
TOL_PARITY = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_counters():
    clear_plan_cache()
    yield
    clear_plan_cache()


@pytest.fixture
def params():
    return cnn.init_cnn(torch.Generator().manual_seed(0), SPECS, 3, res=RES,
                        device="cpu")


@pytest.fixture
def xs(rng):
    return [rng.standard_normal((RES, RES, 3)).astype(np.float32)
            for _ in range(6)]


def make_cfg(**kw):
    base = dict(buckets=(1, 2, 4), queue_capacity=8, verbose=False,
                backoff_base_s=0.002, backoff_cap_s=0.01)
    base.update(kw)
    return ServeConfig(**base)


def server(params, **kw):
    kw.setdefault("config", make_cfg())
    return Server(params, SPECS, res=RES, algorithm="winograd",
                  device="cpu", **kw)


def oracle_outputs(params, xs):
    net = C.compile(params, SPECS, res=RES, batch=1, algorithm="im2col",
                    device="cpu")
    return [net.apply(torch.from_numpy(x[None]))[0].numpy() for x in xs]


def assert_close(y, ref, tol=2e-3):
    err = np.max(np.abs(y - ref)) / (np.max(np.abs(ref)) + 1e-9)
    assert err < tol, err


# ---------------------------------------------------------------------------
# per-array artifact checksums
# ---------------------------------------------------------------------------

def test_artifact_checksums_roundtrip(params, tmp_path):
    path = str(tmp_path / "net.npz")
    net = C.compile(params, SPECS, res=RES, algorithm="winograd",
                    device="cpu")
    net.save(path)
    assert verify_artifact(path) == []
    loaded = NetworkPlan.load(path, device="cpu")
    x = torch.zeros(1, RES, RES, 3)
    assert torch.equal(net.apply(x), loaded.apply(x))


def test_bitflip_fails_integrity_digest(params, tmp_path):
    path = str(tmp_path / "net.npz")
    C.compile(params, SPECS, res=RES, algorithm="winograd",
              device="cpu").save(path)
    bad = inject.flip_bit(path)
    assert [bad] == verify_artifact(path)
    with pytest.raises(ArtifactMismatchError,
                       match="integrity digest.*recompile"):
        NetworkPlan.load(path, device="cpu")


def test_corrupt_artifact_recompiles_and_repairs(params, tmp_path):
    """compile(artifact=) over a bit-flipped file must cold-compile (one
    artifact miss), produce correct outputs, and leave a repaired artifact
    behind."""
    path = str(tmp_path / "net.npz")
    ref = C.compile(params, SPECS, res=RES, algorithm="winograd",
                    artifact=path, device="cpu")
    x = torch.zeros(1, RES, RES, 3)
    y_ref = ref.apply(x)
    inject.flip_bit(path)
    before = plan_cache_info()
    net = C.compile(params, SPECS, res=RES, algorithm="winograd",
                    artifact=path, device="cpu")
    after = plan_cache_info()
    assert after["artifact_misses"] == before["artifact_misses"] + 1
    assert torch.equal(net.apply(x), y_ref)
    assert verify_artifact(path) == []          # repaired on disk
    NetworkPlan.load(path, device="cpu")          # and loadable again


# ---------------------------------------------------------------------------
# re-placement hook (core side of the degrade ladder)
# ---------------------------------------------------------------------------

def test_replace_layer_parity(params, xs):
    net = C.compile(params, SPECS, res=RES, batch=1, algorithm="winograd",
                    device="cpu")
    x = torch.from_numpy(xs[0][None])
    y_before = net.apply(x).numpy()
    assert net.plans["c1"].spec.algorithm != "im2col"
    old = net.plans["c1"]
    net.replace_layer("c1", params, algorithm="im2col")
    assert net.plans["c1"].spec.algorithm == "im2col"
    # the registered modules follow the swap (.to(), state_dict)
    assert list(net._plan_modules) == list(net.plans.values())
    assert all(m is not old for m in net.modules())
    assert_close(net.apply(x).numpy(), y_before)


def test_replace_layer_rejects_unknown_node_and_foreign_params(
        params, tmp_path):
    path = str(tmp_path / "net.npz")
    net = C.compile(params, SPECS, res=RES, algorithm="winograd",
                    artifact=path, device="cpu")
    with pytest.raises(ValueError, match="not a plan-bearing node"):
        net.replace_layer("nope", params)
    other = cnn.init_cnn(torch.Generator().manual_seed(1), SPECS, 3,
                         res=RES, device="cpu")
    with pytest.raises(ValueError, match="params_digest mismatch"):
        net.replace_layer("c1", other)


def test_apply_annotates_layer_errors(params):
    net = C.compile(params, SPECS, res=RES, algorithm="winograd",
                    device="cpu")
    proxy = inject.install(net, inject.ExecutorRaise("c2"))
    assert proxy in list(net._plan_modules)
    x = torch.zeros(1, RES, RES, 3)
    with pytest.raises(inject.InjectedExecutorError):
        net.apply(x)                             # default: raw error
    with pytest.raises(LayerExecutionError) as ei:
        net.apply(x, annotate_errors=True)
    assert ei.value.node_id == "c2"
    assert isinstance(ei.value.__cause__, inject.InjectedExecutorError)


# ---------------------------------------------------------------------------
# serving: the degrade ladder under injected faults
# ---------------------------------------------------------------------------

def test_executor_raise_replacement_parity(params, xs):
    """Permanent executor failure: retries burn out, the supervisor
    re-places the failing layer onto im2row across every bucket, and every
    in-flight request is answered with outputs matching the im2row
    oracle -- zero drops, zero incorrect responses."""
    srv = server(params)
    srv.start()
    inject.install_on_server(srv, inject.ExecutorRaise("c1"))
    tickets = [srv.submit(x) for x in xs]
    ys = [t.result(timeout=120) for t in tickets]
    srv.stop()
    s = srv.stats
    assert s.replacements >= 1 and s.executor_failures >= 1
    assert s.failed == 0 and s.in_flight == 0
    for b in srv.buckets:
        assert srv.nets[b].plans["c1"].spec.algorithm == "im2col"
    for y, ref in zip(ys, oracle_outputs(params, xs)):
        assert_close(y, ref)


def test_transient_executor_raise_survived_by_retry(params, xs):
    """A fault that clears within the retry budget never escalates."""
    srv = server(params)
    srv.start()
    inject.install_on_server(srv, inject.ExecutorRaise("c1", times=1))
    ys = [t.result(timeout=120) for t in [srv.submit(x) for x in xs]]
    srv.stop()
    assert srv.stats.retries >= 1 and srv.stats.replacements == 0
    assert srv.stats.failed == 0 and srv.stats.in_flight == 0
    for y, ref in zip(ys, oracle_outputs(params, xs)):
        assert_close(y, ref)


def test_recompile_rung_when_replacement_cannot_cure(params, xs,
                                                     monkeypatch):
    """When re-placement is unavailable the ladder's last rung recompiles
    every bucket plan from raw params -- which drops the fault proxies --
    and the batch still completes."""
    srv = server(params)
    srv.start()
    monkeypatch.setattr(srv, "_replace_layer", lambda *a, **k: False)
    inject.install_on_server(srv, inject.ExecutorRaise("c1"))
    ys = [t.result(timeout=120) for t in [srv.submit(x) for x in xs]]
    srv.stop()
    assert srv.stats.recompiles == 1
    assert srv.stats.failed == 0 and srv.stats.in_flight == 0
    for y, ref in zip(ys, oracle_outputs(params, xs)):
        assert_close(y, ref)


def test_queue_overload_bounded_rejection(params, xs):
    """Overload degrades into bounded rejection with a retry-after hint;
    every ADMITTED request is still served (zero drops)."""
    srv = server(params, config=make_cfg(queue_capacity=4))
    accepted, rejected = [], 0
    for i in range(11):
        try:
            accepted.append(srv.submit(xs[i % len(xs)]))
        except QueueFullError as e:
            rejected += 1
            assert e.retry_after_s > 0 and e.capacity == 4
    assert len(accepted) == 4 and rejected == 7
    assert srv.stats.rejected == 7
    srv.start()
    ys = [t.result(timeout=120) for t in accepted]
    srv.stop()
    assert srv.stats.completed == 4 and srv.stats.in_flight == 0
    refs = oracle_outputs(params, [t.x for t in accepted])
    for y, ref in zip(ys, refs):
        assert_close(y, ref)


def test_straggler_eviction_counter(params, xs):
    """An injected latency spike on one layer is flagged by the per-bucket
    StepTimer, attributed via per-layer times, and the layer is evicted
    onto the fallback executor after the configured count. Straggler
    attribution needs the eager supervised path's per-layer timing hooks,
    so graph dispatch is disabled."""
    srv = server(params, config=make_cfg(
        buckets=(2,), queue_capacity=64, jit_dispatch=False,
        straggler_window=16, straggler_min_baseline=5,
        straggler_evict_after=2, batch_wait_s=0.0))
    srv.start()
    for _ in range(8):                           # build the baseline
        [t.result(timeout=60) for t in [srv.submit(x) for x in xs[:2]]]
    inject.install_on_server(srv, inject.LatencySpike("c2", delay_s=0.3))
    for _ in range(6):
        [t.result(timeout=60) for t in [srv.submit(x) for x in xs[:2]]]
    srv.stop()
    s = srv.stats
    assert s.stragglers >= 2 and s.evictions >= 1
    assert srv.nets[2].plans["c2"].spec.algorithm == "im2col"
    assert s.failed == 0 and s.in_flight == 0


def test_deadline_timeout_cancellation(params, xs):
    srv = server(params)
    expired = srv.submit(xs[0], deadline_s=0.0)   # dead before dispatch
    live = srv.submit(xs[1], deadline_s=60.0)
    srv.start()
    with pytest.raises(TimeoutError, match="deadline expired"):
        expired.result(timeout=60)
    assert_close(live.result(timeout=60), oracle_outputs(params, [xs[1]])[0])
    srv.stop()
    assert expired.status == "timeout" and srv.stats.timed_out == 1
    assert srv.stats.completed == 1 and srv.stats.in_flight == 0


def test_corrupt_bucket_artifact_repaired_at_startup(params, xs, tmp_path):
    """A bit-flipped bucket artifact is detected by the per-array checksums
    at server startup, recompiled in place, and serving proceeds with
    correct outputs; the repaired artifact warm-starts the next server."""
    art = str(tmp_path)
    cfg = make_cfg()
    srv = server(params, config=cfg, artifact_dir=art)
    assert srv.stats.artifact_cold_starts == len(srv.buckets)
    del srv
    inject.flip_bit(os.path.join(art, "plan_b2.npz"))
    srv2 = server(params, config=cfg, artifact_dir=art)
    assert srv2.stats.corrupt_artifacts == 1
    assert srv2.stats.corrupt_arrays >= 1
    assert srv2.stats.artifact_cold_starts == 1     # only the corrupt bucket
    assert srv2.stats.artifact_warm_starts == len(srv2.buckets) - 1
    assert verify_artifact(os.path.join(art, "plan_b2.npz")) == []
    srv2.start()
    ys = [t.result(timeout=120) for t in [srv2.submit(x) for x in xs]]
    srv2.stop()
    for y, ref in zip(ys, oracle_outputs(params, xs)):
        assert_close(y, ref)
    srv3 = server(params, config=cfg, artifact_dir=art)
    assert srv3.stats.artifact_warm_starts == len(srv3.buckets)


def test_jit_dispatch_happy_path_counters(params, xs):
    """Fault-free traffic is served entirely by the graph-dispatch happy
    path (stats.jit_dispatches), no bucket ever falls back, and outputs
    match the eager oracle."""
    srv = server(params)
    srv.start()
    ys = [t.result(timeout=120) for t in [srv.submit(x) for x in xs]]
    srv.stop()
    assert srv.stats.jit_dispatches >= 1
    assert srv.stats.jit_dispatches == srv.stats.batches
    assert srv.stats.jit_fallbacks == 0 and srv.stats.retries == 0
    for y, ref in zip(ys, oracle_outputs(params, xs)):
        assert_close(y, ref)


def test_probation_promotes_layer_back(params, xs):
    """Continuous re-placement. A permanent executor fault breaks the
    bucket's graph path (counted in jit_fallbacks), the supervisor evicts
    the layer onto im2col, and after the probation window of clean batches
    a re-probe promotes it back onto winograd."""
    srv = server(params, config=make_cfg(probation_batches=2))
    srv.start()
    inject.install_on_server(srv, inject.ExecutorRaise("c1"))
    [t.result(timeout=120) for t in [srv.submit(x) for x in xs]]
    assert srv.stats.replacements >= 1 and srv.stats.jit_fallbacks >= 1
    # serve clean singles until the probation window fills
    ys = []
    for _ in range(4):
        ys.append(srv.submit(xs[0]).result(timeout=120))
    srv.stop()
    s = srv.stats
    assert s.probation_reprobes >= 1 and s.probation_promotions == 1
    for b in srv.buckets:
        assert srv.nets[b].plans["c1"].spec.algorithm == "winograd"
    ref = oracle_outputs(params, [xs[0]])[0]
    for y in ys:
        assert_close(y, ref)
    assert s.failed == 0 and s.in_flight == 0


def test_probation_window_doubles_on_failed_probe(params, xs, monkeypatch):
    """A failed probation re-probe keeps the layer on the fallback and
    doubles its window instead of flapping. The probe is refused from the
    start: with a window of one batch, any clean batch after the
    re-placement re-probes, including one formed from the first burst."""
    srv = server(params, config=make_cfg(probation_batches=1))

    def boom(*a, **k):
        raise RuntimeError("probe refused")
    monkeypatch.setattr(srv, "_fresh_plan", boom)
    srv.start()
    inject.install_on_server(srv, inject.ExecutorRaise("c1"))
    [t.result(timeout=120) for t in [srv.submit(x) for x in xs]]
    assert srv.stats.replacements >= 1
    for _ in range(2):
        srv.submit(xs[0]).result(timeout=120)
    srv.stop()
    s = srv.stats
    assert s.probation_reprobes >= 1 and s.probation_promotions == 0
    assert srv._probation["c1"]["need"] >= 2
    for b in srv.buckets:
        assert srv.nets[b].plans["c1"].spec.algorithm == "im2col"


def test_batches_form_across_buckets(params, xs):
    """Dynamic batch formation picks the smallest covering bucket; a
    pre-loaded queue of 6 forms a 4-batch plus a 2-batch."""
    srv = server(params)
    tickets = [srv.submit(x) for x in xs]
    srv.start()
    [t.result(timeout=120) for t in tickets]
    srv.stop()
    assert srv.stats.bucket_batches == {4: 1, 2: 1}
    assert srv.stats.completed == 6 and srv.stats.in_flight == 0


def test_mesh_serving_not_ported(params):
    """Mesh-sharded buckets are ported now (tests/test_torch_partition.py
    holds them against the reference): a data partition over 2 CPU shards
    covers the even buckets, and without a mesh nothing is sharded."""
    from repro_torch.launch.mesh import make_data_mesh
    srv = server(params, mesh=make_data_mesh(devices=["cpu"] * 2),
                 partition="data")
    assert srv.stats.sharded_buckets == {"2": 2, "4": 2}
    assert set(srv.sharded_nets) == {2, 4}
    srv_plain = server(params, partition="data")
    assert srv_plain.stats.sharded_buckets == {}


# ---------------------------------------------------------------------------
# parity with the reference Server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shared():
    """The reference's params (numpy) and the same params in the port."""
    ref_params = ref_cnn.init_cnn(jax.random.key(0), REF_SPECS, 3, res=RES)
    ref_params = jax.tree.map(np.array, ref_params)
    return ref_params, cnn.params_from_reference(ref_params, "cpu")


#: counters the same fault schedule must leave equal in both packages
LADDER_COUNTERS = ("retries", "replacements", "recompiles",
                   "corrupt_arrays", "precision_promotions", "completed",
                   "failed", "batches")


def _pair(shared, tmp_path, **cfg):
    """(reference Server, port Server) on the same params; probation off
    (a re-probe's timing is not part of the schedule)."""
    kw = dict(buckets=(1, 2, 4), queue_capacity=16, verbose=False,
              backoff_base_s=0.002, backoff_cap_s=0.01, probation_batches=0)
    kw.update(cfg)
    ref = ref_serve.Server(shared[0], REF_SPECS, res=RES, algorithm="winograd",
                           config=ref_serve.ServeConfig(**kw),
                           artifact_dir=str(tmp_path / "ref"))
    port = Server(shared[1], SPECS, res=RES, algorithm="winograd",
                  config=ServeConfig(**kw), artifact_dir=str(tmp_path / "pt"),
                  device="cpu")
    return ref, port


def _serve_preloaded(srv, xs):
    """Warm up, then admit every request before the scheduler starts, so
    batches form alike in both packages (a 4-batch and a 2-batch)."""
    tickets = [srv.submit(x) for x in xs]
    srv.start(warmup=False)
    ys = [np.asarray(t.result(timeout=120)) for t in tickets]
    srv.stop()
    return ys


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@pytest.mark.parametrize("fault", ["none", "transient", "permanent",
                                   "recompile", "corrupt_artifact"])
def test_ladder_matches_reference(shared, xs, tmp_path, monkeypatch, fault):
    """The same fault schedule through both servers: every answer within
    TOL_PARITY of the reference's, and the same ladder counters."""
    ref, port = _pair(shared, tmp_path)
    if fault == "corrupt_artifact":
        ref_inject.flip_bit(os.path.join(str(tmp_path / "ref"),
                                         "plan_b2.npz"))
        inject.flip_bit(os.path.join(str(tmp_path / "pt"), "plan_b2.npz"))
        ref, port = _pair(shared, tmp_path)
    ys = {}
    for name, srv, inj in (("ref", ref, ref_inject), ("port", port, inject)):
        srv.warmup()
        if fault in ("transient", "permanent", "recompile"):
            times = 1 if fault == "transient" else 10**9
            inj.install_on_server(srv, inj.ExecutorRaise("c1", times=times))
        if fault == "recompile":
            monkeypatch.setattr(srv, "_replace_layer", lambda *a, **k: False)
        ys[name] = _serve_preloaded(srv, xs)
    for y, y_ref in zip(ys["port"], ys["ref"]):
        assert _rel(y, y_ref) < TOL_PARITY
    got = {k: getattr(port.stats, k) for k in LADDER_COUNTERS}
    want = {k: getattr(ref.stats, k) for k in LADDER_COUNTERS}
    assert got == want
    # each schedule reached its rung
    rung = {"none": "completed", "transient": "retries",
            "permanent": "replacements", "recompile": "recompiles",
            "corrupt_artifact": "corrupt_arrays"}[fault]
    assert got[rung] >= 1, got
    assert port.stats.failed == 0 and port.stats.in_flight == 0


@pytest.mark.parametrize("compute_dtype", ["int8", "bfloat16"])
def test_precision_probe_matches_reference(shared, compute_dtype):
    """probe_precision on the same params and the same host-drawn inputs:
    per-layer rel_err within 1e-4 of the reference's and the same promoted
    set -- under the default budget, then under a budget set between the
    two layers' errors, so that exactly the worse layer is promoted."""
    kw = dict(buckets=(1, 2), verbose=False)
    ref = ref_serve.Server(shared[0], REF_SPECS, res=RES, algorithm="winograd",
                           compute_dtype=compute_dtype,
                           config=ref_serve.ServeConfig(**kw))
    port = Server(shared[1], SPECS, res=RES, algorithm="winograd",
                  compute_dtype=compute_dtype, config=ServeConfig(**kw),
                  device="cpu")
    reports = []
    for budget in (None, "between"):
        if budget == "between":
            errs = sorted(r["rel_err"] for r in reports[-1][0].values())
            cut = {compute_dtype: float(np.sqrt(errs[0] * errs[-1]))}
            ref.config.precision_budget = port.config.precision_budget = cut
        reports.append((ref.probe_precision(), port.probe_precision()))
    for r_ref, r_port in reports:
        assert set(r_ref) == set(r_port) == {"c1", "c2"}
        for nid in r_ref:
            assert abs(r_port[nid]["rel_err"] - r_ref[nid]["rel_err"]) \
                < 1e-4, (nid, r_port[nid], r_ref[nid])
            assert r_port[nid]["promoted"] == r_ref[nid]["promoted"]
            assert r_port[nid]["compute_dtype"] == \
                r_ref[nid]["compute_dtype"]
    assert sum(r["promoted"] for r in reports[-1][1].values()) == 1
    assert port.stats.precision_promotions == ref.stats.precision_promotions
    assert port.stats.layer_compute_dtypes == ref.stats.layer_compute_dtypes
    # the promoted layer serves the reference's fp32 answer
    x = np.random.default_rng(3).standard_normal(
        (1, RES, RES, 3)).astype(np.float32)
    y_ref = np.asarray(ref.nets[1].apply(jax.numpy.asarray(x)))
    y_port = port.nets[1].apply(torch.from_numpy(x)).numpy()
    assert _rel(y_port, y_ref) < 1e-2


def test_reference_server_artifacts_verify_in_port(shared, tmp_path):
    """Each package's server writes artifacts the other's audit accepts."""
    ref, port = _pair(shared, tmp_path)
    from repro_torch.runtime import serve as pt_serve
    for d, audit in ((tmp_path / "ref", pt_serve.audit_artifact),
                     (tmp_path / "pt", ref_serve.audit_artifact)):
        for b in (1, 2, 4):
            rows = audit(str(d / f"plan_b{b}.npz"))
            assert rows and all(s == "ok" for _, s in rows), rows
    assert ref_compile.verify_artifact(str(tmp_path / "pt" / "plan_b1.npz")) \
        == []
