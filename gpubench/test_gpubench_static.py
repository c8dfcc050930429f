"""The benchmark's yardstick on the CPU: the counted work against the
published figures, the traffic generator, the percentiles, the result
line, the process's refusal without a card, and what the benchmark may
import."""

import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gpubench import counting, harness, traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, gmacs, params_m, tol", [
    # Simonyan & Zisserman: 138 M parameters (138.36 M with the FC
    # biases this network leaves out), ~15.5 G multiply-adds at 224
    ("vgg16", 15.5, 138.36, 0.01),
    # Sandler et al.: 300 M multiply-adds, 3.4 M parameters (3.47 M with
    # the classifier's 1000 x 1280 weights counted in full)
    ("mobilenet_v2", 0.300, 3.47, 0.03),
])
def test_counted_work_matches_published(name, gmacs, params_m, tol):
    rows = counting.walk(_config(name)["layers"], 224, 3)
    macs = counting.forward_flops(rows) / 2
    assert macs / 1e9 == pytest.approx(gmacs, rel=tol)
    assert counting.param_count(rows) / 1e6 == pytest.approx(params_m,
                                                            rel=tol)


def test_least_time_is_the_larger_bound():
    peak = counting.PEAKS["NVIDIA H100 80GB HBM3"]
    rows = {r.get("name"): r for r in
            counting.walk(_config("vgg16")["layers"], 224, 3)}
    # conv5_2 at batch 32: 2 * 32 * 14 * 14 * 512 * 512 * 9 FLOPs
    r = rows["conv5_2"]
    assert counting.layer_flops(r, 32) == 2 * 32 * 14 * 14 * 512 * 512 * 9
    t, kind = counting.least_seconds(r, 32, peak)
    assert kind == "operations"
    assert t == pytest.approx(counting.layer_flops(r, 32) / 495e12)
    # a whole inverted residual's bytes: input, output, weights, biases
    ir = next(r for r in counting.walk(_config("mobilenet_v2")["layers"],
                                       224, 3) if r.get("name") == "ir3")
    w = 24 * 144 + 144 + 9 * 144 + 144 + 144 * 24 + 24
    assert counting.layer_bytes(ir, 2) == 4 * (2 * 2 * 56 * 56 * 24 + w)
    assert counting.least_seconds(ir, 2, peak)[1] == "bytes"


def _mix(**kw):
    return dict({"kind": "served", "image_rate_per_s": 800.0,
                 "burst_min": 1, "burst_max": 1, "pool_images": 64}, **kw)


@pytest.mark.parametrize("lo, hi", [(1, 1), (1, 16)])
def test_schedule_is_the_seeds_order_of_fixed_work(lo, hi):
    mix = _mix(burst_min=lo, burst_max=hi, image_rate_per_s=1700.0)
    a = traffic.served_schedule(mix, 2**31 + 17, 20.0)
    b = traffic.served_schedule(mix, 2**31 + 17, 20.0)
    c = traffic.served_schedule(mix, 5, 20.0)
    assert np.array_equal(a.due_s, b.due_s)
    assert np.array_equal(a.image, b.image)
    assert not np.array_equal(a.due_s, c.due_s)
    # the same requests, gaps and burst sizes for every seed
    assert len(a) == len(c)
    for s in (a, c):
        starts, sizes = np.unique(s.due_s, return_counts=True)
        assert np.all(np.diff(s.due_s) >= 0)
        assert 0 <= s.due_s[0] and s.due_s[-1] < 20.0
        assert len(s) / 20.0 == pytest.approx(1700.0, rel=0.01)
        assert sizes.min() == lo and sizes.max() == hi
        if hi > lo:
            counts = np.bincount(sizes)[lo:]
            assert counts.max() - counts.min() <= 1
    gaps = [np.sort(np.diff(np.unique(s.due_s))) for s in (a, c)]
    assert np.allclose(np.quantile(gaps[0], [0.1, 0.5, 0.9]),
                       np.quantile(gaps[1], [0.1, 0.5, 0.9]), rtol=0.05)
    assert np.mean(gaps[0]) == pytest.approx(20.0 / len(gaps[0]), rel=0.01)


def test_percentiles_count_refused_requests_as_infinitely_late():
    lat = [0.001 * k for k in range(1, 96)] + [math.inf] * 5
    assert traffic.percentile(lat, 50) == pytest.approx(0.050)
    assert traffic.percentile(lat, 95) == pytest.approx(0.095)
    assert traffic.percentile(lat + [math.inf], 95) == math.inf
    rec = {"kind": "served", "latency_s": np.array(lat)}
    assert harness.load_metric("latency_p95_ms").read(rec) == \
        pytest.approx(95.0)
    assert harness.load_metric("latency_p50_ms").read(rec) == \
        pytest.approx(50.0)
    assert harness.load_metric("images_per_s").read(rec) is None


def test_result_line_keys_and_order():
    from gpubench import run
    rec = {"correct": True, "attempted": 10, "failed": 0,
           "metrics": {"latency_p95_ms": {"value": math.inf, "unit": "ms"}},
           "checks": {"logit_err": {"value": 1e-6, "limit": 1e-4}},
           "window_s": 2.0, "busy_s": 1.5,
           "breakdown": {"device_ops": [["k", 1.0]], "idle_gaps": []}}
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 5}
    plain = run.result(rec, dev, trace=False)
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]
    assert "busy_s" not in plain["device"]
    traced = run.result(rec, dev, trace=True)
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert traced["device"]["busy_s"] == 1.5
    assert traced["device"]["window_s"] == 2.0
    line = json.loads(json.dumps(traced))
    assert line["metrics"]["latency_p95_ms"]["value"] == "inf"


def test_every_metric_has_a_reader_that_declares_it():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = harness.load_metric(m["name"])
        assert mod.UNIT == m["unit"]
        if "layer" in m:
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], bench)
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer and cell.limits["logit_err"] > 0


def test_run_refuses_without_a_card():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    p = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "vgg16.offline.b32", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, f
        if "reference" in f.relative_to(HERE).parts:
            assert not tops & {"repro_torch", "gpubench"}, f
            assert tops <= {"__future__", "contextlib", "torch"}, f
    assert not {m.split(".")[0] for m in _imports(HERE / "counting.py")} - {
        "__future__", "math"}




@pytest.mark.parametrize("lost", [False, True])
def test_device_clock_ties_to_the_soonest_closing_marker(lost):
    """The primer and the opening instants move nothing, a late closing
    marker neither; a trace that lost a closing marker is left unread; a
    kernel is its node's by its midpoint."""
    from gpubench import devtrace
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    dev = lambda t: t + 5.0  # noqa: E731   the device's clock
    lat = 4e-6                      # a marker's launch latency
    marks = [9.0, 9.001, 9.002, 9.003]
    raw = [(spin, dev(0.99), 1e-3),                # the primer
           (spin, dev(1.5) - 6e-4, 5e-6)]          # an opening spin
    kernels = [("a", 2.0, 2.004), ("b", 2.0041, 2.006), ("c", 8.0, 8.5)]
    raw += [(n, dev(s), dev(e) - dev(s)) for n, s, e in kernels]
    raw += [(spin, dev(9.0) + 2e-3, 5e-6)]         # started 2 ms late
    raw += [(spin, dev(t) + lat, 5e-6) for t in marks[1 + lost:]]
    ev = devtrace.align(sorted(raw, key=lambda e: e[1]), marks)
    if lost:
        assert ev == []
        return
    assert [n for n, _, _ in ev] == ["a", "b", "c"]
    for (_, s, e), (_, s0, e0) in zip(ev, kernels):
        assert abs(s - (s0 - lat)) < 1e-7 and abs(e - (e0 - lat)) < 1e-7
    by = devtrace.attribute(ev, [("n1", 1.99999, 2.0041),
                                 ("n2", 2.0041, 2.0062)])
    assert set(by) == {"n1", "n2"}
    assert by["n1"] == pytest.approx(0.004, rel=1e-6)
