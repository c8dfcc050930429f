"""The port's regression gate (repro_torch.obs.regress) against the JAX
package's (repro.obs.regress and benchmarks/regress.py): format detection,
metric extraction and findings on every committed BENCH_PR*.json and on
perturbed copies, the CLI's modes and exit codes, and the profiler-overhead
protocol of chip_smoke.py (benchmarks/observe.py's, on the port) on a
small CPU server, whose document the gate must read. No time bound is
checked here: CPU wall clocks are unsteady, and the card's run
(chip_smoke.py phase 7) carries the overhead gate.
"""

import copy
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from repro.obs import regress as ref_regress
from repro_torch.models import cnn
from repro_torch.obs import profile, regress
from repro_torch.runtime.serve import ServeConfig, Server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = sorted(glob.glob(os.path.join(ROOT, "BENCH_PR[0-9]*.json")))


def _as_dicts(metrics: dict) -> dict:
    return {k: dataclasses.asdict(m) for k, m in metrics.items()}


def _findings(findings) -> list:
    return [dataclasses.asdict(f) for f in findings]


def _walk(doc, fn, key=None):
    """A copy of `doc` with fn(key, value) applied to every leaf."""
    if isinstance(doc, dict):
        return {k: _walk(v, fn, k) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_walk(v, fn, key) for v in doc]
    return fn(key, doc)


def _slower(doc):
    """Every time 2x, every throughput and speedup halved (the offered
    rates, which name the metrics, stay)."""
    def fn(key, v):
        if (isinstance(v, bool) or not isinstance(v, (int, float))
                or key is None):
            return v
        if key.endswith(("_ms", "_s")):
            return v * 2
        if key.startswith("throughput") or "speedup" in key:
            return v / 2
        return v
    return _walk(doc, fn)


def _dropped(doc):
    """One more dropped request wherever the format counts them."""
    return _walk(doc, lambda k, v: v + 1 if k == "dropped"
                 and isinstance(v, int) else v)


def _flipped(doc):
    """Every boolean gate false."""
    return _walk(doc, lambda k, v: False if isinstance(v, bool) else v)


@pytest.mark.parametrize("path", BENCH, ids=os.path.basename)
def test_extract_matches_reference(path):
    doc = regress.load(path)
    assert regress.detect(doc) == ref_regress.detect(doc)
    assert _as_dicts(regress.extract(doc)) == _as_dicts(
        ref_regress.extract(doc))


@pytest.mark.parametrize("perturb", [_slower, _dropped, _flipped],
                         ids=["2x_slower", "dropped", "gate_flipped"])
@pytest.mark.parametrize("path", BENCH, ids=os.path.basename)
def test_compare_matches_reference(path, perturb):
    base = regress.load(path)
    cur = perturb(copy.deepcopy(base))
    for kw in ({}, {"threshold": 3.0, "pct_margin": 1.0}):
        got = regress.compare(base, cur, **kw)
        assert _findings(got) == _findings(ref_regress.compare(base, cur,
                                                               **kw))
        assert regress.summarize(got) == ref_regress.summarize(got)


def test_perturbations_regress_where_the_format_gates():
    """The perturbed copies do regress: the serving benchmark on all three,
    the observe document on the flipped gates."""
    serving = regress.load(os.path.join(ROOT, "BENCH_PR7.json"))
    for perturb in (_slower, _dropped, _flipped):
        assert any(f.regressed for f in regress.compare(
            serving, perturb(serving)))
    observe = regress.load(os.path.join(ROOT, "BENCH_PR10.json"))
    assert any(f.regressed for f in regress.compare(observe,
                                                    _flipped(observe)))


# ---------------------------------------------------------------------------
# the CLI (benchmarks/regress.py's tests, on repro_torch.obs.regress.main)
# ---------------------------------------------------------------------------

def _serving_doc(p50=10.0, dropped=0):
    return {"clean": [{"rate_rps": 20, "p50_ms": p50, "p99_ms": 3 * p50,
                       "mean_ms": p50, "throughput_rps": 19.0,
                       "dropped": dropped, "incorrect": 0}],
            "faults": [], "zero_dropped": dropped == 0,
            "zero_incorrect": True, "fault_survived": True}


def test_regress_cli_fails_on_2x_slowdown(tmp_path):
    base, cur = tmp_path / "base.json", tmp_path / "cur.json"
    base.write_text(json.dumps(_serving_doc(p50=10.0)))
    cur.write_text(json.dumps(_serving_doc(p50=10.5)))
    assert regress.main([str(base), str(cur)]) == 0      # within threshold
    cur.write_text(json.dumps(_serving_doc(p50=20.0)))
    assert regress.main([str(base), str(cur)]) == 1      # injected 2x
    assert regress.main([str(base), str(cur), "--warn-only"]) == 0
    assert regress.main([str(base), str(cur), "--threshold", "3.0"]) == 0


def test_regress_count_and_bool_gates_zero_tolerance(tmp_path):
    base, cur = tmp_path / "base.json", tmp_path / "cur.json"
    base.write_text(json.dumps(_serving_doc(dropped=0)))
    cur.write_text(json.dumps(_serving_doc(dropped=1)))
    assert regress.main([str(base), str(cur)]) == 1      # any drop regresses


def test_regress_observe_format_machine_relative():
    ob = {"format": "repro.observe/v1", "overhead_pct": 1.0,
          "p50_disabled_ms": 100.0,
          "decomposition": {"max_residual_pct": 0.1},
          "gates": {"valid_chrome_trace": True}}
    worse = dict(ob, overhead_pct=9.0, p50_disabled_ms=900.0)
    findings = {f.metric: f for f in regress.compare(ob, worse)}
    assert findings["observe.overhead_pct"].regressed        # +8 points
    assert not findings["observe.p50_disabled_ms"].regressed
    assert not any(f.regressed for f in regress.compare(
        ob, dict(ob, overhead_pct=3.0)))
    broken = dict(ob, gates={"valid_chrome_trace": False})
    fs = {f.metric: f for f in regress.compare(ob, broken)}
    assert fs["observe.gate.valid_chrome_trace"].regressed


def test_regress_trajectory_pairs_committed_with_ci(tmp_path):
    root, ci = tmp_path / "root", tmp_path / "ci"
    root.mkdir(), ci.mkdir()
    (root / "BENCH_PR7.json").write_text(json.dumps(_serving_doc(10.0)))
    (ci / "BENCH_PR7_ci_x.json").write_text(json.dumps(_serving_doc(40.0)))
    # absolute serving metrics across machines: warn-only -> exit 0
    assert regress.main(["--trajectory", str(ci), "--root", str(root)]) == 0
    assert regress.main(["--trajectory", str(ci), "--root", str(root),
                         "--strict"]) == 1
    ob = {"format": "repro.observe/v1", "overhead_pct": 1.0,
          "gates": {"g": True}, "decomposition": {"max_residual_pct": 0.1}}
    (root / "BENCH_PR10.json").write_text(json.dumps(ob))
    (ci / "BENCH_PR10_ci_y.json").write_text(
        json.dumps(dict(ob, gates={"g": False})))
    assert regress.main(["--trajectory", str(ci), "--root", str(root)]) == 1
    assert regress.main(["--trajectory", str(tmp_path / "empty"),
                         "--root", str(root)]) == 2
    # the default root is this repository's, with its committed files
    assert str(regress.ROOT) == ROOT


# ---------------------------------------------------------------------------
# the observe protocol on a CPU server
# ---------------------------------------------------------------------------

def test_observe_protocol_document_reads_back(tmp_path):
    res = 16
    specs = [cnn.Conv("c1", 3, 3, 8), cnn.Conv("c2", 3, 3, 8, relu=False)]
    params = cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                          res=res, device="cpu")
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal((res, res, 3)).astype(np.float32)
              for _ in range(4)]
    config = ServeConfig(buckets=(1, 2), jit_dispatch=False, verbose=False)
    try:
        with Server(params, specs, res=res, config=config,
                    device="cpu") as srv:
            doc = chip_smoke.observe_protocol(
                srv, inputs, rng, rounds=2, per_round=3,
                trace_out=str(tmp_path / "trace.json"))
    finally:
        profile.disable()
    assert doc["requests_per_arm"] == 6
    assert doc["decomposition"]["requests"] == 6
    path = tmp_path / "observe.json"
    path.write_text(json.dumps(doc))
    metrics = regress.extract(regress.load(str(path)))
    assert regress.detect(doc) == "observe"
    assert set(doc["gates"]) == {"overhead_lt_10pct",
                                 "decomposition_residual_lt_1pct",
                                 "valid_chrome_trace", "layer_spans_present"}
    assert {f"observe.gate.{g}" for g in doc["gates"]} <= set(metrics)
    assert "observe.overhead_pct" in metrics
    # every gate but the timed one holds on the CPU
    assert all(v for g, v in doc["gates"].items()
               if g != "overhead_lt_10pct")
    assert doc["span_table"] and all(
        r["span"].startswith("layer:") for r in doc["span_table"])
    with open(tmp_path / "trace.json") as f:
        assert len(json.load(f)["traceEvents"]) == doc["trace_events"]
