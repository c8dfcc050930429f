"""The port's spec cache, planning counters and measured `auto_tuned` race
against the JAX package's (core/plan.py).

Two kinds of tests:

* Parity. The reference's race cannot run on this host as it stands (its
  `_measure_allowed` calls `jax.core.trace_state_clean`, which jax 0.9
  lacks), and real timings differ between the packages. So both packages
  get the same deterministic `_time_apply` (a fixed time per executor,
  tile and compute dtype) and the reference gets a `_measure_allowed`
  that honours REPRO_PLAN_NO_MEASURE only. Everything else runs as it
  is: the same seeded race inputs, the same contenders, the accuracy gate
  on real bf16 / int8 outputs. Winner, tile, dtype, the evidence keys in
  order and the t_* values must be equal; err_* agree to TOL_ERR;
  `plan_cache_info()` key for key.
* The reference's own cache and autotune tests (tests/test_plan.py,
  tests/test_precision.py, tests/test_fft_f63.py), on the port with its
  real timer on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as ref_plan
from repro_torch.core import plan as pt_plan
from repro_torch.core import winograd as pt_wg
from repro_torch.obs import metrics as pt_metrics
from repro_torch.obs import trace as pt_trace

ROOT = Path(__file__).resolve().parents[1]

#: err_* evidence: the relative max-abs error of a bf16 / int8 contender
#: against the fp32 `winograd` contender, computed on each side from its
#: own fp32 transforms (summed in another order) over the same bf16 taps or
#: int8 codes. They agree to 1e-7 absolute at errors of 1e-3 to 1e-2 and to
#: 3e-6 relative where a broken int8 tile reads 8 to 13; the limit is
#: relative to the reference's value, floored at 1e-6.
TOL_ERR = 1e-4
#: Output of a plan against F.conv2d / the oracle, relative max-abs error.
TOL_OUT = 1e-4

_BASE_MS = {"winograd": 4.0, "winograd_f63": 2.0, "fft": 3.0, "im2col": 6.0,
            "winograd_grouped": 2.5, "winograd_depthwise": 1.5,
            "winograd_strided": 2.2}
_DTYPE_MS = {"float32": 0.0, "bfloat16": 2.5, "int8": 3.5}


def _fake_time(plan, x, warmup=1, iters=3):
    """Seconds by (executor, tile, compute dtype): F(6, 3) beats FFT beats
    F(2, .) beats F(4, .) beats im2col, and a reduced dtype is faster
    still. A spec of either package carries the three."""
    s = plan.spec
    ms = _BASE_MS[s.algorithm] + (0.1 * s.output_tile[0]
                                  if s.output_tile else 0.0)
    return (ms - _DTYPE_MS[s.compute_dtype]) * 1e-3


def _fft_fastest(plan, x, warmup=1, iters=3):
    return 1e-4 if plan.spec.algorithm == "fft" else _fake_time(plan, x)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """The port's spec cache and tuning database must not leak between
    tests (the reference's are cleared by tests/conftest.py)."""
    pt_plan.clear_plan_cache()
    pt_plan.set_tuning_db(None)
    yield
    pt_plan.clear_plan_cache()
    pt_plan.set_tuning_db(None)
    ref_plan.set_tuning_db(None)


@pytest.fixture
def timed(monkeypatch):
    """The injected timer in both packages; the reference may measure
    wherever REPRO_PLAN_NO_MEASURE is unset."""
    monkeypatch.setattr(ref_plan, "_measure_allowed",
                        lambda: not os.environ.get("REPRO_PLAN_NO_MEASURE"))
    monkeypatch.setattr(ref_plan, "_time_apply", _fake_time)
    monkeypatch.setattr(pt_plan, "_time_apply", _fake_time)
    return monkeypatch


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _direct(x, w, stride=1, padding="SAME", groups=1):
    """NHWC x HWIO conv through torch's own conv2d, float64, with the
    reference's SAME pads."""
    from repro_torch.core.im2col import _same_pads
    xc = torch.from_numpy(np.asarray(x, np.float64)).permute(0, 3, 1, 2)
    wc = torch.from_numpy(np.asarray(w, np.float64)).permute(3, 2, 0, 1)
    kh, kw = w.shape[:2]
    if padding == "SAME":
        ph = _same_pads(x.shape[1], kh, stride)
        pw = _same_pads(x.shape[2], kw, stride)
        xc = torch.nn.functional.pad(xc, (*pw, *ph))
    y = torch.nn.functional.conv2d(xc, wc, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1).numpy()


def _both(x_shape, w, **kw):
    ref = ref_plan.plan_conv2d(x_shape, jnp.asarray(w), **kw)
    got = pt_plan.plan_conv2d(x_shape, torch.from_numpy(w), device="cpu",
                              **kw)
    return ref, got


def _assert_same_race(ref, got):
    rs, gs = ref.spec, got.spec
    assert gs.algorithm == rs.algorithm
    assert gs.output_tile == rs.output_tile
    assert gs.compute_dtype == rs.compute_dtype
    assert rs.autotune is not None and gs.autotune is not None
    assert [k for k, _ in gs.autotune] == [k for k, _ in rs.autotune]
    for (k, rv), (_, gv) in zip(rs.autotune, gs.autotune):
        if k.startswith("err_"):
            assert abs(gv - rv) <= TOL_ERR * max(abs(rv), 1e-2), (k, rv, gv)
        else:
            assert gv == rv, (k, rv, gv)
    assert got.describe() == ref.describe()
    assert pt_plan.plan_cache_info() == ref_plan.plan_cache_info()


#: (x_shape, w_shape, groups, stride): a dense 3x3 (every contender), the
#: 5x5 and 7x7 F(2, .) layers (no F(6, 3); int8 over its budget), grouped,
#: depthwise and stride-2 layers (their own fast executor, no F(2, 3) /
#: F(6, 3) / FFT contender), and a wider 3x3.
RACE_CASES = [((1, 16, 16, 8), (3, 3, 8, 8), 1, 1),
              ((1, 16, 16, 8), (5, 5, 8, 8), 1, 1),
              ((1, 16, 16, 8), (7, 7, 8, 8), 1, 1),
              ((1, 12, 12, 8), (3, 3, 2, 8), 4, 1),
              ((1, 12, 12, 8), (3, 3, 1, 8), 8, 1),
              ((1, 16, 16, 8), (3, 3, 8, 8), 1, 2),
              ((1, 40, 40, 16), (3, 3, 16, 16), 1, 1)]
RACE_IDS = ["3x3", "5x5", "7x7", "grouped", "depthwise", "stride2", "3x3c16"]


@pytest.mark.parametrize("compute_dtype", ["float32", "auto", "int8",
                                           "bfloat16"])
@pytest.mark.parametrize("x_shape,w_shape,groups,stride", RACE_CASES,
                         ids=RACE_IDS)
def test_race_matches_reference(timed, x_shape, w_shape, groups, stride,
                                compute_dtype):
    w = (np.random.default_rng(1).standard_normal(w_shape)
         / 9).astype(np.float32)
    ref, got = _both(x_shape, w, groups=groups, stride=stride,
                     algorithm="auto_tuned", compute_dtype=compute_dtype)
    _assert_same_race(ref, got)
    # planned again: a spec-cache hit on both sides, nothing re-measured
    ref2, got2 = _both(x_shape, w, groups=groups, stride=stride,
                       algorithm="auto_tuned", compute_dtype=compute_dtype)
    assert got2.spec is got.spec
    assert pt_plan.plan_cache_info() == ref_plan.plan_cache_info()
    assert pt_plan.plan_cache_info()["hits"] == 1
    assert pt_plan.plan_cache_info()["measured"] == 1


def test_race_gates_int8_off_large_tiles(timed):
    """At F(2, 5) one int8 scale per output channel over 36 transform
    points leaves the small points a few codes: the int8 contender reads
    an error far over its budget in both packages and may not win, though
    the injected timer makes it the fastest."""
    w = (np.random.default_rng(2).standard_normal((5, 5, 8, 8))
         / 25).astype(np.float32)
    ref, got = _both((1, 16, 16, 8), w, algorithm="auto_tuned",
                     compute_dtype="auto")
    _assert_same_race(ref, got)
    report = got.spec.autotune_report
    assert report["err_winograd_int8"] > \
        pt_plan.AUTOTUNE_ACCURACY_BUDGET["int8"]
    assert "t_winograd_int8_s" not in report
    assert got.spec.compute_dtype != "int8"
    assert got.describe()["decision"] == "measured"


def test_race_picks_fft_alike(monkeypatch):
    monkeypatch.setattr(ref_plan, "_measure_allowed", lambda: True)
    monkeypatch.setattr(ref_plan, "_time_apply", _fft_fastest)
    monkeypatch.setattr(pt_plan, "_time_apply", _fft_fastest)
    w = (np.random.default_rng(3).standard_normal((5, 5, 6, 7))
         / 25).astype(np.float32)
    ref, got = _both((2, 21, 17, 6), w, algorithm="auto_tuned")
    _assert_same_race(ref, got)
    assert got.algorithm == "fft"
    x = np.random.default_rng(4).standard_normal(
        (2, 21, 17, 6)).astype(np.float32)
    y = got.apply(torch.from_numpy(x)).numpy()
    assert _rel(y, _direct(x, w)) <= TOL_OUT
    assert _rel(y, np.asarray(ref.apply(jnp.asarray(x)))) <= TOL_OUT


def test_heuristic_fallback_counts_alike_and_is_not_cached(timed):
    w = (np.random.default_rng(5).standard_normal((3, 3, 8, 8))
         / 9).astype(np.float32)
    timed.setenv("REPRO_PLAN_NO_MEASURE", "1")
    for _ in range(2):
        ref, got = _both((1, 20, 20, 8), w, algorithm="auto_tuned")
        assert got.describe() == ref.describe()
        assert got.describe()["decision"] == "heuristic"
    info = pt_plan.plan_cache_info()
    assert info == ref_plan.plan_cache_info()
    assert (info["fallback"], info["misses"], info["hits"],
            info["size"]) == (2, 2, 0, 0)
    timed.delenv("REPRO_PLAN_NO_MEASURE")
    ref, got = _both((1, 20, 20, 8), w, algorithm="auto_tuned")
    _assert_same_race(ref, got)
    assert pt_plan.plan_cache_info()["measured"] == 1
    # the sole-candidate im2col case (stride 3: no winograd executor) is a
    # fallback and is cached
    ref, got = _both((1, 12, 12, 8), w, stride=3, algorithm="auto_tuned")
    ref, got = _both((1, 12, 12, 8), w, stride=3, algorithm="auto_tuned")
    assert got.algorithm == ref.spec.algorithm == "im2col"
    assert got.spec.autotune is None
    assert pt_plan.plan_cache_info() == ref_plan.plan_cache_info()
    assert pt_plan.plan_cache_info()["fallback"] == 3


def test_tuning_db_resolution_matches_reference(timed):
    """A database entry built from the race's evidence resolves the layer
    with zero measurements, alike in both packages (same key string)."""
    w = (np.random.default_rng(6).standard_normal((3, 3, 8, 8))
         / 9).astype(np.float32)
    x_shape = (1, 16, 16, 8)
    ref, got = _both(x_shape, w, algorithm="auto_tuned")
    key = pt_plan.tuning_db_key(x_shape, (3, 3, 8, 8), "float32", (1, 1),
                                "SAME", 1, "NHWC", "float32", None)
    assert key == ref_plan.tuning_db_key(x_shape, (3, 3, 8, 8), "float32",
                                         (1, 1), "SAME", 1, "NHWC",
                                         "float32", None)
    report = got.spec.autotune_report
    entries = {key: {"winner": report["winner"],
                     "winner_dtype": report["winner_dtype"],
                     "winner_tile": list(report["winner_tile"]),
                     "evidence": [list(kv) for kv in got.spec.autotune]}}
    pt_plan.clear_plan_cache()
    ref_plan.clear_plan_cache()
    pt_plan.set_tuning_db(entries)
    ref_plan.set_tuning_db(entries)

    def boom(*a, **k):
        raise AssertionError("a tuning-database hit must not measure")

    timed.setattr(pt_plan, "_measure_autotune", boom)
    timed.setattr(ref_plan, "_measure_autotune", boom)
    ref, got = _both(x_shape, w, algorithm="auto_tuned")
    assert got.spec.autotune == ref.spec.autotune
    assert got.spec.autotune_report["source"] == "tuning_db"
    assert got.algorithm == ref.spec.algorithm
    assert pt_plan.plan_cache_info() == ref_plan.plan_cache_info()
    assert pt_plan.plan_cache_info()["tuningdb_hits"] == 1


def test_plan_cache_info_has_the_reference_keys():
    assert list(pt_plan.plan_cache_info()) == list(ref_plan.plan_cache_info())


@pytest.mark.parametrize("kind", ["separable", "conv1d_depthwise"])
def test_block_and_conv1d_specs_count_alike(kind):
    """plan_separable_block's fused spec and plan_depthwise_conv1d's spec
    sit in the same cache, hit and missed as in the reference."""
    rng = np.random.default_rng(7)
    if kind == "separable":
        w_dw = (rng.standard_normal((3, 3, 1, 8)) / 3).astype(np.float32)
        w_pw = (rng.standard_normal((1, 1, 8, 16)) / 3).astype(np.float32)
        for _ in range(2):
            ref_plan.plan_separable_block((1, 12, 12, 8), jnp.asarray(w_dw),
                                          jnp.asarray(w_pw),
                                          algorithm="pallas_winograd")
            pt_plan.plan_separable_block((1, 12, 12, 8),
                                         torch.from_numpy(w_dw),
                                         torch.from_numpy(w_pw),
                                         algorithm="pallas_winograd",
                                         device="cpu")
    else:
        w = rng.standard_normal((4, 16)).astype(np.float32)
        for backend in ("jnp", "jnp", "pallas"):
            ref_plan.plan_depthwise_conv1d((2, 30, 16), jnp.asarray(w),
                                           backend=backend)
            pt_plan.plan_depthwise_conv1d((2, 30, 16), torch.from_numpy(w),
                                          backend=backend, device="cpu")
    assert pt_plan.plan_cache_info() == ref_plan.plan_cache_info()
    assert pt_plan.plan_cache_info()["hits"] == 1


def test_artifact_carries_evidence_and_warm_load_measures_nothing(
        timed, tmp_path):
    """A raced layer in a NetworkPlan: the artifact's meta carries the
    evidence as the reference writes it, and a load in a fresh process
    re-measures and re-quantizes nothing and describes the plan as
    measured."""
    from repro_torch.core import compile as pt_compile
    from repro_torch.models import cnn as pt_cnn
    specs = [pt_cnn.Conv("c1", 3, 3, 8), pt_cnn.Conv("c2", 3, 3, 8)]
    params = pt_cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                             res=16, device="cpu")
    net = pt_compile.compile(params, specs, res=16, batch=1,
                             algorithm="auto_tuned", device="cpu")
    assert pt_plan.plan_cache_info()["measured"] == 2
    table = {nid: p.describe() for nid, p in net.plans.items()}
    assert all(d["decision"] == "measured" for d in table.values())
    meta, _ = net.plans["c2"].to_artifact()
    assert meta["autotune"] == [list(kv) for kv in
                                net.plans["c2"].spec.autotune]
    path = str(tmp_path / "net.npz")
    net.save(path)
    code = (
        "import json, sys, torch\n"
        "from repro_torch.core import compile as C, plan as P\n"
        f"net = C.NetworkPlan.load({path!r}, device='cpu')\n"
        "print(json.dumps({'info': P.plan_cache_info(), 'table': "
        "{n: p.describe() for n, p in net.plans.items()}, 'auto': "
        "{n: [list(kv) for kv in p.spec.autotune] for n, p in "
        "net.plans.items()}}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert loaded["info"]["measured"] == 0
    assert loaded["info"]["fallback"] == 0
    assert loaded["info"]["quantized"] == 0
    assert loaded["info"]["artifact_hits"] == 1
    assert loaded["table"] == table
    for nid, p in net.plans.items():
        assert loaded["auto"][nid] == [list(kv) for kv in json.loads(
            json.dumps(p.spec.autotune))]


# ---------------------------------------------------------------------------
# tests/test_plan.py's cache and autotune tests, on the port
# ---------------------------------------------------------------------------

def _spec_cache():
    info = pt_plan.plan_cache_info()
    return (info["hits"], info["misses"], info["size"])


def _w(*shape, seed=0, scale=3.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) / scale).astype(np.float32))


def test_cache_hit_on_same_shape_miss_on_new():
    w = _w(3, 3, 4, 4)
    assert _spec_cache() == (0, 0, 0)
    p1 = pt_plan.plan_conv2d((1, 12, 12, 4), w, device="cpu")
    assert _spec_cache() == (0, 1, 1)
    p2 = pt_plan.plan_conv2d((1, 12, 12, 4), w, device="cpu")
    assert _spec_cache() == (1, 1, 1)
    assert p1.spec is p2.spec                  # decisions shared
    pt_plan.plan_conv2d((1, 16, 16, 4), w, device="cpu")
    assert _spec_cache() == (1, 2, 2)
    pt_plan.plan_conv2d((1, 12, 12, 4), w, algorithm="im2col", device="cpu")
    assert _spec_cache() == (1, 3, 3)


def test_cache_key_includes_padding_and_stride():
    w = _w(3, 3, 4, 4)
    pt_plan.plan_conv2d((1, 12, 12, 4), w, padding="SAME", device="cpu")
    pt_plan.plan_conv2d((1, 12, 12, 4), w, padding="VALID", device="cpu")
    pt_plan.plan_conv2d((1, 12, 12, 4), w, stride=2, device="cpu")
    assert pt_plan.plan_cache_info()["misses"] == 3
    assert pt_plan.plan_cache_info()["hits"] == 0


def test_cache_key_includes_the_card(monkeypatch):
    """A spec whose kernel blocking was sized for one multiprocessor count
    is not served for another."""
    w = _w(3, 3, 4, 4)
    p1 = pt_plan.plan_conv2d((1, 12, 12, 4), w, algorithm="pallas_winograd",
                             device="cpu")
    monkeypatch.setattr(pt_plan, "_sm_count", lambda device: 66)
    p2 = pt_plan.plan_conv2d((1, 12, 12, 4), w, algorithm="pallas_winograd",
                             device="cpu")
    assert _spec_cache() == (0, 2, 2)
    assert p2.spec is not p1.spec


def test_clear_plan_cache():
    pt_plan.plan_conv2d((1, 12, 12, 4), _w(3, 3, 4, 4), device="cpu")
    pt_plan.clear_plan_cache()
    assert _spec_cache() == (0, 0, 0)


def test_no_cache_switch(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_NO_CACHE", "1")
    w = _w(3, 3, 4, 4)
    p1 = pt_plan.plan_conv2d((1, 12, 12, 4), w, device="cpu")
    p2 = pt_plan.plan_conv2d((1, 12, 12, 4), w, device="cpu")
    assert _spec_cache() == (0, 2, 0)
    assert p1.spec is not p2.spec and p1.spec == p2.spec


def test_filter_transform_called_exactly_once(monkeypatch):
    calls = {"n": 0}
    real = pt_wg.transform_filter_2d

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(pt_wg, "transform_filter_2d", counting)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 12, 12, 4)).astype(np.float32))
    p = pt_plan.plan_conv2d(x.shape, _w(3, 3, 4, 4), algorithm="winograd",
                            device="cpu")
    assert calls["n"] == 1
    for _ in range(3):
        p.apply(x)
    assert calls["n"] == 1


@pytest.mark.parametrize("algorithm", ["winograd", "winograd_f63", "fft"])
def test_no_geometry_derivation_in_apply(monkeypatch, algorithm):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 12, 12, 4)).astype(np.float32))
    p = pt_plan.plan_conv2d(x.shape, _w(3, 3, 4, 4), algorithm=algorithm,
                            device="cpu")

    def boom(*args, **kwargs):
        raise AssertionError("_pad_amounts called during apply()")

    monkeypatch.setattr(pt_wg, "_pad_amounts", boom)
    p.apply(x)


def test_plan_records_build_time_and_domain_filter():
    p = pt_plan.plan_conv2d((1, 12, 12, 4), _w(3, 3, 4, 6),
                            algorithm="winograd", device="cpu")
    ct = p.spec.ct_h
    assert tuple(p.u.shape) == (ct.t, ct.t, 4, 6)
    assert p.build_time_s > 0


def test_auto_tuned_measures_once_and_caches_winner():
    x_shape = (1, 20, 20, 8)
    w = _w(3, 3, 8, 8)
    p = pt_plan.plan_conv2d(x_shape, w, algorithm="auto_tuned", device="cpu")
    assert p.algorithm in ("winograd", "winograd_f63", "fft", "im2col")
    report = p.spec.autotune_report
    assert report is not None
    assert report["winner"] == p.algorithm
    assert report["t_winograd_s"] > 0 and report["t_im2col_s"] > 0
    before = pt_plan.plan_cache_info()["hits"]
    p2 = pt_plan.plan_conv2d(x_shape, w, algorithm="auto_tuned",
                             device="cpu")
    assert pt_plan.plan_cache_info()["hits"] == before + 1
    assert p2.spec is p.spec


@pytest.mark.parametrize("where", ["compiling", "capturing", "env"])
def test_auto_tuned_falls_back_where_nothing_may_be_measured(monkeypatch,
                                                             where):
    """Under torch.compile tracing, a CUDA graph capture or
    REPRO_PLAN_NO_MEASURE the static predicate decides, the decision is
    not cached, and a later plan where measuring is allowed measures."""
    if where == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    elif where == "capturing":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
    else:
        monkeypatch.setenv("REPRO_PLAN_NO_MEASURE", "1")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 20, 20, 8)).astype(np.float32))
    w = _w(3, 3, 8, 8)
    p = pt_plan.plan_conv2d(x.shape, w, algorithm="auto_tuned", device="cpu")
    assert p.describe()["decision"] == "heuristic"
    assert _rel(p.apply(x).numpy(), _direct(x.numpy(), w.numpy())) \
        <= TOL_OUT
    assert pt_plan.plan_cache_info()["fallback"] == 1
    assert pt_plan.plan_cache_info()["size"] == 0
    monkeypatch.undo()
    p = pt_plan.plan_conv2d(x.shape, w, algorithm="auto_tuned", device="cpu")
    assert p.spec.autotune_report is not None
    assert pt_plan.plan_cache_info()["measured"] == 1


def test_auto_tuned_unsuitable_layer_skips_measurement():
    p = pt_plan.plan_conv2d((1, 12, 12, 4), _w(3, 3, 4, 4), stride=3,
                            algorithm="auto_tuned", device="cpu")
    assert p.algorithm == "im2col"
    assert p.spec.autotune is None
    assert pt_plan.plan_cache_info()["fallback"] == 1


def test_forced_winograd_on_uncovered_layer_raises():
    with pytest.raises(ValueError, match="im2col"):
        pt_plan.plan_conv2d((1, 12, 12, 4), _w(3, 3, 4, 4), stride=3,
                            algorithm="winograd", device="cpu")


# ---------------------------------------------------------------------------
# tests/test_precision.py's dtype-race tests and tests/test_fft_f63.py's
# race tests, on the port
# ---------------------------------------------------------------------------

def test_fp32_only_executors_reject_reduced_dtypes():
    for alg in ("fft", "winograd_f63"):
        with pytest.raises(ValueError, match="float32"):
            pt_plan.plan_conv2d((1, 16, 16, 8), _w(3, 3, 8, 8, scale=9),
                                algorithm=alg, compute_dtype="int8",
                                device="cpu")


def test_compute_dtype_is_part_of_the_cache_key():
    w = _w(3, 3, 8, 8, scale=9)
    pt_plan.plan_conv2d((1, 12, 12, 8), w, device="cpu")
    pt_plan.plan_conv2d((1, 12, 12, 8), w, compute_dtype="int8",
                        device="cpu")
    info = pt_plan.plan_cache_info()
    assert info["misses"] == 2 and info["hits"] == 0
    assert info["quantized"] == 1
    p = pt_plan.plan_conv2d((1, 12, 12, 8), w, compute_dtype="int8",
                            device="cpu")
    assert pt_plan.plan_cache_info()["hits"] == 1
    assert p.spec.compute_dtype == "int8"


def test_autotune_race_gates_reduced_dtypes_on_accuracy():
    p = pt_plan.plan_conv2d((1, 28, 28, 64), _w(3, 3, 64, 64, scale=9),
                            algorithm="auto_tuned", compute_dtype="auto",
                            device="cpu")
    report = p.spec.autotune_report
    assert report and report.get("winner_dtype") is not None
    errs = {k: v for k, v in report.items() if k.startswith("err_")}
    assert set(errs) == {"err_winograd_bf16", "err_winograd_int8"}
    wd = report["winner_dtype"]
    if wd != "float32":
        lbl = report["winner_label"]
        assert errs[f"err_{lbl}"] <= pt_plan.AUTOTUNE_ACCURACY_BUDGET[wd]


def test_default_auto_tuned_race_never_lowers_precision():
    w = _w(3, 3, 64, 64, scale=9)
    p = pt_plan.plan_conv2d((1, 28, 28, 64), w, algorithm="auto_tuned",
                            device="cpu")
    assert p.spec.compute_dtype == "float32"
    report = p.spec.autotune_report or {}
    assert not any(k.startswith("err_") for k in report)
    assert not any(k in ("t_winograd_bf16_s", "t_winograd_int8_s")
                   for k in report)
    with pytest.raises(ValueError, match="auto_tuned"):
        pt_plan.plan_conv2d((1, 28, 28, 64), w, algorithm="winograd",
                            compute_dtype="auto", device="cpu")


def test_auto_tuned_races_all_eligible_contenders():
    p = pt_plan.plan_conv2d((1, 18, 18, 8), _w(3, 3, 8, 8),
                            algorithm="auto_tuned", device="cpu")
    report = p.spec.autotune_report
    for key in ("t_winograd_s", "t_winograd_f2_s", "t_f63_s", "t_fft_s",
                "t_im2col_s"):
        assert report[key] > 0, key
    assert report["winner"] == p.spec.algorithm
    times = {k: v for k, v in report.items() if k.startswith("t_")}
    assert report[f"t_{report['winner_label']}_s"] == min(times.values())
    assert p.describe()["decision"] == "measured"


def test_auto_tuned_five_filter_race_skips_f63():
    p = pt_plan.plan_conv2d((1, 16, 16, 4), _w(5, 5, 4, 4, scale=5),
                            algorithm="auto_tuned", device="cpu")
    report = p.spec.autotune_report
    assert "t_f63_s" not in report
    assert report["t_fft_s"] > 0


def test_static_algorithms_report_static_decision():
    w = _w(3, 3, 4, 4)
    for alg in ("winograd", "fft", "winograd_f63", "im2col"):
        p = pt_plan.plan_conv2d((1, 12, 12, 4), w, algorithm=alg,
                                device="cpu")
        assert p.describe()["decision"] == "static"
    assert pt_plan.plan_cache_info()["measured"] == 0


def test_auto_tuned_winner_tile_rebuilds_from_artifact(monkeypatch):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 18, 18, 8)).astype(np.float32))
    p = pt_plan.plan_conv2d(x.shape, _w(3, 3, 8, 8), algorithm="auto_tuned",
                            device="cpu")
    meta, arrays = p.to_artifact()
    want = p.apply(x)

    def boom(*a, **k):
        raise AssertionError("warm load must not measure or re-transform")

    monkeypatch.setattr(pt_plan, "_measure_autotune", boom)
    monkeypatch.setattr(pt_plan, "_bind_weights", boom)
    p2 = pt_plan.ConvPlan.from_artifact(meta, arrays, device="cpu")
    assert p2.spec.algorithm == p.spec.algorithm
    assert p2.spec.output_tile == p.spec.output_tile
    assert p2.spec.autotune_report == p.spec.autotune_report
    assert p2.describe()["decision"] == "measured"
    assert torch.equal(p2.apply(x), want)


def test_counters_and_race_span_reach_observability():
    """Each planning counter is mirrored into the default metrics registry
    under the reference's names, and each race is one plan.autotune.race
    span."""
    pt_metrics.reset()
    pt_trace.enable()
    pt_trace.get().clear()
    try:
        w = _w(3, 3, 8, 8)
        pt_plan.plan_conv2d((1, 16, 16, 8), w, algorithm="auto_tuned",
                            device="cpu")
        pt_plan.plan_conv2d((1, 16, 16, 8), w, algorithm="auto_tuned",
                            device="cpu")
        pt_plan.plan_conv2d((1, 12, 12, 8), w, stride=3,
                            algorithm="auto_tuned", device="cpu")
        counters = pt_metrics.snapshot_all()["default"]["counters"]
        races = pt_trace.get().spans("plan.autotune.race")
    finally:
        pt_trace.disable()
        pt_metrics.reset()
    assert counters == {"plan.cache.miss": 2, "plan.cache.hit": 1,
                        "plan.autotune.measured": 1,
                        "plan.autotune.fallback": 1}
    assert len(races) == 1
    assert races[0].args["winner"] in ("winograd", "winograd_f63", "fft",
                                       "im2col")
    assert races[0].args["contenders"] == 5
