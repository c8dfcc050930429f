"""The port's tuning database (repro_torch.obs.tuningdb): the JAX
package's four tuning-DB tests (tests/test_obs.py) on the port with its
real timer on the CPU, the walk into nested plan metas (conv1d, separable,
inverted residual), and databases crossing between the packages.

The reference's race cannot run on this host as it stands (jax 0.9 lacks
`jax.core.trace_state_clean`), so the cross-package tests give both
packages one injected `_time_apply` and the reference a `_measure_allowed`
that honours REPRO_PLAN_NO_MEASURE only, as tests/test_torch_autotune.py
does.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile as ref_compile
from repro.core import plan as ref_plan
from repro.models import cnn as ref_cnn
from repro.obs import tuningdb as ref_tuningdb
from repro_torch.core import compile as pt_compile
from repro_torch.core import plan as pt_plan
from repro_torch.models import audio as pt_audio
from repro_torch.models import cnn as pt_cnn
from repro_torch.obs import tuningdb

ROOT = Path(__file__).resolve().parents[1]
RES = 16
SPECS = [pt_cnn.Conv("c1", 3, 3, 8), pt_cnn.Conv("c2", 3, 3, 8, relu=False)]
REF_SPECS = [ref_cnn.Conv("c1", 3, 3, 8),
             ref_cnn.Conv("c2", 3, 3, 8, relu=False)]

#: Seconds by (executor, tile): the same fixed times in both packages, so
#: both races pick the same winners (tests/test_torch_autotune.py).
_BASE_MS = {"winograd": 4.0, "winograd_f63": 2.0, "fft": 3.0, "im2col": 6.0}


def _fake_time(plan, x, warmup=1, iters=3):
    s = plan.spec
    tile = 0.1 * s.output_tile[0] if s.output_tile else 0.0
    return (_BASE_MS[s.algorithm] + tile) * 1e-3


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    """The spec cache and the installed database must not leak between
    tests; planning here may measure."""
    monkeypatch.delenv("REPRO_PLAN_NO_MEASURE", raising=False)
    monkeypatch.delenv("REPRO_TUNING_DB", raising=False)
    pt_plan.clear_plan_cache()
    tuningdb.clear()
    yield
    pt_plan.clear_plan_cache()
    tuningdb.clear()
    ref_tuningdb.clear()


@pytest.fixture
def params():
    return pt_cnn.init_cnn(torch.Generator().manual_seed(0), SPECS, 3,
                           res=RES, device="cpu")


@pytest.fixture
def timed(monkeypatch):
    monkeypatch.setattr(ref_plan, "_measure_allowed",
                        lambda: not os.environ.get("REPRO_PLAN_NO_MEASURE"))
    monkeypatch.setattr(ref_plan, "_time_apply", _fake_time)
    monkeypatch.setattr(pt_plan, "_time_apply", _fake_time)
    return monkeypatch


def _compile(params):
    return pt_compile.compile(params, SPECS, res=RES, batch=1,
                              algorithm="auto_tuned", device="cpu")


def _placement(net):
    return {nid: (p.describe()["executor"], p.describe()["tile"])
            for nid, p in net.plans.items()}


def test_tuningdb_roundtrip_skips_measurement(params):
    net = _compile(params)
    assert pt_plan.plan_cache_info()["measured"] > 0
    db = tuningdb.export([net])
    assert db["format"] == "repro.tuning_db" and db["version"] == 1
    assert len(db["entries"]) == 2

    pt_plan.clear_plan_cache()
    assert tuningdb.install(db) == 2
    net2 = _compile(params)
    info = pt_plan.plan_cache_info()
    assert info["measured"] == 0, info
    assert info["tuningdb_hits"] == 2, info
    assert _placement(net2) == _placement(net)
    x = torch.zeros(1, RES, RES, 3)
    torch.testing.assert_close(net2.apply(x), net.apply(x), atol=1e-5,
                               rtol=0)
    plan = next(iter(net2.plans.values()))
    assert plan.describe()["decision"] == "measured"
    assert plan.spec.autotune_report["source"] == "tuning_db"


def test_tuningdb_merge_prefers_faster_evidence(params):
    db = tuningdb.export([_compile(params)])
    k, entry = next(iter(db["entries"].items()))
    slower = json.loads(json.dumps(db))
    slower["entries"][k]["winner_time_s"] = entry["winner_time_s"] * 10
    slower["entries"][k]["winner_label"] = "slow_variant"
    for merged in (tuningdb.merge(db, slower), tuningdb.merge(slower, db)):
        assert merged["entries"][k]["winner_label"] == entry["winner_label"]
        assert len(merged["hosts"]) == 2
    with pytest.raises(ValueError, match="not a tuning database"):
        tuningdb.merge(db, {"format": "something else"})


def test_tuningdb_fresh_process_zero_measurements(params, tmp_path):
    """A fresh process compiling under REPRO_TUNING_DB adopts the exported
    placements with zero measurements."""
    net = _compile(params)
    db_path = str(tmp_path / "fleet_db.json")
    tuningdb.save(tuningdb.export([net]), db_path)
    prog = (
        "import json, torch\n"
        "from repro_torch.core import compile as C, plan\n"
        "from repro_torch.models import cnn\n"
        "specs = [cnn.Conv('c1', 3, 3, 8),"
        " cnn.Conv('c2', 3, 3, 8, relu=False)]\n"
        "params = cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,"
        f" res={RES}, device='cpu')\n"
        f"net = C.compile(params, specs, res={RES}, batch=1,"
        " algorithm='auto_tuned', device='cpu')\n"
        "info = plan.plan_cache_info()\n"
        "print(json.dumps({'measured': info['measured'],"
        " 'tuningdb_hits': info['tuningdb_hits'],"
        " 'placement': {n: net.plans[n].describe()['executor']"
        " for n in net.plans}}))\n")
    env = dict(os.environ, REPRO_TUNING_DB=db_path,
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("REPRO_PLAN_NO_MEASURE", None)
    proc = subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["measured"] == 0, got
    assert got["tuningdb_hits"] == 2, got
    assert got["placement"] == {n: e for n, (e, _) in _placement(net).items()}


def test_tuningdb_rejects_unknown_and_foreign_entries(params):
    """Entries that do not validate against the live registry fall back to
    a local race instead of poisoning the plan."""
    db = tuningdb.export([_compile(params)])
    for entry in db["entries"].values():
        entry["winner"] = "no_such_executor"
    pt_plan.clear_plan_cache()
    tuningdb.install(db)
    _compile(params)
    info = pt_plan.plan_cache_info()
    assert info["tuningdb_hits"] == 0
    assert info["measured"] > 0
    with pytest.raises(ValueError, match="newer than this reader"):
        tuningdb.install(dict(db, version=tuningdb.VERSION + 1))


def test_collect_walks_nested_plan_metas(tmp_path):
    """Raced conv2d metas nested in conv1d (inner / subplans), separable
    and inverted-residual metas are all collected, from a live network, a
    saved artifact and a directory of artifacts alike."""
    cfg_d, n_mels = 16, 8
    g = torch.Generator().manual_seed(0)
    stem_params = {"conv1_w": torch.randn(3, n_mels, cfg_d, generator=g),
                   "conv1_b": torch.zeros(cfg_d),
                   "conv2_w": torch.randn(3, cfg_d, cfg_d, generator=g),
                   "conv2_b": torch.zeros(cfg_d)}
    stem = pt_compile.compile(stem_params, pt_audio.stem_graph(cfg_d),
                              input_shape=(1, 20, n_mels),
                              algorithm="auto_tuned", device="cpu")
    # stride 1 plans inner auto_tuned; stride 2 plans its im2col baseline
    assert len(tuningdb.collect(stem)) == 1
    specs = pt_cnn.NETWORKS["mobilenet_v2"][0]()
    mbv2 = pt_compile.compile(
        pt_cnn.init_cnn(torch.Generator().manual_seed(1), specs, 3, res=32,
                        device="cpu"),
        specs, res=32, batch=1, algorithm="auto_tuned", device="cpu")
    nested = tuningdb.collect(mbv2)
    assert nested
    for name, net in (("stem", stem), ("mbv2", mbv2)):
        net.save(str(tmp_path / f"{name}.npz"))
    assert tuningdb.collect(str(tmp_path / "mbv2.npz")) == nested
    assert tuningdb.collect(str(tmp_path)) == {**tuningdb.collect(stem),
                                               **nested}


def _ref_compile():
    ref_params = ref_cnn.init_cnn(jax.random.key(0), REF_SPECS, 3, res=RES)
    return ref_params, ref_compile.compile(ref_params, REF_SPECS, res=RES,
                                           batch=1, algorithm="auto_tuned")


def test_reference_database_installs_in_the_port(timed):
    """A database the reference exports, under the one injected timer,
    resolves the port's plans with zero measurements and the reference's
    winners."""
    ref_params, ref_net = _ref_compile()
    db = ref_tuningdb.export([ref_net])
    assert len(db["entries"]) == 2
    params = pt_cnn.params_from_reference(jax.tree.map(np.array, ref_params),
                                          "cpu")
    assert tuningdb.install(json.loads(json.dumps(db))) == 2
    net = _compile(params)
    info = pt_plan.plan_cache_info()
    assert info["measured"] == 0 and info["tuningdb_hits"] == 2, info
    assert {n: p.spec.algorithm for n, p in net.plans.items()} == \
        {n: p.spec.algorithm for n, p in ref_net.plans.items()}
    x = np.random.default_rng(0).standard_normal(
        (1, RES, RES, 3)).astype(np.float32)
    want = np.asarray(ref_net.apply(jnp.asarray(x)))
    got = net.apply(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


def test_port_database_installs_in_the_reference(timed, tmp_path):
    """The reverse: the port's exported file installs in the reference,
    whose plans then measure nothing and pick the port's winners."""
    ref_params, _ = _ref_compile()
    params = pt_cnn.params_from_reference(jax.tree.map(np.array, ref_params),
                                          "cpu")
    net = _compile(params)
    path = str(tmp_path / "port_db.json")
    tuningdb.save(tuningdb.export([net]), path)
    ref_plan.clear_plan_cache()
    assert ref_tuningdb.install(path) == 2

    def boom(*a, **k):
        raise AssertionError("a tuning-database hit must not measure")

    timed.setattr(ref_plan, "_measure_autotune", boom)
    ref_net = ref_compile.compile(ref_params, REF_SPECS, res=RES, batch=1,
                                  algorithm="auto_tuned")
    assert ref_plan.plan_cache_info()["tuningdb_hits"] == 2
    assert {n: p.spec.algorithm for n, p in ref_net.plans.items()} == \
        {n: p.spec.algorithm for n, p in net.plans.items()}
