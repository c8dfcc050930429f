"""The port's Conv1DPlan (core/plan.py:plan_conv1d) against the JAX
package's on the same seeded numpy inputs: the three modes (as2d,
polyphase, im2col) and their describe() rows, outputs after bias + GELU at
even and odd lengths, the artifact round trip, and each package reading
the other's conv1d artifacts (plan metas and whole .npz files).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile as ref_compile
from repro.core import plan as ref_plan
from repro.models import audio as ref_audio
from repro_torch.core import compile as pt_compile
from repro_torch.core import plan as pt_plan
from repro_torch.models import audio as pt_audio

#: Output against the reference, relative max-abs error (of the
#: reference's max |y|): the same fp32 Cook-Toom transforms and GEMMs,
#: summed in other orders.
TOL = 1e-5

#: (stride, algorithm) -> the mode the reference plans.
MODES = {(1, "auto"): "as2d", (1, "winograd"): "as2d",
         (1, "im2col"): "as2d", (1, "pallas_winograd"): "as2d",
         (2, "auto"): "polyphase", (2, "winograd"): "polyphase",
         (2, "im2col"): "im2col", (2, "pallas_winograd"): "im2col"}


@pytest.fixture(autouse=True)
def _fresh_port_cache():
    pt_plan.clear_plan_cache()
    yield
    pt_plan.clear_plan_cache()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _inputs(length, c=6, m=10, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, length, c)).astype(np.float32)
    w = (rng.standard_normal((k, c, m)) / np.sqrt(k * c)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    return x, w, b


def _both(x, w, **kw):
    ref = ref_plan.plan_conv1d(x.shape, jnp.asarray(w), **kw)
    got = pt_plan.plan_conv1d(x.shape, torch.from_numpy(w), device="cpu",
                              **kw)
    return ref, got


@pytest.mark.parametrize("stride,algorithm", sorted(MODES))
@pytest.mark.parametrize("length", [20, 32, 33])
def test_conv1d_plan_matches_reference(length, stride, algorithm):
    x, w, b = _inputs(length)
    ref, got = _both(x, w, stride=stride, algorithm=algorithm)
    assert got.mode == ref.mode == MODES[(stride, algorithm)]
    assert got.describe() == ref.describe()
    assert (got.pad, got.out_len) == (tuple(ref.pad), ref.out_len)
    want = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                activation="gelu"))
    y = got.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                  activation="gelu")
    assert tuple(y.shape) == want.shape == (2, -(-length // stride), 10)
    assert _rel(y.numpy(), want) < TOL


@pytest.mark.parametrize("k,stride", [(5, 2), (3, 3), (2, 2)])
def test_polyphase_sub_filters_and_valid_padding(k, stride):
    """Longer filters, stride 3, and k == stride (no polyphase: im2col);
    VALID padding crops as the reference does."""
    x, w, b = _inputs(33, k=k)
    for padding in ("SAME", "VALID"):
        ref, got = _both(x, w, stride=stride, padding=padding,
                         algorithm="auto")
        assert got.describe() == ref.describe()
        want = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                    activation="relu"))
        y = got.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                      activation="relu")
        assert tuple(y.shape) == want.shape
        assert _rel(y.numpy(), want) < TOL


@pytest.mark.parametrize("stride,algorithm", [(1, "auto"), (2, "auto"),
                                              (2, "im2col")])
def test_artifact_roundtrip_is_bitwise(stride, algorithm):
    x, w, b = _inputs(33)
    plan = pt_plan.plan_conv1d(x.shape, torch.from_numpy(w), stride=stride,
                               algorithm=algorithm, device="cpu")
    meta, arrays = plan.to_artifact()
    assert meta["kind"] == "conv1d"
    prefixes = {k.split(".")[0] for k in arrays}
    assert prefixes == ({"inner"} if plan.mode != "polyphase"
                        else {"sub0", "sub1"})
    again = pt_plan.plan_from_artifact(meta, arrays, device="cpu")
    assert again.describe() == plan.describe()
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    assert torch.equal(again.apply(xt, bias=bt, activation="gelu"),
                       plan.apply(xt, bias=bt, activation="gelu"))


@pytest.mark.parametrize("stride", [1, 2])
def test_plan_metas_cross_read(stride):
    """Each package's plan_from_artifact rebuilds the other's conv1d plan
    (meta and arrays) and answers alike."""
    x, w, b = _inputs(33)
    ref, got = _both(x, w, stride=stride, algorithm="auto")
    ref_meta, ref_arrays = ref.to_artifact()
    pt_meta, pt_arrays = got.to_artifact()
    assert set(ref_arrays) == set(pt_arrays)
    from_ref = pt_plan.plan_from_artifact(
        ref_meta, {k: np.asarray(v) for k, v in ref_arrays.items()},
        device="cpu")
    from_pt = ref_plan.plan_from_artifact(pt_meta, pt_arrays)
    want = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                activation="gelu"))
    y = from_ref.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                       activation="gelu")
    assert _rel(y.numpy(), want) < TOL
    y_ref = np.asarray(from_pt.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                     activation="gelu"))
    assert _rel(y_ref, want) < TOL
    assert from_ref.describe() == from_pt.describe() == ref.describe()


def test_stem_artifact_files_cross_verify(tmp_path):
    """The compiled stem saved by each package passes the other's
    verify_artifact, and the conv1d plans of the other's file rebuild
    through plan_from_artifact."""
    rng = np.random.default_rng(3)
    params_np = {
        "conv1_w": (rng.standard_normal((3, 8, 16)) / 5).astype(np.float32),
        "conv1_b": rng.standard_normal(16).astype(np.float32),
        "conv2_w": (rng.standard_normal((3, 16, 16)) / 7).astype(np.float32),
        "conv2_b": rng.standard_normal(16).astype(np.float32)}
    shape = (2, 33, 8)
    ref_net = ref_compile.compile(
        {k: jnp.asarray(v) for k, v in params_np.items()},
        ref_audio.stem_graph(16), input_shape=shape)
    pt_net = pt_compile.compile(
        pt_audio.params_from_reference(params_np, device="cpu"),
        pt_audio.stem_graph(16), input_shape=shape, device="cpu")
    ref_path, pt_path = str(tmp_path / "ref.npz"), str(tmp_path / "pt.npz")
    ref_net.save(ref_path)
    pt_net.save(pt_path)
    for path in (ref_path, pt_path):
        assert ref_compile.verify_artifact(path) == []
        assert pt_compile.verify_artifact(path) == []
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(ref_net.apply(jnp.asarray(x)))
    with np.load(ref_path, allow_pickle=False) as data:
        header = json.loads(str(data["__header__"][()]))
        plans = {nid: pt_plan.plan_from_artifact(
            meta, {k.split(":", 2)[2]: data[k] for k in data.files
                   if k.startswith(f"plan:{nid}:")}, device="cpu")
            for nid, meta in header["plans"].items()}
    y = torch.from_numpy(x)
    for nid in ("conv1", "conv2"):
        y = plans[nid].apply(y, bias=torch.from_numpy(params_np[f"{nid}_b"]),
                             activation="gelu")
    assert _rel(y.numpy(), want) < TOL
    loaded = pt_compile.NetworkPlan.load(pt_path, device="cpu")
    assert torch.equal(loaded.apply(torch.from_numpy(x)),
                       pt_net.apply(torch.from_numpy(x)))
