"""NetworkPlan artifacts in the port on the CPU: save / load of
MobileNet-v2 at res 32 under pallas_winograd (every kernel on its plain
version here) round-trips bitwise with no filter transform and no blocking
chooser at load, the per-array digests catch a flipped bit, and the
artifact format is the reference's: each package's verify_artifact accepts
the other's files, and params_digest of carried-across params equals the
reference's."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.core import compile as ref_compile
from repro.models import cnn as ref_cnn
from repro_torch.core import compile as pt_compile
from repro_torch.core import im2col as pt_im2col
from repro_torch.core import plan as pt_plan
from repro_torch.core import winograd as pt_wg
from repro_torch.models import cnn as pt_cnn
from repro_torch.runtime import inject

RES, BATCH = 32, 2


@pytest.fixture(autouse=True)
def _fresh_port_counters():
    pt_plan.clear_plan_cache()
    yield
    pt_plan.clear_plan_cache()


@pytest.fixture(scope="module")
def mbv2():
    """(reference params as numpy, the same params in the port, input)."""
    ref = ref_cnn.init_cnn(jax.random.key(0), ref_cnn.mobilenet_v2(), 3,
                           res=RES)
    ref = jax.tree.map(np.array, ref)
    x = np.random.default_rng(0).standard_normal(
        (BATCH, RES, RES, 3)).astype(np.float32)
    return ref, pt_cnn.params_from_reference(ref, "cpu"), x


def _port_net(mbv2, compute_dtype="float32", **kw):
    return pt_compile.compile(mbv2[1], pt_cnn.mobilenet_v2(), res=RES,
                              batch=BATCH, algorithm="pallas_winograd",
                              compute_dtype=compute_dtype, device="cpu",
                              **kw)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
def test_save_load_roundtrip_is_bitwise(mbv2, tmp_path, compute_dtype):
    net = _port_net(mbv2, compute_dtype)
    path = str(tmp_path / "mbv2.npz")
    net.save(path)
    loaded = pt_compile.NetworkPlan.load(path, device="cpu")
    assert loaded.describe() == net.describe()
    assert pt_plan.plan_cache_info()["artifact_hits"] == 1
    x = torch.from_numpy(mbv2[2])
    assert torch.equal(loaded.apply(x), net.apply(x))
    for nid, p in net.plans.items():
        assert loaded.plans[nid].to_artifact()[0] == p.to_artifact()[0]


def test_load_transforms_no_filter_and_chooses_no_blocking(mbv2, tmp_path,
                                                          monkeypatch):
    """The meta carries the chooser's blocking, so a load runs neither the
    filter transform nor any blocking chooser."""
    net = _port_net(mbv2)
    path = str(tmp_path / "mbv2.npz")
    net.save(path)

    def refuse(*a, **k):
        raise AssertionError("plan-time work during load")
    monkeypatch.setattr(pt_plan, "_domain_filter", refuse)
    monkeypatch.setattr(pt_plan, "_depthwise_domain_taps", refuse)
    for name in ("stream_geometry_tf32x3", "stream_geometry_depthwise",
                 "separable_geometry", "winograd_blocks"):
        monkeypatch.setattr(pt_wg, name, refuse)
    monkeypatch.setattr(pt_im2col, "matmul_blocks", refuse)
    loaded = pt_compile.NetworkPlan.load(path, device="cpu")
    x = torch.from_numpy(mbv2[2])
    assert torch.equal(loaded.apply(x), net.apply(x))


def test_compile_warm_starts_from_artifact(mbv2, tmp_path):
    path = str(tmp_path / "mbv2.npz")
    cold = _port_net(mbv2, artifact=path)
    info = pt_plan.plan_cache_info()
    assert (info["artifact_hits"], info["artifact_misses"]) == (0, 1)
    warm = _port_net(mbv2, artifact=path)
    assert pt_plan.plan_cache_info()["artifact_hits"] == 1
    assert warm.params_digest == cold.params_digest
    x = torch.from_numpy(mbv2[2])
    assert torch.equal(warm.apply(x), cold.apply(x))
    # another policy on the same path is stale: cold compile, one miss
    _port_net(mbv2, compute_dtype="int8", artifact=path)
    info = pt_plan.plan_cache_info()
    assert (info["artifact_hits"], info["artifact_misses"]) == (1, 2)


def test_flip_bit_caught_by_verify_and_load(mbv2, tmp_path):
    path = str(tmp_path / "mbv2.npz")
    _port_net(mbv2).save(path)
    bad = inject.flip_bit(path, byte=5, bit=3)
    assert pt_compile.verify_artifact(path) == [bad]
    assert ref_compile.verify_artifact(path) == [bad]
    with pytest.raises(pt_compile.ArtifactMismatchError,
                       match="integrity digest"):
        pt_compile.NetworkPlan.load(path, device="cpu")


def test_verify_artifact_reads_the_other_package(mbv2, tmp_path):
    """The same format, header keys and per-array sha256 in both packages:
    each one's verify_artifact passes the other's file, and both name the
    same array after a bit flip."""
    ref_net = ref_compile.compile(mbv2[0], ref_cnn.mobilenet_v2(), res=RES,
                                  batch=BATCH, algorithm="winograd")
    ref_path = str(tmp_path / "ref.npz")
    ref_net.save(ref_path)
    pt_path = str(tmp_path / "port.npz")
    _port_net(mbv2).save(pt_path)
    for path in (ref_path, pt_path):
        assert pt_compile.verify_artifact(path) == []
        assert ref_compile.verify_artifact(path) == []
    ref_header = _header(ref_path)
    pt_header = _header(pt_path)
    assert set(pt_header) == (set(ref_header) - {"jax_version"}) | {
        "torch_version"}
    for key in ("format", "version", "registry_fingerprint", "layout",
                "input_shape", "params_digest", "partition"):
        assert pt_header[key] == ref_header[key], key
    # the port loads the reference's plan weights and runs them as the
    # reference does
    loaded = pt_compile.NetworkPlan.load(ref_path, device="cpu")
    y = loaded.apply(torch.from_numpy(mbv2[2])).numpy()
    want = np.asarray(ref_net.apply(mbv2[2]))
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()
    bad = inject.flip_bit(ref_path)
    assert pt_compile.verify_artifact(ref_path) == \
        ref_compile.verify_artifact(ref_path) == [bad]


def _header(path):
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__header__"][()]))


def test_params_digest_matches_reference(mbv2):
    ref = ref_cnn.init_cnn(jax.random.key(0), ref_cnn.mobilenet_v2(), 3,
                           res=RES)
    assert pt_compile.params_digest(mbv2[1]) == \
        ref_compile.params_digest(ref) == ref_compile.params_digest(mbv2[0])
    other = dict(mbv2[1], conv1={"w": mbv2[1]["conv1"]["w"] + 1})
    assert pt_compile.params_digest(other) != \
        pt_compile.params_digest(mbv2[1])


def test_registry_fingerprint_matches_reference():
    from repro.core import registry as ref_registry
    from repro_torch.core import registry as pt_registry
    assert pt_registry.fingerprint() == ref_registry.fingerprint()


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_depthwise_conv1d_plan_roundtrip(backend):
    w = torch.randn(4, 24, generator=torch.Generator().manual_seed(0))
    plan = pt_plan.plan_depthwise_conv1d((2, 37, 24), w, backend=backend,
                                         device="cpu")
    meta, arrays = plan.to_artifact()
    again = pt_plan.plan_from_artifact(meta, arrays, device="cpu")
    assert again.spec == plan.spec
    x = torch.randn(2, 37, 24, generator=torch.Generator().manual_seed(1))
    assert torch.equal(again.apply(x), plan.apply(x))


def test_plan_from_artifact_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown plan artifact kind"):
        pt_plan.plan_from_artifact({"kind": "conv3d"}, {}, device="cpu")
