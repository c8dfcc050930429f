"""The port's first slice end to end on the CPU: VGG-16 through
`compile(..., algorithm="pallas_winograd")` -> `NetworkPlan.apply`, held
against the JAX package on the same weights (the reference's `init_cnn`
output, handed over as numpy), plus a narrow network at an odd resolution
that exercises edge blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile as ref_compile
from repro.models import cnn as ref_cnn
from repro_torch.core import compile as pt_compile
from repro_torch.models import cnn as pt_cnn

#: Logits agree to 1e-4 of their largest magnitude: 13 fp32 Winograd
#: convs and 3 dense layers deep, the two packages round differently at
#: every sum, and F(4, 3)'s transforms amplify those differences ~10x
#: against a direct conv.
TOL_LOGITS = 1e-4


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _narrow(C):
    return [C.Conv("a", 3, 3, 16), C.Conv("b", 5, 5, 24),
            C.Pool("max", 2, 2), C.Conv("c", 3, 3, 8),
            C.Pool("avg", 3, 2, "SAME"), C.Dense("fc", 10, relu=False)]


def _params(specs, res):
    ref = ref_cnn.init_cnn(jax.random.key(0), specs, 3, res=res)
    return ref, jax.tree.map(np.array, ref)


@pytest.fixture(scope="module", autouse=True)
def _no_measure():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PLAN_NO_MEASURE", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def vgg():
    specs = ref_cnn.vgg16()
    ref_params, np_params = _params(specs, 32)
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    net = pt_compile.compile(pt_cnn.params_from_reference(np_params, "cpu"),
                             pt_cnn.vgg16(), res=32, batch=2,
                             algorithm="pallas_winograd", device="cpu")
    return specs, ref_params, x, net


def test_vgg16_placement_table_equals_reference(vgg):
    """Exact: the same fusions (none), executors, tiles and shapes."""
    specs, ref_params, _, net = vgg
    ref = ref_compile.compile(ref_params, specs, res=32, batch=2,
                              algorithm="pallas_winograd")
    assert net.describe() == ref.describe()
    assert sum(p.spec.algorithm == "pallas_winograd"
               for p in net.plans.values()) == 13


@pytest.mark.parametrize("oracle", ["winograd", "im2col"])
def test_vgg16_logits_match_reference(vgg, oracle):
    specs, ref_params, x, net = vgg
    ref = ref_compile.compile(ref_params, specs, res=32, batch=2,
                              algorithm=oracle)
    y_ref = np.asarray(ref.apply(jnp.asarray(x)))
    y = net.apply(torch.from_numpy(x)).numpy()
    assert y.shape == y_ref.shape == (2, 1000)
    assert np.isfinite(y).all()
    assert _rel(y, y_ref) <= TOL_LOGITS


@pytest.mark.parametrize("algorithm", ["pallas_winograd", "winograd",
                                       "im2col", "auto"])
def test_narrow_network_at_odd_resolution(algorithm):
    """C_in = 3, res 37: edge blocks in every conv; SAME avg pooling."""
    specs = _narrow(ref_cnn)
    ref_params, np_params = _params(specs, 37)
    x = np.random.default_rng(1).standard_normal((2, 37, 37, 3)).astype(
        np.float32)
    net = pt_compile.compile(pt_cnn.params_from_reference(np_params, "cpu"),
                             _narrow(pt_cnn), res=37, batch=2,
                             algorithm=algorithm, device="cpu")
    ref = ref_compile.compile(ref_params, specs, res=37, batch=2,
                              algorithm=algorithm)
    assert net.describe() == ref.describe()
    assert net.out_shape == ref.out_shape
    oracle = ref_compile.compile(ref_params, specs, res=37, batch=2,
                                 algorithm="im2col")
    y_ref = np.asarray(oracle.apply(jnp.asarray(x)))
    y = net.apply(torch.from_numpy(x)).numpy()
    assert _rel(y, y_ref) <= TOL_LOGITS


def test_mobilenet_lowers_and_fuses_like_reference():
    """Fusion is ported: MobileNet-v2's graph fuses into the same nodes,
    and every fused node binds to its block plan
    (tests/test_torch_mobilenet.py holds the network against the
    reference)."""
    specs = pt_cnn.mobilenet_v2()
    ours = pt_compile.fuse(pt_compile.lower(specs))
    theirs = ref_compile.fuse(ref_compile.lower(ref_cnn.mobilenet_v2()))
    assert [(n.id, n.op, n.inputs) for n in ours] == \
        [(n.id, n.op, n.inputs) for n in theirs]
    params = pt_cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                             res=32, device="cpu")
    net = pt_compile.compile(params, specs, res=32, device="cpu",
                             algorithm="pallas_winograd")
    fused = [n.id for n in ours if n.op == "inverted_residual"]
    assert len(fused) == 17
    assert all(net.plans[nid].describe()["kind"] == "inverted_residual"
               for nid in fused)


def test_init_cnn_is_seeded_and_shaped_like_reference():
    specs = pt_cnn.vgg16()
    a = pt_cnn.init_cnn(torch.Generator().manual_seed(3), specs, 3, res=32,
                        device="cpu")
    b = pt_cnn.init_cnn(torch.Generator().manual_seed(3), specs, 3, res=32,
                        device="cpu")
    ref = jax.eval_shape(lambda: ref_cnn.init_cnn(jax.random.key(0),
                                                  ref_cnn.vgg16(), 3, res=32))
    for name, layer in ref.items():
        for k, v in layer.items():
            assert tuple(a[name][k].shape) == v.shape
            assert torch.equal(a[name][k], b[name][k])
