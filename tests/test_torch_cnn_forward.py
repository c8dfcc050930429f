"""The spec-walk interpreter `models.cnn.cnn_forward` (every conv through
the per-call dispatcher) against the JAX package's on the same weights
(the reference's `init_cnn` output, handed over as numpy) at res 32,
batch 2: VGG-16, MobileNet-v1 and MobileNet-v2 under "auto", "winograd"
and "im2col", with the `layer_times` descriptors equal; and the
deprecated `plan_cnn` / `cnn_forward(plans=)` shims over compile().
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as ref_cnn
from repro_torch.core import compile as pt_compile
from repro_torch.core import plan as pt_plan
from repro_torch.models import cnn as pt_cnn

#: Logits, relative max-abs error of the reference's largest: the same
#: fp32 transforms and GEMMs summed in other orders through the network
#: (tests/test_torch_mobilenet.py holds compiled networks to the same).
TOL = 1e-5
RES, BATCH = 32, 2
NETS = ["vgg16", "mobilenet_v1", "mobilenet_v2"]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@pytest.fixture(scope="module", autouse=True)
def _no_measure():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PLAN_NO_MEASURE", "1")
    yield
    mp.undo()


@pytest.fixture(autouse=True)
def _fresh_port_cache():
    pt_plan.clear_plan_cache()
    yield
    pt_plan.clear_plan_cache()


@pytest.fixture(scope="module")
def nets():
    """name -> (specs, reference params, port params on the CPU, input)."""
    out = {}
    for i, name in enumerate(NETS):
        specs = getattr(ref_cnn, name)()
        ref_params = ref_cnn.init_cnn(jax.random.key(i), specs, 3, res=RES)
        x = np.random.default_rng(i).standard_normal(
            (BATCH, RES, RES, 3)).astype(np.float32)
        out[name] = (specs, ref_params, pt_cnn.params_from_reference(
            jax.tree.map(np.array, ref_params), "cpu"), x)
    return out


@pytest.mark.parametrize("algorithm", ["auto", "winograd", "im2col"])
@pytest.mark.parametrize("name", NETS)
def test_cnn_forward_matches_reference(nets, name, algorithm):
    _, ref_params, pt_params, x = nets[name]
    specs = pt_cnn.NETWORKS[name][0]()
    ref_times, pt_times = {}, {}
    want = np.asarray(ref_cnn.cnn_forward(
        ref_params, jnp.asarray(x), getattr(ref_cnn, name)(),
        algorithm=algorithm, layer_times=ref_times))
    got = pt_cnn.cnn_forward(pt_params, torch.from_numpy(x), specs,
                             algorithm=algorithm, layer_times=pt_times)
    assert tuple(got.shape) == want.shape == (BATCH, 1000)
    assert _rel(got.numpy(), want) < TOL
    assert pt_times == ref_times


def test_cnn_forward_equals_the_compiled_network(nets):
    """Per call under pallas_winograd (each kernel wrapper on its plain
    version here) against the compiled network on the same weights."""
    _, _, pt_params, x = nets["mobilenet_v1"]
    specs = pt_cnn.NETWORKS["mobilenet_v1"][0]()
    xt = torch.from_numpy(x)
    got = pt_cnn.cnn_forward(pt_params, xt, specs,
                             algorithm="pallas_winograd")
    net = pt_compile.compile(pt_params, specs, res=RES, batch=BATCH,
                             algorithm="pallas_winograd", device="cpu")
    assert _rel(got.numpy(), net.apply(xt).numpy()) < TOL


@pytest.mark.parametrize("spec,algorithm,want", [
    (pt_cnn.Conv("c", 3, 3, 8), "pallas_winograd", "pallas_winograd"),
    (pt_cnn.Conv("c", 1, 1, 8), "pallas_winograd", "im2col"),
    (pt_cnn.Conv("c", 3, 3, 8, stride=2), "winograd", "winograd"),
    (pt_cnn.Conv("c", 3, 3, 8, groups=8), "pallas_winograd_materialized",
     "im2col"),
    (pt_cnn.Conv("c", 11, 11, 8), "winograd", "im2col")])
def test_layer_algorithm_is_the_references(spec, algorithm, want):
    ref_spec = ref_cnn.Conv(spec.name, spec.kh, spec.kw, spec.c_out,
                            stride=spec.stride, groups=spec.groups)
    assert pt_cnn._layer_algorithm(spec, algorithm, 8) == want == \
        ref_cnn._layer_algorithm(ref_spec, algorithm, 8)


def test_plan_cnn_warns_once_and_equals_compile(nets):
    _, _, pt_params, x = nets["mobilenet_v2"]
    specs = pt_cnn.NETWORKS["mobilenet_v2"][0]()
    pt_compile._DEPRECATION_WARNED.discard("models.cnn.plan_cnn")
    with pytest.warns(DeprecationWarning, match="plan_cnn"):
        net = pt_cnn.plan_cnn(pt_params, specs, res=RES, batch=BATCH,
                              device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")             # no second warning
        again = pt_cnn.plan_cnn(pt_params, specs, res=RES, batch=BATCH,
                                device="cpu")
    direct = pt_compile.compile(pt_params, specs, res=RES, batch=BATCH,
                                device="cpu")
    assert net.describe() == again.describe() == direct.describe()
    xt = torch.from_numpy(x)
    want = direct.apply(xt)
    assert torch.equal(net.apply(xt), want)
    # the legacy walk over a NetworkPlan, biases from this call's params
    pt_compile._DEPRECATION_WARNED.discard(
        "models.cnn.cnn_forward(plans=...)")
    with pytest.warns(DeprecationWarning, match="plans="):
        got = pt_cnn.cnn_forward(pt_params, xt, specs, plans=net)
    assert _rel(got.numpy(), want.numpy()) < TOL

