"""The rest of the CNN zoo end to end on the CPU: VGG-19, SqueezeNet and
MobileNet-v1 0.5 here, GoogleNet in tests/test_torch_googlenet.py and
Inception-v3 in tests/test_torch_inception.py (one file each, so that the
reference's slow CPU compiles spread over the test workers). Each network
goes through `compile(..., algorithm=...)` -> `NetworkPlan.apply` (every
kernel on its plain version) and is held against the JAX package on the
same weights (the reference's `init_cnn` output, handed over as numpy) at
batch 2, res 32 (Inception-v3 at res 75, its smallest valid input).

The placement tables must equal the reference's under every algorithm the
port runs; the logits are held against the reference's `winograd` and
`im2col` networks, which run here (its streamed Pallas kernels do not).
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile as ref_compile
from repro.models import cnn as ref_cnn
from repro_torch.core import compile as pt_compile
from repro_torch.models import cnn as pt_cnn

#: Logits agree to 1e-5 of their largest magnitude, as in
#: tests/test_torch_mobilenet.py: the reference's own winograd and im2col
#: networks differ by 0.7e-6 to 3.3e-6 on these five networks (1.3e-6 on
#: Inception-v3, whose F(2, 7) points stay inside the same limit); the
#: port sums in yet another order.
TOL_LOGITS = 1e-5
#: int8 codes: both packages transform the filter in fp32 and round
#: G w / scale to the nearest code, in another summation order, so a value
#: within an ulp of a rounding boundary may round the other way: one code
#: step, at most this share of the codes (Inception-v3 reads 3 of 4.2e6,
#: all in F(2, 7) layers, whose G sums 7 taps).
MAX_FLIP_SHARE = 1e-5
BATCH = 2
RES = {"vgg19": 32, "googlenet": 32, "squeezenet": 32,
       "mobilenet_v1_050": 32, "inception_v3": 75}
SEED = {name: i for i, name in enumerate(RES)}
NETS = ["vgg19", "squeezenet", "mobilenet_v1_050"]
#: (algorithm, compute_dtype) of each placement table held equal.
TABLES = [("pallas_winograd", "float32"), ("pallas_winograd", "bfloat16"),
          ("pallas_winograd", "int8"),
          ("pallas_winograd_materialized", "float32"),
          ("winograd", "float32"), ("im2col", "float32")]
TABLE_IDS = [f"{a}-{c}" for a, c in TABLES]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@contextlib.contextmanager
def _no_measure():
    """The reference's heuristic decisions only (its measured auto_tuned
    race does not run here)."""
    old = os.environ.get("REPRO_PLAN_NO_MEASURE")
    os.environ["REPRO_PLAN_NO_MEASURE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_PLAN_NO_MEASURE"]
        else:
            os.environ["REPRO_PLAN_NO_MEASURE"] = old


@functools.lru_cache(maxsize=None)
def case(name):
    """(reference params, port params on the CPU, input) of one network."""
    specs = getattr(ref_cnn, name)()
    ref_params = ref_cnn.init_cnn(jax.random.key(SEED[name]), specs, 3,
                                  res=RES[name])
    x = np.random.default_rng(SEED[name]).standard_normal(
        (BATCH, RES[name], RES[name], 3)).astype(np.float32)
    return ref_params, pt_cnn.params_from_reference(
        jax.tree.map(np.array, ref_params), "cpu"), x


def ref_net(name, algorithm, cd="float32"):
    with _no_measure():
        return ref_compile.compile(case(name)[0], getattr(ref_cnn, name)(),
                                   res=RES[name], batch=BATCH,
                                   algorithm=algorithm, compute_dtype=cd)


@functools.lru_cache(maxsize=None)
def ref_logits(name, algorithm, cd="float32"):
    return np.asarray(ref_net(name, algorithm, cd).apply(
        jnp.asarray(case(name)[2])))


def port_net(name, algorithm, cd="float32"):
    return pt_compile.compile(case(name)[1], getattr(pt_cnn, name)(),
                              res=RES[name], batch=BATCH, algorithm=algorithm,
                              compute_dtype=cd, device="cpu")


def port_logits(net, name):
    y = net.apply(torch.from_numpy(case(name)[2])).numpy()
    assert y.shape == (BATCH, 1000)
    assert np.isfinite(y).all()
    return y


def check_table(name, algorithm, cd):
    """Exact: the same fusions, executors, tiles, dtypes and output shapes
    as the reference's network (planning runs there; only its streamed
    apply needs the missing pl.Unblocked)."""
    ref = ref_net(name, algorithm, cd)
    net = port_net(name, algorithm, cd)
    assert net.describe() == ref.describe()
    assert net.out_shape == ref.out_shape == (BATCH, 1000)


def check_logits(name, oracle):
    """The port's pallas_winograd network (the kernels' plain versions on
    the CPU) and its pure-PyTorch winograd network against one reference
    network, fp32."""
    y_ref = ref_logits(name, oracle)
    for algorithm in ("pallas_winograd", "winograd"):
        y = port_logits(port_net(name, algorithm), name)
        assert _rel(y, y_ref) <= TOL_LOGITS, algorithm


def _conv_plans(plans):
    """node id -> ConvPlan, composed blocks opened up (either package)."""
    out = {}
    for nid, p in plans.items():
        for part in ("expand", "dw", "pw"):
            sub = getattr(p, part, None)
            if sub is not None:
                out[f"{nid}.{part}"] = sub
        if getattr(p, "spec", None) is not None and hasattr(p, "scale"):
            out[nid] = p
    return out


def check_int8(name):
    """int8 (per-output-channel scales on the transform-domain filter),
    against the reference's int8 winograd network, which quantizes the
    same domain filters as the port's winograd network:
      * the scales agree to 1e-6 and the codes to one step, at most
        MAX_FLIP_SHARE of them a step apart;
      * with the reference's codes carried over, the port's network
        reproduces the reference's logits to TOL_LOGITS;
      * the port's pallas_winograd network (the streamed kernels' plain
        versions, their filters padded to the blocking) gives the port's
        winograd network's logits to TOL_LOGITS."""
    ref = ref_net(name, "winograd", "int8")
    net = port_net(name, "winograd", "int8")
    ref_plans, plans = _conv_plans(ref.plans), _conv_plans(net.plans)
    assert set(plans) == set(ref_plans)
    flips = codes = 0
    for nid, plan in plans.items():
        q_ref = np.asarray(ref_plans[nid].u)
        assert plan.u.dtype == torch.int8 and q_ref.dtype == np.int8, nid
        q = plan.u.numpy()
        assert q.shape == q_ref.shape, nid
        step = np.abs(q.astype(np.int32) - q_ref)
        assert step.max() <= 1, nid
        flips += int(step.sum())
        codes += q.size
        assert np.allclose(plan.scale.numpy(),
                           np.asarray(ref_plans[nid].scale).reshape(-1),
                           rtol=1e-6, atol=0), nid
    assert flips <= MAX_FLIP_SHARE * codes, (flips, codes)
    own = port_logits(net, name)
    for nid, plan in plans.items():
        plan.u = torch.from_numpy(np.asarray(ref_plans[nid].u).copy())
    assert _rel(port_logits(net, name),
                ref_logits(name, "winograd", "int8")) <= TOL_LOGITS
    streamed = port_logits(port_net(name, "pallas_winograd", "int8"), name)
    assert _rel(streamed, own) <= TOL_LOGITS


@pytest.mark.parametrize("algorithm,cd", TABLES, ids=TABLE_IDS)
@pytest.mark.parametrize("name", NETS)
def test_placement_table_equals_reference(name, algorithm, cd):
    check_table(name, algorithm, cd)


@pytest.mark.parametrize("oracle", ["winograd", "im2col"])
@pytest.mark.parametrize("name", NETS)
def test_logits_match_reference(name, oracle):
    check_logits(name, oracle)


@pytest.mark.parametrize("name", NETS)
def test_int8_logits_match_reference(name):
    check_int8(name)
