"""The port's reduced-precision path on the CPU: VGG-16, MobileNet-v1 and
MobileNet-v2 through `compile(..., algorithm="pallas_winograd",
compute_dtype=...)` -> `NetworkPlan.apply` at bfloat16 and int8 (every
kernel on its plain version), held against the JAX package on the same
weights (the reference's `init_cnn` output, handed over as numpy) at res
32, batch 2.

The placement table must equal the reference's `pallas_winograd` table at
the same compute_dtype, leaf by leaf: executor, tile and compute_dtype.
The logits are held against the reference's `winograd` network at the
same compute_dtype, which runs here (its streamed Pallas kernels do not).
The two networks quantize the same transformed filters but place some
1x1 convs differently (the reference's bf16 `im2col` rounds its input
activations to bf16; the port's `pallas_im2col` does not), and the
reference's own reduced-precision networks disagree with each other by
1.9e-2 (MBv1 bf16), 4.0e-2 (MBv1 int8), 2.1e-2 (MBv2 bf16) and 3.2e-2
(MBv2 int8) between `winograd` and `im2col` at res 32. The limit, 0.1 of
the logits' largest magnitude, is above that spread and far below the
error of a wrong tap or scale (order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile as ref_compile
from repro.models import cnn as ref_cnn
from repro_torch.core import compile as pt_compile
from repro_torch.kernels import depthwise as pt_kd
from repro_torch.kernels import matmul as pt_km
from repro_torch.kernels import winograd as pt_kw
from repro_torch.models import cnn as pt_cnn

TOL_LOGITS = 0.1
RES, BATCH = 32, 2
NETS = ["vgg16", "mobilenet_v1", "mobilenet_v2"]
DTYPES = ["bfloat16", "int8"]
KERNELS = (pt_kw.winograd_streamed, pt_kw.winograd_strided_streamed,
           pt_kd.depthwise_streamed, pt_kd.depthwise_strided_streamed,
           pt_kd.separable_streamed, pt_km.matmul)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@pytest.fixture(scope="module", autouse=True)
def _no_measure():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PLAN_NO_MEASURE", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def nets():
    """name -> (reference params, port params on the CPU, input)."""
    out = {}
    for i, name in enumerate(NETS):
        specs = getattr(ref_cnn, name)()
        ref_params = ref_cnn.init_cnn(jax.random.key(10 + i), specs, 3,
                                      res=RES)
        x = np.random.default_rng(10 + i).standard_normal(
            (BATCH, RES, RES, 3)).astype(np.float32)
        out[name] = (ref_params, pt_cnn.params_from_reference(
            jax.tree.map(np.array, ref_params), "cpu"), x)
    return out


@pytest.fixture(scope="module")
def port():
    """(name, compute_dtype) -> the port's compiled network, built once."""
    cache = {}

    def get(nets, name, cd):
        if (name, cd) not in cache:
            cache[(name, cd)] = pt_compile.compile(
                nets[name][1], getattr(pt_cnn, name)(), res=RES, batch=BATCH,
                algorithm="pallas_winograd", compute_dtype=cd, device="cpu")
        return cache[(name, cd)]
    return get


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("name", NETS)
def test_placement_table_equals_reference(nets, port, name, compute_dtype):
    """Exact: the same executors, tiles and compute_dtype per leaf and the
    same output shapes as the reference's pallas_winograd network at this
    compute_dtype (planning runs there; only its apply needs the missing
    pl.Unblocked). No separable block fuses, every Winograd leaf is at
    F(2, .)."""
    ref = ref_compile.compile(nets[name][0], getattr(ref_cnn, name)(),
                              res=RES, batch=BATCH,
                              algorithm="pallas_winograd",
                              compute_dtype=compute_dtype)
    net = port(nets, name, compute_dtype)
    assert net.describe() == ref.describe()
    assert net.out_shape == ref.out_shape
    leaves = [p.describe() for p in net.plans.values()]
    assert not any("separable_streamed" in d["executor"] for d in leaves)
    assert all(d["tile"] in ("-", "2x2") for d in leaves)
    if name != "vgg16":
        assert sum("pallas_depthwise+pallas_im2col" in d["executor"]
                   for d in leaves) == {"mobilenet_v1": 9,
                                        "mobilenet_v2": 13}[name]


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("name", NETS)
def test_logits_match_reference(nets, port, name, compute_dtype):
    """The port's reduced-precision network (plain versions, no launches)
    against the reference's winograd network at the same compute_dtype."""
    ref_params, _, x = nets[name]
    ref = ref_compile.compile(ref_params, getattr(ref_cnn, name)(), res=RES,
                              batch=BATCH, algorithm="winograd",
                              compute_dtype=compute_dtype)
    y_ref = np.asarray(ref.apply(jnp.asarray(x)))
    before = [f.LAUNCHES for f in KERNELS]
    y = port(nets, name, compute_dtype).apply(torch.from_numpy(x)).numpy()
    assert [f.LAUNCHES for f in KERNELS] == before
    assert y.shape == y_ref.shape == (BATCH, 1000)
    assert np.isfinite(y).all()
    assert _rel(y, y_ref) <= TOL_LOGITS
