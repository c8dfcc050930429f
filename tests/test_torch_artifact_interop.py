"""Artifacts the JAX package saves, loaded into the port on the CPU.

The reference saves a narrow network -- a stride-2 stem, dense 3x3 and 5x5
convs, a 1x1, inverted residuals with and without a stride, a separable
block and the head -- under winograd / pallas_winograd / im2col /
winograd_f63 (its dense part) at fp32, bf16 and int8, and one
spatial-partitioned plan. The
port loads each file: its header has no `torch_version`, its metas carry no
kernel blocking, its `u` is padded to the reference's blocking and its bf16
arrays are ml_dtypes.bfloat16 (2-byte voids to np.load). Every plan array
of the loaded network equals the reference's cropped to the logical C / M
(int8: the same codes, bf16: the same bits); the fp32 outputs are within
1e-5 of the reference's pure-JAX apply (see ORACLE), and each plan of the
pure-JAX executors, fp32 and bf16, within 1e-5 of the reference's plan on
the same input."""

import json

import jax
import numpy as np
import pytest
import torch

from repro.core import compile as ref_cc
from repro.models import cnn as ref_cnn
from repro_torch.core import compile as pt_cc
from repro_torch.core import plan as pt_plan
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.models import cnn as pt_cnn

RES, BATCH = 16, 2
#: Port against reference outputs, relative max-abs: the same execution-
#: domain weights, fp32 transforms and sums in another order.
TOL = 1e-5

SPECS = [ref_cnn.Conv("conv1", 3, 3, 8, stride=2, activation="relu6"),
         ref_cnn.Conv("c2", 3, 3, 12),
         ref_cnn.Conv("c3", 5, 5, 8),
         ref_cnn.Conv("c4", 1, 1, 16),
         ref_cnn.InvertedResidual("ir1", 24, expand=2),
         ref_cnn.InvertedResidual("ir2", 24, stride=2, expand=2),
         ref_cnn.SeparableConv("sep", 3, 32),
         ref_cnn.GlobalAvgPool(),
         ref_cnn.Dense("fc", 10, relu=False)]
PT_SPECS = [pt_cnn.Conv("conv1", 3, 3, 8, stride=2, activation="relu6"),
            pt_cnn.Conv("c2", 3, 3, 12),
            pt_cnn.Conv("c3", 5, 5, 8),
            pt_cnn.Conv("c4", 1, 1, 16),
            pt_cnn.InvertedResidual("ir1", 24, expand=2),
            pt_cnn.InvertedResidual("ir2", 24, stride=2, expand=2),
            pt_cnn.SeparableConv("sep", 3, 32),
            pt_cnn.GlobalAvgPool(),
            pt_cnn.Dense("fc", 10, relu=False)]
#: F(6, 3) covers dense 3x3 convs only, and the reference's compile
#: refuses its request on a separable block: its network is the dense part.
F63_SPECS = SPECS[:4] + [ref_cnn.GlobalAvgPool(),
                         ref_cnn.Dense("fc63", 10, relu=False)]
#: The reference's pure-JAX apply each algorithm's fp32 outputs are held
#: to: its own for the pure-JAX executors, winograd's for pallas_winograd
#: (the reference's Pallas kernels do not run under this host's jax). At
#: bf16 pallas_winograd composes its blocks onto other executors than
#: winograd (2.5e-3 apart), so there the loaded network is held to the
#: port's own compile of the same request instead.
ORACLE = {"winograd": "winograd", "pallas_winograd": "winograd",
          "im2col": "im2col", "winograd_f63": "winograd_f63"}


@pytest.fixture(autouse=True)
def _fresh_port_counters():
    pt_plan.clear_plan_cache()
    yield
    pt_plan.clear_plan_cache()


@pytest.fixture(scope="module")
def net_inputs():
    """Seeded params (the port's init_cnn, the reference's layout, as
    numpy) and an input."""
    gen = torch.Generator().manual_seed(0)
    params = {**pt_cnn.init_cnn(gen, PT_SPECS[:4] + [
        pt_cnn.GlobalAvgPool(), pt_cnn.Dense("fc63", 10, relu=False)], 3,
        res=RES, device="cpu"),
        **pt_cnn.init_cnn(gen, PT_SPECS, 3, res=RES, device="cpu")}
    params = jax.tree.map(lambda t: t.numpy(), params)
    x = np.random.default_rng(0).standard_normal(
        (BATCH, RES, RES, 3)).astype(np.float32)
    return params, x


_OUT: dict = {}


def specs_for(algorithm):
    return F63_SPECS if algorithm == "winograd_f63" else SPECS


def ref_out(params, x, algorithm, compute_dtype):
    key = (algorithm, compute_dtype)
    if key not in _OUT:
        _OUT[key] = np.asarray(ref_cc.compile(
            params, specs_for(algorithm), res=RES, batch=BATCH,
            algorithm=algorithm, compute_dtype=compute_dtype).apply(x))
    return _OUT[key]


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def bits(a: np.ndarray) -> np.ndarray:
    """An artifact array as comparable numbers: 2-byte voids (the
    reference's bf16) as their int16 bit pattern, as the port stores bf16."""
    a = np.asarray(a)
    if a.dtype.kind == "V":
        return np.frombuffer(a.tobytes(), np.int16).reshape(a.shape)
    return a


def crop_equal(got: np.ndarray, want: np.ndarray) -> bool:
    """Two paddings of one logical array agree on their common corner."""
    corner = tuple(slice(0, min(g, w)) for g, w in zip(got.shape,
                                                      want.shape))
    return got.ndim == want.ndim and np.array_equal(bits(got)[corner],
                                                    bits(want)[corner])


def saved_arrays(path) -> dict:
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files if k.startswith("plan:")}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("algorithm", sorted(ORACLE))
def test_port_loads_reference_artifact(net_inputs, tmp_path, algorithm,
                                       compute_dtype):
    params, x = net_inputs
    path = str(tmp_path / "ref.npz")
    ref_net = ref_cc.compile(params, specs_for(algorithm), res=RES,
                             batch=BATCH, algorithm=algorithm,
                             compute_dtype=compute_dtype)
    ref_net.save(path)
    net = pt_cc.NetworkPlan.load(path, device="cpu")
    assert pt_plan.plan_cache_info()["artifact_hits"] == 1
    assert net.describe() == ref_net.describe()
    want = saved_arrays(path)
    got = {}
    for nid, p in net.plans.items():
        got.update({f"plan:{nid}:{k}": v
                    for k, v in p.to_artifact()[1].items()})
    assert set(got) == set(want)
    for k in want:
        assert crop_equal(got[k], want[k]), k
    if compute_dtype == "int8":
        return                                      # the codes, above
    y = net.apply(torch.from_numpy(x)).numpy()
    if algorithm == "pallas_winograd" and compute_dtype == "bfloat16":
        own = pt_cc.compile(
            pt_cnn.params_from_reference(params, "cpu"), PT_SPECS, res=RES,
            batch=BATCH, algorithm=algorithm, compute_dtype=compute_dtype,
            device="cpu")
        assert rel(y, own.apply(torch.from_numpy(x)).numpy()) < TOL
    elif compute_dtype == "float32":
        assert rel(y, ref_out(params, x, ORACLE[algorithm],
                              compute_dtype)) < TOL
    if algorithm != "pallas_winograd":
        # each plan against the reference's on one input: a bf16 im2col
        # layer rounds its input activations to bf16, so end to end a
        # 1e-7 difference upstream can flip a rounding (2^-8 of that value)
        shapes = ref_cc.infer_shapes(ref_net.graph, ref_net.input_shape)
        rng = np.random.default_rng(1)
        for node in ref_net.graph:
            if node.id not in ref_net.plans:
                continue
            v = rng.standard_normal(shapes[node.inputs[0]]).astype(
                np.float32)
            got = net._eval_node(net_node(net, node.id), node.attrs,
                                 torch.from_numpy(v), None, net.consts)
            want = ref_net._eval_node(node, node.attrs, jax.numpy.asarray(v),
                                      None, ref_net.consts)
            assert rel(got.numpy(), want) < TOL, node.id


def net_node(net, nid):
    return next(n for n in net.graph if n.id == nid)


def test_port_warm_starts_from_reference_spatial_artifact(net_inputs,
                                                          tmp_path):
    """A spatial-partitioned pallas_winograd plan the reference saved
    (a stand-in mesh: its compile reads only the axis name and size):
    compile(artifact=, mesh=) in the port is one hit, keeps the record,
    and its sharded apply is the reference's unsharded one."""
    import types
    params, x = net_inputs
    path = str(tmp_path / "ref_spatial.npz")
    mesh = types.SimpleNamespace(axis_names=("data",), shape={"data": 4})
    ref_net = ref_cc.compile(params, SPECS, res=RES, batch=BATCH,
                             algorithm="pallas_winograd", mesh=mesh,
                             partition="spatial", artifact=path)
    assert "halo" in ref_net.partition["modes"].values()
    pt_plan.clear_plan_cache()
    net = pt_cc.compile(pt_cnn.params_from_reference(params, "cpu"),
                        PT_SPECS, res=RES, batch=BATCH,
                        algorithm="pallas_winograd",
                        mesh=make_data_mesh(devices=["cpu"] * 4),
                        partition="spatial", artifact=path)
    info = pt_plan.plan_cache_info()
    assert (info["artifact_hits"], info["artifact_misses"]) == (1, 0)
    assert net.partition == ref_net.partition
    y = net.apply(torch.from_numpy(x)).numpy()
    assert rel(y, ref_out(params, x, "winograd", "float32")) < TOL


def test_reference_bf16_digests_verify_in_the_port(net_inputs, tmp_path):
    """np.load hands the reference's bf16 arrays back as 2-byte voids, whose
    dtype name is not the "bfloat16" the reference digested: the port's
    digest reads them under that name, so its integrity check passes them
    and still catches a flipped bit."""
    from repro_torch.runtime import inject
    params, _ = net_inputs
    path = str(tmp_path / "ref_bf16.npz")
    ref_cc.compile(params, SPECS, res=RES, batch=BATCH, algorithm="winograd",
                   compute_dtype="bfloat16").save(path)
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(str(data["__header__"][()]))
        assert any(data[k].dtype.kind == "V" for k in data.files)
    assert "torch_version" not in header
    assert pt_cc.verify_artifact(path) == []
    bad = inject.flip_bit(path, "const:", byte=5, bit=3)
    assert pt_cc.verify_artifact(path) == [bad]
