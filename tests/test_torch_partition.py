"""Partitioned NetworkPlans in the port on the CPU: `decide_partition`'s
records against the reference's for every network of NETWORKS, the
reference's own small cases, sharded `apply` on a CPU mesh
(`make_data_mesh(devices=["cpu"] * D)`, one process evaluating every shard)
against the unsharded port plan and the reference's unsharded
`compile(..., algorithm="winograd")`, the argument checks, the partitioned
artifact round trip, and `Server(mesh=, partition="data")` against the
reference's `sharded_buckets`.

The reference's `compile(mesh=)` and `Server(mesh=)` read a mesh only
through its axis names and shape until something runs sharded, so they take
a stand-in mesh here (as `tests/test_sharding.py` does for its specs); no
forced host devices and no subprocess."""

import os
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import compile as ref_cc
from repro.core import partition as ref_pt
from repro.models import cnn as ref_cnn
from repro.runtime import serve as ref_serve
from repro_torch.core import compile as pt_cc
from repro_torch.core import partition as pt_pt
from repro_torch.core.plan import clear_plan_cache, plan_cache_info
from repro_torch.launch.mesh import Mesh, make_data_mesh
from repro_torch.models import cnn as pt_cnn
from repro_torch.runtime.serve import ServeConfig, Server

#: Sharded against unsharded, relative max-abs: the same plans on strips,
#: sums in the same order except the global mean (a mean of strip means).
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_counters():
    clear_plan_cache()
    yield
    clear_plan_cache()


def cpu_mesh(d: int) -> Mesh:
    return make_data_mesh(devices=["cpu"] * d)


def ref_mesh(d: int):
    """A stand-in for a jax Mesh of d devices on the "data" axis."""
    return types.SimpleNamespace(axis_names=("data",), shape={"data": d},
                                 devices=np.empty((d,), object))


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


# ---------------------------------------------------------------------------
# decide_partition: the records, key for key
# ---------------------------------------------------------------------------

_IR: dict = {}


def _irs(name: str):
    """(port IR, reference IR) of one network, lowered and fused."""
    if name not in _IR:
        _IR[name] = (pt_cc.fuse(pt_cc.lower(pt_cnn.NETWORKS[name][0](), 3)),
                     ref_cc.fuse(ref_cc.lower(ref_cnn.NETWORKS[name][0](),
                                              3)))
    return _IR[name]


@pytest.mark.parametrize("batch", [2, 6, 8])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["data", "spatial"])
@pytest.mark.parametrize("name", sorted(pt_cnn.NETWORKS))
def test_decide_partition_matches_reference(name, kind, d, batch):
    pt_ir, ref_ir = _irs(name)
    res = pt_cnn.NETWORKS[name][1]
    shape = (batch, res, res, 3)
    got = pt_pt.decide_partition(pt_ir, pt_cc.infer_shapes(pt_ir, shape), d,
                                 kind)
    want = ref_pt.decide_partition(ref_ir, ref_cc.infer_shapes(ref_ir, shape),
                                   d, kind)
    assert got == want


CNN_SPECS = [pt_cnn.Conv("c1", 3, 3, 8),
             pt_cnn.Conv("c2", 5, 5, 8),
             pt_cnn.Pool("max", 2, 2),
             pt_cnn.Conv("c3", 3, 3, 16),
             pt_cnn.GlobalAvgPool(),
             pt_cnn.Dense("fc", 10, relu=False)]
REF_SPECS = [ref_cnn.Conv("c1", 3, 3, 8),
             ref_cnn.Conv("c2", 5, 5, 8),
             ref_cnn.Pool("max", 2, 2),
             ref_cnn.Conv("c3", 3, 3, 16),
             ref_cnn.GlobalAvgPool(),
             ref_cnn.Dense("fc", 10, relu=False)]


def _cnn_ir(batch=8, res=32):
    ir = pt_cc.fuse(pt_cc.lower(CNN_SPECS, c_in=3))
    return ir, pt_cc.infer_shapes(ir, (batch, res, res, 3))


def test_decide_partition_data_divisible():
    ir, shapes = _cnn_ir(batch=8)
    assert pt_pt.decide_partition(ir, shapes, 4, "data") == {
        "kind": "data", "axis": "data", "num_shards": 4,
        "requested_shards": 4, "degraded": None}


def test_decide_partition_data_indivisible_degrades():
    ir, shapes = _cnn_ir(batch=6)
    part = pt_pt.decide_partition(ir, shapes, 4, "data")
    assert part["num_shards"] == 1 and part["requested_shards"] == 4
    assert "does not divide" in part["degraded"]


def test_decide_partition_spatial_modes():
    """Stride-1 odd-k convs halo, the stride-2 pool re-gathers (and
    re-scatters: H/2 still divides), global pooling reduces, the head runs
    replicated."""
    ir, shapes = _cnn_ir(batch=2, res=32)
    part = pt_pt.decide_partition(ir, shapes, 4, "spatial")
    m = part["modes"]
    assert m["c1"] == "halo" and part["halo"]["c1"] == 1
    assert m["c2"] == "halo" and part["halo"]["c2"] == 2
    pool = next(k for k in m if k.startswith("pool"))
    assert m[pool] == "full" and part["rescatter"][pool]
    assert m["c3"] == "halo"
    gap = next(k for k in m if k.startswith("gap"))
    assert m[gap] == "reduce"
    assert m["fc"] == "local"
    assert part["out_sharded"] is False


def test_decide_partition_spatial_halo_needs_enough_rows():
    ir, shapes = _cnn_ir(batch=2, res=8)
    part = pt_pt.decide_partition(ir, shapes, 8, "spatial")
    assert part["modes"]["c1"] == "halo"          # halo 1 <= 1 local row
    assert part["modes"]["c2"] == "full"          # halo 2 > 1 local row


def test_decide_partition_spatial_indivisible_h_degrades():
    ir, shapes = _cnn_ir(batch=2, res=30)
    part = pt_pt.decide_partition(ir, shapes, 4, "spatial")
    assert part["num_shards"] == 1
    assert "does not divide" in part["degraded"]


def test_decide_partition_rejects_unknown_kind():
    ir, shapes = _cnn_ir()
    with pytest.raises(ValueError, match="unknown partition kind"):
        pt_pt.decide_partition(ir, shapes, 2, "model")


def test_spatial_halo_in_shape_is_the_exchanged_strip():
    ir, shapes = _cnn_ir(batch=2, res=32)
    part = pt_pt.decide_partition(ir, shapes, 4, "spatial")
    c2 = next(n for n in ir if n.id == "c2")
    assert pt_pt.spatial_halo_in_shape(part, c2, shapes) == (2, 12, 36, 8)
    assert pt_pt.local_bind_shapes(
        pt_pt.decide_partition(ir, _cnn_ir(batch=8)[1], 4, "data"),
        _cnn_ir(batch=8)[1])["input"] == (2, 32, 32, 3)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_make_data_mesh_names_devices_and_refuses_missing_cards():
    mesh = cpu_mesh(4)
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 4}
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    assert pt_pt.mesh_num_shards(mesh) == ("data", 4)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="devices="):
        make_data_mesh(n + 1)
    with pytest.raises(ValueError, match="num_devices=3"):
        make_data_mesh(3, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="empty"):
        make_data_mesh(devices=[])


def test_sharding_primitives_on_shard_lists():
    from repro_torch.distributed import sharding as shd
    x = torch.arange(2 * 8 * 3 * 1, dtype=torch.float32).reshape(2, 8, 3, 1)
    devs = (torch.device("cpu"),) * 4
    shards = shd.scatter_rows(x, devs)
    assert [tuple(s.shape) for s in shards] == [(2, 2, 3, 1)] * 4
    assert torch.equal(shd.gather_rows(shards, devs[0]), x)
    ex = shd.halo_exchange(shards, 1)
    full = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    for i, strip in enumerate(ex):
        assert torch.equal(strip, full[:, 2 * i:2 * i + 4])
    assert shd.halo_exchange(shards, 0) == shards
    assert [tuple(s.shape) for s in shd.split_batch(x, devs[:2])] == \
        [(1, 8, 3, 1)] * 2
    assert shd.data_axis_name(cpu_mesh(2)) == "data"


# ---------------------------------------------------------------------------
# sharded apply against the unsharded plans of both packages
# ---------------------------------------------------------------------------

MB_SPECS = [pt_cnn.Conv("conv1", 3, 3, 8, stride=2, activation="relu6"),
            pt_cnn.InvertedResidual("ir1", 16, expand=1),
            pt_cnn.InvertedResidual("ir2", 16, stride=2),
            pt_cnn.InvertedResidual("ir3", 16),
            pt_cnn.SeparableConv("sep4", 3, 24),
            pt_cnn.GlobalAvgPool(),
            pt_cnn.Dense("fc", 10, relu=False)]
REF_MB_SPECS = [ref_cnn.Conv("conv1", 3, 3, 8, stride=2,
                             activation="relu6"),
                ref_cnn.InvertedResidual("ir1", 16, expand=1),
                ref_cnn.InvertedResidual("ir2", 16, stride=2),
                ref_cnn.InvertedResidual("ir3", 16),
                ref_cnn.SeparableConv("sep4", 3, 24),
                ref_cnn.GlobalAvgPool(),
                ref_cnn.Dense("fc", 10, relu=False)]
LADDERS = {"cnn": (CNN_SPECS, REF_SPECS, 32), "mb": (MB_SPECS, REF_MB_SPECS,
                                                     32)}
_CACHE: dict = {}


def ladder(name: str, batch: int):
    """(port params, port specs, reference unsharded logits, input)."""
    key = (name, batch)
    if key not in _CACHE:
        specs, ref_specs, res = LADDERS[name]
        ref_params = jax.tree.map(lambda t: t.numpy(), pt_cnn.init_cnn(
            torch.Generator().manual_seed(0), specs, 3, res=res,
            device="cpu"))
        x = np.random.default_rng(1).standard_normal(
            (batch, res, res, 3)).astype(np.float32)
        want = np.asarray(ref_cc.compile(
            ref_params, ref_specs, res=res, batch=batch,
            algorithm="winograd").apply(x))
        _CACHE[key] = (pt_cnn.params_from_reference(ref_params, "cpu"),
                       specs, want, x, ref_params)
    return _CACHE[key]


@pytest.mark.parametrize("algorithm", ["winograd", "pallas_winograd"])
@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("kind", ["spatial", "data"])
def test_sharded_apply_matches_unsharded(kind, d, algorithm):
    """The reference test's ladder (tests/test_sharding.py): spatial H
    splits d-way with halo exchanges and a re-gathered pool, data splits
    the batch; both against the unsharded port plan and the reference's
    unsharded winograd apply."""
    batch = 8 if kind == "data" else 2
    params, specs, want, x, _ = ladder("cnn", batch)
    net = pt_cc.compile(params, specs, res=32, batch=batch,
                        algorithm=algorithm, mesh=cpu_mesh(d),
                        partition=kind)
    assert net.is_sharded() and net.partition["num_shards"] == d
    plain = pt_cc.compile(params, specs, res=32, batch=batch,
                          algorithm=algorithm, device="cpu")
    xt = torch.from_numpy(x)
    y = net.apply(xt)
    assert rel(y, plain.apply(xt)) < TOL
    assert rel(y, want) < TOL
    if kind == "spatial":
        m = net.partition["modes"]
        assert m["c1"] == m["c2"] == m["c3"] == "halo"
        # halo plans bind VALID at the exchanged strip
        spec = net.plans["c2"].spec
        assert spec.padding == "VALID"
        assert spec.x_shape == (batch, 32 // d + 4, 36, 8)


@pytest.mark.parametrize("kind,d", [("data", 2), ("data", 4),
                                    ("spatial", 2), ("spatial", 4)])
def test_mobilenet_ladder_sharded(kind, d):
    """A narrow MobileNet-style ladder: stride-2 stem, inverted residuals
    with and without expansion and skip, a separable block. Under "data"
    every block runs at the local batch; under "spatial" the
    expansion-free block and the separable block halo."""
    params, specs, want, x, _ = ladder("mb", 8)
    net = pt_cc.compile(params, specs, res=32, batch=8,
                        algorithm="pallas_winograd", mesh=cpu_mesh(d),
                        partition=kind)
    xt = torch.from_numpy(x)
    plain = pt_cc.compile(params, specs, res=32, batch=8,
                          algorithm="pallas_winograd", device="cpu")
    y = net.apply(xt)
    assert rel(y, plain.apply(xt)) < TOL and rel(y, want) < TOL
    if kind == "data":
        assert net.plans["ir1"].x_shape[0] == 8 // d
    else:
        m = net.partition["modes"]
        assert m["ir1"] == "halo" and m["sep4"] == "halo"
        assert m["ir3"] == "full"                     # residual


def test_single_shard_mesh_records_degrade_and_runs_eagerly():
    params, specs, want, x, _ = ladder("cnn", 2)
    net = pt_cc.compile(params, specs, res=32, batch=2, algorithm="winograd",
                        mesh=cpu_mesh(1), partition="spatial")
    assert net.partition["num_shards"] == 1
    assert net.partition["degraded"] == "single-device mesh axis"
    assert not net.is_sharded()
    assert rel(net.apply(torch.from_numpy(x)), want) < TOL


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def test_sharded_plan_refuses_hooks_and_missing_mesh(tmp_path):
    params, specs, _, x, _ = ladder("cnn", 8)
    net = pt_cc.compile(params, specs, res=32, batch=8, algorithm="winograd",
                        mesh=cpu_mesh(4))
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="layer_hook / annotate_errors"):
        net.apply(xt, layer_hook=lambda *a: None)
    with pytest.raises(ValueError, match="layer_hook / annotate_errors"):
        net.apply(xt, annotate_errors=True)
    with pytest.raises(ValueError, match="single-logical-device"):
        net.replace_layer("c1", params)
    path = str(tmp_path / "net.npz")
    net.save(path)
    loaded = pt_cc.NetworkPlan.load(path, device="cpu")
    assert loaded.is_sharded() and loaded.mesh is None
    with pytest.raises(ValueError, match="with_mesh"):
        loaded.apply(xt)
    with pytest.raises(ValueError, match="does not match the recorded"):
        loaded.with_mesh(cpu_mesh(2))
    assert torch.equal(loaded.with_mesh(cpu_mesh(4)).apply(xt),
                       net.apply(xt))


def test_compile_argument_checks():
    params, specs, _, _, _ = ladder("cnn", 8)
    with pytest.raises(ValueError, match="needs mesh="):
        pt_cc.compile(params, specs, res=32, batch=8, partition="data",
                      device="cpu")
    with pytest.raises(ValueError, match="unknown partition"):
        pt_cc.compile(params, specs, res=32, batch=8, partition="model",
                      mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        pt_cc.compile(params, specs, res=32, batch=8, mesh=cpu_mesh(2),
                      device="meta")
    plain = pt_cc.compile(params, specs, res=32, batch=8, device="cpu")
    with pytest.raises(ValueError, match="without a partition"):
        plain.with_mesh(cpu_mesh(2))


# ---------------------------------------------------------------------------
# artifacts: the partition record, warm starts, the reference's record
# ---------------------------------------------------------------------------

def test_partitioned_artifact_roundtrip(tmp_path):
    params, specs, _, x, _ = ladder("cnn", 2)
    art = str(tmp_path / "net.npz")
    mesh = cpu_mesh(4)
    net = pt_cc.compile(params, specs, res=32, batch=2, algorithm="winograd",
                        mesh=mesh, partition="spatial", artifact=art)
    assert plan_cache_info()["artifact_misses"] == 1
    xt = torch.from_numpy(x)
    y = net.apply(xt)
    clear_plan_cache()
    warm = pt_cc.compile(params, specs, res=32, batch=2,
                         algorithm="winograd", mesh=mesh,
                         partition="spatial", artifact=art)
    info = plan_cache_info()
    assert (info["artifact_hits"], info["artifact_misses"]) == (1, 0)
    assert warm.partition == net.partition and warm.mesh is mesh
    assert torch.equal(warm.apply(xt), y)
    # another partition request, or none, is stale: cold, one miss each
    clear_plan_cache()
    other = pt_cc.compile(params, specs, res=32, batch=2,
                          algorithm="winograd", mesh=mesh, partition="data",
                          artifact=art)
    assert other.partition["kind"] == "data"
    plain = pt_cc.compile(params, specs, res=32, batch=2,
                          algorithm="winograd", artifact=art, device="cpu")
    assert plain.partition is None
    assert plan_cache_info()["artifact_misses"] == 2


@pytest.mark.parametrize("kind,d", [("spatial", 4), ("data", 2)])
def test_partition_record_matches_reference_header(tmp_path, kind, d):
    """Both packages write the same record for the same graph, and the port
    warm-starts from the reference's partitioned artifact."""
    params, specs, want, x, ref_params = ladder("cnn", 8)
    ref_art = str(tmp_path / "ref.npz")
    ref_net = ref_cc.compile(ref_params, REF_SPECS, res=32, batch=8,
                             algorithm="winograd", mesh=ref_mesh(d),
                             partition=kind, artifact=ref_art)
    pt_art = str(tmp_path / "port.npz")
    pt_cc.compile(params, specs, res=32, batch=8, algorithm="winograd",
                  mesh=cpu_mesh(d), partition=kind).save(pt_art)
    assert _header(pt_art)["partition"] == _header(ref_art)["partition"]
    clear_plan_cache()
    warm = pt_cc.compile(params, specs, res=32, batch=8,
                         algorithm="winograd", mesh=cpu_mesh(d),
                         partition=kind, artifact=ref_art)
    assert plan_cache_info()["artifact_hits"] == 1
    assert warm.partition == ref_net.partition
    assert rel(warm.apply(torch.from_numpy(x)), want) < TOL


def _header(path):
    import json
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["__header__"][()]))


# ---------------------------------------------------------------------------
# serving: mesh-sharded buckets
# ---------------------------------------------------------------------------

SERVE_SPECS = [pt_cnn.Conv("c1", 3, 3, 8),
               pt_cnn.Conv("c2", 3, 3, 8, relu=False)]
REF_SERVE_SPECS = [ref_cnn.Conv("c1", 3, 3, 8),
                   ref_cnn.Conv("c2", 3, 3, 8, relu=False)]


def test_server_shards_divisible_buckets(tmp_path):
    ref_params = jax.tree.map(lambda t: t.numpy(), pt_cnn.init_cnn(
        torch.Generator().manual_seed(0), SERVE_SPECS, 3, res=16,
        device="cpu"))
    params = pt_cnn.params_from_reference(ref_params, "cpu")
    cfg = dict(buckets=(1, 2, 4, 8), queue_capacity=64, verbose=False,
               backoff_base_s=0.002, backoff_cap_s=0.01)
    ref_srv = ref_serve.Server(ref_params, REF_SERVE_SPECS, res=16,
                               algorithm="winograd",
                               config=ref_serve.ServeConfig(**cfg),
                               mesh=ref_mesh(4), partition="data")
    srv = Server(params, SERVE_SPECS, res=16, algorithm="winograd",
                 config=ServeConfig(**cfg), mesh=cpu_mesh(4),
                 partition="data", artifact_dir=str(tmp_path))
    assert srv.stats.sharded_buckets == \
        ref_srv.stats.sharded_buckets == {"4": 4, "8": 4}
    assert srv.stats.snapshot()["sharded_buckets"] == {"4": 4, "8": 4}
    assert sorted(os.listdir(tmp_path)) == [
        "plan_b1.npz", "plan_b1_data4.npz", "plan_b2.npz",
        "plan_b2_data4.npz", "plan_b4.npz", "plan_b4_data4.npz",
        "plan_b8.npz", "plan_b8_data4.npz"]
    xs = [np.random.default_rng(i).standard_normal(
        (16, 16, 3)).astype(np.float32) for i in range(8)]
    srv.start()
    ys = [t.result(timeout=60) for t in [srv.submit(x) for x in xs]]
    srv.stop()
    assert srv.stats.failed == 0 and srv.stats.in_flight == 0
    assert srv.stats.jit_dispatches >= 1
    oracle = pt_cc.compile(params, SERVE_SPECS, res=16, batch=1,
                           algorithm="winograd", device="cpu")
    for x, y in zip(xs, ys):
        assert rel(y, oracle.apply(torch.from_numpy(x[None]))[0]) < TOL
    # a second server warm-starts every bucket, sharded ones included
    again = Server(params, SERVE_SPECS, res=16, algorithm="winograd",
                   config=ServeConfig(**cfg), mesh=cpu_mesh(4),
                   partition="data", artifact_dir=str(tmp_path))
    assert again.stats.artifact_warm_starts == 8
    assert again.sharded_nets[8].partition == srv.sharded_nets[8].partition
