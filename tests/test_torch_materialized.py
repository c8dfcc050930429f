"""Parity of the port's `pallas_winograd_materialized` path, the A/B
baseline of the streamed Winograd kernel, with the JAX package: the plain
version of the tiles-domain kernel `winograd_fused` against the
reference's Pallas kernel (which runs here in interpret mode: its
BlockSpecs are all blocked) and its pure-JAX oracle, the plan, and VGG-16,
MobileNet-v1 and MobileNet-v2 end to end against the reference's own
materialized networks. The MobileNets place no conv on `winograd_fused`:
their depthwise convs fall back to grouped `im2col`, tested here too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile as ref_compile
from repro.core import im2col as ref_im2col
from repro.core import plan as ref_plan
from repro.core.transforms import cook_toom as ref_cook_toom
from repro.kernels import ref as ref_kref
from repro.kernels import winograd as ref_kw
from repro.models import cnn as ref_cnn
from repro_torch.core import compile as pt_compile
from repro_torch.core import plan as pt_plan
from repro_torch.core import winograd as pt_wg
from repro_torch.core.transforms import cook_toom
from repro_torch.kernels import winograd as pt_kw
from repro_torch.models import cnn as pt_cnn

#: fp32 transforms and point-GEMMs on both sides, summed in another order:
#: 1e-5 of the reference's max |y|.
TOL = 1e-5
RES, BATCH = 32, 2
#: int8 filters quantized by each package from its own fp32 filter matrix:
#: the same codes but where a value sits on a rounding boundary.
TOL_INT8 = 5e-3


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@pytest.fixture(scope="module", autouse=True)
def _no_measure():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PLAN_NO_MEASURE", "1")
    yield
    mp.undo()


@pytest.mark.parametrize("m,k", [(2, 3), (4, 3), (2, 5), (3, 2)])
def test_fused_plain_version_matches_reference_kernel(m, k):
    """winograd_fused_plain against the reference's Pallas winograd_fused
    (interpret mode) and its kernels/ref.py oracle on the same tiles and
    Winograd-domain filter."""
    rng = np.random.default_rng(m * 10 + k)
    ct = cook_toom(m, k)
    r, c, mout = 16, 16, 24
    tiles = rng.standard_normal((r, ct.t, ct.t, c)).astype(np.float32)
    u = rng.standard_normal((ct.t * ct.t, c, mout)).astype(np.float32)
    ref_ct = ref_cook_toom(m, k)
    want = np.asarray(ref_kw.winograd_fused(
        jnp.asarray(tiles), jnp.asarray(u), ct_h=ref_ct, ct_w=ref_ct,
        block_r=8, block_c=8, block_m=8, interpret=True))
    oracle = np.asarray(ref_kref.winograd_fused(
        jnp.asarray(tiles), jnp.asarray(u), ct_h=ref_ct, ct_w=ref_ct))
    before = pt_kw.winograd_fused.LAUNCHES
    got = pt_kw.winograd_fused(torch.from_numpy(tiles), torch.from_numpy(u),
                               ct_h=ct, ct_w=ct, block_r=16, block_c=8,
                               block_m=8).numpy()
    assert pt_kw.winograd_fused.LAUNCHES == before
    assert got.shape == want.shape == (r, m, m, mout)
    assert _rel(got, want) <= TOL
    assert _rel(got, oracle) <= TOL


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("shape,k,mout,tile", [
    ((2, 17, 13, 11), 3, 20, None), ((1, 23, 19, 8), 3, 16, 2),
    ((2, 12, 9, 5), 5, 7, None)])
def test_materialized_plan_matches_reference(shape, k, mout, tile, padding):
    """Exact decisions (executor, tile, geometry, output shape, describe),
    the (P, C, M) filter to fp32 rounding, and the applied plan (extract,
    the kernel's plain version, un-tile, epilogue) against the reference's
    materialized plan, whose kernel runs here in interpret mode."""
    rng = np.random.default_rng(k + mout)
    c = shape[3]
    x = rng.standard_normal(shape).astype(np.float32)
    wt = (rng.standard_normal((k, k, c, mout)) / (k * k * c) ** 0.5).astype(
        np.float32)
    b = rng.standard_normal(mout).astype(np.float32)
    kw = dict(algorithm="pallas_winograd_materialized", output_tile=tile,
              padding=padding)
    ref = ref_plan.plan_conv2d(shape, jnp.asarray(wt), **kw)
    got = pt_plan.plan_conv2d(shape, torch.from_numpy(wt), device="cpu",
                              **kw)
    assert got.spec.algorithm == ref.spec.algorithm == \
        "pallas_winograd_materialized"
    assert got.spec.output_tile == ref.spec.output_tile
    assert got.spec.geometry == tuple(ref.spec.geometry)
    assert got.out_shape == ref.out_shape
    assert got.describe() == ref.describe()
    u_ref = np.asarray(ref.u)[:, :c, :mout]
    np.testing.assert_allclose(got.u.numpy()[:, :c, :mout], u_ref, rtol=0,
                               atol=1e-6 * np.abs(u_ref).max())
    assert not got.u[:, c:].any() and not got.u[:, :, mout:].any()
    y_ref = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                 activation="relu"))
    y = got.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                  activation="relu").numpy()
    assert y.shape == y_ref.shape
    assert _rel(y, y_ref) <= TOL


@pytest.fixture(scope="module")
def vgg():
    specs = ref_cnn.vgg16()
    ref_params = ref_cnn.init_cnn(jax.random.key(3), specs, 3, res=RES)
    x = np.random.default_rng(3).standard_normal(
        (BATCH, RES, RES, 3)).astype(np.float32)
    net = pt_compile.compile(
        pt_cnn.params_from_reference(jax.tree.map(np.array, ref_params),
                                     "cpu"),
        pt_cnn.vgg16(), res=RES, batch=BATCH,
        algorithm="pallas_winograd_materialized", device="cpu")
    ref = ref_compile.compile(ref_params, specs, res=RES, batch=BATCH,
                              algorithm="pallas_winograd_materialized")
    return ref, net, x


def test_vgg16_materialized_placement_equals_reference(vgg):
    """Exact: every conv on pallas_winograd_materialized, the same tiles
    and output shapes as the reference's table."""
    ref, net, _ = vgg
    assert net.describe() == ref.describe()
    assert net.out_shape == ref.out_shape
    kinds = [p.describe()["executor"] for p in net.plans.values()]
    assert kinds == ["pallas_winograd_materialized"] * 13


def test_vgg16_materialized_logits_match_reference(vgg):
    """The port's materialized network (the kernel's plain version on the
    CPU, which launches nothing) against the reference's own materialized
    network, whose Pallas kernel runs here in interpret mode."""
    ref, net, x = vgg
    y_ref = np.asarray(ref.apply(jnp.asarray(x)))
    before = pt_kw.winograd_fused.LAUNCHES
    y = net.apply(torch.from_numpy(x)).numpy()
    assert pt_kw.winograd_fused.LAUNCHES == before
    assert y.shape == y_ref.shape == (BATCH, 1000)
    assert np.isfinite(y).all()
    assert _rel(y, y_ref) <= TOL


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape,k,groups,mout,stride", [
    ((2, 13, 11, 12), 3, 12, 12, 1),       # depthwise
    ((2, 13, 11, 12), 3, 12, 24, 2),       # depthwise, multiplier 2
    ((1, 9, 10, 8), 5, 4, 12, 1),          # grouped
    ((2, 7, 8, 6), 1, 3, 9, 1)])           # grouped 1x1
def test_grouped_im2col_matches_reference(shape, k, groups, mout, stride,
                                          compute_dtype):
    """The grouped im2col executor (per-group row blocks times per-group
    filter matrices; output channel o = g*M/G + j) against the
    reference's im2col plan: the same bound filter matrix and the same
    applied result, bf16 activations rounded as the reference rounds them."""
    rng = np.random.default_rng(k + groups + mout)
    c = shape[3]
    x = rng.standard_normal(shape).astype(np.float32)
    wt = (rng.standard_normal((k, k, c // groups, mout)) / k).astype(
        np.float32)
    b = rng.standard_normal(mout).astype(np.float32)
    kw = dict(algorithm="im2col", groups=groups, stride=stride,
              compute_dtype=compute_dtype)
    ref = ref_plan.plan_conv2d(shape, jnp.asarray(wt), **kw)
    got = pt_plan.plan_conv2d(shape, torch.from_numpy(wt), device="cpu",
                              **kw)
    assert got.describe() == ref.describe()
    assert got.out_shape == ref.out_shape
    assert got.u.shape == ref.u.shape
    if compute_dtype == "bfloat16":
        # this host's XLA has no bf16 x bf16 -> f32 dot for some of the
        # reference's grouped einsums: take its lowering, round it to bf16
        # as its executor does, and sum against its bound bf16 filter here
        a, _ = ref_im2col.grouped_im2row(jnp.asarray(x), k, k,
                                         (stride, stride), "SAME", groups)
        a = np.asarray(a.astype(jnp.bfloat16).astype(jnp.float32))
        y_ref = np.einsum("rgk,gkm->rgm", a,
                          np.asarray(ref.u.astype(jnp.float32)))
        y_ref = np.clip(y_ref.reshape(ref.out_shape) + b, 0.0, 6.0)
    else:
        y_ref = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                     activation="relu6"))
    y = got.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                  activation="relu6").numpy()
    assert y.shape == y_ref.shape
    assert _rel(y, y_ref) <= (TOL_INT8 if compute_dtype == "int8" else TOL)


@pytest.mark.parametrize("name", ["mobilenet_v1", "mobilenet_v2"])
def test_mobilenet_materialized_matches_reference(name):
    """The MobileNets under pallas_winograd_materialized: the reference's
    table (stems and depthwise convs on im2col, pointwise convs on
    pallas_im2col) and its logits, which run here (no streamed kernel)."""
    specs = getattr(ref_cnn, name)()
    ref_params = ref_cnn.init_cnn(jax.random.key(5), specs, 3, res=RES)
    x = np.random.default_rng(5).standard_normal(
        (BATCH, RES, RES, 3)).astype(np.float32)
    kw = dict(res=RES, batch=BATCH, algorithm="pallas_winograd_materialized")
    ref = ref_compile.compile(ref_params, specs, **kw)
    net = pt_compile.compile(
        pt_cnn.params_from_reference(jax.tree.map(np.array, ref_params),
                                     "cpu"),
        getattr(pt_cnn, name)(), device="cpu", **kw)
    assert net.describe() == ref.describe()
    y_ref = np.asarray(ref.apply(jnp.asarray(x)))
    y = net.apply(torch.from_numpy(x)).numpy()
    assert y.shape == y_ref.shape == (BATCH, 1000)
    assert _rel(y, y_ref) <= TOL
