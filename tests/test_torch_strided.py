"""Parity of the port's stride-2 path with the JAX package: the phase
geometry and tile choice, the stride-2 plans of the streamed kernels
(`pallas_winograd_strided`, `pallas_depthwise_strided`) and their applied
results on the CPU (the kernels' plain versions), and the pure-PyTorch
`winograd_strided` / `winograd_depthwise` executors.

The oracle for applied results is the reference's `algorithm="winograd"`
plan (its pure-JAX `winograd_strided` / `winograd_depthwise` executors):
the reference's streamed Pallas kernels do not run under the installed
JAX (pl.Unblocked is gone).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as ref_plan
from repro.core import winograd as ref_wg
from repro_torch.core import plan as pt_plan
from repro_torch.core import transforms as pt_tf
from repro_torch.core import winograd as pt_wg

#: fp32: both sides run the same transforms and sums in fp32, in another
#: order (the phase sum, the GEMM): 1e-5 of the reference's max |y|.
TOL_F32 = 1e-5
#: bf16 / int8 filters: both sides quantize the same transformed filter,
#: but the fp32 transforms round differently, so a code or a bf16 ulp of u
#: may differ (checked by the plan tests); one such step moves an output
#: by well under 5e-3 of its range.
TOL_REDUCED = 5e-3
ACTS = ["none", "relu", "relu6", "gelu"]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@pytest.fixture(autouse=True)
def _no_measure(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_NO_MEASURE", "1")


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("h,w", [(224, 224), (17, 12), (9, 30), (56, 55)])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_strided_geometry_and_tile_equal_reference(k, h, w, padding):
    """Exact: conv pads, phase tile counts and output sizes, the default
    stride-2 tile for a shallow and a deep layer, and explicit tiles."""
    for c_in in (16, 128):
        tile = pt_plan._resolve_strided_tile(h, w, k, k, padding, None, c_in)
        assert tile == ref_plan._resolve_strided_tile(h, w, k, k, padding,
                                                      None, c_in)
        for mt in (tile[0], 1, 3):
            assert pt_wg.conv2d_strided_geometry(h, w, k, k, mt, mt,
                                                 padding) == \
                tuple(ref_wg.conv2d_strided_geometry(h, w, k, k, mt, mt,
                                                     padding))
    assert pt_wg.strided_out_size(h, k, padding) == \
        ref_wg.strided_out_size(h, k, padding)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_strided_phase_filters_equal_reference(k):
    rng = np.random.default_rng(k)
    wt = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    r = (k + 1) // 2
    for m in (2, 4):
        ref = ref_wg.strided_phase_filters(jnp.asarray(wt),
                                           ref_wg.cook_toom(m, r),
                                           ref_wg.cook_toom(m, r))
        ct = pt_tf.cook_toom(m, r)
        got = pt_wg.strided_phase_filters(torch.from_numpy(wt), ct, ct)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6 * np.abs(np.asarray(ref)).max())


def _plans(x_shape, wt, groups, compute_dtype, tile=None):
    kw = dict(stride=2, groups=groups, algorithm="pallas_winograd",
              compute_dtype=compute_dtype, output_tile=tile)
    ref = ref_plan.plan_conv2d(x_shape, jnp.asarray(wt), **kw)
    got = pt_plan.plan_conv2d(x_shape, torch.from_numpy(wt), device="cpu",
                              **kw)
    return ref, got


def _check_u(u_got, u_ref, compute_dtype):
    """The cropped filters agree to fp32 rounding of the transform, or to
    one int8 code / one bf16 step of the reference's."""
    if compute_dtype == "float32":
        np.testing.assert_allclose(u_got, u_ref, rtol=0,
                                   atol=1e-6 * np.abs(u_ref).max())
        return
    step = 1.0 if compute_dtype == "int8" else 2 ** -7 * np.abs(u_ref).max()
    assert np.max(np.abs(u_got - u_ref)) <= step


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k,h,c,tile", [(3, 224, 3, None), (3, 23, 20, None),
                                        (5, 18, 7, 4), (7, 15, 9, 2)])
def test_dense_strided_plan_matches_reference(k, h, c, tile, compute_dtype):
    """pallas_winograd on a stride-2 dense layer: the same executor, tile,
    geometry and output shape; the cropped phase-major (4P, C, M) filter."""
    rng = np.random.default_rng(k + h + c)
    m = 12
    x_shape = (2, h, h + 1, c)
    wt = rng.standard_normal((k, k, c, m)).astype(np.float32)
    ref, got = _plans(x_shape, wt, 1, compute_dtype, tile)
    assert got.spec.algorithm == ref.spec.algorithm == \
        "pallas_winograd_strided"
    assert got.spec.output_tile == ref.spec.output_tile
    assert got.spec.geometry == tuple(ref.spec.geometry)
    assert got.out_shape == ref.out_shape
    assert got.describe() == ref.describe()
    u_ref = np.asarray(ref.u.astype(jnp.float32))[:, :c, :m]
    u_got = got.u.float().numpy()[:, :c, :m]
    _check_u(u_got, u_ref, compute_dtype)
    assert not got.u[:, c:].float().any() and \
        not got.u[:, :, m:].float().any()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k,h,c,tile", [(3, 112, 64, None), (3, 56, 128, None),
                                        (5, 21, 13, 4), (7, 16, 8, 2)])
def test_depthwise_strided_plan_matches_reference(k, h, c, tile,
                                                  compute_dtype):
    """pallas_winograd on a stride-2 depthwise layer: the same executor,
    tile, geometry and output shape; the cropped (4P, C) taps."""
    rng = np.random.default_rng(k + h + c + 1)
    x_shape = (2, h, h - 1, c)
    wt = rng.standard_normal((k, k, 1, c)).astype(np.float32)
    ref, got = _plans(x_shape, wt, c, compute_dtype, tile)
    assert got.spec.algorithm == ref.spec.algorithm == \
        "pallas_depthwise_strided"
    assert got.spec.output_tile == ref.spec.output_tile
    assert got.spec.geometry == tuple(ref.spec.geometry)
    assert got.out_shape == ref.out_shape
    assert got.describe() == ref.describe()
    u_ref = np.asarray(ref.u.astype(jnp.float32))[:, :c]
    _check_u(got.u.float().numpy()[:, :c], u_ref, compute_dtype)
    s = got.spec.stream
    assert pt_wg.depthwise_strided_blocking_fits(
        got.spec.ct_h, got.spec.ct_w, s.bh, s.bw, s.block_c)
    assert s.c_pad % s.block_c == 0 and s.c_pad >= c


def _case(rng, n, h, w, c, k, groups, m):
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((k, k, c // groups, m)) / k).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    return x, wt, b


def _applied(x_shape, x, wt, b, groups, compute_dtype, act, algorithm,
             tile=None):
    """(port plan on `algorithm`, reference winograd plan) applied."""
    kw = dict(stride=2, groups=groups, compute_dtype=compute_dtype,
              output_tile=tile)
    ref = ref_plan.plan_conv2d(x_shape, jnp.asarray(wt), algorithm="winograd",
                               **kw)
    got = pt_plan.plan_conv2d(x_shape, torch.from_numpy(wt),
                              algorithm=algorithm, device="cpu", **kw)
    y_ref = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                 activation=act))
    y = got.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                  activation=act).numpy()
    assert y.shape == y_ref.shape == got.out_shape
    return got, y, y_ref


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
def test_dense_strided_executor_matches_reference(compute_dtype, act):
    """ConvPlan.apply of pallas_winograd_strided (the kernel's plain version
    on the CPU) against the reference's winograd_strided plan; SAME pads on
    odd H/W, C spanning two channel steps."""
    rng = np.random.default_rng(len(act) + len(compute_dtype))
    x, wt, b = _case(rng, 2, 19, 14, 11, 3, 1, 10)
    got, y, y_ref = _applied(x.shape, x, wt, b, 1, compute_dtype, act,
                             "pallas_winograd")
    assert got.spec.algorithm == "pallas_winograd_strided"
    tol = TOL_F32 if compute_dtype == "float32" else TOL_REDUCED
    assert _rel(y, y_ref) <= tol


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
def test_depthwise_strided_executor_matches_reference(compute_dtype, act):
    """ConvPlan.apply of pallas_depthwise_strided against the reference's
    winograd_strided depthwise plan; both default tiles (F(4, 2) on the
    shallow 64-channel layer, F(2, 2) on the deep one)."""
    rng = np.random.default_rng(10 + len(act) + len(compute_dtype))
    for h, c in ((48, 64), (13, 72)):
        x, wt, b = _case(rng, 2, h, h + 3, c, 3, c, c)
        got, y, y_ref = _applied(x.shape, x, wt, b, c, compute_dtype, act,
                                 "pallas_winograd")
        assert got.spec.algorithm == "pallas_depthwise_strided"
        tol = TOL_F32 if compute_dtype == "float32" else TOL_REDUCED
        assert _rel(y, y_ref) <= tol


@pytest.mark.parametrize("k,padding", [(5, "SAME"), (7, "VALID"),
                                       (3, "VALID")])
def test_strided_filter_sizes_match_reference(k, padding):
    """k in {3, 5, 7} through both stride-2 streamed executors at explicit
    tiles 2 and 4, fp32, SAME and VALID."""
    rng = np.random.default_rng(30 + k)
    for tile in (2, 4):
        x, wt, b = _case(rng, 1, 21, 18, 6, k, 1, 5)
        _, y, y_ref = _applied(x.shape, x, wt, b, 1, "float32", "relu",
                               "pallas_winograd", tile)
        assert _rel(y, y_ref) <= TOL_F32
        x, wt, b = _case(rng, 1, 21, 18, 6, k, 6, 6)
        _, y, y_ref = _applied(x.shape, x, wt, b, 6, "float32", "relu6",
                               "pallas_winograd", tile)
        assert _rel(y, y_ref) <= TOL_F32


@pytest.mark.parametrize("groups", [1, 4, 8])
def test_winograd_strided_executor_matches_reference(groups):
    """The pure-PyTorch winograd_strided executor, dense / grouped /
    depthwise, against the reference's."""
    rng = np.random.default_rng(40 + groups)
    x, wt, b = _case(rng, 2, 15, 16, 8, 3, groups, 8)
    got, y, y_ref = _applied(x.shape, x, wt, b, groups, "float32", "gelu",
                             "winograd")
    assert got.spec.algorithm == "winograd_strided"
    assert _rel(y, y_ref) <= TOL_F32


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k,mult", [(3, 1), (5, 1), (3, 2)])
def test_winograd_depthwise_executor_matches_reference(k, mult,
                                                       compute_dtype):
    """The pure-PyTorch stride-1 winograd_depthwise executor, channel
    multiplier 1 and 2 (output channel o = c * mult + j)."""
    rng = np.random.default_rng(50 + k + mult)
    c = 6
    x = rng.standard_normal((2, 11, 13, c)).astype(np.float32)
    wt = (rng.standard_normal((k, k, 1, c * mult)) / k).astype(np.float32)
    b = rng.standard_normal(c * mult).astype(np.float32)
    kw = dict(groups=c, algorithm="winograd", compute_dtype=compute_dtype)
    ref = ref_plan.plan_conv2d(x.shape, jnp.asarray(wt), **kw)
    got = pt_plan.plan_conv2d(x.shape, torch.from_numpy(wt), device="cpu",
                              **kw)
    assert got.spec.algorithm == ref.spec.algorithm == "winograd_depthwise"
    y_ref = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                 activation="relu"))
    y = got.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                  activation="relu").numpy()
    tol = TOL_F32 if compute_dtype == "float32" else TOL_REDUCED
    assert _rel(y, y_ref) <= tol


def test_strided_blockings_cover_the_geometry():
    """Every chooser's blocking covers the tile grid with whole strips and
    fits its kernel: the dense stride-2 kernel takes the
    tensor-core chooser with its four phases (a blocking the shared body
    takes, C padded to one C step at most, M to one M block), the depthwise
    one a blocking its own kernel takes."""
    for n_h, n_w, c, m in ((28, 28, 3, 32), (7, 7, 512, 1024), (1, 3, 5, 7)):
        for mt, r in ((4, 2), (2, 2), (2, 4)):
            ct = pt_tf.cook_toom(mt, r)
            s = pt_wg.stream_geometry_tf32x3(n_h, n_w, c, m, ct, ct,
                                             phases=4)
            assert s.n_hb * s.bh >= n_h and s.n_wb * s.bw >= n_w
            assert s.pad_h == (s.n_hb * s.bh - n_h) * mt
            assert pt_wg.stream_tc_blocking_fits(ct, ct, s.bh, s.bw,
                                                 s.block_c, s.block_m)
            assert c <= s.c_pad < c + s.block_c
            assert m <= s.m_pad < m + s.block_m
            d = pt_wg.stream_geometry_depthwise(n_h, n_w, c, ct, ct,
                                                stride=2)
            assert d.n_hb * d.bh >= n_h and d.n_wb * d.bw >= n_w
            assert d.pad_h == (d.n_hb * d.bh - n_h) * mt
            assert pt_wg.depthwise_strided_blocking_fits(ct, ct, d.bh, d.bw,
                                                         d.block_c)
