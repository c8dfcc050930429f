"""Parity of the port's streaming Winograd conv (kernels/ops.py ->
kernels/winograd.py, plain path on the CPU) and of its plans with the JAX
package.

The oracle is the reference's pure-JAX executor
core/winograd.py:winograd_conv2d_pretransformed + kernels/runtime.py:
epilogue_jnp, fed the same Winograd-domain filter. The reference's own
streaming Pallas kernel is not the oracle: it does not run under the
installed JAX (pl.Unblocked is gone).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as ref_plan
from repro.core import winograd as ref_wg
from repro.kernels import runtime as ref_rt
from repro.optim import compression as ref_comp
from repro_torch.core import plan as pt_plan
from repro_torch.core import transforms as pt_tf
from repro_torch.core import winograd as pt_wg
from repro_torch.kernels import ops as pt_ops
from repro_torch.kernels import winograd as pt_kw
from repro_torch.optim import compression as pt_comp

#: Relative max-abs error bound (of the reference's max |y|) for fp32
#: filters: both sides run the same transforms in fp32 but sum in another
#: order; F(2, 7)'s 8-point transforms carry entries up to 64, so rounding
#: grows with the tile.
TOL_F32 = 2e-5
#: bf16 / int8 filters are widened to fp32 identically on both sides (bf16
#: values and int8 codes are exact in fp32), so they hold the fp32 bound.
TOL = {"float32": TOL_F32, "bfloat16": TOL_F32, "int8": TOL_F32}

KS = [2, 3, 4, 5, 7]


def _case(rng, k, c, m, h, w, n=2):
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((k, k, c, m)) / (k * np.sqrt(c))).astype(
        np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    return x, wt, b


def _reference(x, u4, ct, geom, bias, act, scale=None):
    y = ref_wg.winograd_conv2d_pretransformed(
        jnp.asarray(x), jnp.asarray(u4), ct, ct, geometry=geom)
    if scale is not None:
        y = y * jnp.asarray(scale)
    return np.asarray(ref_rt.epilogue_jnp(
        y, None if bias is None else jnp.asarray(bias), act))


def _port(x, u_pcm, ct, padding, bias, act, scale=None):
    """The port's planned op on the CPU, from a (P, C, M) filter."""
    n, h, w, c = x.shape
    m = u_pcm.shape[2]
    pct = pt_tf.cook_toom(ct.m, ct.r)
    geom = pt_wg.conv2d_geometry(h, w, ct.r, ct.r, ct.m, ct.m, padding)
    stream = pt_wg.stream_geometry_tf32x3(
        geom.n_h, geom.n_w, c, m, pct, pct, batch=n,
        u_size=u_pcm.element_size())
    u = pt_ops.pad_winograd_filter(u_pcm, stream.block_c, stream.block_m)
    sc = None
    if scale is not None:
        sc = torch.nn.functional.pad(torch.from_numpy(scale),
                                     (0, stream.m_pad - m), value=1.0)
        sc = sc.reshape(1, -1)
    before = pt_kw.winograd_streamed.LAUNCHES
    y = pt_ops.winograd_conv2d_planned(
        torch.from_numpy(x), u, ct_h=pct, ct_w=pct, geometry=geom,
        stream=stream, c_out=m,
        bias=None if bias is None else torch.from_numpy(bias),
        scale=sc, activation=act)
    assert pt_kw.winograd_streamed.LAUNCHES == before   # CPU: no kernel
    return y.numpy()


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", KS)
def test_planned_op_matches_reference_executor(k, compute_dtype):
    """Every filter size at its default tile, each filter dtype; C spans
    one block (3) or three (20), odd H/W, bias, activations rotate."""
    rng = np.random.default_rng(10 * k + len(compute_dtype))
    c = 3 if k % 2 else 20
    act = ("none", "relu", "relu6", "gelu")[(k + len(compute_dtype)) % 4]
    padding = "SAME" if k != 4 else "VALID"
    x, wt, b = _case(rng, k, c, 6, 11, 9)
    mt = pt_tf.DEFAULT_OUTPUT_TILE[k]
    ct = ref_wg.cook_toom(mt, k)
    geom = ref_wg.conv2d_geometry(11, 9, k, k, mt, mt, padding)
    u4 = np.array(ref_wg.transform_filter_2d(jnp.asarray(wt), ct, ct))
    u_pcm = u4.reshape(ct.t * ct.t, c, 6)
    scale = None
    if compute_dtype == "bfloat16":
        u_ref = np.asarray(jnp.asarray(u4).astype(jnp.bfloat16)
                           .astype(jnp.float32))
        u_pt = torch.from_numpy(u_pcm).to(torch.bfloat16)
        assert np.array_equal(u_pt.float().numpy().reshape(u4.shape), u_ref)
    elif compute_dtype == "int8":
        q_ref, s_ref = ref_comp.quantize_channelwise(jnp.asarray(u_pcm))
        q_pt, s_pt = pt_comp.quantize_channelwise(torch.from_numpy(u_pcm))
        np.testing.assert_array_equal(q_pt.numpy(), np.asarray(q_ref))
        np.testing.assert_array_equal(s_pt.numpy(), np.asarray(s_ref))
        u_ref = np.asarray(q_ref).astype(np.float32).reshape(u4.shape)
        u_pt, scale = q_pt, np.asarray(s_ref)
    else:
        u_ref, u_pt = u4, torch.from_numpy(u_pcm)
    ref = _reference(x, u_ref, ct, geom, b, act, scale)
    got = _port(x, u_pt, ct, padding, b, act, scale)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL[compute_dtype]


@pytest.mark.parametrize("act", ["none", "relu", "relu6", "gelu"])
def test_planned_op_activations_and_no_bias(act):
    """F(4, 3) with C spanning several blocks, M past one block, no bias."""
    rng = np.random.default_rng(5)
    x, wt, _ = _case(rng, 3, 19, 70, 13, 7)
    ct = ref_wg.cook_toom(4, 3)
    geom = ref_wg.conv2d_geometry(13, 7, 3, 3, 4, 4, "SAME")
    u4 = np.array(ref_wg.transform_filter_2d(jnp.asarray(wt), ct, ct))
    ref = _reference(x, u4, ct, geom, None, act)
    got = _port(x, torch.from_numpy(u4.reshape(36, 19, 70)), ct, "SAME",
                None, act)
    assert _rel(got, ref) <= TOL_F32


@pytest.mark.parametrize("mt", [1, 2, 6])
def test_planned_op_explicit_tiles(mt):
    """Explicit output tiles up to t = 8 (F(6, 3))."""
    rng = np.random.default_rng(6 + mt)
    x, wt, b = _case(rng, 3, 5, 4, 10, 15)
    ct = ref_wg.cook_toom(mt, 3)
    geom = ref_wg.conv2d_geometry(10, 15, 3, 3, mt, mt, "SAME")
    u4 = np.array(ref_wg.transform_filter_2d(jnp.asarray(wt), ct, ct))
    ref = _reference(x, u4, ct, geom, b, "relu")
    got = _port(x, torch.from_numpy(u4.reshape(ct.t ** 2, 5, 4)), ct,
                "SAME", b, "relu")
    assert _rel(got, ref) <= TOL_F32


def test_plain_version_rejects_mismatched_operands():
    ct = pt_tf.cook_toom(4, 3)
    xp = torch.zeros(1, 11, 10, 8)               # 11 - 2 is not 8-aligned
    u = torch.zeros(36, 8, 16)
    with pytest.raises(ValueError, match="do not match"):
        pt_kw.winograd_streamed(xp, u, None, ct_h=ct, ct_w=ct, bh=2, bw=2,
                                block_c=8, block_m=16)
    with pytest.raises(ValueError, match="activation"):
        pt_kw.winograd_streamed(xp, u, None, ct_h=ct, ct_w=ct, bh=1, bw=2,
                                block_c=8, block_m=16, activation="swish")


@pytest.mark.parametrize("k", KS)
def test_plan_matches_reference_plan(k, monkeypatch):
    """Tiles and geometry exactly; the cropped Winograd-domain filter up to
    fp32 rounding of the transform (1e-6 of max |u|: both sides contract
    G w G^T in fp32, in another order)."""
    monkeypatch.setenv("REPRO_PLAN_NO_MEASURE", "1")
    rng = np.random.default_rng(20 + k)
    c, m = 5, 12
    x_shape = (2, 17, 12, c)
    wt = rng.standard_normal((k, k, c, m)).astype(np.float32)
    ref = ref_plan.plan_conv2d(x_shape, jnp.asarray(wt),
                               algorithm="pallas_winograd")
    got = pt_plan.plan_conv2d(x_shape, torch.from_numpy(wt),
                              algorithm="pallas_winograd", device="cpu")
    assert got.spec.algorithm == ref.spec.algorithm == "pallas_winograd"
    assert got.spec.output_tile == ref.spec.output_tile
    assert got.spec.geometry == tuple(ref.spec.geometry)
    assert got.out_shape == ref.out_shape
    assert got.describe() == ref.describe()
    u_ref = np.asarray(ref.u)[:, :c, :m]
    u_got = got.u.numpy()[:, :c, :m]
    np.testing.assert_allclose(u_got, u_ref, rtol=0,
                               atol=1e-6 * np.abs(u_ref).max())
    assert not got.u[:, c:].any() and not got.u[:, :, m:].any()


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "int8"])
def test_reduced_precision_plan_matches_reference(compute_dtype, monkeypatch):
    """A reduced dtype takes the small tile, as in the reference; the
    applied plans agree to the fp32 bound (TOL) since the quantized
    filters are equal or differ only where the fp32 transform rounded
    differently (checked: max |q| difference <= 1 code)."""
    monkeypatch.setenv("REPRO_PLAN_NO_MEASURE", "1")
    rng = np.random.default_rng(7)
    x_shape = (1, 9, 9, 4)
    wt = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    x = rng.standard_normal(x_shape).astype(np.float32)
    ref = ref_plan.plan_conv2d(x_shape, jnp.asarray(wt),
                               algorithm="pallas_winograd",
                               compute_dtype=compute_dtype)
    got = pt_plan.plan_conv2d(x_shape, torch.from_numpy(wt),
                              algorithm="pallas_winograd",
                              compute_dtype=compute_dtype, device="cpu")
    assert got.spec.output_tile == ref.spec.output_tile == (2, 2)
    u_ref = np.asarray(ref.u.astype(jnp.float32))[:, :4, :6]
    u_got = got.u.float().numpy()[:, :4, :6]
    step = 1.0 if compute_dtype == "int8" else 2 ** -7 * np.abs(u_ref).max()
    assert np.max(np.abs(u_got - u_ref)) <= step
    # the reference's executor on the reference's plan filter is the oracle
    wplan = ref_plan.plan_conv2d(x_shape, jnp.asarray(wt), algorithm="winograd",
                                 compute_dtype=compute_dtype)
    y_ref = np.asarray(wplan.apply(jnp.asarray(x), activation="relu"))
    y_got = got.apply(torch.from_numpy(x), activation="relu").numpy()
    assert _rel(y_got, y_ref) <= 5e-3   # one int8 code / bf16 ulp of u apart


@pytest.mark.parametrize("algorithm", ["winograd", "im2col", "pallas_winograd"])
@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_conv_plan_apply_matches_reference(algorithm, data_format,
                                           monkeypatch):
    """Each ported executor, NHWC and NCHW ingest, against the same
    reference plan (1e-5 relative: fp32 sums in another order)."""
    monkeypatch.setenv("REPRO_PLAN_NO_MEASURE", "1")
    rng = np.random.default_rng(8)
    c, m = 6, 10
    x = rng.standard_normal((2, 12, 13, c)).astype(np.float32)
    wt = rng.standard_normal((3, 3, c, m)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    xs, ws = x, wt
    if data_format == "NCHW":
        xs, ws = x.transpose(0, 3, 1, 2), wt.transpose(3, 2, 0, 1)
    ref = ref_plan.plan_conv2d(xs.shape, jnp.asarray(ws), algorithm=algorithm
                               if algorithm != "pallas_winograd"
                               else "winograd", data_format=data_format)
    got = pt_plan.plan_conv2d(xs.shape, torch.from_numpy(ws),
                              algorithm=algorithm, data_format=data_format,
                              device="cpu")
    y_ref = np.asarray(ref.apply(jnp.asarray(xs), bias=jnp.asarray(b),
                                 activation="relu6"))
    y_got = got.apply(torch.from_numpy(xs), bias=torch.from_numpy(b),
                      activation="relu6").numpy()
    assert got.out_shape == ref.out_shape == y_got.shape
    assert _rel(y_got, y_ref) <= 1e-5


def test_unported_executors_name_their_roadmap_item():
    """Every executor now plans (fft and winograd_f63 included), compile()
    binds a conv1d node (to a Conv1DPlan), and an unknown executor is a
    ValueError."""
    w = torch.zeros(3, 3, 8, 8)
    for alg in ("fft", "winograd_f63"):
        p = pt_plan.plan_conv2d((1, 8, 8, 8), w, algorithm=alg,
                                device="cpu")
        assert p.algorithm == alg
    with pytest.raises(ValueError, match="unknown algorithm"):
        pt_plan._build_spec((1, 8, 8, 8), (3, 3, 8, 8), "float32", (1, 1),
                            "SAME", "winograd", "no_such_executor", None)
    from repro_torch.core import compile as pt_compile
    graph = (pt_compile.LayerIR(id="input", op="input"),
             pt_compile.LayerIR(id="c", op="conv1d", inputs=("input",),
                                attrs=dict(k=3, c_out=4, stride=2,
                                           padding="SAME", activation="gelu",
                                           w_path=("w",), b_path=None)))
    net = pt_compile.compile({"w": torch.zeros(3, 8, 4)}, graph,
                             input_shape=(1, 9, 8), device="cpu")
    assert isinstance(net.plans["c"], pt_plan.Conv1DPlan)
    assert net.apply(torch.zeros(1, 9, 8)).shape == (1, 5, 4)
