"""Parity of the port's stride-1 depthwise path with the JAX package: the
`pallas_depthwise` plan (executor, tile, geometry, bound taps and int8
scale) and the plain version of the `depthwise_streamed` kernel, which the
wrapper runs on the CPU.

The reference's streamed Pallas kernel does not run under the installed
JAX (pl.Unblocked is gone), so the oracle for applied results is its
pure-JAX depthwise executor (core/winograd.py:
winograd_depthwise_conv2d_pretransformed) plus the kernel's epilogue
(x scale, + bias, activation), fed the reference plan's own bound taps and
scale as numpy: both sides then start from the same quantized filter and
run only fp32 transforms and Hadamard products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as ref_plan
from repro.core import winograd as ref_wg
from repro_torch.core import plan as pt_plan
from repro_torch.core import winograd as pt_wg
from repro_torch.core.transforms import cook_toom
from repro_torch.kernels import depthwise as pt_kd
from repro_torch.kernels import ops as pt_ops

#: Applied results: the same taps, fp32 transforms and products on both
#: sides, summed in another order: 1e-5 of the reference's max |y|.
TOL = 1e-5
#: Bound filters: both sides transform in fp32 (G w G^T) and round the
#: same values to bf16 / int8.
TOL_U = 1e-6
#: int8 plans quantized by each package from its own transform: one filter
#: value may land on a neighbouring code, which moves an output by well
#: under 5e-3 of its range (as in test_torch_strided.py).
TOL_REDUCED = 5e-3
ACTS = {"none": lambda y: y, "relu": jax.nn.relu,
        "relu6": lambda y: jnp.minimum(jax.nn.relu(y), 6.0),
        "gelu": jax.nn.gelu}


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@pytest.fixture(autouse=True)
def _no_measure(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_NO_MEASURE", "1")


def _case(seed, shape, k, mult):
    rng = np.random.default_rng(seed)
    c = shape[3]
    x = rng.standard_normal(shape).astype(np.float32)
    wt = (rng.standard_normal((k, k, 1, c * mult)) / k).astype(np.float32)
    b = rng.standard_normal(c * mult).astype(np.float32)
    return x, wt, b


def _plans(x_shape, wt, compute_dtype, tile=None, padding="SAME"):
    kw = dict(groups=x_shape[3], algorithm="pallas_winograd",
              compute_dtype=compute_dtype, output_tile=tile, padding=padding)
    ref = ref_plan.plan_conv2d(x_shape, jnp.asarray(wt), **kw)
    got = pt_plan.plan_conv2d(x_shape, torch.from_numpy(wt), device="cpu",
                              **kw)
    return ref, got


CASES = [  # (shape, k, mult, tile, padding)
    ((2, 17, 13, 11), 3, 1, 2, "SAME"),
    ((2, 17, 13, 11), 3, 2, 4, "VALID"),
    ((1, 23, 19, 37), 3, 1, 4, "SAME"),
    ((2, 9, 14, 5), 5, 2, 2, "SAME"),
    ((1, 15, 12, 8), 5, 1, 4, "VALID"),
    ((2, 12, 11, 6), 7, 1, 2, "SAME"),
]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape,k,mult,tile,padding", CASES)
def test_depthwise_plan_binds_reference_filter(shape, k, mult, tile, padding,
                                               compute_dtype):
    """pallas_depthwise: the same executor, tile, geometry, output shape and
    describe(); the cropped (P, C, mult) taps to 1e-6 (int8: one code) and
    the int8 scale row (o = c*mult + j) to 1e-6."""
    _, wt, _ = _case(k + mult, shape, k, mult)
    ref, got = _plans(shape, wt, compute_dtype, tile, padding)
    c = shape[3]
    assert got.spec.algorithm == ref.spec.algorithm == "pallas_depthwise"
    assert got.spec.output_tile == ref.spec.output_tile
    assert got.spec.geometry == tuple(ref.spec.geometry)
    assert got.out_shape == ref.out_shape
    assert got.describe() == ref.describe()
    u_ref = np.asarray(ref.u.astype(jnp.float32))[:, :c, :]
    u_got = got.u.float().numpy()
    assert u_got.shape[::2] == u_ref.shape[::2]
    assert not u_got[:, c:].any()
    u_got = u_got[:, :c, :]
    if compute_dtype == "int8":
        assert np.max(np.abs(u_got - u_ref)) <= 1.0
        s_ref = np.asarray(ref.scale).reshape(-1)[:c * mult]
        s_got = got.scale.numpy().reshape(-1)
        assert got.scale.shape == (1, got.u.shape[1] * mult)
        np.testing.assert_allclose(s_got[:c * mult], s_ref, rtol=0,
                                   atol=TOL_U * np.abs(s_ref).max())
    else:
        np.testing.assert_allclose(u_got, u_ref, rtol=0,
                                   atol=TOL_U * np.abs(u_ref).max())
    s = got.spec.stream
    assert pt_wg.depthwise_blocking_fits(got.spec.ct_h, got.spec.ct_w, s.bh,
                                         s.bw, s.block_c, mult)
    assert s.c_pad % s.block_c == 0 and s.c_pad >= c
    assert (s.block_m, s.m_pad) == (s.block_c * mult, s.c_pad * mult)


@pytest.mark.parametrize("activation", ["relu6", "gelu"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape,k,mult,tile,padding", CASES)
def test_plain_version_matches_reference(shape, k, mult, tile, padding,
                                         compute_dtype, activation):
    """The port's planned depthwise conv (its one pad, the kernel's plain
    version over the halo-padded blocks, one crop) on the reference plan's
    bound taps and scale, against the reference's pure-JAX depthwise
    executor with the same taps plus the epilogue."""
    x, wt, b = _case(10 * k + mult, shape, k, mult)
    ref, got = _plans(shape, wt, compute_dtype, tile, padding)
    c, t = shape[3], ref.spec.ct_h.t
    u = np.array(ref.u.astype(jnp.float32))[:, :c, :]         # (P, C, mult)
    y_ref = ref_wg.winograd_depthwise_conv2d_pretransformed(
        jnp.asarray(x), jnp.asarray(u.reshape(t, t, c, mult)), ref.spec.ct_h,
        ref.spec.ct_w, padding=padding)
    scale = None
    if compute_dtype == "int8":
        scale = np.array(ref.scale).reshape(-1)[:c * mult]
        y_ref = y_ref * scale
    y_ref = np.asarray(ACTS[activation](y_ref + b))

    s = got.spec.stream
    u_pt = torch.nn.functional.pad(torch.from_numpy(u),
                                   (0, 0, 0, s.c_pad - c)).to(got.u.dtype)
    scale_pt = None
    if scale is not None:
        scale_pt = torch.nn.functional.pad(torch.from_numpy(scale),
                                           (0, (s.c_pad - c) * mult),
                                           value=1.0).reshape(1, -1)
    before = pt_kd.depthwise_streamed.LAUNCHES
    y = pt_ops.depthwise_conv2d_planned(
        torch.from_numpy(x), u_pt, ct_h=got.spec.ct_h, ct_w=got.spec.ct_w,
        geometry=got.spec.geometry, stream=s, c_out=c * mult,
        bias=torch.from_numpy(b), scale=scale_pt,
        activation=activation).numpy()
    assert pt_kd.depthwise_streamed.LAUNCHES == before
    assert y.shape == y_ref.shape == got.out_shape
    assert _rel(y, y_ref) <= TOL


@pytest.mark.parametrize("compute_dtype", ["float32", "int8"])
def test_plan_apply_matches_reference_executor(compute_dtype):
    """The port's pallas_depthwise ConvPlan end to end (its own bound
    filter) against the reference's winograd plan (the pure-JAX
    winograd_depthwise executor) at the same compute_dtype and tile."""
    shape, k, mult = (2, 21, 18, 24), 3, 1
    x, wt, b = _case(99, shape, k, mult)
    kw = dict(groups=shape[3], compute_dtype=compute_dtype, output_tile=2)
    ref = ref_plan.plan_conv2d(shape, jnp.asarray(wt), algorithm="winograd",
                               **kw)
    got = pt_plan.plan_conv2d(shape, torch.from_numpy(wt),
                              algorithm="pallas_winograd", device="cpu", **kw)
    y_ref = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                 activation="relu"))
    y = got.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                  activation="relu").numpy()
    tol = TOL if compute_dtype == "float32" else TOL_REDUCED
    assert _rel(y, y_ref) <= tol


def test_wrapper_refuses_other_devices():
    """No fallback: a tensor on neither the CPU nor a CUDA card raises."""
    plan = pt_plan.plan_conv2d((1, 8, 8, 8), torch.randn(3, 3, 1, 8),
                               groups=8, algorithm="pallas_winograd",
                               device="cpu")
    s = plan.spec
    xp = pt_ops.pad_streamed_input(torch.zeros(1, 8, 8, 8), s.geometry,
                                   s.stream).to("meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pt_kd.depthwise_streamed(xp, plan.u.to("meta"), None, ct_h=s.ct_h,
                                 ct_w=s.ct_w, bh=s.stream.bh, bw=s.stream.bw,
                                 block_c=s.stream.block_c)


@pytest.mark.parametrize("mult", [1, 2, 3])
def test_depthwise_geometry_ignores_multiplier(mult):
    """The kernel loops over a channel's `mult` outputs in one thread, so
    the multiplier leaves the blocking as it is and scales the output
    channel counts."""
    ct = cook_toom(2, 3)
    one = pt_wg.stream_geometry_depthwise(28, 28, 37, ct, ct)
    got = pt_wg.stream_geometry_depthwise(28, 28, 37, ct, ct, mult=mult)
    assert got._replace(block_m=one.block_m, m_pad=one.m_pad) == one
    assert (got.block_m, got.m_pad) == (one.block_c * mult, one.c_pad * mult)
