"""The port's rfft2 (FFT) and large-tile F(6, 3) executors
(`plan_conv2d(..., algorithm="fft" / "winograd_f63")`) against torch's own
conv2d in float64 and against the JAX package's plans on the same seeded
numpy inputs: tests/test_fft_f63.py on the port (its race tests are in
tests/test_torch_autotune.py), plus spec, filter and artifact parity.
The property sweeps run through plan_conv2d; the per-call
`ops.fft_conv2d` / `ops.winograd_f63_conv2d` wrappers are held against
the reference's in tests/test_torch_dispatch.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile as ref_compile
from repro.core import fft as ref_fft
from repro.core import plan as ref_plan
from repro.models import cnn as ref_cnn
from repro_torch.core import compile as pt_compile
from repro_torch.core import fft as pt_fft
from repro_torch.core import plan as pt_plan
from repro_torch.core import registry as pt_registry
from repro_torch.core.transforms import (F63_FP32_ERROR_BUDGET, cook_toom,
                                         scaled_cook_toom)
from repro_torch.models import cnn as pt_cnn

try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

#: FFT against float64 conv2d, relative max-abs error: fp32 rfft2 / irfft2
#: of length 8-32 and an fp32 complex channel sum (the reference's limit).
TOL_FFT = 1e-5
#: F(6, 3) against float64 conv2d: the row-scaled t = 8 transforms carry
#: entries up to ~2 after scaling (the reference's limit).
TOL_F63 = 1e-4
#: The port's FFT plan against the reference's: both sides run fp32 FFTs
#: (pocketfft under torch, XLA's under JAX) that round differently, so
#: each is ~1e-7-1e-6 from float64; held to the FFT's own limit.
TOL_FFT_PARITY = 1e-5
#: The port's F(6, 3) plan against the reference's: both sum the same fp32
#: transforms in other orders.
TOL_F63_PARITY = 2e-5
#: The complex64 filter spectra: one fp32 FFT of a zero-padded filter per
#: (C, M), relative to the largest magnitude.
TOL_U_FFT = 1e-6
#: The F(6, 3) domain filter G w, relative to its largest magnitude.
TOL_U_F63 = 1e-6


@pytest.fixture(autouse=True)
def _fresh_port_cache():
    pt_plan.clear_plan_cache()
    yield
    pt_plan.clear_plan_cache()


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _direct(x, w, padding="SAME"):
    """NHWC x HWIO stride-1 conv in float64 through torch's conv2d, with
    SAME's lo = (k - 1) // 2 pad."""
    xc = torch.from_numpy(np.asarray(x, np.float64)).permute(0, 3, 1, 2)
    wc = torch.from_numpy(np.asarray(w, np.float64)).permute(3, 2, 0, 1)
    kh, kw = w.shape[:2]
    if padding == "SAME":
        xc = torch.nn.functional.pad(
            xc, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    return torch.nn.functional.conv2d(xc, wc).permute(0, 2, 3, 1).numpy()


def _case(shape, w_shape, seed, scale=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(w_shape)
         / (scale or w_shape[0])).astype(np.float32)
    return x, w


def _port(x, w, algorithm, **kw):
    p = pt_plan.plan_conv2d(x.shape, torch.from_numpy(w),
                            algorithm=algorithm, device="cpu", **kw)
    return p, p.apply(torch.from_numpy(x), **{
        k: v for k, v in kw.items() if k in ("bias", "activation")})


# ---------------------------------------------------------------------------
# transform construction
# ---------------------------------------------------------------------------

def test_scaled_cook_toom_preserves_bilinear_identity():
    base, sc = cook_toom(6, 3), scaled_cook_toom(6, 3)
    rng = np.random.default_rng(0)
    d, g = rng.standard_normal(base.t), rng.standard_normal(3)
    want = base.AT @ ((base.G @ g) * (base.BT @ d))
    got = sc.AT @ ((sc.G @ g) * (sc.BT @ d))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_scaled_cook_toom_equalizes_bt_row_magnitudes():
    for row in scaled_cook_toom(6, 3).BT:
        amax = np.max(np.abs(row))
        assert 2 ** -0.5 <= amax < 2 ** 0.5 + 1e-12


@pytest.mark.parametrize("h,w,k", [(14, 14, 3), (56, 56, 3), (28, 20, 5),
                                   (17, 13, 7), (224, 224, 3), (7, 7, 5)])
def test_fft_geometry_round_trips_and_matches_reference(h, w, k):
    g = pt_fft.choose_fft_geometry(h, w, k, k)
    assert g.fft_h in pt_fft.FFT_SIZES and g.fft_w in pt_fft.FFT_SIZES
    assert tuple(g) == tuple(ref_fft.choose_fft_geometry(h, w, k, k))
    again = pt_fft.choose_fft_geometry(h, w, k, k, output_tile=(g.m_h, g.m_w))
    assert again == g
    assert pt_fft.FFT_SIZES == ref_fft.FFT_SIZES


# ---------------------------------------------------------------------------
# parity vs float64 conv2d and vs the reference's plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(7, 7), (13, 9), (21, 17), (33, 33)])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_fft_matches_direct_and_reference(h, w, k, padding):
    x, wt = _case((2, h, w, 5), (k, k, 5, 7), seed=h * 100 + w + k)
    p, y = _port(x, wt, "fft", padding=padding)
    want = _direct(x, wt, padding)
    assert y.shape == want.shape == p.out_shape
    assert _rel(y.numpy(), want) < TOL_FFT
    ref = ref_plan.plan_conv2d(x.shape, jnp.asarray(wt), algorithm="fft",
                               padding=padding)
    assert p.spec.output_tile == ref.spec.output_tile
    assert tuple(p.spec.fft) == tuple(ref.spec.fft)
    assert tuple(p.spec.geometry) == tuple(ref.spec.geometry)
    assert p.describe() == ref.describe()
    assert _rel(y.numpy(), np.asarray(ref.apply(jnp.asarray(x)))) \
        < TOL_FFT_PARITY
    u_ref = np.asarray(ref.u)
    assert p.u.dtype == torch.complex64 and str(u_ref.dtype) == "complex64"
    assert _rel(p.u.numpy(), u_ref) < TOL_U_FFT


@pytest.mark.parametrize("h,w", [(7, 7), (13, 9), (21, 17), (33, 33)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_f63_matches_direct_and_reference(h, w, padding):
    x, wt = _case((2, h, w, 5), (3, 3, 5, 7), seed=h * 100 + w)
    p, y = _port(x, wt, "winograd_f63", padding=padding)
    assert p.spec.output_tile == (6, 6)
    want = _direct(x, wt, padding)
    assert y.shape == want.shape
    assert _rel(y.numpy(), want) < TOL_F63
    ref = ref_plan.plan_conv2d(x.shape, jnp.asarray(wt),
                               algorithm="winograd_f63", padding=padding)
    assert tuple(p.spec.geometry) == tuple(ref.spec.geometry)
    for mat in ("G", "BT", "AT"):
        assert np.array_equal(getattr(p.spec.ct_h, mat),
                              getattr(ref.spec.ct_h, mat))
    assert p.describe() == ref.describe()
    assert _rel(y.numpy(), np.asarray(ref.apply(jnp.asarray(x)))) \
        < TOL_F63_PARITY
    assert _rel(p.u.numpy(), np.asarray(ref.u)) < TOL_U_F63


@pytest.mark.parametrize("alg", ["fft", "winograd_f63"])
@pytest.mark.parametrize("activation", ["relu", "gelu", "relu6"])
def test_new_executors_fuse_bias_and_activation(alg, activation):
    x, wt = _case((1, 15, 11, 4), (3, 3, 4, 6), seed=5)
    b = np.random.default_rng(6).standard_normal(6).astype(np.float32)
    p = pt_plan.plan_conv2d(x.shape, torch.from_numpy(wt), algorithm=alg,
                            device="cpu")
    got = p.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                  activation=activation).numpy()
    ref = ref_plan.plan_conv2d(x.shape, jnp.asarray(wt), algorithm=alg)
    want = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                activation=activation))
    assert _rel(got, want) < TOL_F63


if _HAVE_HYPOTHESIS:

    @settings(max_examples=15, deadline=None)
    @given(h=st.integers(5, 24).filter(lambda v: v % 2 == 1),
           w=st.integers(5, 24).filter(lambda v: v % 2 == 1),
           c=st.integers(1, 6), mo=st.integers(1, 6),
           k=st.sampled_from([3, 5]),
           padding=st.sampled_from(["SAME", "VALID"]),
           seed=st.integers(0, 2**31 - 1))
    def test_fft_property_sweep(h, w, c, mo, k, padding, seed):
        x, wt = _case((1, h, w, c), (k, k, c, mo), seed)
        _, y = _port(x, wt, "fft", padding=padding)
        assert _rel(y.numpy(), _direct(x, wt, padding)) < TOL_FFT

    @settings(max_examples=15, deadline=None)
    @given(h=st.integers(5, 24).filter(lambda v: v % 2 == 1),
           w=st.integers(5, 24).filter(lambda v: v % 2 == 1),
           c=st.integers(1, 6), mo=st.integers(1, 6),
           padding=st.sampled_from(["SAME", "VALID"]),
           seed=st.integers(0, 2**31 - 1))
    def test_f63_property_sweep(h, w, c, mo, padding, seed):
        x, wt = _case((1, h, w, c), (3, 3, c, mo), seed)
        _, y = _port(x, wt, "winograd_f63", padding=padding)
        assert _rel(y.numpy(), _direct(x, wt, padding)) < TOL_F63


def test_f63_fp32_error_budget_on_adversarial_filters():
    """Filters with magnitudes 1..1000 stress the wide-range B^T rows of
    large-tile variants; the scaled F(6, 3) set holds the declared fp32
    budget against float64."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 24, 24, 8)).astype(np.float32)
    w = rng.standard_normal((3, 3, 8, 8))
    w = (w * 10.0 ** rng.uniform(0, 3, size=w.shape)).astype(np.float32)
    _, y = _port(x, w, "winograd_f63")
    want = _direct(x, w)
    err = np.max(np.abs(y.numpy() - want)) / np.max(np.abs(want))
    assert err < F63_FP32_ERROR_BUDGET, err


def test_registry_declares_the_new_families():
    for fam in ("winograd_f63", "fft"):
        assert fam in pt_registry.FAMILIES
        q = pt_registry.as_query(3, 3, (1, 1), c_in=8, c_out=8)
        assert pt_registry.supported(fam, q)
        assert not pt_registry.supported(fam,
                                         pt_registry.as_query(3, 3, (2, 2)))
        assert not pt_registry.supported(
            fam, pt_registry.as_query(3, 3, (1, 1), groups=8, c_in=8,
                                      c_out=8))
        assert pt_registry.compute_dtypes_for(fam) == ("float32",)


# ---------------------------------------------------------------------------
# artifacts: the complex64 spectrum round-trips, both verifiers read it
# ---------------------------------------------------------------------------

SPECS = [("c1", 3, 3, 8), ("c2", 5, 5, 8), ("c3", 3, 3, 6)]


@pytest.mark.parametrize("algorithm", ["fft", "winograd_f63"])
def test_network_artifact_round_trips_and_cross_verifies(tmp_path,
                                                         algorithm):
    """A network compiled with algorithm="fft" / "winograd_f63" (5x5 and
    3x3 layers on the FFT, 3x3 on F(6, 3), the rest falling back) saves,
    loads bitwise with no filter transform, and both packages'
    verify_artifact read each other's files."""
    pt_specs = [pt_cnn.Conv(*s) for s in SPECS]
    ref_specs = [ref_cnn.Conv(*s) for s in SPECS]
    params = pt_cnn.init_cnn(torch.Generator().manual_seed(0), pt_specs, 3,
                             res=16, device="cpu")
    net = pt_compile.compile(params, pt_specs, res=16, batch=2,
                             algorithm=algorithm, device="cpu")
    executors = {nid: p.algorithm for nid, p in net.plans.items()}
    assert algorithm in executors.values()
    path = str(tmp_path / "port.npz")
    net.save(path)
    loaded = pt_compile.NetworkPlan.load(path, device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 16, 16, 3)).astype(np.float32))
    assert torch.equal(loaded.apply(x), net.apply(x))
    assert {n: p.describe() for n, p in loaded.plans.items()} == \
        {n: p.describe() for n, p in net.plans.items()}
    ref_params = {k: {kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()}
                  for k, v in params.items()}
    ref_net = ref_compile.compile(ref_params, ref_specs, res=16, batch=2,
                                  algorithm=algorithm)
    assert {n: p.describe() for n, p in ref_net.plans.items()} == \
        {n: p.describe() for n, p in net.plans.items()}
    ref_path = str(tmp_path / "ref.npz")
    ref_net.save(ref_path)
    assert ref_compile.verify_artifact(path) == []
    assert pt_compile.verify_artifact(ref_path) == []
    y_ref = np.asarray(ref_net.apply(jnp.asarray(x.numpy())))
    assert _rel(net.apply(x).numpy(), y_ref) < TOL_FFT_PARITY
