"""Parity of the port's separable and inverted-residual plans with the JAX
package: the fused `separable_streamed` plan's decisions and operands, its
applied result on the CPU (the kernel's plain version), the composed
stride-2 block (`pallas_depthwise_strided` + `pallas_im2col`), and
`InvertedResidualPlan` with and without its expand conv and residual.

The oracle for applied results is the reference's `algorithm="winograd"`
plan of the same block, which composes its pure-JAX executors: the
reference's fused Pallas kernel does not run under the installed JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as ref_plan
from repro_torch.core import plan as pt_plan
from repro_torch.core import winograd as pt_wg

#: fp32 on both sides, sums in another order (the fused block sums the
#: pointwise GEMM in one order, the reference's im2col matmul in another):
#: 1e-5 of the reference's max |y|.
TOL = 1e-5
#: bf16 filters: both sides round the same transformed filters to bf16,
#: but the reference's bf16 `im2col` pointwise conv also rounds its input
#: activations to bf16 (2^-9 relative), which the port's GEMM kernel does
#: not.
TOL_BF16 = 1e-2


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@pytest.fixture(autouse=True)
def _no_measure(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_NO_MEASURE", "1")


def _block(rng, n, h, w, c, m, k=3, mult=1):
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    w_dw = (rng.standard_normal((k, k, 1, c * mult)) / k).astype(np.float32)
    w_pw = (rng.standard_normal((1, 1, c * mult, m))
            / np.sqrt(c)).astype(np.float32)
    b_dw = rng.standard_normal(c * mult).astype(np.float32)
    b_pw = rng.standard_normal(m).astype(np.float32)
    return x, w_dw, w_pw, b_dw, b_pw


@pytest.mark.parametrize("k,h,c,m", [(3, 112, 32, 64), (3, 14, 512, 512),
                                     (3, 7, 1024, 1024), (5, 17, 9, 20),
                                     (7, 12, 6, 5)])
def test_fused_plan_matches_reference(k, h, c, m):
    """The same mode, tile, geometry and output shape; the cropped
    depthwise taps (P, C) and pointwise matrix (C, M)."""
    rng = np.random.default_rng(k + h + c)
    x_shape = (2, h, h + 1, c)
    _, w_dw, w_pw, _, _ = _block(rng, 1, 1, 1, c, m, k)
    ref = ref_plan.plan_separable_block(x_shape, jnp.asarray(w_dw),
                                        jnp.asarray(w_pw),
                                        algorithm="pallas_winograd")
    got = pt_plan.plan_separable_block(x_shape, torch.from_numpy(w_dw),
                                       torch.from_numpy(w_pw),
                                       algorithm="pallas_winograd",
                                       device="cpu")
    assert got.mode == ref.mode == "fused_pallas"
    assert got.spec.output_tile == ref.spec.output_tile
    assert got.spec.geometry == tuple(ref.spec.geometry)
    assert got.out_shape == ref.out_shape
    assert got.describe() == ref.describe()
    u_ref = np.asarray(ref.u_dw)[:, :c]
    np.testing.assert_allclose(got.u_dw.numpy()[:, :c], u_ref, rtol=0,
                               atol=1e-6 * np.abs(u_ref).max())
    np.testing.assert_array_equal(got.u_pw.numpy()[:c, :m],
                                  np.asarray(ref.u_pw)[:c, :m])
    s = got.spec.stream
    assert not got.u_dw[:, c:].any() and not got.u_pw[c:].any()
    assert got.u_pw.shape == (s.c_pad, s.m_pad)
    assert pt_wg.separable_blocking_fits(got.spec.ct_h, got.spec.ct_w, s.bh,
                                         s.bw, s.block_c, s.block_m)
    assert s.block_m >= min(m, 64)
    assert s.m_pad // s.block_m <= (1 if m <= 128 else -(-m // 64))


@pytest.mark.parametrize("acts", [("relu", "relu"), ("relu6", "relu6"),
                                  ("relu6", "none"), ("none", "relu")])
def test_fused_block_matches_reference_composed(acts):
    """The fused block's applied result against the reference's composed
    winograd block, with the activations MobileNet-v1 (relu, relu) and v2
    (relu6, none) use."""
    rng = np.random.default_rng(len(acts[0]) + 3 * len(acts[1]))
    x, w_dw, w_pw, b_dw, b_pw = _block(rng, 2, 19, 14, 21, 37)
    ref = ref_plan.plan_separable_block(x.shape, jnp.asarray(w_dw),
                                        jnp.asarray(w_pw),
                                        algorithm="winograd")
    got = pt_plan.plan_separable_block(x.shape, torch.from_numpy(w_dw),
                                       torch.from_numpy(w_pw),
                                       algorithm="pallas_winograd",
                                       device="cpu")
    assert got.mode == "fused_pallas" and ref.mode == "composed"
    y_ref = np.asarray(ref.apply(jnp.asarray(x), bias_dw=jnp.asarray(b_dw),
                                 bias_pw=jnp.asarray(b_pw),
                                 inner_activation=acts[0],
                                 activation=acts[1]))
    y = got.apply(torch.from_numpy(x), bias_dw=torch.from_numpy(b_dw),
                  bias_pw=torch.from_numpy(b_pw), inner_activation=acts[0],
                  activation=acts[1]).numpy()
    assert y.shape == y_ref.shape == got.out_shape
    assert _rel(y, y_ref) <= TOL


@pytest.mark.parametrize("algorithm,executor", [
    ("pallas_winograd", "pallas_depthwise_strided+pallas_im2col"),
    ("winograd", "winograd_strided+im2col")])
def test_strided_block_composes_like_reference(algorithm, executor):
    """A stride-2 block composes the strided depthwise plan with a
    pointwise plan, as in the reference; applied against the reference's
    winograd block."""
    rng = np.random.default_rng(7)
    x, w_dw, w_pw, b_dw, b_pw = _block(rng, 2, 23, 20, 24, 40)
    kw = dict(stride=2, algorithm=algorithm)
    ref = ref_plan.plan_separable_block(x.shape, jnp.asarray(w_dw),
                                        jnp.asarray(w_pw), **kw)
    got = pt_plan.plan_separable_block(x.shape, torch.from_numpy(w_dw),
                                       torch.from_numpy(w_pw), device="cpu",
                                       **kw)
    assert got.describe() == ref.describe()
    assert got.describe()["executor"] == executor
    oracle = ref_plan.plan_separable_block(x.shape, jnp.asarray(w_dw),
                                           jnp.asarray(w_pw), stride=2,
                                           algorithm="winograd")
    y_ref = np.asarray(oracle.apply(jnp.asarray(x),
                                    bias_dw=jnp.asarray(b_dw),
                                    bias_pw=jnp.asarray(b_pw)))
    y = got.apply(torch.from_numpy(x), bias_dw=torch.from_numpy(b_dw),
                  bias_pw=torch.from_numpy(b_pw)).numpy()
    assert y.shape == y_ref.shape == got.out_shape
    assert _rel(y, y_ref) <= TOL


def test_reduced_precision_block_composes():
    """The fused kernel is fp32-only: a bf16 block composes, as in the
    reference, onto the stride-1 depthwise kernel and the GEMM kernel, with
    the reference's decisions, and applies (the kernels' plain versions)
    within bf16 rounding of the reference's composed winograd block."""
    rng = np.random.default_rng(8)
    x, w_dw, w_pw, b_dw, b_pw = _block(rng, 1, 9, 9, 8, 8)
    kw = dict(algorithm="pallas_winograd", compute_dtype="bfloat16")
    ref = ref_plan.plan_separable_block(x.shape, jnp.asarray(w_dw),
                                        jnp.asarray(w_pw), **kw)
    assert ref.mode == "composed"
    assert ref.describe()["executor"] == "pallas_depthwise+pallas_im2col"
    got = pt_plan.plan_separable_block(x.shape, torch.from_numpy(w_dw),
                                       torch.from_numpy(w_pw), device="cpu",
                                       **kw)
    assert got.mode == "composed"
    assert got.describe() == ref.describe()
    oracle = ref_plan.plan_separable_block(
        x.shape, jnp.asarray(w_dw), jnp.asarray(w_pw), algorithm="winograd",
        compute_dtype="bfloat16")
    y_ref = np.asarray(oracle.apply(jnp.asarray(x), bias_dw=jnp.asarray(b_dw),
                                    bias_pw=jnp.asarray(b_pw)))
    y = got.apply(torch.from_numpy(x), bias_dw=torch.from_numpy(b_dw),
                  bias_pw=torch.from_numpy(b_pw)).numpy()
    assert _rel(y, y_ref) <= TOL_BF16


@pytest.mark.parametrize("expand,c_in,c_out,stride", [
    (6, 16, 16, 1),       # expand + residual
    (6, 16, 24, 1),       # expand, no residual (C changes)
    (1, 32, 16, 1),       # no expand (MobileNet-v2's first block)
    (6, 24, 32, 2),       # expand, stride 2: composed strided block
])
def test_inverted_residual_matches_reference(expand, c_in, c_out, stride):
    rng = np.random.default_rng(expand + c_in + c_out + stride)
    ce = c_in * expand
    x = rng.standard_normal((2, 15, 12, c_in)).astype(np.float32)
    w_exp = (None if expand == 1 else (rng.standard_normal((1, 1, c_in, ce))
                                       / np.sqrt(c_in)).astype(np.float32))
    _, w_dw, w_pw, b_dw, b_pw = _block(rng, 1, 1, 1, ce, c_out)
    b_exp = rng.standard_normal(ce).astype(np.float32)

    def ref_plan_of(algorithm):
        return ref_plan.plan_inverted_residual(
            x.shape, None if w_exp is None else jnp.asarray(w_exp),
            jnp.asarray(w_dw), jnp.asarray(w_pw), stride=stride,
            algorithm=algorithm)

    got = pt_plan.plan_inverted_residual(
        x.shape, None if w_exp is None else torch.from_numpy(w_exp),
        torch.from_numpy(w_dw), torch.from_numpy(w_pw), stride=stride,
        algorithm="pallas_winograd", device="cpu")
    ref = ref_plan_of("pallas_winograd")
    assert got.describe() == ref.describe()
    assert got.residual == ref.residual == (stride == 1 and c_in == c_out)
    assert got.out_shape == ref.out_shape
    oracle = ref_plan_of("winograd")
    biases = dict(bias_exp=b_exp, bias_dw=b_dw, bias_pw=b_pw)
    y_ref = np.asarray(oracle.apply(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in biases.items()}))
    y = got.apply(torch.from_numpy(x),
                  **{k: torch.from_numpy(v) for k, v in biases.items()}
                  ).numpy()
    assert y.shape == y_ref.shape
    assert _rel(y, y_ref) <= TOL


def test_separable_plans_move_with_to():
    rng = np.random.default_rng(9)
    _, w_dw, w_pw, _, _ = _block(rng, 1, 1, 1, 8, 8)
    plan = pt_plan.plan_inverted_residual(
        (1, 8, 8, 8), None, torch.from_numpy(w_dw), torch.from_numpy(w_pw),
        algorithm="pallas_winograd", device="cpu")
    names = dict(plan.named_buffers())
    assert set(names) == {"sep.u_dw", "sep.u_pw"}
    assert plan.to(torch.float64).sep.u_pw.dtype == torch.float64
