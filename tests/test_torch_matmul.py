"""Parity of the port's `pallas_im2col` executor (kernels/ops.py ->
kernels/matmul.py, the GEMM kernel's plain version on the CPU) with the JAX
package. Here the oracle IS the reference's own `pallas_im2col` plan: its
Pallas `matmul` kernel runs in interpret mode under the installed JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as ref_plan
from repro_torch.core import im2col as pt_im2col
from repro_torch.core import plan as pt_plan
from repro_torch.kernels import matmul as pt_mm
from repro_torch.kernels import ops as pt_ops

#: Both sides widen B to fp32 exactly (bf16 values and int8 codes are exact
#: in fp32) and sum K in fp32, in another order: 1e-5 of max |y|.
TOL = 1e-5
CASES = [((2, 9, 7, 13), 1, 1, 24), ((2, 8, 11, 5), 3, 1, 17),
         ((1, 12, 9, 6), 3, 2, 70)]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@pytest.fixture(autouse=True)
def _no_measure(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_NO_MEASURE", "1")


def _plans(x_shape, k, stride, m, compute_dtype, seed):
    rng = np.random.default_rng(seed)
    wt = (rng.standard_normal((k, k, x_shape[3], m))
          / k).astype(np.float32)
    kw = dict(stride=stride, algorithm="pallas_im2col",
              compute_dtype=compute_dtype)
    ref = ref_plan.plan_conv2d(x_shape, jnp.asarray(wt), **kw)
    got = pt_plan.plan_conv2d(x_shape, torch.from_numpy(wt), device="cpu",
                              **kw)
    return rng, ref, got


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("x_shape,k,stride,m", CASES)
def test_im2col_plan_matches_reference(x_shape, k, stride, m, compute_dtype):
    """Exact: geometry, output shape, the cropped (khkwC, M) filter matrix
    and, for int8, its scales (no transform, so nothing rounds)."""
    _, ref, got = _plans(x_shape, k, stride, m, compute_dtype, k + m)
    assert got.spec.algorithm == ref.spec.algorithm == "pallas_im2col"
    assert got.spec.geometry == tuple(ref.spec.geometry)
    assert got.out_shape == ref.out_shape
    assert got.describe() == ref.describe()
    kk = k * k * x_shape[3]
    np.testing.assert_array_equal(
        got.u.float().numpy()[:kk, :m],
        np.asarray(ref.u.astype(jnp.float32))[:kk, :m])
    bm, bk, bn, _ = got.spec.blocks
    assert got.u.shape[0] % bk == 0 and got.u.shape[1] % bn == 0
    assert not got.u[kk:].float().any() and not got.u[:, m:].float().any()
    if compute_dtype == "int8":
        np.testing.assert_array_equal(got.scale.numpy()[0, :m],
                                      np.asarray(ref.scale)[0, :m])


@pytest.mark.parametrize("act", ["none", "relu", "relu6", "gelu"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
def test_im2col_executor_matches_reference(compute_dtype, act):
    """ConvPlan.apply of pallas_im2col against the reference's, whose
    Pallas matmul runs in interpret mode here; a 1x1 (the MobileNet
    pointwise conv) and a stride-2 3x3."""
    for i, (x_shape, k, stride, m) in enumerate(CASES[::2]):
        rng, ref, got = _plans(x_shape, k, stride, m, compute_dtype,
                               7 * i + len(act))
        x = rng.standard_normal(x_shape).astype(np.float32)
        b = rng.standard_normal(m).astype(np.float32)
        y_ref = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                     activation=act))
        y = got.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                      activation=act).numpy()
        assert y.shape == y_ref.shape == got.out_shape
        assert _rel(y, y_ref) <= TOL


@pytest.mark.parametrize("mm,kk,nn", [(1, 1, 1), (67, 19, 70), (130, 64, 128)])
def test_matmul_plain_version_matches_numpy(mm, kk, nn):
    """The GEMM wrapper on the CPU: ragged M / K / N against float64 numpy,
    B padded by the plan's rule for the chooser's tile, no bias / scale."""
    rng = np.random.default_rng(mm + kk + nn)
    a = rng.standard_normal((mm, kk)).astype(np.float32)
    b = rng.standard_normal((kk, nn)).astype(np.float32)
    bm, _, bn, splits = pt_im2col.matmul_blocks(mm, kk, nn)
    bp = pt_ops.pad_im2col_filter(torch.from_numpy(b), bn)
    assert tuple(bp.shape) == pt_im2col.matmul_b_shape(kk, nn, bn)
    before = pt_mm.matmul.LAUNCHES
    y = pt_mm.matmul(torch.from_numpy(a), bp, n_out=nn, block_m=bm,
                     block_n=bn, splits=splits).numpy()
    assert pt_mm.matmul.LAUNCHES == before          # CPU: no kernel
    want = a.astype(np.float64) @ b.astype(np.float64)
    assert y.shape == (mm, nn)
    assert _rel(y, want) <= TOL


def test_matmul_rejects_mismatched_operands():
    a, b = torch.zeros(4, 20), torch.zeros(16, 64)
    tile = dict(block_m=64, block_n=64)
    with pytest.raises(ValueError, match="do not match"):
        pt_mm.matmul(a, b, n_out=8, **tile)
    with pytest.raises(ValueError, match="activation"):
        pt_mm.matmul(a[:, :16], b, n_out=8, activation="swish", **tile)
