"""Parity of the port's depthwise causal Cook-Toom conv1d with the JAX
package: the plain version of the `conv1d_ct_fused` kernel (which the
wrapper runs on the CPU) against the reference's Pallas kernel in
interpret mode and its pure-jnp oracle (kernels/ref.py), and both backends
of `plan_depthwise_conv1d` and the unplanned `ops.ct_depthwise_causal_conv1d`
against the reference's, with a direct causal conv as the common oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import plan as ref_plan
from repro.core.transforms import cook_toom as ref_cook_toom
from repro.kernels import conv1d_ct as ref_k
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.core import plan as pt_plan
from repro_torch.core import winograd as pt_wg
from repro_torch.core.transforms import cook_toom
from repro_torch.kernels import conv1d_ct as pt_k
from repro_torch.kernels import ops as pt_ops

#: fp32: the same exact transforms and fp32 products on both sides, summed
#: in another order: 1e-5 of the reference's max |y|.
TOL = 1e-5
#: bf16 tiles: both sides compute in fp32 and round the output once to
#: bf16; a sum landing on a rounding boundary may round the other way, one
#: bf16 step (2^-8 relative).
TOL_BF16 = 1e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _direct(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Causal depthwise conv in float64: y[l] = sum_k w[k] x[l - r + 1 + k]."""
    r = w.shape[0]
    xp = np.pad(x.astype(np.float64), ((0, 0), (r - 1, 0), (0, 0)))
    return sum(xp[:, k:k + x.shape[1]] * w[k] for k in range(r))


def _case(seed, b, length, c, r):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, length, c)).astype(np.float32)
    w = (rng.standard_normal((r, c)) / r).astype(np.float32)
    return x, w


@pytest.mark.parametrize("mt,r", [(2, 2), (2, 3), (4, 3), (2, 4), (4, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kernel_matches_reference_kernel(mt, r, dtype):
    """conv1d_ct_fused_plain against the reference's Pallas kernel in
    interpret mode and its jnp oracle, on the same tiles and taps."""
    rng = np.random.default_rng(10 * mt + r)
    ct = cook_toom(mt, r)
    b, s, c = 2, 32, 256
    tiles = rng.standard_normal((b, s, ct.t, c)).astype(np.float32)
    u = rng.standard_normal((ct.t, c)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jt = jnp.asarray(tiles, jdt)
    rct = ref_cook_toom(mt, r)
    want_k = ref_k.conv1d_ct_fused(jt, jnp.asarray(u), ct=rct, block_s=16,
                                   block_c=128, interpret=True)
    want_o = ref_ref.conv1d_ct_fused(jt, jnp.asarray(u), ct=rct)
    tt = torch.tensor(tiles).to(getattr(torch, dtype))
    got = pt_k.conv1d_ct_fused(tt, torch.tensor(u), ct=ct, block_s=2,
                               block_c=128)
    assert got.dtype == tt.dtype and got.shape == (b, s, ct.m, c)
    tol = TOL if dtype == "float32" else TOL_BF16
    got = got.float().numpy()
    assert _rel(got, want_k.astype(jnp.float32)) <= tol
    assert _rel(got, want_o.astype(jnp.float32)) <= tol


def test_kernel_wrapper_counts_no_launch_on_cpu():
    ct = cook_toom(4, 4)
    before = pt_k.conv1d_ct_fused.LAUNCHES
    y = pt_k.conv1d_ct_fused(torch.ones(1, 3, ct.t, 128),
                             torch.ones(ct.t, 128), ct=ct)
    assert y.shape == (1, 3, 4, 128)
    assert pt_k.conv1d_ct_fused.LAUNCHES == before


@pytest.mark.parametrize("r", [2, 3, 4])
@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("mt,length,c", [(4, 37, 200), (2, 45, 70),
                                         (4, 2045, 136)])
def test_plan_matches_reference_plan(r, backend, mt, length, c):
    """Both backends of the planned conv, L not a multiple of m and C not a
    multiple of 128: the same spec decisions and taps as the reference's
    plan, and the same output (the reference's "pallas" plan runs its
    kernel in interpret mode)."""
    x, w = _case(r * 100 + length, 2, length, c, r)
    ref = ref_plan.plan_depthwise_conv1d(x.shape, jnp.asarray(w),
                                         output_tile=mt, backend=backend)
    plan = pt_plan.plan_depthwise_conv1d(x.shape, torch.tensor(w),
                                         output_tile=mt, backend=backend,
                                         device="cpu")
    s, rs = plan.spec, ref.spec
    assert (s.ct.m, s.ct.r, s.n_tiles, s.pad_hi, s.dtype) == \
        (rs.ct.m, rs.ct.r, rs.n_tiles, rs.pad_hi, rs.dtype)
    assert plan.describe() == ref.describe()
    assert _rel(plan.u[:, :c].numpy(), np.asarray(ref.u)[:, :c]) <= 1e-6
    if backend == "pallas":
        assert plan.u.shape[1] % s.blocks[1] == 0
        assert not plan.u[:, c:].any()
    got = plan.apply(torch.tensor(x)).numpy()
    want = np.asarray(ref.apply(jnp.asarray(x)))
    assert got.shape == want.shape == x.shape
    assert _rel(got, want) <= TOL
    assert _rel(got, _direct(x, w)) <= TOL


@pytest.mark.parametrize("r,mt", [(2, 2), (3, 4), (4, 4)])
def test_unplanned_ops_matches_reference(r, mt):
    x, w = _case(7 + r, 3, 29, 200, r)
    want = np.asarray(ref_ops.ct_depthwise_causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), output_tile=mt, interpret=True))
    got = pt_ops.ct_depthwise_causal_conv1d(torch.tensor(x), torch.tensor(w),
                                            output_tile=mt).numpy()
    assert _rel(got, want) <= TOL
    got_core = pt_wg.ct_depthwise_causal_conv1d(
        torch.tensor(x), torch.tensor(w), output_tile=mt).numpy()
    assert _rel(got_core, want) <= TOL


def test_plan_matches_torch_conv1d():
    """The planned conv is F.conv1d(groups=C) with a causal left pad, at
    the falcon-mamba short-conv tile (F(4, 4)) on a narrow shape."""
    x, w = _case(3, 2, 300, 64, 4)
    plan = pt_plan.plan_depthwise_conv1d(x.shape, torch.tensor(w),
                                         backend="pallas", device="cpu")
    xt = torch.tensor(x).permute(0, 2, 1)
    want = F.conv1d(F.pad(xt, (3, 0)), torch.tensor(w).t()[:, None, :],
                    groups=64).permute(0, 2, 1)
    assert _rel(plan.apply(torch.tensor(x)).numpy(), want.numpy()) <= TOL


def test_plan_rejects_bad_shapes():
    with pytest.raises(ValueError, match=r"\(B, L, C\) x \(r, C\)"):
        pt_plan.plan_depthwise_conv1d((2, 10, 8), torch.zeros(4, 9),
                                      device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        pt_plan.plan_depthwise_conv1d((2, 10, 8), torch.zeros(4, 8),
                                      backend="cuda", device="cpu")
    plan = pt_plan.plan_depthwise_conv1d((2, 10, 8), torch.zeros(4, 8),
                                         device="cpu")
    with pytest.raises(ValueError, match="L/C must match"):
        plan.apply(torch.zeros(2, 11, 8))
