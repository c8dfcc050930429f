"""The port's grouped convolutions: the block-diagonal grouped Winograd
executor (`winograd_grouped`) and grouped im2row, against torch's own
grouped conv2d in float64 and against the JAX package's plans on the same
seeded numpy inputs (tests/test_grouped.py:55 and :387 on the port, plus
filter, int8-scale and output parity at every compute dtype).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as ref_plan
from repro_torch.core import plan as pt_plan

#: Output against float64 conv2d, relative max-abs error (the reference's
#: grouped-plan limit): F(4, 3)'s transforms carry entries up to 8.
TOL = 1e-4
#: Port against reference, same compute dtype: the same fp32 transforms
#: and per-group GEMMs summed in another order; bf16 taps are bitwise
#: equal and int8 codes within one step (see TOL_SCALE).
TOL_PARITY = 2e-5
#: int8 plans: the per-output-channel scales agree to fp32 rounding of the
#: same max |G w|, relative.
TOL_SCALE = 1e-6


@pytest.fixture(autouse=True)
def _fresh_port_cache():
    pt_plan.clear_plan_cache()
    yield
    pt_plan.clear_plan_cache()


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _direct(x, w, groups, padding="SAME"):
    xc = torch.from_numpy(np.asarray(x, np.float64)).permute(0, 3, 1, 2)
    wc = torch.from_numpy(np.asarray(w, np.float64)).permute(3, 2, 0, 1)
    kh, kw = w.shape[:2]
    if padding == "SAME":
        xc = torch.nn.functional.pad(
            xc, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    y = torch.nn.functional.conv2d(xc, wc, groups=groups)
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("algorithm,resolved", [
    ("auto", "winograd_grouped"), ("winograd", "winograd_grouped"),
    ("im2col", "im2col")])
@pytest.mark.parametrize("groups", [2, 3, 6])
def test_grouped_plan_matches_direct(algorithm, resolved, groups):
    c, m = 12, 18
    rng = np.random.default_rng(groups)
    x = rng.standard_normal((1, 14, 9, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c // groups, m)) / 3).astype(np.float32)
    p = pt_plan.plan_conv2d(x.shape, torch.from_numpy(w), groups=groups,
                            algorithm=algorithm, device="cpu")
    assert p.algorithm == resolved
    got = p.apply(torch.from_numpy(x)).numpy()
    want = _direct(x, w, groups)
    assert got.shape == want.shape == p.out_shape
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("k,tile", [(3, None), (3, 2), (5, None)])
def test_grouped_winograd_matches_reference(k, tile, padding,
                                            compute_dtype):
    """Spec, domain filter (and int8 codes and scales), describe() and the
    output after bias and activation, against the reference's plan at the
    same compute dtype; ResNeXt's 32 groups of 4 channels, narrowed."""
    groups, c, m = 8, 32, 40
    rng = np.random.default_rng(k * 10 + (tile or 0))
    x = rng.standard_normal((2, 13, 11, c)).astype(np.float32)
    w = (rng.standard_normal((k, k, c // groups, m))
         / np.sqrt(k * k * c / groups)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    kw = dict(groups=groups, padding=padding, algorithm="winograd",
              output_tile=tile, compute_dtype=compute_dtype)
    ref = ref_plan.plan_conv2d(x.shape, jnp.asarray(w), **kw)
    got = pt_plan.plan_conv2d(x.shape, torch.from_numpy(w), device="cpu",
                              **kw)
    assert got.algorithm == ref.spec.algorithm == "winograd_grouped"
    assert got.spec.output_tile == ref.spec.output_tile
    assert tuple(got.spec.geometry) == tuple(ref.spec.geometry)
    assert got.describe() == ref.describe()
    u_ref = np.asarray(ref.u.astype(jnp.float32))
    u_got = got.u.float().numpy()
    assert u_got.shape == u_ref.shape
    if compute_dtype == "int8":
        assert np.max(np.abs(u_got - u_ref)) <= 1
        assert _rel(got.scale.numpy(), np.asarray(ref.scale)) <= TOL_SCALE
    elif compute_dtype == "bfloat16":
        assert np.array_equal(u_got, u_ref)
    else:
        assert _rel(u_got, u_ref) <= 1e-6
    y_ref = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                 activation="relu"))
    y = got.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                  activation="relu").numpy()
    if compute_dtype == "int8" and not np.array_equal(u_got, u_ref):
        # a code one step apart moves the output by at most its scale
        y = pt_plan.ConvPlan(got.spec, torch.from_numpy(np.asarray(
            ref.u)), torch.from_numpy(np.asarray(ref.scale))).apply(
                torch.from_numpy(x), bias=torch.from_numpy(b),
                activation="relu").numpy()
    assert _rel(y, y_ref) <= TOL_PARITY
    if compute_dtype == "float32":
        want = np.maximum(_direct(x, w, groups, padding) + b, 0)
        assert _rel(y, want) < TOL


def test_resnext_stage1_grouped_conv():
    """ResNeXt-50 32x4d's stage-1 grouped 3x3 (128 -> 128, 32 groups), at
    14x14 and batch 1 here (the card runs it at 56x56, batch 4), on both
    grouped executors."""
    rng = np.random.default_rng(50)
    x = rng.standard_normal((1, 14, 14, 128)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 4, 128)) / 6).astype(np.float32)
    want = _direct(x, w, 32)
    for alg, resolved in (("winograd", "winograd_grouped"),
                          ("im2col", "im2col")):
        p = pt_plan.plan_conv2d(x.shape, torch.from_numpy(w), groups=32,
                                algorithm=alg, device="cpu")
        assert p.algorithm == resolved
        assert _rel(p.apply(torch.from_numpy(x)).numpy(), want) < TOL


def test_cache_key_includes_groups():
    """Two plans of the same shapes with different groups must not share a
    spec (a (3, 3, 1, C) depthwise filter is also a valid dense filter
    shape)."""
    rng = np.random.default_rng(0)
    w_dense = torch.from_numpy((rng.standard_normal((3, 3, 8, 8))
                                / 3).astype(np.float32))
    w_dw = torch.from_numpy((rng.standard_normal((3, 3, 1, 8))
                             / 3).astype(np.float32))
    pt_plan.plan_conv2d((1, 12, 12, 8), w_dense, device="cpu")
    p = pt_plan.plan_conv2d((1, 12, 12, 8), w_dw, groups=8, device="cpu")
    assert pt_plan.plan_cache_info()["hits"] == 0
    assert pt_plan.plan_cache_info()["misses"] == 2
    assert p.spec.groups == 8
    p2 = pt_plan.plan_conv2d((1, 12, 12, 8), w_dw, groups=8, device="cpu")
    assert pt_plan.plan_cache_info()["hits"] == 1
    assert p2.spec is p.spec


def test_grouped_plan_round_trips_through_artifact():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 10, 10, 12)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 4, 12)) / 6).astype(
        np.float32))
    p = pt_plan.plan_conv2d(x.shape, w, groups=3, algorithm="winograd",
                            compute_dtype="int8", device="cpu")
    meta, arrays = p.to_artifact()
    p2 = pt_plan.ConvPlan.from_artifact(meta, arrays, device="cpu")
    assert p2.describe() == p.describe()
    assert torch.equal(p2.apply(x), p.apply(x))
