"""Parity of the port's single-axis (1xN / Nx1) Cook-Toom executor with the
JAX package: `plan_conv2d(..., algorithm="winograd")` on a 1xN or Nx1
filter resolves to `winograd_1d` in both packages, and the two plans are
held together on the same seeded numpy inputs -- the spec (tile, transform
set, axis geometry), the (t, C, M) domain filter and its int8 scales,
`out_shape`, `describe()` and the output after bias and activation.

The reference's executor is plain XLA (three einsums around one channel
GEMM), so it runs here as it is.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as ref_plan
from repro_torch.core import plan as pt_plan

#: Output, relative max-abs error (of the reference's max |y|): both sides
#: run the same fp32 transforms and an fp32 channel GEMM, summed in another
#: order; F(2, 7)'s transforms carry entries up to 64 (as in
#: tests/test_torch_winograd.py). bf16 / int8 filters widen to fp32
#: identically on both sides (bf16 values and int8 codes are exact in fp32),
#: so they hold the same bound.
TOL = 2e-5
#: The fp32 domain filter G w: one (t x k) . (k x C*M) product, rounded
#: once per entry in another order.
TOL_U = 1e-6

FILTERS = [(1, 7), (7, 1), (1, 3), (3, 1)]
DTYPES = ["float32", "bfloat16", "int8"]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _case(kh, kw, padding, seed):
    """Odd H, W, C and M; the filter axis long enough for VALID."""
    rng = np.random.default_rng(seed)
    c, m = 5, 11
    x = rng.standard_normal((2, 13, 9, c)).astype(np.float32)
    wt = (rng.standard_normal((kh, kw, c, m))
          / np.sqrt(kh * kw * c)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    return x, wt, b


def _plans(x, wt, padding, cd, algorithm="winograd"):
    ref = ref_plan.plan_conv2d(x.shape, jnp.asarray(wt), padding=padding,
                               algorithm=algorithm, compute_dtype=cd)
    got = pt_plan.plan_conv2d(x.shape, torch.from_numpy(wt), padding=padding,
                              algorithm=algorithm, compute_dtype=cd,
                              device="cpu")
    return ref, got


def test_winograd_1d_is_ported():
    """Every executor the registry declares, winograd_1d among them,
    builds a spec on the CPU; a 1xN layer resolves to winograd_1d under
    each family whose capability declares it."""
    from test_torch_package import registry_executors_build_on_cpu
    from repro_torch.core import registry as pt_registry
    assert not hasattr(pt_plan, "NOT_PORTED")
    built = registry_executors_build_on_cpu()
    assert "winograd_1d" in built
    assert built == {c.executor for c in pt_registry.CAPABILITIES}
    for fam in ("winograd", "pallas_winograd",
                "pallas_winograd_materialized"):
        p = pt_plan.plan_conv2d((1, 12, 12, 8), torch.zeros(1, 7, 8, 8),
                                algorithm=fam, device="cpu")
        assert p.algorithm == "winograd_1d"


@pytest.mark.parametrize("cd", DTYPES)
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("kh,kw", FILTERS)
def test_spec_filter_and_output_match_reference(kh, kw, padding, cd):
    x, wt, b = _case(kh, kw, padding, seed=kh * 10 + kw)
    ref, got = _plans(x, wt, padding, cd)
    rs, gs = ref.spec, got.spec
    assert gs.algorithm == rs.algorithm == "winograd_1d"
    assert gs.output_tile == rs.output_tile
    assert tuple(gs.geometry) == tuple(rs.geometry)
    assert gs.geometry.axis == rs.axis == (1 if kh > 1 else 2)
    for mat in ("G", "BT", "AT"):
        assert np.array_equal(getattr(gs.ct_w, mat), getattr(rs.ct_w, mat))
    assert got.out_shape == ref.out_shape
    assert got.describe() == ref.describe()

    # the (t, C, M) domain filter, at its stored dtype
    u_ref = np.asarray(ref.u.astype(jnp.float32))
    u_got = got.u.float().numpy()
    assert u_got.shape == u_ref.shape == (rs.ct_w.t, x.shape[3],
                                          wt.shape[3])
    assert str(got.u.dtype).removeprefix("torch.") == str(ref.u.dtype)
    if cd == "float32":
        assert _rel(u_got, u_ref) <= TOL_U
    elif cd == "bfloat16":
        assert np.array_equal(u_got, u_ref)
    else:
        assert np.array_equal(u_got, u_ref)
        assert got.scale.shape == (wt.shape[3],)
        assert np.allclose(got.scale.numpy(), np.asarray(ref.scale),
                           rtol=1e-6, atol=0)

    y_ref = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                 activation="relu6"))
    y_got = got.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                      activation="relu6").numpy()
    assert y_got.shape == y_ref.shape == got.out_shape
    assert np.isfinite(y_got).all()
    assert _rel(y_got, y_ref) <= TOL


@pytest.mark.parametrize("algorithm", ["pallas_winograd",
                                       "pallas_winograd_materialized"])
@pytest.mark.parametrize("kh,kw", FILTERS)
def test_streamed_families_route_1xn_to_winograd_1d(kh, kw, algorithm):
    """The streamed families declare winograd_1d for 1xN / Nx1 layers, as
    in the reference: the same executor, tile and describe() row."""
    x, wt, b = _case(kh, kw, "SAME", seed=3)
    ref, got = _plans(x, wt, "SAME", "float32", algorithm=algorithm)
    assert got.spec.algorithm == ref.spec.algorithm == "winograd_1d"
    assert got.describe() == ref.describe()
    y_ref = np.asarray(ref.apply(jnp.asarray(x), bias=jnp.asarray(b),
                                 activation="relu"))
    y_got = got.apply(torch.from_numpy(x), bias=torch.from_numpy(b),
                      activation="relu").numpy()
    assert _rel(y_got, y_ref) <= TOL


@pytest.mark.parametrize("kh,kw", [(1, 7), (3, 1)])
def test_nchw_layout(kh, kw):
    """An NCHW plan transposes once at plan time and around apply."""
    x, wt, b = _case(kh, kw, "SAME", seed=5)
    xs, ws = x.transpose(0, 3, 1, 2), wt.transpose(3, 2, 0, 1)
    ref = ref_plan.plan_conv2d(xs.shape, jnp.asarray(ws), algorithm="winograd",
                               data_format="NCHW")
    got = pt_plan.plan_conv2d(xs.shape, torch.from_numpy(ws),
                              algorithm="winograd", data_format="NCHW",
                              device="cpu")
    y_ref = np.asarray(ref.apply(jnp.asarray(xs)))
    y_got = got.apply(torch.from_numpy(xs)).numpy()
    assert got.out_shape == ref.out_shape == y_got.shape
    assert _rel(y_got, y_ref) <= TOL
