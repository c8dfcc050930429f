"""Parity of the PyTorch port's plan-time building blocks with the JAX
package: Cook-Toom transforms, tiling geometry, the executor registry, the
int8 quantizer and the shared CNN layers. Inputs come from seeded numpy and
go to both packages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import im2col as ref_im2col
from repro.core import registry as ref_registry
from repro.core import transforms as ref_transforms
from repro.core import winograd as ref_wg
from repro.models import layers as ref_layers
from repro.optim import compression as ref_comp
from repro_torch.core import im2col as pt_im2col
from repro_torch.core import registry as pt_registry
from repro_torch.core import transforms as pt_transforms
from repro_torch.core import winograd as pt_wg
from repro_torch.models import layers as pt_layers
from repro_torch.optim import compression as pt_comp

#: Every (m, r) pair the registry's executors can plan: the Cook-Toom
#: filter sizes with output tiles 1..6 (default tiles, explicit requests,
#: and the stride-2 phase filters (k+1)//2, which are sizes 2..4).
PAIRS = [(m, r) for r in sorted(ref_registry.WINOGRAD_FILTER_SIZES)
         for m in range(1, 7)]


@pytest.mark.parametrize("m,r", PAIRS)
def test_cook_toom_matrices_equal_reference_exactly(m, r):
    """Exact: both packages derive the matrices in rational arithmetic and
    round once, so every float must be identical."""
    for fn in ("cook_toom", "scaled_cook_toom"):
        a = getattr(pt_transforms, fn)(m, r)
        b = getattr(ref_transforms, fn)(m, r)
        assert (a.m, a.r, a.t) == (b.m, b.r, b.t)
        assert a.bt_rows == b.bt_rows
        assert a.g_rows == b.g_rows
        assert a.at_rows == b.at_rows
    assert pt_transforms.DEFAULT_OUTPUT_TILE == ref_transforms.DEFAULT_OUTPUT_TILE


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("h,w", [(13, 13), (16, 10), (9, 14)])
def test_conv2d_geometry_matches_reference(h, w, padding):
    """Exact: pads, tile counts and output sizes are integer decisions."""
    for m, r in PAIRS:
        if padding == "VALID" and min(h, w) < r:
            continue
        assert pt_wg.conv2d_geometry(h, w, r, r, m, m, padding) == \
            tuple(ref_wg.conv2d_geometry(h, w, r, r, m, m, padding))
        assert pt_im2col.im2row_geometry(h, w, r, r, (1, 1), padding) == \
            tuple(ref_im2col.im2row_geometry(h, w, r, r, (1, 1), padding))


@pytest.mark.parametrize("m,r", [(4, 2), (4, 3), (4, 4), (2, 5), (2, 7),
                                 (6, 3), (1, 7)])
def test_stream_geometry_covers_the_conv_geometry(m, r):
    """The port's stride-1 blocking (stream_geometry_tf32x3) may differ
    from the reference's (it is budgeted for the tensor-core kernel's
    registers and shared memory), but it must cover exactly the tile grid:
    whole blocks, the same tiles, channels padded to its blocks, a
    blocking the kernel takes."""
    ct = pt_transforms.cook_toom(m, r)
    g = pt_wg.conv2d_geometry(37, 23, r, r, m, m, "SAME")
    s = pt_wg.stream_geometry_tf32x3(g.n_h, g.n_w, 3, 5, ct, ct)
    assert s.n_hb * s.bh * m == g.n_h * m + s.pad_h
    assert s.n_wb * s.bw * m == g.n_w * m + s.pad_w
    assert 0 <= s.pad_h < s.bh * m and 0 <= s.pad_w < s.bw * m
    assert s.c_pad % s.block_c == 0 and s.c_pad >= 3
    assert s.block_c == 8                  # C = 3 pays for no wider step
    assert s.m_pad % s.block_m == 0 and s.m_pad >= 5
    assert pt_wg.stream_tc_blocking_fits(ct, ct, s.bh, s.bw, s.block_c,
                                         s.block_m)


def test_stream_geometry_rejects_tiles_past_the_kernel():
    ct = pt_transforms.cook_toom(4, 7)            # t = 10 > 8
    with pytest.raises(ValueError, match="exceeds"):
        pt_wg.stream_geometry_tf32x3(4, 4, 8, 8, ct, ct)


def test_capability_table_equals_reference():
    """Exact: the records are data, so place() and describe() agree."""
    as_tuple = lambda c: dataclasses.astuple(c)   # noqa: E731
    assert [as_tuple(c) for c in pt_registry.CAPABILITIES] == \
        [as_tuple(c) for c in ref_registry.CAPABILITIES]
    assert pt_registry.FAMILIES == ref_registry.FAMILIES


@pytest.mark.parametrize("kh,kw,stride,groups,c_in,c_out", [
    (3, 3, 1, 1, 64, 64), (1, 1, 1, 1, 64, 128), (3, 3, 2, 1, 32, 64),
    (3, 3, 1, 32, 32, 32), (1, 7, 1, 1, 16, 16), (5, 5, 1, 4, 16, 32),
    (6, 6, 1, 1, 8, 8)])
def test_registry_queries_match_reference(kh, kw, stride, groups, c_in, c_out):
    q_pt = pt_registry.as_query(kh, kw, stride, groups=groups, c_in=c_in,
                                c_out=c_out)
    q_ref = ref_registry.as_query(kh, kw, stride, groups=groups, c_in=c_in,
                                  c_out=c_out)
    assert pt_registry.select_auto(q_pt).executor == \
        ref_registry.select_auto(q_ref).executor
    for fam in ref_registry.FAMILIES:
        assert pt_registry.supported(fam, q_pt) == \
            ref_registry.supported(fam, q_ref)
        assert [c.executor for c in pt_registry.matching(q_pt, fam)] == \
            [c.executor for c in ref_registry.matching(q_ref, fam)]
        if ref_registry.supported(fam, q_ref):
            assert pt_registry.resolve(fam, q_pt).executor == \
                ref_registry.resolve(fam, q_ref).executor
        else:
            with pytest.raises(ValueError):
                pt_registry.resolve(fam, q_pt)


@pytest.mark.parametrize("axes", [(-1,), (0, 2), (0, 1, 2)])
def test_quantize_channelwise_equals_reference(axes):
    """Exact: the same fp32 division and round-half-to-even in both, and a
    zero channel keeps scale 1."""
    g = np.random.default_rng(1).standard_normal((6, 5, 7)).astype(np.float32)
    g[:, :, 3] = 0.0
    q_ref, s_ref = ref_comp.quantize_channelwise(jnp.asarray(g), axes)
    q_pt, s_pt = pt_comp.quantize_channelwise(torch.from_numpy(g), axes)
    np.testing.assert_array_equal(q_pt.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s_pt.numpy(), np.asarray(s_ref))
    assert q_pt.dtype == torch.int8


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("k,stride,padding", [(2, 2, "VALID"), (3, 2, "VALID"),
                                              (3, 2, "SAME"), (3, 1, "SAME")])
def test_pool2d_matches_reduce_window(kind, k, stride, padding):
    """1e-6: max is exact; avg sums k*k values in another order."""
    x = np.random.default_rng(2).standard_normal((2, 11, 9, 5)).astype(
        np.float32)
    ref = np.asarray(ref_layers.pool2d(jnp.asarray(x), kind, k, stride,
                                       padding))
    got = pt_layers.pool2d(torch.from_numpy(x), kind, k, stride, padding)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("relu", [True, False])
def test_dense_head_matches_reference(relu):
    """1e-5 relative: one fp32 matmul of depth 4*3*6, summed in another
    order."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 3, 6)).astype(np.float32)
    w = rng.standard_normal((72, 10)).astype(np.float32)
    ref = np.asarray(ref_layers.dense_head(jnp.asarray(x), jnp.asarray(w),
                                           relu))
    got = pt_layers.dense_head(torch.from_numpy(x), torch.from_numpy(w), relu)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_activations_match_reference():
    """1e-6: gelu is the tanh form in both packages."""
    from repro.kernels import runtime as ref_rt
    from repro_torch.kernels import runtime as pt_rt
    x = np.linspace(-8, 8, 401, dtype=np.float32)
    for act in ref_rt.ACTIVATIONS:
        ref = np.asarray(ref_rt.apply_activation(jnp.asarray(x), act))
        got = pt_rt.apply_activation(torch.from_numpy(x), act).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert pt_rt.ACTIVATIONS == ref_rt.ACTIVATIONS


@pytest.mark.parametrize("dim,target,quantum", [
    (1, 128, 8), (7, 128, 8), (9, 128, 8), (128, 128, 8), (300, 128, 8),
    (5, 64, 16), (17, 64, 16)])
def test_pick_block_matches_reference(dim, target, quantum):
    """Exact: an integer rule."""
    from repro.kernels import runtime as ref_rt
    from repro_torch.kernels import runtime as pt_rt
    assert pt_rt.pick_block(dim, target, quantum) == \
        ref_rt.pick_block(dim, target, quantum)


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (1, "VALID"),
                                            (2, "SAME"), (2, "VALID")])
def test_direct_conv2d_matches_reference(stride, padding):
    """1e-5 relative: the test oracle itself, F.conv2d with the reference's
    explicit SAME pads against lax.conv_general_dilated (fp32 sums in
    another order)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 9, 5)).astype(np.float32)
    w = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    ref = np.asarray(ref_im2col.direct_conv2d(
        jnp.asarray(x), jnp.asarray(w), stride=stride, padding=padding))
    got = pt_im2col.direct_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                  stride=stride, padding=padding).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
