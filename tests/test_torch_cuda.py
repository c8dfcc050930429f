"""The CUDA kernels against their plain versions, on the card. Each test
skips without a CUDA device; on the card run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports JAX, which that machine lacks.)
"""

import contextlib
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import im2col as pt_im2col
from repro_torch.core import plan as pt_plan
from repro_torch.core import winograd as pt_wg
from repro_torch.kernels import depthwise as kd
from repro_torch.kernels import matmul as km
from repro_torch.kernels import ops
from repro_torch.kernels import winograd as kw

#: Relative max-abs error (of max |plain|): fp32 transforms and FMAs on
#: both sides, sums taken in another order.
TOL = 2e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _padded(x, geometry, ct_h, ct_w, bh, bw, c_pad):
    """x with the conv padding, edge strips to whole (bh, bw) tile blocks
    and C to c_pad: the streamed kernels' input under any blocking."""
    n_hb, n_wb = -(-geometry.n_h // bh), -(-geometry.n_w // bw)
    return torch.nn.functional.pad(x, (
        0, c_pad - x.shape[3], geometry.lo_w,
        geometry.hi_w + (n_wb * bw - geometry.n_w) * ct_w.m, geometry.lo_h,
        geometry.hi_h + (n_hb * bh - geometry.n_h) * ct_h.m))


def _pad_to(t, dims):
    """t zero-padded at the end of each axis to `dims`."""
    pads = []
    for size, want in reversed(list(zip(t.shape, dims))):
        pads += [0, want - size]
    return torch.nn.functional.pad(t, pads).contiguous()


def _tc_blockings(ct_h, ct_w, u_size, phases=1):
    """Every (bh, bw, block_c, block_m) of the streamed kernel's menu for
    these tiles at `phases` (1 the stride-1 kernel, 4 the stride-2 one):
    the menu of the body that runs them (stream_body), at two strip shapes
    each."""
    if pt_wg.stream_body(ct_h, ct_w, phases) == "ws":
        menu = pt_wg.WINOGRAD_WS_CONFIGS[pt_wg.winograd_ws_tile(ct_h.t,
                                                                ct_w.t)]
    else:
        menu = pt_wg.WINOGRAD_TC_CONFIGS[pt_wg.winograd_tc_tile(ct_h.t,
                                                                ct_w.t)]
    for kmt, knt in menu:
        br = 16 * kmt
        for bc in pt_wg.WINOGRAD_TC_BLOCK_C:
            for bh in sorted({4, br // 4}):
                if pt_wg.stream_blocking_fits(ct_h, ct_w, bh, br // bh, bc,
                                              8 * knt, u_size, phases):
                    yield bh, br // bh, bc, 8 * knt


@pytest.mark.parametrize("k,compute_dtype,tile", [
    (2, "float32", None), (3, "float32", None), (4, "float32", None),
    (5, "float32", None), (7, "float32", None), (3, "float32", 6),
    (3, "bfloat16", None), (3, "int8", None), (3, "bfloat16", 4),
    (3, "int8", 4), (3, "float32", 2), (5, "int8", None)])
def test_kernel_matches_plain_version(cuda, k, compute_dtype, tile):
    """The plan's own blocking, then every blocking of the kernel's menu
    for the tile (C 13: a ragged last C step of every size; M 40: not a
    multiple of 16), each against the plain version and launched twice,
    bitwise equal."""
    g = torch.Generator().manual_seed(k)
    n, h, w, c, m = 2, 23, 17, 13, 40
    x = torch.randn(n, h, w, c, generator=g).to(cuda)
    wt = (torch.randn(k, k, c, m, generator=g) / (k * k * c) ** 0.5).to(cuda)
    bias = torch.randn(m, generator=g).to(cuda)
    plan = pt_plan.plan_conv2d((n, h, w, c), wt, algorithm="pallas_winograd",
                               compute_dtype=compute_dtype, output_tile=tile,
                               device=cuda)
    s, sp = plan.spec.stream, plan.spec
    u = plan.u[:, :c, :m]
    scale = None if plan.scale is None else plan.scale[:, :m]
    blockings = [(s.bh, s.bw, s.block_c, s.block_m)] + list(
        _tc_blockings(sp.ct_h, sp.ct_w, plan.u.element_size()))
    for bh, bw, bc, bm in blockings:
        c_pad, m_pad = -(-c // bc) * bc, -(-m // bm) * bm
        xp = _padded(x, sp.geometry, sp.ct_h, sp.ct_w, bh, bw, c_pad)
        ub = _pad_to(u, (u.shape[0], c_pad, m_pad))
        sb = None if scale is None else torch.nn.functional.pad(
            scale, (0, m_pad - m), value=1.0).contiguous()
        args = dict(ct_h=sp.ct_h, ct_w=sp.ct_w, bh=bh, bw=bw,
                    activation="gelu")
        before = kw.winograd_streamed.LAUNCHES
        got = kw.winograd_streamed(xp, ub, bias, sb, block_c=bc,
                                   block_m=bm, **args)
        again = kw.winograd_streamed(xp, ub, bias, sb, block_c=bc,
                                     block_m=bm, **args)
        torch.cuda.synchronize()
        assert kw.winograd_streamed.LAUNCHES == before + 2
        assert torch.equal(got, again), (bh, bw, bc, bm)
        want = kw.winograd_streamed_plain(xp, ub, bias, sb, **args)
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) <= TOL, (bh, bw, bc, bm)


def _vgg16_convs():
    """(name, res, C, M) of VGG-16's 13 3x3 convs at 224."""
    from repro_torch.models import cnn
    out, res, c = [], 224, 3
    for spec in cnn.vgg16():
        if isinstance(spec, cnn.Conv):
            out.append((spec.name, res, c, spec.c_out))
            c = spec.c_out
        elif isinstance(spec, cnn.Pool):
            res //= spec.stride
    return out


VGG16 = _vgg16_convs()


@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("name,res,c,m", VGG16, ids=[v[0] for v in VGG16])
def test_ws_body_on_every_vgg16_conv(cuda, name, res, c, m, batch):
    """Each VGG-16 conv at 224 and batch 1, 8 and 32 under the plan's own
    blocking runs the warp-specialised body (its launch counted as such)
    and reads within TOL of the plain version run in float64: the TF32x3
    limit. conv5_1 also runs the plain version in one-pass TF32, which
    must break that limit (else the limit could not tell the two apart)."""
    g = torch.Generator().manual_seed(sum(map(ord, name)) + batch)
    x = torch.randn(batch, res, res, c, generator=g).to(cuda)
    wt = (torch.randn(3, 3, c, m, generator=g) / (9 * c) ** 0.5).to(cuda)
    bias = (0.1 * torch.randn(m, generator=g)).to(cuda)
    plan = pt_plan.plan_conv2d(x.shape, wt, algorithm="pallas_winograd",
                               device=cuda)
    row = plan.describe(kernel=True)
    assert row["body"] == "ws" and row["blocking"][1] == 8
    sp, s = plan.spec, plan.spec.stream
    xp = ops.pad_streamed_input(x, sp.geometry, s)
    kwargs = dict(ct_h=sp.ct_h, ct_w=sp.ct_w, bh=s.bh, bw=s.bw,
                  activation="relu")
    before = dict(kw.winograd_streamed.BODY_LAUNCHES)
    got = kw.winograd_streamed(xp, plan.u, bias, block_c=s.block_c,
                               block_m=s.block_m, **kwargs)
    torch.cuda.synchronize()
    assert kw.winograd_streamed.BODY_LAUNCHES["ws"] == before["ws"] + 1
    assert kw.winograd_streamed.BODY_LAUNCHES["tc"] == before["tc"]
    with _float64():
        exact = kw.winograd_streamed_plain(*_double(xp, plan.u, bias),
                                           **kwargs)
    assert _rel(got.double(), exact) <= TOL, name
    if name == "conv5_1":
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            one_pass = kw.winograd_streamed_plain(xp, plan.u, bias, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        assert _rel(one_pass.double(), exact) > TOL


@pytest.mark.parametrize("activation", ["none", "relu", "relu6", "gelu"])
@pytest.mark.parametrize("compute_dtype,tile", [
    ("float32", None), ("bfloat16", None), ("int8", None),
    ("float32", (4, 2))])
def test_ws_body_filters_epilogue_and_guarded_tiles(cuda, compute_dtype,
                                                     tile, activation):
    """The warp-specialised body under every blocking of its menu with an
    fp32, bf16 or int8 filter (int8 with its scale row), a bias shorter
    than M and each activation, and on a guarded non-square tile (F(4, 3)
    down, F(2, 3) across: 6 x 4 on the T = 6 body), each against the
    plain version: C 24 in three C steps, M 96, 30 x 26 pixels."""
    g = torch.Generator().manual_seed(7)
    n, h, w, c, m = 2, 30, 26, 24, 96
    x = torch.randn(n, h, w, c, generator=g).to(cuda)
    wt = (torch.randn(3, 3, c, m, generator=g) / (9 * c) ** 0.5).to(cuda)
    bias = torch.randn(m - 5, generator=g).to(cuda)
    plan = pt_plan.plan_conv2d((n, h, w, c), wt, algorithm="pallas_winograd",
                               compute_dtype=compute_dtype, output_tile=tile,
                               device=cuda)
    sp = plan.spec
    assert pt_wg.stream_body(sp.ct_h, sp.ct_w) == "ws"
    assert (plan.scale is not None) == (compute_dtype == "int8")
    u = plan.u[:, :c, :m]
    scale = None if plan.scale is None else plan.scale[:, :m]
    for bh, bw, bc, bm in _tc_blockings(sp.ct_h, sp.ct_w,
                                        plan.u.element_size()):
        assert bc == 8
        m_pad = -(-m // bm) * bm
        xp = _padded(x, sp.geometry, sp.ct_h, sp.ct_w, bh, bw, 24)
        ub = _pad_to(u, (u.shape[0], 24, m_pad))
        sb = None if scale is None else torch.nn.functional.pad(
            scale, (0, m_pad - m), value=1.0).contiguous()
        args = dict(ct_h=sp.ct_h, ct_w=sp.ct_w, bh=bh, bw=bw,
                    activation=activation)
        got = kw.winograd_streamed(xp, ub, bias, sb, block_c=bc,
                                   block_m=bm, **args)
        torch.cuda.synchronize()
        with _float64():
            exact = kw.winograd_streamed_plain(*_double(xp, ub, bias, sb),
                                               **args)
        assert _rel(got.double(), exact) <= TOL, (bh, bw, bc, bm)


def test_ws_launch_replays_in_a_cuda_graph(cuda):
    """After one warm-up launch, a winograd_streamed launch on the
    warp-specialised body is captured in a CUDA graph and replayed on new
    input: bitwise the eager launch on that input."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn(4, 28, 28, 64, generator=g).to(cuda)
    wt = (torch.randn(3, 3, 64, 128, generator=g) / 24).to(cuda)
    plan = pt_plan.plan_conv2d(x.shape, wt, algorithm="pallas_winograd",
                               device=cuda)
    sp, s = plan.spec, plan.spec.stream
    xp = ops.pad_streamed_input(x, sp.geometry, s)
    args = dict(ct_h=sp.ct_h, ct_w=sp.ct_w, bh=s.bh, bw=s.bw,
                block_c=s.block_c, block_m=s.block_m, activation="relu")
    kw.winograd_streamed(xp, plan.u, None, **args)          # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kw.winograd_streamed(xp, plan.u, None, **args)
    xp.copy_(ops.pad_streamed_input(x.flip(1).contiguous(), sp.geometry, s))
    graph.replay()
    torch.cuda.synchronize()
    want = kw.winograd_streamed(xp.clone(), plan.u, None, **args)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_kernel_rejects_bad_operands(cuda):
    plan = pt_plan.plan_conv2d((1, 8, 8, 8), torch.randn(3, 3, 8, 16),
                               algorithm="pallas_winograd", device=cuda)
    s = plan.spec
    xp = ops.pad_streamed_input(torch.zeros(1, 8, 8, 8, device=cuda),
                                s.geometry, s.stream)
    with pytest.raises(ValueError, match="contiguous float32"):
        kw.winograd_streamed(xp.double(), plan.u, None, ct_h=s.ct_h,
                             ct_w=s.ct_w, bh=s.stream.bh, bw=s.stream.bw,
                             block_c=s.stream.block_c,
                             block_m=s.stream.block_m)
    with pytest.raises(RuntimeError, match="blocking"):
        kw.winograd_streamed(torch.zeros(1, 10, 10, 8, device=cuda), plan.u,
                             None, ct_h=s.ct_h, ct_w=s.ct_w, bh=1, bw=1,
                             block_c=8, block_m=16)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@contextlib.contextmanager
def _float64():
    """The plain versions in float64: their `.float()` casts become no-ops
    (as chip_smoke.double_plain), the oracle of the TF32x3 kernels."""
    cast = torch.Tensor.float
    torch.Tensor.float = lambda self: self
    try:
        yield
    finally:
        torch.Tensor.float = cast


def _double(*ts):
    return [None if t is None else t.double() for t in ts]


@pytest.mark.parametrize("k,tile,compute_dtype", [
    (3, None, "float32"), (3, 2, "float32"), (5, 4, "float32"),
    (7, 2, "float32"), (3, 4, "bfloat16"), (3, 2, "int8")])
def test_strided_kernel_matches_plain_version(cuda, k, tile, compute_dtype):
    """The plan's own blocking, then every blocking of the tensor-core
    menu for the tile (C 5: one partial C step of each size; M 40), each
    against the plain version in fp32 and in float64 and launched twice,
    bitwise equal."""
    g = torch.Generator().manual_seed(30 + k)
    n, h, w, c, m = 2, 37, 26, 5, 40
    x = torch.randn(n, h, w, c, generator=g).to(cuda)
    wt = (torch.randn(k, k, c, m, generator=g) / (k * k * c) ** 0.5).to(cuda)
    bias = torch.randn(m, generator=g).to(cuda)
    plan = pt_plan.plan_conv2d((n, h, w, c), wt, stride=2,
                               algorithm="pallas_winograd",
                               compute_dtype=compute_dtype, output_tile=tile,
                               device=cuda)
    assert plan.spec.algorithm == "pallas_winograd_strided"
    s, sp = plan.spec.stream, plan.spec
    u = plan.u[:, :c, :m]
    scale = None if plan.scale is None else plan.scale[:, :m]
    blockings = [(s.bh, s.bw, s.block_c, s.block_m)] + list(
        _tc_blockings(sp.ct_h, sp.ct_w, plan.u.element_size(), phases=4))
    for bh, bw, bc, bm in blockings:
        c_pad, m_pad = -(-c // bc) * bc, -(-m // bm) * bm
        n_hb, n_wb = -(-sp.geometry.n_h // bh), -(-sp.geometry.n_w // bw)
        xp = torch.nn.functional.pad(x, (
            0, c_pad - c, sp.geometry.lo_w,
            sp.geometry.hi_w + 2 * (n_wb * bw - sp.geometry.n_w) * sp.ct_w.m,
            sp.geometry.lo_h,
            sp.geometry.hi_h + 2 * (n_hb * bh - sp.geometry.n_h) * sp.ct_h.m))
        ub = _pad_to(u, (u.shape[0], c_pad, m_pad))
        sb = None if scale is None else torch.nn.functional.pad(
            scale, (0, m_pad - m), value=1.0).contiguous()
        args = dict(ct_h=sp.ct_h, ct_w=sp.ct_w, bh=bh, bw=bw,
                    activation="relu6")
        before = kw.winograd_strided_streamed.LAUNCHES
        got = kw.winograd_strided_streamed(xp, ub, bias, sb, block_c=bc,
                                           block_m=bm, **args)
        again = kw.winograd_strided_streamed(xp, ub, bias, sb, block_c=bc,
                                             block_m=bm, **args)
        torch.cuda.synchronize()
        assert kw.winograd_strided_streamed.LAUNCHES == before + 2
        assert torch.equal(got, again), (bh, bw, bc, bm)
        want = kw.winograd_strided_streamed_plain(xp, ub, bias, sb, **args)
        assert _rel(got, want) <= TOL, (bh, bw, bc, bm)
        with _float64():
            exact = kw.winograd_strided_streamed_plain(
                *_double(xp, ub, bias, sb), **args)
        assert _rel(got.double(), exact) <= TOL, (bh, bw, bc, bm)


@pytest.mark.parametrize("k,tile,compute_dtype", [
    (3, 2, "float32"), (3, 4, "float32"), (5, 2, "float32"),
    (7, 4, "float32"), (3, 2, "bfloat16"), (5, 4, "int8")])
def test_depthwise_strided_kernel_matches_plain_version(cuda, k, tile,
                                                        compute_dtype):
    g = torch.Generator().manual_seed(40 + k)
    n, h, w, c = 2, 29, 34, 44
    x = torch.randn(n, h, w, c, generator=g).to(cuda)
    wt = (torch.randn(k, k, 1, c, generator=g) / k).to(cuda)
    bias = torch.randn(c, generator=g).to(cuda)
    plan = pt_plan.plan_conv2d((n, h, w, c), wt, stride=2, groups=c,
                               algorithm="pallas_winograd",
                               compute_dtype=compute_dtype, output_tile=tile,
                               device=cuda)
    assert plan.spec.algorithm == "pallas_depthwise_strided"
    s = plan.spec.stream
    xp = ops.pad_streamed_input(x, plan.spec.geometry, s, stride=2)
    args = dict(ct_h=plan.spec.ct_h, ct_w=plan.spec.ct_w, bh=s.bh, bw=s.bw,
                activation="gelu")
    before = kd.depthwise_strided_streamed.LAUNCHES
    got = kd.depthwise_strided_streamed(xp, plan.u, bias, plan.scale,
                                        block_c=s.block_c, **args)
    torch.cuda.synchronize()
    assert kd.depthwise_strided_streamed.LAUNCHES == before + 1
    want = kd.depthwise_strided_streamed_plain(xp, plan.u, bias, plan.scale,
                                               **args)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mt,k", [(2, 3), (4, 3), (3, 3), (3, 5)],
                         ids=["F(2,2)", "F(4,2)", "F(3,2)", "F(3,3)"])
def test_depthwise_strided_kernel_under_every_blocking(cuda, mt, k,
                                                       compute_dtype):
    """Every (bh, bw, block_c) the stride-2 chooser may pick (bh, bw in
    1..16 up to the tile grid, bc in DEPTHWISE_BLOCK_C up to C rounded up
    to 8, depthwise_strided_blocking_fits) against the plain version: the
    guard-free F(2, 2) and F(4, 2) bodies, the generic one at F(3, 2)
    (T = 4) and F(3, 3) (T = 5, m = 3), each filter dtype."""
    g = torch.Generator().manual_seed(60 + mt + k)
    n, h, w, c = 2, 30, 27, 40
    x = torch.randn(n, h, w, c, generator=g).to(cuda)
    wt = (torch.randn(k, k, 1, c, generator=g) / k).to(cuda)
    bias = torch.randn(c, generator=g).to(cuda)
    plan = pt_plan.plan_conv2d((n, h, w, c), wt, stride=2, groups=c,
                               algorithm="pallas_winograd",
                               compute_dtype=compute_dtype, output_tile=mt,
                               device=cuda)
    assert plan.spec.algorithm == "pallas_depthwise_strided"
    sp = plan.spec
    ct_h, ct_w, geom = sp.ct_h, sp.ct_w, sp.geometry
    u = plan.u[:, :c]
    scale = None if plan.scale is None else plan.scale[:, :c]
    tried = 0
    for bh in (1, 2, 4, 8, 16):
        for bw in (1, 2, 4, 8, 16):
            for bc in pt_wg.DEPTHWISE_BLOCK_C:
                if (bc > 8 and bc > -(-c // 8) * 8) or bh > 2 * geom.n_h or \
                        bw > 2 * geom.n_w or \
                        not pt_wg.depthwise_strided_blocking_fits(
                            ct_h, ct_w, bh, bw, bc):
                    continue
                c_pad = -(-c // bc) * bc
                n_hb, n_wb = -(-geom.n_h // bh), -(-geom.n_w // bw)
                xp = torch.nn.functional.pad(x, (
                    0, c_pad - c, geom.lo_w,
                    geom.hi_w + 2 * (n_wb * bw - geom.n_w) * ct_w.m,
                    geom.lo_h,
                    geom.hi_h + 2 * (n_hb * bh - geom.n_h) * ct_h.m))
                ub = _pad_to(u, (u.shape[0], c_pad))
                sb = None if scale is None else torch.nn.functional.pad(
                    scale, (0, c_pad - c), value=1.0).contiguous()
                args = dict(ct_h=ct_h, ct_w=ct_w, bh=bh, bw=bw,
                            activation="relu6")
                got = kd.depthwise_strided_streamed(xp, ub, bias, sb,
                                                    block_c=bc, **args)
                torch.cuda.synchronize()
                want = kd.depthwise_strided_streamed_plain(xp, ub, bias, sb,
                                                           **args)
                assert _rel(got, want) <= TOL, (bh, bw, bc)
                tried += 1
    assert tried >= 40


@pytest.mark.parametrize("k,c,m,acts", [
    (3, 24, 40, ("relu", "relu")), (3, 70, 16, ("relu6", "none")),
    (5, 19, 33, ("relu", "gelu")), (7, 8, 130, ("none", "relu6")),
    (3, 37, 200, ("relu6", "none")), (3, 9, 24, ("relu", "relu"))])
def test_separable_kernel_matches_plain_version(cuda, k, c, m, acts):
    """The plan's own blocking, then every C step with each M width the
    chooser weighs (M not a multiple of 8 or 16, M past 128) at two strip
    shapes, each against the plain version and launched twice, bitwise
    equal."""
    g = torch.Generator().manual_seed(50 + k + c)
    n, h, w = 2, 23, 19
    x = torch.randn(n, h, w, c, generator=g).to(cuda)
    w_dw = (torch.randn(k, k, 1, c, generator=g) / k).to(cuda)
    w_pw = (torch.randn(1, 1, c, m, generator=g) / c ** 0.5).to(cuda)
    b_dw = torch.randn(c, generator=g).to(cuda)
    b_pw = torch.randn(m, generator=g).to(cuda)
    plan = pt_plan.plan_separable_block((n, h, w, c), w_dw, w_pw,
                                        algorithm="pallas_winograd",
                                        device=cuda)
    assert plan.mode == "fused_pallas"
    s, sp = plan.spec.stream, plan.spec
    blockings = [(s.bh, s.bw, s.block_c, s.block_m)]
    for bm in pt_wg.separable_block_m(m):
        for bc in pt_wg.SEPARABLE_BLOCK_C:
            for bh, bw in ((2, 2), (1, 4), (4, 4)):
                if pt_wg.separable_blocking_fits(sp.ct_h, sp.ct_w, bh, bw,
                                                 bc, bm):
                    blockings.append((bh, bw, bc, bm))
    u_dw, u_pw = plan.u_dw[:, :c], plan.u_pw[:c, :m]
    for bh, bw, bc, bm in blockings:
        c_pad, m_pad = -(-c // bc) * bc, -(-m // bm) * bm
        xp = _padded(x, sp.geometry, sp.ct_h, sp.ct_w, bh, bw, c_pad)
        udw = _pad_to(u_dw, (u_dw.shape[0], c_pad))
        upw = _pad_to(u_pw, (c_pad, m_pad))
        args = dict(ct_h=sp.ct_h, ct_w=sp.ct_w, bh=bh, bw=bw,
                    inner_activation=acts[0], activation=acts[1])
        before = kd.separable_streamed.LAUNCHES
        got = kd.separable_streamed(xp, udw, upw, b_dw, b_pw, block_c=bc,
                                    block_m=bm, **args)
        again = kd.separable_streamed(xp, udw, upw, b_dw, b_pw, block_c=bc,
                                      block_m=bm, **args)
        torch.cuda.synchronize()
        assert kd.separable_streamed.LAUNCHES == before + 2
        assert torch.equal(got, again), (bh, bw, bc, bm)
        want = kd.separable_streamed_plain(xp, udw, upw, b_dw, b_pw, **args)
        assert _rel(got, want) <= TOL, (bh, bw, bc, bm)


@pytest.mark.parametrize("mm,kk,nn,dtype", [
    (1, 1, 1, torch.float32), (131, 37, 70, torch.float32),
    (300, 64, 128, torch.float32), (77, 45, 19, torch.bfloat16),
    (129, 96, 24, torch.int8), (200, 37, 16, torch.int8),
    (333, 45, 24, torch.float32), (196, 512, 1024, torch.float32),
    (50176, 32, 64, torch.bfloat16), (12544, 96, 24, torch.float32),
    (3136, 144, 32, torch.int8), (196, 960, 320, torch.int8),
    (196, 1024, 1024, torch.bfloat16), (196, 576, 160, torch.float32)])
def test_matmul_kernel_matches_plain_version(cuda, mm, kk, nn, dtype):
    """Every tile of the kernel's menu, B padded by the plan's rule for
    that tile, then every K split that fits on the plan's tile: ragged K
    (37, 45: the 4-byte staging path), narrow N (16, 24), MobileNet shapes
    (sep13, sep2, ir2, ir4, ir17, sep14, ir14); each against the plain
    version in fp32 and in float64 and launched twice, bitwise equal (the
    splits' sum runs in a fixed order)."""
    g = torch.Generator().manual_seed(mm + kk + nn)
    a = torch.randn(mm, kk, generator=g).to(cuda)
    b = torch.randn(kk, nn, generator=g) / kk ** 0.5
    if dtype == torch.int8:
        b = torch.clamp(torch.round(b * 40 * kk ** 0.5), -127, 127)
    bias = torch.randn(nn, generator=g).to(cuda)
    plan_bm, _, plan_bn, _ = pt_im2col.matmul_blocks(
        mm, kk, nn, u_size=torch.tensor([], dtype=dtype).element_size())
    cases = [(bm, bn, 1) for bm, bn in pt_im2col.MATMUL_TILES] + [
        (plan_bm, plan_bn, s) for s in pt_im2col.MATMUL_SPLITS[1:]
        if pt_im2col.matmul_split_fits(kk, s)]
    for bm, bn, splits in cases:
        bp = ops.pad_im2col_filter(b.to(dtype), bn).to(cuda)
        assert tuple(bp.shape) == pt_im2col.matmul_b_shape(kk, nn, bn)
        scale = None if dtype != torch.int8 else \
            torch.rand(1, bp.shape[1], generator=g).to(cuda)
        args = dict(n_out=nn, activation="relu")
        tile = dict(block_m=bm, block_n=bn, splits=splits)
        before = km.matmul.LAUNCHES
        got = km.matmul(a, bp, bias, scale, **tile, **args)
        again = km.matmul(a, bp, bias, scale, **tile, **args)
        torch.cuda.synchronize()
        assert km.matmul.LAUNCHES == before + 2
        assert got.shape == (mm, nn)
        assert torch.equal(got, again), (bm, bn, splits)
        want = km.matmul_plain(a, bp, bias, scale, **args)
        assert _rel(got, want) <= TOL, (bm, bn, splits)
        with _float64():
            exact = km.matmul_plain(*_double(a, bp, bias, scale), **args)
        assert _rel(got.double(), exact) <= TOL, (bm, bn, splits)


def test_matmul_rejects_bad_operands(cuda):
    """A tile off the menu, B not padded by the rule for its tile, and a
    K split that leaves a split empty."""
    a = torch.zeros(40, 64, device=cuda)
    b = ops.pad_im2col_filter(torch.zeros(64, 24), 32).to(cuda)
    with pytest.raises(ValueError, match="menu"):
        km.matmul(a, b, n_out=24, block_m=48, block_n=32)
    with pytest.raises(ValueError, match="padded"):
        km.matmul(a, b, n_out=24, block_m=64, block_n=64)
    with pytest.raises(ValueError, match="split"):
        km.matmul(a, b, n_out=24, block_m=64, block_n=32, splits=3)


#: Every distinct stride-1 depthwise layer of MobileNet-v1 and v2 at 224
#: (the reduced path's depthwise_streamed launches), at batch 2.
MOBILENET_DW = [(2, 112, 112, 32), (2, 56, 56, 128), (2, 28, 28, 256),
                (2, 14, 14, 512), (2, 7, 7, 1024), (2, 56, 56, 144),
                (2, 28, 28, 192), (2, 14, 14, 384), (2, 14, 14, 576),
                (2, 7, 7, 960)]


@pytest.mark.parametrize("k,tile,mult,compute_dtype,shape", [
    (3, 2, 1, "bfloat16", (2, 56, 56, 128)),
    (3, 2, 1, "int8", (2, 14, 14, 512)),
    (3, 4, 1, "float32", (2, 28, 28, 192)),
    (3, 4, 2, "float32", (2, 23, 19, 37)),
    (5, 2, 2, "int8", (2, 17, 29, 13)),
    (7, 2, 1, "bfloat16", (1, 9, 11, 70)),
    (3, 3, 1, "int8", (2, 19, 21, 200)),      # F(3, 3): the generic body
    (3, 2, 3, "float32", (1, 15, 16, 40))]
    + [(3, 2, 1, cd, shape) for shape in MOBILENET_DW
       for cd in ("bfloat16", "int8")])
def test_depthwise_kernel_matches_plain_version(cuda, k, tile, mult,
                                                compute_dtype, shape):
    """The plan's own blocking, then each C step of the kernel (1, 2 and 4
    channels a thread; F(2, 3) on its exact body, every other tile on the
    generic one) at three strip shapes, each against the plain version and
    launched twice, bitwise equal."""
    g = torch.Generator().manual_seed(60 + k + mult)
    n, h, w, c = shape
    x = torch.randn(n, h, w, c, generator=g).to(cuda)
    wt = (torch.randn(k, k, 1, c * mult, generator=g) / k).to(cuda)
    bias = torch.randn(c * mult, generator=g).to(cuda)
    plan = pt_plan.plan_conv2d((n, h, w, c), wt, groups=c,
                               algorithm="pallas_winograd",
                               compute_dtype=compute_dtype, output_tile=tile,
                               device=cuda)
    assert plan.spec.algorithm == "pallas_depthwise"
    s, sp = plan.spec.stream, plan.spec
    u = plan.u[:, :c]
    scale = None if plan.scale is None else plan.scale[:, :c * mult]
    blockings = [(s.bh, s.bw, s.block_c)] + [
        (bh, bw, bc) for bc in pt_wg.DEPTHWISE_BLOCK_C
        for bh, bw in ((1, 1), (2, 4), (5, 8))
        if bc <= max(8, c) and pt_wg.depthwise_blocking_fits(
            sp.ct_h, sp.ct_w, bh, bw, bc, mult)]
    for bh, bw, bc in blockings:
        c_pad = -(-c // bc) * bc
        xp = _padded(x, sp.geometry, sp.ct_h, sp.ct_w, bh, bw, c_pad)
        ub = _pad_to(u, (u.shape[0], c_pad, mult))
        sb = None if scale is None else torch.nn.functional.pad(
            scale, (0, (c_pad - c) * mult), value=1.0).contiguous()
        args = dict(ct_h=sp.ct_h, ct_w=sp.ct_w, bh=bh, bw=bw,
                    activation="relu6")
        before = kd.depthwise_streamed.LAUNCHES
        got = kd.depthwise_streamed(xp, ub, bias, sb, block_c=bc, **args)
        again = kd.depthwise_streamed(xp, ub, bias, sb, block_c=bc, **args)
        torch.cuda.synchronize()
        assert kd.depthwise_streamed.LAUNCHES == before + 2
        assert torch.equal(got, again), (bh, bw, bc)
        want = kd.depthwise_streamed_plain(xp, ub, bias, sb, **args)
        assert got.shape == want.shape
        assert _rel(got, want) <= TOL, (bh, bw, bc)


@pytest.mark.parametrize("h,c,m,tile", [
    (56, 64, 128, None), (14, 512, 512, None), (23, 19, 40, 2),
    (9, 8, 16, 6)])
def test_fused_kernel_matches_plain_version(cuda, h, c, m, tile):
    """The plan's own blocking, then every blocking of the tensor-core menu
    that the tiles-domain kernel takes for the tile, each against the
    plain version in fp32 and in float64 (the TF32x3 oracle); then the
    plan against a cuDNN convolution."""
    g = torch.Generator().manual_seed(70 + h + c)
    n = 2
    x = torch.randn(n, h, h + 3, c, generator=g).to(cuda)
    wt = (torch.randn(3, 3, c, m, generator=g) / (9 * c) ** 0.5).to(cuda)
    plan = pt_plan.plan_conv2d((n, h, h + 3, c), wt,
                               algorithm="pallas_winograd_materialized",
                               output_tile=tile, device=cuda)
    s = plan.spec
    u = plan.u[:, :c, :m]
    t = pt_wg.winograd_tc_tile(s.ct_h.t, s.ct_w.t)
    blockings = [tuple(s.blocks)] + [
        (16 * kmt, bc, 8 * knt) for kmt, knt in pt_wg.FUSED_TC_CONFIGS[t]
        for bc in pt_wg.WINOGRAD_TC_BLOCK_C
        if pt_wg.fused_blocking_fits(s.ct_h, s.ct_w, 16 * kmt, bc, 8 * knt)]
    for br, bc, bm in blockings:
        tiles = ops.extract_tiles(x, ct_h=s.ct_h, ct_w=s.ct_w,
                                  geometry=s.geometry, blocks=(br, bc, bm))
        ub = _pad_to(u, (u.shape[0], tiles.shape[3], -(-m // bm) * bm))
        args = dict(ct_h=s.ct_h, ct_w=s.ct_w)
        before = kw.winograd_fused.LAUNCHES
        got = kw.winograd_fused(tiles, ub, block_r=br, block_c=bc,
                                block_m=bm, **args)
        torch.cuda.synchronize()
        assert kw.winograd_fused.LAUNCHES == before + 1
        want = kw.winograd_fused_plain(tiles, ub, **args)
        assert got.shape == want.shape == (tiles.shape[0], s.ct_h.m,
                                           s.ct_w.m, ub.shape[2])
        assert _rel(got, want) <= TOL, (br, bc, bm)
        with _float64():
            exact = kw.winograd_fused_plain(tiles.double(), ub.double(),
                                            **args)
        assert _rel(got.double(), exact) <= TOL, (br, bc, bm)
    y = plan.apply(x)
    torch.backends.cudnn.allow_tf32 = False
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                     wt.permute(3, 2, 0, 1), padding=1)
    assert _rel(y, ref.permute(0, 2, 3, 1)) <= TOL


@pytest.mark.parametrize("r,tile,c,length,dtype", [
    (4, 4, 8192, 2048, torch.float32), (4, 4, 8192, 2048, torch.bfloat16),
    (2, 2, 200, 2045, torch.float32), (3, 4, 200, 2045, torch.bfloat16),
    (3, 2, 16, 37, torch.float32)])
def test_conv1d_ct_kernel_matches_plain_version(cuda, r, tile, c, length,
                                                dtype):
    from repro_torch.kernels import conv1d_ct as kc
    g = torch.Generator().manual_seed(80 + r + c)
    x = torch.randn(2, length, c, generator=g).to(cuda, dtype)
    w = (torch.randn(r, c, generator=g) / r).to(cuda)
    plan = pt_plan.plan_depthwise_conv1d(x.shape, w, output_tile=tile,
                                         backend="pallas", device=cuda)
    s = plan.spec
    tiles = ops.conv1d_tiles(x, ct=s.ct, n_tiles=s.n_tiles, pad_hi=s.pad_hi,
                             c_pad=plan.u.shape[1])
    before = kc.conv1d_ct_fused.LAUNCHES
    got = kc.conv1d_ct_fused(tiles, plan.u, ct=s.ct, block_s=s.blocks[0],
                             block_c=s.blocks[1])
    torch.cuda.synchronize()
    assert kc.conv1d_ct_fused.LAUNCHES == before + 1
    want = kc.conv1d_ct_fused_plain(tiles, plan.u, ct=s.ct)
    assert got.dtype == want.dtype == dtype
    tol = TOL if dtype == torch.float32 else 1e-2   # one bf16 rounding
    assert _rel(got.float(), want.float()) <= tol
    y = plan.apply(x)
    torch.backends.cudnn.allow_tf32 = False
    ref = torch.nn.functional.conv1d(
        torch.nn.functional.pad(x.float().transpose(1, 2), (r - 1, 0)),
        w.t()[:, None, :], groups=c).transpose(1, 2)
    assert _rel(y.float(), ref) <= tol


def _scan_exact(*args):
    """selective_scan's plain version in float64: the kernel's oracle. Its
    exp2 decays (ex2.approx) and the fp32 plain version's expf round
    differently, and over 2048 steps the fp32 plain version reads as far
    from float64 as the kernel (chip_smoke.TOL_SCAN)."""
    from repro_torch.kernels import selective_scan as ks
    with _float64():
        return ks.selective_scan_plain(*_double(*args))


@pytest.mark.parametrize("b,length,d,n,dtype", [
    (2, 2048, 1024, 16, torch.float32), (1, 1, 300, 16, torch.float32),
    (2, 37, 200, 8, torch.float32), (1, 2064, 130, 4, torch.float32),
    (2, 100, 256, 16, torch.bfloat16)])
def test_selective_scan_kernel_matches_plain_version(cuda, b, length, d, n,
                                                     dtype):
    from repro_torch.kernels import selective_scan as ks
    g = torch.Generator().manual_seed(90 + d + n)
    dt = (0.001 + 0.1 * torch.rand(b, length, d, generator=g)).to(cuda, dtype)
    xs = torch.randn(b, length, d, generator=g).to(cuda, dtype)
    bmat = torch.randn(b, length, n, generator=g).to(cuda, dtype)
    cmat = torch.randn(b, length, n, generator=g).to(cuda, dtype)
    a_mat = -torch.exp(torch.randn(d, n, generator=g)).to(cuda)
    before = ks.selective_scan.LAUNCHES
    y, h = ks.selective_scan(dt, xs, bmat, cmat, a_mat)
    torch.cuda.synchronize()
    assert ks.selective_scan.LAUNCHES == before + 1
    want_y, want_h = _scan_exact(dt, xs, bmat, cmat, a_mat)
    # the reference's limit for its kernel (tests/test_selective_scan.py),
    # against the plain version in float64 (as chip_smoke.TOL_SCAN)
    assert _rel(y.double(), want_y) <= 1e-5
    assert _rel(h.double(), want_h) <= 1e-5


#: (B, L, D, N, dt / xs dtype, B / C dtype) of every selective_scan shape
#: chip_smoke.py checks: the falcon-mamba-7b layer (prefill, prefill +
#: decode, one step), odd D, N and L, bf16 operands.
SCAN_SHAPES = [
    (4, 2048, 8192, 16, torch.float32, torch.float32),
    (4, 2064, 8192, 16, torch.float32, torch.float32),
    (4, 1, 8192, 16, torch.float32, torch.float32),
    (2, 37, 8200, 16, torch.float32, torch.float32),
    (2, 300, 1000, 4, torch.float32, torch.float32),
    (2, 300, 1000, 8, torch.float32, torch.float32),
    (1, 129, 200, 12, torch.float32, torch.float32),
    (4, 2048, 8192, 16, torch.bfloat16, torch.float32),
    (2, 256, 1000, 16, torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("b,length,d,n,xdt,bcdt", SCAN_SHAPES)
def test_selective_scan_under_every_blocking(cuda, b, length, d, n, xdt,
                                             bcdt):
    """Every (lanes, channels, chunk) scan_blocking_fits takes, which
    holds every blocking scan_blocking returns, at each of chip_smoke's
    shapes: launched twice, the two results bitwise equal and within the
    reference's 1e-5 of the plain version in float64."""
    from repro_torch.kernels import selective_scan as ks
    g = torch.Generator().manual_seed(7 + d + n + length)
    dt = (0.001 + 0.1 * torch.rand(b, length, d, generator=g)).to(cuda, xdt)
    xs = torch.randn(b, length, d, generator=g).to(cuda, xdt)
    bmat = torch.randn(b, length, n, generator=g).to(cuda, bcdt)
    cmat = torch.randn(b, length, n, generator=g).to(cuda, bcdt)
    a_mat = -torch.exp(torch.randn(d, n, generator=g)).to(cuda)
    args = (dt, xs, bmat, cmat, a_mat)
    want_y, want_h = _scan_exact(*args)
    x_size, bc_size = dt.element_size(), bmat.element_size()
    blockings = [blk for blk in itertools.product(
        ks.SCAN_LANES, ks.SCAN_CHANNELS, ks.SCAN_CHUNKS)
        if ks.scan_blocking_fits(*blk, n, x_size, bc_size)]
    assert ks.scan_blocking(b, d, n) in blockings
    for blk in blockings:
        y, h = ks.selective_scan(*args, blocking=blk)
        y2, h2 = ks.selective_scan(*args, blocking=blk)
        torch.cuda.synchronize()
        assert torch.equal(y, y2) and torch.equal(h, h2), blk
        assert _rel(y.double(), want_y) <= 1e-5, blk
        assert _rel(h.double(), want_h) <= 1e-5, blk


# ---------------------------------------------------------------------------
# the serving runtime's graph dispatch (a CUDA graph per bucket)
# ---------------------------------------------------------------------------

def _mbv2_server(**cfg):
    """MobileNet-v2 at 64 under pallas_winograd on the card (its stem,
    separable, stride-2 depthwise and matmul kernels), buckets (1, 2)."""
    from repro_torch.models import cnn
    from repro_torch.runtime.serve import ServeConfig, Server
    specs = cnn.mobilenet_v2()
    params = cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                          res=64, device="cuda")
    kw = dict(buckets=(1, 2), verbose=False, probation_batches=0)
    kw.update(cfg)
    return Server(params, specs, res=64, algorithm="pallas_winograd",
                  config=ServeConfig(**kw))


def _images(n):
    g = torch.Generator().manual_seed(5)
    return [torch.randn(64, 64, 3, generator=g).numpy() for _ in range(n)]


def test_graph_replay_equals_eager_apply(cuda):
    """A replay of the bucket's captured forward equals the eager apply of
    the same plans on the same batch, bitwise, and fresh outputs survive
    the next replay."""
    srv = _mbv2_server()
    srv.warmup()
    x = torch.from_numpy(np.stack(_images(2))).to(cuda)
    x2 = x.flip(0).contiguous()
    y = srv._jitted_apply(2, x)
    y2 = srv._jitted_apply(2, x2)
    with torch.inference_mode():
        eager, eager2 = srv.nets[2].apply(x), srv.nets[2].apply(x2)
    torch.cuda.synchronize()
    assert torch.equal(y, eager) and torch.equal(y2, eager2)
    assert len(srv._jit) == 2


def test_faulty_plan_after_capture_forces_recapture(cuda):
    """A FaultyPlan installed after capture changes the plan-identity
    token: the next dispatch captures again (the proxy runs in the warm-up
    and the capture), and replays then run without calling it."""
    from repro_torch.runtime import inject
    srv = _mbv2_server()
    srv.start()
    try:
        xs = _images(3)
        [srv.submit(x).result(timeout=120) for x in xs]
        proxies = inject.install_on_server(
            srv, inject.ExecutorRaise("ir2", after=10**9))
        ys = [srv.submit(x).result(timeout=120) for x in xs]
    finally:
        srv.stop()
    assert proxies[0].calls == 2            # warm-up + capture, bucket 1
    assert srv.stats.jit_fallbacks == 0
    assert srv.stats.jit_dispatches == srv.stats.batches
    with torch.inference_mode():
        want = srv.nets[1].apply(torch.from_numpy(xs[0][None]).to(cuda))
    assert np.array_equal(ys[0], want[0].cpu().numpy())


def test_capture_that_raises_leaves_the_device_usable(cuda):
    """An exception inside the capture (the fault's second call) ends the
    capture before it leaves: no stream is left capturing, the bucket
    falls back to the eager supervised path once, and it answers
    correctly on the same device."""
    from repro_torch.runtime import inject
    srv = _mbv2_server(buckets=(1,))
    srv.warmup()
    inject.install_on_server(srv, inject.ExecutorRaise("ir2", after=1,
                                                       times=1))
    x = torch.from_numpy(_images(1)[0][None]).to(cuda)
    y, layer_times = srv._dispatch(1, x)
    torch.cuda.synchronize()
    assert not torch.cuda.is_current_stream_capturing()
    assert srv.stats.jit_fallbacks == 1 and layer_times
    with torch.inference_mode():
        want = srv.nets[1].apply(x)
    assert torch.equal(y, want)
