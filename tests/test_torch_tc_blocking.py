"""The blocking choosers of the tensor-core kernels on every layer the
main path gives them: `stream_geometry_tf32x3` (kernels/csrc/
winograd_streamed.cu, every stride-1 conv of VGG-16 at each filter dtype;
with phases=4 kernels/csrc/winograd_strided_streamed.cu, the MobileNet
stems), `separable_geometry` (kernels/csrc/separable_streamed.cu, every
fused stride-1 block of MobileNet-v1 and v2) and `matmul_blocks`
(kernels/csrc/matmul.cu, every pointwise GEMM of the MobileNets at each
filter dtype), at 224 and batch 1 and 4; and their fit rules against the
launchers' validation. The CPU cannot run the kernels: the fit rules are
held to tables that mirror the launchers' checks, one rule broken per
rejected case."""

import pathlib
import re

import pytest
import torch

from repro_torch.core import im2col as pt_im2col
from repro_torch.core import plan as pt_plan
from repro_torch.core import transforms as pt_tf
from repro_torch.core import winograd as pt_wg
from repro_torch.models import cnn
from ws_sweep_h100 import WS_SWEEP_MS

RES = 224
U_SIZES = {"float32": 4, "bfloat16": 2, "int8": 1}


def _vgg16_convs() -> list[tuple[str, int, int, int]]:
    """(name, res, C, M) of VGG-16's 3x3 convs at RES."""
    out, res, c = [], RES, 3
    for spec in cnn.vgg16():
        if isinstance(spec, cnn.Conv):
            out.append((spec.name, res, c, spec.c_out))
            c = spec.c_out
        elif isinstance(spec, cnn.Pool):
            res //= spec.stride
    return out


def _fused_blocks() -> list[tuple[str, int, int, int]]:
    """(name, res, C, M) of the stride-1 depthwise + pointwise pairs that
    the compiler fuses onto separable_streamed: MobileNet-v1's separable
    units and MobileNet-v2's inverted residuals (C the expanded width)."""
    out = []
    for net, specs in (("mobilenet_v1", cnn.mobilenet_v1()),
                       ("mobilenet_v2", cnn.mobilenet_v2())):
        res, c = RES, 3
        for spec in specs:
            if isinstance(spec, cnn.Conv):
                res, c = -(-res // spec.stride), spec.c_out
            elif isinstance(spec, cnn.SeparableConv):
                if spec.stride == 1:
                    out.append((f"{net}.{spec.name}", res, c, spec.c_out))
                res, c = -(-res // spec.stride), spec.c_out
            elif isinstance(spec, cnn.InvertedResidual):
                if spec.stride == 1:
                    out.append((f"{net}.{spec.name}", res, c * spec.expand,
                                spec.c_out))
                res, c = -(-res // spec.stride), spec.c_out
    return out


def _matmul_launches() -> list[tuple[str, int, int, int, str]]:
    """(name, M, K, N, compute dtype) of the MobileNets' matmul launches at
    RES and batch 4: the pointwise GEMM after each stride-2 depthwise conv
    at fp32 (the stride-1 blocks fuse onto separable_streamed), after every
    depthwise conv at bf16 and int8 (MobileNet-v2's: the projection, K the
    expanded width)."""
    out = []
    for net, specs in (("mobilenet_v1", cnn.mobilenet_v1()),
                       ("mobilenet_v2", cnn.mobilenet_v2())):
        res, c = RES, 3
        for spec in specs:
            if isinstance(spec, cnn.Conv):
                res, c = -(-res // spec.stride), spec.c_out
            elif isinstance(spec, (cnn.SeparableConv, cnn.InvertedResidual)):
                res = -(-res // spec.stride)
                k = c * getattr(spec, "expand", 1)
                for cd in ("float32", "bfloat16", "int8"):
                    if cd != "float32" or spec.stride == 2:
                        out.append((f"{net}.{spec.name}", 4 * res * res, k,
                                    spec.c_out, cd))
                c = spec.c_out
    return out


VGG = _vgg16_convs()
FUSED = _fused_blocks()
MATMULS = _matmul_launches()


def test_the_layer_lists_are_the_main_path():
    """13 VGG-16 convs; 9 + 13 fused MobileNet blocks (PERF.md's launch
    counts), the last of each at 7 x 7 or 14 x 14; 4 + 4 fp32 and 13 + 17
    bf16 / int8 matmul launches (38 shapes), among them sep13, sep2 and
    ir2."""
    assert len(VGG) == 13 and VGG[-1] == ("conv5_2", 14, 512, 512)
    assert sum(n.startswith("mobilenet_v1") for n, *_ in FUSED) == 9
    assert sum(n.startswith("mobilenet_v2") for n, *_ in FUSED) == 13
    assert ("mobilenet_v1.sep14", 7, 1024, 1024) in FUSED
    fp32 = [m for m in MATMULS if m[4] == "float32"]
    bf16 = [m for m in MATMULS if m[4] == "bfloat16"]
    assert len(fp32) == 8 and len(bf16) == 30 and len(MATMULS) == 68
    assert ("mobilenet_v1.sep13", 196, 512, 1024, "float32") in fp32
    assert ("mobilenet_v1.sep2", 50176, 32, 64, "bfloat16") in bf16
    assert ("mobilenet_v2.ir2", 12544, 96, 24, "float32") in fp32
    assert ("mobilenet_v2.ir17", 196, 960, 320, "bfloat16") in bf16


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("dtype", list(U_SIZES))
@pytest.mark.parametrize("name,res,c,m", VGG, ids=[v[0] for v in VGG])
def test_winograd_chooser_on_vgg16(name, res, c, m, dtype, batch):
    """The plan's tile at each dtype (F(4, 3) fp32, F(2, 3) reduced): a
    blocking the kernel takes that covers the tile grid exactly, C padded
    to one C step at most (conv1_0's 3 channels to 8), M to one M block."""
    mt = 4 if dtype == "float32" else 2
    ct = pt_tf.cook_toom(mt, 3)
    g = pt_wg.conv2d_geometry(res, res, 3, 3, mt, mt, "SAME")
    s = pt_wg.stream_geometry_tf32x3(g.n_h, g.n_w, c, m, ct, ct, batch=batch,
                                     u_size=U_SIZES[dtype])
    assert pt_wg.stream_blocking_fits(ct, ct, s.bh, s.bw, s.block_c,
                                      s.block_m, U_SIZES[dtype])
    assert s.n_hb * s.bh == g.n_h + s.pad_h // mt >= g.n_h
    assert s.n_wb * s.bw == g.n_w + s.pad_w // mt >= g.n_w
    assert 0 <= s.pad_h < s.bh * mt and 0 <= s.pad_w < s.bw * mt
    assert c <= s.c_pad < c + s.block_c and s.c_pad % s.block_c == 0
    assert m <= s.m_pad < m + s.block_m and s.m_pad % s.block_m == 0
    assert s.block_c <= max(8, c)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name,res,c,m", FUSED, ids=[f[0] for f in FUSED])
def test_separable_chooser_on_mobilenets(name, res, c, m, batch):
    """A blocking the kernel takes, covering the F(4, 3) tile grid; bM >=
    min(M, 64), the whole of M where M <= 128, so the depthwise stage runs
    Mp / bM <= 2 times per (strip, channel) there (here once)."""
    ct = pt_tf.cook_toom(4, 3)
    g = pt_wg.conv2d_geometry(res, res, 3, 3, 4, 4, "SAME")
    s = pt_wg.separable_geometry(g.n_h, g.n_w, c, m, ct, ct, batch=batch)
    assert pt_wg.separable_blocking_fits(ct, ct, s.bh, s.bw, s.block_c,
                                         s.block_m)
    assert s.block_m >= min(m, 64)
    if m <= 128:
        assert s.m_pad // s.block_m == 1 <= 2
    assert s.n_hb * s.bh * 4 == g.n_h * 4 + s.pad_h
    assert s.n_wb * s.bw * 4 == g.n_w * 4 + s.pad_w
    assert c <= s.c_pad < c + s.block_c and m <= s.m_pad < m + s.block_m


_F43, _F23 = pt_tf.cook_toom(4, 3), pt_tf.cook_toom(2, 3)
_F63 = pt_tf.cook_toom(6, 3)


@pytest.mark.parametrize("ct,bh,bw,bc,bm,u_size,fits", [
    (_F43, 4, 4, 16, 16, 4, True),     # conv5_x's blocking
    (_F43, 2, 8, 8, 32, 4, True),
    (_F23, 1, 16, 8, 64, 2, True),
    (_F63, 4, 4, 8, 16, 4, True),      # T = 8: the (1, 2) tile only
    (_F43, 2, 4, 8, 32, 4, False),     # 8 tiles: not a multiple of 16
    (_F43, 4, 4, 24, 16, 4, False),    # C step not 8 / 16 / 32
    (_F43, 4, 4, 8, 64, 4, False),     # (1, 8) not on T = 6's menu
    (_F43, 8, 2, 8, 20, 4, False),     # bm not in 8s
    (_F43, 16, 2, 32, 32, 4, False),   # (2, 4) at T = 6: off the menu
    (_F63, 4, 4, 8, 32, 4, False),     # (1, 4) at T = 8: off the menu
    (_F43, 4, 4, 32, 32, 4, False),    # 532 KB of shared memory
    (_F43, 2, 8, 32, 16, 4, False),    # 393 KB of shared memory
])
def test_stream_tc_blocking_fits_is_the_kernels_rule(ct, bh, bw, bc, bm,
                                                     u_size, fits):
    """stream_tc_blocking_fits mirrors winograd_tc.cuh's launcher and
    dispatch (winograd_strided_streamed_launch; winograd_streamed_launch
    past 6 x 6 tiles): the (T, bR/16, bM/8) menu, bc in 8 / 16 / 32, bw a
    power of two, 227 KB of shared memory."""
    assert pt_wg.stream_tc_blocking_fits(ct, ct, bh, bw, bc, bm,
                                         u_size) is fits


def test_stream_tc_smem_is_the_kernels_formula():
    """F(4, 3), 4 x 4 tiles, bc 16, bm 16, fp32: two strip stages of
    18 x 18 x 20 floats, two filter stages of 36 x 16 rows of 96 bytes,
    V 36 x 16 x 20 floats; the spill 36 x 16 x 20 floats is smaller."""
    want = 4 * (2 * 18 * 18 * 20 + 36 * 16 * 20) + 2 * 36 * 16 * 96
    assert pt_wg.stream_tc_smem_bytes(_F43, _F43, 4, 4, 16, 16) == want
    assert pt_wg.u_row_bytes(16, 4) == 96
    assert pt_wg.u_row_bytes(16, 2) == 32 and pt_wg.u_row_bytes(64, 1) == 96


_CSRC = (pathlib.Path(pt_wg.__file__).resolve().parents[1] / "kernels"
         / "csrc")


def _header(name: str) -> str:
    return (_CSRC / name).read_text()


@pytest.mark.parametrize("ct,bh,bw,bc,bm,u_size,fits", [
    (_F43, 4, 4, 8, 64, 4, True),      # (1, 8) at T = 6: 223,552 bytes
    (_F43, 1, 16, 8, 64, 4, True),     # the menu's largest: 228,160 bytes
    (_F43, 4, 8, 8, 32, 4, True),      # (2, 4)
    (_F43, 4, 4, 8, 16, 1, True),      # (1, 2), int8: 16-byte rows
    (_F23, 4, 8, 8, 64, 2, True),      # (2, 8) at T = 4
    (_F43, 4, 4, 16, 16, 4, False),    # C step 16: the body takes 8 only
    (_F43, 4, 4, 8, 8, 4, False),      # (1, 1) not on T = 6's menu
    (_F43, 8, 4, 8, 64, 4, False),     # (2, 8) not on T = 6's menu
    (_F23, 4, 4, 8, 16, 4, False),     # (1, 2) not on T = 4's menu
    (_F43, 2, 4, 8, 16, 4, False),     # 8 tiles: not a multiple of 16
    (_F43, 4, 4, 8, 20, 4, False),     # bm not in 8s
    (_F63, 4, 4, 8, 16, 4, False),     # T = 8: the shared body's tiles
])
def test_stream_ws_blocking_fits_is_the_kernels_rule(ct, bh, bw, bc, bm,
                                                     u_size, fits):
    """stream_ws_blocking_fits mirrors winograd_streamed_launch and
    winograd_ws.cuh's dispatch: a tile up to 6 x 6, the (T, bR/16, bM/8)
    menu, bc 8, bw a power of two, 227 KB of shared memory (which every
    blocking of the menu fits). Each rejected case fails one rule; the
    body-aware stream_blocking_fits agrees on these tiles."""
    assert pt_wg.stream_ws_blocking_fits(ct, ct, bh, bw, bc, bm,
                                         u_size) is fits
    if pt_wg.stream_body(ct, ct) == "ws":
        assert pt_wg.stream_blocking_fits(ct, ct, bh, bw, bc, bm,
                                          u_size) is fits


@pytest.mark.parametrize("ct,bh,bw,bm,u_size,want", [
    # the mbarriers; two strips of 18 x 18 x 8 floats, two V slots of
    # 36 x 16 x 8 floats, two filter chunks of 36 x 8 rows of 288 bytes
    (_F43, 4, 4, 64, 4,
     64 + 4 * (2 * 18 * 18 * 8 + 2 * 36 * 16 * 8) + 2 * 36 * 8 * 288),
    # (1, 2), fp32: rows of 96 bytes
    (_F43, 4, 4, 16, 4,
     64 + 4 * (2 * 18 * 18 * 8 + 2 * 36 * 16 * 8) + 2 * 36 * 8 * 96),
    # (2, 8) at T = 4, bf16: the (16, 32, 68) accumulator spill outgrows
    # the ring (strips of 10 x 18 pixels, rows of 160 bytes: 85,312)
    (_F23, 4, 8, 64, 2, 64 + 4 * 16 * 32 * 68),
])
def test_stream_ws_smem_is_the_kernels_formula(ct, bh, bw, bm, u_size, want):
    """winograd_ws.cuh:smem_bytes: the ring during the C sweep, the
    accumulator spill after it, whichever is larger, behind 64 bytes of
    mbarriers."""
    assert pt_wg.stream_ws_smem_bytes(ct, ct, bh, bw, bm, u_size) == want


def test_stream_ws_menu_is_the_kernels_dispatch():
    """WINOGRAD_WS_CONFIGS is the (T, kMT, kNT) list of winograd_ws.cuh's
    REPRO_WS_CASE lines, and the warp split and C step the Python side
    counts with are the header's."""
    src = _header("winograd_ws.cuh")
    cases = re.findall(r"REPRO_WS_CASE\((\d+), (\d+), (\d+)\)", src)
    menu = {}
    for t, mt, nt in cases:
        menu.setdefault(int(t), []).append((int(mt), int(nt)))
    assert menu == {t: list(c) for t, c in pt_wg.WINOGRAD_WS_CONFIGS.items()}
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kConsumerWarps"]) == pt_wg.WS_CONSUMER_WARPS
    assert int(consts["kProducers"]) == pt_wg.WS_PRODUCERS
    assert int(consts["kBC"]) == pt_wg.WS_BLOCK_C
    assert int(consts["kBarBytes"]) == pt_wg.WS_BAR_BYTES


@pytest.mark.parametrize("m,r,phases,body", [
    (2, 3, 1, "ws"), (4, 3, 1, "ws"),  # the main path: T = 4, 6
    (2, 5, 1, "ws"), (2, 2, 1, "ws"),  # guarded: 6 x 6 on T = 6, 3 x 3 on 4
    (6, 3, 1, "tc"), (4, 4, 1, "tc"),  # 8 x 8 and 7 x 7: the shared body
    (4, 2, 4, "tc"),                   # stride 2: the shared body
])
def test_stream_body_routes_by_tile(m, r, phases, body):
    """stream_body is winograd_streamed_launch's routing: stride-1 tiles up
    to 6 x 6 on the warp-specialised body, everything else on the shared
    one; the launcher's tmax <= 6 test reads the same."""
    ct = pt_tf.cook_toom(m, r)
    assert pt_wg.stream_body(ct, ct, phases) == body
    assert "if (tmax <= 6) {" in _header("winograd_streamed.cu")


def test_ws_terms_count_a_step_of_eight_channels():
    """ws_block_terms: C steps of 8, the filter chunk and strip bytes a
    step, the busiest consumer warp's products (three a multiply-add, two
    for a widened filter), one transform item per producer thread at
    bR 16 and two at 32, one block an SM."""
    terms, waves, bps = pt_wg.ws_block_terms(_F43, _F43, 512, 512, 4, 4, 64,
                                             n_h=4, n_w=4, batch=32)
    assert terms["step"] == 64 and terms["block"] == 1 and bps == 1
    assert terms["load"] == 64 * (36 * 8 * 64 * 4 + 18 * 18 * 8 * 4)
    assert terms["mma"] == 64 * 5 * 1 * 8 * 3
    assert terms["xform"] == 64 * 1 * 6 ** 3
    assert waves == -(-(32 * 8) // pt_wg.H100_SMS)
    bf16 = pt_wg.ws_block_terms(_F43, _F43, 512, 512, 4, 8, 32, n_h=4,
                                n_w=4, batch=32, u_size=2)[0]
    assert bf16["mma"] == 64 * 5 * 2 * 4 * 2 and bf16["xform"] == 64 * 2 * 216


@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("name,res,c,m", VGG, ids=[v[0] for v in VGG])
def test_ws_chooser_on_vgg16(name, res, c, m, batch):
    """Every VGG-16 conv at the cells' batches (32 offline, the served
    buckets 1-8) plans onto the warp-specialised body with a blocking it
    takes that covers the tile grid exactly; at batch 32, from conv2_1 on
    (the layers where the shared body's chooser took bM 16), bM >= 32."""
    g = pt_wg.conv2d_geometry(res, res, 3, 3, 4, 4, "SAME")
    s = pt_wg.stream_geometry_tf32x3(g.n_h, g.n_w, c, m, _F43, _F43,
                                     batch=batch)
    assert pt_wg.stream_body(_F43, _F43) == "ws"
    assert pt_wg.stream_ws_blocking_fits(_F43, _F43, s.bh, s.bw, s.block_c,
                                         s.block_m)
    assert s.n_hb * s.bh * 4 == g.n_h * 4 + s.pad_h
    assert s.n_wb * s.bw * 4 == g.n_w * 4 + s.pad_w
    assert 0 <= s.pad_h < s.bh * 4 and 0 <= s.pad_w < s.bw * 4
    assert s.block_c == 8 and m <= s.m_pad < m + s.block_m
    if batch == 32 and [v[0] for v in VGG].index(name) >= 3:
        assert s.block_m >= 32


@pytest.mark.parametrize("layer,batch", list(WS_SWEEP_MS),
                         ids=[f"{n}-b{b}" for n, b in WS_SWEEP_MS])
def test_ws_chooser_picks_near_the_fastest_measured(layer, batch):
    """On the card's sweep of every blocking (tests/ws_sweep_h100.py), the
    chooser's pick is within 3 % of the fastest: at batch 32 the wide M
    blocks, at batch 1 the grid that one wave holds (a second wave at one
    block an SM costs more than the idle SMs of the first)."""
    _, res, c, m = next(v for v in VGG if v[0] == layer)
    g = pt_wg.conv2d_geometry(res, res, 3, 3, 4, 4, "SAME")
    s = pt_wg.stream_geometry_tf32x3(g.n_h, g.n_w, c, m, _F43, _F43,
                                     batch=batch)
    times = WS_SWEEP_MS[(layer, batch)]
    assert times[(s.bh, s.bw, s.block_m)] <= 1.03 * min(times.values())


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_vgg16_plans_report_the_ws_body(batch):
    """describe(kernel=True) of each VGG-16 conv plan names the warp-
    specialised body and its (bR, 8, bM) blocking, the plan's own; the
    default describe() row is the reference's columns alone."""
    for name, res, c, m in VGG:
        w = torch.zeros(3, 3, c, m)
        p = pt_plan.plan_conv2d((batch, res, res, c), w,
                                algorithm="pallas_winograd", device="cpu")
        row, s = p.describe(kernel=True), p.spec.stream
        assert row["body"] == "ws", name
        assert row["blocking"] == (s.bh * s.bw, 8, s.block_m)
        assert "body" not in p.describe()


@pytest.mark.parametrize("bh,bw,bc,bm,fits", [
    (1, 2, 128, 64, True),             # sep14's blocking
    (2, 2, 64, 24, True),              # M 24: whole, not a power of two
    (1, 1, 64, 160, True),
    (1, 1, 128, 160, False),           # 258 KB of shared memory
    (1, 1, 48, 64, False),             # C step not a power of two
    (1, 1, 256, 64, False),            # C step past 128
    (1, 1, 64, 20, False),             # bm not in 8s
    (1, 3, 64, 64, False),             # bw not a power of two
    (4, 4, 128, 256, False),           # 16 x 32 = 512 output tiles > 128
    (2, 2, 128, 128, False),           # shared memory past 227 KB
])
def test_separable_blocking_fits_is_the_kernels_rule(bh, bw, bc, bm, fits):
    """separable_blocking_fits mirrors separable_streamed_launch: bc a
    power of two in 8..128, bm in 8s, bw a power of two, S in 16s, at
    most 128 (16-pixel, 8-channel) output tiles, 227 KB of shared memory."""
    assert pt_wg.separable_blocking_fits(_F43, _F43, bh, bw, bc, bm) is fits


def test_separable_block_m_keeps_the_depthwise_passes_few():
    """The whole of M up to 128 (rounded up to 8); past it, widths of at
    least 64 that divide M or are 64 / 128."""
    assert pt_wg.separable_block_m(16) == [16]
    assert pt_wg.separable_block_m(24) == [24]
    assert pt_wg.separable_block_m(70) == [72]
    assert pt_wg.separable_block_m(160) == [64, 80, 128, 160]
    assert all(b >= 64 for b in pt_wg.separable_block_m(1024))


@pytest.mark.parametrize("name,m,k,n,dtype", MATMULS,
                         ids=[f"{v[0]}-{v[4]}" for v in MATMULS])
def test_matmul_chooser_on_mobilenets(name, m, k, n, dtype):
    """The GEMM chooser's tile and K split for each matmul launch of the
    MobileNets' main paths: on the kernel's menu, a split that fits K, the
    same on a second call, with B padded by one rule to at most one column
    block more than N and K to whole K steps; a narrow N (16, 24, 32) is
    not padded to 64."""
    u_size = U_SIZES[dtype]
    bm, bk, bn, splits = pt_im2col.matmul_blocks(m, k, n, u_size=u_size)
    assert (bm, bn) in pt_im2col.MATMUL_TILES and bk == pt_im2col.MATMUL_BK
    assert splits in pt_im2col.MATMUL_SPLITS
    assert pt_im2col.matmul_split_fits(k, splits)
    assert pt_im2col.matmul_blocks(m, k, n, u_size=u_size) == \
        (bm, bk, bn, splits)
    kp, np_ = pt_im2col.matmul_b_shape(k, n, bn)
    assert kp % bk == 0 and k <= kp < k + bk
    assert np_ % bn == 0 and n <= np_ < n + bn
    if n <= 32:
        assert np_ <= 32
    assert pt_im2col.matmul_smem_bytes(bm, bn, u_size) <= pt_wg.TC_SMEM_MAX


@pytest.mark.parametrize("bm,bn,u_size,want", [
    (128, 64, 4, 3 * (4 * 128 * 36 + 32 * 288)),
    (32, 32, 4, 3 * (4 * 32 * 36 + 32 * 160)),
    (128, 16, 1, 3 * (4 * 128 * 36 + 32 * 32)),
    (64, 64, 2, 3 * (4 * 64 * 36 + 32 * 160)),
])
def test_matmul_smem_is_the_kernels_formula(bm, bn, u_size, want):
    """matmul.cu's Tile::kSmem: three stages of A (rows of 32 + 4 floats)
    and of raw B (32 rows of u_row_bytes)."""
    assert pt_im2col.matmul_smem_bytes(bm, bn, u_size) == want


@pytest.mark.parametrize("k,splits,fits", [
    (576, 6, True),                    # 18 K steps, 3 each
    (576, 4, True),                    # 5, 5, 5, 3
    (576, 8, False),                   # 3 each: 6 splits, two left empty
    (32, 1, True), (32, 2, False),     # one K step
    (1024, 8, True), (45, 2, True),    # 2 steps of a ragged K
    (100, 0, False),
])
def test_matmul_split_fits_is_the_kernels_rule(k, splits, fits):
    """matmul_split_fits mirrors matmul_launch: ceil(steps / splits) steps
    a split, and no split left without one."""
    assert pt_im2col.matmul_split_fits(k, splits) is fits


def test_matmul_tiles_are_the_kernels_menu():
    """Each tile splits into whole m16n8 fragments per warp, at 128 or 256
    threads, and its B rows copy in 16-byte pieces at every dtype."""
    for (bm, bn), (wm, wn) in pt_im2col.MATMUL_TILES.items():
        assert bm % (16 * wm) == 0 and bn % (8 * wn) == 0
        assert 32 * wm * wn in (128, 256)
        assert bn % 16 == 0


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("dtype", list(U_SIZES))
def test_strided_chooser_on_the_stems(dtype, batch):
    """The MobileNet stem (224 x 224 x 3 -> 32, stride 2) at F(4, 2) (fp32)
    and F(2, 2) (bf16 / int8): the tensor-core chooser with phases=4 gives a
    blocking the kernel takes that covers the phase grid, C = 3 padded to
    one C step of 8, M = 32 to at most one M block."""
    mt = 4 if dtype == "float32" else 2
    ct = pt_tf.cook_toom(mt, 2)
    g = pt_wg.conv2d_strided_geometry(RES, RES, 3, 3, mt, mt, "SAME")
    s = pt_wg.stream_geometry_tf32x3(g.n_h, g.n_w, 3, 32, ct, ct,
                                     batch=batch, u_size=U_SIZES[dtype],
                                     phases=4)
    assert pt_wg.stream_tc_blocking_fits(ct, ct, s.bh, s.bw, s.block_c,
                                         s.block_m, U_SIZES[dtype])
    assert s.n_hb * s.bh * mt == g.n_h * mt + s.pad_h
    assert s.n_wb * s.bw * mt == g.n_w * mt + s.pad_w
    assert s.block_c == s.c_pad == 8 and s.m_pad == 32


def test_strided_terms_count_four_phases():
    """phases=4 multiplies the C steps and every per-step term by four and
    leaves the blocks and their waves as they are."""
    ct = pt_tf.cook_toom(4, 2)
    one = pt_wg.tc_block_terms(ct, ct, 3, 32, 4, 4, 8, 32, n_h=28, n_w=28,
                               batch=4)
    four = pt_wg.tc_block_terms(ct, ct, 3, 32, 4, 4, 8, 32, n_h=28, n_w=28,
                                batch=4, phases=4)
    assert four[1:] == one[1:]
    for key in ("step", "load", "mma", "xform"):
        assert four[0][key] == 4 * one[0][key]
    assert four[0]["tail"] == one[0]["tail"]


def _depthwise_layers() -> list[tuple[str, int, int]]:
    """(name, res, C) of every stride-1 depthwise conv of MobileNet-v1 and
    v2 at RES: the reduced-precision path's `depthwise_streamed` launches
    (MobileNet-v2's at the expanded width)."""
    out = []
    for net, specs in (("mobilenet_v1", cnn.mobilenet_v1()),
                       ("mobilenet_v2", cnn.mobilenet_v2())):
        res, c = RES, 3
        for spec in specs:
            if isinstance(spec, cnn.Conv):
                res, c = -(-res // spec.stride), spec.c_out
            elif isinstance(spec, (cnn.SeparableConv, cnn.InvertedResidual)):
                if spec.stride == 1:
                    out.append((f"{net}.{spec.name}", res,
                                c * getattr(spec, "expand", 1)))
                res, c = -(-res // spec.stride), spec.c_out
    return out


DEPTHWISE = _depthwise_layers()
#: The tiles-domain chooser's picks (block_r, block_c, block_m) for
#: VGG-16's 13 layers at F(4x4, 3x3), batch 4.
FUSED_PICKS = {"conv1_0": (16, 8, 32), "conv1_1": (16, 8, 32),
               "conv2_0": (16, 8, 32), "conv2_1": (16, 8, 32),
               "conv3_0": (16, 8, 32), "conv3_1": (16, 8, 32),
               "conv3_2": (16, 8, 32), "conv4_0": (16, 8, 32),
               "conv4_1": (16, 8, 32), "conv4_2": (16, 8, 32),
               "conv5_0": (16, 8, 16), "conv5_1": (16, 8, 16),
               "conv5_2": (16, 8, 16)}


@pytest.mark.parametrize("name,res,c,m", VGG, ids=[v[0] for v in VGG])
def test_fused_chooser_on_vgg16(name, res, c, m):
    """The materialized arm's blocking of each VGG-16 layer at batch 4:
    (16 kMT, bc, 8 kNT) on the tensor-core menu for T = 6, bc in 8 / 16 /
    32 and at most C rounded up to 8, within TC_SMEM_MAX, the same on a
    second call, and the listed pick."""
    g = pt_wg.conv2d_geometry(res, res, 3, 3, 4, 4, "SAME")
    r_tot = 4 * g.n_h * g.n_w
    br, bc, bm = pt_wg.winograd_blocks(r_tot, c, m, _F43, _F43)
    assert (br // 16, bm // 8) in pt_wg.WINOGRAD_TC_CONFIGS[6]
    assert br % 16 == 0 and bm % 8 == 0
    assert bc in pt_wg.WINOGRAD_TC_BLOCK_C and bc <= max(8, c)
    assert pt_wg.fused_smem_bytes(_F43, _F43, br, bc, bm) <= pt_wg.TC_SMEM_MAX
    assert pt_wg.fused_blocking_fits(_F43, _F43, br, bc, bm)
    assert pt_wg.winograd_blocks(r_tot, c, m, _F43, _F43) == (br, bc, bm)
    assert (br, bc, bm) == FUSED_PICKS[name]


@pytest.mark.parametrize("ct,br,bc,bm,fits", [
    (_F43, 16, 8, 16, True),           # conv5_x's blocking
    (_F43, 32, 8, 16, True),           # (2, 2) at T = 6: 216 KB
    (_F23, 16, 16, 64, True),          # (1, 8) at T = 4
    (_F43, 24, 8, 16, False),          # 24 tiles: not a multiple of 16
    (_F43, 16, 8, 12, False),          # bm not in 8s
    (_F43, 16, 24, 16, False),         # C step not 8 / 16 / 32
    (_F43, 16, 8, 64, False),          # (1, 8) not on T = 6's menu
    (_F63, 16, 8, 8, True),            # (1, 1) at T = 8: the tiles' entry
    (_F63, 16, 8, 32, False),          # (1, 4) at T = 8: off the menu
    (_F63, 16, 8, 16, False),          # (1, 2) at T = 8: 240 KB
    (_F43, 16, 16, 16, False),         # 243 KB of shared memory
    (_F23, 16, 32, 32, False),         # 268 KB of shared memory
])
def test_fused_blocking_fits_is_the_kernels_rule(ct, br, bc, bm, fits):
    """fused_blocking_fits mirrors winograd_fused_launch and the shared
    dispatch: the (T, bR/16, bM/8) menu (the streamed kernels' and its own
    (8, 1, 1)), bc in 8 / 16 / 32, 227 KB of shared memory. Each rejected
    case fails one rule."""
    assert pt_wg.fused_blocking_fits(ct, ct, br, bc, bm) is fits


def test_fused_smem_is_the_kernels_formula():
    """F(4, 3), 16 tiles, bc 8, bm 32: two tile stages of 16 x 36 x 12
    floats, V 36 x 16 x 12 floats and two filter stages of 36 x 8 rows of
    160 bytes; the spill 36 x 16 x 36 floats is smaller."""
    want = 4 * (2 * 16 * 36 * 12 + 36 * 16 * 12) + 2 * 36 * 8 * 160
    assert pt_wg.fused_smem_bytes(_F43, _F43, 16, 8, 32) == want
    assert want > 4 * 36 * 16 * 36


def test_fused_terms_replace_the_strip_by_the_tile_stage():
    """The tiles-domain model stages bR * P pixels a step where the streamed
    one stages the strip; the products and transforms are the streamed
    kernel's for the same block shape."""
    terms, waves, bps = pt_wg.fused_block_terms(_F43, _F43, 3136, 64, 64,
                                                16, 8, 32)
    assert terms["step"] == 8 and terms["block"] == 1
    assert terms["load"] == 8 * (36 * 8 * 32 * 4 + 16 * 36 * 8 * 4)
    assert waves == -(-(196 * 2) // (pt_wg.H100_SMS * bps))
    streamed = pt_wg.tc_block_terms(_F43, _F43, 64, 64, 4, 4, 8, 32, n_h=14,
                                    n_w=14, batch=4)[0]
    for key in ("mma", "xform", "tail"):
        assert terms[key] == streamed[key]


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("name,res,c", DEPTHWISE,
                         ids=[d[0] for d in DEPTHWISE])
def test_depthwise_chooser_on_mobilenets(name, res, c, batch):
    """The stride-1 depthwise chooser at F(2, 3) (the reduced path's tile)
    on every stride-1 depthwise layer: a blocking the kernel takes, whole
    strips covering the tile grid, C padded by less than one C step, bc at
    most C rounded up to 8, and block_m = block_c (mult 1)."""
    g = pt_wg.conv2d_geometry(res, res, 3, 3, 2, 2, "SAME")
    s = pt_wg.stream_geometry_depthwise(g.n_h, g.n_w, c, _F23, _F23,
                                        batch=batch)
    assert pt_wg.depthwise_blocking_fits(_F23, _F23, s.bh, s.bw, s.block_c)
    assert s.n_hb * s.bh * 2 == g.n_h * 2 + s.pad_h >= g.n_h * 2
    assert s.n_wb * s.bw * 2 == g.n_w * 2 + s.pad_w >= g.n_w * 2
    assert c <= s.c_pad < c + s.block_c and s.c_pad % s.block_c == 0
    assert s.block_c <= -(-c // 8) * 8
    assert (s.block_m, s.m_pad) == (s.block_c, s.c_pad)


def test_depthwise_layer_list_is_the_main_path():
    """9 + 13 stride-1 depthwise launches (PERF.md's counts), the first
    of each at 112 x 112 x 32."""
    assert sum(n.startswith("mobilenet_v1") for n, *_ in DEPTHWISE) == 9
    assert sum(n.startswith("mobilenet_v2") for n, *_ in DEPTHWISE) == 13
    assert DEPTHWISE[0] == ("mobilenet_v1.sep2", 112, 32)
    assert ("mobilenet_v2.ir1", 112, 32) in DEPTHWISE


@pytest.mark.parametrize("ct,bh,bw,bc,mult,fits", [
    (_F23, 4, 8, 32, 1, True),
    (_F23, 3, 4, 64, 2, True),         # bh any, bw a power of two
    (_F63, 2, 2, 64, 1, True),         # T = 8: 14 x 14 x 64 floats
    (_F23, 4, 3, 32, 1, False),        # bw not a power of two
    (_F23, 4, 4, 48, 1, False),        # C step not a power of two
    (_F23, 4, 4, 4, 1, False),         # C step below one 16-byte copy
    (_F23, 4, 4, 128, 1, False),       # C step past 64
    (_F23, 16, 16, 64, 1, False),      # 34 x 34 x 64 floats: 293 KB
    (_F23, 2, 2, 64, 250, False),      # the taps of 250 multipliers
])
def test_depthwise_blocking_fits_is_the_kernels_rule(ct, bh, bw, bc, mult,
                                                     fits):
    """depthwise_blocking_fits mirrors depthwise_streamed_launch: bc a
    power of two in 8..64, bw a power of two, 227 KB of shared memory
    (strip, taps, scale and bias rows). Each rejected case fails one
    rule."""
    assert pt_wg.depthwise_blocking_fits(ct, ct, bh, bw, bc, mult) is fits


def test_depthwise_smem_and_channels_per_thread():
    """depthwise_streamed.cu's shared memory (the (4*2 + 2) x (8*2 + 2)
    strip of 32 channels, 16 taps and 2 epilogue rows per multiplier) and
    its channels per thread (a warp on one tile's bc channels, 2 at most)."""
    assert pt_wg.depthwise_smem_bytes(_F23, _F23, 4, 8, 32) == \
        4 * (10 * 18 * 32 + 18 * 32)
    assert pt_wg.depthwise_smem_bytes(_F23, _F23, 4, 8, 32, mult=2) == \
        4 * (10 * 18 * 32 + 2 * 18 * 32)
    assert [pt_wg.depthwise_cpt(bc) for bc in pt_wg.DEPTHWISE_BLOCK_C] == \
        [1, 1, 1, 2]


def _strided_depthwise_layers() -> list[tuple[str, int, int]]:
    """(name, res, C) of every stride-2 depthwise conv of MobileNet-v1 and
    v2 at RES: the `depthwise_strided_streamed` launches of every path
    (MobileNet-v2's at the expanded width)."""
    out = []
    for net, specs in (("mobilenet_v1", cnn.mobilenet_v1()),
                       ("mobilenet_v2", cnn.mobilenet_v2())):
        res, c = RES, 3
        for spec in specs:
            if isinstance(spec, cnn.Conv):
                res, c = -(-res // spec.stride), spec.c_out
            elif isinstance(spec, (cnn.SeparableConv, cnn.InvertedResidual)):
                if spec.stride == 2:
                    out.append((f"{net}.{spec.name}", res,
                                c * getattr(spec, "expand", 1)))
                res, c = -(-res // spec.stride), spec.c_out
    return out


STRIDED_DEPTHWISE = _strided_depthwise_layers()
#: The stride-2 chooser's picks (bh, bw, block_c) at batch 4, by layer and
#: path: fp32 (F(4, 2) per phase on the one large shallow layer, F(2, 2)
#: elsewhere) and bf16 / int8 (F(2, 2) everywhere).
STRIDED_DW_PICKS = {
    ("mobilenet_v1.sep3", "float32"): (4, 4, 16),
    ("mobilenet_v1.sep3", "reduced"): (2, 4, 64),
    ("mobilenet_v1.sep5", "float32"): (8, 8, 16),
    ("mobilenet_v1.sep5", "reduced"): (8, 8, 16),
    ("mobilenet_v1.sep7", "float32"): (4, 8, 16),
    ("mobilenet_v1.sep7", "reduced"): (4, 8, 16),
    ("mobilenet_v1.sep13", "float32"): (4, 4, 16),
    ("mobilenet_v1.sep13", "reduced"): (4, 4, 16),
    ("mobilenet_v2.ir2", "float32"): (4, 4, 32),
    ("mobilenet_v2.ir2", "reduced"): (4, 4, 32),
    ("mobilenet_v2.ir4", "float32"): (2, 16, 16),
    ("mobilenet_v2.ir4", "reduced"): (2, 16, 16),
    ("mobilenet_v2.ir7", "float32"): (4, 8, 16),
    ("mobilenet_v2.ir7", "reduced"): (4, 8, 16),
    ("mobilenet_v2.ir14", "float32"): (2, 4, 64),
    ("mobilenet_v2.ir14", "reduced"): (2, 4, 64),
}


def test_strided_depthwise_layer_list_is_the_main_path():
    """4 + 4 stride-2 depthwise launches per forward (PERF.md's counts),
    the first of each at 112 x 112."""
    assert [n for n, *_ in STRIDED_DEPTHWISE] == [
        "mobilenet_v1.sep3", "mobilenet_v1.sep5", "mobilenet_v1.sep7",
        "mobilenet_v1.sep13", "mobilenet_v2.ir2", "mobilenet_v2.ir4",
        "mobilenet_v2.ir7", "mobilenet_v2.ir14"]
    assert STRIDED_DEPTHWISE[0] == ("mobilenet_v1.sep3", 112, 64)
    assert STRIDED_DEPTHWISE[4] == ("mobilenet_v2.ir2", 112, 96)


@pytest.mark.parametrize("path", ["float32", "reduced"])
@pytest.mark.parametrize("name,res,c", STRIDED_DEPTHWISE,
                         ids=[d[0] for d in STRIDED_DEPTHWISE])
def test_strided_depthwise_chooser_on_mobilenets(name, res, c, path):
    """The stride-2 depthwise chooser on every stride-2 depthwise layer at
    the tile the planner resolves for the path (F(4, 2) per phase on large
    shallow fp32 layers, else F(2, 2)): at batch 4 the listed pick, and at
    batch 1 and 4 a blocking the kernel takes, whole strips covering the
    phase grid, C padded by less than one C step and block_m = block_c."""
    out = -(-res // 2)
    mt = 4 if (path == "float32" and out >= 24 and c <= 64) else 2
    ct = pt_tf.cook_toom(mt, 2)
    g = pt_wg.conv2d_strided_geometry(res, res, 3, 3, mt, mt, "SAME")
    for batch in (1, 4):
        s = pt_wg.stream_geometry_depthwise(g.n_h, g.n_w, c, ct, ct,
                                            stride=2, batch=batch)
        assert pt_wg.depthwise_strided_blocking_fits(ct, ct, s.bh, s.bw,
                                                     s.block_c)
        assert s.n_hb * s.bh * mt == g.n_h * mt + s.pad_h >= g.n_h * mt
        assert s.n_wb * s.bw * mt == g.n_w * mt + s.pad_w >= g.n_w * mt
        assert c <= s.c_pad < c + s.block_c and s.c_pad % s.block_c == 0
        assert s.block_c <= -(-c // 8) * 8
        assert (s.block_m, s.m_pad) == (s.block_c, s.c_pad)
        if batch == 4:
            assert (s.bh, s.bw, s.block_c) == STRIDED_DW_PICKS[(name, path)]


_F22 = pt_tf.cook_toom(2, 2)
_F42 = pt_tf.cook_toom(4, 2)


@pytest.mark.parametrize("ct,bh,bw,bc,fits", [
    (_F22, 4, 4, 32, True),
    (_F42, 3, 8, 16, True),            # bh any, bw a power of two
    (_F22, 4, 3, 32, False),           # bw not a power of two
    (_F22, 4, 4, 48, False),           # C step not a power of two
    (_F22, 4, 4, 4, False),            # C step below one 16-byte copy
    (_F22, 4, 4, 128, False),          # C step past 64
    (_F42, 8, 8, 64, False),           # 68 x 68 x 64 floats: 1.2 MB
])
def test_depthwise_strided_blocking_fits_is_the_kernels_rule(ct, bh, bw, bc,
                                                             fits):
    """depthwise_strided_blocking_fits mirrors
    depthwise_strided_streamed_launch: bc a power of two in 8..64, bw a
    power of two, 227 KB of shared memory (full-resolution strip, phase
    taps, scale and bias rows). Each rejected case fails one rule."""
    assert pt_wg.depthwise_strided_blocking_fits(ct, ct, bh, bw, bc) is fits


def test_depthwise_strided_smem_is_the_kernels_formula():
    """depthwise_strided_streamed.cu's shared memory at F(2, 2), 4 x 8
    tiles of 32 channels: the (2*(4*2 + 1)) x (2*(8*2 + 1)) full-resolution
    strip, 4 x 9 phase taps and 2 epilogue rows; at F(4, 2) the (2*(2*4 +
    1))^2 strip and 4 x 25 taps."""
    assert pt_wg.depthwise_strided_smem_bytes(_F22, _F22, 4, 8, 32) == \
        4 * (18 * 34 * 32 + (36 + 2) * 32)
    assert pt_wg.depthwise_strided_smem_bytes(_F42, _F42, 2, 2, 16) == \
        4 * (18 * 18 * 16 + (100 + 2) * 16)


def test_depthwise_strided_terms_count_the_full_resolution_strip():
    """The stride-2 model stages the full-resolution window (its bytes and
    pixels), stores the block's outputs and counts a thread's items times
    T^4, an item's channels side by side on the F(2, 2) body and one
    after another on the others; its waves are the busiest SM's blocks
    over the blocks it holds at once."""
    terms, waves, bps = pt_wg.depthwise_strided_block_terms(
        _F22, _F22, 128, 4, 4, 64, n_h=14, n_w=14, batch=4)
    assert terms["load"] == 4 * 18 * 18 * 64 and terms["pix"] == 18 * 18
    assert terms["store"] == 4 * 8 * 8 * 64
    assert terms["item"] == 2 * 3 ** 4  # 4 * 4 * 64 / (2 * 256) items
    assert terms["block"] == 1
    assert bps == min(pt_wg.DEPTHWISE_BLOCKS_PER_SM[3],
                      pt_wg.TC_SMEM_PER_SM // (
                          pt_wg.depthwise_strided_smem_bytes(
                              _F22, _F22, 4, 4, 64) + 1024))
    assert waves == 1 / bps            # 128 blocks: one per SM at most
    terms, waves, bps = pt_wg.depthwise_strided_block_terms(
        _F42, _F42, 64, 2, 2, 64, n_h=14, n_w=14, batch=4)
    assert terms["item"] == 2 * 5 ** 4  # 2 channels one after another
    assert waves == 2 / bps            # 4 * 7 * 7 = 196 blocks
