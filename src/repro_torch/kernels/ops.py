"""Planned-op wrappers around the kernels: they handle all padding and
blocking so callers never see alignment constraints.

The planned Winograd paths stream regions end-to-end inside the kernels
(winograd_conv2d_planned -> kernels.winograd.winograd_streamed, and the
stride-2, depthwise and separable counterparts): the only per-call device
tensors are the padded NHWC input and the NHWC output, with the scale +
bias + activation epilogue fused into the kernel's store. Biases are passed
unpadded; the kernels give the padded output channels no bias, so no
per-call bias copy exists either. The im2col path hands its row matrix to
the GEMM kernel unpadded; the kernel masks the ragged edges.

winograd_conv2d_planned_materialized is the pre-streaming executor, kept as
the A/B baseline of the streamed path: it materializes the (R, th, tw, C)
overlapping-tile tensor in device memory, runs the tiles-domain kernel
(kernels.winograd.winograd_fused) and un-tiles the output in a separate
pass. Its extra passes are the point of it.

ct_depthwise_causal_conv1d_planned runs the Mamba short conv on the
tiles-domain conv1d kernel (kernels.conv1d_ct.conv1d_ct_fused): it pads the
input causally and to the kernel's channel step, extracts the (B, S, t, Cp)
tiles in device memory and crops the output.

The unplanned wrappers (winograd_conv2d, im2col_conv2d, fft_conv2d,
winograd_f63_conv2d, ct_depthwise_causal_conv1d) are the JAX package's
per-call compatibility paths: each plans the layer on the input's device
(core.plan, whose choosers pick the kernel's blocking) and applies the
plan, so the filter is transformed on every call and a result equals the
planned one bitwise. winograd_conv2d runs 1xN / Nx1 / 1x1 filters on the
plain single-axis path instead, as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import im2col as _im2col
from repro_torch.core import winograd as _wg
from repro_torch.core.transforms import DEFAULT_OUTPUT_TILE
from repro_torch.kernels import conv1d_ct as _k_conv1d
from repro_torch.kernels import depthwise as _k_depthwise
from repro_torch.kernels import matmul as _k_matmul
from repro_torch.kernels import winograd as _k_winograd
from repro_torch.kernels.runtime import epilogue


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_streamed_input(x: torch.Tensor, geometry: _wg.Conv2DGeometry,
                       stream: _wg.StreamGeometry,
                       stride: int = 1) -> torch.Tensor:
    """A streamed kernel's input: NHWC `x` with the conv padding, the
    edge-block padding and C rounded up to the kernel's channel step. The
    geometry of a stride-2 plan is in full-resolution input units, so its
    edge-block padding is 2x the plan's output-tile surplus."""
    return F.pad(x, (0, stream.c_pad - x.shape[3],
                     geometry.lo_w, geometry.hi_w + stride * stream.pad_w,
                     geometry.lo_h, geometry.hi_h + stride * stream.pad_h))


def winograd_conv2d_planned(
    x: torch.Tensor,
    u: torch.Tensor,
    *,
    ct_h,
    ct_w,
    geometry: _wg.Conv2DGeometry,
    stream: _wg.StreamGeometry,
    c_out: int,
    bias: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    activation: str = "none",
) -> torch.Tensor:
    """Execute a planned streaming Winograd conv.

    `u` is the pre-transformed, pre-padded (P, Cp, Mp) filter (fp32, or a
    bf16/int8 reduced-precision copy -- the kernel widens it to fp32);
    `scale` is the plan's (1, Mp) int8 dequantization row or None. All
    geometry (conv padding, strip origins, edge-block padding, block sizes)
    was derived once at plan time. The per-call work is one NHWC pad, the
    kernel, and one crop.
    """
    y = _k_winograd.winograd_streamed(
        pad_streamed_input(x, geometry, stream), u, bias, scale, ct_h=ct_h,
        ct_w=ct_w, bh=stream.bh, bw=stream.bw, block_c=stream.block_c,
        block_m=stream.block_m, activation=activation)
    return y[:, :geometry.out_h, :geometry.out_w, :c_out]


def winograd_strided_conv2d_planned(
    x: torch.Tensor,
    u: torch.Tensor,
    *,
    ct_h,
    ct_w,
    geometry: _wg.Conv2DGeometry,
    stream: _wg.StreamGeometry,
    c_out: int,
    bias: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    activation: str = "none",
) -> torch.Tensor:
    """Execute a planned stride-2 streaming Winograd conv (transform-domain
    phase decomposition). `u` is the pre-transformed (4P, Cp, Mp)
    phase-major filter (fp32/bf16/int8); `scale` the (1, Mp) int8 dequant
    row or None."""
    y = _k_winograd.winograd_strided_streamed(
        pad_streamed_input(x, geometry, stream, stride=2), u, bias, scale,
        ct_h=ct_h, ct_w=ct_w, bh=stream.bh, bw=stream.bw,
        block_c=stream.block_c, block_m=stream.block_m,
        activation=activation)
    return y[:, :geometry.out_h, :geometry.out_w, :c_out]


def depthwise_strided_conv2d_planned(
    x: torch.Tensor,
    u: torch.Tensor,
    *,
    ct_h,
    ct_w,
    geometry: _wg.Conv2DGeometry,
    stream: _wg.StreamGeometry,
    c_out: int,
    bias: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    activation: str = "none",
) -> torch.Tensor:
    """Execute a planned stride-2 streamed depthwise conv: `u` is the
    (4P, Cp) phase-major taps (fp32/bf16/int8); `scale` the (1, Cp) int8
    dequant row or None; the blocking comes from the plan."""
    y = _k_depthwise.depthwise_strided_streamed(
        pad_streamed_input(x, geometry, stream, stride=2), u, bias, scale,
        ct_h=ct_h, ct_w=ct_w, bh=stream.bh, bw=stream.bw,
        block_c=stream.block_c, activation=activation)
    return y[:, :geometry.out_h, :geometry.out_w, :c_out]


def depthwise_conv2d_planned(
    x: torch.Tensor,
    u: torch.Tensor,
    *,
    ct_h,
    ct_w,
    geometry: _wg.Conv2DGeometry,
    stream: _wg.StreamGeometry,
    c_out: int,
    bias: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    activation: str = "none",
) -> torch.Tensor:
    """Execute a planned stride-1 streamed depthwise conv: `u` is the
    pre-padded (P, Cp, mult) taps (fp32/bf16/int8; output channel
    o = c * mult + j); `scale` the (1, Cp*mult) int8 dequant row or None.
    The per-call work is one NHWC pad, the kernel, one crop."""
    y = _k_depthwise.depthwise_streamed(
        pad_streamed_input(x, geometry, stream), u, bias, scale, ct_h=ct_h,
        ct_w=ct_w, bh=stream.bh, bw=stream.bw, block_c=stream.block_c,
        activation=activation)
    return y[:, :geometry.out_h, :geometry.out_w, :c_out]


def separable_conv2d_planned(
    x: torch.Tensor,
    u_dw: torch.Tensor,
    u_pw: torch.Tensor,
    *,
    ct_h,
    ct_w,
    geometry: _wg.Conv2DGeometry,
    stream: _wg.StreamGeometry,
    c_out: int,
    bias_dw: torch.Tensor | None = None,
    bias_pw: torch.Tensor | None = None,
    inner_activation: str = "none",
    activation: str = "none",
) -> torch.Tensor:
    """Execute a planned fused separable block (depthwise Winograd +
    epilogue + pointwise 1x1 + epilogue in one kernel; the intermediate
    never touches device memory). `u_dw` is the (P, Cp) depthwise taps,
    `u_pw` the (Cp, Mp) pointwise matrix, both pre-padded at plan time."""
    y = _k_depthwise.separable_streamed(
        pad_streamed_input(x, geometry, stream), u_dw, u_pw, bias_dw,
        bias_pw, ct_h=ct_h, ct_w=ct_w, bh=stream.bh, bw=stream.bw,
        block_c=stream.block_c, block_m=stream.block_m,
        inner_activation=inner_activation, activation=activation)
    return y[:, :geometry.out_h, :geometry.out_w, :c_out]


def pad_winograd_filter(u: torch.Tensor, block_c: int,
                        block_m: int) -> torch.Tensor:
    """Pad a (P, C, M) Winograd-domain filter to the kernel's block grid.
    Done once at plan time so apply() never touches the weights."""
    _, c, mout = u.shape
    return F.pad(u, (0, _round_up(mout, block_m) - mout,
                     0, _round_up(c, block_c) - c)).contiguous()


def extract_tiles(x: torch.Tensor, *, ct_h, ct_w,
                  geometry: _wg.Conv2DGeometry,
                  blocks: tuple[int, int, int]) -> torch.Tensor:
    """The tiles-domain kernel's input: NHWC `x` with the conv padding and
    C rounded up to the kernel's channel step, cut into the (R, th, tw, Cp)
    overlapping tiles in device memory, R padded to whole tile blocks."""
    n, c = x.shape[0], x.shape[3]
    br, bc, _ = blocks
    nh, nw = geometry.n_h, geometry.n_w
    xp = F.pad(x, (0, _round_up(c, bc) - c, geometry.lo_w, geometry.hi_w,
                   geometry.lo_h, geometry.hi_h))
    tiles = _wg._extract_tiles_1d(xp, 1, ct_h.t, ct_h.m, nh)
    tiles = _wg._extract_tiles_1d(tiles, 3, ct_w.t, ct_w.m, nw)
    tiles = tiles.transpose(2, 3).reshape(n * nh * nw, ct_h.t, ct_w.t,
                                          xp.shape[3])
    r_tot = tiles.shape[0]
    return F.pad(tiles, (0, 0, 0, 0, 0, 0, 0, _round_up(r_tot, br) - r_tot))


def winograd_conv2d_planned_materialized(
    x: torch.Tensor,
    u: torch.Tensor,
    *,
    ct_h,
    ct_w,
    geometry: _wg.Conv2DGeometry,
    blocks: tuple[int, int, int],
    c_out: int,
) -> torch.Tensor:
    """The pre-streaming planned executor, kept as the A/B baseline: pads
    the input (conv padding, C to the kernel's channel step), extracts the
    (R, th, tw, Cp) overlapping-tile tensor in device memory, pads R to
    whole tile blocks, runs the tiles-domain kernel on the (P, Cp, Mp)
    filter, then un-tiles the output with a transpose/reshape pass. No
    epilogue: the caller applies bias and activation. Every step the
    streamed path removes is here."""
    n, nh, nw = x.shape[0], geometry.n_h, geometry.n_w
    tiles = extract_tiles(x, ct_h=ct_h, ct_w=ct_w, geometry=geometry,
                          blocks=blocks)
    y = _k_winograd.winograd_fused(tiles, u, ct_h=ct_h, ct_w=ct_w,
                                   block_r=blocks[0], block_c=blocks[1],
                                   block_m=blocks[2])   # (Rp, mh, mw, Mp)
    y = y[:n * nh * nw, :, :, :c_out].reshape(n, nh, nw, ct_h.m, ct_w.m,
                                              c_out)
    y = y.transpose(2, 3).reshape(n, nh * ct_h.m, nw * ct_w.m, c_out)
    return y[:, :geometry.out_h, :geometry.out_w]


def pad_im2col_filter(b: torch.Tensor, block_n: int) -> torch.Tensor:
    """Pad the (khkwC, M) filter matrix to the GEMM kernel's B shape for a
    tile of `block_n` columns (core/im2col.py:matmul_b_shape), plan-time."""
    kk, mout = b.shape
    kp, np_ = _im2col.matmul_b_shape(kk, mout, block_n)
    return F.pad(b, (0, np_ - mout, 0, kp - kk)).contiguous()


def im2col_conv2d_planned(
    x: torch.Tensor,
    b: torch.Tensor,
    *,
    kh: int,
    kw: int,
    stride: tuple[int, int],
    padding: _wg.Padding,
    geometry: _im2col.Im2RowGeometry,
    blocks: tuple[int, int, int, int],
    c_out: int,
    bias: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    activation: str = "none",
) -> torch.Tensor:
    """Execute a planned im2row conv on the GEMM kernel: `b` is the
    pre-reshaped, pre-padded (Kp, Np) filter matrix (fp32/bf16/int8) for the
    plan's (block_m, bk, block_n, splits) tile and K split `blocks`;
    `scale` the (1, Np) int8 dequant row or None. A 1x1 stride-1 conv's row
    matrix is the input itself, reshaped. The bias + activation epilogue
    (and the dequant multiply) is fused into the kernel's store."""
    n = x.shape[0]
    if (kh, kw) == (1, 1) and tuple(stride) == (1, 1):
        a, (oh, ow) = x.reshape(-1, x.shape[3]), (geometry.oh, geometry.ow)
    else:
        a, (oh, ow) = _im2col.im2row(x, kh, kw, stride, padding, geometry)
    y = _k_matmul.matmul(a.contiguous(), b, bias, scale, n_out=c_out,
                         block_m=blocks[0], block_n=blocks[2],
                         splits=blocks[3], activation=activation)
    return y.reshape(n, oh, ow, c_out)


# ---------------------------------------------------------------------------
# Unplanned (per-call) conv2d wrappers
# ---------------------------------------------------------------------------

def _plan_and_apply(x: torch.Tensor, w: torch.Tensor, algorithm: str, *,
                    bias: torch.Tensor | None, activation: str,
                    **plan_kwargs) -> torch.Tensor:
    """Plan the layer under `algorithm` on x's device, then apply it."""
    from repro_torch.core.plan import plan_conv2d  # imports this module
    plan = plan_conv2d(x.shape, w, algorithm=algorithm, device=x.device,
                       **plan_kwargs)
    return plan.apply(x, bias=bias, activation=activation)


def winograd_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    output_tile: int | None = None,
    padding: _wg.Padding = "SAME",
    bias: torch.Tensor | None = None,
    activation: str = "none",
) -> torch.Tensor:
    """F(m x m, k x k) convolution on the streamed Winograd kernel, NHWC x
    HWIO -> NHWC, stride 1 (unplanned). 1xN / Nx1 / 1x1 filters run the
    plain single-axis path (core.winograd.winograd_conv2d), as in the JAX
    package."""
    kh, kw = w.shape[:2]
    if kh == 1 or kw == 1:
        mt = output_tile or DEFAULT_OUTPUT_TILE.get(max(kh, kw), 2)
        y = _wg.winograd_conv2d(x, torch.as_tensor(w, device=x.device),
                                output_tile=mt, padding=padding)
        return epilogue(y, bias, activation)
    return _plan_and_apply(x, w, "pallas_winograd", bias=bias,
                           activation=activation, padding=padding,
                           output_tile=output_tile)


def im2col_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int | tuple[int, int] = 1,
    padding: _wg.Padding = "SAME",
    bias: torch.Tensor | None = None,
    activation: str = "none",
) -> torch.Tensor:
    """im2row + GEMM on the matmul kernel, any stride (unplanned); the
    kernel's tile and K split come from core/im2col.py:matmul_blocks."""
    return _plan_and_apply(x, w, "pallas_im2col", bias=bias,
                           activation=activation, stride=stride,
                           padding=padding)


def fft_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    padding: _wg.Padding = "SAME",
    bias: torch.Tensor | None = None,
    activation: str = "none",
) -> torch.Tensor:
    """Overlap-tiled rfft2 convolution, plain PyTorch (unplanned)."""
    return _plan_and_apply(x, w, "fft", bias=bias, activation=activation,
                           padding=padding)


def winograd_f63_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    padding: _wg.Padding = "SAME",
    bias: torch.Tensor | None = None,
    activation: str = "none",
) -> torch.Tensor:
    """Large-tile F(6x6, 3x3) convolution with the power-of-two row-scaled
    transforms, plain PyTorch (unplanned; 3x3 stride 1 only)."""
    kh, kw = w.shape[0], w.shape[1]
    if (kh, kw) != (3, 3):
        raise ValueError(f"winograd_f63 covers 3x3 filters only, got "
                         f"{kh}x{kw}")
    return _plan_and_apply(x, w, "winograd_f63", bias=bias,
                           activation=activation, padding=padding)


# ---------------------------------------------------------------------------
# Depthwise causal Cook-Toom conv1d (Mamba short conv)
# ---------------------------------------------------------------------------

def conv1d_ct_blocks(c: int) -> tuple[int, int]:
    """(block_s, block_c) of the conv1d kernel, plan-time: block_c a power
    of two from 32 to 128 channels (C pads to a multiple of it), block_s
    the tiles that fill the block's 256 threads. The kernel masks the
    ragged S edge, so the tile count does not enter (the reference's
    chooser also blocked S)."""
    bc = 128 if c > 64 else (64 if c > 32 else 32)
    return _k_conv1d.THREADS // bc, bc


def conv1d_tiles(x: torch.Tensor, *, ct, n_tiles: int, pad_hi: int,
                 c_pad: int) -> torch.Tensor:
    """The conv1d kernel's input: (B, L, C) `x` padded causally by r - 1,
    on the right by `pad_hi` and in C to `c_pad`, cut into the
    (B, n_tiles, t, c_pad) overlapping tiles in device memory."""
    xp = F.pad(x, (0, c_pad - x.shape[2], ct.r - 1, pad_hi))
    return _wg._extract_tiles_1d(xp, 1, ct.t, ct.m, n_tiles).contiguous()


def ct_depthwise_causal_conv1d_planned(
    x: torch.Tensor,
    u: torch.Tensor,
    *,
    ct,
    n_tiles: int,
    pad_hi: int,
    blocks: tuple[int, int],
    c_in: int,
) -> torch.Tensor:
    """Planned executor: `u` is the pre-transformed, pre-padded (t, Cp)
    Cook-Toom-domain taps; tile count, padding and block sizes come from the
    plan (core.plan.plan_depthwise_conv1d). Pads x (B, L, C) causally by
    r - 1, on the right to whole tiles and in C to Cp, extracts the tiles,
    runs the kernel and crops to (B, L, C)."""
    b, length, c = x.shape
    bs, bc = blocks
    tiles = conv1d_tiles(x, ct=ct, n_tiles=n_tiles, pad_hi=pad_hi,
                         c_pad=u.shape[1])
    y = _k_conv1d.conv1d_ct_fused(tiles, u, ct=ct, block_s=bs, block_c=bc)
    y = y[:, :, :, :c_in].reshape(b, n_tiles * ct.m, c_in)
    return y[:, :length]


def ct_depthwise_causal_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    output_tile: int = 4,
) -> torch.Tensor:
    """(B, L, C) x (r, C) -> (B, L, C), causal, on the conv1d kernel.

    Unplanned: plans the "pallas" backend per call. Hold a
    core.plan.plan_depthwise_conv1d plan to make its decisions once."""
    from repro_torch.core.plan import plan_depthwise_conv1d  # imports this module
    return plan_depthwise_conv1d(x.shape, w, output_tile=output_tile,
                                 backend="pallas", device=x.device).apply(x)