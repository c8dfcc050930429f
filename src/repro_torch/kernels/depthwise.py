"""Depthwise (stride 1 and 2) and fused separable convolution: the CUDA
kernels' wrappers and their plain PyTorch versions.

`depthwise_streamed` replaces repro/kernels/depthwise.py:depthwise_streamed,
`depthwise_strided_streamed` its depthwise_strided_streamed and
`separable_streamed` its separable_streamed, the Pallas TPU kernels. On a
CUDA tensor each launches its hand-written kernel
(csrc/depthwise_streamed.cu, csrc/depthwise_strided_streamed.cu,
csrc/separable_streamed.cu, built at first use) or raises; on a CPU tensor
it runs its plain version, the same arithmetic in plain PyTorch. Each takes
the operands the reference kernel takes and returns the same NHWC block
grid; the caller (ops.py) pads the input and crops the output.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import winograd as _wg
from repro_torch.core.transforms import CookToom
from repro_torch.kernels import build
from repro_torch.kernels.runtime import (ACTIVATIONS, check_activations,
                                         check_operands, kernel_epilogue)
from repro_torch.kernels.winograd import (U_TYPES, block_geometry,
                                          padded_mats, strip_grid)

_F32 = (torch.float32,)
_P, _I = ctypes.c_void_p, ctypes.c_int
_DW_ARGTYPES = (_P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                _I, _I, _I, _I, _I, _P, _P)
_DW1_ARGTYPES = _DW_ARGTYPES[:11] + (_I,) + _DW_ARGTYPES[11:]
_SEP_ARGTYPES = (_P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P)


def _check_taps(xp: torch.Tensor, u: torch.Tensor, points: int) -> None:
    if u.dim() != 2 or u.shape != (points, xp.shape[3]):
        raise ValueError(f"taps {tuple(u.shape)} do not match ({points}, "
                         f"{xp.shape[3]}) for input {tuple(xp.shape)}")


def _tap_mult(xp: torch.Tensor, u: torch.Tensor, points: int) -> int:
    """The channel multiplier of (P, Cp, mult) taps; raises unless they
    match the input."""
    if u.dim() != 3 or u.shape[:2] != (points, xp.shape[3]):
        raise ValueError(f"taps {tuple(u.shape)} do not match ({points}, "
                         f"{xp.shape[3]}, mult) for input {tuple(xp.shape)}")
    return u.shape[2]


def _check_epilogue(bias, scale, channels: int) -> None:
    if bias is not None and (bias.dim() != 1 or bias.shape[0] > channels):
        raise ValueError(f"bias must be 1-D with at most {channels} entries")
    if scale is not None and scale.numel() != channels:
        raise ValueError(f"scale must hold {channels} entries")


def depthwise_streamed_plain(
    xp: torch.Tensor, u: torch.Tensor, bias: torch.Tensor | None,
    scale: torch.Tensor | None = None, *, ct_h: CookToom, ct_w: CookToom,
    bh: int, bw: int, activation: str = "none",
) -> torch.Tensor:
    """The stride-1 depthwise kernel's function in plain PyTorch: the
    depthwise executor (core/winograd.py:
    winograd_depthwise_conv2d_pretransformed) over the halo-padded input
    with the kernel's tiles, in fp32; then x scale, + bias, activation.
    `u` is the (P, Cp, mult) taps; output channel o = c * mult + j."""
    n_hb, n_wb = strip_grid(xp, ct_h, ct_w, bh, bw)
    _tap_mult(xp, u, ct_h.t * ct_w.t)
    out = _wg.winograd_depthwise_conv2d_pretransformed(
        xp.float(), u.reshape(ct_h.t, ct_w.t, *u.shape[1:]), ct_h, ct_w,
        geometry=block_geometry(n_hb, n_wb, bh, bw, ct_h, ct_w))
    return kernel_epilogue(out, bias, scale, activation)


def depthwise_streamed(
    xp: torch.Tensor,                  # (N, Hp, Wp, Cp) halo-padded NHWC fp32
    u: torch.Tensor,                   # (P, Cp, mult) fp32 / bf16 / int8
    bias: torch.Tensor | None,         # (<= Cp*mult,) fp32 bias, or None
    scale: torch.Tensor | None = None,  # (1, Cp*mult) fp32 int8 dequant
    *,
    ct_h: CookToom,
    ct_w: CookToom,
    bh: int,
    bw: int,
    block_c: int,
    activation: str = "none",
) -> torch.Tensor:
    """Stride-1 depthwise conv with channel multiplier `mult`: per tile and
    channel, input transform, Hadamard product with each of the channel's
    `mult` tap sets, inverse transform and the fused epilogue; output
    channel o = c * mult + j. The kernel stages each block's halo strip
    and taps in shared memory. `xp` must be padded so Hp = nHb*bh*mh +
    (th - mh) and likewise Wp, Cp a multiple of `block_c` (8 to 128, a
    power of two), bw a power of two (ops.py pads from the plan's
    StreamGeometry, core/winograd.py:stream_geometry_depthwise). Returns
    the (N, nHb*bh*mh, nWb*bw*mw, Cp*mult) output; the caller crops."""
    check_activations(activation)
    if xp.device.type == "cpu":
        return depthwise_streamed_plain(
            xp, u, bias, scale, ct_h=ct_h, ct_w=ct_w, bh=bh, bw=bw,
            activation=activation)
    if xp.device.type != "cuda":
        raise ValueError(f"depthwise_streamed runs on CUDA or CPU tensors, "
                         f"not {xp.device}")
    n_hb, n_wb = strip_grid(xp, ct_h, ct_w, bh, bw)
    n, hp, wp, cp = xp.shape
    mult = _tap_mult(xp, u, ct_h.t * ct_w.t)
    check_operands(xp.device, [("xp", xp, _F32), ("u", u, tuple(U_TYPES)),
                               ("bias", bias, _F32), ("scale", scale, _F32)])
    _check_epilogue(bias, scale, cp * mult)
    out = torch.empty((n, n_hb * bh * ct_h.m, n_wb * bw * ct_w.m, cp * mult),
                      dtype=torch.float32, device=xp.device)
    mats = padded_mats(ct_h, ct_w)      # held: the launch reads its memory
    launch, error = build.bind("depthwise_streamed.cu", "depthwise_streamed",
                               _DW1_ARGTYPES)
    with torch.cuda.device(xp.device):
        status = launch(
            xp.data_ptr(), u.data_ptr(), U_TYPES[u.dtype],
            bias.data_ptr() if bias is not None else None,
            bias.shape[0] if bias is not None else 0,
            scale.data_ptr() if scale is not None else None,
            out.data_ptr(), n, hp, wp, cp, mult, ct_h.t, ct_w.t, ct_h.m,
            ct_w.m, bh, bw, block_c, ACTIVATIONS.index(activation),
            mats.ctypes.data, torch.cuda.current_stream().cuda_stream)
    build.check_status("depthwise_streamed", status, error)
    depthwise_streamed.LAUNCHES += 1
    return out


def depthwise_strided_streamed_plain(
    xp: torch.Tensor, u: torch.Tensor, bias: torch.Tensor | None,
    scale: torch.Tensor | None = None, *, ct_h: CookToom, ct_w: CookToom,
    bh: int, bw: int, activation: str = "none",
) -> torch.Tensor:
    """The stride-2 depthwise kernel's function in plain PyTorch: the
    phase-decomposed executor (core/winograd.py:
    winograd_strided_conv2d_pretransformed, groups = C) over the halo-padded
    full-resolution input with the kernel's tiles, in fp32; then x scale,
    + bias, activation. `u` is the (4P, Cp) phase-major taps."""
    n_hb, n_wb = strip_grid(xp, ct_h, ct_w, bh, bw, stride=2)
    _check_taps(xp, u, 4 * ct_h.t * ct_w.t)
    c = xp.shape[3]
    out = _wg.winograd_strided_conv2d_pretransformed(
        xp.float(), u.reshape(2, 2, ct_h.t, ct_w.t, c, 1), ct_h, ct_w,
        groups=c, geometry=block_geometry(n_hb, n_wb, bh, bw, ct_h, ct_w))
    return kernel_epilogue(out, bias, scale, activation)


def depthwise_strided_streamed(
    xp: torch.Tensor,                  # (N, Hp, Wp, Cp) padded full-res fp32
    u: torch.Tensor,                   # (4P, Cp) fp32 / bf16 / int8 taps
    bias: torch.Tensor | None,         # (<= Cp,) fp32 epilogue bias, or None
    scale: torch.Tensor | None = None,  # (1, Cp) fp32 int8 dequant scale
    *,
    ct_h: CookToom,
    ct_w: CookToom,
    bh: int,
    bw: int,
    block_c: int,
    activation: str = "none",
) -> torch.Tensor:
    """Stride-2 depthwise conv (channel multiplier 1) by transform-domain
    phase decomposition: four phase transforms and Hadamard products per
    tile, summed before one inverse transform and the fused epilogue. The
    kernel stages each block's full-resolution halo strip and taps in
    shared memory. `xp` must be padded so Hp = 2*(nHb*bh*mh + th - mh)
    and likewise Wp, Cp a multiple of `block_c` (8 to 64, a power of
    two), bw a power of two (ops.py pads from the plan's StreamGeometry,
    core/winograd.py:stream_geometry_depthwise with stride=2). Returns the
    (N, nHb*bh*mh, nWb*bw*mw, Cp) stride-2 output; the caller crops."""
    check_activations(activation)
    if xp.device.type == "cpu":
        return depthwise_strided_streamed_plain(
            xp, u, bias, scale, ct_h=ct_h, ct_w=ct_w, bh=bh, bw=bw,
            activation=activation)
    if xp.device.type != "cuda":
        raise ValueError(f"depthwise_strided_streamed runs on CUDA or CPU "
                         f"tensors, not {xp.device}")
    n_hb, n_wb = strip_grid(xp, ct_h, ct_w, bh, bw, stride=2)
    _check_taps(xp, u, 4 * ct_h.t * ct_w.t)
    n, hp, wp, cp = xp.shape
    check_operands(xp.device, [("xp", xp, _F32), ("u", u, tuple(U_TYPES)),
                               ("bias", bias, _F32), ("scale", scale, _F32)])
    _check_epilogue(bias, scale, cp)
    out = torch.empty((n, n_hb * bh * ct_h.m, n_wb * bw * ct_w.m, cp),
                      dtype=torch.float32, device=xp.device)
    mats = padded_mats(ct_h, ct_w)      # held: the launch reads its memory
    launch, error = build.bind("depthwise_strided_streamed.cu",
                               "depthwise_strided_streamed", _DW_ARGTYPES)
    with torch.cuda.device(xp.device):
        status = launch(
            xp.data_ptr(), u.data_ptr(), U_TYPES[u.dtype],
            bias.data_ptr() if bias is not None else None,
            bias.shape[0] if bias is not None else 0,
            scale.data_ptr() if scale is not None else None,
            out.data_ptr(), n, hp, wp, cp, ct_h.t, ct_w.t, ct_h.m, ct_w.m,
            bh, bw, block_c, ACTIVATIONS.index(activation),
            mats.ctypes.data, torch.cuda.current_stream().cuda_stream)
    build.check_status("depthwise_strided_streamed", status, error)
    depthwise_strided_streamed.LAUNCHES += 1
    return out


def separable_streamed_plain(
    xp: torch.Tensor, u_dw: torch.Tensor, u_pw: torch.Tensor,
    bias_dw: torch.Tensor | None, bias_pw: torch.Tensor | None, *,
    ct_h: CookToom, ct_w: CookToom, bh: int, bw: int,
    inner_activation: str = "none", activation: str = "none",
) -> torch.Tensor:
    """The fused separable kernel's function in plain PyTorch: the depthwise
    executor (core/winograd.py:winograd_depthwise_conv2d_pretransformed)
    over the halo-padded input with the kernel's tiles, + bias_dw,
    inner activation, then the pointwise matmul with u_pw, + bias_pw,
    activation, all in fp32."""
    n_hb, n_wb = strip_grid(xp, ct_h, ct_w, bh, bw)
    _check_taps(xp, u_dw, ct_h.t * ct_w.t)
    cp = xp.shape[3]
    z = _wg.winograd_depthwise_conv2d_pretransformed(
        xp.float(), u_dw.reshape(ct_h.t, ct_w.t, cp, 1), ct_h, ct_w,
        geometry=block_geometry(n_hb, n_wb, bh, bw, ct_h, ct_w))
    z = kernel_epilogue(z, bias_dw, None, inner_activation)
    return kernel_epilogue(torch.matmul(z, u_pw.float()), bias_pw, None,
                           activation)


def separable_streamed(
    xp: torch.Tensor,                  # (N, Hp, Wp, Cp) halo-padded NHWC fp32
    u_dw: torch.Tensor,                # (P, Cp) fp32 depthwise taps
    u_pw: torch.Tensor,                # (Cp, Mp) fp32 pointwise matrix
    bias_dw: torch.Tensor | None,      # (<= Cp,) fp32, or None
    bias_pw: torch.Tensor | None,      # (<= Mp,) fp32, or None
    *,
    ct_h: CookToom,
    ct_w: CookToom,
    bh: int,
    bw: int,
    block_c: int,
    block_m: int,
    inner_activation: str = "none",
    activation: str = "none",
) -> torch.Tensor:
    """Fused separable block over the halo-padded input: depthwise Winograd
    + bias / inner activation + pointwise 1x1 + bias / activation in one
    kernel; the depthwise output never leaves the chip. `xp` must be padded
    so Hp = nHb*bh*mh + (th - mh) and likewise Wp, Cp a multiple of
    `block_c` and Mp of `block_m` (ops.py pads from the plan's
    StreamGeometry). Returns (N, nHb*bh*mh, nWb*bw*mw, Mp); the caller crops
    the geometry surplus."""
    check_activations(inner_activation, activation)
    if xp.device.type == "cpu":
        return separable_streamed_plain(
            xp, u_dw, u_pw, bias_dw, bias_pw, ct_h=ct_h, ct_w=ct_w, bh=bh,
            bw=bw, inner_activation=inner_activation, activation=activation)
    if xp.device.type != "cuda":
        raise ValueError(f"separable_streamed runs on CUDA or CPU tensors, "
                         f"not {xp.device}")
    n_hb, n_wb = strip_grid(xp, ct_h, ct_w, bh, bw)
    _check_taps(xp, u_dw, ct_h.t * ct_w.t)
    n, hp, wp, cp = xp.shape
    if u_pw.dim() != 2 or u_pw.shape[0] != cp:
        raise ValueError(f"u_pw {tuple(u_pw.shape)} must be ({cp}, Mp)")
    mp = u_pw.shape[1]
    check_operands(xp.device, [
        ("xp", xp, _F32), ("u_dw", u_dw, _F32), ("u_pw", u_pw, _F32),
        ("bias_dw", bias_dw, _F32), ("bias_pw", bias_pw, _F32)])
    for name, b, limit in (("bias_dw", bias_dw, cp), ("bias_pw", bias_pw, mp)):
        if b is not None and (b.dim() != 1 or b.shape[0] > limit):
            raise ValueError(f"{name} must be 1-D with at most {limit} "
                             f"entries")
    out = torch.empty((n, n_hb * bh * ct_h.m, n_wb * bw * ct_w.m, mp),
                      dtype=torch.float32, device=xp.device)
    mats = padded_mats(ct_h, ct_w)      # held: the launch reads its memory
    launch, error = build.bind("separable_streamed.cu", "separable_streamed",
                               _SEP_ARGTYPES)
    with torch.cuda.device(xp.device):
        status = launch(
            xp.data_ptr(), u_dw.data_ptr(), u_pw.data_ptr(),
            bias_dw.data_ptr() if bias_dw is not None else None,
            bias_dw.shape[0] if bias_dw is not None else 0,
            bias_pw.data_ptr() if bias_pw is not None else None,
            bias_pw.shape[0] if bias_pw is not None else 0,
            out.data_ptr(), n, hp, wp, cp, mp, ct_h.t, ct_w.t, ct_h.m,
            ct_w.m, bh, bw, block_c, block_m,
            ACTIVATIONS.index(inner_activation),
            ACTIVATIONS.index(activation),
            mats.ctypes.data, torch.cuda.current_stream().cuda_stream)
    build.check_status("separable_streamed", status, error)
    separable_streamed.LAUNCHES += 1
    return out


#: Kernel launches made through each wrapper (CUDA tensors only).
depthwise_streamed.LAUNCHES = 0
depthwise_strided_streamed.LAUNCHES = 0
separable_streamed.LAUNCHES = 0
