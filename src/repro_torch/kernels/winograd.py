"""Winograd convolution kernels, halo-streaming at stride 1 and stride 2
and over pre-extracted tiles: the CUDA kernels' wrappers and their plain
PyTorch versions.

`winograd_streamed` replaces repro/kernels/winograd.py:winograd_streamed,
`winograd_strided_streamed` its winograd_strided_streamed and
`winograd_fused` its winograd_fused, the Pallas TPU kernels. On a CUDA
tensor each launches its hand-written kernel (csrc/winograd_streamed.cu,
csrc/winograd_strided_streamed.cu, csrc/winograd_fused.cu, built at first
use, see build.py) or raises; on a CPU tensor it runs its plain version,
the same arithmetic in plain PyTorch. Each takes the operands the
reference kernel takes and returns the same result: the streamed kernels
an NHWC block grid whose input the caller (ops.py) pads and whose output
it crops, `winograd_fused` the (R, mh, mw, Mp) output tiles. All three
run on the tensor cores in TF32x3: the stride-1 kernel's tiles up to 6 x 6
on its warp-specialised body (csrc/winograd_ws.cuh), everything else on
the shared one (csrc/winograd_tc.cuh).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import winograd as _wg
from repro_torch.core.transforms import CookToom
from repro_torch.kernels import build
from repro_torch.kernels.runtime import (ACTIVATIONS, check_activations,
                                         check_operands, kernel_epilogue)

#: Filter dtypes the kernels widen to fp32, by their C type code.
U_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_F32 = (torch.float32,)
_MAX_T = 8
_P, _I = ctypes.c_void_p, ctypes.c_int
#: C signature of the streamed launchers (winograd_streamed.cu and
#: winograd_strided_streamed.cu).
_ARGTYPES = (_P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I,
             _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P)
_FUSED_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                   _P)


def strip_grid(xp: torch.Tensor, ct_h: CookToom, ct_w: CookToom, bh: int,
               bw: int, stride: int = 1) -> tuple[int, int]:
    """(n_hb, n_wb) strip counts of a halo-padded input whose strips cover
    (bh, bw) tiles at input `stride`; raises on a mismatch."""
    _, hp, wp, _ = xp.shape
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    n_hb, rh = divmod(hp - stride * (th - mh), stride * bh * mh)
    n_wb, rw = divmod(wp - stride * (tw - mw), stride * bw * mw)
    if rh or rw or n_hb < 1 or n_wb < 1:
        raise ValueError(
            f"input {tuple(xp.shape)} and tiles F({mh}x{mw}, "
            f"{ct_h.r}x{ct_w.r}) in {bh}x{bw} tile blocks at stride {stride} "
            f"do not match")
    return n_hb, n_wb


def _grid(xp: torch.Tensor, u: torch.Tensor, ct_h: CookToom,
          ct_w: CookToom, bh: int, bw: int,
          stride: int = 1) -> tuple[int, int]:
    """strip_grid, after checking u holds stride^2 phase banks of P points
    over xp's channels; raises on a mismatch."""
    p, c2, _ = u.shape
    if p != stride * stride * ct_h.t * ct_w.t or xp.shape[3] != c2:
        raise ValueError(
            f"operands xp {tuple(xp.shape)} / u {tuple(u.shape)} do not "
            f"match tiles F({ct_h.m}x{ct_w.m}, {ct_h.r}x{ct_w.r}) at "
            f"stride {stride}")
    return strip_grid(xp, ct_h, ct_w, bh, bw, stride)


def block_geometry(n_hb: int, n_wb: int, bh: int, bw: int, ct_h: CookToom,
                   ct_w: CookToom) -> _wg.Conv2DGeometry:
    """The Conv2DGeometry of a kernel's whole block grid over its
    halo-padded input: no further padding, every tile kept. The plain
    versions run the core executors with it, so their tiles are exactly
    the kernel's."""
    n_h, n_w = n_hb * bh, n_wb * bw
    return _wg.Conv2DGeometry(0, 0, n_h, 0, 0, n_w, n_h * ct_h.m,
                              n_w * ct_w.m)


def winograd_streamed_plain(
    xp: torch.Tensor, u: torch.Tensor, bias: torch.Tensor | None,
    scale: torch.Tensor | None = None, *, ct_h: CookToom, ct_w: CookToom,
    bh: int, bw: int, activation: str = "none",
) -> torch.Tensor:
    """The stride-1 kernel's function in plain PyTorch: the region-wise
    executor (core/winograd.py:winograd_conv2d_pretransformed) over the
    halo-padded input with the kernel's tiles, in fp32; then x scale,
    + bias, activation. `bias` may be shorter than Mp (the missing
    channels get no bias)."""
    n_hb, n_wb = _grid(xp, u, ct_h, ct_w, bh, bw)
    _, c, mp = u.shape
    out = _wg.winograd_conv2d_pretransformed(
        xp.float(), u.reshape(ct_h.t, ct_w.t, c, mp), ct_h, ct_w,
        geometry=block_geometry(n_hb, n_wb, bh, bw, ct_h, ct_w))
    return kernel_epilogue(out, bias, scale, activation)


def winograd_strided_streamed_plain(
    xp: torch.Tensor, u: torch.Tensor, bias: torch.Tensor | None,
    scale: torch.Tensor | None = None, *, ct_h: CookToom, ct_w: CookToom,
    bh: int, bw: int, activation: str = "none",
) -> torch.Tensor:
    """The stride-2 kernel's function in plain PyTorch: the phase-
    decomposed executor (core/winograd.py:
    winograd_strided_conv2d_pretransformed) over the halo-padded
    full-resolution input with the kernel's tiles, in fp32; then the same
    epilogue. `u` is the (4P, Cp, Mp) phase-major filter."""
    n_hb, n_wb = _grid(xp, u, ct_h, ct_w, bh, bw, stride=2)
    _, c, mp = u.shape
    out = _wg.winograd_strided_conv2d_pretransformed(
        xp.float(), u.reshape(2, 2, ct_h.t, ct_w.t, c, mp), ct_h, ct_w,
        geometry=block_geometry(n_hb, n_wb, bh, bw, ct_h, ct_w))
    return kernel_epilogue(out, bias, scale, activation)


def padded_mats(ct_h: CookToom, ct_w: CookToom) -> np.ndarray:
    """B_h^T, B_w^T, A_h^T, A_w^T as one (4, 8, 8) float32 host array, the
    transform operand of every Winograd kernel under csrc/."""
    mats = np.zeros((4, _MAX_T, _MAX_T), np.float32)
    for i, a in enumerate((ct_h.BT, ct_w.BT, ct_h.AT, ct_w.AT)):
        mats[i, :a.shape[0], :a.shape[1]] = a
    return mats


def _launch(name: str, source: str, stride: int, xp, u, bias, scale, *,
            ct_h: CookToom, ct_w: CookToom, bh: int, bw: int, block_c: int,
            block_m: int, activation: str) -> torch.Tensor:
    """Check the operands of a streamed kernel and launch it on the current
    stream; returns the (N, nHb*bh*mh, nWb*bw*mw, Mp) output."""
    if xp.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not "
                         f"{xp.device}")
    n_hb, n_wb = _grid(xp, u, ct_h, ct_w, bh, bw, stride)
    n, hp, wp, cp = xp.shape
    mp = u.shape[2]
    check_operands(xp.device, [("xp", xp, _F32), ("u", u, tuple(U_TYPES)),
                               ("bias", bias, _F32), ("scale", scale, _F32)])
    if bias is not None and (bias.dim() != 1 or bias.shape[0] > mp):
        raise ValueError(f"bias must be 1-D with at most {mp} entries")
    if scale is not None and scale.numel() != mp:
        raise ValueError(f"scale must hold {mp} entries")
    if max(ct_h.t, ct_w.t) > _MAX_T:
        raise ValueError(f"input tile ({ct_h.t}, {ct_w.t}) exceeds {_MAX_T}")
    out = torch.empty((n, n_hb * bh * ct_h.m, n_wb * bw * ct_w.m, mp),
                      dtype=torch.float32, device=xp.device)
    mats = padded_mats(ct_h, ct_w)      # held: the launch reads its memory
    launch, error = build.bind(source, name, _ARGTYPES)
    with torch.cuda.device(xp.device):
        status = launch(
            xp.data_ptr(), u.data_ptr(), U_TYPES[u.dtype],
            bias.data_ptr() if bias is not None else None,
            bias.shape[0] if bias is not None else 0,
            scale.data_ptr() if scale is not None else None,
            out.data_ptr(), n, hp, wp, cp, mp, ct_h.t, ct_w.t, ct_h.m,
            ct_w.m, bh, bw, block_c, block_m, ACTIVATIONS.index(activation),
            mats.ctypes.data, torch.cuda.current_stream().cuda_stream)
    build.check_status(name, status, error)
    return out


def winograd_streamed(
    xp: torch.Tensor,                  # (N, Hp, Wp, Cp) halo-padded NHWC fp32
    u: torch.Tensor,                   # (P, Cp, Mp) fp32 / bf16 / int8
    bias: torch.Tensor | None,         # (<= Mp,) fp32 epilogue bias, or None
    scale: torch.Tensor | None = None,  # (1, Mp) fp32 int8 dequant scale
    *,
    ct_h: CookToom,
    ct_w: CookToom,
    bh: int,
    bw: int,
    block_c: int,
    block_m: int,
    activation: str = "none",
) -> torch.Tensor:
    """Halo-streaming transform + GEMM + inverse + epilogue over the padded
    input, the point-GEMMs on the tensor cores in TF32x3 (fp32-level
    error). `xp` must be padded so Hp = nHb*bh*mh + (th - mh) and
    Wp = nWb*bw*mw + (tw - mw) for whole strip counts nHb / nWb, Cp a
    multiple of the C step `block_c` (8, 16 or 32) and Mp of `block_m`
    (ops.py pads from the plan's StreamGeometry). Returns the
    (N, nHb*bh*mh, nWb*bw*mw, Mp) NHWC output; the caller crops the
    geometry surplus. Tiles up to 6 x 6 run the warp-specialised body
    (csrc/winograd_ws.cuh, `block_c` 8), larger ones the shared one
    (core/winograd.py:stream_body); BODY_LAUNCHES counts each."""
    check_activations(activation)
    if xp.device.type == "cpu":
        return winograd_streamed_plain(xp, u, bias, scale, ct_h=ct_h,
                                       ct_w=ct_w, bh=bh, bw=bw,
                                       activation=activation)
    out = _launch("winograd_streamed", "winograd_streamed.cu", 1, xp, u,
                  bias, scale, ct_h=ct_h, ct_w=ct_w, bh=bh, bw=bw,
                  block_c=block_c, block_m=block_m, activation=activation)
    winograd_streamed.LAUNCHES += 1
    winograd_streamed.BODY_LAUNCHES[_wg.stream_body(ct_h, ct_w)] += 1
    return out


def winograd_strided_streamed(
    xp: torch.Tensor,                  # (N, Hp, Wp, Cp) padded full-res fp32
    u: torch.Tensor,                   # (4P, Cp, Mp) fp32 / bf16 / int8
    bias: torch.Tensor | None,         # (<= Mp,) fp32 epilogue bias, or None
    scale: torch.Tensor | None = None,  # (1, Mp) fp32 int8 dequant scale
    *,
    ct_h: CookToom,
    ct_w: CookToom,
    bh: int,
    bw: int,
    block_c: int,
    block_m: int,
    activation: str = "none",
) -> torch.Tensor:
    """Stride-2 halo-streaming Winograd conv by transform-domain phase
    decomposition, on the stride-1 kernel's tensor-core body with a loop
    over the four input phases around its C sweep: one set of
    accumulators, one inverse transform, one NHWC store with the fused
    epilogue. `xp` must be padded so Hp = 2*(nHb*bh*mh + th - mh) and
    likewise Wp, Cp a multiple of the C step `block_c` (8, 16 or 32) and
    Mp of `block_m`. Returns the (N, nHb*bh*mh, nWb*bw*mw, Mp) stride-2
    output; the caller crops."""
    check_activations(activation)
    if xp.device.type == "cpu":
        return winograd_strided_streamed_plain(
            xp, u, bias, scale, ct_h=ct_h, ct_w=ct_w, bh=bh, bw=bw,
            activation=activation)
    out = _launch("winograd_strided_streamed",
                  "winograd_strided_streamed.cu", 2, xp, u, bias, scale,
                  ct_h=ct_h, ct_w=ct_w, bh=bh, bw=bw, block_c=block_c,
                  block_m=block_m, activation=activation)
    winograd_strided_streamed.LAUNCHES += 1
    return out


def winograd_fused_plain(tiles: torch.Tensor, u: torch.Tensor, *,
                        ct_h: CookToom, ct_w: CookToom) -> torch.Tensor:
    """The tiles-domain kernel's function in plain PyTorch (the reference's
    kernels/ref.py:winograd_fused): input transform B^T d B of every tile,
    the P point-GEMMs over C, inverse transform A^T y A, all in fp32. No
    epilogue."""
    r, th, tw, c = tiles.shape
    x = tiles.float()
    v = torch.einsum("it,rtuc,ju->rijc", _wg._mat(ct_h.BT, x), x,
                     _wg._mat(ct_w.BT, x))
    v = v.reshape(r, th * tw, c).transpose(0, 1)          # (P, R, C)
    y = torch.bmm(v, u.to(x.dtype))                       # (P, R, Mp)
    y = y.transpose(0, 1).reshape(r, th, tw, u.shape[2])
    return torch.einsum("it,rtum,ju->rijm", _wg._mat(ct_h.AT, y), y,
                        _wg._mat(ct_w.AT, y))


def winograd_fused(
    tiles: torch.Tensor,               # (R, th, tw, Cp) input tiles, fp32
    u: torch.Tensor,                   # (P, Cp, Mp) fp32 Winograd-domain
    *,
    ct_h: CookToom,
    ct_w: CookToom,
    block_r: int,
    block_c: int,
    block_m: int,
) -> torch.Tensor:
    """Transform + point-GEMMs + inverse over pre-extracted overlapping
    tiles, the point-GEMMs on the tensor cores in TF32x3 (fp32-level
    error): the A/B baseline of the streamed kernel. R must be a multiple
    of `block_r`, Cp of the C step `block_c` (8, 16 or 32) and Mp of
    `block_m` (ops.py pads from the plan's blocks). Returns the
    (R, mh, mw, Mp) output tiles, with no epilogue: the caller un-tiles
    them and applies bias and activation."""
    if tiles.device.type == "cpu":
        return winograd_fused_plain(tiles, u, ct_h=ct_h, ct_w=ct_w)
    if tiles.device.type != "cuda":
        raise ValueError(f"winograd_fused runs on CUDA or CPU tensors, not "
                         f"{tiles.device}")
    r, th, tw, cp = tiles.shape
    if (th, tw) != (ct_h.t, ct_w.t) or u.dim() != 3 or \
            u.shape[:2] != (th * tw, cp):
        raise ValueError(
            f"operands tiles {tuple(tiles.shape)} / u {tuple(u.shape)} do "
            f"not match tiles F({ct_h.m}x{ct_w.m}, {ct_h.r}x{ct_w.r})")
    check_operands(tiles.device, [("tiles", tiles, _F32), ("u", u, _F32)])
    mp = u.shape[2]
    out = torch.empty((r, ct_h.m, ct_w.m, mp), dtype=torch.float32,
                      device=tiles.device)
    mats = padded_mats(ct_h, ct_w)      # held: the launch reads its memory
    launch, error = build.bind("winograd_fused.cu", "winograd_fused",
                               _FUSED_ARGTYPES)
    with torch.cuda.device(tiles.device):
        status = launch(
            tiles.data_ptr(), u.data_ptr(), out.data_ptr(), r, th, tw,
            ct_h.m, ct_w.m, cp, mp, block_r, block_c, block_m,
            mats.ctypes.data, torch.cuda.current_stream().cuda_stream)
    build.check_status("winograd_fused", status, error)
    winograd_fused.LAUNCHES += 1
    return out


#: Kernel launches made through each wrapper (CUDA tensors only).
winograd_streamed.LAUNCHES = 0
#: winograd_streamed's launches by body: "ws" (csrc/winograd_ws.cuh) and
#: "tc" (csrc/winograd_tc.cuh), as core/winograd.py:stream_body names them.
winograd_streamed.BODY_LAUNCHES = {"ws": 0, "tc": 0}
winograd_strided_streamed.LAUNCHES = 0
winograd_fused.LAUNCHES = 0
