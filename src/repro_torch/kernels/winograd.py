"""Halo-streaming Winograd convolution: the CUDA kernel's wrapper and its
plain PyTorch version.

`winograd_streamed` replaces repro/kernels/winograd.py:winograd_streamed,
the Pallas TPU kernel. On a CUDA tensor it launches the hand-written kernel
in csrc/winograd_streamed.cu (built at first use, see build.py) or raises;
on a CPU tensor it runs `winograd_streamed_plain`, the same arithmetic in
plain PyTorch. Both take the operands the reference kernel takes and return
the same (N, nHb*bh*mh, nWb*bw*mw, Mp) NHWC block grid; the caller
(ops.py) pads the input and crops the output.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import winograd as _wg
from repro_torch.core.transforms import CookToom
from repro_torch.kernels import build
from repro_torch.kernels.runtime import ACTIVATIONS, apply_activation

_SOURCE = "winograd_streamed.cu"
_U_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_T = 8


def _grid(xp: torch.Tensor, u: torch.Tensor, ct_h: CookToom,
          ct_w: CookToom, bh: int, bw: int) -> tuple[int, int]:
    """(n_hb, n_wb) strip counts of a padded input; raises on a mismatch."""
    n, hp, wp, c = xp.shape
    p, c2, _ = u.shape
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    n_hb, rh = divmod(hp - (th - mh), bh * mh)
    n_wb, rw = divmod(wp - (tw - mw), bw * mw)
    if p != th * tw or c != c2 or rh or rw or n_hb < 1 or n_wb < 1:
        raise ValueError(
            f"operands xp {tuple(xp.shape)} / u {tuple(u.shape)} do not "
            f"match tiles F({mh}x{mw}, {ct_h.r}x{ct_w.r}) in {bh}x{bw} "
            f"tile blocks")
    return n_hb, n_wb


def winograd_streamed_plain(
    xp: torch.Tensor, u: torch.Tensor, bias: torch.Tensor | None,
    scale: torch.Tensor | None = None, *, ct_h: CookToom, ct_w: CookToom,
    bh: int, bw: int, activation: str = "none",
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the region-wise executor
    (core/winograd.py:winograd_conv2d_pretransformed) over the halo-padded
    input as a VALID conv, whose tiles are exactly the kernel's, in fp32;
    then x scale, + bias, activation. `bias` may be shorter than Mp (the
    missing channels get no bias)."""
    _grid(xp, u, ct_h, ct_w, bh, bw)
    _, c, mp = u.shape
    out = _wg.winograd_conv2d_pretransformed(
        xp.float(), u.reshape(ct_h.t, ct_w.t, c, mp), ct_h, ct_w,
        padding="VALID")
    if scale is not None:
        out = out * scale.reshape(-1).float()
    if bias is not None:
        out = out + torch.nn.functional.pad(bias.float(), (0, mp - len(bias)))
    return apply_activation(out, activation)


def _padded_mats(ct_h: CookToom, ct_w: CookToom) -> np.ndarray:
    """B_h^T, B_w^T, A_h^T, A_w^T as one (4, 8, 8) float32 host array."""
    mats = np.zeros((4, _MAX_T, _MAX_T), np.float32)
    for i, a in enumerate((ct_h.BT, ct_w.BT, ct_h.AT, ct_w.AT)):
        mats[i, :a.shape[0], :a.shape[1]] = a
    return mats


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    fn = lib.winograd_streamed_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, i, p, p, i, i, i, i, i,
                   i, i, i, i, i, i, i, i, p, p]
    fn.restype = i
    lib.winograd_streamed_error.argtypes = [i]
    lib.winograd_streamed_error.restype = ctypes.c_char_p
    return lib


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
    block_m: int,
    activation: str = "none",
) -> torch.Tensor:
    """Halo-streaming transform + GEMM + inverse + epilogue over the padded
    input. `xp` must be padded so Hp = nHb*bh*mh + (th - mh) and
    Wp = nWb*bw*mw + (tw - mw) for whole strip counts nHb / nWb, Cp a
    multiple of 8 and Mp of `block_m` (ops.py pads from the plan's
    StreamGeometry). Returns the (N, nHb*bh*mh, nWb*bw*mw, Mp) NHWC output;
    the caller crops the geometry surplus."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; expected one "
                         f"of {ACTIVATIONS}")
    if xp.device.type == "cpu":
        return winograd_streamed_plain(xp, u, bias, scale, ct_h=ct_h,
                                       ct_w=ct_w, bh=bh, bw=bw,
                                       activation=activation)
    if xp.device.type != "cuda":
        raise ValueError(f"winograd_streamed runs on CUDA or CPU tensors, "
                         f"not {xp.device}")
    n_hb, n_wb = _grid(xp, u, ct_h, ct_w, bh, bw)
    n, hp, wp, cp = xp.shape
    mp = u.shape[2]
    operands = [("u", u, None), ("bias", bias, torch.float32),
                ("scale", scale, torch.float32)]
    for name, t, dtype in operands:
        if t is None:
            continue
        if t.device != xp.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {xp.device}")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if xp.dtype != torch.float32 or not xp.is_contiguous():
        raise ValueError(f"xp must be contiguous float32, got {xp.dtype}")
    if u.dtype not in _U_TYPES:
        raise ValueError(f"u must be float32, bfloat16 or int8, got {u.dtype}")
    if bias is not None and (bias.dim() != 1 or bias.shape[0] > mp):
        raise ValueError(f"bias must be 1-D with at most {mp} entries")
    if scale is not None and scale.numel() != mp:
        raise ValueError(f"scale must hold {mp} entries")
    if max(ct_h.t, ct_w.t) > _MAX_T:
        raise ValueError(f"input tile ({ct_h.t}, {ct_w.t}) exceeds {_MAX_T}")
    out = torch.empty((n, n_hb * bh * ct_h.m, n_wb * bw * ct_w.m, mp),
                      dtype=torch.float32, device=xp.device)
    mats = _padded_mats(ct_h, ct_w)
    lib = _library()
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.winograd_streamed_launch(
            xp.data_ptr(), u.data_ptr(), _U_TYPES[u.dtype],
            bias.data_ptr() if bias is not None else None,
            bias.shape[0] if bias is not None else 0,
            scale.data_ptr() if scale is not None else None,
            out.data_ptr(), n, hp, wp, cp, mp, ct_h.t, ct_w.t, ct_h.m,
            ct_w.m, bh, bw, block_m, ACTIVATIONS.index(activation),
            mats.ctypes.data, stream)
    if err != 0:
        raise RuntimeError("winograd_streamed launch failed: "
                           + lib.winograd_streamed_error(err).decode())
    winograd_streamed.LAUNCHES += 1
    return out


#: Kernel launches made through the wrapper (CUDA tensors only).
winograd_streamed.LAUNCHES = 0
