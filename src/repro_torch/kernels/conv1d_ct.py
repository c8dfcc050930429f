"""Depthwise causal Cook-Toom conv1d (the Mamba short conv) over
pre-extracted tiles: the CUDA kernel's wrapper and its plain PyTorch
version.

`conv1d_ct_fused` replaces repro/kernels/conv1d_ct.py:conv1d_ct_fused, the
Pallas TPU kernel. On a CUDA tensor it launches the hand-written kernel
(csrc/conv1d_ct_fused.cu, built at first use, see build.py) or raises; on a
CPU tensor it runs its plain version, the same arithmetic in plain PyTorch.
It takes the operands the reference kernel takes, the (B, S, t, Cp) causal
tiles and the (t, Cp) Cook-Toom-domain taps, and returns the (B, S, m, Cp)
output tiles in the tiles' dtype; the caller (ops.py) pads, extracts the
tiles and crops.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.transforms import CookToom
from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_operands

#: Tile and tap dtypes the kernel takes, by their C type code (common.cuh).
TYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Threads per block: block_s tiles x block_c channels (kThreads in
#: csrc/conv1d_ct_fused.cu).
THREADS = 256
_MAX_T = 8
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P)


def transform_mats(ct: CookToom) -> np.ndarray:
    """B^T (t, t) and A^T (m, t) as one (2, 8, 8) float32 host array, each
    zero-padded: the kernel's transform operand."""
    mats = np.zeros((2, _MAX_T, _MAX_T), np.float32)
    mats[0, :ct.t, :ct.t] = ct.BT
    mats[1, :ct.m, :ct.t] = ct.AT
    return mats


def conv1d_ct_fused_plain(tiles: torch.Tensor, u: torch.Tensor, *,
                          ct: CookToom) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the reference's
    kernels/ref.py:conv1d_ct_fused): B^T, the Hadamard product with the taps
    and A^T in fp32, cast to the tiles' dtype."""
    bt = torch.as_tensor(ct.BT, dtype=torch.float32, device=tiles.device)
    at = torch.as_tensor(ct.AT, dtype=torch.float32, device=tiles.device)
    v = torch.einsum("it,bstc->bsic", bt, tiles.float())
    y = v * u.float()[None, None]
    return torch.einsum("ot,bstc->bsoc", at, y).to(tiles.dtype)


def conv1d_ct_fused(
    tiles: torch.Tensor,               # (B, S, t, Cp) fp32 / bf16 tiles
    u: torch.Tensor,                   # (t, Cp) fp32 / bf16 taps
    *,
    ct: CookToom,
    block_s: int = 2,
    block_c: int = 128,
) -> torch.Tensor:
    """Per tile and channel: B^T over the t inputs, the Hadamard product
    with the channel's taps, A^T to m outputs, fp32 arithmetic, output in
    the tiles' dtype. Blocks of block_s tiles x block_c channels
    (block_s * block_c = 256, Cp a multiple of block_c; ops.py pads C from
    the plan's blocking). Returns (B, S, m, Cp)."""
    if tiles.device.type == "cpu":
        return conv1d_ct_fused_plain(tiles, u, ct=ct)
    if tiles.device.type != "cuda":
        raise ValueError(f"conv1d_ct_fused runs on CUDA or CPU tensors, not "
                         f"{tiles.device}")
    if tiles.dim() != 4 or tiles.shape[2] != ct.t:
        raise ValueError(f"tiles {tuple(tiles.shape)} must be (B, S, "
                         f"{ct.t}, Cp)")
    b, s, t, cp = tiles.shape
    if tuple(u.shape) != (t, cp):
        raise ValueError(f"taps {tuple(u.shape)} do not match ({t}, {cp})")
    check_operands(tiles.device, [("tiles", tiles, tuple(TYPES)),
                                  ("u", u, tuple(TYPES))])
    out = torch.empty((b, s, ct.m, cp), dtype=tiles.dtype,
                      device=tiles.device)
    mats = transform_mats(ct)          # held: the launch reads its memory
    launch, error = build.bind("conv1d_ct_fused.cu", "conv1d_ct_fused",
                               _ARGTYPES)
    with torch.cuda.device(tiles.device):
        status = launch(
            tiles.data_ptr(), TYPES[tiles.dtype], u.data_ptr(),
            TYPES[u.dtype], out.data_ptr(), b, s, t, ct.m, cp, block_s,
            block_c, mats.ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    build.check_status("conv1d_ct_fused", status, error)
    conv1d_ct_fused.LAUNCHES += 1
    return out


#: Kernel launches made through the wrapper (CUDA tensors only).
conv1d_ct_fused.LAUNCHES = 0
