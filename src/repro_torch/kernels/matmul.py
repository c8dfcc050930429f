"""Tiled GEMM with a fused epilogue: the CUDA kernel's wrapper and its plain
PyTorch version.

`matmul` replaces repro/kernels/matmul.py:matmul, the Pallas TPU kernel
behind the pallas_im2col executor. On a CUDA tensor it launches the
hand-written kernel in csrc/matmul.cu (built at first use; TF32x3 products
on the tensor cores) or raises; on a CPU tensor it runs `matmul_plain`.
C = act(scale * (A @ B) + bias) with fp32 accumulation: A (M, K) fp32 at its
logical size, B (Kp, Np) fp32 / bf16 / int8 padded at plan time by
core/im2col.py:matmul_b_shape for the plan's block tile (ops.py:
pad_im2col_filter), the output (M, n_out) at its logical width.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.im2col import (MATMUL_TILES, matmul_b_shape,
                                     matmul_split_fits)
from repro_torch.kernels import build
from repro_torch.kernels.runtime import (ACTIVATIONS, check_activations,
                                         check_operands, kernel_epilogue)
from repro_torch.kernels.winograd import U_TYPES

_F32 = (torch.float32,)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             _P, _I, _P)


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 bias: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None, *, n_out: int,
                 activation: str = "none") -> torch.Tensor:
    """The kernel's function in plain PyTorch: A @ B[:K] in fp32 (B widened),
    x scale, + bias, activation, cropped to n_out columns."""
    y = torch.matmul(a.float(), b[:a.shape[1]].float())
    return kernel_epilogue(y, bias, scale, activation)[:, :n_out]


def matmul(
    a: torch.Tensor,                   # (M, K) fp32
    b: torch.Tensor,                   # (Kp, Np) fp32 / bf16 / int8, padded
    bias: torch.Tensor | None = None,  # (<= Np,) fp32, or None
    scale: torch.Tensor | None = None,  # (1, Np) fp32 int8 dequant scale
    *,
    n_out: int,
    block_m: int,
    block_n: int,
    splits: int = 1,
    activation: str = "none",
) -> torch.Tensor:
    """C (M, n_out) = act(scale * (A @ B[:K, :n_out]) + bias), fp32
    accumulation, on the kernel's (block_m, block_n) tile (core/im2col.py:
    MATMUL_TILES) with its K steps in `splits` parts (matmul_split_fits),
    summed in a fixed order. B must be padded to (Kp, Np) =
    matmul_b_shape(K, n_out, block_n)."""
    check_activations(activation)
    if a.dim() != 2 or b.dim() != 2 or b.shape[0] < a.shape[1] or \
            not 0 < n_out <= b.shape[1]:
        raise ValueError(f"operands A {tuple(a.shape)} / B {tuple(b.shape)} "
                         f"do not match for {n_out} output columns")
    if a.device.type == "cpu":
        return matmul_plain(a, b, bias, scale, n_out=n_out,
                            activation=activation)
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on CUDA or CPU tensors, not "
                         f"{a.device}")
    m, k = a.shape
    kp, np_ = b.shape
    if (block_m, block_n) not in MATMUL_TILES:
        raise ValueError(f"({block_m}, {block_n}) is not a tile of the "
                         f"kernel's menu {sorted(MATMUL_TILES)}")
    if (kp, np_) != matmul_b_shape(k, n_out, block_n):
        raise ValueError(f"B {tuple(b.shape)} must be padded to "
                         f"{matmul_b_shape(k, n_out, block_n)}")
    if not matmul_split_fits(k, splits):
        raise ValueError(f"{splits} K splits do not fit K = {k}")
    check_operands(a.device, [("a", a, _F32), ("b", b, tuple(U_TYPES)),
                              ("bias", bias, _F32), ("scale", scale, _F32)])
    if bias is not None and (bias.dim() != 1 or bias.shape[0] > np_):
        raise ValueError(f"bias must be 1-D with at most {np_} entries")
    if scale is not None and scale.numel() != np_:
        raise ValueError(f"scale must hold {np_} entries")
    out = torch.empty((m, n_out), dtype=torch.float32, device=a.device)
    work = torch.empty((splits, m, n_out), dtype=torch.float32,
                       device=a.device) if splits > 1 else None
    launch, error = build.bind("matmul.cu", "matmul", _ARGTYPES)
    with torch.cuda.device(a.device):
        status = launch(
            a.data_ptr(), b.data_ptr(), U_TYPES[b.dtype],
            bias.data_ptr() if bias is not None else None,
            bias.shape[0] if bias is not None else 0,
            scale.data_ptr() if scale is not None else None,
            out.data_ptr(), m, n_out, k, kp, np_, block_m, block_n, splits,
            work.data_ptr() if work is not None else None,
            ACTIVATIONS.index(activation),
            torch.cuda.current_stream().cuda_stream)
    build.check_status("matmul", status, error)
    matmul.LAUNCHES += 1
    return out


#: Kernel launches made through the wrapper (CUDA tensors only).
matmul.LAUNCHES = 0
