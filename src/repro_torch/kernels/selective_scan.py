"""Mamba-1 selective scan: the CUDA kernel's wrapper and its plain PyTorch
version.

`selective_scan` replaces repro/kernels/selective_scan.py:selective_scan,
the Pallas TPU kernel. On a CUDA tensor it launches the hand-written kernel
(csrc/selective_scan.cu, built at first use, see build.py) or raises; on a
CPU tensor it runs its plain version. Both compute

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,   y_t = C_t . h_t,   h_0 = 0

and return (y (B, L, D) fp32, h_last (B, D, N) fp32). The kernel walks L
in order with the state in registers; the plain version is the chunked
formulation the reference runs off the TPU (models/mamba.py:
_chunked_selective_scan): a sequential loop over chunks carrying the
(B, D, N) state, and inside each chunk an inclusive scan of the affine
maps h -> a h + b written as log2(chunk) doubling steps on tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_operands

#: Operand dtypes the kernel takes, by their C type code (common.cuh).
TYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Largest state size the kernel keeps in registers.
MAX_STATE = 16
_F32 = (torch.float32,)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P)


def _affine_prefix(a: torch.Tensor, b: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the maps h -> a h + b, composed
    earlier-first: (a1, b1) then (a2, b2) is (a1 a2, a2 b1 + b2). Doubling
    steps (Hillis-Steele): after the step of offset k, element i holds the
    composition of elements max(0, i - 2k + 1) .. i."""
    k, n = 1, a.shape[1]
    while k < n:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], 1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
        k *= 2
    return a, b


def selective_scan_plain(
    dt: torch.Tensor, xs: torch.Tensor, bmat: torch.Tensor,
    cmat: torch.Tensor, a_mat: torch.Tensor, *, chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, chunked: per chunk of
    `chunk` steps (the last one may be shorter), the discretization
    exp(dt A) and dt x B in fp32 over (B, chunk, D, N), their inclusive
    scan seeded by the carried state, and the contraction with C."""
    f32 = torch.float32
    dt, xs, bmat, cmat = dt.to(f32), xs.to(f32), bmat.to(f32), cmat.to(f32)
    a_mat = a_mat.to(f32)
    b, length, d = dt.shape
    h = torch.zeros((b, d, a_mat.shape[-1]), dtype=f32, device=dt.device)
    ys = []
    for l0 in range(0, length, chunk):
        sl = slice(l0, l0 + chunk)
        dtc = dt[:, sl]                                    # (B, c, D)
        ac = torch.exp(dtc[..., None] * a_mat[None, None])  # (B, c, D, N)
        bxc = (dtc * xs[:, sl])[..., None] * bmat[:, sl, None, :]
        a_acc, b_acc = _affine_prefix(ac, bxc)
        h_all = a_acc * h[:, None] + b_acc                 # (B, c, D, N)
        ys.append(torch.einsum("blds,bls->bld", h_all, cmat[:, sl]))
        h = h_all[:, -1]
    return torch.cat(ys, 1), h.contiguous()


def selective_scan(
    dt: torch.Tensor,        # (B, L, D) fp32 / bf16
    xs: torch.Tensor,        # (B, L, D), dt's dtype
    bmat: torch.Tensor,      # (B, L, N) fp32 / bf16
    cmat: torch.Tensor,      # (B, L, N), bmat's dtype
    a_mat: torch.Tensor,     # (D, N) fp32 (A = -exp(a_log))
    *,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, D) fp32, h_last (B, D, N) fp32), for any L and D
    and N <= 16. `chunk` is the plain version's chunk length (CPU tensors);
    the kernel walks L in order and takes none."""
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, xs, bmat, cmat, a_mat, chunk=chunk)
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan runs on CUDA or CPU tensors, not "
                         f"{dt.device}")
    if dt.dim() != 3 or xs.shape != dt.shape:
        raise ValueError(f"dt {tuple(dt.shape)} and xs {tuple(xs.shape)} "
                         f"must both be (B, L, D)")
    b, length, d = dt.shape
    n = a_mat.shape[-1]
    if a_mat.shape != (d, n) or not 1 <= n <= MAX_STATE:
        raise ValueError(f"a_mat {tuple(a_mat.shape)} must be ({d}, N) with "
                         f"N <= {MAX_STATE}")
    for name, t in (("bmat", bmat), ("cmat", cmat)):
        if t.shape != (b, length, n):
            raise ValueError(f"{name} {tuple(t.shape)} must be ({b}, "
                             f"{length}, {n})")
    check_operands(dt.device, [("dt", dt, tuple(TYPES)),
                               ("xs", xs, (dt.dtype,)),
                               ("bmat", bmat, tuple(TYPES)),
                               ("cmat", cmat, (bmat.dtype,)),
                               ("a_mat", a_mat, _F32)])
    y = torch.empty((b, length, d), dtype=torch.float32, device=dt.device)
    h_last = torch.empty((b, d, n), dtype=torch.float32, device=dt.device)
    launch, error = build.bind("selective_scan.cu", "selective_scan",
                               _ARGTYPES)
    with torch.cuda.device(dt.device):
        status = launch(
            dt.data_ptr(), xs.data_ptr(), TYPES[dt.dtype], bmat.data_ptr(),
            cmat.data_ptr(), TYPES[bmat.dtype], a_mat.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), b, length, d, n,
            torch.cuda.current_stream().cuda_stream)
    build.check_status("selective_scan", status, error)
    selective_scan.LAUNCHES += 1
    return y, h_last


#: Kernel launches made through the wrapper (CUDA tensors only).
selective_scan.LAUNCHES = 0
