"""Mamba-1 selective scan: the CUDA kernel's wrapper and its plain PyTorch
version.

`selective_scan` replaces repro/kernels/selective_scan.py:selective_scan,
the Pallas TPU kernel. On a CUDA tensor it launches the hand-written kernel
(csrc/selective_scan.cu, built at first use, see build.py) or raises; on a
CPU tensor it runs its plain version; on "meta" tensors (a dry run) it
returns empty results and reports one launch to the active
launch/opcost.CostMode, running nothing and counting no launch. Both compute

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,   y_t = C_t . h_t,   h_0 = 0

and return (y (B, L, D) fp32, h_last (B, D, N) fp32). The kernel walks L
in order with each channel's states split across a group of lanes, in
registers; `scan_blocking` chooses its lanes per channel, channels per
block and staged chunk, which the wrapper passes to the launcher. The
plain version is the chunked
formulation the reference runs off the TPU (models/mamba.py:
_chunked_selective_scan): a sequential loop over chunks carrying the
(B, D, N) state, and inside each chunk an inclusive scan of the affine
maps h -> a h + b written as log2(chunk) doubling steps on tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.winograd import H100_SMS, TC_SMEM_MAX
from repro_torch.kernels import build
from repro_torch.kernels.runtime import check_operands

#: Operand dtypes the kernel takes, by their C type code (common.cuh).
TYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Largest state size the kernel keeps in registers.
MAX_STATE = 16
#: The kernel's blocking menu; these must agree with
#: kernels/csrc/selective_scan.cu: lanes per channel (each holds N / lanes
#: of the padded states), channels per block (at most SCAN_MAX_THREADS
#: threads) and steps per staged chunk.
SCAN_LANES = (1, 2, 4)
SCAN_CHANNELS = (32, 64, 128, 256)
SCAN_CHUNKS = (16, 32, 64, 128)
SCAN_MAX_THREADS = 512
_F32 = (torch.float32,)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (_P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _P)


def padded_states(n: int) -> int:
    """The kernel's state count: N rounded up to 4, 8 or 16."""
    return 4 if n <= 4 else 8 if n <= 8 else 16


def scan_smem_bytes(channels: int, chunk: int, n: int, x_size: int = 4,
                    bc_size: int = 4) -> int:
    """Dynamic shared memory of one selective_scan.cu block: two stages of
    `chunk` steps of dt and xs (`channels` values of x_size bytes each) and
    of B and C (the padded N values of bc_size bytes each)."""
    return 2 * chunk * (2 * channels * x_size + 2 * padded_states(n) * bc_size)


def scan_blocking_fits(lanes: int, channels: int, chunk: int, n: int,
                       x_size: int = 4, bc_size: int = 4) -> bool:
    """Whether selective_scan_launch takes the blocking: lanes in
    SCAN_LANES, channels in SCAN_CHANNELS with channels * lanes <=
    SCAN_MAX_THREADS, chunk in SCAN_CHUNKS, and the shared memory within
    TC_SMEM_MAX."""
    return (lanes in SCAN_LANES and channels in SCAN_CHANNELS
            and channels * lanes <= SCAN_MAX_THREADS
            and chunk in SCAN_CHUNKS
            and scan_smem_bytes(channels, chunk, n, x_size, bc_size)
            <= TC_SMEM_MAX)


def scan_blocking(b: int, d: int, n: int, *, sms: int = H100_SMS
                  ) -> tuple[int, int, int]:
    """(lanes per channel, channels per block, chunk) of the kernel for a
    (B, ., D) scan with N states: 8 states a lane (N / 8 lanes, at least
    1), 64 channels a block where that gives every SM two blocks, else 32,
    and 32-step chunks. Fitted to `chip_smoke.py --sweep selective_scan`
    at falcon-mamba-7b's (4, 2048, 8192, 16) on an H100 (PERF.md): 2 lanes
    beat 4 (fewer loads and shuffles per update) and 1 (too few warps),
    and every 2-lane blocking with 32 or 64-step chunks reads within 5 %
    of the best."""
    lanes = max(padded_states(n) // 8, 1)
    channels = 64 if b * -(-d // 64) >= 2 * sms else 32
    return lanes, channels, 32


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
    remat: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, chunked: per chunk of
    `chunk` steps (the last one may be shorter), the discretization
    exp(dt A) and dt x B in fp32 over (B, chunk, D, N), their inclusive
    scan seeded by the carried state, and the contraction with C
    (chunk_step). With `remat`, each chunk runs under
    torch.utils.checkpoint: a backward through it keeps only the chunks'
    inputs and recomputes one chunk at a time (the gradient's path,
    models/mamba.py)."""
    dt, xs, bmat, cmat = dt.float(), xs.float(), bmat.float(), cmat.float()
    a_mat = a_mat.float()
    step = (functools.partial(checkpoint, chunk_step, use_reentrant=False)
            if remat else chunk_step)
    h = torch.zeros((dt.shape[0], dt.shape[2], a_mat.shape[-1]),
                    dtype=dt.dtype, device=dt.device)
    ys = []
    for l0 in range(0, dt.shape[1], chunk):
        sl = slice(l0, l0 + chunk)
        h, y = step(h, dt[:, sl], xs[:, sl], bmat[:, sl], cmat[:, sl], a_mat)
        ys.append(y)
    return torch.cat(ys, 1), h.contiguous()


def chunk_step(h: torch.Tensor, dt: torch.Tensor, xs: torch.Tensor,
               bmat: torch.Tensor, cmat: torch.Tensor, a_mat: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the plain version from state h (B, D, N), the
    reference's chunk_step (models/mamba.py:_chunked_selective_scan): the
    discretization exp(dt A) and dt x B over (B, c, D, N), their inclusive
    scan seeded by h, and the contraction with C. Returns (the state after
    the chunk, y (B, c, D)), in the operands' dtype."""
    ac = torch.exp(dt[..., None] * a_mat[None, None])   # (B, c, D, N)
    bxc = (dt * xs)[..., None] * bmat[:, :, None, :]
    a_acc, b_acc = _affine_prefix(ac, bxc)
    h_all = a_acc * h[:, None] + b_acc                 # (B, c, D, N)
    return h_all[:, -1], torch.einsum("blds,bls->bld", h_all, cmat)


def selective_scan(
    dt: torch.Tensor,        # (B, L, D) fp32 / bf16
    xs: torch.Tensor,        # (B, L, D), dt's dtype
    bmat: torch.Tensor,      # (B, L, N) fp32 / bf16
    cmat: torch.Tensor,      # (B, L, N), bmat's dtype
    a_mat: torch.Tensor,     # (D, N) fp32 (A = -exp(a_log))
    *,
    chunk: int = 256,
    blocking: tuple[int, int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, L, D) fp32, h_last (B, D, N) fp32), for any L and D
    and N <= 16. `chunk` is the plain version's chunk length (CPU tensors);
    the kernel walks L in order, under `blocking` (lanes, channels, steps
    per staged chunk; scan_blocking's choice by default)."""
    if dt.device.type == "cpu":
        return selective_scan_plain(dt, xs, bmat, cmat, a_mat, chunk=chunk)
    if dt.device.type not in ("cuda", "meta"):
        raise ValueError(f"selective_scan runs on CUDA, CPU or meta "
                         f"tensors, not {dt.device}")
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
    if dt.device.type == "meta":
        # a dry run (launch/opcost.py): the kernel's one launch, its
        # operands and results, and its bound's work, the B*L*D*N
        # exponentials on the special-function unit; no launch is counted
        from repro_torch.launch import opcost
        opcost.report_kernel("selective_scan", (dt, xs, bmat, cmat, a_mat),
                             (y, h_last), b * length * d * n, "sfu")
        return y, h_last
    lanes, channels, steps = blocking or scan_blocking(b, d, n)
    launch, error = build.bind("selective_scan.cu", "selective_scan",
                               _ARGTYPES)
    with torch.cuda.device(dt.device):
        status = launch(
            dt.data_ptr(), xs.data_ptr(), TYPES[dt.dtype], bmat.data_ptr(),
            cmat.data_ptr(), TYPES[bmat.dtype], a_mat.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), b, length, d, n, lanes,
            channels, steps, torch.cuda.current_stream().cuda_stream)
    build.check_status("selective_scan", status, error)
    selective_scan.LAUNCHES += 1
    return y, h_last


#: Kernel launches made through the wrapper (CUDA tensors only).
selective_scan.LAUNCHES = 0
