"""Region-wise multi-channel Winograd / Cook-Toom convolution (PyTorch).

The paper's three-phase scheme, as in the JAX package's core/winograd.py:

  1. *Input transform*: tile the NHWC input into overlapping t x t regions,
     apply B^T x B per region, and scatter the t^2 Winograd-domain points
     into a (P, R, C) tensor -- P = t^2 points, R = regions, C = channels.
  2. *GEMM*: P batched matmuls (P, R, C) x (P, C, M) -> (P, R, M).
  3. *Output transform*: gather each region's P points, apply A^T (.) A,
     and write the m x m spatial outputs back into NHWC.

This module holds the plan-time geometry (padding, tile counts, and the
halo blocking of the CUDA kernel in kernels/csrc/winograd_streamed.cu) and
the pure-PyTorch executor the XLA family maps to.
"""

from __future__ import annotations

from typing import Literal, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.transforms import CookToom

Padding = Literal["SAME", "VALID"]


def _mat(a: np.ndarray, like: torch.Tensor,
         dtype: torch.dtype | None = None) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype or like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Filter transforms (done once per layer, at plan time)
# ---------------------------------------------------------------------------

def transform_filter_2d(w: torch.Tensor, ct_h: CookToom,
                        ct_w: CookToom) -> torch.Tensor:
    """(kh, kw, C, M) -> (th, tw, C, M): G_h w G_w^T over the spatial axes."""
    return torch.einsum("ij,jkcm,lk->ilcm", _mat(ct_h.G, w), w,
                        _mat(ct_w.G, w))


# ---------------------------------------------------------------------------
# Tiling geometry
# ---------------------------------------------------------------------------

def _pad_amounts(size: int, k: int, m: int,
                 padding: Padding) -> tuple[int, int, int]:
    """Return (lo, hi, n_tiles) padding for one spatial axis.

    The axis is padded so that (padded - k + 1) is a positive multiple of
    the output tile m; surplus outputs are cropped after the inverse
    transform.
    """
    if padding == "SAME":
        out = size
        lo = (k - 1) // 2
    else:
        out = size - k + 1
        lo = 0
    if out <= 0:
        raise ValueError(
            f"axis of size {size} too small for filter {k} ({padding})")
    n_tiles = -(-out // m)
    padded = n_tiles * m + k - 1
    hi = padded - size - lo
    return lo, hi, n_tiles


class Conv2DGeometry(NamedTuple):
    """Static tiling geometry of one (H, W) conv shape, derived once at plan
    time so the hot path never re-derives padding or tile counts."""

    lo_h: int
    hi_h: int
    n_h: int          # tile count along H
    lo_w: int
    hi_w: int
    n_w: int          # tile count along W
    out_h: int
    out_w: int


def conv2d_geometry(h: int, w: int, kh: int, kw: int, mh: int, mw: int,
                    padding: Padding) -> Conv2DGeometry:
    """All padding/tiling decisions for an (H, W) layer, computed once."""
    lo_h, hi_h, nh = _pad_amounts(h, kh, mh, padding)
    lo_w, hi_w, nw = _pad_amounts(w, kw, mw, padding)
    out_h = h if padding == "SAME" else h - kh + 1
    out_w = w if padding == "SAME" else w - kw + 1
    return Conv2DGeometry(lo_h, hi_h, nh, lo_w, hi_w, nw, out_h, out_w)


# ---------------------------------------------------------------------------
# Halo blocking of the CUDA streaming kernel
# ---------------------------------------------------------------------------

class StreamGeometry(NamedTuple):
    """Halo-blocking geometry of the streaming kernel
    (kernels/winograd.py:winograd_streamed), derived once at plan time.

    One thread block computes a (bh, bw) block of output tiles for block_m
    output channels, sweeping all of C in block_c steps. Edge blocks are
    covered by padding the input up to n_hb*bh / n_wb*bw whole tile blocks
    (`pad_h` / `pad_w` extra rows/cols beyond the convolution padding); the
    surplus outputs are cropped after the kernel.
    """

    bh: int           # output-tile rows per thread block
    bw: int           # output-tile cols per thread block
    n_hb: int         # tile blocks along H  (= ceil(n_h / bh))
    n_wb: int         # tile blocks along W  (= ceil(n_w / bw))
    pad_h: int        # extra rows of input padding for edge blocks
    pad_w: int        # extra cols of input padding for edge blocks
    block_c: int      # channels per step of the in-block C sweep
    block_m: int      # output channels per thread block
    c_pad: int        # C rounded up to block_c
    m_pad: int        # M rounded up to block_m


# The kernel's fixed shape; these must agree with the constants at the top
# of kernels/csrc/winograd_streamed.cu, which rejects any other blocking.
STREAM_THREADS = 256          # threads per block
STREAM_BLOCK_C = 8            # channels per C step
STREAM_POINTS_PER_THREAD = 9  # Winograd points one thread accumulates
STREAM_MAX_T = 8              # largest input tile per axis
#: Shared memory one block may take: two blocks fit on one SM (228 KB),
#: which the kernel's __launch_bounds__(256, 2) and its 128-register cap
#: also assume.
STREAM_SMEM_BUDGET = 113 * 1024
#: Streaming multiprocessors of the target card (H100 SXM), used when the
#: plan is made for a CPU device; a CUDA plan passes its card's count.
H100_SMS = 132
_BLOCKS_PER_SM = 2


def stream_smem_bytes(p: int, br: int, bm: int) -> int:
    """Dynamic shared memory of one kernel block: the widened filter chunk
    (P, bC, bM), the transformed input chunk (P, bC, bR) and its
    half-transformed staging copy while the C sweep runs; the (P, bR, bM)
    accumulator spill for the inverse transform reuses the same space."""
    stage = 4 * (p * STREAM_BLOCK_C * bm + 2 * p * STREAM_BLOCK_C * br)
    return max(stage, 4 * p * br * bm)


def stream_geometry(n_h: int, n_w: int, c: int, mout: int,
                    ct_h: CookToom, ct_w: CookToom, *, batch: int = 1,
                    sms: int = H100_SMS) -> StreamGeometry:
    """Choose the kernel's blocking for one layer, once, at plan time.

    Each thread holds 2 regions x 4 output channels of up to
    STREAM_POINTS_PER_THREAD Winograd points in registers, so a candidate
    (bh, bw, bM) must spread its P * bR * bM accumulators over the 256
    threads within that bound, and its shared-memory footprint must let
    two blocks share an SM. Among those, the cheapest by a per-thread
    operation count (point-GEMM FMAs with their shared-memory loads, the
    filter staging, the two-pass input transform, the inverse transform
    and epilogue), times the number of waves of blocks the card's `sms`
    multiprocessors run, wins; ties go to the larger block.

    The score's weights are estimates that no measurement on the card has
    checked yet, and the kernel runs far below its FMA peak (PERF.md), so
    the premise that it is bound by operations is itself unchecked: the
    score picks a blocking that fits, not one known to be fastest.
    """
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    if th > STREAM_MAX_T or tw > STREAM_MAX_T:
        raise ValueError(
            f"input tile ({th}, {tw}) exceeds the streaming kernel's "
            f"{STREAM_MAX_T}; use a smaller output_tile")
    p = th * tw
    bc = STREAM_BLOCK_C
    c_pad = -(-c // bc) * bc
    chunks = c_pad // bc

    def pow2_upto(n: int) -> list[int]:
        top = 2                      # a 1-tile axis still pairs 2 regions
        while top < n:
            top *= 2
        return [b for b in (1, 2, 4, 8, 16) if b <= top]

    def per_thread(items: int) -> int:
        return -(-items // STREAM_THREADS)

    best = None
    for bm in (16, 32, 64):
        if bm > 16 and bm > mout:
            continue
        m_pad = -(-mout // bm) * bm
        for bh in pow2_upto(n_h):
            for bw in pow2_upto(n_w):
                br = bh * bw
                if br < 2 or br > 16:
                    continue
                slab = (br // 2) * (bm // 4)
                pg = STREAM_THREADS // slab
                ps = -(-p // pg)
                if slab > STREAM_THREADS or ps > STREAM_POINTS_PER_THREAD:
                    continue
                if stream_smem_bytes(p, br, bm) > STREAM_SMEM_BUDGET:
                    continue
                n_hb, n_wb = -(-n_h // bh), -(-n_w // bw)
                chunk = (ps * bc * 8 * 5 // 4                 # GEMM + loads
                         + 3 * per_thread(p * bc * bm)        # filter staging
                         + per_thread(tw * bc * br) * th * (th + 1)
                         + per_thread(th * bc * br) * tw * (tw + 1)
                         + 50)                                # barriers
                tail = per_thread(br * bm) * (p * mw + th * mh * mw
                                              + 4 * mh * mw)
                blocks = batch * n_hb * n_wb * (m_pad // bm)
                waves = -(-blocks // (sms * _BLOCKS_PER_SM))
                score = (waves * (chunks * chunk + tail), -br * bm)
                if best is None or score < best[0]:
                    best = (score, (bh, bw, n_hb, n_wb, bm, m_pad))
    if best is None:
        raise ValueError(
            f"no blocking of the ({n_h}, {n_w})-tile grid (C={c}, M={mout}, "
            f"t=({th}, {tw})) fits the streaming kernel's registers and "
            f"{STREAM_SMEM_BUDGET} bytes of shared memory")
    bh, bw, n_hb, n_wb, bm, m_pad = best[1]
    return StreamGeometry(bh=bh, bw=bw, n_hb=n_hb, n_wb=n_wb,
                          pad_h=(n_hb * bh - n_h) * mh,
                          pad_w=(n_wb * bw - n_w) * mw,
                          block_c=bc, block_m=bm, c_pad=c_pad, m_pad=m_pad)


# ---------------------------------------------------------------------------
# Pure-PyTorch executor (the XLA family's counterpart)
# ---------------------------------------------------------------------------

def _extract_tiles_1d(x: torch.Tensor, axis: int, t: int, m: int,
                      n: int) -> torch.Tensor:
    """Slice an axis of length n*m + t - m into n overlapping windows of
    length t: the axis is replaced by two axes (n, t)."""
    idx = (np.arange(n)[:, None] * m + np.arange(t)[None, :]).reshape(-1)
    out = torch.index_select(x, axis, torch.as_tensor(idx, device=x.device))
    return out.reshape(x.shape[:axis] + (n, t) + x.shape[axis + 1:])


def winograd_conv2d_pretransformed(
    x: torch.Tensor,
    u: torch.Tensor,
    ct_h: CookToom,
    ct_w: CookToom,
    *,
    padding: Padding = "SAME",
    geometry: Conv2DGeometry | None = None,
) -> torch.Tensor:
    """Region-wise multi-channel Winograd conv with the filter already in
    the Winograd domain: x (N, H, W, C) NHWC, u (th, tw, C, M). A reduced
    precision u (bf16, int8) is widened to x's dtype for the GEMM; the
    caller applies any int8 scale."""
    n, h, wdt, c = x.shape
    th, tw, _, mout = u.shape
    mh, mw, kh, kw = ct_h.m, ct_w.m, ct_h.r, ct_w.r
    if geometry is None:
        geometry = conv2d_geometry(h, wdt, kh, kw, mh, mw, padding)
    nh, nw = geometry.n_h, geometry.n_w
    xp = F.pad(x, (0, 0, geometry.lo_w, geometry.hi_w,
                   geometry.lo_h, geometry.hi_h))

    # phase 1: tile + input transform + scatter to (P, R, C)
    tiles = _extract_tiles_1d(xp, 1, th, mh, nh)        # (N, nh, th, Wp, C)
    tiles = _extract_tiles_1d(tiles, 3, tw, mw, nw)     # (N, nh, th, nw, tw, C)
    v = torch.einsum("it,nhtwuc,ju->nhwijc", _mat(ct_h.BT, x), tiles,
                     _mat(ct_w.BT, x))
    v = v.reshape(n * nh * nw, th * tw, c).transpose(0, 1)

    # phase 2: P batched GEMMs [R x C] x [C x M]
    y = torch.bmm(v, u.to(x.dtype).reshape(th * tw, c, mout))

    # phase 3: gather + output transform
    y = y.transpose(0, 1).reshape(n, nh, nw, th, tw, mout)
    out = torch.einsum("it,nhwtum,ju->nhiwjm", _mat(ct_h.AT, y), y,
                       _mat(ct_w.AT, y))
    out = out.reshape(n, nh * mh, nw * mw, mout)
    return out[:, :geometry.out_h, :geometry.out_w, :]
