"""Region-wise multi-channel Winograd / Cook-Toom convolution (PyTorch).

The paper's three-phase scheme, as in the JAX package's core/winograd.py:

  1. *Input transform*: tile the NHWC input into overlapping t x t regions,
     apply B^T x B per region, and scatter the t^2 Winograd-domain points
     into a (P, R, C) tensor -- P = t^2 points, R = regions, C = channels.
  2. *GEMM*: P batched matmuls (P, R, C) x (P, C, M) -> (P, R, M).
  3. *Output transform*: gather each region's P points, apply A^T (.) A,
     and write the m x m spatial outputs back into NHWC.

Stride-2 layers decompose into four stride-1 phase sub-convolutions whose
sum also happens in the transform domain
(winograd_strided_conv2d_pretransformed). Depthwise layers replace the
channel GEMM with a Hadamard product over channels.

This module holds the plan-time geometry (padding, tile counts, and the
blocking of the CUDA kernels under kernels/csrc/) and the pure-PyTorch
executors the XLA family maps to, which are also the plain versions the
kernel wrappers run on the CPU.
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


def strided_out_size(size: int, k: int, padding: Padding) -> int:
    """Output extent of one stride-2 axis (lax conventions): the one place
    the formula lives; the strided geometry and the plan-time tile chooser
    (core/plan.py:_resolve_strided_tile) both consult it."""
    return -(-size // 2) if padding == "SAME" else (size - k) // 2 + 1


def _pad_amounts_strided(size: int, k: int, m: int,
                         padding: Padding) -> tuple[int, int, int, int]:
    """(lo, hi, n_tiles, out) padding for one stride-2 phase-decomposed axis.

    The axis is padded to 2*n_tiles*m + k - 1 elements so every phase
    sub-grid x[p::2] (p in {0, 1}) holds n_tiles*m + r_ph - 1 elements,
    r_ph = (k+1)//2: the length the stride-1 phase tiling needs to cover
    n_tiles*m outputs. lo follows lax's SAME convention for stride 2 (torch's
    padding="same" rejects stride > 1); surplus outputs are cropped after the
    inverse transform."""
    out = strided_out_size(size, k, padding)
    if padding == "SAME":
        lo = max((out - 1) * 2 + k - size, 0) // 2
    else:
        lo = 0
    if out <= 0:
        raise ValueError(
            f"axis of size {size} too small for filter {k} stride 2 "
            f"({padding})")
    n_tiles = -(-out // m)
    padded = 2 * n_tiles * m + k - 1
    return lo, padded - size - lo, n_tiles, out


def conv2d_strided_geometry(h: int, w: int, kh: int, kw: int, mh: int,
                            mw: int, padding: Padding) -> Conv2DGeometry:
    """Padding/tiling decisions for a stride-2 phase-decomposed layer: the
    same record as the stride-1 geometry (tile counts n_h / n_w describe the
    phase sub-grids; lo / hi pad the full-resolution input)."""
    lo_h, hi_h, nh, out_h = _pad_amounts_strided(h, kh, mh, padding)
    lo_w, hi_w, nw, out_w = _pad_amounts_strided(w, kw, mw, padding)
    return Conv2DGeometry(lo_h, hi_h, nh, lo_w, hi_w, nw, out_h, out_w)


def strided_phase_filters(w: torch.Tensor, ct_h: CookToom,
                          ct_w: CookToom) -> torch.Tensor:
    """(kh, kw, Cg, M) filter -> (2, 2, th, tw, Cg, M) Winograd-domain phase
    sub-filters for the stride-2 decomposition.

    The filter is zero-padded to even size (kh+1, kw+1) so all four phase
    sub-filters w[p::2, q::2] share one size r_ph = (k+1)//2, hence one
    F(m, r_ph) transform set: that is what lets the phase sum happen in the
    transform domain, before the single inverse transform."""
    wp = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))
    return torch.stack([
        torch.stack([transform_filter_2d(wp[p::2, q::2], ct_h, ct_w)
                     for q in (0, 1)], 0)
        for p in (0, 1)], 0)


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


def stream_blocking_fits(p: int, br: int, bm: int) -> bool:
    """Whether the shared streamed/tiles-domain kernel body
    (kernels/csrc/winograd_common.cuh:fill_blocking) takes a block of `br`
    regions x `bm` output channels at P = `p` Winograd points: an even
    block_r and a block_m in 4s, 2 regions x 4 channels per thread slot
    with the slots dividing the 256 threads, at most
    STREAM_POINTS_PER_THREAD points per thread, and the shared-memory
    budget."""
    if br < 2 or br % 2 or bm < 4 or bm % 4:
        return False
    slab = (br // 2) * (bm // 4)
    if slab > STREAM_THREADS or STREAM_THREADS % slab:
        return False
    if -(-p // (STREAM_THREADS // slab)) > STREAM_POINTS_PER_THREAD:
        return False
    return stream_smem_bytes(p, br, bm) <= STREAM_SMEM_BUDGET


def stream_geometry(n_h: int, n_w: int, c: int, mout: int,
                    ct_h: CookToom, ct_w: CookToom, *, batch: int = 1,
                    sms: int = H100_SMS, phases: int = 1) -> StreamGeometry:
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

    `phases` = 4 describes the stride-2 kernel
    (kernels/csrc/winograd_strided_streamed.cu): it runs the same blocks
    over four phase GEMM banks, so its C sweep has four times the steps
    while its registers and shared memory per step stay the same.

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
    chunks = phases * c_pad // bc

    def per_thread(items: int) -> int:
        return -(-items // STREAM_THREADS)

    best = None
    for bm in (16, 32, 64):
        if bm > 16 and bm > mout:
            continue
        m_pad = -(-mout // bm) * bm
        for bh in _pow2_upto(n_h, 16):
            for bw in _pow2_upto(n_w, 16):
                br = bh * bw
                if br > 16 or not stream_blocking_fits(p, br, bm):
                    continue
                ps = -(-p // (STREAM_THREADS // ((br // 2) * (bm // 4))))
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


def _pow2_upto(n: int, cap: int) -> list[int]:
    """Powers of two up to the first one >= n, at most cap; at least up to
    2, so a 1-tile axis still pairs 2 regions."""
    top = 2
    while top < n:
        top *= 2
    return [b for b in (1, 2, 4, 8, 16, 32) if b <= min(top, cap)]


def winograd_blocks(r_tot: int, mout: int, points: int
                    ) -> tuple[int, int, int]:
    """(block_r, block_c, block_m) of the tiles-domain kernel
    (kernels/csrc/winograd_fused.cu), once, at plan time. It runs the
    streamed kernel's body, so a candidate must pass stream_blocking_fits.
    Among those, the largest block wins (the most reuse of each staged
    tile and filter chunk), then the larger block_m (each M block
    transforms its tiles again); block_r stops at the first power of two
    covering `r_tot`."""
    best = None
    for bm in (16, 32, 64):
        if bm > 16 and bm > mout:
            continue
        for br in _pow2_upto(r_tot, 32):
            if not stream_blocking_fits(points, br, bm):
                continue
            if best is None or (br * bm, bm) > (best[0] * best[1], best[1]):
                best = (br, bm)
    if best is None:
        raise ValueError(f"no blocking of the tiles-domain kernel fits "
                         f"{points} Winograd points")
    return best[0], STREAM_BLOCK_C, best[1]


# The depthwise kernels' fixed shape; these must agree with
# kernels/csrc/depthwise_common.cuh.
DEPTHWISE_THREADS = 256       # threads per block
DEPTHWISE_MAX_T = 8           # largest input tile per axis


def stream_geometry_depthwise(n_h: int, n_w: int, c: int, ct_h: CookToom,
                              ct_w: CookToom, *,
                              mult: int = 1) -> StreamGeometry:
    """Blocking of the depthwise kernels, stride 1
    (kernels/csrc/depthwise_streamed.cu) and stride 2
    (kernels/csrc/depthwise_strided_streamed.cu), once, at plan time.

    The kernels have no reduction and no shared memory: one thread computes
    one (output tile, input channel) pair, its transforms and Hadamard
    products held in registers, which the tile size (<= 8 per axis) fixes.
    A channel multiplier `mult` > 1 (stride 1 only) adds no registers: the
    thread produces its channel's `mult` outputs one after another, so it
    scales every candidate's work alike and leaves the choice as it is. A
    block is a (bh, bw) strip of tiles by bC channels with
    bh * bw * bC = 256 threads, channels fastest, so a warp's loads and
    stores are contiguous NHWC runs. Edge strips are covered by padding the
    input to whole strips and C to whole channel steps, as in
    stream_geometry. The chooser takes the fewest padded (tile, channel)
    items, then 32 channels per block (one warp reads 128 contiguous
    bytes), then the wider strip (neighbouring tiles share their halo in
    L1). block_m = block_c * mult and m_pad = c_pad * mult count the output
    channels: output o = c * mult + j.
    """
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    if max(th, tw) > DEPTHWISE_MAX_T:
        raise ValueError(
            f"input tile ({th}, {tw}) exceeds the depthwise kernels' "
            f"{DEPTHWISE_MAX_T}; use a smaller output_tile")
    best = None
    for bc in (8, 16, 32, 64):
        if bc > 8 and bc > c:
            continue
        c_pad = -(-c // bc) * bc
        tiles = DEPTHWISE_THREADS // bc
        for bw in _pow2_upto(tiles, tiles):
            bh = tiles // bw
            n_hb, n_wb = -(-n_h // bh), -(-n_w // bw)
            items = n_hb * bh * n_wb * bw * c_pad
            score = (items, abs(bc - 32), -bw)
            if best is None or score < best[0]:
                best = (score, (bh, bw, n_hb, n_wb, bc, c_pad))
    bh, bw, n_hb, n_wb, bc, c_pad = best[1]
    return StreamGeometry(bh=bh, bw=bw, n_hb=n_hb, n_wb=n_wb,
                          pad_h=(n_hb * bh - n_h) * mh,
                          pad_w=(n_wb * bw - n_w) * mw,
                          block_c=bc, block_m=bc * mult, c_pad=c_pad,
                          m_pad=c_pad * mult)


# The fused separable kernel's fixed shape; these must agree with
# kernels/csrc/separable_streamed.cu.
SEPARABLE_THREADS = 256
#: Shared memory one separable block may take, so that two share an SM.
SEPARABLE_SMEM_BUDGET = 113 * 1024


def separable_geometry(n_h: int, n_w: int, c: int, mout: int,
                       ct_h: CookToom, ct_w: CookToom, *, batch: int = 1,
                       sms: int = H100_SMS) -> StreamGeometry:
    """Blocking of the fused separable kernel
    (kernels/csrc/separable_streamed.cu), once, at plan time.

    One block computes a (bh, bw) strip of depthwise output tiles, S =
    bh*mh * bw*mw pixels, for bM pointwise output channels. It sweeps C in
    bC steps; each step recomputes the depthwise stage of its strip for
    those channels into shared memory (z, (bC, S)), stages the (bC, bM)
    pointwise filter chunk beside it, and runs the (S, bC) x (bC, bM) GEMM,
    each thread holding a 4-pixel x 4-channel register tile. So a candidate
    needs S a multiple of 4, S * bM / 16 <= 256 threads and z + filter chunk
    within the shared budget. Among those, the cheapest by a per-thread
    operation count (depthwise items, GEMM FMAs with their loads, filter
    staging) times the waves of blocks the card's `sms` multiprocessors
    run, two blocks each, wins; ties go to the larger block. The weights
    are estimates no measurement has checked (PERF.md).
    """
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    if max(th, tw) > DEPTHWISE_MAX_T:
        raise ValueError(
            f"input tile ({th}, {tw}) exceeds the depthwise kernels' "
            f"{DEPTHWISE_MAX_T}; use a smaller output_tile")

    def per_thread(items: int) -> int:
        return -(-items // SEPARABLE_THREADS)

    dw_item = (4 * th * tw + th * tw * (th + tw) + th * tw
               + mh * th * tw + mh * mw * tw + 4 * mh * mw)
    best = None
    for bm in (16, 32, 64, 128):
        if bm > 16 and bm > mout:
            continue
        m_pad = -(-mout // bm) * bm
        for bc in (16, 32, 64):
            if bc > 16 and bc > c:
                continue
            c_pad = -(-c // bc) * bc
            for bh in _pow2_upto(n_h, 16):
                for bw in _pow2_upto(n_w, 16):
                    s = bh * mh * bw * mw
                    if s % 4 or s * bm // 16 > SEPARABLE_THREADS:
                        continue
                    if 4 * bc * (s + bm) > SEPARABLE_SMEM_BUDGET:
                        continue
                    n_hb, n_wb = -(-n_h // bh), -(-n_w // bw)
                    chunk = (per_thread(bh * bw * bc) * dw_item
                             + bc * 16 * 5 // 4
                             + 3 * per_thread(bc * bm) + 50)
                    blocks = batch * n_hb * n_wb * (m_pad // bm)
                    waves = -(-blocks // (sms * _BLOCKS_PER_SM))
                    score = (waves * ((c_pad // bc) * chunk + 40), -s * bm)
                    if best is None or score < best[0]:
                        best = (score, (bh, bw, n_hb, n_wb, bc, bm, c_pad,
                                        m_pad))
    if best is None:
        raise ValueError(
            f"no blocking of the ({n_h}, {n_w})-tile grid (C={c}, M={mout}, "
            f"m=({mh}, {mw})) fits the separable kernel's thread layout")
    bh, bw, n_hb, n_wb, bc, bm, c_pad, m_pad = best[1]
    return StreamGeometry(bh=bh, bw=bw, n_hb=n_hb, n_wb=n_wb,
                          pad_h=(n_hb * bh - n_h) * mh,
                          pad_w=(n_wb * bw - n_w) * mw,
                          block_c=bc, block_m=bm, c_pad=c_pad, m_pad=m_pad)


# ---------------------------------------------------------------------------
# Pure-PyTorch executors (the XLA family's counterparts)
# ---------------------------------------------------------------------------

def _extract_tiles_1d(x: torch.Tensor, axis: int, t: int, m: int,
                      n: int) -> torch.Tensor:
    """Slice an axis of length n*m + t - m into n overlapping windows of
    length t: the axis is replaced by two axes (n, t). A strided view of
    x (no index tensor, so a CUDA graph can capture it); a later reshape
    materializes it."""
    win = x.narrow(axis, 0, n * m + t - m).unfold(axis, t, m)
    return win.movedim(-1, axis + 1)


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


def winograd_depthwise_conv2d_pretransformed(
    x: torch.Tensor,
    u: torch.Tensor,
    ct_h: CookToom,
    ct_w: CookToom,
    *,
    padding: Padding = "SAME",
    geometry: Conv2DGeometry | None = None,
) -> torch.Tensor:
    """Depthwise Winograd executor: the dense scheme's channel GEMM becomes a
    Hadamard product over channels, each channel with its own filter.
    Phases 1 and 3 are the dense path's. `u` is the (th, tw, C, mult)
    Winograd-domain filter (mult = channel multiplier); the output channel
    o = c * mult + j, as in a grouped conv with groups = C. Runs in fp32."""
    n, h, wdt, c = x.shape
    th, tw, _, mult = u.shape
    mh, mw, kh, kw = ct_h.m, ct_w.m, ct_h.r, ct_w.r
    if geometry is None:
        geometry = conv2d_geometry(h, wdt, kh, kw, mh, mw, padding)
    nh, nw = geometry.n_h, geometry.n_w
    xp = F.pad(x.float(), (0, 0, geometry.lo_w, geometry.hi_w,
                           geometry.lo_h, geometry.hi_h))
    tiles = _extract_tiles_1d(xp, 1, th, mh, nh)
    tiles = _extract_tiles_1d(tiles, 3, tw, mw, nw)     # (N, nh, th, nw, tw, C)
    v = torch.einsum("it,nhtwuc,ju->nhwijc", _mat(ct_h.BT, xp), tiles,
                     _mat(ct_w.BT, xp))
    y = torch.einsum("nhwijc,ijcm->nhwijcm", v, u.float())
    out = torch.einsum("it,nhwtucm,ju->nhiwjcm", _mat(ct_h.AT, y), y,
                       _mat(ct_w.AT, y))
    out = out.reshape(n, nh * mh, nw * mw, c * mult)
    return out[:, :geometry.out_h, :geometry.out_w, :].to(x.dtype)


def winograd_strided_conv2d_pretransformed(
    x: torch.Tensor,
    u: torch.Tensor,
    ct_h: CookToom,
    ct_w: CookToom,
    *,
    groups: int = 1,
    geometry: Conv2DGeometry,
) -> torch.Tensor:
    """Stride-2 convolution by transform-domain phase decomposition.

    A stride-2 conv splits into four stride-1 sub-convolutions over the
    input phases x[p::2, q::2] with the phase sub-filters w[p::2, q::2]
    (strided_phase_filters). Every phase shares A^T, so the phase outputs
    are summed in the transform domain: four input transforms and four GEMM
    banks, one accumulated (P, R, M) tensor, ONE inverse transform.

    `u` is the (2, 2, th, tw, Cg, M') phase filter set: dense Cg = C and
    M' = M; depthwise (groups = C) Cg = C and M' = the channel multiplier;
    grouped Cg = C / groups and M' = M, group-major. `geometry` is the
    conv2d_strided_geometry record. Returns (N, H', W', M) NHWC.
    """
    n, h, wdt, c = x.shape
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    nh, nw = geometry.n_h, geometry.n_w
    depthwise = groups > 1 and groups == c
    dt = torch.float32 if depthwise else x.dtype
    xp = F.pad(x.to(dt), (0, 0, geometry.lo_w, geometry.hi_w,
                          geometry.lo_h, geometry.hi_h))
    len_h = nh * mh + ct_h.r - 1          # phase sub-grid extents
    len_w = nw * mw + ct_w.r - 1
    pp, r_tot = th * tw, n * nh * nw

    # phase 1: per-phase tiling + input transform, scattered into ONE
    # (4P, R, C) tensor, phase-major.
    vs = []
    for p in (0, 1):
        for q in (0, 1):
            ph = xp[:, p::2, q::2, :][:, :len_h, :len_w, :]
            tiles = _extract_tiles_1d(ph, 1, th, mh, nh)
            tiles = _extract_tiles_1d(tiles, 3, tw, mw, nw)
            v = torch.einsum("it,nhtwuc,ju->nhwijc", _mat(ct_h.BT, xp),
                             tiles, _mat(ct_w.BT, xp))
            vs.append(v.reshape(r_tot, pp, c).transpose(0, 1))
    v4 = torch.cat(vs, 0)                            # (4P, R, C)
    u4 = u.to(dt).reshape(4 * pp, *u.shape[4:])      # (4P, Cg, M')

    # phase 2: 4P batched contractions, then the cross-phase sum in the
    # transform domain.
    if groups == 1:
        y = torch.bmm(v4, u4)
    elif depthwise:
        y = torch.einsum("prc,pcm->prcm", v4, u4).reshape(
            4 * pp, r_tot, c * u4.shape[-1])
    else:
        cg, mg = c // groups, u4.shape[-1] // groups
        y = torch.einsum("prgc,pcgm->prgm",
                         v4.reshape(4 * pp, r_tot, groups, cg),
                         u4.reshape(4 * pp, cg, groups, mg))
        y = y.reshape(4 * pp, r_tot, groups * mg)
    mout = y.shape[-1]
    y = y.reshape(4, pp, r_tot, mout).sum(0)

    # phase 3: one gather + inverse transform + NHWC scatter.
    y = y.transpose(0, 1).reshape(n, nh, nw, th, tw, mout)
    out = torch.einsum("it,nhwtum,ju->nhiwjm", _mat(ct_h.AT, y), y,
                       _mat(ct_w.AT, y))
    out = out.reshape(n, nh * mh, nw * mw, mout)
    return out[:, :geometry.out_h, :geometry.out_w, :].to(x.dtype)


# ---------------------------------------------------------------------------
# 1D depthwise causal Cook-Toom convolution (Mamba's short conv): the
# paper's 1D algorithm in depthwise form. The per-point GEMM over channels
# degenerates to an elementwise product, but the multiplication reduction
# (m*r/t) still applies per channel.
# ---------------------------------------------------------------------------

def ct_depthwise_causal_conv1d(x: torch.Tensor, w: torch.Tensor, *,
                               output_tile: int = 4) -> torch.Tensor:
    """Causal depthwise conv: y[b, l, c] = sum_k w[k, c] x[b, l - (r-1) + k, c].

    x (B, L, C), w (r, C) depthwise taps -> (B, L, C), same length (causal
    left pad of r - 1). Unplanned: plans the "jnp" backend per call."""
    from repro_torch.core.plan import plan_depthwise_conv1d  # imports this module
    return plan_depthwise_conv1d(x.shape, w, output_tile=output_tile,
                                 backend="jnp", device=x.device).apply(x)


def ct_depthwise_causal_conv1d_pretransformed(
    x: torch.Tensor, u: torch.Tensor, ct: CookToom, *, n_tiles: int,
    pad_hi: int,
) -> torch.Tensor:
    """Planned executor for the depthwise causal Cook-Toom conv: `u` is the
    pre-transformed (t, C) taps and the tile count / padding come from the
    plan (core.plan.plan_depthwise_conv1d). Computes in x's dtype, as the
    reference's jnp executor does."""
    b, length, c = x.shape
    # causal pad left r-1; pad right so tiles cover n_tiles * m outputs.
    xp = F.pad(x, (0, 0, ct.r - 1, pad_hi))
    tiles = _extract_tiles_1d(xp, 1, ct.t, ct.m, n_tiles)   # (B, nt, t, C)
    v = torch.einsum("it,bstc->bsic", _mat(ct.BT, x), tiles)
    y = v * u.to(x.dtype)[None, None]                     # Hadamard per channel
    out = torch.einsum("ot,bstc->bsoc", _mat(ct.AT, x), y).reshape(
        b, n_tiles * ct.m, c)
    return out[:, :length].to(x.dtype)
