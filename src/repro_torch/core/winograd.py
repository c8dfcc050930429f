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
channel GEMM with a Hadamard product over channels, grouped layers with a
block-diagonal GEMM (winograd_grouped_conv2d_pretransformed).

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

from repro_torch.core.transforms import CookToom, cook_toom

Padding = Literal["SAME", "VALID"]


#: Transform matrices already on a device, by (values, shape, dtype,
#: device): an executor reuses them, so a warm call copies nothing from the
#: host and a CUDA graph can capture it.
_MATS: dict = {}


def _mat(a: np.ndarray, like: torch.Tensor,
         dtype: torch.dtype | None = None) -> torch.Tensor:
    dtype = dtype or like.dtype
    key = (a.tobytes(), a.shape, dtype, like.device)
    t = _MATS.get(key)
    if t is None:
        # made outside inference mode whatever the first caller's mode: a
        # tensor made inside cannot be saved for a later training step's
        # backward
        with torch.inference_mode(False):
            t = _MATS[key] = torch.as_tensor(a, dtype=dtype,
                                             device=like.device)
    return t


# ---------------------------------------------------------------------------
# Filter transforms (done once per layer, at plan time)
# ---------------------------------------------------------------------------

def transform_filter_2d(w: torch.Tensor, ct_h: CookToom,
                        ct_w: CookToom) -> torch.Tensor:
    """(kh, kw, C, M) -> (th, tw, C, M): G_h w G_w^T over the spatial axes."""
    return torch.einsum("ij,jkcm,lk->ilcm", _mat(ct_h.G, w), w,
                        _mat(ct_w.G, w))


def transform_filter_1d(w: torch.Tensor, ct: CookToom) -> torch.Tensor:
    """(k, C, M) -> (t, C, M)."""
    return torch.einsum("ij,jcm->icm", _mat(ct.G, w), w)


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


def conv2d_fft_geometry(h: int, w: int, kh: int, kw: int, fft_h: int,
                        fft_w: int, padding: Padding) -> Conv2DGeometry:
    """Tiling geometry of the FFT executor (core/fft.py): the Winograd
    overlap tiling with the output tile set to fft - k + 1 per axis, so the
    padded extent n_tiles * m + k - 1 matches the last tile's transform
    window and the surplus outputs are cropped after the inverse
    transform."""
    return conv2d_geometry(h, w, kh, kw, fft_h - kh + 1, fft_w - kw + 1,
                           padding)


class Axis1DGeometry(NamedTuple):
    """Static tiling geometry of the 1xN / Nx1 (single-axis) algorithm."""

    axis: int         # spatial axis the filter runs along (1 = H, 2 = W)
    lo: int
    hi: int
    n_t: int          # tile count along the axis
    out_size: int


def conv1d_axis_geometry(size: int, axis: int, k: int, m: int,
                         padding: Padding) -> Axis1DGeometry:
    lo, hi, nt = _pad_amounts(size, k, m, padding)
    out = size if padding == "SAME" else size - k + 1
    return Axis1DGeometry(axis, lo, hi, nt, out)


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
    """Halo-blocking geometry of the streaming kernels
    (kernels/winograd.py, kernels/depthwise.py), derived once at plan
    time.

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


#: Streaming multiprocessors of the target card (H100 SXM), used when the
#: plan is made for a CPU device; a CUDA plan passes its card's count.
H100_SMS = 132


# The tensor-core kernels' fixed shape; these must agree with
# kernels/csrc/winograd_tc.cuh (the body of winograd_streamed.cu,
# winograd_strided_streamed.cu and winograd_fused.cu), which rejects any
# other blocking.
TC_THREADS = 256
TC_WARPS = TC_THREADS // 32
TC_MAX_T = 8                  # largest input tile per axis
#: Shared memory one block may take (an H100 SM holds 228 KB, 1 KB of it
#: reserved per block).
TC_SMEM_MAX = 227 * 1024
TC_SMEM_PER_SM = 228 * 1024
#: (kMT, kNT) warp tiles of winograd_tc.cuh by transform size T
#: (winograd_tc_tile): a block holds bR = 16 * kMT tiles and bM = 8 * kNT
#: output channels, each warp ceil(T^2 / 8) whole Winograd points of them,
#: so a thread keeps ceil(T^2 / 8) * kMT * kNT * 4 fp32 accumulators (at
#: most 80) beside the transform's T x T arrays.
WINOGRAD_TC_CONFIGS = {3: ((1, 4), (1, 8), (2, 4)),
                       4: ((1, 4), (1, 8), (2, 4)),
                       5: ((1, 2), (1, 4), (2, 2)),
                       6: ((1, 2), (1, 4), (2, 2)),
                       8: ((1, 2),)}
WINOGRAD_TC_BLOCK_C = (8, 16, 32)
#: The menu of the tiles-domain kernel (winograd_fused.cu): the streamed
#: kernels' plus (1, 1) at T = 8, where the (1, 2) blocking's two
#: (16, 64, 12)-float tile stages leave no room in TC_SMEM_MAX.
FUSED_TC_CONFIGS = {**WINOGRAD_TC_CONFIGS, 8: ((1, 1), (1, 2))}
#: Weights of the time model the tensor-core choosers score a blocking
#: with (tc_block_terms, separable_block_terms): nanoseconds per unit of
#: each term, and the share of a block's time that a co-resident block
#: adds. Non-negative least-squares fits (relative error; 15.1 % and
#: 15.9 % rms over 30 and 329 blockings) to the `chip_smoke.py --sweep`
#: device times of VGG-16's conv3_1 and conv5_1 and of MobileNet-v1's
#: sep14 and MobileNet-v2's ir8, on an H100 (PERF.md). A term
#: the fit weighs 0 is kept: the model names what was tried. The stride-2
#: chooser (phases=4) shares TC_COST: on the stems' sweep it reads 81 % rms
#: (it overcounts their C = 3 steps) but picks within 0.3 % of the best
#: blocking swept (PERF.md).
TC_COST = {"step": 0.0, "load": 0.0, "mma": 32.96, "xform": 6.498,
           "tail": 0.0, "block": 12610.0, "share": 0.3}
SEPARABLE_COST = {"step": 479.9, "load": 0.0, "dw": 10.22, "mma": 51.69,
                  "block": 0.0, "share": 0.3}


def model_time(terms: dict, waves: int, bps: int, cost: dict) -> float:
    """A blocking's modelled time in nanoseconds: its block's terms weighted
    by `cost`, times its waves, a co-resident block adding cost["share"]
    of the time."""
    block = sum(cost[k] * v for k, v in terms.items())
    return waves * block * (1 + cost["share"] * (bps - 1))


def tc_tile(th: int, tw: int) -> int:
    """separable_streamed.cu's transform size: the larger tile side
    rounded up to 4, 6 or 8 (its register arrays are T x T)."""
    t = max(th, tw)
    return 4 if t <= 4 else 6 if t <= 6 else 8


def winograd_tc_tile(th: int, tw: int) -> int:
    """winograd_tc.cuh's transform size: the larger tile side, 3 at the
    least, 7 rounded up to 8 (its register arrays are T x T). A square
    tile of the main path's filters (F(2, 3), F(4, 3) at stride 1; the
    stems' F(2, 2), F(4, 2) phase tiles at stride 2) runs guard-free."""
    t = max(th, tw, 3)
    return 8 if t == 7 else t


def u_row_bytes(bm: int, size: int) -> int:
    """Bytes between two rows of a staged (k, bM) operand tile in the
    tensor-core kernels (kernels/csrc/mma_tf32x3.cuh:u_row_bytes): a
    multiple of 16 that is 32 or 96 mod 128."""
    b = -(-bm * size // 16) * 16
    while b % 128 not in (32, 96):
        b += 16
    return b


def stream_tc_smem_bytes(ct_h: CookToom, ct_w: CookToom, bh: int, bw: int,
                         bc: int, bm: int, u_size: int = 4) -> int:
    """Dynamic shared memory of one winograd_tc.cuh block: two stages
    of the strip (sh, sw, bc + 4) and of the raw filter chunk (P, bc, row),
    and V (P, bR, bc + 4), during the C sweep; the (P, bR, bM + 4)
    accumulator spill after it reuses the space."""
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    p, br = th * tw, bh * bw
    strip = (bh * mh + th - mh) * (bw * mw + tw - mw) * (bc + 4)
    stage = (4 * (2 * strip + p * br * (bc + 4))
             + 2 * p * bc * u_row_bytes(bm, u_size))
    return max(stage, 4 * p * br * (bm + 4))


def stream_tc_blocking_fits(ct_h: CookToom, ct_w: CookToom, bh: int,
                            bw: int, bc: int, bm: int,
                            u_size: int = 4) -> bool:
    """Whether winograd_tc.cuh takes a block of bh x bw tiles, bc
    channels per C step and bm output channels: (bh*bw / 16, bm / 8) on
    its menu for the tile's T, bc in 8 / 16 / 32, bw a power of two, and
    the shared memory."""
    br = bh * bw
    if br % 16 or bm % 8 or bc not in WINOGRAD_TC_BLOCK_C or bw & (bw - 1):
        return False
    if (br // 16, bm // 8) not in \
            WINOGRAD_TC_CONFIGS[winograd_tc_tile(ct_h.t, ct_w.t)]:
        return False
    return stream_tc_smem_bytes(ct_h, ct_w, bh, bw, bc, bm,
                                u_size) <= TC_SMEM_MAX


# The warp-specialised stride-1 body's fixed shape; these must agree with
# kernels/csrc/winograd_ws.cuh, which winograd_streamed.cu launches for
# every tile up to 6 x 6 (stream_body).
WS_CONSUMER_WARPS = 8         # two consumer warpgroups: the point-GEMMs
WS_PRODUCERS = 128            # one producer warpgroup: staging, transform
WS_CONSUMERS = 32 * WS_CONSUMER_WARPS
WS_BLOCK_C = 8                # channels per C step: one m16n8k8 k-step
WS_BAR_BYTES = 64             # the ring's mbarriers, ahead of it
#: (kMT, kNT) of winograd_ws.cuh by its transform size (winograd_ws_tile):
#: a block holds bR = 16 * kMT tiles and bM = 8 * kNT output channels;
#: consumer warp w owns points w, w + 8, ..., so a consumer thread keeps
#: ceil(T^2 / 8) * kMT * kNT * 4 accumulators (at most 160) and no
#: transform arrays: the producer warpgroup holds those.
WINOGRAD_WS_CONFIGS = {4: ((1, 4), (1, 8), (2, 4), (2, 8)),
                       6: ((1, 2), (1, 4), (1, 8), (2, 4))}
#: Weights of the warp-specialised body's time model (ws_block_terms), as
#: TC_COST: nanoseconds per unit of each term, one block an SM. A
#: non-negative least-squares fit (relative error; 2.85 % rms over 282
#: blockings) to the `chip_smoke.py --sweep winograd_streamed` device times
#: of six VGG-16 convs at batches 32, 8 and 1 on an H100 (PERF.md): a C
#: step costs a fixed ~1.2 us, then its staged bytes and its busiest
#: consumer warp's products; the producer's transform hides under them
#: (weight 0).
WS_COST = {"step": 1198.0, "load": 0.01511, "mma": 9.975, "xform": 0.0,
           "tail": 7.412, "block": 575.3, "share": 0.0}


def winograd_ws_tile(th: int, tw: int) -> int | None:
    """winograd_ws.cuh's transform size: 4 for tiles up to 4 x 4, 6 up to
    6 x 6 (F(2, 3) and F(4, 3) run guard-free); None past 6, where the
    producer's T x T arrays leave the register split no room."""
    t = max(th, tw)
    return 4 if t <= 4 else 6 if t <= 6 else None


def stream_body(ct_h: CookToom, ct_w: CookToom, phases: int = 1) -> str:
    """Which body runs a streamed conv: "ws" (winograd_ws.cuh, warp-
    specialised) for stride-1 tiles up to 6 x 6, else "tc"
    (winograd_tc.cuh: the stride-2 kernel, and stride-1 tiles of 7 and
    8). winograd_streamed_launch routes by the same rule."""
    if phases == 1 and winograd_ws_tile(ct_h.t, ct_w.t) is not None:
        return "ws"
    return "tc"


def stream_ws_smem_bytes(ct_h: CookToom, ct_w: CookToom, bh: int, bw: int,
                         bm: int, u_size: int = 4) -> int:
    """Dynamic shared memory of one winograd_ws.cuh block: the mbarriers,
    then two slots each of the strip (sh, sw, 8), of V (P, bR, 8) and of
    the raw filter chunk (P, 8, row) during the C sweep; the (P, bR,
    bM + 4) accumulator spill after it reuses the ring."""
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    p, br = th * tw, bh * bw
    strip = (bh * mh + th - mh) * (bw * mw + tw - mw) * WS_BLOCK_C
    ring = (4 * (2 * strip + 2 * p * br * WS_BLOCK_C)
            + 2 * p * WS_BLOCK_C * u_row_bytes(bm, u_size))
    return WS_BAR_BYTES + max(ring, 4 * p * br * (bm + 4))


def stream_ws_blocking_fits(ct_h: CookToom, ct_w: CookToom, bh: int,
                            bw: int, bc: int, bm: int,
                            u_size: int = 4) -> bool:
    """Whether winograd_ws.cuh takes a block of bh x bw tiles, bc channels
    per C step and bm output channels: a tile up to 6 x 6, (bh*bw / 16,
    bm / 8) on its menu, bc 8, bw a power of two, and the shared memory."""
    t = winograd_ws_tile(ct_h.t, ct_w.t)
    br = bh * bw
    if t is None or br % 16 or bm % 8 or bc != WS_BLOCK_C or bw & (bw - 1):
        return False
    if (br // 16, bm // 8) not in WINOGRAD_WS_CONFIGS[t]:
        return False
    return stream_ws_smem_bytes(ct_h, ct_w, bh, bw, bm,
                                u_size) <= TC_SMEM_MAX


def stream_blocking_fits(ct_h: CookToom, ct_w: CookToom, bh: int, bw: int,
                         bc: int, bm: int, u_size: int = 4,
                         phases: int = 1) -> bool:
    """Whether the streamed kernel at `phases` (1: winograd_streamed.cu,
    4: winograd_strided_streamed.cu) takes the blocking: the rule of the
    body that runs the tiles (stream_body)."""
    if stream_body(ct_h, ct_w, phases) == "ws":
        return stream_ws_blocking_fits(ct_h, ct_w, bh, bw, bc, bm, u_size)
    return stream_tc_blocking_fits(ct_h, ct_w, bh, bw, bc, bm, u_size)


def ws_block_terms(ct_h: CookToom, ct_w: CookToom, c: int, mout: int,
                   bh: int, bw: int, bm: int, *, n_h: int, n_w: int,
                   batch: int = 1, sms: int = H100_SMS,
                   u_size: int = 4) -> tuple[dict, int, int]:
    """(terms, waves, blocks per SM) of one winograd_ws.cuh blocking, in
    tc_block_terms's keys: per block its C steps of 8 channels, the bytes
    it stages (filter chunks and strips), the TF32 products of its busiest
    consumer warp, the producer's transform work per thread (items per
    producer thread times T^3) and the consumers' inverse transform; one
    block an SM (384 threads at 168 registers), in waves."""
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    t = winograd_ws_tile(th, tw)
    p, pts = th * tw, -(-t * t // WS_CONSUMER_WARPS)
    br, kmt, knt = bh * bw, bh * bw // 16, bm // 8
    steps = -(-c // WS_BLOCK_C)
    strip = (bh * mh + th - mh) * (bw * mw + tw - mw) * WS_BLOCK_C * 4
    terms = {"step": steps,
             "load": steps * (p * WS_BLOCK_C * bm * u_size + strip),
             "mma": steps * pts * kmt * knt * (3 if u_size == 4 else 2),
             "xform": steps * -(-br * WS_BLOCK_C // WS_PRODUCERS) * t ** 3,
             "tail": -(-br * bm // WS_CONSUMERS) * t ** 3,
             "block": 1}
    blocks = (batch * -(-n_h // bh) * -(-n_w // bw) * -(-mout // bm))
    return terms, -(-blocks // sms), 1


def tc_block_terms(ct_h: CookToom, ct_w: CookToom, c: int, mout: int,
                   bh: int, bw: int, bc: int, bm: int, *, n_h: int,
                   n_w: int, batch: int = 1, sms: int = H100_SMS,
                   u_size: int = 4, phases: int = 1) -> tuple[dict, int, int]:
    """(terms, waves, blocks per SM) of one winograd_tc.cuh blocking:
    per block its C steps (`phases` times C / bc: the stride-2 kernel runs
    its C sweep once per input phase), the bytes it stages (filter chunks
    and strips), the TF32 products of its busiest warp, the transform work
    per thread (items per thread times T^3) and the inverse transform's;
    the waves of blocks the card's `sms` multiprocessors run, each holding
    as many blocks as registers and shared memory allow."""
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    t = winograd_tc_tile(th, tw)
    p, pts = th * tw, -(-t * t // TC_WARPS)
    br, kmt, knt = bh * bw, bh * bw // 16, bm // 8
    steps = phases * -(-c // bc)
    smem = stream_tc_smem_bytes(ct_h, ct_w, bh, bw, bc, bm, u_size)
    bps = min(2 if pts * kmt * knt * 4 <= 64 and t <= 6 else 1,
              TC_SMEM_PER_SM // (smem + 1024))
    strip = (bh * mh + th - mh) * (bw * mw + tw - mw) * bc * 4
    terms = {"step": steps,
             "load": steps * (p * bc * bm * u_size + strip),
             "mma": steps * pts * (bc // 8) * kmt * knt
             * (3 if u_size == 4 else 2),
             "xform": steps * -(-br * bc // TC_THREADS) * t ** 3,
             "tail": -(-br * bm // TC_THREADS) * t ** 3,
             "block": 1}
    blocks = (batch * -(-n_h // bh) * -(-n_w // bw) * -(-mout // bm))
    return terms, -(-blocks // (sms * bps)), bps


def stream_geometry_tf32x3(n_h: int, n_w: int, c: int, mout: int,
                           ct_h: CookToom, ct_w: CookToom, *,
                           batch: int = 1, sms: int = H100_SMS,
                           u_size: int = 4,
                           phases: int = 1) -> StreamGeometry:
    """Blocking of the tensor-core streaming kernels, once, at plan time:
    the stride-1 kernel (kernels/csrc/winograd_streamed.cu) at `phases` 1,
    the stride-2 one (winograd_strided_streamed.cu, the same body with a
    loop over the four input phases around its C sweep) at 4, where n_h /
    n_w count the phase grid's tiles. `u_size` is the filter's bytes per
    value (4 fp32, 2 bf16, 1 int8).

    A candidate is a (bh, bw) strip of bR = bh*bw tiles, a C step bc and
    bM output channels that the body running the tiles takes
    (stream_body: the warp-specialised one for stride-1 tiles up to
    6 x 6, stream_ws_blocking_fits; else stream_tc_blocking_fits). Its
    score is that body's modelled time (model_time of ws_block_terms with
    WS_COST, or of tc_block_terms with TC_COST, each fitted to the card):
    per block, a cost per C step, per staged byte, per TF32 product of the
    busiest warp and per transform item, the inverse transform and a
    fixed cost; the blocks in waves. Smaller blocks fill the grid of the
    deep layers at small batches (conv5_x); wider M blocks share each
    transform among more channels where the grid is large. Ties go to the
    fewer padded tiles, then the larger block.
    """
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    if max(th, tw) > TC_MAX_T:
        raise ValueError(
            f"input tile ({th}, {tw}) exceeds the streaming kernel's "
            f"{TC_MAX_T}; use a smaller output_tile")
    if stream_body(ct_h, ct_w, phases) == "ws":
        menu = WINOGRAD_WS_CONFIGS[winograd_ws_tile(th, tw)]
        block_cs, cost = (WS_BLOCK_C,), WS_COST

        def terms_of(bh, bw, bc, bm):
            return ws_block_terms(ct_h, ct_w, c, mout, bh, bw, bm, n_h=n_h,
                                  n_w=n_w, batch=batch, sms=sms,
                                  u_size=u_size)
    else:
        menu = WINOGRAD_TC_CONFIGS[winograd_tc_tile(th, tw)]
        block_cs, cost = WINOGRAD_TC_BLOCK_C, TC_COST

        def terms_of(bh, bw, bc, bm):
            return tc_block_terms(ct_h, ct_w, c, mout, bh, bw, bc, bm,
                                  n_h=n_h, n_w=n_w, batch=batch, sms=sms,
                                  u_size=u_size, phases=phases)
    best = None
    min_bm = min(8 * knt for _, knt in menu)
    for kmt, knt in menu:
        br, bm = 16 * kmt, 8 * knt
        if bm > max(min_bm, mout):
            continue
        for bc in block_cs:
            if bc > 8 and bc > c:
                continue
            for bh in (b for b in (1, 2, 4, 8, 16, 32) if b <= br):
                bw = br // bh
                if not stream_blocking_fits(ct_h, ct_w, bh, bw, bc, bm,
                                            u_size, phases):
                    continue
                terms, waves, bps = terms_of(bh, bw, bc, bm)
                n_hb, n_wb = -(-n_h // bh), -(-n_w // bw)
                score = (model_time(terms, waves, bps, cost),
                         n_hb * bh * n_wb * bw, -br * bm)
                if best is None or score < best[0]:
                    best = (score, (bh, bw, n_hb, n_wb, bc, bm))
    if best is None:
        raise ValueError(
            f"no blocking of the ({n_h}, {n_w})-tile grid (C={c}, M={mout}, "
            f"t=({th}, {tw})) fits the tensor-core streaming kernel")
    bh, bw, n_hb, n_wb, bc, bm = best[1]
    return StreamGeometry(bh=bh, bw=bw, n_hb=n_hb, n_wb=n_wb,
                          pad_h=(n_hb * bh - n_h) * mh,
                          pad_w=(n_wb * bw - n_w) * mw, block_c=bc,
                          block_m=bm, c_pad=-(-c // bc) * bc,
                          m_pad=-(-mout // bm) * bm)


def _pow2_upto(n: int, cap: int) -> list[int]:
    """Powers of two up to the first one >= n, at most cap; at least up to
    2, so a 1-tile axis still pairs 2 regions."""
    top = 2
    while top < n:
        top *= 2
    return [b for b in (1, 2, 4, 8, 16, 32) if b <= min(top, cap)]


def fused_smem_bytes(ct_h: CookToom, ct_w: CookToom, br: int, bc: int,
                     bm: int) -> int:
    """Dynamic shared memory of one winograd_fused.cu block (the
    tensor-core body over pre-extracted tiles, fp32 filter): two tile
    stages (bR, P, bc + 4) and two filter stages (P, bc, row) and V
    (P, bR, bc + 4) during the C sweep; the (P, bR, bM + 4) accumulator
    spill after it reuses the space (winograd_tc.cuh:smem_bytes)."""
    p = ct_h.t * ct_w.t
    stage = (4 * (2 * br * p * (bc + 4) + p * br * (bc + 4))
             + 2 * p * bc * u_row_bytes(bm, 4))
    return max(stage, 4 * p * br * (bm + 4))


def fused_blocking_fits(ct_h: CookToom, ct_w: CookToom, br: int, bc: int,
                        bm: int) -> bool:
    """Whether winograd_fused.cu takes a block of br tiles, bc channels per
    C step and bm output channels: (br / 16, bm / 8) on its menu
    (FUSED_TC_CONFIGS) for the tile's T, bc in 8 / 16 / 32, and the shared
    memory."""
    if br % 16 or bm % 8 or bc not in WINOGRAD_TC_BLOCK_C:
        return False
    if (br // 16, bm // 8) not in \
            FUSED_TC_CONFIGS[winograd_tc_tile(ct_h.t, ct_w.t)]:
        return False
    return fused_smem_bytes(ct_h, ct_w, br, bc, bm) <= TC_SMEM_MAX


def fused_block_terms(ct_h: CookToom, ct_w: CookToom, r_tot: int, c: int,
                      mout: int, br: int, bc: int, bm: int, *,
                      sms: int = H100_SMS) -> tuple[dict, int, int]:
    """(terms, waves, blocks per SM) of one winograd_fused.cu blocking, the
    terms of tc_block_terms with the tile stage (bR, P, bc) in place of the
    strip: per block its C steps, the bytes it stages, the TF32 products of
    its busiest warp, the transform work per thread and the inverse
    transform's; the blocks (R / bR x M / bM) in waves."""
    t = winograd_tc_tile(ct_h.t, ct_w.t)
    p, pts = ct_h.t * ct_w.t, -(-t * t // TC_WARPS)
    kmt, knt = br // 16, bm // 8
    steps = -(-c // bc)
    smem = fused_smem_bytes(ct_h, ct_w, br, bc, bm)
    bps = min(2 if pts * kmt * knt * 4 <= 64 and t <= 6 else 1,
              TC_SMEM_PER_SM // (smem + 1024))
    terms = {"step": steps,
             "load": steps * (p * bc * bm * 4 + br * p * bc * 4),
             "mma": steps * pts * (bc // 8) * kmt * knt * 3,
             "xform": steps * -(-br * bc // TC_THREADS) * t ** 3,
             "tail": -(-br * bm // TC_THREADS) * t ** 3,
             "block": 1}
    blocks = -(-r_tot // br) * -(-mout // bm)
    return terms, -(-blocks // (sms * bps)), bps


def winograd_blocks(r_tot: int, c: int, mout: int, ct_h: CookToom,
                    ct_w: CookToom, *, sms: int = H100_SMS
                    ) -> tuple[int, int, int]:
    """(block_r, block_c, block_m) of the tiles-domain kernel
    (kernels/csrc/winograd_fused.cu, the tensor-core body over
    pre-extracted tiles), once, at plan time: (16 kMT, bc, 8 kNT) with
    (kMT, kNT) from FUSED_TC_CONFIGS and bc in 8 / 16 / 32, among the
    blockings fused_blocking_fits takes. The score is the modelled time
    (model_time of fused_block_terms, weights TC_COST, the streamed
    kernel's fit); ties go to the fewer padded tiles, then the larger
    block."""
    th, tw = ct_h.t, ct_w.t
    if max(th, tw) > TC_MAX_T:
        raise ValueError(
            f"input tile ({th}, {tw}) exceeds the tiles-domain kernel's "
            f"{TC_MAX_T}; use a smaller output_tile")
    t = winograd_tc_tile(th, tw)
    min_bm = min(8 * knt for _, knt in FUSED_TC_CONFIGS[t])
    best = None
    for kmt, knt in FUSED_TC_CONFIGS[t]:
        br, bm = 16 * kmt, 8 * knt
        if bm > max(min_bm, mout):
            continue
        for bc in WINOGRAD_TC_BLOCK_C:
            if (bc > 8 and bc > c) or \
                    not fused_blocking_fits(ct_h, ct_w, br, bc, bm):
                continue
            terms, waves, bps = fused_block_terms(
                ct_h, ct_w, r_tot, c, mout, br, bc, bm, sms=sms)
            score = (model_time(terms, waves, bps, TC_COST),
                     -(-r_tot // br) * br, -br * bm)
            if best is None or score < best[0]:
                best = (score, (br, bc, bm))
    if best is None:
        raise ValueError(f"no blocking of the tiles-domain kernel fits "
                         f"tiles ({th}, {tw})")
    return best[1]


# The depthwise kernels' fixed shape; these must agree with
# kernels/csrc/depthwise_streamed.cu (stride 1) and
# kernels/csrc/depthwise_strided_streamed.cu (stride 2).
DEPTHWISE_THREADS = 256       # threads per block
DEPTHWISE_MAX_T = 8           # largest input tile per axis
#: C steps of both kernels: a warp covers one tile's bc channels, 1 or 2
#: adjacent ones per thread (depthwise_cpt), or 32 / bc tiles of bc < 32
#: channels.
DEPTHWISE_BLOCK_C = (8, 16, 32, 64)
#: Blocks of 256 threads one SM holds by both kernels' registers (their
#: __launch_bounds__ minimum, by T: 3 blocks, 24 warps, up to T = 4, 2 at
#: T = 5, 6 and 1 above, where the generic body would spill at a tighter
#: cap). Shared memory may allow fewer (depthwise_block_terms,
#: depthwise_strided_block_terms).
DEPTHWISE_BLOCKS_PER_SM = {2: 3, 3: 3, 4: 3, 5: 2, 6: 2, 7: 1, 8: 1}
#: Weights of the stride-1 chooser's time model (depthwise_block_terms),
#: nanoseconds per unit of each term, as TC_COST: a non-negative
#: least-squares fit (16.3 % rms over 1542 blockings) to the `chip_smoke.py
#: --sweep depthwise_streamed` device times of every stride-1 depthwise
#: layer of MobileNet-v1 and v2 at bf16 and int8 on an H100 (PERF.md).
DEPTHWISE_COST = {"load": 0.114, "store": 0.0, "item": 6.533,
                  "block": 1125.7, "share": 0.3}
#: Weights of the stride-2 chooser's time model
#: (depthwise_strided_block_terms), nanoseconds per unit of each term, as
#: DEPTHWISE_COST: a non-negative least-squares fit (12.6 % rms over the
#: 3624 blockings of two runs, with a per-launch constant "launch" outside
#: the waves, which no choice depends on) to the `chip_smoke.py --sweep
#: depthwise_strided_streamed` device times of the eight stride-2
#: depthwise layers of MobileNet-v1 and v2 at fp32, bf16 and int8 on an
#: H100 (PERF.md).
DEPTHWISE_STRIDED_COST = {"load": 0.0438, "pix": 0.2246, "store": 0.0,
                          "item": 2.463, "block": 394.2, "launch": 3349.3,
                          "share": 0.5}


def depthwise_cpt(bc: int) -> int:
    """Channels one thread of depthwise_streamed.cu and
    depthwise_strided_streamed.cu computes per item: bc / 32 (a warp on one
    tile's bc channels), at least 1, at most 2."""
    return min(max(bc // 32, 1), 2)


def depthwise_smem_bytes(ct_h: CookToom, ct_w: CookToom, bh: int, bw: int,
                         bc: int, mult: int = 1) -> int:
    """Dynamic shared memory of one depthwise_streamed.cu block: the halo
    strip (bh*mh + th - mh, bw*mw + tw - mw, bc) and the block's taps
    (mult, P, bc), scale (mult, bc) and bias (mult, bc) rows, all fp32."""
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    strip = (bh * mh + th - mh) * (bw * mw + tw - mw) * bc
    return 4 * (strip + (th * tw + 2) * mult * bc)


def depthwise_blocking_fits(ct_h: CookToom, ct_w: CookToom, bh: int,
                            bw: int, bc: int, mult: int = 1) -> bool:
    """Whether depthwise_streamed.cu takes a block of bh x bw tiles by bc
    channels: bc in DEPTHWISE_BLOCK_C, bw a power of two, and the shared
    memory within TC_SMEM_MAX."""
    if bc not in DEPTHWISE_BLOCK_C or bh < 1 or bw < 1 or bw & (bw - 1):
        return False
    return depthwise_smem_bytes(ct_h, ct_w, bh, bw, bc, mult) <= TC_SMEM_MAX


def depthwise_block_terms(ct_h: CookToom, ct_w: CookToom, c: int, bh: int,
                          bw: int, bc: int, *, n_h: int, n_w: int,
                          batch: int = 1, sms: int = H100_SMS
                          ) -> tuple[dict, int, int]:
    """(terms, waves, blocks per SM) of one depthwise_streamed.cu blocking
    (per output channel set: the multiplier scales every candidate alike):
    per block the bytes it stages (the halo strip) and stores (its outputs),
    the (tile, channel group) items per thread and a fixed cost; the blocks
    in waves, each SM holding DEPTHWISE_BLOCKS_PER_SM blocks or as many as
    the shared memory allows."""
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    t = max(th, tw)
    smem = depthwise_smem_bytes(ct_h, ct_w, bh, bw, bc)
    bps = min(DEPTHWISE_BLOCKS_PER_SM[t], TC_SMEM_PER_SM // (smem + 1024))
    strip = (bh * mh + th - mh) * (bw * mw + tw - mw) * bc
    terms = {"load": 4 * strip, "store": 4 * bh * mh * bw * mw * bc,
             "item": -(-bh * bw * bc // (depthwise_cpt(bc) * DEPTHWISE_THREADS)),
             "block": 1}
    blocks = batch * -(-n_h // bh) * -(-n_w // bw) * -(-c // bc)
    return terms, -(-blocks // (sms * bps)), bps


def depthwise_strided_smem_bytes(ct_h: CookToom, ct_w: CookToom, bh: int,
                                 bw: int, bc: int) -> int:
    """Dynamic shared memory of one depthwise_strided_streamed.cu block:
    the full-resolution halo strip (2*(bh*mh + th - mh), 2*(bw*mw + tw -
    mw), bc) and the block's phase taps (4P, bc), scale (bc) and bias (bc)
    rows, all fp32."""
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    strip = 4 * (bh * mh + th - mh) * (bw * mw + tw - mw) * bc
    return 4 * (strip + (4 * th * tw + 2) * bc)


def depthwise_strided_blocking_fits(ct_h: CookToom, ct_w: CookToom, bh: int,
                                    bw: int, bc: int) -> bool:
    """Whether depthwise_strided_streamed.cu takes a block of bh x bw
    output tiles by bc channels: bc in DEPTHWISE_BLOCK_C, bw a power of
    two, and the shared memory within TC_SMEM_MAX."""
    if bc not in DEPTHWISE_BLOCK_C or bh < 1 or bw < 1 or bw & (bw - 1):
        return False
    return depthwise_strided_smem_bytes(ct_h, ct_w, bh, bw, bc) <= TC_SMEM_MAX


def depthwise_strided_block_terms(ct_h: CookToom, ct_w: CookToom, c: int,
                                  bh: int, bw: int, bc: int, *, n_h: int,
                                  n_w: int, batch: int = 1,
                                  sms: int = H100_SMS
                                  ) -> tuple[dict, float, int]:
    """(terms, waves, blocks per SM) of one depthwise_strided_streamed.cu
    blocking: per block the bytes it stages (the full-resolution strip),
    the strip's pixels (one copy of bc channels each), the bytes it stores
    (its outputs), a thread's (tile, channel group) items times T^4 (each
    item runs four T x T phase transforms, its channels one after another
    but on the F(2, 2) body; T^4 fits the sweeps' T = 3 and 5 rows better
    than T^2 or T^3, PERF.md) and a fixed cost. `waves` is the
    busiest SM's share of the blocks over the blocks it holds at once,
    DEPTHWISE_BLOCKS_PER_SM or as many as the shared memory allows: a
    fraction, since blocks this short start as others end (whole waves fit
    the sweep's times worse, PERF.md)."""
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    t = max(th, tw)
    smem = depthwise_strided_smem_bytes(ct_h, ct_w, bh, bw, bc)
    bps = min(DEPTHWISE_BLOCKS_PER_SM[t], TC_SMEM_PER_SM // (smem + 1024))
    strip = 4 * (bh * mh + th - mh) * (bw * mw + tw - mw) * bc
    cpt = depthwise_cpt(bc)
    items = -(-bh * bw * bc // (cpt * DEPTHWISE_THREADS))
    # the F(2, 2) body computes an item's channels side by side, the
    # others one after another
    serial = 1 if (th, tw, mh, mw) == (3, 3, 2, 2) else cpt
    terms = {"load": 4 * strip, "pix": strip // bc,
             "store": 4 * bh * mh * bw * mw * bc,
             "item": items * serial * t ** 4, "block": 1}
    blocks = batch * -(-n_h // bh) * -(-n_w // bw) * -(-c // bc)
    return terms, -(-blocks // sms) / bps, bps


def stream_geometry_depthwise(n_h: int, n_w: int, c: int, ct_h: CookToom,
                              ct_w: CookToom, *, mult: int = 1,
                              stride: int = 1, batch: int = 1,
                              sms: int = H100_SMS) -> StreamGeometry:
    """Blocking of the depthwise kernels, once, at plan time: stride 1
    (kernels/csrc/depthwise_streamed.cu) and stride 2
    (kernels/csrc/depthwise_strided_streamed.cu, n_h / n_w counting the
    phase grid's tiles).

    A block is a (bh, bw) strip of tiles by bC channels, channels fastest.
    Edge strips are covered by padding the input to whole strips and C to
    whole channel steps, as in stream_geometry_tf32x3. block_m = block_c *
    mult and m_pad = c_pad * mult count the output channels: output o =
    c * mult + j. A channel multiplier `mult` > 1 (stride 1 only) scales
    every candidate's work alike and leaves the choice as it is.

    Both kernels stage the block's halo strip (at stride 2 its
    full-resolution window) and its taps in shared memory and run 256
    threads over the block's (tile, channel group) items,
    depthwise_cpt(bc) adjacent channels an item. Candidates pass the
    kernel's fit rule (depthwise_blocking_fits, stride 2
    depthwise_strided_blocking_fits; bh, bw up to 16, bc up to C rounded
    up to 8); the score is the modelled time (model_time of
    depthwise_block_terms with DEPTHWISE_COST, stride 2
    depthwise_strided_block_terms with DEPTHWISE_STRIDED_COST, both fitted
    to the card), then the fewer padded (tile, channel) items, then the
    larger block.
    """
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    if max(th, tw) > DEPTHWISE_MAX_T:
        raise ValueError(
            f"input tile ({th}, {tw}) exceeds the depthwise kernels' "
            f"{DEPTHWISE_MAX_T}; use a smaller output_tile")
    best = None
    for bc in DEPTHWISE_BLOCK_C:
        if bc > 8 and bc > -(-c // 8) * 8:
            continue
        c_pad = -(-c // bc) * bc
        for bh in _pow2_upto(n_h, 16):
            for bw in _pow2_upto(n_w, 16):
                if stride == 1:
                    if not depthwise_blocking_fits(ct_h, ct_w, bh, bw, bc,
                                                   mult):
                        continue
                    terms, waves, bps = depthwise_block_terms(
                        ct_h, ct_w, c, bh, bw, bc, n_h=n_h, n_w=n_w,
                        batch=batch, sms=sms)
                    cost = DEPTHWISE_COST
                else:
                    if not depthwise_strided_blocking_fits(ct_h, ct_w, bh,
                                                           bw, bc):
                        continue
                    terms, waves, bps = depthwise_strided_block_terms(
                        ct_h, ct_w, c, bh, bw, bc, n_h=n_h, n_w=n_w,
                        batch=batch, sms=sms)
                    cost = DEPTHWISE_STRIDED_COST
                n_hb, n_wb = -(-n_h // bh), -(-n_w // bw)
                score = (model_time(terms, waves, bps, cost),
                         n_hb * bh * n_wb * bw * c_pad, -bh * bw * bc)
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
SEPARABLE_BLOCK_C = (8, 16, 32, 64, 128)
#: (16-pixel, 8-channel) output tiles one warp may own; the kernel holds
#: 4 fp32 accumulators for each.
SEPARABLE_PAIRS = (1, 2, 4, 8, 16)
def separable_w_row(bm: int) -> int:
    """Floats between two rows of the staged pointwise chunk: bm + 8
    unless bm is 8 mod 16 (a row is then 32 or 96 bytes mod 128)."""
    return bm if bm % 16 == 8 else bm + 8


def separable_smem_bytes(ct_h: CookToom, ct_w: CookToom, bh: int, bw: int,
                         bc: int, bm: int) -> int:
    """Dynamic shared memory of one separable_streamed.cu block: two
    stages of the strip (sh, sw, bc + 4), the taps (P, bc) and the
    pointwise chunk (bc, row), and z's two TF32 halves (S, bc + 4)."""
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    strip = (bh * mh + th - mh) * (bw * mw + tw - mw) * (bc + 4)
    z = bh * mh * bw * mw * (bc + 4)
    return 4 * (2 * (strip + th * tw * bc + bc * separable_w_row(bm))
                + 2 * z)


def separable_blocking_fits(ct_h: CookToom, ct_w: CookToom, bh: int,
                            bw: int, bc: int, bm: int) -> bool:
    """Whether separable_streamed.cu takes a block of bh x bw tiles, bc
    channels per C step and bm output channels: bc in 8 / 16 / 32 / 64 /
    128, bm
    in 8s, bw a power of two, S = bh*mh * bw*mw pixels in 16s, at most
    8 * 16 output tiles of 16 pixels x 8 channels, and the shared
    memory."""
    s = bh * ct_h.m * bw * ct_w.m
    if (bc not in SEPARABLE_BLOCK_C or bm < 8 or bm % 8 or s % 16
            or bw & (bw - 1)):
        return False
    if (s // 16) * (bm // 8) > 8 * SEPARABLE_PAIRS[-1]:
        return False
    return separable_smem_bytes(ct_h, ct_w, bh, bw, bc, bm) <= TC_SMEM_MAX


def separable_block_m(mout: int) -> list[int]:
    """The M widths the separable chooser weighs: the whole of M (rounded
    up to 8) where M <= 128, else 64, 128 and the multiples of 8 from 64
    to 320 that divide it, so the depthwise stage runs at most
    twice per (strip, channel) for M <= 128 and every block covers at
    least 64 output channels."""
    m8 = -(-mout // 8) * 8
    if m8 <= 128:
        return [m8]
    return sorted({64, 128} | {b for b in range(64, 321, 8) if m8 % b == 0})


def separable_block_terms(ct_h: CookToom, ct_w: CookToom, c: int,
                          mout: int, bh: int, bw: int, bc: int, bm: int, *,
                          n_h: int, n_w: int, batch: int = 1,
                          sms: int = H100_SMS) -> tuple[dict, int, int]:
    """(terms, waves, blocks per SM) of one separable_streamed.cu
    blocking: per block its C steps, the bytes it stages (strips, taps,
    pointwise chunks), the depthwise work per thread (items per thread
    times T^3) and the TF32 products of its busiest warp; the waves of
    blocks, as tc_block_terms."""
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    t = tc_tile(th, tw)
    steps = -(-c // bc)
    pairs = (bh * mh * bw * mw // 16) * (bm // 8)
    kp = next(q for q in SEPARABLE_PAIRS if pairs <= 8 * q)
    smem = separable_smem_bytes(ct_h, ct_w, bh, bw, bc, bm)
    bps = min(2 if t <= 6 and kp <= 4 else 1,
              TC_SMEM_PER_SM // (smem + 1024))
    staged = ((bh * mh + th - mh) * (bw * mw + tw - mw) + th * tw + bm) \
        * bc * 4
    terms = {"step": steps, "load": steps * staged,
             "dw": steps * -(-bh * bw * bc // SEPARABLE_THREADS) * t ** 3,
             "mma": steps * -(-pairs // 8) * (bc // 8) * 3, "block": 1}
    blocks = batch * -(-n_h // bh) * -(-n_w // bw) * -(-mout // bm)
    return terms, -(-blocks // (sms * bps)), bps


def separable_geometry(n_h: int, n_w: int, c: int, mout: int,
                       ct_h: CookToom, ct_w: CookToom, *, batch: int = 1,
                       sms: int = H100_SMS) -> StreamGeometry:
    """Blocking of the fused separable kernel
    (kernels/csrc/separable_streamed.cu), once, at plan time.

    One block computes a (bh, bw) strip of depthwise output tiles, S =
    bh*mh * bw*mw pixels, for bM pointwise output channels
    (separable_block_m), sweeping C in bc steps: each step stages the
    strip, taps and pointwise chunk, runs the depthwise stage into z (S,
    bc) and the (S, bc) x (bc, bM) GEMM on the tensor cores. Every M block
    recomputes its strip's depthwise stage, so the chooser keeps bM wide
    and fills the card with smaller strips. Candidates must pass
    separable_blocking_fits; the score is the modelled time (model_time
    of separable_block_terms, weights SEPARABLE_COST, fitted to the card):
    the Mp/bM depthwise passes enter through the blocks, each paying its
    steps' depthwise work, and the blocks run in waves. The time follows
    the C steps more than the depthwise passes (PERF.md), so the step
    cost is a term of its own. Ties go to the larger block.
    """
    th, tw, mh, mw = ct_h.t, ct_w.t, ct_h.m, ct_w.m
    if max(th, tw) > DEPTHWISE_MAX_T:
        raise ValueError(
            f"input tile ({th}, {tw}) exceeds the depthwise kernels' "
            f"{DEPTHWISE_MAX_T}; use a smaller output_tile")
    best = None
    for bm in separable_block_m(mout):
        for bc in SEPARABLE_BLOCK_C:
            if bc > 8 and bc > c:
                continue
            for bh in _pow2_upto(n_h, 16):
                for bw in _pow2_upto(n_w, 16):
                    if not separable_blocking_fits(ct_h, ct_w, bh, bw, bc,
                                                   bm):
                        continue
                    terms, waves, bps = separable_block_terms(
                        ct_h, ct_w, c, mout, bh, bw, bc, bm, n_h=n_h,
                        n_w=n_w, batch=batch, sms=sms)
                    score = (model_time(terms, waves, bps, SEPARABLE_COST),
                             -bh * mh * bw * mw * bm)
                    if best is None or score < best[0]:
                        best = (score, (bh, bw, bc, bm))
    if best is None:
        raise ValueError(
            f"no blocking of the ({n_h}, {n_w})-tile grid (C={c}, M={mout}, "
            f"m=({mh}, {mw})) fits the separable kernel")
    bh, bw, bc, bm = best[1]
    n_hb, n_wb = -(-n_h // bh), -(-n_w // bw)
    return StreamGeometry(bh=bh, bw=bw, n_hb=n_hb, n_wb=n_wb,
                          pad_h=(n_hb * bh - n_h) * mh,
                          pad_w=(n_wb * bw - n_w) * mw, block_c=bc,
                          block_m=bm, c_pad=-(-c // bc) * bc,
                          m_pad=-(-mout // bm) * bm)


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


def winograd_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    output_tile: int | tuple[int, int] = 4,
    padding: Padding = "SAME",
) -> torch.Tensor:
    """F(m x m, kh x kw) region-wise multi-channel convolution, per call:
    x (N, H, W, C) NHWC, w (kh, kw, C, M) HWIO -> (N, H', W', M), stride 1.

    Derives the Cook-Toom pair and transforms the filter on every call;
    plan once (core.plan.plan_conv2d) to do that once. 1xN / Nx1 filters
    run the single-axis algorithm and 1x1 filters a channel GEMM
    (_winograd_conv2d_1d_kernel). `output_tile` is m, or (m_h, m_w) per
    axis."""
    kh, kw = w.shape[:2]
    if kh == 1 or kw == 1:
        return _winograd_conv2d_1d_kernel(x, w, output_tile=output_tile,
                                          padding=padding)
    mh, mw = ((output_tile, output_tile) if isinstance(output_tile, int)
              else output_tile)
    ct_h, ct_w = cook_toom(mh, kh), cook_toom(mw, kw)
    u = transform_filter_2d(w, ct_h, ct_w)              # (th, tw, C, M)
    return winograd_conv2d_pretransformed(x, u, ct_h, ct_w, padding=padding)


def pointwise_conv2d(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """1x1 convolution: a pure channel GEMM, x (N, H, W, C) x u (C, M)."""
    return torch.matmul(x, u.to(x.dtype))


def _winograd_conv2d_1d_kernel(x: torch.Tensor, w: torch.Tensor, *,
                               output_tile, padding: Padding
                               ) -> torch.Tensor:
    """1xN / Nx1 layers (the paper's Inception-v3 case), per call: derive
    the filter transform and the axis geometry, then run the
    pretransformed single-axis executor; a 1x1 filter is a channel GEMM."""
    kh, kw, c, mout = w.shape
    axis = 1 if kh > 1 else 2          # spatial axis the filter runs along
    k = max(kh, kw)
    if k == 1:
        return pointwise_conv2d(x, w[0, 0])
    m = output_tile if isinstance(output_tile, int) else output_tile[axis - 1]
    ct = cook_toom(m, k)
    u = transform_filter_1d(w.reshape(k, c, mout), ct)  # (t, C, M)
    geometry = conv1d_axis_geometry(x.shape[axis], axis, k, m, padding)
    return winograd_conv1d_axis_pretransformed(x, u, ct, geometry)


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


def winograd_conv1d_axis_pretransformed(
    x: torch.Tensor,
    u: torch.Tensor,
    ct: CookToom,
    geometry: Axis1DGeometry,
) -> torch.Tensor:
    """1xN / Nx1 executor over a pre-transformed (t, C, M) filter and a
    precomputed axis geometry: 1D Cook-Toom along geometry.axis, plain
    channel GEMM along the unit axis. The transforms run in fp32; the
    channel GEMM is one batched matmul over the t points, with a reduced
    precision u (bf16, int8) widened to fp32 (the caller applies any int8
    scale)."""
    n, h, wdt, _ = x.shape
    axis, nt, t, m = geometry.axis, geometry.n_t, ct.t, ct.m
    mout = u.shape[-1]
    pad = [0, 0, 0, 0, 0, 0]             # F.pad order: C, then W, then H
    pad[2 * (3 - axis):2 * (3 - axis) + 2] = [geometry.lo, geometry.hi]
    xp = F.pad(x.float(), pad)
    tiles = _extract_tiles_1d(xp, axis, t, m, nt)     # axis -> (nt, t)
    bt, at = _mat(ct.BT, xp), _mat(ct.AT, xp)
    if axis == 1:
        v = torch.einsum("it,nstwc->inswc", bt, tiles)    # (t, N, nt, W, C)
    else:
        v = torch.einsum("it,nhstc->inhsc", bt, tiles)    # (t, N, H, nt, C)
    lead = v.shape[1:4]
    y = torch.bmm(v.reshape(t, -1, v.shape[-1]), u.float())
    y = y.reshape(t, *lead, mout)
    if axis == 1:
        out = torch.einsum("ot,tnswm->nsowm", at, y)
        out = out.reshape(n, nt * m, wdt, mout)[:, :geometry.out_size]
    else:
        out = torch.einsum("ot,tnhsm->nhsom", at, y)
        out = out.reshape(n, h, nt * m, mout)[:, :, :geometry.out_size]
    return out.to(x.dtype)


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


def winograd_grouped_conv2d_pretransformed(
    x: torch.Tensor,
    u: torch.Tensor,
    ct_h: CookToom,
    ct_w: CookToom,
    groups: int,
    *,
    padding: Padding = "SAME",
    geometry: Conv2DGeometry | None = None,
) -> torch.Tensor:
    """Grouped dense Winograd executor: the channel reduction becomes a
    block-diagonal one, an (R x Cg) x (Cg x Mg) GEMM per group per
    Winograd point, batched in one contraction. Phases 1 and 3 are the
    dense path's. `u` is the (th, tw, Cg, M) Winograd-domain filter, M =
    groups * Mg group-major (output channel o = g * Mg + j, as in a conv
    with groups); a reduced precision u is widened to x's dtype and the
    caller applies any int8 scale."""
    n, h, wdt, c = x.shape
    th, tw, cg, mout = u.shape
    mg = mout // groups
    mh, mw, kh, kw = ct_h.m, ct_w.m, ct_h.r, ct_w.r
    if geometry is None:
        geometry = conv2d_geometry(h, wdt, kh, kw, mh, mw, padding)
    nh, nw = geometry.n_h, geometry.n_w
    xp = F.pad(x, (0, 0, geometry.lo_w, geometry.hi_w,
                   geometry.lo_h, geometry.hi_h))
    tiles = _extract_tiles_1d(xp, 1, th, mh, nh)
    tiles = _extract_tiles_1d(tiles, 3, tw, mw, nw)     # (N, nh, th, nw, tw, C)
    v = torch.einsum("it,nhtwuc,ju->nhwijc", _mat(ct_h.BT, x), tiles,
                     _mat(ct_w.BT, x))
    # scatter with the channel axis split: (P, R, G, Cg)
    v = v.reshape(n * nh * nw, th * tw, groups, cg).transpose(0, 1)

    # phase 2: P x G batched (R, Cg) x (Cg, Mg) GEMMs
    y = torch.einsum("prgc,pcgm->prgm", v,
                     u.to(x.dtype).reshape(th * tw, cg, groups, mg))
    y = y.reshape(th * tw, n * nh * nw, mout)           # group-major M

    y = y.transpose(0, 1).reshape(n, nh, nw, th, tw, mout)
    out = torch.einsum("it,nhwtum,ju->nhiwjm", _mat(ct_h.AT, y), y,
                       _mat(ct_w.AT, y))
    out = out.reshape(n, nh * mh, nw * mw, mout)
    return out[:, :geometry.out_h, :geometry.out_w, :]


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
