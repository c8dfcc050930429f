"""im2row + GEMM convolution -- the paper's baseline comparator.

Patches are linearized into rows of an [OHW x khkwC] matrix and multiplied
with the [khkwC x M] filter matrix (NHWC / row-major => im2row), as in the
JAX package's core/im2col.py. The GEMM is one `torch.matmul`; a grouped
conv (groups > 1, depthwise included) multiplies each group's rows by its
own filter block.

It also holds the plan-time blocking of the GEMM kernel behind the
`pallas_im2col` executor (kernels/csrc/matmul.cu): its tile menu, the
padding rule of its B operand and the chooser of its tile.
"""

from __future__ import annotations

from typing import Literal, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.winograd import (H100_SMS, TC_SMEM_PER_SM, model_time,
                                       u_row_bytes)

Padding = Literal["SAME", "VALID"]


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Im2RowGeometry(NamedTuple):
    """Static padding/output geometry of one im2row lowering, derived once
    at plan time."""

    ph: tuple[int, int]
    pw: tuple[int, int]
    oh: int
    ow: int


def im2row_geometry(h: int, w: int, kh: int, kw: int,
                    stride: tuple[int, int], padding: Padding) -> Im2RowGeometry:
    sh, sw = stride
    ph = _same_pads(h, kh, sh) if padding == "SAME" else (0, 0)
    pw = _same_pads(w, kw, sw) if padding == "SAME" else (0, 0)
    hp, wp = h + ph[0] + ph[1], w + pw[0] + pw[1]
    return Im2RowGeometry(ph, pw, (hp - kh) // sh + 1, (wp - kw) // sw + 1)


def read_amplification(kh: int, kw: int, stride: tuple[int, int]) -> float:
    """How many times the im2row lowering copies each input element into
    the patch matrix (the kernel-window overlap factor at this stride)."""
    sh, sw = stride
    return (kh * kw) / (sh * sw)


def im2row(x: torch.Tensor, kh: int, kw: int, stride: tuple[int, int],
           padding: Padding, geometry: Im2RowGeometry | None = None
           ) -> tuple[torch.Tensor, tuple[int, int]]:
    """(N, H, W, C) -> ((N * OH * OW, kh * kw * C), (OH, OW))."""
    n, h, w, c = x.shape
    sh, sw = stride
    if geometry is None:
        geometry = im2row_geometry(h, w, kh, kw, stride, padding)
    ph, pw, oh, ow = geometry
    if any(ph) or any(pw):
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    rows = [x[:, di:di + (oh - 1) * sh + 1:sh, dj:dj + (ow - 1) * sw + 1:sw]
            for di in range(kh) for dj in range(kw)]
    patches = torch.stack(rows, dim=3)                 # (N, OH, OW, khkw, C)
    return patches.reshape(n * oh * ow, kh * kw * c), (oh, ow)


def grouped_im2row(x: torch.Tensor, kh: int, kw: int,
                   stride: tuple[int, int], padding: Padding, groups: int,
                   geometry: Im2RowGeometry | None = None
                   ) -> tuple[torch.Tensor, tuple[int, int]]:
    """Grouped im2row lowering: (N, H, W, C) ->
    ((N * OH * OW, G, kh * kw * C/G), (OH, OW)); row group g multiplies
    only its own (kh*kw*C/G, M/G) filter block, so the zero blocks of a
    dense lowering never exist."""
    n, c = x.shape[0], x.shape[3]
    a, (oh, ow) = im2row(x, kh, kw, stride, padding, geometry)
    a = a.reshape(n * oh * ow, kh * kw, groups, c // groups).transpose(1, 2)
    return a.reshape(n * oh * ow, groups, kh * kw * (c // groups)), (oh, ow)


def grouped_filter_matrix(w: torch.Tensor, groups: int) -> torch.Tensor:
    """(kh, kw, C/G, M) HWIO grouped filter -> (G, kh*kw*C/G, M/G) per-group
    GEMM matrices, group-major on the output axis (output channel
    o = g * M/G + j, as a grouped conv orders it). Plan-time."""
    kh, kw, cg, m = w.shape
    return (w.reshape(kh * kw, cg, groups, m // groups).permute(2, 0, 1, 3)
            .reshape(groups, kh * kw * cg, m // groups))


def direct_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride=1,
                  padding: Padding = "SAME") -> torch.Tensor:
    """Direct convolution oracle (testing only): NHWC x HWIO -> NHWC with
    the JAX package's explicit SAME pads, through `F.conv2d`."""
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    kh, kw = w.shape[:2]
    g = im2row_geometry(x.shape[1], x.shape[2], kh, kw, stride, padding)
    xp = F.pad(x, (0, 0, g.pw[0], g.pw[1], g.ph[0], g.ph[1]))
    y = F.conv2d(xp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Blocking of the GEMM kernel (kernels/csrc/matmul.cu)
# ---------------------------------------------------------------------------

#: K per pipeline stage and the stages in flight; these must agree with
#: kBK / kStages in kernels/csrc/matmul.cu.
MATMUL_BK = 32
MATMUL_STAGES = 3
#: The kernel's block tiles, (rows, columns) -> its (rows, columns) of
#: warps, each warp (rows / 16 / warp rows) x (columns / 8 / warp columns)
#: m16n8 fragments; must agree with matmul.cu:dispatch. 128 x 64 for the
#: long shallow layers, 16 and 32 columns for MobileNet-v2's narrow N,
#: 32 rows so that M = 196 still makes 7 row blocks.
MATMUL_TILES = {(128, 64): (4, 2), (64, 64): (2, 2), (128, 32): (4, 1),
                (64, 32): (2, 2), (128, 16): (4, 1), (64, 16): (4, 1),
                (32, 64): (1, 4), (32, 32): (2, 2)}
#: Weights of the GEMM chooser's time model (matmul_block_terms):
#: nanoseconds per unit of each term, and the share of a block's time that
#: a co-resident block adds (core/winograd.py:model_time). A non-negative
#: least-squares fit of the relative error (13.95 % rms over 264 tiles and
#: splits) to `chip_smoke.py --sweep matmul` on nine MobileNet GEMMs, on
#: an H100 (PERF.md).
MATMUL_COST = {"step": 742.5, "mma": 7.306, "load": 0.1236, "store": 94.55,
               "block": 1094.0, "share": 0.1, "launch": 2631.0,
               "reduce": 0.1750}
#: K splits the chooser weighs (matmul_split_fits narrows them per K).
MATMUL_SPLITS = (1, 2, 3, 4, 6, 8)


def matmul_b_shape(k: int, n: int, block_n: int) -> tuple[int, int]:
    """(Kp, Np) of the GEMM kernel's B operand for a (K, N) filter matrix:
    K rounded up to MATMUL_BK, N to the tile's columns. The one padding
    rule: the plan pads to it (kernels/ops.py:pad_im2col_filter) and the
    wrapper and the launcher accept only it."""
    return -(-k // MATMUL_BK) * MATMUL_BK, -(-n // block_n) * block_n


def matmul_split_fits(k: int, splits: int) -> bool:
    """Whether matmul.cu takes `splits` K splits of a K-deep product: each
    split gets ceil(steps / splits) of its ceil(K / MATMUL_BK) K steps and
    none is left empty."""
    n_k = -(-k // MATMUL_BK)
    if splits < 1 or splits > n_k:
        return False
    return -(-n_k // -(-n_k // splits)) == splits


def matmul_smem_bytes(bm: int, bn: int, u_size: int) -> int:
    """Dynamic shared memory of one matmul.cu block: MATMUL_STAGES stages
    of the A tile (bm rows of MATMUL_BK + 4 floats) and of the raw B tile
    (MATMUL_BK rows of u_row_bytes)."""
    return MATMUL_STAGES * (4 * bm * (MATMUL_BK + 4)
                            + MATMUL_BK * u_row_bytes(bn, u_size))


def matmul_block_terms(m: int, k: int, n: int, bm: int, bn: int,
                       u_size: int = 4, sms: int = H100_SMS,
                       splits: int = 1) -> tuple[dict, int, int, dict]:
    """(terms, waves, co-resident blocks per SM, extra) of one matmul.cu
    tile and K split on an (M, K, N) GEMM: per block its K steps, the TF32
    products of each warp (3 per multiply-add for an fp32 B, 2 for bf16 /
    int8), the bytes each thread stages and the outputs each stores; the
    waves of blocks the card's `sms` multiprocessors run, each holding as
    many blocks as threads and shared memory allow, at most as many as the
    grid gives; `extra`, outside the waves, the split's reduction kernel:
    its launch and the KB of partial sums it reads and writes."""
    wm, wn = MATMUL_TILES[(bm, bn)]
    threads = 32 * wm * wn
    n_k = -(-k // MATMUL_BK)
    steps = -(-n_k // splits)
    frags = (bm // (16 * wm)) * (bn // (8 * wn))
    terms = {"step": steps,
             "mma": steps * (MATMUL_BK // 8) * frags
             * (3 if u_size == 4 else 2),
             "load": steps * (4 * bm + u_size * bn) * MATMUL_BK / threads,
             "store": bm * bn / threads,
             "block": 1}
    blocks = -(-m // bm) * -(-n // bn) * splits
    bps = min(2048 // threads,
              TC_SMEM_PER_SM // (matmul_smem_bytes(bm, bn, u_size) + 1024),
              -(-blocks // sms))
    extra = {"launch": int(splits > 1),
             "reduce": (splits + 1) * m * n * 4 / 1024 if splits > 1 else 0}
    return terms, -(-blocks // (sms * bps)), bps, extra


def matmul_model_time(m: int, k: int, n: int, bm: int, bn: int,
                      u_size: int = 4, sms: int = H100_SMS,
                      splits: int = 1, cost: dict | None = None) -> float:
    """The GEMM chooser's modelled time of one tile and split, in
    nanoseconds: model_time of matmul_block_terms plus its extra terms."""
    cost = MATMUL_COST if cost is None else cost
    terms, waves, bps, extra = matmul_block_terms(m, k, n, bm, bn, u_size,
                                                  sms, splits)
    return model_time(terms, waves, bps, cost) + sum(
        cost[key] * v for key, v in extra.items())


def matmul_blocks(m: int, k: int, n: int, *, u_size: int = 4,
                  sms: int = H100_SMS) -> tuple[int, int, int, int]:
    """(block_m, MATMUL_BK, block_n, splits) of the GEMM kernel for an
    (M, K, N) product, once, at plan time: among the tiles of MATMUL_TILES
    no wider than N rounded up to a power of two (so a narrow N pads to at
    most twice its width) and the K splits of MATMUL_SPLITS that fit, the
    one with the least modelled time (matmul_model_time, weights
    MATMUL_COST); ties go to fewer splits, the fewer padded columns, then
    the larger tile."""
    widest = 16
    while widest < n:
        widest *= 2
    best = None
    for bm, bn in MATMUL_TILES:
        if bn > widest:
            continue
        for splits in MATMUL_SPLITS:
            if not matmul_split_fits(k, splits):
                continue
            score = (matmul_model_time(m, k, n, bm, bn, u_size, sms, splits),
                     splits, -(-n // bn) * bn, -bm * bn)
            if best is None or score < best[0]:
                best = (score, (bm, MATMUL_BK, bn, splits))
    return best[1]
