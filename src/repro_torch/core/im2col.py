"""im2row + GEMM convolution -- the paper's baseline comparator.

Patches are linearized into rows of an [OHW x khkwC] matrix and multiplied
with the [khkwC x M] filter matrix (NHWC / row-major => im2row), as in the
JAX package's core/im2col.py. The GEMM is one `torch.matmul`; a grouped
conv (groups > 1, depthwise included) multiplies each group's rows by its
own filter block.
"""

from __future__ import annotations

from typing import Literal, NamedTuple

import torch
import torch.nn.functional as F

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
