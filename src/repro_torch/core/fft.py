"""Tiled FFT (rfft2) convolution executor (PyTorch).

The JAX package's core/fft.py on `torch.fft` (cuFFT on the card). FFT's
transform cost per output point is O(log t) and independent of the filter
size, so it is the planner's contender on large filters and large spatial
extents, where F(4, 3)-class tiles amortize poorly.

The executor reuses the Winograd overlap tiling (winograd.conv2d_fft_geometry):
the input is cut into t x t tiles whose origins advance by m = t - k + 1,
each tile goes through rfft2, the channel reduction is a complex pointwise
GEMM against the pre-transformed, conjugated filter spectrum, and irfft2
brings each tile back to m x m valid outputs. With the spectrum conjugated
the circular theorem yields cross-correlation,

    irfft2(rfft2(x_tile) * conj(rfft2(pad(w))))[i] = sum_n x[n + i] w[n],

and the first m outputs per axis are wraparound-free, so tiles write
disjoint output blocks (overlap-save).

The filter transform U = conj(rfft2(zero-padded w)) runs once at plan time
(plan._bind_weights) and is stored complex64, in plan artifacts too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import winograd as _wg


class FFTGeometry(NamedTuple):
    """Plan-time decisions of the FFT executor for one layer: the rfft2
    transform length per axis and the valid outputs per tile
    (m = fft - k + 1). Derived from the layer shape (choose_fft_geometry),
    so an artifact needs only the output tile to rebuild it."""

    fft_h: int
    fft_w: int
    m_h: int
    m_w: int


#: Candidate transform lengths. Powers of two keep rfft2 on its fastest
#: path and make the choice reproducible from the output tile alone
#: (fft = m + k - 1 lands back on the same power of two).
FFT_SIZES = (8, 16, 32)


def _pick_axis(size: int, k: int) -> int:
    """Transform length for one spatial axis: the smallest candidate that
    covers the axis in a single tile (m = f - k + 1 >= size), else the
    largest candidate with m >= 1."""
    for f in FFT_SIZES:
        if f - k + 1 >= size:
            return f
    for f in reversed(FFT_SIZES):
        if f - k + 1 >= 1:
            return f
    raise ValueError(f"filter size {k} exceeds every FFT candidate "
                     f"length {FFT_SIZES}")


def choose_fft_geometry(h: int, w: int, kh: int, kw: int,
                        output_tile: tuple[int, int] | None = None
                        ) -> FFTGeometry:
    """Per-axis transform lengths for an (h, w) layer with a (kh, kw)
    filter. With `output_tile` given (artifact reload, or an explicit
    request) the lengths are m + k - 1, the inverse of the default choice,
    so saved plans rebuild identically."""
    if output_tile is not None:
        m_h, m_w = output_tile
        return FFTGeometry(m_h + kh - 1, m_w + kw - 1, m_h, m_w)
    fh, fw = _pick_axis(h, kh), _pick_axis(w, kw)
    return FFTGeometry(fh, fw, fh - kh + 1, fw - kw + 1)


def fft_transform_filter(w: torch.Tensor, fft_h: int,
                         fft_w: int) -> torch.Tensor:
    """(kh, kw, C, M) -> (fft_h, fft_w//2+1, C, M) complex64: the conjugated
    rfft2 spectrum of the zero-padded filter, once per plan."""
    kh, kw = w.shape[0], w.shape[1]
    wp = F.pad(w.float(), (0, 0, 0, 0, 0, fft_w - kw, 0, fft_h - kh))
    return torch.fft.rfft2(wp, dim=(0, 1)).conj().resolve_conj()


def fft_conv2d_pretransformed(x: torch.Tensor, u: torch.Tensor,
                              fft: FFTGeometry, *,
                              padding: _wg.Padding = "SAME",
                              geometry: _wg.Conv2DGeometry | None = None
                              ) -> torch.Tensor:
    """NHWC conv with a plan-time filter spectrum `u`: overlap tiling ->
    rfft2 -> complex channel GEMM -> irfft2 -> crop. Each tile's valid
    region is [:m_h, :m_w]."""
    n, h, w, _ = x.shape
    kh = fft.fft_h - fft.m_h + 1
    kw = fft.fft_w - fft.m_w + 1
    if geometry is None:
        geometry = _wg.conv2d_fft_geometry(h, w, kh, kw, fft.fft_h,
                                           fft.fft_w, padding)
    g = geometry
    xp = F.pad(x.float(), (0, 0, g.lo_w, g.hi_w, g.lo_h, g.hi_h))
    tiles = _wg._extract_tiles_1d(xp, 1, fft.fft_h, fft.m_h, g.n_h)
    tiles = _wg._extract_tiles_1d(tiles, 3, fft.fft_w, fft.m_w, g.n_w)
    # (N, n_h, fft_h, n_w, fft_w, C) -> spectrum over the tile axes
    v = torch.fft.rfft2(tiles, dim=(2, 4))
    y = torch.einsum("nhawbc,abcm->nhawbm", v, u)
    y = torch.fft.irfft2(y, s=(fft.fft_h, fft.fft_w), dim=(2, 4))
    y = y[:, :, :fft.m_h, :, :fft.m_w, :]
    y = y.reshape(n, g.n_h * fft.m_h, g.n_w * fft.m_w, u.shape[-1])
    return y[:, :g.out_h, :g.out_w, :].to(x.dtype)
