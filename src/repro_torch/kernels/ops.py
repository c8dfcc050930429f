"""Planned-op wrappers around the kernels: they handle all padding and
blocking so callers never see alignment constraints.

The planned Winograd path streams regions end-to-end inside the kernel
(winograd_conv2d_planned -> kernels.winograd.winograd_streamed): the only
per-call device tensors are the padded NHWC input and the NHWC output,
with the scale + bias + activation epilogue fused into the kernel's store.
The bias is passed unpadded; the kernel gives the padded output channels
no bias, so no per-call bias copy exists either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import winograd as _wg
from repro_torch.kernels import winograd as _k_winograd


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_streamed_input(x: torch.Tensor, geometry: _wg.Conv2DGeometry,
                       stream: _wg.StreamGeometry) -> torch.Tensor:
    """The kernel's input: NHWC `x` with the conv padding, the edge-block
    padding and C rounded up to the kernel's channel step."""
    return F.pad(x, (0, stream.c_pad - x.shape[3],
                     geometry.lo_w, geometry.hi_w + stream.pad_w,
                     geometry.lo_h, geometry.hi_h + stream.pad_h))


def winograd_conv2d_planned(
    x: torch.Tensor,
    u: torch.Tensor,
    *,
    ct_h,
    ct_w,
    geometry: _wg.Conv2DGeometry,
    stream: _wg.StreamGeometry,
    c_out: int,
    bias: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    activation: str = "none",
) -> torch.Tensor:
    """Execute a planned streaming Winograd conv.

    `u` is the pre-transformed, pre-padded (P, Cp, Mp) filter (fp32, or a
    bf16/int8 reduced-precision copy -- the kernel widens it to fp32);
    `scale` is the plan's (1, Mp) int8 dequantization row or None. All
    geometry (conv padding, strip origins, edge-block padding, block sizes)
    was derived once at plan time. The per-call work is one NHWC pad, the
    kernel, and one crop.
    """
    y = _k_winograd.winograd_streamed(
        pad_streamed_input(x, geometry, stream), u, bias, scale, ct_h=ct_h, ct_w=ct_w, bh=stream.bh, bw=stream.bw,
        block_m=stream.block_m, activation=activation)
    return y[:, :geometry.out_h, :geometry.out_w, :c_out]


def pad_winograd_filter(u: torch.Tensor, block_c: int,
                        block_m: int) -> torch.Tensor:
    """Pad a (P, C, M) Winograd-domain filter to the kernel's block grid.
    Done once at plan time so apply() never touches the weights."""
    _, c, mout = u.shape
    return F.pad(u, (0, _round_up(mout, block_m) - mout,
                     0, _round_up(c, block_c) - c)).contiguous()
