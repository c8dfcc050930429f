"""Per-output-channel int8 quantization of execution-domain filters."""

from __future__ import annotations

import torch

_I8_MAX = 127.0


def quantize_channelwise(g: torch.Tensor, channel_axes=(-1,)
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 quantization: one scale per position along
    `channel_axes` (every other axis is reduced), `q * scale == g` up to
    rounding. The plan-time weight quantizer for the low-precision Winograd
    executors (core/plan.py:_bind_weights). Zero channels (all-pad) get
    scale 1.0 so dequantization stays finite. Rounding is half to even, as
    in the JAX package. Returns (q int8, scale f32 of the channel_axes
    shape)."""
    g = g.float()
    axes = tuple(a % g.ndim for a in channel_axes)
    reduce_axes = tuple(i for i in range(g.ndim) if i not in axes)
    amax = g.abs().amax(dim=reduce_axes) if reduce_axes else g.abs()
    scale = torch.where(amax > 0, amax / _I8_MAX, torch.ones_like(amax))
    bshape = [g.shape[i] if i in axes else 1 for i in range(g.ndim)]
    q = torch.clamp(torch.round(g / scale.reshape(bshape)), -_I8_MAX, _I8_MAX)
    return q.to(torch.int8), scale
