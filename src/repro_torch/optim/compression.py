"""int8 quantization: the per-output-channel quantizer of execution-domain
filters, and the error-feedback int8 gradient compression of the JAX
package's optim/compression.py.

Error feedback (Seide et al. / EF-SGD) keeps the quantization unbiased
over time: the residual of each step's quantization is carried and added
to the next step's gradient. Per leaf:

  q, scale = quantize(g + err)           # symmetric per-tensor int8
  err'     = (g + err) - dequantize(q)   # carried residual

The cross-pod mean over that wire (pod_mean_int8, pod_mean_int8_tree) is
a collective over the mesh's "pod" axis and waits for the LM's meshes
(ROADMAP.md queue 1 item 9): it raises NotImplementedError.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_map

_F32 = torch.float32
_I8_MAX = 127.0


class Compressed(NamedTuple):
    q: torch.Tensor       # int8 payload, same shape as the gradient
    scale: torch.Tensor   # fp32 scalar


def quantize(g: torch.Tensor) -> Compressed:
    """Symmetric per-tensor int8 quantization (round half to even, as in
    the JAX package)."""
    g32 = g.to(_F32)
    amax = g32.abs().max()
    scale = torch.where(amax > 0, amax / _I8_MAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(g32 / scale), -_I8_MAX, _I8_MAX)
    return Compressed(q=q.to(torch.int8), scale=scale)


def dequantize(c: Compressed) -> torch.Tensor:
    return c.q.to(_F32) * c.scale


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


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor
                           ) -> tuple[Compressed, torch.Tensor]:
    """Returns (compressed(g + err), new_err)."""
    target = g.to(_F32) + err
    c = quantize(target)
    return c, target - dequantize(c)


def init_error_state(params: Any) -> Any:
    """Zero fp32 residuals, shaped like the gradients."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                          device=p.device), params)


def _pod_mean_not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} is a collective over the mesh's 'pod' axis, which waits "
        f"for the LM's meshes: ROADMAP.md queue 1 item 9")


def pod_mean_int8(g, err, axis: str = "pod"):
    """The int8 cross-pod gradient mean with error feedback: not ported."""
    raise _pod_mean_not_ported("pod_mean_int8")


def pod_mean_int8_tree(grads, err_state, axis: str = "pod"):
    """pod_mean_int8 over a gradient tree: not ported."""
    raise _pod_mean_not_ported("pod_mean_int8_tree")
