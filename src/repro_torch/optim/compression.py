"""int8 quantization: the per-output-channel quantizer of execution-domain
filters, and the error-feedback int8 gradient compression of the JAX
package's optim/compression.py.

Error feedback (Seide et al. / EF-SGD) keeps the quantization unbiased
over time: the residual of each step's quantization is carried and added
to the next step's gradient. Per leaf:

  q, scale = quantize(g + err)           # symmetric per-tensor int8
  err'     = (g + err) - dequantize(q)   # carried residual

The cross-pod mean over that wire (pod_mean_int8, pod_mean_int8_tree)
is the reference's collective over the mesh's "pod" axis in the
single-controller form of distributed/sharding.py: one tensor per pod, on
its pod's device, where the reference's shard_map body sees its own. Each
pod quantizes its gradient with error feedback, its int8 payload and
scale are copied to every pod's device (the all-gather: one int8 payload
per pod on the wire, 4x fewer bytes than fp32), and each pod
dequantizes and averages them there.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

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


def pod_mean_int8(gs: Sequence[torch.Tensor], errs: Sequence[torch.Tensor]
                  ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The mean of per-pod gradients (`gs`, one per "pod" position, each on
    its pod's device) through an int8 wire with error feedback (`errs`,
    the pods' fp32 residuals). Returns (each pod's mean, in g's dtype on
    its device; each pod's new residual).

    A sum of int8 payloads would overflow, so, as in the reference, the
    payloads and scales are gathered and each pod dequant-sums them
    locally."""
    packed = [compress_with_feedback(g, e) for g, e in zip(gs, errs)]
    means = []
    for g in gs:
        qs = torch.stack([c.q.to(g.device) for c, _ in packed])
        scales = torch.stack([c.scale.to(g.device) for c, _ in packed])
        mean = torch.tensordot(scales, qs.to(_F32), dims=([0], [0]))
        means.append((mean / len(gs)).to(g.dtype))
    return means, [e for _, e in packed]


def pod_mean_int8_tree(grads: Sequence[Any], err_state: Sequence[Any]
                       ) -> tuple[list[Any], list[Any]]:
    """pod_mean_int8 over gradient trees, one tree per pod (and one error
    tree per pod): (the pods' mean trees, their new error trees). Each
    tree holds its pod-local batch mean on entry and the global mean on
    exit."""
    leaves = [tree_leaves(t) for t in grads]
    errs = [tree_leaves(t) for t in err_state]
    outs = [pod_mean_int8([ls[i] for ls in leaves], [es[i] for es in errs])
            for i in range(len(leaves[0]))]
    return ([tree_unflatten(grads[p], [o[0][p] for o in outs])
             for p in range(len(grads))],
            [tree_unflatten(err_state[p], [o[1][p] for o in outs])
             for p in range(len(grads))])
