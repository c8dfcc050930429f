"""AdamW with a cosine schedule and global-norm clipping, as in the JAX
package's optim/adamw.py: plain tensor code over the parameter tree (not
torch.optim), so the arithmetic is the reference's. The update runs in
fp32 and is cast back to each parameter's dtype and to `state_dtype` (bf16
moments for the 100B+ archs). Functional: apply_updates returns new
params and state and leaves its inputs as they were.

On a placed tree (distributed/sharding.device_put) the moments take the
params' shardings, which is ZeRO: each piece of a parameter has its
moments' pieces on its device, and the update runs piece by piece. The
step count is one replicated scalar. The global norm counts each element
once, however many positions replicate it, and replicas, given equal
gradients, get the same update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.distributed.sharding import distinct_tensors, piecewise
from repro_torch.kernels.runtime import resolve_device
from repro_torch.tree import tree_from_numpy, tree_leaves, tree_map

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: Any = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor       # scalar int32
    m: Any                   # tree like params
    v: Any


def init_state(params: Any, cfg: AdamWConfig) -> AdamWState:
    """Zero moments in cfg.state_dtype on each parameter's device (the
    "meta" device for abstract params), in its shardings for a placed
    tree; the step on the first leaf's device."""
    @piecewise
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def abstract_state(params_shape: Any, cfg: AdamWConfig) -> AdamWState:
    """init_state's tree on the "meta" device for a (possibly "meta")
    params tree: the keys, shapes and dtypes with no storage (the
    reference's jax.eval_shape version)."""
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params_shape)
    return init_state(meta, cfg)


def opt_state_from_reference(state_np, device=None) -> AdamWState:
    """The JAX package's AdamWState, given with numpy leaves, as this
    package's on `device` (None means the CUDA device): the same step,
    moments, shapes and dtypes."""
    device = resolve_device(device)
    return AdamWState(*(tree_from_numpy(x, device) for x in state_np))


def schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup to cfg.lr over warmup_steps, then a cosine decay to
    min_lr_frac * lr at total_steps; fp32, for a step count (int or int
    tensor)."""
    step = torch.as_tensor(step)
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    t = torch.clip((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                    * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos).to(_F32)


def global_norm(tree: Any) -> torch.Tensor:
    """The 2-norm over every element of the tree, each once (on the first
    leaf's device)."""
    parts = [x.to(_F32).square().sum() for leaf in tree_leaves(tree)
             for x in distinct_tensors(leaf)]
    return torch.sqrt(sum(p.to(parts[0].device) for p in parts))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0).to(_F32)
    return tree_map(piecewise(
        lambda g: (g.to(_F32) * scale.to(g.device)).to(g.dtype)),
        grads), norm


def apply_updates(params: Any, grads: Any, state: AdamWState,
                  cfg: AdamWConfig) -> tuple[Any, AdamWState]:
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(state.step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(_F32)
    bc2 = 1 - b2 ** step.to(_F32)

    @piecewise
    def upd(p, g, m, v):
        g32, p32 = g.to(_F32), p.to(_F32)
        m32 = b1 * m.to(_F32) + (1 - b1) * g32
        v32 = b2 * v.to(_F32) + (1 - b2) * g32.square()
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
            + cfg.weight_decay * p32
        return ((p32 - lr * delta).to(p.dtype), m32.to(cfg.state_dtype),
                v32.to(cfg.state_dtype))

    out = tree_map(upd, params, grads, state.m, state.v)

    def pick(i):
        return tree_map(lambda _, o: o[i], params, out)

    return pick(0), AdamWState(step=step, m=pick(1), v=pick(2))
