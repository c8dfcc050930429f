"""Adafactor (Shazeer & Stern, 2018) with factored second moments, as in
the JAX package's optim/adafactor.py: row and column factors of the
second moment for every matrix-shaped parameter, O(n + m) state instead of
O(nm); update clipping by RMS (d = 1.0), a relative step size, and no
first moment by default (beta1=None). Plain tensor code over the
parameter tree, functional like optim/adamw.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-2               # relative step scale
    decay_rate: float = 0.8        # beta2_t = 1 - t^-decay_rate
    eps1: float = 1e-30            # second-moment regularizer
    eps2: float = 1e-3             # parameter-scale floor
    clip_threshold: float = 1.0    # RMS update clip
    beta1: Optional[float] = None  # None = no first moment (memory-free)
    weight_decay: float = 0.0
    min_dim_size_to_factor: int = 128


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any     # row factors (matrix params) or full v (vectors / scalars)
    vc: Any     # column factors (matrix params) or (1,) placeholders
    m: Any      # first moments or (1,) placeholders


def _factored(shape, cfg: AdafactorConfig) -> bool:
    return (len(shape) >= 2 and shape[-1] >= cfg.min_dim_size_to_factor
            and shape[-2] >= cfg.min_dim_size_to_factor)


def _state_shapes(shape, cfg: AdafactorConfig) -> tuple[tuple, tuple, tuple]:
    """The (vr, vc, m) shapes of a parameter's state: a factored matrix
    keeps its row means (last axis dropped) and column means (second last
    dropped); anything else a full second moment and a (1,) placeholder;
    m is the parameter's shape with beta1, else a placeholder."""
    shape = tuple(shape)
    if _factored(shape, cfg):
        vr, vc = shape[:-1], shape[:-2] + shape[-1:]
    else:
        vr, vc = shape, (1,)
    return vr, vc, (shape if cfg.beta1 else (1,))


def init_state(params: Any, cfg: AdafactorConfig) -> AdafactorState:
    def zeros(i):
        return lambda p: torch.zeros(_state_shapes(p.shape, cfg)[i],
                                     dtype=_F32, device=p.device)
    device = tree_leaves(params)[0].device
    return AdafactorState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          vr=tree_map(zeros(0), params),
                          vc=tree_map(zeros(1), params),
                          m=tree_map(zeros(2), params))


def abstract_state(params_shape: Any, cfg: AdafactorConfig
                   ) -> AdafactorState:
    """init_state's tree on the "meta" device for a (possibly "meta")
    params tree: the keys, shapes and dtypes with no storage (the
    reference's jax.eval_shape version)."""
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params_shape)
    return init_state(meta, cfg)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.square().mean())


def apply_updates(params: Any, grads: Any, state: AdafactorState,
                  cfg: AdafactorConfig) -> tuple[Any, AdafactorState]:
    step = state.step + 1
    beta2 = 1.0 - step.to(_F32) ** (-cfg.decay_rate)

    def upd(p, g, vr, vc, m):
        g32, p32 = g.to(_F32), p.to(_F32)
        g2 = g32.square() + cfg.eps1
        if _factored(p.shape, cfg):
            new_vr = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
            new_vc = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
            # v_hat = vr vc^T / mean(vr) (rank-1 reconstruction)
            denom = new_vr.mean(dim=-1, keepdim=True).clamp_min(cfg.eps1)
            vhat = (new_vr / denom)[..., None] * new_vc[..., None, :]
            update = g32 * torch.rsqrt(vhat + cfg.eps1)
        else:
            new_vr = beta2 * vr + (1 - beta2) * g2
            new_vc = vc
            update = g32 * torch.rsqrt(new_vr + cfg.eps1)
        update = update / torch.clamp_min(_rms(update) / cfg.clip_threshold,
                                          1.0)
        if cfg.beta1:
            new_m = cfg.beta1 * m + (1 - cfg.beta1) * update
            update = new_m
        else:
            new_m = m
        scale = cfg.lr * torch.clamp_min(_rms(p32), cfg.eps2)
        newp = p32 - scale * update - cfg.lr * cfg.weight_decay * p32
        return newp.to(p.dtype), new_vr, new_vc, new_m

    out = tree_map(upd, params, grads, state.vr, state.vc, state.m)

    def pick(i):
        return tree_map(lambda _, o: o[i], params, out)

    return pick(0), AdafactorState(step=step, vr=pick(1), vc=pick(2),
                                   m=pick(3))


def state_bytes(params: Any, cfg: AdafactorConfig) -> int:
    """Optimizer memory (the point of Adafactor): the fp32 vr, vc and m,
    from the parameters' shapes (nothing allocated)."""
    return sum(4 * math.prod(s) for p in tree_leaves(params)
               for s in _state_shapes(p.shape, cfg))
