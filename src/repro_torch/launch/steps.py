"""Train, prefill and serve steps, as in the JAX package's launch/steps.py.

The reference jits them; PyTorch runs them eagerly. The train step
supports gradient accumulation (microbatches run one after another, so one
microbatch's activations are live at a time) and returns scalar metrics.
launch/serve.py:Server drives make_serve_step, launch/train.py the train
step.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

_F32 = torch.float32


def make_loss_and_grads(cfg: ArchConfig):
    """loss_and_grads(params, batch) -> (fp32 loss, gradient tree like
    params): tf.forward and its backward (the reference's
    jax.value_and_grad(loss_fn)). batch leaves are tensors or arrays,
    moved to the params' device."""
    def loss_and_grads(params, batch):
        leaves = tree_leaves(params)
        device = leaves[0].device
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss = tf.forward(p, batch, cfg)
            grads = torch.autograd.grad(loss, tree_leaves(p))
        return loss.detach(), tree_unflatten(params, list(grads))
    return loss_and_grads


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    accum_steps: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {loss, grad_norm (of the unclipped gradients), lr (the
    schedule at the step just taken)}), new trees, its inputs left as they
    were.

    batch leaves have leading dim = global batch; with accum_steps > 1 the
    batch splits into that many microbatches (consecutive rows), whose
    gradients are summed in an fp32 buffer, divided and cast back to each
    parameter's dtype; the loss is their mean."""
    loss_and_grads = make_loss_and_grads(cfg)

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            rows = len(batch["tokens"])
            if rows % accum_steps:
                raise ValueError(f"a batch of {rows} rows does not split "
                                 f"into {accum_steps} microbatches")
            mb = rows // accum_steps
            micro = [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                     for i in range(accum_steps)]
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                                 device=p.device), params)
            loss = 0.0
            for mb in micro:
                mb_loss, g = loss_and_grads(params, mb)
                tree_map(lambda a, x: a.add_(x.to(_F32)), acc, g)
                loss = loss + mb_loss
                del g
            loss = loss / accum_steps
            grads = tree_map(lambda a, p: (a / accum_steps).to(p.dtype),
                             acc, params)
            del acc
        grad_norm = adamw.global_norm(grads)
        params, opt_state = adamw.apply_updates(params, grads, opt_state,
                                                opt_cfg)
        metrics = {"loss": loss.to(_F32), "grad_norm": grad_norm,
                   "lr": adamw.schedule(opt_state.step - 1, opt_cfg)}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, max_len: int):
    """prefill_step(params, batch {tokens (B, S)[, frames]}) ->
    (last-token logits (B, V), decode cache). Bulk prefill: MoE routing is
    capacity-bounded (dropless=False), as in the reference; a dropless
    buffer is O(T) rows per expert."""
    def prefill_step(params, batch):
        return tf.prefill(params, batch["tokens"], cfg, max_len,
                          batch.get("frames"), dropless=False)
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """One-token decode: (params, cache, tokens (B, 1), cache_pos) ->
    (next_token_logits (B, V), new_cache)."""
    def serve_step(params, cache, tokens, cache_pos):
        return tf.decode_step(params, cache, tokens, cache_pos, cfg)
    return serve_step
