"""Prefill and serve steps, as in the JAX package's launch/steps.py.

The reference jits them; PyTorch runs them eagerly. `make_train_step`
waits for training (ROADMAP.md queue 1 item 9). launch/serve.py:Server
drives make_serve_step.
"""

from __future__ import annotations

from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig


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
