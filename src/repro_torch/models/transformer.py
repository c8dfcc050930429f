"""Model assembly for the LM stack, as in the JAX package's
models/transformer.py, for the SSM family (pure Mamba-1 layers: the
falcon-mamba-7b configuration).

  * Per-layer parameters are stacked over units (leading axis
    cfg.n_units), keyed `layer_<i>` inside a unit, as in the reference's
    tree. The reference scans the stack under jax.lax.scan + remat; the
    port is inference only and loops over units in Python under
    torch.inference_mode(), each unit's leaves a view of the stack.
  * Attention, MoE, MLP (d_ff > 0) and encoder layers raise
    NotImplementedError naming ROADMAP.md queue 1 item 9; the training
    loss (the reference's `forward`) waits for that item too. Activation
    sharding (the reference's dist.shard_activations) is a no-op on one
    device and is left out (queue 1 item 7).

Entry points run on the CUDA device unless the caller passes
device="cpu" (init_params, init_decode_cache, params_from_reference);
the forwards run where their params are.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import mamba as ssm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import rms_norm, truncated_normal_init

_F32 = torch.float32
Params = Any


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP.md queue 1 "
        f"item 9 (attention, MoE, MLP, encoder layers and training)")


def check_ported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError unless every layer of cfg is a Mamba layer
    with no MLP, MoE or encoder: the layers the port runs."""
    for i in range(cfg.scan_unit):
        if cfg.layer_kind(i) != "mamba":
            raise _not_ported(f"{cfg.name}: attention layers")
        if cfg.layer_is_moe(i):
            raise _not_ported(f"{cfg.name}: MoE layers")
    if cfg.d_ff > 0:
        raise _not_ported(f"{cfg.name}: MLP layers (d_ff > 0)")
    if cfg.encoder is not None:
        raise _not_ported(f"{cfg.name}: the encoder")


def _norm(x: torch.Tensor, p: dict, cfg: ArchConfig) -> torch.Tensor:
    if "bias" in p:
        raise _not_ported("layer norm (encoder layers)")
    return rms_norm(x, p["scale"], cfg.norm_eps)


def _init_norm(cfg: ArchConfig, dtype, device) -> dict:
    return {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_zip(fn: Callable, a, b) -> None:
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    else:
        fn(a, b)


def _stack(trees: list):
    """Per-unit trees -> one tree of (n_units, ...) leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unit(tree, u: int):
    """Unit u of a stacked tree: views of the stacked leaves."""
    return _tree_map(lambda t: t[u], tree)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _init_unit(generator: torch.Generator, cfg: ArchConfig, dtype,
               device) -> dict:
    """One unit = cfg.scan_unit consecutive layers (dict keyed by idx)."""
    return {f"layer_{i}": {"ln1": _init_norm(cfg, dtype, device),
                           "mamba": ssm.init_mamba(generator, cfg, dtype,
                                                   device)}
            for i in range(cfg.scan_unit)}


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.bfloat16, device=None) -> Params:
    """Random parameters in the reference's tree, drawn from `generator` on
    its own device (a CUDA generator draws on the card) and placed on
    `device` (None means the CUDA device). Each unit is drawn and copied
    into the preallocated stack, so the peak is the params plus one unit.
    The numbers differ from the JAX package's init_params; use
    params_from_reference to share weights."""
    device = resolve_device(device)
    check_ported(cfg)
    d = cfg.d_model
    params = {"embed": truncated_normal_init(generator, (cfg.vocab, d),
                                             d ** -0.5, dtype, device)}
    blocks = None
    for u in range(cfg.n_units):
        unit = _init_unit(generator, cfg, dtype, device)
        if blocks is None:
            blocks = _tree_map(lambda t: torch.empty(
                (cfg.n_units, *t.shape), dtype=t.dtype, device=device), unit)
        _tree_zip(lambda dst, src, u=u: dst[u].copy_(src), blocks, unit)
        del unit
    params["blocks"] = blocks
    params["ln_f"] = _init_norm(cfg, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = truncated_normal_init(
            generator, (cfg.vocab, d), d ** -0.5, dtype, device)
    if cfg.pos_emb == "learned":
        params["pos_emb"] = truncated_normal_init(
            generator, (cfg.max_seq, d), 0.02, dtype, device)
    return params


def params_from_reference(params_np, device=None) -> Params:
    """The JAX package's `init_params` tree, given with numpy leaves, as
    this package's params on `device` (None means the CUDA device): the
    same keys, shapes and dtypes. bf16 leaves arrive as ml_dtypes.bfloat16,
    which torch cannot take; they go through fp32 and are cast back."""
    device = resolve_device(device)

    def convert(v):
        if isinstance(v, dict):
            return {k: convert(x) for k, x in v.items()}
        v = np.array(v)                  # a writable copy
        if v.dtype.name == "bfloat16":
            return torch.as_tensor(v.astype(np.float32),
                                   device=device).to(torch.bfloat16)
        return torch.as_tensor(v, device=device)

    return convert(params_np)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, tokens: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.pos_emb == "learned":
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = x + params["pos_emb"][pos][None].to(x.dtype)
    return x


def _layer(layer: dict, x: torch.Tensor, cfg: ArchConfig,
           return_state: bool = False):
    h = _norm(x, layer["ln1"], cfg)
    if not return_state:
        return x + ssm.mamba_block(layer["mamba"], h, cfg)
    h, state = ssm.mamba_block(layer["mamba"], h, cfg, return_state=True)
    return x + h, state


def _run_blocks(params: Params, x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """(B, S, D) -> (B, S, D) through every unit in order. The reference
    also returns the MoE aux loss, which the SSM family does not have."""
    for u in range(cfg.n_units):
        unit = _unit(params["blocks"], u)
        for i in range(cfg.scan_unit):
            x = _layer(unit[f"layer_{i}"], x, cfg)
    return x


def _logits(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x.to(_F32), head.to(_F32).t())


@torch.inference_mode()
def forward_logits(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                   frames: torch.Tensor | None = None) -> torch.Tensor:
    """Full fp32 logits (B, S, V): the (B, S, V) tensor is materialized, as
    in the reference (smoke tests and the prefill-then-decode invariant)."""
    check_ported(cfg)
    if frames is not None:
        raise _not_ported("the encoder (frames)")
    x = _run_blocks(params, embed_tokens(params, tokens, cfg), cfg)
    return _logits(params, _norm(x, params["ln_f"], cfg), cfg)


# ---------------------------------------------------------------------------
# Decode (single-token serve step with caches)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Stacked per-unit caches, keyed like the parameter tree: each Mamba
    layer's (conv, ssm) state. `max_len` sizes attention KV caches, which
    the SSM family does not have."""
    device = resolve_device(device)
    check_ported(cfg)
    unit = {f"layer_{i}": ssm.init_mamba_cache(cfg, batch, dtype, device)
            for i in range(cfg.scan_unit)}
    return _tree_map(lambda t: t.expand(cfg.n_units, *t.shape).clone(), unit)


@torch.inference_mode()
def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                cache_pos, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1) int -> fp32 logits (B, V), and the
    updated cache (a new tree; the old one is left as it was). cache_pos:
    the number of tokens already prefilled / decoded."""
    check_ported(cfg)
    x = params["embed"][tokens]
    if cfg.pos_emb == "learned":
        x = x + params["pos_emb"][cache_pos][None, None].to(x.dtype)
    x = x.to(params["embed"].dtype)
    new_cache = []
    for u in range(cfg.n_units):
        unit, ucache = _unit(params["blocks"], u), _unit(cache, u)
        new_unit = {}
        for i in range(cfg.scan_unit):
            layer = unit[f"layer_{i}"]
            h = _norm(x, layer["ln1"], cfg)
            h, new_unit[f"layer_{i}"] = ssm.mamba_decode_step(
                layer["mamba"], h, ucache[f"layer_{i}"], cfg)
            x = x + h
        new_cache.append(new_unit)
    logits = _logits(params, _norm(x, params["ln_f"], cfg), cfg)
    return logits[:, 0], _stack(new_cache)


# ---------------------------------------------------------------------------
# Prefill: run the full prompt, emit logits for the last position and a
# populated decode cache.
# ---------------------------------------------------------------------------

@torch.inference_mode()
def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            max_len: int, frames: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict]:
    """tokens: (B, S) -> (last-token fp32 logits (B, V), decode cache at
    pos = S). Each layer's final conv window and SSM state make the cache.
    The reference's `dropless` (MoE routing) waits for the MoE layers."""
    check_ported(cfg)
    if frames is not None:
        raise _not_ported("the encoder (frames)")
    x = embed_tokens(params, tokens, cfg)
    caches = []
    for u in range(cfg.n_units):
        unit = _unit(params["blocks"], u)
        cache_unit = {}
        for i in range(cfg.scan_unit):
            x, cache_unit[f"layer_{i}"] = _layer(unit[f"layer_{i}"], x, cfg,
                                                 return_state=True)
        caches.append(cache_unit)
    logits = _logits(params, _norm(x[:, -1:], params["ln_f"], cfg), cfg)
    return logits[:, 0], _stack(caches)
