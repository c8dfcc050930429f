"""Model assembly for the LM stack, as in the JAX package's
models/transformer.py: decoder LMs (dense, MoE, SSM, hybrid) and the
encoder-decoder (whisper), for training and inference.

  * Per-layer parameters are stacked over units (leading axis
    cfg.n_units), keyed `layer_<i>` inside a unit, as in the reference's
    tree. The reference scans the stack under jax.lax.scan + remat; the
    port loops over units in Python, each unit's leaves a view of the
    stack: the serving entry points under torch.inference_mode(), the
    training loss (`forward`) with autograd, each unit under
    torch.utils.checkpoint (the reference's nothing_saveable remat).
  * The loss head is vocab-chunked (_xent_total): (B, chunk, V) logits
    a chunk at a time, each chunk recomputed in the backward.
  * MoE routing: forward_logits, decode_step and prefill(dropless=True)
    route dropless (the serving semantics, models/moe.py);
    prefill(dropless=False) and the training loss are capacity-bounded.
  * Sharded params: every entry point also takes a tree placed by
    distributed/sharding.device_put. Each scan unit's weights are
    gathered, as copies, onto the device that computes just before the
    unit runs (inside torch.utils.checkpoint, so the recompute gathers
    again and one unit's gathered weights are alive at a time), and so is
    each other leaf (embed, lm_head, the final norm, the encoder per
    layer). The gathers go through autograd, so gradients land on the
    pieces. An unplaced tree runs exactly as before.
  * dist.shard_activations is called where the reference calls it (the
    residual after each mixer, MoE and MLP, the embeddings, the decode
    step's residuals); it is the identity (distributed/context.py).

Entry points run on the CUDA device unless the caller passes
device="cpu" (init_params, init_decode_cache, params_from_reference);
the forwards run where their params are.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import context as dist
from repro_torch.distributed.sharding import Placed, Stacked
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as ssm
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (dense, init_mlp, layer_norm, mlp,
                                       rms_norm, truncated_normal_init)
from repro_torch.tree import tree_from_numpy, tree_map

_F32 = torch.float32
Params = Any


def _norm(x: torch.Tensor, p: dict, cfg: ArchConfig) -> torch.Tensor:
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rms_norm(x, p["scale"], cfg.norm_eps)


def _init_norm(cfg: ArchConfig, dtype, device, with_bias=False) -> dict:
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if with_bias:
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def _stack(trees: list):
    """Per-unit trees -> one tree of (n_units, ...) leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unit(tree, u: int):
    """Unit u of a stacked tree: views of the stacked leaves (of their
    pieces, for placed leaves)."""
    return tree_map(lambda t: t.unit(u) if isinstance(t, (Placed, Stacked))
                    else t[u], tree)


def _here(tree, device: torch.device):
    """`tree` with each placed leaf gathered onto `device`; a tensor leaf
    as it is."""
    return tree_map(lambda t: t.gather(device) if isinstance(t, Placed)
                    else t, tree)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def _init_layer(generator: torch.Generator, cfg: ArchConfig, i: int, dtype,
                device) -> dict:
    """Layer i of a unit: attention or Mamba; then MoE, MLP or nothing
    (d_ff == 0: the mixer is the whole layer); then cross-attention when
    the model has an encoder."""
    layer = {"ln1": _init_norm(cfg, dtype, device)}
    if cfg.layer_kind(i) == "attn":
        layer["attn"] = attn.init_attention(generator, cfg, dtype, device)
    else:
        layer["mamba"] = ssm.init_mamba(generator, cfg, dtype, device)
    if cfg.layer_is_moe(i):
        layer["ln2"] = _init_norm(cfg, dtype, device)
        layer["moe"] = moe_lib.init_moe(generator, cfg, dtype, device)
    elif cfg.d_ff > 0:
        layer["ln2"] = _init_norm(cfg, dtype, device)
        layer["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act,
                                dtype, device)
    if cfg.encoder is not None:
        layer["ln_x"] = _init_norm(cfg, dtype, device)
        layer["xattn"] = attn.init_attention(generator, cfg, dtype, device)
    return layer


def _into_stack(stack: dict | None, n: int, j: int, tree: dict,
                device) -> dict:
    """Copy `tree` into row j of `stack`, its (n, ...) preallocation,
    allocated at the first row. A stack of one row is `tree` itself, with
    the leading axis added as a view (no copy)."""
    if n == 1:
        return tree_map(lambda t: t.unsqueeze(0), tree)
    if stack is None:
        stack = tree_map(lambda t: torch.empty(
            (n, *t.shape), dtype=t.dtype, device=device), tree)
    tree_map(lambda dst, src: dst[j].copy_(src), stack, tree)
    return stack


def _init_encoder(generator: torch.Generator, cfg: ArchConfig, dtype,
                  device) -> dict:
    """The encoder: pre-norm layers (layer norms with bias, bidirectional
    attention, a GELU MLP) stacked over its n_layers, learned positions and
    a final layer norm."""
    enc = cfg.encoder
    layers = None
    for j in range(enc.n_layers):
        layer = {"ln1": _init_norm(cfg, dtype, device, with_bias=True),
                 "attn": attn.init_attention(generator, cfg, dtype, device),
                 "ln2": _init_norm(cfg, dtype, device, with_bias=True),
                 "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, "gelu",
                                 dtype, device)}
        layers = _into_stack(layers, enc.n_layers, j, layer, device)
        del layer
    return {"layers": layers,
            "pos_emb": truncated_normal_init(generator,
                                             (enc.n_ctx, cfg.d_model), 0.02,
                                             dtype, device),
            "ln_f": _init_norm(cfg, dtype, device, with_bias=True)}


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dtype=torch.bfloat16, device=None) -> Params:
    """Random parameters in the reference's tree, drawn from `generator` on
    its own device (a CUDA generator draws on the card) and placed on
    `device` (None means the CUDA device). Each layer is drawn and copied
    into its preallocated stack, so the peak is the params plus one layer
    (a unit is a whole 8-layer period for jamba); a model of one unit
    keeps the drawn layers as its stack, and its peak is the params. The
    numbers differ from
    the JAX package's init_params; use params_from_reference to share
    weights."""
    device = resolve_device(device)
    d = cfg.d_model
    params = {"embed": truncated_normal_init(generator, (cfg.vocab, d),
                                             d ** -0.5, dtype, device)}
    blocks: dict = {}
    for u in range(cfg.n_units):
        for i in range(cfg.scan_unit):
            layer = _init_layer(generator, cfg, i, dtype, device)
            key = f"layer_{i}"
            blocks[key] = _into_stack(blocks.get(key), cfg.n_units, u, layer,
                                      device)
            del layer
    params["blocks"] = blocks
    params["ln_f"] = _init_norm(cfg, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = truncated_normal_init(
            generator, (cfg.vocab, d), d ** -0.5, dtype, device)
    if cfg.encoder is not None:
        params["encoder"] = _init_encoder(generator, cfg, dtype, device)
    if cfg.pos_emb == "learned":
        params["pos_emb"] = truncated_normal_init(
            generator, (cfg.max_seq, d), 0.02, dtype, device)
    return params


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    """init_params' tree as tensors on the "meta" device: the keys, shapes
    and dtypes with no storage and nothing drawn (a checkpoint restore's
    `like`)."""
    return init_params(torch.Generator(), cfg, dtype, device="meta")


def params_from_reference(params_np, device=None) -> Params:
    """The JAX package's `init_params` tree, given with numpy leaves, as
    this package's params on `device` (None means the CUDA device): the
    same keys, shapes and dtypes. bf16 leaves arrive as ml_dtypes.bfloat16,
    which torch cannot take; they go through fp32 and are cast back."""
    return tree_from_numpy(params_np, resolve_device(device))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, tokens: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    x = _here(params["embed"], tokens.device)[tokens]
    if cfg.pos_emb == "learned":
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = x + _here(params["pos_emb"], tokens.device)[pos][None].to(
            x.dtype)
    return dist.shard_activations(x, "residual")


def _mixer(layer: dict, h: torch.Tensor, cfg: ArchConfig, i: int,
           max_len: int | None):
    """Layer i's causal attention or Mamba block on the normed h; with
    max_len, also its decode cache entry: K / V zero-padded to max_len
    rows, or the Mamba block's (conv, ssm) state."""
    if cfg.layer_kind(i) != "attn":
        if max_len is None:
            return ssm.mamba_block(layer["mamba"], h, cfg), None
        return ssm.mamba_block(layer["mamba"], h, cfg, return_state=True)
    b, s, _ = h.shape
    q, k, v = attn._qkv(layer["attn"], h, cfg,
                        torch.arange(s, device=h.device), rope=True)
    o = attn._sdpa(q, k, v, attn.causal_mask(s, h.device),
                   cfg.n_heads // cfg.n_kv_heads)
    out = dense(o.reshape(b, s, -1), layer["attn"]["wo"])
    if max_len is None:
        return out, None
    pad = (0, 0, 0, 0, 0, max_len - s)
    return out, {"k": F.pad(k, pad), "v": F.pad(v, pad)}


def _tail(layer: dict, x: torch.Tensor, cfg: ArchConfig, i: int,
          cross_kv: dict | None, dropless: bool, kind: str | None,
          route=None):
    """What follows layer i's mixer: cross-attention on the encoder's K / V
    (encoder-decoder), then the MoE block or the MLP, whose residual takes
    the activation constraint `kind` (None: the caller constrains).
    Returns (x, the MoE aux loss, or its part under `route`, or None)."""
    if cross_kv is not None:
        h = _norm(x, layer["ln_x"], cfg)
        x = x + attn.cross_attention(layer["xattn"], h, cross_kv, cfg)
    aux = None
    if cfg.layer_is_moe(i):
        h, aux = moe_lib.moe_block(layer["moe"], _norm(x, layer["ln2"], cfg),
                                   cfg, dropless=dropless, route=route)
        x = x + h
    elif cfg.d_ff > 0:
        x = x + mlp(_norm(x, layer["ln2"], cfg), layer["mlp"], cfg.act)
    else:
        return x, aux
    return (x if kind is None else dist.shard_activations(x, kind)), aux


def _unit_forward(unit: dict, x: torch.Tensor, cfg: ArchConfig,
                  enc_out: torch.Tensor | None = None,
                  dropless: bool = False, max_len: int | None = None,
                  route=None):
    """(B, S, D) -> (B, S, D) through one unit, the summed MoE aux loss
    (fp32 scalar) and, with max_len, the unit's decode cache. Each layer
    of an encoder-decoder projects the encoder output to its own cross
    K / V (kept in the cache as xk / xv). route(i): MoE layer i's
    moe.LayerRoute, for a data group of a larger batch; the aux term is
    then the (n_moe_layers, E) stack of their summed router
    probabilities."""
    aux = torch.zeros((), dtype=_F32, device=x.device)
    parts = []
    cache = {}
    for i in range(cfg.scan_unit):
        layer = unit[f"layer_{i}"]
        h, entry = _mixer(layer, _norm(x, layer["ln1"], cfg), cfg, i,
                          max_len)
        x = dist.shard_activations(x + h, "residual")
        cross_kv = None
        if enc_out is not None:
            cross_kv = attn.encode_cross_kv(layer["xattn"], enc_out, cfg)
            if entry is not None:
                entry["xk"], entry["xv"] = cross_kv["k"], cross_kv["v"]
        x, a = _tail(layer, x, cfg, i, cross_kv, dropless, "residual",
                     route(i) if route and cfg.layer_is_moe(i) else None)
        if a is not None:
            if route is None:
                aux = aux + a
            else:
                parts.append(a)
        cache[f"layer_{i}"] = entry
    if route is not None:
        aux = (torch.stack(parts) if parts else
               x.new_zeros((0, cfg.moe.n_experts), dtype=_F32))
    return x, aux, cache


def _run_blocks(params: Params, x: torch.Tensor, cfg: ArchConfig,
                enc_out: torch.Tensor | None = None, dropless: bool = False,
                max_len: int | None = None):
    """Every unit in order: (x, summed aux loss, the stacked decode cache
    when max_len is given, else None). enc_out: the encoder's output, for
    the decoder of an encoder-decoder (the reference's
    _run_blocks_encdec)."""
    aux = torch.zeros((), dtype=_F32, device=x.device)
    caches = []
    for u in range(cfg.n_units):
        unit = _here(_unit(params["blocks"], u), x.device)
        x, a, cache = _unit_forward(unit, x, cfg, enc_out, dropless, max_len)
        del unit
        aux = aux + a
        caches.append(cache)
    return x, aux, (_stack(caches) if max_len is not None else None)


def _train_blocks(params: Params, x: torch.Tensor, cfg: ArchConfig,
                  enc_out: torch.Tensor | None = None, route=None):
    """_run_blocks for the training loss: capacity-bounded MoE, each unit
    under torch.utils.checkpoint (only its input is kept; the backward
    runs it again, its scan kernels and its weights' gathers included).
    Returns (x, summed aux loss); with route(u, i) (a data group's
    moe.LayerRoute of unit u's MoE layer i), (x, the units' stacked
    summed router probabilities)."""
    aux = torch.zeros((), dtype=_F32, device=x.device)
    parts = []
    for u in range(cfg.n_units):
        unit = _unit(params["blocks"], u)
        unit_route = None if route is None else \
            (lambda i, u=u: route(u, i))
        x, a = checkpoint(
            lambda h, unit=unit, r=unit_route: _unit_forward(
                _here(unit, h.device), h, cfg, enc_out, route=r)[:2],
            x, use_reentrant=False)
        if route is None:
            aux = aux + a
        else:
            parts.append(a)
    return x, (aux if route is None else torch.cat(parts))


def _encode(params: Params, frames: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """frames: (B, n_ctx, D) stem embeddings (models/audio.py:stem) ->
    (B, n_ctx, D), under whatever grad mode the caller set (the training
    loss backpropagates through it; `encode` is the serving entry
    point)."""
    enc = params["encoder"]
    dev = frames.device
    x = frames + _here(enc["pos_emb"], dev)[None, :frames.shape[1]].to(
        frames.dtype)
    for j in range(cfg.encoder.n_layers):
        layer = _here(_unit(enc["layers"], j), dev)
        h = _norm(x, layer["ln1"], cfg)
        x = x + attn.self_attention(layer["attn"], h, cfg, causal=False)
        h = _norm(x, layer["ln2"], cfg)
        x = x + mlp(h, layer["mlp"], "gelu")
        del layer
    return _norm(x, _here(enc["ln_f"], dev), cfg)


@torch.inference_mode()
def encode(params: Params, frames: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """The encoder for serving: frames (B, n_ctx, D) -> (B, n_ctx, D)."""
    return _encode(params, frames, cfg)


# ---------------------------------------------------------------------------
# Loss (vocab-chunked cross-entropy)
# ---------------------------------------------------------------------------

def _xent_sum(x: torch.Tensor, head: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one chunk: x (B, c, D), labels (B, c), the
    logits (B, c, V) in fp32; labels < 0 count zero."""
    logits = torch.matmul(x.to(_F32), head.to(_F32).t())
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    return ((lse - gold) * (labels >= 0).to(_F32)).sum()


def _xent_total(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                chunk: int) -> torch.Tensor:
    """x: (B, S, D), head: (V, D), labels: (B, S) -> the summed loss over
    the labels >= 0. Chunks of `chunk` positions (the whole sequence when
    that does not divide S), each under torch.utils.checkpoint, so one
    chunk's (B, chunk, V) logits are live at a time, forward and
    backward."""
    s = x.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    labels = labels.long()
    tot = torch.zeros((), dtype=_F32, device=x.device)
    for l0 in range(0, s, chunk):
        sl = slice(l0, l0 + chunk)
        tot = tot + checkpoint(_xent_sum, x[:, sl], head, labels[:, sl],
                               use_reentrant=False)
    return tot


def n_labels(labels: torch.Tensor) -> torch.Tensor:
    """The loss's divisor: the labels >= 0, at least one (fp32)."""
    return (labels >= 0).sum().to(_F32).clamp_min(1.0)


def loss_terms(params: Params, batch: dict, cfg: ArchConfig, route=None):
    """forward's two terms: (the cross-entropy summed over the labels >=
    0, the summed MoE aux loss). With route(u, i) (a data group's
    moe.LayerRoute of unit u's MoE layer i), the second term is the
    stacked summed router probabilities, for moe.GroupRouting.aux."""
    enc_out = (_encode(params, batch["frames"], cfg)
               if cfg.encoder is not None else None)
    x = embed_tokens(params, batch["tokens"], cfg)
    x, aux = _train_blocks(params, x, cfg, enc_out, route)
    x = _norm(x, _here(params["ln_f"], x.device), cfg)
    head = _here(params["embed"] if cfg.tie_embeddings
                 else params["lm_head"], x.device)
    return _xent_total(x, head, batch["labels"], cfg.logits_chunk), aux


def forward(params: Params, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Training loss. batch: {tokens (B, S), labels (B, S)[, frames]} ->
    fp32 scalar: the vocab-chunked cross-entropy plus 0.01 x the summed
    MoE aux loss. MoE routing is capacity-bounded, as the reference's
    `_run_blocks` default; an encoder-decoder runs its encoder on the
    frames and each decoder layer its own cross K / V."""
    tot, aux = loss_terms(params, batch, cfg)
    loss = tot / n_labels(batch["labels"])
    return loss + 0.01 * aux


def _encoder_out(params: Params, frames, cfg: ArchConfig):
    if cfg.encoder is None:
        return None
    if frames is None:
        raise ValueError(f"{cfg.name} has an encoder: pass frames=")
    return encode(params, frames, cfg)


def _logits(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    head = _here(params["embed"] if cfg.tie_embeddings
                 else params["lm_head"], x.device)
    return torch.matmul(x.to(_F32), head.to(_F32).t())


@torch.inference_mode()
def forward_logits(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                   frames: torch.Tensor | None = None) -> torch.Tensor:
    """Full fp32 logits (B, S, V): the (B, S, V) tensor is materialized, as
    in the reference (smoke tests and the prefill-then-decode invariant).
    Inference semantics: MoE routing is dropless."""
    enc_out = _encoder_out(params, frames, cfg)
    x, _, _ = _run_blocks(params, embed_tokens(params, tokens, cfg), cfg,
                          enc_out, dropless=True)
    return _logits(params, _norm(x, _here(params["ln_f"], x.device), cfg),
                   cfg)


# ---------------------------------------------------------------------------
# Decode (single-token serve step with caches)
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Stacked per-unit caches, keyed like the parameter tree: KV caches
    of max_len rows for attention layers, (conv, ssm) state for Mamba
    layers, and for an encoder-decoder each layer's read-only cross K / V
    (xk / xv, n_ctx rows), filled by prefill."""
    device = resolve_device(device)
    unit = {}
    for i in range(cfg.scan_unit):
        if cfg.layer_kind(i) == "attn":
            c = attn.init_kv_cache(cfg, batch, max_len, dtype, device)
        else:
            c = ssm.init_mamba_cache(cfg, batch, dtype, device)
        if cfg.encoder is not None:
            xc = attn.init_kv_cache(cfg, batch, cfg.encoder.n_ctx, dtype,
                                    device)
            c["xk"], c["xv"] = xc["k"], xc["v"]
        unit[f"layer_{i}"] = c
    return tree_map(lambda t: t.expand(cfg.n_units, *t.shape).clone(), unit)


def abstract_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                          dtype=torch.bfloat16) -> dict:
    """init_decode_cache's tree on the "meta" device: the keys, shapes and
    dtypes with no storage (the reference's jax.eval_shape version)."""
    return init_decode_cache(cfg, batch, max_len, dtype, device="meta")


@torch.inference_mode()
def decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                cache_pos, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1) int -> fp32 logits (B, V), and the
    updated cache (a new tree; the old one is left as it was). cache_pos:
    the number of tokens already prefilled / decoded, one for the whole
    batch; it must be below the KV caches' max_len. MoE routing is
    dropless."""
    dev = tokens.device
    x = _here(params["embed"], dev)[tokens]
    if cfg.pos_emb == "learned":
        x = x + _here(params["pos_emb"], dev)[cache_pos][None, None].to(
            x.dtype)
    x = x.to(params["embed"].dtype)
    new_cache = []
    for u in range(cfg.n_units):
        unit = _here(_unit(params["blocks"], u), dev)
        ucache = _unit(cache, u)
        new_unit = {}
        for i in range(cfg.scan_unit):
            layer = unit[f"layer_{i}"]
            lcache = dict(ucache[f"layer_{i}"])
            xk, xv = lcache.pop("xk", None), lcache.pop("xv", None)
            h = _norm(x, layer["ln1"], cfg)
            if cfg.layer_kind(i) == "attn":
                h, nc = attn.decode_self_attention(layer["attn"], h, lcache,
                                                   cache_pos, cfg)
            else:
                h, nc = ssm.mamba_decode_step(layer["mamba"], h, lcache, cfg)
            x = dist.shard_activations(x + h, "decode")
            cross_kv = None
            if xk is not None:
                cross_kv = {"k": xk, "v": xv}
                nc["xk"], nc["xv"] = xk, xv
            x, _ = _tail(layer, x, cfg, i, cross_kv, dropless=True,
                         kind=None)
            x = dist.shard_activations(x, "decode")
            new_unit[f"layer_{i}"] = nc
        new_cache.append(new_unit)
        del unit
    logits = _logits(params, _norm(x, _here(params["ln_f"], dev), cfg), cfg)
    return logits[:, 0], _stack(new_cache)


# ---------------------------------------------------------------------------
# Prefill: run the full prompt, emit logits for the last position and a
# populated decode cache.
# ---------------------------------------------------------------------------

@torch.inference_mode()
def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            max_len: int, frames: torch.Tensor | None = None,
            dropless: bool = True) -> tuple[torch.Tensor, dict]:
    """tokens: (B, S) -> (last-token fp32 logits (B, V), decode cache at
    pos = S): each attention layer's K / V zero-padded to max_len rows,
    each Mamba layer's final conv window and SSM state, and for an
    encoder-decoder (frames given) each layer's cross K / V.

    dropless: exact MoE routing (the serving semantics, which prefill +
    decode must reproduce forward_logits under); the bulk prefill step
    passes dropless=False, capacity-bounded routing, as the reference's
    does."""
    s = tokens.shape[1]
    if s > max_len:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{max_len}")
    enc_out = _encoder_out(params, frames, cfg)
    x, _, cache = _run_blocks(params, embed_tokens(params, tokens, cfg), cfg,
                              enc_out, dropless=dropless, max_len=max_len)
    logits = _logits(params, _norm(x[:, -1:], _here(params["ln_f"],
                                                    x.device), cfg), cfg)
    return logits[:, 0], cache
