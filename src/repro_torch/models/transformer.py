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
    distributed/sharding.device_put. Outside a mesh, each scan unit's
    weights are gathered whole, as copies, onto the device that computes
    just before the unit runs, and so is each other leaf (embed,
    lm_head, the final norm, the encoder per layer). Under a mesh
    (distributed/context.use_mesh) the tree runs the tensor-parallel
    program at the end of this module: each data group's model positions
    compute their shares on compute views of the leaves, gathered inside
    torch.utils.checkpoint in training (the recompute gathers again, one
    unit's views alive at a time), and the decode cache is placed by
    cache_specs. The gathers go through autograd, so gradients land on
    the pieces. An unplaced tree runs exactly as before.
  * dist.shard_activations is called where the reference calls it (the
    residual after each mixer, MoE and MLP, the embeddings, the decode
    step's residuals): the identity on this path's whole activations, the
    sequence split of the tensor-parallel program's residual.

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
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import (Placed, Stacked, _to, block,
                                              compute_view, keeps_model)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as ssm
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (dense, init_mlp, layer_norm, mlp,
                                       rms_norm, truncated_normal_init)
from repro_torch.tree import tree_from_numpy, tree_map, tree_map_with_path

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
        return _mamba(layer["mamba"], h, cfg, max_len)
    return _attention(layer["attn"], h, cfg, max_len)


def _mamba(p: dict, h: torch.Tensor, cfg: ArchConfig, max_len: int | None):
    if max_len is None:
        return ssm.mamba_block(p, h, cfg), None
    return ssm.mamba_block(p, h, cfg, return_state=True)


def _attention(p: dict, h: torch.Tensor, cfg: ArchConfig,
               max_len: int | None):
    """Causal self-attention on the normed h; with max_len, also its K /
    V zero-padded to max_len rows."""
    b, s, _ = h.shape
    q, k, v = attn._qkv(p, h, cfg, torch.arange(s, device=h.device),
                        rope=True)
    o = attn._sdpa(q, k, v, attn.causal_mask(s, h.device),
                   cfg.n_heads // cfg.n_kv_heads)
    out = dense(o.reshape(b, s, -1), p["wo"])
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
    if _tp_active(params):
        return torch.cat([_to(_tp_encode(params, _frames_of(frames, g), g,
                                         cfg)[0], frames.device)
                          for g in _tp_groups(params, frames.shape[0])])
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


def loss_terms(params: Params, batch: dict, cfg: ArchConfig, route=None,
               group=None):
    """forward's two terms: (the cross-entropy summed over the labels >=
    0, the summed MoE aux loss). With route(u, i) (a data group's
    moe.LayerRoute of unit u's MoE layer i), the second term is the
    stacked summed router probabilities, for moe.GroupRouting.aux.

    Under a mesh, a placed tree runs the tensor-parallel program on the
    model positions of `group` (a context.Group, the batch its rows;
    default: the whole batch as one group at the mesh's first
    positions)."""
    if _tp_active(params):
        if group is None:
            group = dist.Group(params["embed"].sharding.mesh, 0,
                               batch["tokens"].shape[0])
        return _tp_loss_terms(params, batch, cfg, route, group)
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
    if _tp_active(params):
        if cfg.encoder is not None and frames is None:
            raise ValueError(f"{cfg.name} has an encoder: pass frames=")
        return _tp_forward_logits(params, tokens, cfg, frames)
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
                cache_pos, cfg: ArchConfig,
                groups=None) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, 1) int -> fp32 logits (B, V), and the
    updated cache (a new tree; the old one is left as it was). cache_pos:
    the number of tokens already prefilled / decoded, one for the whole
    batch; it must be below the KV caches' max_len. MoE routing is
    dropless.

    Under a mesh, a placed tree runs the tensor-parallel program on a
    cache placed by cache_specs (an unplaced one is placed first) and
    returns the new cache placed so; `groups` (indices of data groups)
    computes those groups' rows only (the dry run)."""
    if _tp_active(params):
        return _tp_decode_step(params, cache, tokens, cache_pos, cfg,
                               groups)
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
            dropless: bool = True, groups=None) -> tuple[torch.Tensor, dict]:
    """tokens: (B, S) -> (last-token fp32 logits (B, V), decode cache at
    pos = S): each attention layer's K / V zero-padded to max_len rows,
    each Mamba layer's final conv window and SSM state, and for an
    encoder-decoder (frames given) each layer's cross K / V.

    dropless: exact MoE routing (the serving semantics, which prefill +
    decode must reproduce forward_logits under); the bulk prefill step
    passes dropless=False, capacity-bounded routing, as the reference's
    does.

    Under a mesh, a placed tree runs the tensor-parallel program, and the
    cache comes back placed by cache_specs; `groups` as decode_step's."""
    s = tokens.shape[1]
    if s > max_len:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{max_len}")
    if _tp_active(params):
        if cfg.encoder is not None and frames is None:
            raise ValueError(f"{cfg.name} has an encoder: pass frames=")
        return _tp_prefill(params, tokens, cfg, max_len, frames, dropless,
                           groups)
    enc_out = _encoder_out(params, frames, cfg)
    x, _, cache = _run_blocks(params, embed_tokens(params, tokens, cfg), cfg,
                              enc_out, dropless=dropless, max_len=max_len)
    logits = _logits(params, _norm(x[:, -1:], _here(params["ln_f"],
                                                    x.device), cfg), cfg)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# The tensor-parallel program over the "model" axis
# ---------------------------------------------------------------------------
#
# Under a mesh (distributed/context.use_mesh) with a placed tree, each data
# group runs on its model positions, as the reference's jit over its
# parameter and activation specs partitions it: a layer whose leaves all
# kept their "model" axis computes each position's share (query heads and
# their KV heads, ffn columns, d_in channels, experts or expert ffn
# columns, vocab rows) on the position's compute view of its leaves
# (sharding.compute_view), and its row-parallel output is summed once
# (context.add); any other layer computes whole at the group's first
# position, as a placed tree's layers do outside a mesh. The residual is a
# context.Sharded: split by sequence where the "residual" rule allows,
# whole at each position for "decode". The decode cache is placed by
# cache_specs, and each position reads and writes its part.

def _tp_active(params) -> bool:
    """Whether the params run the tensor-parallel program: a placed tree
    on a mesh with a "model" axis, under an active mesh."""
    embed = params["embed"]
    return (dist.active_mesh() is not None and isinstance(embed, Placed)
            and "model" in embed.sharding.mesh.axis_names)


def _tp_groups(params, rows: int, groups=None) -> list:
    """The data groups of a batch of `rows` rows over the params' mesh (the
    indices `groups` of them, default all)."""
    every = dist.groups(params["embed"].sharding.mesh, rows)
    return every if groups is None else [every[g] for g in groups]


def _rows(group) -> list:
    return [(group.batch.start, group.batch.stop)]


def _splits(group, *leaves) -> bool:
    """Whether a layer of these leaves splits over the group's model
    positions: more than one, and every leaf kept its "model" axis (with
    one position the layer computes whole, as unsharded)."""
    return group.n > 1 and keeps_model(*leaves)


def _tp_norm(x, p: dict, cfg: ArchConfig):
    """The norm of each part of a Sharded activation, with its (replicated)
    weights at the part's position."""
    g = x.group
    return x.map(lambda t, m: _norm(t, tree_map(
        lambda leaf: compute_view(leaf, m, g.n, t.device), p), cfg))


def _tp_mlp(p: dict, hs: list, act: str, group) -> dist.Sharded:
    """The MLP column-parallel (up / gate) then row-parallel (down): each
    position's partial output; whole at the first position unless every
    leaf kept its "model" axis."""
    if _splits(group, *p.values()):
        return dist.Sharded(group, dist.each(group, lambda m: mlp(
            hs[m], {k: compute_view(leaf, m, group.n, group.devices[m])
                    for k, leaf in p.items()}, act)), "partial")
    return dist.Sharded(group, [mlp(hs[0], _here(p, group.first), act)],
                        "first")


def _attn_splits(p: dict, cfg: ArchConfig, n: int) -> bool:
    return attn.tp_split(cfg, n) is not None and keeps_model(*(
        leaf for k, leaf in p.items() if k not in ("q_norm", "k_norm")))


def _kv_entry(ks: list, cfg: ArchConfig, group) -> list:
    """Views (sharding.Placed.from_views) of one K or V cache entry of a
    group from each position's K / V of its KV heads: each position's
    where the cache splits by KV heads, else the whole, its KV heads
    joined at the first position."""
    n, hkv = group.n, cfg.n_kv_heads
    if attn.kv_layout(cfg, n) == "heads":
        per = hkv // n
        return [({0: _rows(group), 2: [(m * per, (m + 1) * per)]}, k)
                for m, k in enumerate(ks)]
    with dist.at(group.positions[0]):
        whole = torch.cat([_to(ks[k * n // hkv], group.first)
                           for k in range(hkv)], dim=2)
    return [({0: _rows(group)}, whole)]


def _tp_self_attention(p: dict, hs: list, cfg: ArchConfig, group,
                       max_len: int | None = None, causal: bool = True):
    """Self-attention split by heads (each position's partial output and,
    with max_len, the views of its cache entry), else whole at the first
    position."""
    n = group.n
    if not _attn_splits(p, cfg, n):
        if not causal:
            return dist.Sharded(group, [attn.self_attention(
                _here(p, group.first), hs[0], cfg, causal=False)],
                "first"), None
        out, entry = _attention(_here(p, group.first), hs[0], cfg, max_len)
        return (dist.Sharded(group, [out], "first"), None if entry is None
                else {k: [({0: _rows(group)}, t)] for k, t in entry.items()})
    lcfg = attn.local_config(cfg, n)
    views = dist.each(group, lambda m: attn.tp_views(p, cfg, n, m,
                                                     group.devices[m]))
    if not causal:
        res = dist.each(group, lambda m: (attn.self_attention(
            views[m], hs[m], lcfg, causal=False), None))
        return dist.Sharded(group, [o for o, _ in res], "partial"), None
    res = dist.each(group, lambda m: _attention(views[m], hs[m], lcfg,
                                                max_len))
    h = dist.Sharded(group, [o for o, _ in res], "partial")
    if max_len is None:
        return h, None
    return h, {k: _kv_entry([e[k] for _, e in res], cfg, group)
               for k in ("k", "v")}


def _tp_mamba(p: dict, hs: list, cfg: ArchConfig, group,
              max_len: int | None):
    """The Mamba block split by d_in channels (ssm.mamba_block_tp), else
    whole at the first position; with max_len, also the views of its
    {conv, ssm} cache entry."""
    rows = _rows(group)
    if group.n < 2 or not ssm.tp_splits(p):
        out, state = _mamba(_here(p, group.first), hs[0], cfg, max_len)
        return (dist.Sharded(group, [out], "first"), None if state is None
                else {k: [({0: rows}, t)] for k, t in state.items()})
    if max_len is None:
        return dist.Sharded(group, ssm.mamba_block_tp(p, hs, cfg, group),
                            "partial"), None
    parts, states = ssm.mamba_block_tp(p, hs, cfg, group, return_state=True)
    d_in = ssm._dims(cfg)[1]
    entry = {"conv": [({0: rows, 2: block(d_in, m, group.n)}, st["conv"])
                      for m, st in enumerate(states)],
             "ssm": [({0: rows, 1: block(d_in, m, group.n)}, st["ssm"])
                     for m, st in enumerate(states)]}
    return dist.Sharded(group, parts, "partial"), entry


def _cross_splits(p: dict, cfg: ArchConfig, n: int) -> bool:
    return attn.kv_layout(cfg, n) == "heads" and _attn_splits(p, cfg, n)


def _tp_cross_kv(p: dict, enc: list, cfg: ArchConfig, group) -> list:
    """Each position's cross K / V of its KV heads from the encoder output
    (enc[m], whole at each position), or [the whole at the first
    position]."""
    n = group.n
    if not _cross_splits(p, cfg, n):
        return [attn.encode_cross_kv(_here(p, group.first), enc[0], cfg)]
    lcfg = attn.local_config(cfg, n)
    return dist.each(group, lambda m: attn.encode_cross_kv(
        attn.tp_views(p, cfg, n, m, group.devices[m]), enc[m], lcfg))


def _cross_entry(kvs: list, group) -> dict:
    """The views of the xk / xv cache entries from _tp_cross_kv's."""
    if len(kvs) == 1:
        return {x: [({0: _rows(group)}, kvs[0][k])]
                for x, k in (("xk", "k"), ("xv", "v"))}
    per = kvs[0]["k"].shape[2]
    return {x: [({0: _rows(group), 2: [(m * per, (m + 1) * per)]}, kv[k])
                for m, kv in enumerate(kvs)]
            for x, k in (("xk", "k"), ("xv", "v"))}


def _tp_cross(p: dict, hs: list, kvs: list, cfg: ArchConfig, group):
    n = group.n
    if len(kvs) == 1:
        return dist.Sharded(group, [attn.cross_attention(
            _here(p, group.first), hs[0], kvs[0], cfg)], "first")
    lcfg = attn.local_config(cfg, n)
    return dist.Sharded(group, dist.each(group, lambda m: attn.cross_attention(
        attn.tp_views(p, cfg, n, m, group.devices[m]), hs[m], kvs[m],
        lcfg)), "partial")


def _tp_tail(layer: dict, x, cfg: ArchConfig, i: int, group, cross_kv,
             dropless: bool, kind: str | None, route=None):
    """_tail in the tensor-parallel program."""
    if cross_kv is not None:
        hs = _tp_norm(x, layer["ln_x"], cfg).whole()
        x = dist.add(x, _tp_cross(layer["xattn"], hs, cross_kv, cfg, group))
    aux = None
    if cfg.layer_is_moe(i):
        hs = _tp_norm(x, layer["ln2"], cfg).whole()
        p = layer["moe"]
        if group.n > 1 and moe_lib.tp_splits(p):
            parts, aux = moe_lib.moe_block_tp(p, hs, cfg, group, dropless,
                                              route)
            h = dist.Sharded(group, parts, "partial")
        else:
            out, aux = moe_lib.moe_block(_here(p, group.first), hs[0], cfg,
                                         dropless=dropless, route=route)
            h = dist.Sharded(group, [out], "first")
        x = dist.add(x, h)
    elif cfg.d_ff > 0:
        hs = _tp_norm(x, layer["ln2"], cfg).whole()
        x = dist.add(x, _tp_mlp(layer["mlp"], hs, cfg.act, group))
    else:
        return x, aux
    return (x if kind is None else dist.shard_activations(x, kind)), aux


def _tp_unit_forward(unit: dict, x, cfg: ArchConfig, group, enc=None,
                     dropless: bool = False, max_len: int | None = None,
                     route=None):
    """_unit_forward in the tensor-parallel program: x a Sharded residual,
    `enc` each position's whole encoder output; the unit's decode cache
    entries as views (Placed.from_views)."""
    aux = torch.zeros((), dtype=_F32, device=group.first)
    parts = []
    cache = {}
    for i in range(cfg.scan_unit):
        layer = unit[f"layer_{i}"]
        hs = _tp_norm(x, layer["ln1"], cfg).whole()
        if cfg.layer_kind(i) == "attn":
            h, entry = _tp_self_attention(layer["attn"], hs, cfg, group,
                                          max_len)
        else:
            h, entry = _tp_mamba(layer["mamba"], hs, cfg, group, max_len)
        x = dist.shard_activations(dist.add(x, h), "residual")
        cross_kv = None
        if enc is not None:
            cross_kv = _tp_cross_kv(layer["xattn"], enc, cfg, group)
            if entry is not None:
                entry.update(_cross_entry(cross_kv, group))
        x, a = _tp_tail(layer, x, cfg, i, group, cross_kv, dropless,
                        "residual",
                        route(i) if route and cfg.layer_is_moe(i) else None)
        if a is not None:
            if route is None:
                aux = aux + a
            else:
                parts.append(a)
        cache[f"layer_{i}"] = entry
    if route is not None:
        aux = (torch.stack(parts) if parts else
               torch.zeros((0, cfg.moe.n_experts), dtype=_F32,
                           device=group.first))
    return x, aux, cache


def _tp_embed(params: Params, tokens: torch.Tensor, group, cfg: ArchConfig,
              kind: str, cache_pos=None):
    """The embedding, vocab-parallel where the table kept its "model" axis
    (each position looks up the tokens in its rows, the others reading
    zero, and the sum is the constraint's reduction), then the learned
    positions (`cache_pos` in decode). A negative token indexes from the
    end, as the whole table's lookup does."""
    emb, n = params["embed"], group.n
    if _splits(group, emb):
        step = emb.shape[0] // n

        def look(m):
            dev = group.devices[m]
            table = compute_view(emb, m, n, dev)
            local = _to(tokens, dev).remainder(emb.shape[0]) - m * step
            own = ((local >= 0) & (local < step)).to(table.dtype)
            return table[local.clamp(0, step - 1)] * own[..., None]
        x = dist.Sharded(group, dist.each(group, look), "partial")
    else:
        x = dist.Sharded(group, [_here(emb, group.first)[tokens]], "first")
    x = dist.shard_activations(x, kind)
    if cfg.pos_emb == "learned":
        def add_pos(t, m):
            pe = compute_view(params["pos_emb"], m, n, t.device)
            rows = (pe[cache_pos][None, None] if cache_pos is not None
                    else pe[x.rows(m)][None])
            return t + rows.to(t.dtype)
        x = x.map(add_pos)
    return x


def _tp_head(params: Params, cfg: ArchConfig):
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _tp_logits(params: Params, xs: list, group, cfg: ArchConfig):
    """fp32 logits at the first position, from each position's whole
    normed x: vocab-parallel (each position its rows of the head, joined
    at the first), else whole there."""
    head, n = _tp_head(params, cfg), group.n
    if not _splits(group, head):
        return torch.matmul(xs[0].to(_F32),
                            _here(head, group.first).to(_F32).t())
    outs = dist.each(group, lambda m: torch.matmul(
        xs[m].to(_F32), compute_view(head, m, n, group.devices[m]).to(
            _F32).t()))
    with dist.at(group.positions[0]):
        return torch.cat([_to(o, group.first) for o in outs], dim=-1)


def _tp_xent_sum(xs: list, heads: list, labels: torch.Tensor, step: int,
                 group) -> torch.Tensor:
    """_xent_sum vocab-parallel: each position's logits of its vocab rows;
    the max, the sum of exponentials and the gold logit reduce across
    positions (at the first), so no position holds the whole logits."""
    first = group.first
    logits = dist.each(group, lambda m: torch.matmul(
        xs[m].to(_F32), heads[m].to(_F32).t()))
    maxes = dist.each(group, lambda m: logits[m].detach().amax(dim=-1))

    def part(m):
        dev = group.devices[m]
        lg = logits[m]
        se = torch.exp(lg - _to(peak, dev)[..., None]).sum(dim=-1)
        local = _to(labels, dev) - m * step
        own = ((local >= 0) & (local < step)).to(_F32)
        gold = lg.gather(-1, local.clamp(0, step - 1)[..., None])[..., 0]
        return se, gold * own
    with dist.at(group.positions[0]):
        peak = _to(maxes[0], first)
        for t in maxes[1:]:
            peak = torch.maximum(peak, _to(t, first))
    parts = dist.each(group, part)
    with dist.at(group.positions[0]):
        se, gold = _to(parts[0][0], first), _to(parts[0][1], first)
        for s_m, g_m in parts[1:]:
            se, gold = se + _to(s_m, first), gold + _to(g_m, first)
        lse = peak + torch.log(se)
        return ((lse - gold) * (labels >= 0).to(_F32)).sum()


def _tp_xent_total(params: Params, xs: list, labels: torch.Tensor,
                   cfg: ArchConfig, group) -> torch.Tensor:
    """_xent_total in the tensor-parallel program (xs: each position's
    whole normed x), each chunk under torch.utils.checkpoint."""
    head, n = _tp_head(params, cfg), group.n
    labels = labels.long()
    if not _splits(group, head):
        return _xent_total(xs[0], _here(head, group.first), labels,
                           cfg.logits_chunk)
    heads = dist.each(group, lambda m: compute_view(head, m, n,
                                                    group.devices[m]))
    step = head.shape[0] // n
    s = xs[0].shape[1]
    chunk = min(cfg.logits_chunk, s)
    if s % chunk:
        chunk = s
    tot = torch.zeros((), dtype=_F32, device=group.first)
    for l0 in range(0, s, chunk):
        sl = slice(l0, l0 + chunk)
        tot = tot + checkpoint(
            lambda lab, *t: _tp_xent_sum(list(t[:n]), list(t[n:]), lab,
                                         step, group),
            labels[:, sl], *(x[:, sl] for x in xs), *heads,
            use_reentrant=False)
    return tot


def _tp_encode(params: Params, frames: torch.Tensor, group,
               cfg: ArchConfig) -> list:
    """_encode in the tensor-parallel program: each position's whole
    encoder output (the reference constrains no encoder activation, so
    the residual stays whole at each position)."""
    enc, n = params["encoder"], group.n
    x = dist.Sharded(group, [frames], "first").to("rep")
    x = x.map(lambda t, m: t + compute_view(enc["pos_emb"], m, n, t.device)[
        None, :t.shape[1]].to(t.dtype))
    for j in range(cfg.encoder.n_layers):
        layer = _unit(enc["layers"], j)
        hs = _tp_norm(x, layer["ln1"], cfg).whole()
        x = dist.add(x, _tp_self_attention(layer["attn"], hs, cfg, group,
                                           causal=False)[0])
        hs = _tp_norm(x, layer["ln2"], cfg).whole()
        x = dist.add(x, _tp_mlp(layer["mlp"], hs, "gelu", group))
    return _tp_norm(x, enc["ln_f"], cfg).whole()


def _tp_run_blocks(params: Params, x, cfg: ArchConfig, group, enc=None,
                   dropless: bool = False, max_len: int | None = None):
    aux = torch.zeros((), dtype=_F32, device=group.first)
    caches = []
    for u in range(cfg.n_units):
        x, a, cache = _tp_unit_forward(_unit(params["blocks"], u), x, cfg,
                                       group, enc, dropless, max_len)
        aux = aux + a
        caches.append(cache)
    return x, aux, caches


def _tp_train_blocks(params: Params, x, cfg: ArchConfig, group, enc=None,
                     route=None):
    """_train_blocks in the tensor-parallel program: each unit under
    torch.utils.checkpoint with the residual's parts as its inputs (the
    recompute gathers the compute views again)."""
    aux = torch.zeros((), dtype=_F32, device=group.first)
    parts = []
    layout = x.layout
    for u in range(cfg.n_units):
        unit = _unit(params["blocks"], u)
        unit_route = None if route is None else \
            (lambda i, u=u: route(u, i))

        def run(*xs, unit=unit, r=unit_route):
            y, a, _ = _tp_unit_forward(unit, dist.Sharded(group, list(xs),
                                                          layout),
                                       cfg, group, enc, route=r)
            return (*y.parts, a)
        out = checkpoint(run, *x.parts, use_reentrant=False)
        x = dist.Sharded(group, list(out[:-1]), layout)
        if route is None:
            aux = aux + out[-1]
        else:
            parts.append(out[-1])
    return x, (aux if route is None else torch.cat(parts))


def _tp_loss_terms(params: Params, batch: dict, cfg: ArchConfig, route,
                   group):
    enc = (_tp_encode(params, batch["frames"], group, cfg)
           if cfg.encoder is not None else None)
    x = _tp_embed(params, batch["tokens"], group, cfg, "residual")
    x, aux = _tp_train_blocks(params, x, cfg, group, enc, route)
    xs = _tp_norm(x, params["ln_f"], cfg).whole()
    return _tp_xent_total(params, xs, batch["labels"], cfg, group), aux


def _tp_last(x, group):
    """The last sequence row of a Sharded residual, whole at each
    position."""
    part = x.parts[-1] if x.layout == "seq" else x.parts[0]
    with dist.at(group.positions[-1 if x.layout == "seq" else 0]):
        last = _to(part[:, -1:], group.first)
    return dist.Sharded(group, [last], "first").to("rep")


def _frames_of(frames, group):
    return None if frames is None else _to(frames[group.batch], group.first)


@torch.inference_mode()
def _tp_forward_logits(params: Params, tokens: torch.Tensor,
                       cfg: ArchConfig, frames=None):
    out = []
    for group in _tp_groups(params, tokens.shape[0]):
        tok = _to(tokens[group.batch], group.first)
        enc = (_tp_encode(params, _frames_of(frames, group), group, cfg)
               if cfg.encoder is not None else None)
        x, _, _ = _tp_run_blocks(params, _tp_embed(params, tok, group, cfg,
                                                   "residual"),
                                 cfg, group, enc, dropless=True)
        xs = _tp_norm(x, params["ln_f"], cfg).whole()
        out.append(_to(_tp_logits(params, xs, group, cfg), tokens.device))
    return torch.cat(out)


class _Shape:
    """A leaf that has a shape only (cache_specs reads no more)."""

    __slots__ = ("shape",)

    def __init__(self, *shape):
        self.shape = torch.Size(shape)


def _cache_shapes(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """init_decode_cache's tree as shapes, no tensor made (a dry run
    would count a "meta" one's bytes)."""
    u, hd, hkv = cfg.n_units, cfg.head_dim, cfg.n_kv_heads
    unit = {}
    for i in range(cfg.scan_unit):
        if cfg.layer_kind(i) == "attn":
            c = {k: _Shape(u, batch, max_len, hkv, hd) for k in ("k", "v")}
        else:
            s, d_in, _ = ssm._dims(cfg)
            c = {"conv": _Shape(u, batch, s.d_conv - 1, d_in),
                 "ssm": _Shape(u, batch, d_in, s.d_state)}
        if cfg.encoder is not None:
            for k in ("xk", "xv"):
                c[k] = _Shape(u, batch, cfg.encoder.n_ctx, hkv, hd)
        unit[f"layer_{i}"] = c
    return unit


def _cache_shardings(cfg: ArchConfig, batch: int, max_len: int, mesh):
    like = _cache_shapes(cfg, batch, max_len)
    return shd.sharding_tree(shd.cache_specs(like, cfg, mesh), mesh), like


def _placed_cache(shardings, like, views: dict, olds: dict | None = None,
                  covered_only: bool = False) -> dict:
    """The decode cache placed by cache_specs' shardings from the views
    collected for each leaf ({layer: {key: [(sel, tensor over units)]}});
    a leaf with no views (the cross K / V in decode) taken from `olds`."""
    def one(path, sharding):
        layer, key = path.split("/")
        got = views.get(layer, {}).get(key)
        if got is None:
            return olds[layer][key]
        return Placed.from_views(sharding, like[layer][key].shape,
                                 got[0][1].dtype, got, covered_only)
    return tree_map_with_path(one, shardings)


def _stacked_views(unit_views: list, into: dict, group) -> None:
    """Stack each leaf's views over the units (a leading unit dim, its sel
    shifted) and add them to `into`."""
    for layer, entry in unit_views[0].items():
        if entry is None:
            continue
        for key, first in entry.items():
            dst = into.setdefault(layer, {}).setdefault(key, [])
            for j, (sel, _) in enumerate(first):
                pos = group.positions[j if len(first) == group.n else 0]
                with dist.at(pos):
                    t = torch.stack([uv[layer][key][j][1]
                                     for uv in unit_views])
                dst.append(({d + 1: r for d, r in sel.items()}, t))


@torch.inference_mode()
def _tp_prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
                max_len: int, frames, dropless: bool, groups=None):
    mesh = params["embed"].sharding.mesh
    shardings, like = _cache_shardings(cfg, tokens.shape[0], max_len, mesh)
    views: dict = {}
    logits = []
    for group in _tp_groups(params, tokens.shape[0], groups):
        tok = _to(tokens[group.batch], group.first)
        enc = (_tp_encode(params, _frames_of(frames, group), group, cfg)
               if cfg.encoder is not None else None)
        x, _, caches = _tp_run_blocks(
            params, _tp_embed(params, tok, group, cfg, "residual"), cfg,
            group, enc, dropless=dropless, max_len=max_len)
        xs = _tp_norm(_tp_last(x, group), params["ln_f"], cfg).whole()
        logits.append(_to(_tp_logits(params, xs, group, cfg)[:, 0],
                          tokens.device))
        _stacked_views(caches, views, group)
        del x, caches
    return torch.cat(logits), _placed_cache(shardings, like, views,
                                            covered_only=groups is not None)


def _cache_view(leaf: Placed, group, m: int, whole: bool = False):
    """(sel, tensor): model position m's part of a unit's cache leaf for
    its group's rows (its block of the leaf's "model" dim), or with
    `whole` the group's rows whole at the first position."""
    sel = {0: _rows(group)}
    d = leaf.model_dim()
    if d is not None and not whole:
        sel[d] = block(leaf.shape[d], m, group.n)
    return sel, leaf.region(sel, group.first if whole
                            else group.devices[m])


def _tp_decode_attention(p: dict, hs: list, lcache: dict, cache_pos,
                         cfg: ArchConfig, group):
    """One decode step of self-attention on a placed cache: split by heads
    where the cache is, by head dim (attn.decode_self_attention_split)
    where cache_specs split that, else whole at the first position.
    Returns (the output, the new cache views)."""
    n = group.n
    layout = attn.kv_layout(cfg, n)
    if layout == "heads" and _attn_splits(p, cfg, n):
        parts = dist.each(group, lambda m: {
            k: _cache_view(lcache[k], group, m) for k in ("k", "v")})
        lcfg = attn.local_config(cfg, n)
        res = dist.each(group, lambda m: attn.decode_self_attention(
            attn.tp_views(p, cfg, n, m, group.devices[m]), hs[m],
            {k: t for k, (_, t) in parts[m].items()}, cache_pos, lcfg))
        return (dist.Sharded(group, [o for o, _ in res], "partial"),
                {k: [(parts[m][k][0], res[m][1][k]) for m in range(n)]
                 for k in ("k", "v")})
    if layout == "dims":
        parts = dist.each(group, lambda m: {
            k: _cache_view(lcache[k], group, m) for k in ("k", "v")})
        with dist.at(group.positions[0]):
            out, new = attn.decode_self_attention_split(
                _here(p, group.first), hs[0],
                [{k: t for k, (_, t) in c.items()} for c in parts],
                cache_pos, cfg, group)
        return (dist.Sharded(group, [out], "first"),
                {k: [(parts[m][k][0], new[m][k]) for m in range(n)]
                 for k in ("k", "v")})
    with dist.at(group.positions[0]):
        sels = {k: _cache_view(lcache[k], group, 0, whole=True)
                for k in ("k", "v")}
        out, new = attn.decode_self_attention(
            _here(p, group.first), hs[0],
            {k: t for k, (_, t) in sels.items()}, cache_pos, cfg)
    return (dist.Sharded(group, [out], "first"),
            {k: [(sels[k][0], new[k])] for k in ("k", "v")})


def _tp_decode_mamba(p: dict, hs: list, lcache: dict, cfg: ArchConfig,
                     group):
    """One Mamba decode step on a placed cache: split by d_in channels
    (ssm.mamba_decode_tp), else whole at the first position."""
    if group.n > 1 and ssm.tp_splits(p):
        parts = dist.each(group, lambda m: {
            k: _cache_view(lcache[k], group, m) for k in ("conv", "ssm")})
        outs, new = ssm.mamba_decode_tp(
            p, hs, [{k: t for k, (_, t) in c.items()} for c in parts], cfg,
            group)
        return (dist.Sharded(group, outs, "partial"),
                {k: [(parts[m][k][0], new[m][k]) for m in range(group.n)]
                 for k in ("conv", "ssm")})
    with dist.at(group.positions[0]):
        sels = {k: _cache_view(lcache[k], group, 0, whole=True)
                for k in ("conv", "ssm")}
        out, new = ssm.mamba_decode_step(
            _here(p, group.first), hs[0],
            {k: t for k, (_, t) in sels.items()}, cfg)
    return (dist.Sharded(group, [out], "first"),
            {k: [(sels[k][0], new[k])] for k in ("conv", "ssm")})


def _tp_cached_cross_kv(p: dict, lcache: dict, cfg: ArchConfig,
                        group) -> list:
    """The cross K / V of a placed cache as _tp_cross_kv gives them: each
    position's KV heads where the layer splits, else the whole at the
    first position."""
    if _cross_splits(p, cfg, group.n):
        return dist.each(group, lambda m: {
            k: _cache_view(lcache[x], group, m)[1]
            for k, x in (("k", "xk"), ("v", "xv"))})
    with dist.at(group.positions[0]):
        return [{k: _cache_view(lcache[x], group, 0, whole=True)[1]
                 for k, x in (("k", "xk"), ("v", "xv"))}]


@torch.inference_mode()
def _tp_decode_step(params: Params, cache: dict, tokens: torch.Tensor,
                    cache_pos, cfg: ArchConfig, groups=None):
    mesh = params["embed"].sharding.mesh
    shardings, like = _cache_shardings(cfg, tokens.shape[0],
                                       _max_len(cfg, cache), mesh)
    if not isinstance(next(iter(cache["layer_0"].values())), Placed):
        cache = shd.device_put(cache, shardings)
    views: dict = {}
    logits = []
    for group in _tp_groups(params, tokens.shape[0], groups):
        tok = _to(tokens[group.batch], group.first)
        x = _tp_embed(params, tok, group, cfg, "decode", cache_pos)
        x = x.map(lambda t, m: t.to(params["embed"].dtype))
        unit_views = []
        for u in range(cfg.n_units):
            unit = _unit(params["blocks"], u)
            ucache = _unit(cache, u)
            new_unit = {}
            for i in range(cfg.scan_unit):
                layer, lcache = unit[f"layer_{i}"], ucache[f"layer_{i}"]
                hs = _tp_norm(x, layer["ln1"], cfg).whole()
                if cfg.layer_kind(i) == "attn":
                    h, new = _tp_decode_attention(layer["attn"], hs, lcache,
                                                  cache_pos, cfg, group)
                else:
                    h, new = _tp_decode_mamba(layer["mamba"], hs, lcache,
                                              cfg, group)
                x = dist.shard_activations(dist.add(x, h), "decode")
                cross_kv = (_tp_cached_cross_kv(layer["xattn"], lcache, cfg,
                                                group)
                            if "xk" in lcache else None)
                x, _ = _tp_tail(layer, x, cfg, i, group, cross_kv,
                                dropless=True, kind=None)
                x = dist.shard_activations(x, "decode")
                new_unit[f"layer_{i}"] = new
            unit_views.append(new_unit)
        _stacked_views(unit_views, views, group)
        xs = _tp_norm(x, params["ln_f"], cfg).whole()
        logits.append(_to(_tp_logits(params, xs, group, cfg)[:, 0],
                          tokens.device))
    return torch.cat(logits), _placed_cache(
        shardings, like, views, olds=cache, covered_only=groups is not None)


def _max_len(cfg: ArchConfig, cache: dict) -> int:
    """The decode cache's row count (its KV caches' L; any for a
    Mamba-only model, whose cache has none)."""
    for i in range(cfg.scan_unit):
        if cfg.layer_kind(i) == "attn":
            return cache[f"layer_{i}"]["k"].shape[2]
    return 1
