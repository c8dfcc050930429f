"""GQA attention with optional QKV bias, qk-norm, RoPE, KV-cache decode and
cross-attention (encoder-decoder), as in the JAX package's
models/attention.py. Plain functions over parameter dicts; plain PyTorch
(the reference's einsums reach no Pallas kernel either).

Shapes: activations (B, S, D); heads are split out only inside this module.
KV cache layout: {"k": (B, L_max, Hkv, hd), "v": ...}, with the number of
tokens already in it (`cache_pos`) carried by the caller.

**Over the "model" axis** (models/transformer.py's tensor-parallel
program): `tp_split` says how n model positions split the heads. Position
m computes its H / n query heads and the KV heads they read (its Hkv / n
where n divides Hkv, else the one KV head its query heads share: GQA
with fewer KV heads than positions), with the functions above on its
blocks (`tp_views`) under `local_config`; its wo rows give a partial sum
of the output. The decode cache follows `kv_layout`, cache_specs' choice:
split by KV heads, else by head dim, else whole. Split by head dim, the
decode step runs `decode_self_attention_split`: each position writes and
reads its dims of the cache only.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import context as dist
from repro_torch.distributed.sharding import _to, compute_view
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_rope, dense, rms_norm,
                                       truncated_normal_init)

#: The masked score: finite, so a row that the mask leaves empty softmaxes
#: to a uniform row instead of NaNs, as in the reference.
_NEG_INF = -1e30


def init_attention(generator: torch.Generator, cfg: ArchConfig, dtype,
                   device=None) -> dict:
    d, hd = cfg.d_model, cfg.head_dim

    def tn(shape, scale):
        return truncated_normal_init(generator, shape, scale, dtype, device)

    p = {"wq": tn((d, cfg.n_heads * hd), d ** -0.5),
         "wk": tn((d, cfg.n_kv_heads * hd), d ** -0.5),
         "wv": tn((d, cfg.n_kv_heads * hd), d ** -0.5),
         "wo": tn((cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5)}
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, positions, *,
         rope: bool):
    hd = cfg.head_dim
    q = _split_heads(dense(x, p["wq"], p.get("bq")), cfg.n_heads, hd)
    k = _split_heads(dense(x, p["wk"], p.get("bk")), cfg.n_kv_heads, hd)
    v = _split_heads(dense(x, p["wv"], p.get("bv")), cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope and cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None, n_rep: int) -> torch.Tensor:
    """q: (B, Sq, H, hd); k / v: (B, Sk, Hkv, hd). GQA by head grouping:
    query head h reads KV head h // n_rep (no KV copy at H width). fp32
    scores and softmax; the output in v's dtype."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, sq, hkv, n_rep, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", q.float(), k.float())
    scores = scores * (hd ** -0.5)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(b, sq, h, hd).to(v.dtype)


def causal_mask(s: int, device) -> torch.Tensor:
    """(1, S, S): query i sees keys 0..i."""
    idx = torch.arange(s, device=device)
    return (idx[:, None] >= idx[None, :])[None]


def self_attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   causal: bool = True, positions=None) -> torch.Tensor:
    """Full self-attention over (B, S, D)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions, rope=True)
    mask = causal_mask(s, x.device) if causal else None
    out = _sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads)
    return dense(out.reshape(b, s, -1), p["wo"])


def cross_attention(p: dict, x: torch.Tensor, kv_cache: dict,
                    cfg: ArchConfig) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (no RoPE on
    q)."""
    b, s, _ = x.shape
    q = _split_heads(dense(x, p["wq"], p.get("bq")), cfg.n_heads,
                     cfg.head_dim)
    out = _sdpa(q, kv_cache["k"], kv_cache["v"], None,
                cfg.n_heads // cfg.n_kv_heads)
    return dense(out.reshape(b, s, -1), p["wo"])


def encode_cross_kv(p: dict, enc_out: torch.Tensor, cfg: ArchConfig) -> dict:
    hd = cfg.head_dim
    return {"k": _split_heads(dense(enc_out, p["wk"], p.get("bk")),
                              cfg.n_kv_heads, hd),
            "v": _split_heads(dense(enc_out, p["wv"], p.get("bv")),
                              cfg.n_kv_heads, hd)}


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                  device=None) -> dict:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_self_attention(p: dict, x: torch.Tensor, cache: dict, cache_pos,
                          cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """One-token decode step. x: (B, 1, D); cache k / v: (B, L_max, Hkv,
    hd); cache_pos: the number of tokens already in the cache, where this
    token's K / V are written (into a new cache; the given one is left as
    it was). The reference's dynamic_update_slice would clamp a
    cache_pos >= L_max onto the last row, which its server never reaches
    (it stops at L_max - 1); here that raises a ValueError instead."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    l_max = cache["k"].shape[1]
    pos = int(cache_pos)
    if not 0 <= pos < l_max:
        raise ValueError(f"cache_pos {pos} is outside the KV cache of "
                         f"{l_max} rows")
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, positions, rope=True)
    idx = torch.tensor([pos], device=x.device)
    k = cache["k"].index_copy(1, idx, k_new.to(cache["k"].dtype))
    v = cache["v"].index_copy(1, idx, v_new.to(cache["v"].dtype))
    mask = (torch.arange(l_max, device=x.device) <= pos)[None, None]
    out = _sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads)
    return dense(out.reshape(b, 1, -1), p["wo"]), {"k": k, "v": v}


# ---------------------------------------------------------------------------
# Tensor-parallel over the "model" axis
# ---------------------------------------------------------------------------

def tp_split(cfg: ArchConfig, n: int) -> tuple[int, int] | None:
    """(query heads, KV heads) of each of n model positions, or None where
    the heads do not split: n must divide the query heads, and the KV
    heads must split evenly (n divides them) or be shared (they divide n:
    each position then reads one KV head)."""
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    if n < 2 or h % n or (hkv % n and n % hkv):
        return None
    return h // n, max(hkv // n, 1)


def kv_heads_of(cfg: ArchConfig, n: int, m: int) -> int:
    """The first KV head model position m reads."""
    hkv = cfg.n_kv_heads
    return m * (hkv // n) if hkv % n == 0 else m * hkv // n


def kv_layout(cfg: ArchConfig, n: int) -> str:
    """How cache_specs splits a KV cache over n model positions: "heads",
    "dims" (the head dim, where the KV heads do not divide) or "whole"."""
    if cfg.n_kv_heads % n == 0:
        return "heads"
    return "dims" if cfg.head_dim % n == 0 else "whole"


def local_config(cfg: ArchConfig, n: int) -> ArchConfig:
    """The config one model position computes its heads under."""
    hq, hkv = tp_split(cfg, n)
    return dataclasses.replace(cfg, n_heads=hq, n_kv_heads=hkv)


def tp_views(p: dict, cfg: ArchConfig, n: int, m: int, device) -> dict:
    """Model position m's blocks of the (placed) attention params on
    `device`: wq / bq columns and wo rows of its query heads, wk / wv / bk
    / bv columns of the KV heads they read, the qk norms whole."""
    hd = cfg.head_dim
    hq, hkv = tp_split(cfg, n)
    q = [(m * hq * hd, (m + 1) * hq * hd)]
    k0 = kv_heads_of(cfg, n, m)
    kv = [(k0 * hd, (k0 + hkv) * hd)]
    ranges = {"wq": q, "bq": q, "wo": q, "wk": kv, "wv": kv, "bk": kv,
              "bv": kv}
    return {name: compute_view(leaf, m, n, device, ranges.get(name))
            for name, leaf in p.items()}


def decode_self_attention_split(p: dict, x: torch.Tensor, caches: list,
                                cache_pos, cfg: ArchConfig,
                                group) -> tuple[torch.Tensor, list]:
    """decode_self_attention with the KV cache split by head dim over the
    group's model positions (`caches[m]`, position m's dims of every KV
    head, on its device): q, k and v whole at the first position (p and x
    there); each position writes its dims of the new K / V into its part
    and computes its dims' share of the scores; the shares add at the
    first position (the all-reduce), the softmax runs there, each position
    weights its dims of V, and the first position joins the dims for wo.
    Returns (the output, on the first position; the new parts)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    l_max = caches[0]["k"].shape[1]
    pos = int(cache_pos)
    if not 0 <= pos < l_max:
        raise ValueError(f"cache_pos {pos} is outside the KV cache of "
                         f"{l_max} rows")
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, positions, rope=True)
    hd, hkv, h = cfg.head_dim, cfg.n_kv_heads, cfg.n_heads
    qg = q.reshape(b, 1, hkv, h // hkv, hd)
    width = hd // len(caches)

    def write(m):
        dev, cache = group.devices[m], caches[m]
        dims = slice(m * width, (m + 1) * width)
        idx = torch.tensor([pos], device=dev)
        k = cache["k"].index_copy(1, idx, _to(k_new[..., dims], dev).to(
            cache["k"].dtype))
        v = cache["v"].index_copy(1, idx, _to(v_new[..., dims], dev).to(
            cache["v"].dtype))
        share = torch.einsum("bqgrd,bkgd->bgrqk",
                             _to(qg[..., dims], dev).float(), k.float())
        return {"k": k, "v": v}, share
    written = dist.each(group, write)
    scores = written[0][1]
    for _, share in written[1:]:
        scores = scores + _to(share, x.device)
    scores = scores * (hd ** -0.5)
    mask = (torch.arange(l_max, device=x.device) <= pos)[None, None]
    scores = scores.masked_fill(~mask[:, None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    outs = dist.each(group, lambda m: torch.einsum(
        "bgrqk,bkgd->bqgrd", _to(probs, group.devices[m]),
        written[m][0]["v"].float()))
    out = torch.cat([_to(o, x.device) for o in outs], dim=-1)
    out = out.reshape(b, 1, h, hd).to(caches[0]["v"].dtype)
    return dense(out.reshape(b, 1, -1), p["wo"]), [c for c, _ in written]
