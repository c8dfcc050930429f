"""GQA attention with optional QKV bias, qk-norm, RoPE, KV-cache decode and
cross-attention (encoder-decoder), as in the JAX package's
models/attention.py. Plain functions over parameter dicts; plain PyTorch
(the reference's einsums reach no Pallas kernel either).

Shapes: activations (B, S, D); heads are split out only inside this module.
KV cache layout: {"k": (B, L_max, Hkv, hd), "v": ...}, with the number of
tokens already in it (`cache_pos`) carried by the caller.
"""

from __future__ import annotations

import torch

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
