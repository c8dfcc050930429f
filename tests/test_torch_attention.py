"""Parity of the port's attention and shared LM layers with the JAX
package's models/{layers,attention}.py: layer_norm, the biased dense, the
three MLPs, RoPE, self-attention (causal and bidirectional; GQA at n_rep
1, 2 and 4; QKV bias; qk-norm; learned positions), cross-attention, the
encoder's cross K / V and the one-token decode against the KV cache, on
the same weights (the reference's, carried over) and inputs from numpy
seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models.config import ArchConfig
from repro_torch.models import attention as pt_attn
from repro_torch.models import layers as pt_layers
from repro_torch.models import transformer as pt_tf

#: fp32: the same ops in the same dtype, summed in other orders: 1e-5 of
#: max |ref|.
TOL = 1e-5
#: bf16 weights and activations: the same roundings on both sides but
#: for a sum that lands on a rounding boundary.
TOL_BF16 = 1e-4
B, S = 2, 10


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return pt_tf.params_from_reference(_np(tree), device="cpu")


def _cfg(n_heads=4, n_kv_heads=4, qkv_bias=False, qk_norm=False,
         pos_emb="rope"):
    return ArchConfig(name="t", family="dense", n_layers=1, d_model=64,
                      n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=16,
                      d_ff=128, vocab=32, qkv_bias=qkv_bias, qk_norm=qk_norm,
                      pos_emb=pos_emb, rope_theta=10_000.0)


def _x(seed, shape=(B, S, 64), dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _params(cfg, seed):
    """The reference's attention params with nonzero biases and norm
    scales, so that both reach the check."""
    p = dict(ref_attn.init_attention(jax.random.key(seed), cfg, jnp.float32))
    rng = np.random.default_rng(seed + 100)
    for k in ("bq", "bk", "bv"):
        if k in p:
            p[k] = jnp.asarray(0.1 * rng.standard_normal(p[k].shape),
                               jnp.float32)
    for k in ("q_norm", "k_norm"):
        if k in p:
            p[k] = jnp.asarray(1 + 0.1 * rng.standard_normal(p[k].shape),
                               jnp.float32)
    return p


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    x = _x(0) * 3 + 1
    w, b = _x(1, (64,)), _x(2, (64,))
    want = ref_layers.layer_norm(jnp.asarray(x, dtype), jnp.asarray(w),
                                 jnp.asarray(b), 1e-5)
    got = pt_layers.layer_norm(torch.tensor(x).to(getattr(torch, dtype)),
                               torch.tensor(w), torch.tensor(b), 1e-5)
    assert str(got.dtype) == f"torch.{dtype}"
    assert _rel(got.float().numpy(), want) <= (
        TOL if dtype == "float32" else TOL_BF16)


def test_dense_with_bias_matches_reference():
    x, w, b = _x(3), _x(4, (64, 48)), _x(5, (48,))
    want = ref_layers.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = pt_layers.dense(torch.tensor(x), torch.tensor(w), torch.tensor(b))
    assert _rel(got.numpy(), want) <= TOL
    want = ref_layers.dense(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                            jnp.asarray(b))
    got = pt_layers.dense(torch.tensor(x).bfloat16(), torch.tensor(w),
                          torch.tensor(b))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= TOL_BF16


@pytest.mark.parametrize("act", ["swiglu", "gelu", "squared_relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(act, dtype):
    p = ref_layers.init_mlp(jax.random.key(7), 64, 128, act,
                            getattr(jnp, dtype))
    x = _x(8)
    want = ref_layers.mlp(jnp.asarray(x, getattr(jnp, dtype)), p, act)
    got = pt_layers.mlp(torch.tensor(x).to(getattr(torch, dtype)),
                        _port(p), act)
    assert set(_port(p)) == ({"up", "down", "gate"} if act == "swiglu"
                             else {"up", "down"})
    assert _rel(got.float().numpy(), want) <= (
        TOL if dtype == "float32" else TOL_BF16)


def test_init_mlp_tree_matches_reference():
    for act in ("swiglu", "gelu"):
        ref = ref_layers.init_mlp(jax.random.key(0), 64, 96, act, jnp.float32)
        got = pt_layers.init_mlp(torch.Generator().manual_seed(0), 64, 96,
                                 act, torch.float32, "cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in ref.items()}


@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_apply_rope_matches_reference(positions):
    """Positions (S,) in prefill, (B, 1) in decode; split halves rotate."""
    if positions == "prefill":
        x, pos = _x(9, (B, S, 4, 16)), np.arange(S, dtype=np.int32) + 3
    else:
        x, pos = _x(9, (B, 1, 4, 16)), np.array([[5], [77]], np.int32)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = pt_layers.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0)
    assert _rel(got.numpy(), want) <= TOL
    # position 0 is the identity
    x0 = torch.tensor(_x(10, (1, 1, 2, 16)))
    assert torch.allclose(pt_layers.apply_rope(x0, torch.zeros(1), 1e4), x0)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (n_heads, n_kv_heads, qkv_bias, qk_norm): GQA n_rep 1, 2, 4
    (4, 4, False, False),
    (4, 2, True, False),
    (4, 1, False, True),
    (8, 2, True, True),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads,kv,bias,qkn", ATTN_CASES)
def test_self_attention_matches_reference(causal, heads, kv, bias, qkn):
    cfg = _cfg(heads, kv, bias, qkn)
    p = _params(cfg, heads + kv)
    x = _x(11)
    want = ref_attn.self_attention(p, jnp.asarray(x), cfg, causal=causal)
    got = pt_attn.self_attention(_port(p), torch.tensor(x), cfg,
                                 causal=causal)
    assert got.shape == (B, S, 64)
    assert _rel(got.numpy(), want) <= TOL


def test_self_attention_learned_positions_and_bf16():
    """pos_emb="learned" takes no RoPE; bf16 params and activations."""
    cfg = _cfg(4, 2, True, False, pos_emb="learned")
    p = _params(cfg, 3)
    x = _x(12)
    want = ref_attn.self_attention(p, jnp.asarray(x), cfg)
    got = pt_attn.self_attention(_port(p), torch.tensor(x), cfg)
    assert _rel(got.numpy(), want) <= TOL
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    want = ref_attn.self_attention(p16, jnp.asarray(x, jnp.bfloat16), cfg)
    got = pt_attn.self_attention(_port(p16), torch.tensor(x).bfloat16(), cfg)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= TOL_BF16


def test_fully_masked_row_is_uniform_not_nan():
    """The -1e30 mask leaves a fully masked row finite (uniform weights),
    as the reference's does; -inf would give NaNs."""
    q = torch.randn(1, 2, 2, 8)
    k = torch.randn(1, 3, 2, 8)
    v = torch.randn(1, 3, 2, 8)
    mask = torch.zeros(1, 2, 3, dtype=torch.bool)
    got = pt_attn._sdpa(q, k, v, mask, 1)
    want = ref_attn._sdpa(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                          jnp.asarray(v.numpy()),
                          jnp.zeros((1, 2, 3), bool), 1)
    assert torch.isfinite(got).all()
    assert torch.allclose(got[0, 0], v[0].mean(0), atol=1e-6)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("heads,kv,bias,qkn", ATTN_CASES[:2])
def test_cross_attention_and_encoder_kv_match_reference(heads, kv, bias, qkn):
    cfg = _cfg(heads, kv, bias, qkn)
    p = _params(cfg, 21)
    x, enc = _x(13, (B, 3, 64)), _x(14, (B, 16, 64))
    kv_ref = ref_attn.encode_cross_kv(p, jnp.asarray(enc), cfg)
    kv_pt = pt_attn.encode_cross_kv(_port(p), torch.tensor(enc), cfg)
    for k in ("k", "v"):
        assert tuple(kv_pt[k].shape) == kv_ref[k].shape
        assert _rel(kv_pt[k].numpy(), kv_ref[k]) <= TOL
    want = ref_attn.cross_attention(p, jnp.asarray(x), kv_ref, cfg)
    got = pt_attn.cross_attention(_port(p), torch.tensor(x), kv_pt, cfg)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("heads,kv,bias,qkn", ATTN_CASES)
def test_decode_self_attention_matches_reference(heads, kv, bias, qkn):
    """Token by token from an empty cache: each step's output and cache
    against the reference's, and the last step against the causal
    forward at that position."""
    cfg = _cfg(heads, kv, bias, qkn)
    p = _params(cfg, 31)
    pp = _port(p)
    x = _x(15, (B, 6, 64))
    ref_c = ref_attn.init_kv_cache(cfg, B, 8, jnp.float32)
    pt_c = pt_attn.init_kv_cache(cfg, B, 8, torch.float32, "cpu")
    assert tuple(pt_c["k"].shape) == ref_c["k"].shape
    for t in range(6):
        want, ref_c = ref_attn.decode_self_attention(
            p, jnp.asarray(x[:, t:t + 1]), ref_c, jnp.int32(t), cfg)
        before = pt_c["k"].clone()
        got, new_c = pt_attn.decode_self_attention(
            pp, torch.tensor(x[:, t:t + 1]), pt_c, t, cfg)
        assert torch.equal(pt_c["k"], before)       # the input is left as is
        pt_c = new_c
        assert _rel(got.numpy(), want) <= TOL
        for k in ("k", "v"):
            assert _rel(pt_c[k].numpy(), ref_c[k]) <= TOL
    full = pt_attn.self_attention(pp, torch.tensor(x), cfg)
    assert _rel(got[:, 0].numpy(), full[:, -1].numpy()) <= TOL


def test_decode_past_the_cache_raises():
    """The reference's dynamic_update_slice clamps a start past the end;
    the port refuses it."""
    cfg = _cfg()
    pp = _port(_params(cfg, 1))
    cache = pt_attn.init_kv_cache(cfg, 1, 4, torch.float32, "cpu")
    x = torch.tensor(_x(16, (1, 1, 64)))
    pt_attn.decode_self_attention(pp, x, cache, 3, cfg)
    with pytest.raises(ValueError, match="outside the KV cache"):
        pt_attn.decode_self_attention(pp, x, cache, 4, cfg)


def test_init_attention_tree_matches_reference():
    for heads, kv, bias, qkn in ATTN_CASES:
        cfg = _cfg(heads, kv, bias, qkn)
        ref = ref_attn.init_attention(jax.random.key(0), cfg, jnp.bfloat16)
        got = pt_attn.init_attention(torch.Generator().manual_seed(0), cfg,
                                     torch.bfloat16, "cpu")
        assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in
                got.items()} == {k: (v.shape, str(v.dtype)) for k, v in
                                 ref.items()}
        cfg2 = dataclasses.replace(cfg, qkv_bias=not bias)
        assert ("bq" in pt_attn.init_attention(
            torch.Generator(), cfg2, torch.float32, "cpu")) == (not bias)
