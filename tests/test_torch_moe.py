"""Parity of the port's MoE block (models/moe.py) with the JAX package's:
dropless routing against the reference's block and against an every-
expert oracle (top-k 1 and 2 SwiGLU, 8 GELU, 2 squared ReLU, as
tests/test_moe.py), capacity drops on a batch that overflows, the aux
loss, gate renormalization and batch-composition independence, on the
reference's weights carried over.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro.models.config import ArchConfig, MoEConfig
from repro_torch.models import moe as pt_moe
from repro_torch.models import transformer as pt_tf

#: fp32: the same routing and FFN, products summed in other orders: 1e-5
#: of max |ref|.
TOL = 1e-5
#: bf16 expert weights and activations (fp32 router).
TOL_BF16 = 1e-4


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _cfg(n_experts=8, top_k=2, d_ff=32, act="swiglu"):
    return ArchConfig(name="t", family="moe", n_layers=1, d_model=16,
                      n_heads=2, n_kv_heads=2, d_ff=0, vocab=32, act=act,
                      moe=MoEConfig(n_experts=n_experts, top_k=top_k,
                                    d_ff_expert=d_ff))


def _params(cfg, seed=0, dtype=jnp.float32):
    return ref_moe.init_moe(jax.random.key(seed), cfg, dtype)


def _port(p):
    return pt_tf.params_from_reference(jax.tree.map(np.asarray, p),
                                       device="cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _every_expert(p, x, cfg):
    """Oracle: every expert on every token, combined by the top-k gates."""
    m = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xf @ p["router"], dim=-1)
    gate_vals, ids = torch.topk(probs, m.top_k)
    if m.top_k > 1:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    outs = pt_moe._expert_ffn(p, xf.expand(m.n_experts, *xf.shape), cfg.act)
    y = torch.zeros_like(xf)
    for k in range(m.top_k):
        y = y + outs[ids[:, k], torch.arange(xf.shape[0])] * \
            gate_vals[:, k, None]
    return y.reshape(x.shape)


@pytest.mark.parametrize("top_k,act", [(1, "swiglu"), (2, "swiglu"),
                                       (8, "gelu"), (2, "squared_relu")])
@pytest.mark.parametrize("dropless", [True, False])
def test_moe_block_matches_reference(top_k, act, dropless):
    """Output and aux loss against the reference's block; dropless also
    against the every-expert oracle."""
    cfg = _cfg(top_k=top_k, act=act)
    p = _params(cfg)
    x = _x(1, (2, 12, 16))
    want, want_aux = ref_moe.moe_block(p, jnp.asarray(x), cfg,
                                       dropless=dropless)
    pp = _port(p)
    got, aux = pt_moe.moe_block(pp, torch.tensor(x), cfg, dropless=dropless)
    assert got.shape == (2, 12, 16)
    assert _rel(got.numpy(), want) <= TOL
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))
    if dropless:
        oracle = _every_expert(pp, torch.tensor(x), cfg)
        assert _rel(got.numpy(), oracle.numpy()) <= TOL


def test_moe_block_bf16_matches_reference():
    cfg = _cfg()
    p = _params(cfg, dtype=jnp.bfloat16)
    x = _x(2, (2, 12, 16))
    want, _ = ref_moe.moe_block(p, jnp.asarray(x, jnp.bfloat16), cfg,
                                dropless=True)
    pp = _port(p)
    assert pp["router"].dtype == torch.float32
    got, _ = pt_moe.moe_block(pp, torch.tensor(x).bfloat16(), cfg,
                              dropless=True)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= TOL_BF16


def test_capacity_bound_drops_overflow_tokens():
    """Capacity 21 with every token forced onto expert 0: the 43 tokens
    past it contribute zero, the earliest 21 are kept, as in the
    reference; dropless keeps them all."""
    cfg = _cfg(n_experts=4, top_k=1)
    p = dict(_params(cfg))
    p["router"] = jnp.zeros_like(p["router"]).at[:, 0].set(10.0)
    x = np.abs(_x(3, (1, 64, 16))) + 0.1
    assert pt_moe.capacity(cfg.moe, 64, dropless=False) == 21
    y, _ = pt_moe.moe_block(_port(p), torch.tensor(x), cfg, dropless=False)
    dropped = (y[0] == 0).all(dim=-1).numpy()
    assert dropped.sum() == 64 - 21
    assert not dropped[:21].any() and dropped[21:].all()
    want, _ = ref_moe.moe_block(p, jnp.asarray(x), cfg, dropless=False)
    assert _rel(y.numpy(), want) <= TOL
    y2, _ = pt_moe.moe_block(_port(p), torch.tensor(x), cfg, dropless=True)
    assert not (y2[0] == 0).all(dim=-1).any()


def test_capacity_drops_on_a_random_overflowing_batch():
    """A 2 x 64 batch over 8 experts at capacity 21: some tokens overflow
    their expert; which ones, and the result, are the reference's."""
    cfg = _cfg(n_experts=8, top_k=2)
    p = _params(cfg, seed=4)
    x = _x(4, (2, 64, 16))
    got, _ = pt_moe.moe_block(_port(p), torch.tensor(x), cfg,
                              dropless=False)
    want, _ = ref_moe.moe_block(p, jnp.asarray(x), cfg, dropless=False)
    full, _ = pt_moe.moe_block(_port(p), torch.tensor(x), cfg,
                               dropless=True)
    assert _rel(got.numpy(), want) <= TOL
    assert not torch.allclose(got, full)           # something was dropped


def test_aux_loss_minimal_when_balanced():
    cfg = _cfg(n_experts=4, top_k=1)
    p = dict(_params(cfg))
    x = torch.tensor(np.abs(_x(0, (1, 256, 16))) + 0.1)
    p["router"] = jnp.zeros_like(p["router"])
    _, aux_uniform = pt_moe.moe_block(_port(p), x, cfg, dropless=True)
    p["router"] = jnp.zeros_like(p["router"]).at[:, 0].set(10.0)
    _, aux_skew = pt_moe.moe_block(_port(p), x, cfg, dropless=True)
    assert abs(float(aux_uniform) - 1.0) < 0.3
    assert float(aux_skew) > 2.0


def test_gate_renormalization_sums_to_one():
    """top_k = n_experts: the output is the dense gate-weighted mixture."""
    cfg = _cfg(n_experts=8, top_k=8)
    pp = _port(_params(cfg))
    x = torch.tensor(_x(5, (1, 6, 16)))
    y, _ = pt_moe.moe_block(pp, x, cfg, dropless=True)
    xf = x.reshape(-1, 16)
    probs = torch.softmax(xf @ pp["router"], -1)
    outs = pt_moe._expert_ffn(pp, xf.expand(8, 6, 16), cfg.act)
    want = torch.einsum("te,etd->td", probs, outs)
    assert _rel(y.reshape(-1, 16).numpy(), want.numpy()) <= TOL


def test_dropless_is_batch_composition_independent():
    cfg = _cfg()
    pp = _port(_params(cfg))
    x1, x2 = torch.tensor(_x(6, (1, 8, 16))), torch.tensor(_x(7, (1, 8, 16)))
    y_joint, _ = pt_moe.moe_block(pp, torch.cat([x1, x2]), cfg,
                                  dropless=True)
    y_solo, _ = pt_moe.moe_block(pp, x1, cfg, dropless=True)
    assert _rel(y_joint[0].numpy(), y_solo[0].numpy()) <= TOL


def test_init_moe_tree_matches_reference():
    for act in ("swiglu", "gelu"):
        cfg = _cfg(act=act)
        ref = ref_moe.init_moe(jax.random.key(0), cfg, jnp.bfloat16)
        got = pt_moe.init_moe(torch.Generator().manual_seed(0), cfg,
                              torch.bfloat16, "cpu")
        assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in
                got.items()} == {k: (v.shape, str(v.dtype)) for k, v in
                                 ref.items()}
