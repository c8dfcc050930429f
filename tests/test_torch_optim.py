"""The port's optimizers and gradient compression on their own, mirroring
tests/test_optim.py (AdamW against a hand-rolled oracle, the schedule,
clipping, bf16 moments, decoupled weight decay), tests/test_adafactor.py
(factored state, descent, momentum, the RMS clip) and
tests/test_compression.py (int8 round trip, error feedback); the cross-pod
int8 mean raises, naming its ROADMAP item. The parity with the JAX
package's updates is in tests/test_torch_train.py."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.optim import adafactor, adamw
from repro_torch.optim import compression as comp

from test_torch_train import one_thread  # noqa: F401


def _oracle_step(p, g, m, v, step, cfg):
    """Textbook AdamW with bias correction + decoupled weight decay."""
    g = np.asarray(g, np.float32)
    norm = np.sqrt((g ** 2).sum())
    g = g * min(1.0, cfg.grad_clip / (norm + 1e-9))
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g ** 2
    mhat = m / (1 - cfg.b1 ** step)
    vhat = v / (1 - cfg.b2 ** step)
    lr = float(adamw.schedule(step - 1, cfg))
    p = p - lr * (mhat / (np.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p)
    return p, m, v


def test_adamw_matches_oracle_over_steps(rng):
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    p0 = rng.standard_normal(12).astype(np.float32)
    params = {"w": torch.tensor(p0)}
    state = adamw.init_state(params, cfg)
    p_ref, m_ref, v_ref = p0.copy(), np.zeros(12), np.zeros(12)
    for step in range(1, 6):
        g = rng.standard_normal(12).astype(np.float32)
        params, state = adamw.apply_updates(params, {"w": torch.tensor(g)},
                                            state, cfg)
        p_ref, m_ref, v_ref = _oracle_step(p_ref, g, m_ref, v_ref, step, cfg)
        np.testing.assert_allclose(params["w"].numpy(), p_ref, rtol=1e-5,
                                   atol=1e-6)
    assert int(state.step) == 5 and state.step.dtype == torch.int32


def test_schedule_warmup_then_cosine():
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=110,
                            min_lr_frac=0.1)
    lrs = [float(adamw.schedule(torch.tensor(s, dtype=torch.int32), cfg))
           for s in range(110)]
    assert lrs[0] == pytest.approx(1e-4)
    assert lrs[9] == pytest.approx(1e-3)
    assert max(lrs) <= 1e-3 + 1e-9
    assert lrs[-1] == pytest.approx(1e-4, rel=0.1)
    assert all(a >= b - 1e-12 for a, b in zip(lrs[10:], lrs[11:]))
    assert adamw.schedule(3, cfg).dtype == torch.float32


def test_clip_by_global_norm():
    g = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0])}   # norm 5
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(5.0)
    assert float(adamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    clipped2, _ = adamw.clip_by_global_norm(g, 10.0)
    np.testing.assert_allclose(clipped2["a"].numpy(), g["a"].numpy(),
                               rtol=1e-6)


def test_bf16_moment_states():
    cfg = adamw.AdamWConfig(state_dtype=torch.bfloat16)
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    state = adamw.init_state(params, cfg)
    assert state.m["w"].dtype == torch.bfloat16
    new_p, new_s = adamw.apply_updates(
        params, {"w": torch.full((4,), 0.1, dtype=torch.bfloat16)}, state,
        cfg)
    assert new_s.m["w"].dtype == torch.bfloat16
    assert new_p["w"].dtype == torch.bfloat16
    assert torch.isfinite(new_p["w"].float()).all()


def test_weight_decay_decoupled():
    """With zero gradients, params shrink by exactly lr * wd * p."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=100,
                            weight_decay=0.5)
    params = {"w": torch.tensor([2.0])}
    state = adamw.init_state(params, cfg)
    new_p, _ = adamw.apply_updates(params, {"w": torch.tensor([0.0])},
                                   state, cfg)
    lr0 = float(adamw.schedule(0, cfg))
    assert float(new_p["w"][0]) == pytest.approx(2.0 - lr0 * 0.5 * 2.0,
                                                 rel=1e-5)
    assert float(params["w"][0]) == 2.0          # the input is left as is


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

def test_factored_state_is_small():
    params = {"w": torch.zeros((1024, 4096), dtype=torch.bfloat16)}
    cfg = adafactor.AdafactorConfig()
    assert adafactor.state_bytes(params, cfg) < 0.01 * (8 * 1024 * 4096)
    st_ = adafactor.init_state(params, cfg)
    assert st_.vr["w"].shape == (1024,)
    assert st_.vc["w"].shape == (4096,)


def test_small_params_not_factored():
    params = {"b": torch.zeros((64,)), "s": torch.zeros(())}
    st_ = adafactor.init_state(params, adafactor.AdafactorConfig())
    assert st_.vr["b"].shape == (64,)
    assert st_.vc["b"].shape == (1,)


def test_descends_quadratic(rng):
    """min ||W - A||^2 converges."""
    a = torch.tensor(rng.standard_normal((256, 256)), dtype=torch.float32)
    params = {"w": torch.zeros((256, 256))}
    cfg = adafactor.AdafactorConfig(lr=0.3)
    state = adafactor.init_state(params, cfg)

    def loss(p):
        return (p["w"] - a).square().mean()

    l0 = float(loss(params))
    for _ in range(60):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state = adafactor.apply_updates(params, {"w": g}, state, cfg)
    assert float(loss(params)) < 0.05 * l0
    assert int(state.step) == 60


def test_beta1_momentum_variant(rng):
    params = {"w": torch.tensor(rng.standard_normal((128, 128)),
                                dtype=torch.float32)}
    cfg = adafactor.AdafactorConfig(lr=0.1, beta1=0.9)
    state = adafactor.init_state(params, cfg)
    assert state.m["w"].shape == (128, 128)
    new_p, new_s = adafactor.apply_updates(
        params, {"w": torch.ones((128, 128))}, state, cfg)
    assert torch.isfinite(new_p["w"]).all()
    assert float(new_s.m["w"].abs().max()) > 0


def test_update_rms_clipped(rng):
    """Huge gradients produce bounded relative updates (clip_threshold)."""
    params = {"w": torch.ones((256, 256))}
    cfg = adafactor.AdafactorConfig(lr=1e-2, clip_threshold=1.0)
    state = adafactor.init_state(params, cfg)
    g = {"w": torch.tensor(rng.standard_normal((256, 256)) * 1e6,
                           dtype=torch.float32)}
    new_p, _ = adafactor.apply_updates(params, g, state, cfg)
    delta_rms = float((new_p["w"] - 1.0).square().mean().sqrt())
    assert delta_rms <= 1.05e-2


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_quantize_roundtrip_error_bounded(rng):
    g = torch.tensor(rng.standard_normal(256) * 3.0, dtype=torch.float32)
    c = comp.quantize(g)
    assert c.q.dtype == torch.int8 and c.scale.dtype == torch.float32
    err = (comp.dequantize(c) - g).abs().numpy()
    assert err.max() <= 0.5 * float(c.scale) + 1e-7


def test_quantize_zero_tensor():
    c = comp.quantize(torch.zeros(8))
    assert float(comp.dequantize(c).abs().max()) == 0.0


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), scale=st.floats(0.01, 100.0))
def test_error_feedback_accumulated_bias_vanishes(seed, scale):
    """sum_t dequant(q_t) == sum_t g_t - err_T: the residual never exceeds
    one quantization step."""
    rng = np.random.default_rng(seed)
    err = torch.zeros(32)
    total_sent = np.zeros(32)
    total_true = np.zeros(32)
    last_scale = 0.0
    for _ in range(20):
        g = torch.tensor(rng.standard_normal(32) * scale, dtype=torch.float32)
        c, err = comp.compress_with_feedback(g, err)
        total_sent += comp.dequantize(c).numpy()
        total_true += g.numpy()
        last_scale = max(last_scale, float(c.scale))
    residual = np.abs(total_true - total_sent)
    np.testing.assert_allclose(residual, err.abs().numpy(), rtol=1e-4,
                               atol=2e-4 * max(scale, 1.0))
    assert residual.max() <= 0.5 * last_scale + 1e-6


def test_init_error_state_matches_tree():
    params = {"a": torch.ones((3, 2), dtype=torch.bfloat16),
              "b": torch.ones(5)}
    errs = comp.init_error_state(params)
    assert errs["a"].shape == (3, 2) and errs["a"].dtype == torch.float32


def test_pod_mean_int8_is_the_dequantized_mean(rng):
    """Each pod's mean is the mean of the pods' dequantized payloads, in
    g's dtype on its pod's device; the new errors are each pod's
    compress_with_feedback residual. (Against the reference's shard_map:
    tests/test_torch_mesh.py.)"""
    gs = [torch.tensor(rng.standard_normal(16), dtype=torch.float32)
          for _ in range(3)]
    errs = [torch.tensor(rng.standard_normal(16) * 1e-3,
                         dtype=torch.float32) for _ in range(3)]
    means, new = comp.pod_mean_int8(gs, errs)
    packed = [comp.compress_with_feedback(g, e) for g, e in zip(gs, errs)]
    want = sum(comp.dequantize(c) for c, _ in packed) / 3
    for m in means:
        assert m.dtype == torch.float32
        torch.testing.assert_close(m, want, rtol=1e-6, atol=1e-7)
    for (_, e), n in zip(packed, new):
        assert torch.equal(e, n)
