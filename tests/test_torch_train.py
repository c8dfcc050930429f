"""Training parity of the port with the JAX package on the CPU, fp32: for
every architecture of ARCH_IDS at its smoke config (the MoE and hybrid
ones in tests/test_torch_train_moe.py) (`shrink`: d_model
128, two units), the loss (`transformer.forward`) and every gradient
leaf against `jax.value_and_grad(repro.models.transformer.forward)`, and
one `make_train_step` step at accum_steps 1 and 2 against the
reference's jitted step; then the pieces: `dense`'s mixed-precision
backward against `_dense_mm`'s VJP (fp32 and bf16), the scan's gradient
against `_selective_scan_fused`'s VJP (its Pallas kernel in interpret
mode), `mamba_block`'s parameter gradients under both, AdamW and
Adafactor updates on the same gradients, and a reference step continued
in the port.

The reference's MoE routes capacity-bounded in training, the port's too;
its Mamba layers run the chunked XLA scan (REPRO_PALLAS_SCAN unset), whose
gradient is the same function's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as ref_cfgs
from repro.launch import steps as ref_steps
from repro.models import layers as ref_layers
from repro.models import mamba as ref_ssm
from repro.models import transformer as ref_tf
from repro.optim import adafactor as ref_adafactor
from repro.optim import adamw as ref_adamw
from repro_torch import configs as pt_cfgs
from repro_torch.launch import steps as pt_steps
from repro_torch.models import layers as pt_layers
from repro_torch.models import mamba as pt_ssm
from repro_torch.models import transformer as pt_tf
from repro_torch.optim import adafactor as pt_adafactor
from repro_torch.optim import adamw as pt_adamw
from repro_torch.tree import tree_flatten_with_path

#: The MoE and hybrid archs run in tests/test_torch_train_moe.py, a file
#: of its own for the test workers (jamba's reference compiles longest).
MOE_ARCHS = ("jamba_v0_1_52b", "llama4_maverick_400b_a17b",
             "granite_moe_3b_a800m")
ARCHS = tuple(a for a in ref_cfgs.ARCH_IDS if a not in MOE_ARCHS)
#: The loss, fp32: the same ops summed in other orders (measured 0 to
#: 2.1e-7 relative over the ten archs).
TOL_LOSS = 1e-5
#: Each gradient leaf, relative Frobenius error: the backward sums over
#: the batch, sequence and units in other orders than XLA's (measured
#: 1.1e-6 to 8.4e-6, jamba the largest, whose 8-layer unit is deepest).
TOL_GRAD = 5e-5
#: AdamW / Adafactor on the same gradients: the same fp32 arithmetic,
#: elementwise, rounded in another order at most.
TOL_OPT = 1e-6
B, S = 4, 16
OPT = ref_adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
PT_OPT = pt_adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one intra-op thread for the module: at the smoke shapes
    one thread runs these tests as fast as eight, and more only contend
    with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v,
                          dtype=np.float32)
            for k, v in tree_flatten_with_path(tree)}


def _frob(got, want) -> float:
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def check_trees(got, want, tol, what):
    """Each leaf of `got` (port) within `tol` relative Frobenius of `want`
    (reference), the same keys; returns the worst error."""
    g, w = _flat(got), _flat(_np(want))
    assert set(g) == set(w), sorted(set(g) ^ set(w))
    for k in w:
        assert g[k].shape == w[k].shape, k
    errs = {k: _frob(g[k], w[k]) for k in w}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{what}: {worst} {errs[worst]:.3e} > {tol}"
    return errs[worst]


def batch_for(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    batch["labels"][0, :3] = -1                      # ignored positions
    if cfg.encoder is not None:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def reference():
    """Per arch, computed once: (cfg_r, cfg_p, ref params, port params,
    batch, the reference's (loss, grads), and its jitted train step's
    (params, state, metrics) at accum 1 and 2 from a fresh state)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg_r = ref_cfgs.get_smoke_config(arch)
            cfg_p = pt_cfgs.get_smoke_config(arch)
            ref = ref_tf.init_params(jax.random.key(0), cfg_r, jnp.float32)
            port = pt_tf.params_from_reference(_np(ref), device="cpu")
            batch = batch_for(cfg_r)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            vg = jax.jit(jax.value_and_grad(ref_tf.forward),
                         static_argnums=2)(ref, jb, cfg_r)
            steps = {}
            for accum in (1, 2):
                step = jax.jit(ref_steps.make_train_step(cfg_r, OPT, accum))
                steps[accum] = step(ref, ref_adamw.init_state(ref, OPT), jb)
            cache[arch] = (cfg_r, cfg_p, ref, port, batch, vg, steps)
        return cache[arch]

    return get


def check_loss_and_grads(reference, arch):
    _, cfg_p, _, port, batch, (loss_r, grads_r), _ = reference(arch)
    loss, grads = pt_steps.make_loss_and_grads(cfg_p)(port, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - float(loss_r)) <= TOL_LOSS * abs(float(loss_r))
    check_trees(grads, grads_r, TOL_GRAD, f"{arch} grads")
    for k, g in tree_flatten_with_path(grads):
        assert torch.isfinite(g).all(), k


def check_train_step(reference, arch, accum):
    """loss, grad_norm and lr of one step against the reference's jitted
    step, and the new moments (gradients in the state, no sign trap); the
    params are not compared tightly: AdamW's first update is about
    lr * sign(g), so a gradient near zero may move a weight by 2 lr."""
    _, cfg_p, _, port, batch, _, steps = reference(arch)
    p_r, st_r, m_r = steps[accum]
    step = pt_steps.make_train_step(cfg_p, PT_OPT, accum_steps=accum)
    state = pt_adamw.init_state(port, PT_OPT)
    params, st, metrics = step(port, state, batch)
    for key in ("loss", "grad_norm"):
        assert metrics[key].dtype == torch.float32
        assert abs(float(metrics[key]) - float(m_r[key])) <= \
            TOL_LOSS * abs(float(m_r[key])), key
    assert float(metrics["lr"]) == pytest.approx(float(m_r["lr"]), rel=1e-7)
    assert int(st.step) == int(st_r.step) == 1
    check_trees(st.m, st_r.m, TOL_GRAD, f"{arch} m")
    check_trees(st.v, st_r.v, 2 * TOL_GRAD, f"{arch} v")
    # the inputs are left as they were, the update moved every weight
    # matrix by at most lr (1 + weight decay) per element
    for k, p in tree_flatten_with_path(params):
        assert p.dtype == torch.float32 and torch.isfinite(p).all(), k
    old, new = _flat(port), _flat(params)
    assert max(np.abs(new[k] - old[k]).max() for k in old) <= 1.2e-3
    assert _flat(state.m)["embed"].max() == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(reference, arch):
    check_loss_and_grads(reference, arch)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(reference, arch, accum):
    check_train_step(reference, arch, accum)


# ---------------------------------------------------------------------------
# dense's backward and the scan's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_backward_matches_dense_mm_vjp(dtype):
    """dx in x's dtype, dw in w's (bf16 gradients for bf16 weights), the
    cotangent cast to w's dtype first; fp32 to 1e-6, bf16 to one rounding
    of the fp32-accumulated products (2^-8 of max |ref|)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (0.1 * rng.standard_normal((48, 40))).astype(np.float32)
    dy = rng.standard_normal((2, 5, 40)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y_r, vjp = jax.vjp(ref_layers._dense_mm, jnp.asarray(x, jd),
                       jnp.asarray(w, jd))
    dx_r, dw_r = vjp(jnp.asarray(dy, jd))
    xt = torch.tensor(x).to(td).requires_grad_()
    wt = torch.tensor(w).to(td).requires_grad_()
    y = pt_layers.dense(xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.tensor(dy).to(td))
    assert dx.dtype == td and dw.dtype == td
    assert str(dx_r.dtype) == dtype and str(dw_r.dtype) == dtype
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    for got, want in ((y, y_r), (dx, dx_r), (dw, dw_r)):
        assert _rel(got.detach().float(), np.asarray(want, np.float32)) \
            <= tol


@pytest.mark.parametrize("cotangents", ["y and h_last", "y only"])
def test_scan_gradient_matches_reference_vjp(monkeypatch, cotangents):
    """The scan Function's gradient against the reference's
    _selective_scan_fused VJP (its Pallas kernel forward in interpret
    mode, REPRO_PALLAS_SCAN=1; the chunked XLA scan's backward), every
    input's cotangent, at a length of three chunks; an unused h_last
    arrives as None and counts as zero."""
    monkeypatch.setenv("REPRO_PALLAS_SCAN", "1")
    rng = np.random.default_rng(5)
    bsz, length, d, n, chunk = 2, 48, 32, 8, 16
    dt = (0.001 + 0.1 * rng.random((bsz, length, d))).astype(np.float32)
    xs = rng.standard_normal((bsz, length, d)).astype(np.float32)
    bm = rng.standard_normal((bsz, length, n)).astype(np.float32)
    cm = rng.standard_normal((bsz, length, n)).astype(np.float32)
    a = -np.exp(rng.standard_normal((d, n))).astype(np.float32)
    dy = rng.standard_normal((bsz, length, d)).astype(np.float32)
    dh = (rng.standard_normal((bsz, d, n)).astype(np.float32)
          if cotangents == "y and h_last" else np.zeros((bsz, d, n),
                                                        np.float32))
    args = (dt, xs, bm, cm, a)
    (y_r, h_r), vjp = jax.vjp(
        lambda *t: ref_ssm._selective_scan_fused(*t, chunk),
        *map(jnp.asarray, args))
    grads_r = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    ts = [torch.tensor(t).requires_grad_() for t in args]
    y, h = pt_ssm._SelectiveScan.apply(*ts, chunk)
    outs, cots = [y], [torch.tensor(dy)]
    if cotangents == "y and h_last":
        outs.append(h)
        cots.append(torch.tensor(dh))
    grads = torch.autograd.grad(outs, ts, cots)
    assert _rel(y.detach(), y_r) <= 1e-5 and _rel(h.detach(), h_r) <= 1e-5
    for name, g, g_r in zip(("dt", "xs", "bmat", "cmat", "a_mat"), grads,
                            grads_r):
        assert _frob(g.numpy(), np.asarray(g_r)) <= TOL_GRAD, name


@pytest.mark.parametrize("pallas_scan", [False, True])
def test_mamba_block_parameter_gradients(monkeypatch, pallas_scan):
    """Every Mamba parameter's gradient against the reference's
    mamba_block under both of its scan paths: through the Cook-Toom plan
    (conv_w, whose taps the plan transforms on every call), dt_bias,
    a_log (through A = -exp(a_log)) and d_skip, each nonzero."""
    if pallas_scan:
        monkeypatch.setenv("REPRO_PALLAS_SCAN", "1")
    else:
        monkeypatch.delenv("REPRO_PALLAS_SCAN", raising=False)
    cfg_r = ref_cfgs.get_smoke_config("falcon_mamba_7b")
    cfg_p = pt_cfgs.get_smoke_config("falcon_mamba_7b")
    p = ref_ssm.init_mamba(jax.random.key(3), cfg_r, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, cfg_r.d_model)).astype(np.float32)
    dout = rng.standard_normal((2, 32, cfg_r.d_model)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, xx: ref_ssm.mamba_block(q, xx, cfg_r), p,
                     jnp.asarray(x))
    gp_r, gx_r = vjp(jnp.asarray(dout))
    pp = {k: v.requires_grad_() for k, v in pt_tf.params_from_reference(
        _np(p), device="cpu").items()}
    xt = torch.tensor(x).requires_grad_()
    out = pt_ssm.mamba_block(pp, xt, cfg_p)
    grads = torch.autograd.grad(out, [xt, *pp.values()], torch.tensor(dout))
    assert _frob(grads[0].numpy(), np.asarray(gx_r)) <= TOL_GRAD
    for (k, _), g in zip(pp.items(), grads[1:]):
        assert _frob(g.numpy(), np.asarray(gp_r[k])) <= TOL_GRAD, k
        if k != "conv_b":
            assert float(g.abs().max()) > 0, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_after_serving_in_one_process(monkeypatch, dtype):
    """A prefill under torch.inference_mode() first fills the executors'
    transform-matrix cache (core/winograd.py:_mat); the training step
    after it must not meet an inference tensor there (the full card
    script serves falcon at bf16 before it trains)."""
    from repro_torch.core import winograd as pt_winograd
    monkeypatch.setattr(pt_winograd, "_MATS", {})
    cfg = pt_cfgs.get_smoke_config("falcon_mamba_7b")
    params = pt_tf.init_params(torch.Generator().manual_seed(0), cfg,
                               getattr(torch, dtype), device="cpu")
    tok = torch.tensor(batch_for(cfg)["tokens"])
    pt_tf.prefill(params, tok, cfg, S + 4)
    assert pt_winograd._MATS
    loss, grads = pt_steps.make_loss_and_grads(cfg)(
        params, {"tokens": tok, "labels": tok})
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g.float()).all()
               for _, g in tree_flatten_with_path(grads))


# ---------------------------------------------------------------------------
# the optimizers on the same gradients, and a reference step continued
# ---------------------------------------------------------------------------

def _opt_tree(rng):
    return {"w": rng.standard_normal((160, 192)).astype(np.float32),
            "stack": rng.standard_normal((2, 130, 140)).astype(np.float32),
            "b": rng.standard_normal((64,)).astype(np.float32),
            "s": np.full((), 0.5, np.float32)}


def _tt(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def test_adamw_updates_match_on_the_same_gradients(rng):
    """Three steps fed the same gradients in both packages: the params,
    moments and step after each, through warmup into the cosine, with the
    clip active, and the reference's state carried over by
    opt_state_from_reference."""
    params = _opt_tree(rng)
    cfg_r = ref_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                                  grad_clip=5.0)
    cfg_p = pt_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                                 grad_clip=5.0)
    p_r = jax.tree.map(jnp.asarray, params)
    s_r = ref_adamw.init_state(p_r, cfg_r)
    p_p = _tt(params)
    s_p = pt_adamw.opt_state_from_reference(_np(s_r), device="cpu")
    assert s_p.step.dtype == torch.int32 and s_p.step.dim() == 0
    for _ in range(3):
        g = {k: np.asarray(0.3 * rng.standard_normal(np.shape(v)),
                           np.float32) for k, v in params.items()}
        p_r, s_r = ref_adamw.apply_updates(p_r, jax.tree.map(jnp.asarray, g),
                                           s_r, cfg_r)
        p_p, s_p = pt_adamw.apply_updates(p_p, _tt(g), s_p, cfg_p)
        assert int(s_p.step) == int(s_r.step)
        for got, want in ((p_p, p_r), (s_p.m, s_r.m), (s_p.v, s_r.v)):
            check_trees(got, want, TOL_OPT, "adamw")
    assert float(pt_adamw.global_norm(_tt(g))) == pytest.approx(
        float(ref_adamw.global_norm(g)), rel=1e-6)


@pytest.mark.parametrize("beta1", [None, 0.9])
def test_adafactor_updates_match_on_the_same_gradients(rng, beta1):
    """Factored (w, stack) and unfactored (b, s) leaves, with and without
    the first moment, the RMS clip reached by one large gradient."""
    params = _opt_tree(rng)
    cfg_r = ref_adafactor.AdafactorConfig(lr=1e-2, beta1=beta1,
                                          weight_decay=0.01)
    cfg_p = pt_adafactor.AdafactorConfig(lr=1e-2, beta1=beta1,
                                         weight_decay=0.01)
    p_r = jax.tree.map(jnp.asarray, params)
    s_r = ref_adafactor.init_state(p_r, cfg_r)
    p_p = _tt(params)
    s_p = pt_adafactor.init_state(p_p, cfg_p)
    check_trees(s_p.vr, s_r.vr, 0, "vr")
    check_trees(s_p.vc, s_r.vc, 0, "vc")
    for scale in (0.3, 1e4, 0.3):
        g = {k: np.asarray(scale * rng.standard_normal(np.shape(v)),
                           np.float32) for k, v in params.items()}
        p_r, s_r = ref_adafactor.apply_updates(
            p_r, jax.tree.map(jnp.asarray, g), s_r, cfg_r)
        p_p, s_p = pt_adafactor.apply_updates(p_p, _tt(g), s_p, cfg_p)
        for got, want in ((p_p, p_r), (s_p.vr, s_r.vr), (s_p.vc, s_r.vc),
                          (s_p.m, s_r.m)):
            check_trees(got, want, TOL_OPT, "adafactor")
    assert pt_adafactor.state_bytes(p_p, cfg_p) == \
        ref_adafactor.state_bytes(p_r, cfg_r)


def test_reference_step_continues_in_the_port(reference):
    """The reference's first jitted step on falcon-mamba-7b, its params
    and AdamW state carried over (params_from_reference,
    opt_state_from_reference): the port's second step reads the
    reference's second step's loss, grad_norm and lr."""
    cfg_r, cfg_p, _, _, batch, _, steps = reference("falcon_mamba_7b")
    p1, s1, _ = steps[1]
    batch2 = batch_for(cfg_r, seed=7)
    _, s2_r, m2_r = jax.jit(ref_steps.make_train_step(cfg_r, OPT, 1))(
        p1, s1, {k: jnp.asarray(v) for k, v in batch2.items()})
    params = pt_tf.params_from_reference(_np(p1), device="cpu")
    state = pt_adamw.opt_state_from_reference(_np(s1), device="cpu")
    _, s2, m2 = pt_steps.make_train_step(cfg_p, PT_OPT)(params, state,
                                                        batch2)
    assert int(s2.step) == 2
    for key in ("loss", "grad_norm", "lr"):
        assert float(m2[key]) == pytest.approx(float(m2_r[key]),
                                               rel=TOL_LOSS), key
    check_trees(s2.v, s2_r.v, 2 * TOL_GRAD, "v after two steps")
