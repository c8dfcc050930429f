"""Parity of the port's falcon-mamba-7b inference slice with the JAX
package, on the smoke config (`shrink`: 2 layers, d_model 128, d_inner
256, d_state 8, vocab 512): `mamba_block` (with and without its decode
state) against the reference under both of its scan paths, the recurrent
`mamba_decode_step`, and `prefill` + `decode_step` and `forward_logits`
through the step factories, with the reference's weights carried over by
`params_from_reference`; then the port's own prefill-then-decode
invariant, its configs and its init.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_cfgs
from repro.launch import steps as ref_steps
from repro.models import mamba as ref_ssm
from repro.models import transformer as ref_tf
from repro_torch import configs as pt_cfgs
from repro_torch.launch import steps as pt_steps
from repro_torch.models import mamba as pt_ssm
from repro_torch.models import transformer as pt_tf

#: fp32: the same ops in the same dtypes, the scan chunked as in the
#: reference but its prefix taken in another order: 1e-5 of max |ref|.
TOL = 1e-5
#: bf16 params, prefill and forward_logits: the same bf16 roundings on
#: both sides (measured 0 and 8e-8 of max |ref|); the margin covers a
#: rounding that lands on a bf16 boundary once.
TOL_BF16 = 1e-4
#: bf16 params, decode: XLA keeps the decode step's fused bf16
#: intermediates in fp32 inside the compiled scan body
#: (--xla_allow_excess_precision, on by default), where the port rounds
#: each op to bf16 as the reference's source says; measured 0.6-1.4 % of
#: max |ref| on the logits (2e-7 with the flag off).
TOL_BF16_DECODE = 3e-2
PROMPT, EXTRA = 8, 4


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def cfgs():
    return (ref_cfgs.get_smoke_config("falcon_mamba_7b"),
            pt_cfgs.get_smoke_config("falcon_mamba_7b"))


@pytest.fixture(scope="module")
def models(cfgs):
    """(reference params, port params) per dtype, the same weights."""
    out = {}
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        params = ref_tf.init_params(jax.random.key(0), cfgs[0], dt)
        out[name] = (params, pt_tf.params_from_reference(_np(params),
                                                         device="cpu"))
    return out


@pytest.fixture(scope="module")
def tokens(cfgs):
    rng = np.random.default_rng(1)
    return rng.integers(0, cfgs[0].vocab, (2, PROMPT + EXTRA)).astype(
        np.int32)


def test_config_is_the_reference_config():
    for get in ("get_config", "get_smoke_config"):
        ref = getattr(ref_cfgs, get)("falcon-mamba-7b")
        port = getattr(pt_cfgs, get)("falcon-mamba-7b")
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params == ref.n_params
    assert pt_cfgs.ARCH_IDS == ref_cfgs.ARCH_IDS
    assert pt_cfgs.SHAPES == ref_cfgs.SHAPES
    assert pt_cfgs.canonical("falcon-mamba-7b") == "falcon_mamba_7b"


def test_training_loss_raises(cfgs, models, tokens):
    """The training loss (the reference's transformer.forward), which
    raised until training was ported, now runs: at fp32 and bf16 it equals
    the reference's on the same weights and tokens (the gradients and the
    train step: tests/test_torch_train.py)."""
    for dtype, tol in (("float32", TOL), ("bfloat16", TOL_BF16)):
        ref, port = models[dtype]
        want = ref_tf.forward(ref, {"tokens": jnp.asarray(tokens[:, :-1]),
                                    "labels": jnp.asarray(tokens[:, 1:])},
                              cfgs[0])
        got = pt_tf.forward(port, {"tokens": torch.tensor(tokens[:, :-1]),
                                   "labels": torch.tensor(tokens[:, 1:])},
                            cfgs[1])
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= tol * abs(float(want)), dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_reference(cfgs, dtype):
    """The same keys, shapes and dtypes as the reference's tree, blocks
    stacked over units; the truncated normals stay within 2 scales."""
    ref = ref_tf.init_params(jax.random.key(0), cfgs[0],
                             getattr(jnp, dtype))
    port = pt_tf.init_params(torch.Generator().manual_seed(0), cfgs[1],
                             getattr(torch, dtype), device="cpu")
    ref_leaves = {jax.tree_util.keystr(k): v for k, v in
                  jax.tree_util.tree_leaves_with_path(ref)}
    port_leaves = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + f"['{k}']")
            else:
                port_leaves[path + f"['{k}']"] = v
    walk(port, "")
    assert set(port_leaves) == set(ref_leaves)
    for k, v in port_leaves.items():
        assert tuple(v.shape) == ref_leaves[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == \
            str(ref_leaves[k].dtype), k
    d = cfgs[1].d_model
    assert float(port["embed"].float().abs().max()) <= 2 * d ** -0.5
    assert _rel(port["blocks"]["layer_0"]["mamba"]["a_log"].numpy(),
                ref["blocks"]["layer_0"]["mamba"]["a_log"]) <= 1e-6
    assert sum(v.numel() for v in port_leaves.values()) == \
        sum(v.size for v in ref_leaves.values())


@pytest.mark.parametrize("pallas_scan", [False, True])
@pytest.mark.parametrize("return_state", [False, True])
def test_mamba_block_matches_reference(cfgs, monkeypatch, pallas_scan,
                                       return_state):
    """Both reference scan paths: the chunked XLA scan and, with
    REPRO_PALLAS_SCAN=1, its Pallas kernel in interpret mode."""
    if pallas_scan:
        monkeypatch.setenv("REPRO_PALLAS_SCAN", "1")
    else:
        monkeypatch.delenv("REPRO_PALLAS_SCAN", raising=False)
    assert ref_ssm._use_pallas_scan() == pallas_scan
    cfg_r, cfg_p = cfgs
    p = ref_ssm.init_mamba(jax.random.key(3), cfg_r, jnp.float32)
    x = np.random.default_rng(4).standard_normal(
        (2, 40, cfg_r.d_model)).astype(np.float32)
    want = ref_ssm.mamba_block(p, jnp.asarray(x), cfg_r,
                               return_state=return_state)
    pp = pt_tf.params_from_reference(_np(p), device="cpu")
    got = pt_ssm.mamba_block(pp, torch.tensor(x), cfg_p,
                             return_state=return_state)
    if not return_state:
        assert _rel(got.numpy(), want) <= TOL
        return
    assert _rel(got[0].numpy(), want[0]) <= TOL
    for k in ("conv", "ssm"):
        assert tuple(got[1][k].shape) == want[1][k].shape
        assert _rel(got[1][k].numpy(), want[1][k]) <= TOL


@pytest.mark.parametrize("length", [1, 2, 5])
def test_mamba_block_short_prompt_state(cfgs, length):
    """A prompt shorter than the conv window pads the conv cache."""
    cfg_r, cfg_p = cfgs
    p = ref_ssm.init_mamba(jax.random.key(5), cfg_r, jnp.float32)
    x = np.random.default_rng(length).standard_normal(
        (1, length, cfg_r.d_model)).astype(np.float32)
    want = ref_ssm.mamba_block(p, jnp.asarray(x), cfg_r, return_state=True)
    got = pt_ssm.mamba_block(pt_tf.params_from_reference(_np(p),
                                                         device="cpu"),
                             torch.tensor(x), cfg_p, return_state=True)
    assert _rel(got[0].numpy(), want[0]) <= TOL
    assert _rel(got[1]["conv"].numpy(), want[1]["conv"]) <= TOL
    assert _rel(got[1]["ssm"].numpy(), want[1]["ssm"]) <= TOL


def test_mamba_decode_step_matches_reference(cfgs):
    cfg_r, cfg_p = cfgs
    p = ref_ssm.init_mamba(jax.random.key(6), cfg_r, jnp.float32)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 1, cfg_r.d_model)).astype(np.float32)
    cache = {"conv": rng.standard_normal((3, 3, 256)).astype(np.float32),
             "ssm": rng.standard_normal((3, 256, 8)).astype(np.float32)}
    want, want_c = ref_ssm.mamba_decode_step(
        p, jnp.asarray(x), jax.tree.map(jnp.asarray, cache), cfg_r)
    got, got_c = pt_ssm.mamba_decode_step(
        pt_tf.params_from_reference(_np(p), device="cpu"), torch.tensor(x),
        {k: torch.tensor(v) for k, v in cache.items()}, cfg_p)
    assert _rel(got.numpy(), want) <= TOL
    for k in ("conv", "ssm"):
        assert _rel(got_c[k].numpy(), want_c[k]) <= TOL
    empty = pt_ssm.init_mamba_cache(cfg_p, 3, torch.float32, "cpu")
    ref_empty = ref_ssm.init_mamba_cache(cfg_r, 3, jnp.float32)
    for k in ("conv", "ssm"):
        assert tuple(empty[k].shape) == ref_empty[k].shape
        assert not empty[k].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_matches_reference(cfgs, models, tokens, dtype):
    ref_params, params = models[dtype]
    want = ref_tf.forward_logits(ref_params, jnp.asarray(tokens), cfgs[0])
    got = pt_tf.forward_logits(params, torch.tensor(tokens).long(), cfgs[1])
    assert got.dtype == torch.float32
    assert got.shape == (2, PROMPT + EXTRA, cfgs[1].vocab)
    assert _rel(got.numpy(), want) <= (TOL if dtype == "float32"
                                       else TOL_BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(cfgs, models, tokens, dtype):
    """make_prefill_step on the prompt, then make_serve_step teacher-forced
    on the next tokens, each against the reference's step."""
    cfg_r, cfg_p = cfgs
    ref_params, params = models[dtype]
    max_len = PROMPT + EXTRA
    want, ref_cache = ref_steps.make_prefill_step(cfg_r, max_len)(
        ref_params, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    got, cache = pt_steps.make_prefill_step(cfg_p, max_len)(
        params, {"tokens": torch.tensor(tokens[:, :PROMPT]).long()})
    tol = TOL if dtype == "float32" else TOL_BF16
    assert _rel(got.numpy(), want) <= tol
    for k in ("conv", "ssm"):
        assert tuple(cache["layer_0"][k].shape) == \
            ref_cache["layer_0"][k].shape
        assert cache["layer_0"][k].dtype == getattr(
            torch, str(ref_cache["layer_0"][k].dtype))
        assert _rel(cache["layer_0"][k].float().numpy(),
                    np.asarray(ref_cache["layer_0"][k], np.float32)) <= tol
    ref_serve = ref_steps.make_serve_step(cfg_r)
    serve = pt_steps.make_serve_step(cfg_p)
    tol = TOL if dtype == "float32" else TOL_BF16_DECODE
    for i in range(EXTRA):
        pos = PROMPT + i
        want, ref_cache = ref_serve(ref_params, ref_cache,
                                    jnp.asarray(tokens[:, pos:pos + 1]),
                                    jnp.asarray(pos, jnp.int32))
        got, cache = serve(params, cache,
                           torch.tensor(tokens[:, pos:pos + 1]).long(), pos)
        assert got.shape == (2, cfg_p.vocab)
        assert _rel(got.numpy(), want) <= tol


#: The port's own invariant at bf16 params: the decode step rounds in
#: another order than the chunked forward (a direct conv sum, one scan
#: step), which bf16 makes visible: measured 1.4-2.9 % of max |logit| for
#: the port and 1.4-2.8 % for the reference on the same weights (the
#: reference tests its invariant at fp32 only, tests/test_archs.py).
TOL_BF16_INVARIANT = 5e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_forward(cfgs, models, tokens, dtype):
    """Prefill then teacher-forced decode reproduce forward_logits (fp32:
    the same arithmetic in other orders, measured ~7e-7)."""
    cfg = cfgs[1]
    params = models[dtype][1]
    toks = torch.tensor(tokens).long()
    full = pt_tf.forward_logits(params, toks, cfg).numpy()
    logits, cache = pt_tf.prefill(params, toks[:, :PROMPT], cfg,
                                  PROMPT + EXTRA)
    steps = [logits]
    for i in range(EXTRA):
        logits, cache = pt_tf.decode_step(
            params, cache, toks[:, PROMPT + i:PROMPT + i + 1], PROMPT + i,
            cfg)
        steps.append(logits)
    tol = TOL if dtype == "float32" else TOL_BF16_INVARIANT
    for j, got in enumerate(steps):
        assert _rel(got.numpy(), full[:, PROMPT - 1 + j]) <= tol


def test_decode_from_empty_cache_matches_forward(cfgs, models, tokens):
    """init_decode_cache + decode steps from position 0 reproduce the
    forward's logits at fp32."""
    cfg = cfgs[1]
    params = models["float32"][1]
    toks = torch.tensor(tokens[:, :4]).long()
    full = pt_tf.forward_logits(params, toks, cfg).numpy()
    cache = pt_tf.init_decode_cache(cfg, 2, 4, torch.float32, device="cpu")
    ref_cache = ref_tf.init_decode_cache(cfgs[0], 2, 4, jnp.float32)
    assert set(cache) == set(ref_cache)
    assert tuple(cache["layer_0"]["ssm"].shape) == \
        ref_cache["layer_0"]["ssm"].shape
    for t in range(4):
        logits, cache = pt_tf.decode_step(params, cache, toks[:, t:t + 1], t,
                                          cfg)
        assert _rel(logits.numpy(), full[:, t]) <= TOL


def test_params_from_reference_keeps_dtypes(models):
    ref_params, params = models["bfloat16"]
    assert params["embed"].dtype == torch.bfloat16
    assert params["blocks"]["layer_0"]["mamba"]["a_log"].dtype == \
        torch.float32
    assert torch.equal(params["embed"].float(),
                       _t(np.asarray(ref_params["embed"], np.float32)))
