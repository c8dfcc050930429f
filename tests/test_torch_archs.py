"""Every architecture of ARCH_IDS in the port against the JAX package, at
its smoke config (`shrink`: d_model 128, two units): the configs and
cells, the parameter tree, forward_logits, prefill (dropless and the
capacity-bounded bulk step) and teacher-forced decode_step against the
reference's on the reference's weights, and the port's own
prefill-then-decode invariant. whisper-tiny runs its encoder on random
frames; the reference's Mamba layers run its chunked XLA scan, as in
tests/test_torch_mamba.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_cfgs
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_tf
from repro_torch import configs as pt_cfgs
from repro_torch.launch import steps as pt_steps
from repro_torch.models import transformer as pt_tf

ARCHS = ref_cfgs.ARCH_IDS
MOE_ARCHS = [a for a in ARCHS if ref_cfgs.get_config(a).moe is not None]
#: fp32: the same ops in the same dtypes, summed in other orders: 1e-5 of
#: max |ref|.
TOL = 1e-5
B, PROMPT, EXTRA = 2, 8, 4


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _leaves(tree, path=""):
    """{path: leaf} of a nested dict (the reference's and the port's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{path}/{k}"))
        else:
            out[f"{path}/{k}"] = v
    return out


@pytest.fixture(scope="module")
def smoke():
    """(cfgs, ref params, port params, tokens, frames) per arch, fp32, the
    same weights on both sides."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg_r = ref_cfgs.get_smoke_config(arch)
            cfg_p = pt_cfgs.get_smoke_config(arch)
            ref = ref_tf.init_params(jax.random.key(0), cfg_r, jnp.float32)
            port = pt_tf.params_from_reference(jax.tree.map(np.asarray, ref),
                                               device="cpu")
            rng = np.random.default_rng(1)
            toks = rng.integers(0, cfg_r.vocab,
                                (B, PROMPT + EXTRA)).astype(np.int32)
            frames = (rng.standard_normal(
                (B, cfg_r.encoder.n_ctx, cfg_r.d_model)).astype(np.float32)
                if cfg_r.encoder else None)
            cache[arch] = ((cfg_r, cfg_p), ref, port, toks, frames)
        return cache[arch]

    return get


def _frames(frames, lib):
    if frames is None:
        return None
    return jnp.asarray(frames) if lib == "jax" else torch.tensor(frames)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        ref = getattr(ref_cfgs, get)(arch)
        port = getattr(pt_cfgs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.n_params == ref.n_params
        assert port.n_active_params == ref.n_active_params
    assert pt_cfgs.get_config(arch.replace("_", "-")) == \
        pt_cfgs.get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_equal_the_reference(arch):
    assert pt_cfgs.cells(arch) == ref_cfgs.cells(arch)


def test_registry_equals_the_reference():
    assert pt_cfgs.ARCH_IDS == ref_cfgs.ARCH_IDS
    assert pt_cfgs.SHAPES == ref_cfgs.SHAPES
    assert not hasattr(pt_cfgs, "PORTED")
    with pytest.raises(ValueError, match="unknown architecture"):
        pt_cfgs.get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """The same keys, shapes and dtypes as the reference's tree (bf16, the
    router and the Mamba leaves the reference keeps in fp32)."""
    cfg = pt_cfgs.get_smoke_config(arch)
    ref = ref_tf.init_params(jax.random.key(0), ref_cfgs.get_smoke_config(
        arch), jnp.bfloat16)
    port = pt_tf.init_params(torch.Generator().manual_seed(0), cfg,
                             torch.bfloat16, device="cpu")
    ref_l, port_l = _leaves(ref), _leaves(port)
    assert set(port_l) == set(ref_l)
    for k, v in port_l.items():
        assert tuple(v.shape) == ref_l[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(ref_l[k].dtype), k
        assert torch.isfinite(v.float()).all(), k


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "whisper_tiny",
                                  "falcon_mamba_7b"])
def test_init_params_draws_layer_by_layer(arch):
    """Two draws from equal generators give equal trees, and the layer-by-
    layer draw into the preallocated stack equals stacking each unit's
    layers drawn in the same order (the unit-wise draw it replaced)."""
    cfg = pt_cfgs.get_smoke_config(arch)
    a = pt_tf.init_params(torch.Generator().manual_seed(3), cfg,
                          torch.float32, device="cpu")
    b = pt_tf.init_params(torch.Generator().manual_seed(3), cfg,
                          torch.float32, device="cpu")
    la, lb = _leaves(a), _leaves(b)
    assert all(torch.equal(la[k], lb[k]) for k in la)
    gen = torch.Generator().manual_seed(3)
    pt_tf.truncated_normal_init(gen, (cfg.vocab, cfg.d_model), 1.0)
    units = [{f"layer_{i}": pt_tf._init_layer(gen, cfg, i, torch.float32,
                                              "cpu")
              for i in range(cfg.scan_unit)} for _ in range(cfg.n_units)]
    stacked = _leaves(pt_tf._stack(units))
    for k, v in stacked.items():
        assert torch.equal(la[f"/blocks{k}"], v), k


#: sha256 of the smoke falcon-mamba-7b tree (fp32, CPU generator seeded 3;
#: each leaf's path, shape and bytes in sorted path order) as the
#: unit-wise init_params drew it, before the layer-by-layer draw replaced
#: it. It holds for this torch CPU generator's stream.
FALCON_SMOKE_TREE_SHA256 = ("91025310833922b07931c041391c9a55"
                            "c743259d55a8790c65439ba452a65452")


def test_init_params_equals_the_unit_wise_draw():
    """The layer-by-layer draw gives, bit for bit, the falcon tree that the
    unit-wise draw it replaced gave."""
    import hashlib
    cfg = pt_cfgs.get_smoke_config("falcon_mamba_7b")
    tree = _leaves(pt_tf.init_params(torch.Generator().manual_seed(3), cfg,
                                     torch.float32, device="cpu"))
    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(k.encode())
        h.update(str(tuple(tree[k].shape)).encode())
        h.update(tree[k].contiguous().numpy().tobytes())
    assert h.hexdigest() == FALCON_SMOKE_TREE_SHA256


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_matches_reference(smoke, arch):
    (cfg_r, cfg_p), ref, port, toks, frames = smoke(arch)
    want = ref_tf.forward_logits(ref, jnp.asarray(toks), cfg_r,
                                 frames=_frames(frames, "jax"))
    got = pt_tf.forward_logits(port, torch.tensor(toks).long(), cfg_p,
                               frames=_frames(frames, "torch"))
    assert got.dtype == torch.float32
    assert got.shape == (B, PROMPT + EXTRA, cfg_p.vocab)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(smoke, arch):
    """prefill (dropless, the serving path) on the prompt, then the serve
    step teacher-forced on the next tokens, each against the reference's,
    logits and caches; and every step against the port's own
    forward_logits on the whole sequence."""
    (cfg_r, cfg_p), ref, port, toks, frames = smoke(arch)
    max_len = PROMPT + EXTRA
    want, ref_cache = ref_tf.prefill(ref, jnp.asarray(toks[:, :PROMPT]),
                                     cfg_r, max_len,
                                     frames=_frames(frames, "jax"))
    got, cache = pt_tf.prefill(port, torch.tensor(toks[:, :PROMPT]).long(),
                               cfg_p, max_len,
                               frames=_frames(frames, "torch"))
    full = pt_tf.forward_logits(port, torch.tensor(toks).long(), cfg_p,
                                frames=_frames(frames, "torch")).numpy()
    assert _rel(got.numpy(), want) <= TOL
    assert _rel(got.numpy(), full[:, PROMPT - 1]) <= TOL
    ref_l, port_l = _leaves(ref_cache), _leaves(cache)
    assert set(port_l) == set(ref_l)
    for k, v in port_l.items():
        assert tuple(v.shape) == ref_l[k].shape, k
        assert _rel(v.numpy(), ref_l[k]) <= TOL, k
    ref_serve = jax.jit(ref_steps.make_serve_step(cfg_r))
    serve = pt_steps.make_serve_step(cfg_p)
    for i in range(EXTRA):
        pos = PROMPT + i
        want, ref_cache = ref_serve(ref, ref_cache,
                                    jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.asarray(pos, jnp.int32))
        got, cache = serve(port, cache, torch.tensor(
            toks[:, pos:pos + 1]).long(), pos)
        assert got.shape == (B, cfg_p.vocab)
        assert _rel(got.numpy(), want) <= TOL
        assert _rel(got.numpy(), full[:, pos]) <= TOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bulk_prefill_step_matches_reference(smoke, arch):
    """make_prefill_step routes capacity-bounded (dropless=False), as the
    reference's: 16 tokens over 8 experts at capacity 4 drop some, and the
    logits agree with the reference's step, not with the dropless
    prefill."""
    (cfg_r, cfg_p), ref, port, toks, _ = smoke(arch)
    max_len = PROMPT + EXTRA
    want, _ = ref_steps.make_prefill_step(cfg_r, max_len)(
        ref, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    got, _ = pt_steps.make_prefill_step(cfg_p, max_len)(
        port, {"tokens": torch.tensor(toks[:, :PROMPT]).long()})
    dropless, _ = pt_tf.prefill(port, torch.tensor(toks[:, :PROMPT]).long(),
                                cfg_p, max_len)
    assert _rel(got.numpy(), want) <= TOL
    assert _rel(got.numpy(), dropless.numpy()) > 1e-3


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "jamba_v0_1_52b",
                                  "whisper_tiny"])
def test_decode_from_empty_cache_matches_forward(smoke, arch):
    """init_decode_cache (its tree the reference's) + decode steps from
    position 0 reproduce forward_logits; an encoder-decoder's cross K / V
    come from a one-token prefill."""
    (cfg_r, cfg_p), _, port, toks, frames = smoke(arch)
    t = torch.tensor(toks[:, :5]).long()
    fr = _frames(frames, "torch")
    full = pt_tf.forward_logits(port, t, cfg_p, frames=fr).numpy()
    cache = pt_tf.init_decode_cache(cfg_p, B, 5, torch.float32, device="cpu")
    ref_l = _leaves(ref_tf.init_decode_cache(cfg_r, B, 5, jnp.float32))
    port_l = _leaves(cache)
    assert {k: tuple(v.shape) for k, v in port_l.items()} == \
        {k: v.shape for k, v in ref_l.items()}
    start = 0
    if cfg_p.encoder is not None:
        logits, cache = pt_tf.prefill(port, t[:, :1], cfg_p, 5, frames=fr)
        assert _rel(logits.numpy(), full[:, 0]) <= TOL
        start = 1
    for pos in range(start, 5):
        logits, cache = pt_tf.decode_step(port, cache, t[:, pos:pos + 1],
                                          pos, cfg_p)
        assert _rel(logits.numpy(), full[:, pos]) <= TOL


def test_encoder_needs_frames(smoke):
    (_, cfg_p), _, port, toks, _ = smoke("whisper_tiny")
    with pytest.raises(ValueError, match="frames="):
        pt_tf.forward_logits(port, torch.tensor(toks).long(), cfg_p)
    with pytest.raises(ValueError, match="does not fit"):
        pt_tf.prefill(port, torch.tensor(toks).long(), cfg_p, 4,
                      frames=torch.zeros(B, 16, cfg_p.d_model))
