"""The Whisper conv stem on the port (models/audio.py): the JAX package's
tests/test_audio_stem.py against a direct float64 F.conv1d oracle, and the
stem against the reference's on the same weights (carried over with
params_from_reference) under every algorithm, compiled and per call, with
the compiled networks' describe() tables equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as ref_cfgs
from repro.core import compile as ref_compile
from repro.models import audio as ref_audio
from repro_torch import configs as pt_cfgs
from repro_torch.core import compile as pt_compile
from repro_torch.core import plan as pt_plan
from repro_torch.models import audio as pt_audio

#: Against the direct oracle: the reference's own limit
#: (tests/test_audio_stem.py).
TOL_DIRECT = 1e-4
#: Against the reference on the same weights: both run the same fp32
#: Cook-Toom transforms and GEMMs, summed in other orders, then GELU.
TOL = 1e-5

ALGORITHMS = ("auto", "winograd", "im2col", "pallas_winograd")


@pytest.fixture(autouse=True)
def _fresh_port_cache():
    pt_plan.clear_plan_cache()
    yield
    pt_plan.clear_plan_cache()


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _direct_stem(params, mel):
    """Both convs through F.conv1d in float64 with the SAME pads, bias and
    GELU (tanh)."""
    def conv(x, w, stride):
        t, k = x.shape[1], w.shape[0]
        out = -(-t // stride)
        total = max((out - 1) * stride + k - t, 0)
        xc = F.pad(x.double().transpose(1, 2), (total // 2,
                                                total - total // 2))
        return F.conv1d(xc, w.double().permute(2, 1, 0),
                        stride=stride).transpose(1, 2)

    x = F.gelu(conv(mel, params["conv1_w"], 1) + params["conv1_b"].double(),
               approximate="tanh")
    return F.gelu(conv(x, params["conv2_w"], 2) + params["conv2_b"].double(),
                  approximate="tanh")


def _smoke_params(seed, n_mels):
    cfg = pt_cfgs.get_smoke_config("whisper_tiny")
    params = pt_audio.init_stem(torch.Generator().manual_seed(seed), cfg,
                                n_mels=n_mels, device="cpu")
    # non-zero biases, so the epilogue is checked too
    g = torch.Generator().manual_seed(seed + 1)
    for k in ("conv1_b", "conv2_b"):
        params[k] = torch.randn(params[k].shape, generator=g)
    return cfg, params


@pytest.mark.parametrize("algorithm", ["auto", "im2col"])
def test_stem_matches_direct(rng, algorithm):
    cfg, params = _smoke_params(0, 16)
    mel = torch.from_numpy(rng.standard_normal((2, 32, 16)).astype(
        np.float32))
    got = pt_audio.stem(params, mel, algorithm=algorithm)
    assert got.shape == (2, 16, cfg.d_model)
    assert _rel(got, _direct_stem(params, mel)) < TOL_DIRECT


def test_stem_planned_matches_direct(rng):
    """plan_stem builds both conv plans once (the stride-2 one polyphase);
    stem(plans=...) matches the direct oracle with no per-call
    transform."""
    cfg, params = _smoke_params(0, 16)
    mel = torch.from_numpy(rng.standard_normal((2, 32, 16)).astype(
        np.float32))
    pt_compile._DEPRECATION_WARNED.discard("models.audio.plan_stem")
    with pytest.warns(DeprecationWarning, match="plan_stem"):
        plans = pt_audio.plan_stem(params, tuple(mel.shape), device="cpu")
    assert plans["conv2"].describe()["executor"] == \
        "polyphase[winograd_1d+im2col]"
    got = pt_audio.stem(params, mel, plans=plans)
    assert got.shape == (2, 16, cfg.d_model)
    assert _rel(got, _direct_stem(params, mel)) < TOL_DIRECT


def test_stem_halves_time_axis(rng):
    _, params = _smoke_params(1, 8)
    for t in (20, 33):
        mel = torch.from_numpy(rng.standard_normal((1, t, 8)).astype(
            np.float32))
        assert pt_audio.stem(params, mel).shape[1] == -(-t // 2)


def _carried(n_mels=16, seed=0):
    """The reference's init_stem on the smoke config, with non-zero
    biases, as numpy; the same arrays as the port's params."""
    cfg = ref_cfgs.get_smoke_config("whisper_tiny")
    params = ref_audio.init_stem(jax.random.key(seed), cfg, n_mels=n_mels)
    params_np = {k: np.asarray(v) for k, v in params.items()}
    rng = np.random.default_rng(seed + 5)
    for k in ("conv1_b", "conv2_b"):
        params_np[k] = rng.standard_normal(params_np[k].shape).astype(
            np.float32)
    return cfg, params_np


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("length", [20, 33])
def test_stem_matches_reference(length, algorithm):
    """The compiled stem and the per-call stem against the reference's on
    the same weights; the describe() tables equal."""
    cfg, params_np = _carried()
    shape = (2, length, 16)
    mel = np.random.default_rng(length).standard_normal(shape).astype(
        np.float32)
    ref_params = {k: jnp.asarray(v) for k, v in params_np.items()}
    pt_params = pt_audio.params_from_reference(params_np, device="cpu")
    ref_net = ref_compile.compile(ref_params,
                                  ref_audio.stem_graph(cfg.d_model),
                                  input_shape=shape, algorithm=algorithm)
    pt_net = pt_compile.compile(pt_params, pt_audio.stem_graph(cfg.d_model),
                                input_shape=shape, algorithm=algorithm,
                                device="cpu")
    assert pt_net.describe() == ref_net.describe()
    want = np.asarray(ref_net.apply(jnp.asarray(mel)))
    x = torch.from_numpy(mel)
    got = pt_net.apply(x)
    assert tuple(got.shape) == want.shape == (2, -(-length // 2),
                                              cfg.d_model)
    assert _rel(got, want) < TOL
    per_call = pt_audio.stem(pt_params, x, algorithm=algorithm)
    want_per_call = np.asarray(ref_audio.stem(ref_params, jnp.asarray(mel),
                                              algorithm=algorithm))
    assert _rel(per_call, want_per_call) < TOL
    assert _rel(pt_audio.stem(pt_params, x, plans=pt_net), want) < TOL


def test_whisper_config_is_the_reference_config():
    for get in ("get_config", "get_smoke_config"):
        ref = getattr(ref_cfgs, get)("whisper-tiny")
        port = getattr(pt_cfgs, get)("whisper-tiny")
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_stem_save_load_roundtrip_is_bitwise(tmp_path):
    cfg, params_np = _carried()
    pt_params = pt_audio.params_from_reference(params_np, device="cpu")
    shape = (2, 33, 16)
    net = pt_compile.compile(pt_params, pt_audio.stem_graph(cfg.d_model),
                             input_shape=shape, device="cpu")
    path = str(tmp_path / "stem.npz")
    net.save(path)
    loaded = pt_compile.NetworkPlan.load(path, device="cpu")
    assert loaded.describe() == net.describe()
    assert loaded.input_shape == shape
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(loaded.apply(x), net.apply(x))
    assert loaded.out_shape == (2, 17, cfg.d_model)
