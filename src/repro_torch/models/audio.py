"""Whisper conv stem: the paper's 1D algorithm on the audio architecture,
as in the JAX package's models/audio.py.

conv1 (k=3, stride 1) runs the Cook-Toom F(m, 3) path, conv2 (k=3,
stride 2) the polyphase decomposition into stride-1 Cook-Toom
convolutions (core.dispatch.conv1d); both end in bias + GELU (tanh).

Deployment path: `stem_graph()` expresses the stem as layer IR, so it
compiles through the same graph compiler as the CNN zoo --
`repro_torch.core.compile.compile(params, stem_graph(d),
input_shape=(B, T, n_mels))` -- NetworkPlan.save / load artifacts
included. `plan_stem` is a deprecation shim over that compiler; `stem`
without plans is the per-call path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compile import LayerIR
from repro_torch.core.compile import compile as _compile
from repro_torch.core.compile import warn_deprecated
from repro_torch.core.dispatch import conv1d
from repro_torch.kernels.runtime import apply_activation, resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import truncated_normal_init


def init_stem(generator: torch.Generator, cfg: ArchConfig, n_mels: int = 80,
              dtype=torch.float32, device=None) -> dict:
    """The stem's four arrays: (3, n_mels, d) and (3, d, d) filters drawn
    from `generator` (truncated normal, fan-in scaled), zero biases; on
    `device` (None means the CUDA device). The distribution of the JAX
    package's init_stem; the numbers differ (params_from_reference shares
    weights)."""
    device = resolve_device(device)
    d = cfg.d_model
    return {
        "conv1_w": truncated_normal_init(generator, (3, n_mels, d),
                                         (3 * n_mels) ** -0.5, dtype,
                                         device),
        "conv1_b": torch.zeros((d,), dtype=dtype, device=device),
        "conv2_w": truncated_normal_init(generator, (3, d, d),
                                         (3 * d) ** -0.5, dtype, device),
        "conv2_b": torch.zeros((d,), dtype=dtype, device=device),
    }


def params_from_reference(params_np, device=None) -> dict:
    """The JAX package's init_stem output (the four arrays, as numpy) as
    this package's params on `device` (None means the CUDA device)."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in params_np.items()}


def stem_graph(d_model: int) -> tuple[LayerIR, ...]:
    """The stem as layer IR: two conv1d nodes (k=3 stride 1, k=3 stride
    2), each with a fused bias + gelu epilogue, for
    compile(params, stem_graph(d), input_shape=(B, T, n_mels))."""
    return (
        LayerIR(id="input", op="input"),
        LayerIR(id="conv1", op="conv1d", inputs=("input",),
                attrs=dict(k=3, c_out=d_model, stride=1, padding="SAME",
                           activation="gelu", w_path=("conv1_w",),
                           b_path=("conv1_b",))),
        LayerIR(id="conv2", op="conv1d", inputs=("conv1",),
                attrs=dict(k=3, c_out=d_model, stride=2, padding="SAME",
                           activation="gelu", w_path=("conv2_w",),
                           b_path=("conv2_b",))),
    )


def plan_stem(params: dict, mel_shape: tuple[int, ...],
              algorithm: str = "auto", device=None):
    """DEPRECATED shim over the graph compiler: returns
    compile(params, stem_graph(d), input_shape=mel_shape), a NetworkPlan
    that keeps the old dict interface (plans["conv1"], plans["conv2"]).
    New code calls compile() directly."""
    warn_deprecated(
        "models.audio.plan_stem",
        "repro_torch.core.compile.compile(params, audio.stem_graph(d), "
        "input_shape=mel_shape)")
    d_model = params["conv1_w"].shape[2]
    return _compile(params, stem_graph(d_model), input_shape=mel_shape,
                    algorithm=algorithm, device=device)


def stem(params: dict, mel: torch.Tensor, algorithm: str = "auto",
         plans=None) -> torch.Tensor:
    """mel (B, T, n_mels) -> frame embeddings (B, ceil(T / 2), d_model), on
    mel's device.

    With `plans` (a NetworkPlan from plan_stem / compile, indexed by
    "conv1" / "conv2") the convolutions run pre-planned with fused bias +
    gelu epilogues and no per-call filter transform; the biases come from
    the `params` of this call. Without, each conv plans per call
    (core.dispatch.conv1d)."""
    if plans is not None:
        x = plans["conv1"].apply(mel, bias=params["conv1_b"],
                                 activation="gelu")
        return plans["conv2"].apply(x, bias=params["conv2_b"],
                                    activation="gelu")
    x = conv1d(mel, params["conv1_w"], stride=1, padding="SAME",
               algorithm=algorithm)
    x = apply_activation(x + params["conv1_b"], "gelu")
    x = conv1d(x, params["conv2_w"], stride=2, padding="SAME",
               algorithm=algorithm)
    return apply_activation(x + params["conv2_b"], "gelu")
