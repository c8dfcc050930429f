"""Per-call convolution entry points -- thin wrappers over plans.

The JAX package's core/dispatch.py. The paper runs its region-wise
multi-channel Winograd scheme on "suitable" layers (stride-1 NxN / 1xN /
Nx1 with N in {3, 5, 7}, and stride 2 by phase decomposition) and the
im2row baseline everywhere else. `conv2d` and `conv1d` reproduce that
dispatch for ad-hoc callers: each call builds (or cache-hits) a plan
(core.plan.plan_conv2d / plan_conv1d) and applies it, so the filter is
transformed on every call. Callers that run a layer many times plan once
and call `plan.apply(x)`; whole networks go through core.compile.compile
(re-exported here as `compile_network`).

The plan is made on the input tensor's device: a CUDA tensor runs the
kernels the resolved executor launches, a CPU tensor their plain PyTorch
versions. `algorithm=` takes any name of ALGORITHMS; a request the
registered executors cannot cover raises the registry's error, which
lists the capabilities that do match the layer.
"""

from __future__ import annotations

import torch

from repro_torch.core.compile import NetworkPlan
from repro_torch.core.compile import compile as compile_network
from repro_torch.core.plan import (ALGORITHMS, AMORTIZE_MIN_C_IN,
                                   AMORTIZE_MIN_OUT_PIXELS, Algorithm,
                                   Padding, algorithm_supported, plan_conv1d,
                                   plan_conv2d, plan_depthwise_conv1d,
                                   plan_separable_block, winograd_amortizes,
                                   winograd_suitable)
from repro_torch.core.registry import WINOGRAD_FILTER_SIZES

__all__ = [
    "ALGORITHMS", "Algorithm", "NetworkPlan", "algorithm_supported",
    "compile_network", "conv1d", "conv2d", "plan_depthwise_conv1d",
    "plan_separable_block", "winograd_amortizes", "winograd_suitable",
    "WINOGRAD_FILTER_SIZES", "AMORTIZE_MIN_OUT_PIXELS", "AMORTIZE_MIN_C_IN",
]


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int | tuple[int, int] = 1,
    padding: Padding = "SAME",
    algorithm: Algorithm = "auto",
    groups: int = 1,
    output_tile: int | tuple[int, int] | None = None,
    precision=None,
    bias: torch.Tensor | None = None,
    activation: str = "none",
    data_format: str = "NHWC",
) -> torch.Tensor:
    """Unified convolution entry point (NHWC x HWIO -> NHWC): plans on x's
    device (the spec is cached by shape, the filter transformed anew),
    then applies. `bias` / `activation` run the plan's epilogue (fused
    into the kernel on the CUDA executors). `groups` is the feature group
    count (C_in for a depthwise conv; the filter then carries C_in/groups
    input channels). `data_format="NCHW"` takes NCHW inputs with an OIHW
    filter and returns NCHW (the filter transpose happens at plan time,
    keyed in the spec cache). `precision` is the reference's GEMM
    precision argument: the port's GEMMs are fp32 with TF32 off, so only
    None is accepted."""
    if precision is not None:
        raise ValueError(f"precision={precision!r}: the port's GEMMs run "
                         f"fp32 with TF32 off; pass None")
    plan = plan_conv2d(x.shape, w, stride=stride, padding=padding,
                       algorithm=algorithm, groups=groups,
                       output_tile=output_tile, data_format=data_format,
                       device=x.device)
    return plan.apply(x, bias=bias, activation=activation)


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding: Padding = "SAME",
    algorithm: Algorithm = "auto",
    output_tile: int | None = None,
) -> torch.Tensor:
    """Sequence convolution (B, L, C) x (k, C, M) -> (B, L', M) on x's
    device. A stride > 1 runs as a polyphase decomposition into stride-1
    Cook-Toom convolutions (sub-filter w[p::s] over sub-sequence x[p::s])
    when the filter is longer than the stride, else as im2col: the Whisper
    conv stem (k = 3, strides 1 and 2). A wrapper over
    core.plan.plan_conv1d."""
    plan = plan_conv1d(x.shape, w, stride=stride, padding=padding,
                       algorithm=algorithm, output_tile=output_tile,
                       device=x.device)
    return plan.apply(x)
