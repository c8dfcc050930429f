"""The paper's evaluation networks -- VGG-16/19, GoogleNet (Inception-v1),
Inception-v3, SqueezeNet -- plus the MobileNet-v1/v2 family, as layer-spec
lists (data, identical to the JAX package's models/cnn.py) with a torch
initializer.

`compile(params, specs, res=...)` (repro_torch.core.compile) lowers a spec
list to the layer IR and binds it into an executable NetworkPlan;
`cnn_forward` walks the spec list instead, every conv through the per-call
dispatcher (core.dispatch.conv2d).
`params_from_reference` takes the JAX package's `init_cnn` output (as numpy
arrays) so both packages can run the same weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Literal, Sequence

import numpy as np
import torch

from repro_torch.core.dispatch import conv2d
from repro_torch.core.plan import algorithm_supported, winograd_suitable
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.layers import (conv2d_layer, dense_head, init_conv2d,
                                       pool2d)


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    kh: int
    kw: int
    c_out: int
    stride: int = 1
    padding: str = "SAME"
    relu: bool = True
    groups: int = 1                    # feature_group_count (must divide the
                                       # incoming channel count at this spot)
    activation: str | None = None      # epilogue override ("relu6", ...);
                                       # None falls back to the relu flag

    @property
    def act(self) -> str:
        return self.activation or ("relu" if self.relu else "none")


@dataclasses.dataclass(frozen=True)
class SeparableConv:
    """MobileNet depthwise-separable unit: k x k depthwise conv (groups =
    C_in, channel multiplier 1) + 1x1 pointwise conv, bias+ReLU after each.
    Lowers to the unfused dw -> pw conv chain; the compiler's fuse pass
    (repro_torch.core.compile) rewrites it to ONE separable node."""

    name: str
    k: int
    c_out: int
    stride: int = 1
    padding: str = "SAME"


@dataclasses.dataclass(frozen=True)
class InvertedResidual:
    """MobileNet-v2 inverted residual unit (Sandler et al. 2018): 1x1
    expand (xfactor, relu6) -> kxk depthwise (stride s, relu6) -> 1x1
    linear projection, residual add when stride 1 and C_in == C_out.
    Lowers to the unfused expand -> dw -> project [-> add] chain; the
    compiler's fuse pass rewrites it to ONE inverted-residual node."""

    name: str
    c_out: int
    stride: int = 1
    expand: int = 6                    # expansion factor t
    k: int = 3


@dataclasses.dataclass(frozen=True)
class Pool:
    kind: Literal["max", "avg"]
    k: int
    stride: int
    padding: str = "VALID"


@dataclasses.dataclass(frozen=True)
class Concat:
    """Parallel branches (inception); each branch is a spec list."""
    branches: Sequence[Sequence[Any]]


@dataclasses.dataclass(frozen=True)
class GlobalAvgPool:
    pass


@dataclasses.dataclass(frozen=True)
class Dense:
    name: str
    n_out: int
    relu: bool = True


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _out_size(size, k, stride, padding):
    if padding == "SAME":
        return -(-size // stride)
    return (size - k) // stride + 1


def init_cnn(generator: torch.Generator, specs, c_in: int,
             dtype=torch.float32, res: int = 224, device=None) -> dict:
    """Initialize every layer from `generator`, tracking (h, w, c) through
    the spec walk so Dense weights get their flattened input dim up front.
    Weights are drawn on the generator's device and placed on `device`
    (None means the CUDA device). The numbers differ from the JAX
    package's `init_cnn`; use `params_from_reference` to share weights."""
    device = resolve_device(device)
    params: dict = {}

    def conv(kh, kw, ci, co, groups=1):
        return init_conv2d(generator, kh, kw, ci, co, dtype, groups=groups,
                           device=device)

    def walk(specs, h, w, c):
        for spec in specs:
            if isinstance(spec, Conv):
                params[spec.name] = conv(spec.kh, spec.kw, c, spec.c_out,
                                         spec.groups)
                h = _out_size(h, spec.kh, spec.stride, spec.padding)
                w = _out_size(w, spec.kw, spec.stride, spec.padding)
                c = spec.c_out
            elif isinstance(spec, SeparableConv):
                params[spec.name] = {"dw": conv(spec.k, spec.k, c, c, c),
                                     "pw": conv(1, 1, c, spec.c_out)}
                h = _out_size(h, spec.k, spec.stride, spec.padding)
                w = _out_size(w, spec.k, spec.stride, spec.padding)
                c = spec.c_out
            elif isinstance(spec, InvertedResidual):
                ce = c * spec.expand
                p = {"dw": conv(spec.k, spec.k, ce, ce, ce),
                     "pw": conv(1, 1, ce, spec.c_out)}
                if spec.expand != 1:
                    p["exp"] = conv(1, 1, c, ce)
                params[spec.name] = p
                h = _out_size(h, spec.k, spec.stride, "SAME")
                w = _out_size(w, spec.k, spec.stride, "SAME")
                c = spec.c_out
            elif isinstance(spec, Pool):
                h = _out_size(h, spec.k, spec.stride, spec.padding)
                w = _out_size(w, spec.k, spec.stride, spec.padding)
            elif isinstance(spec, Concat):
                outs = [walk(br, h, w, c) for br in spec.branches]
                h, w = outs[0][0], outs[0][1]
                c = sum(o[2] for o in outs)
            elif isinstance(spec, GlobalAvgPool):
                h = w = 1
            elif isinstance(spec, Dense):
                n_in = h * w * c
                wd = torch.randn((n_in, spec.n_out), generator=generator,
                                 dtype=dtype, device=generator.device)
                params[spec.name] = {"w": (n_in ** -0.5 * wd).to(device)}
                h = w = 1
                c = spec.n_out
        return h, w, c

    walk(specs, res, res, c_in)
    return params


def params_from_reference(params_np, device=None) -> dict:
    """The JAX package's `init_cnn` output, given as a nested dict of numpy
    arrays, as this package's params: the same keys, HWIO conv filters and
    (n_in, n_out) dense weights, as tensors on `device` (None means the
    CUDA device)."""
    device = resolve_device(device)

    def convert(v):
        if isinstance(v, dict):
            return {k: convert(x) for k, x in v.items()}
        return torch.as_tensor(np.asarray(v), device=device)

    return convert(params_np)


# ---------------------------------------------------------------------------
# the spec-walk interpreter (per-call path)
# ---------------------------------------------------------------------------

def _layer_algorithm(spec: Conv, algorithm: str,
                     c_in: int | None = None) -> str:
    """A forced winograd / kernel setting falls back to im2col on layers its
    executors do not cover (unsuitable filter or stride, grouped
    constraints): the paper's mixed policy applied to a forced global
    setting, a registry query (plan.algorithm_supported)."""
    if algorithm_supported(algorithm, spec.kh, spec.kw, spec.stride,
                           groups=spec.groups, c_in=c_in, c_out=spec.c_out):
        return algorithm
    return "im2col"


def plan_cnn(params: dict, specs, *, res: int, c_in: int = 3,
             batch: int = 1, algorithm: str = "auto", device=None):
    """DEPRECATED shim over the graph compiler: returns
    core.compile.compile(params, specs, res=...), a NetworkPlan, which
    keeps the old dict interface (plans[name]) over its per-layer plans.
    New code calls compile() directly and uses NetworkPlan.apply / save /
    load."""
    from repro_torch.core.compile import compile as _compile
    from repro_torch.core.compile import warn_deprecated
    warn_deprecated(
        "models.cnn.plan_cnn",
        "repro_torch.core.compile.compile(params, specs, res=...)")
    return _compile(params, specs, res=res, c_in=c_in, batch=batch,
                    algorithm=algorithm, device=device)


def cnn_forward(params: dict, x: torch.Tensor, specs,
                algorithm: str = "auto", layer_times: dict | None = None,
                plans=None) -> torch.Tensor:
    """Run the network by walking its specs, every conv through the
    per-call dispatcher (core.dispatch.conv2d) on x's device: each call
    plans its layer and transforms its filter. `algorithm` selects the
    conv scheme globally ("auto" is the paper's mixed policy); a layer
    the forced family does not cover runs im2col. Separable blocks run as
    a depthwise conv then a 1x1 conv; inverted residuals as an im2col
    expand, the depthwise conv and an im2col projection.

    `plans` is DEPRECATED (compile the network and call net.apply(x)):
    the walk then runs each pre-built plan by name, with biases and dense
    weights from the `params` of this call. `layer_times`, a dict,
    receives one conv descriptor per layer for a benchmark harness."""
    if plans is not None:
        from repro_torch.core.compile import warn_deprecated
        warn_deprecated("models.cnn.cnn_forward(plans=...)",
                        "repro_torch.core.compile.compile(...).apply(x)")

    def walk(x, specs):
        for spec in specs:
            if isinstance(spec, Conv):
                if layer_times is not None:
                    layer_times[spec.name] = dict(
                        kh=spec.kh, kw=spec.kw, c_in=x.shape[-1],
                        c_out=spec.c_out, h=x.shape[1], w=x.shape[2],
                        stride=spec.stride, groups=spec.groups,
                        suitable=winograd_suitable(spec.kh, spec.kw,
                                                   spec.stride))
                x = conv2d_layer(
                    params[spec.name], x, activation=spec.act,
                    plan=plans.get(spec.name) if plans else None,
                    stride=spec.stride, padding=spec.padding,
                    groups=spec.groups,
                    algorithm=_layer_algorithm(spec, algorithm, x.shape[-1]))
            elif isinstance(spec, SeparableConv):
                p = params[spec.name]
                c = x.shape[-1]
                if layer_times is not None:
                    layer_times[f"{spec.name}_dw"] = dict(
                        kh=spec.k, kw=spec.k, c_in=c, c_out=c,
                        h=x.shape[1], w=x.shape[2], stride=spec.stride,
                        groups=c,
                        suitable=winograd_suitable(spec.k, spec.k,
                                                   spec.stride))
                    layer_times[f"{spec.name}_pw"] = dict(
                        kh=1, kw=1, c_in=c, c_out=spec.c_out,
                        h=_out_size(x.shape[1], spec.k, spec.stride,
                                    spec.padding),
                        w=_out_size(x.shape[2], spec.k, spec.stride,
                                    spec.padding),
                        stride=1, groups=1, suitable=False)
                if plans:
                    x = plans[spec.name].apply(
                        x, bias_dw=p["dw"]["b"], bias_pw=p["pw"]["b"])
                else:
                    dw_spec = Conv(spec.name, spec.k, spec.k, c,
                                   stride=spec.stride, padding=spec.padding,
                                   groups=c)
                    x = conv2d(x, p["dw"]["w"], stride=spec.stride,
                               padding=spec.padding, groups=c,
                               algorithm=_layer_algorithm(dw_spec, algorithm,
                                                          c),
                               bias=p["dw"]["b"], activation="relu")
                    pw_spec = Conv(f"{spec.name}_pw", 1, 1, spec.c_out)
                    x = conv2d(x, p["pw"]["w"],
                               algorithm=_layer_algorithm(pw_spec, algorithm,
                                                          c),
                               bias=p["pw"]["b"], activation="relu")
            elif isinstance(spec, InvertedResidual):
                p = params[spec.name]
                c = x.shape[-1]
                ce = c * spec.expand
                if layer_times is not None:
                    layer_times[f"{spec.name}_dw"] = dict(
                        kh=spec.k, kw=spec.k, c_in=ce, c_out=ce,
                        h=x.shape[1], w=x.shape[2], stride=spec.stride,
                        groups=ce,
                        suitable=winograd_suitable(spec.k, spec.k,
                                                   spec.stride))
                if plans:
                    x = plans[spec.name].apply(
                        x, bias_exp=p["exp"]["b"] if "exp" in p else None,
                        bias_dw=p["dw"]["b"], bias_pw=p["pw"]["b"])
                else:
                    h = x
                    if "exp" in p:
                        h = conv2d(h, p["exp"]["w"], bias=p["exp"]["b"],
                                   activation="relu6", algorithm="im2col")
                    dw_spec = Conv(spec.name, spec.k, spec.k, ce,
                                   stride=spec.stride, groups=ce)
                    h = conv2d(h, p["dw"]["w"], stride=spec.stride,
                               groups=ce, bias=p["dw"]["b"],
                               activation="relu6",
                               algorithm=_layer_algorithm(dw_spec, algorithm,
                                                          ce))
                    h = conv2d(h, p["pw"]["w"], bias=p["pw"]["b"],
                               activation="none", algorithm="im2col")
                    x = x + h if (spec.stride == 1
                                  and c == spec.c_out) else h
            elif isinstance(spec, Pool):
                x = pool2d(x, spec.kind, spec.k, spec.stride, spec.padding)
            elif isinstance(spec, Concat):
                x = torch.cat([walk(x, br) for br in spec.branches], dim=-1)
            elif isinstance(spec, GlobalAvgPool):
                x = torch.mean(x, dim=(1, 2))
            elif isinstance(spec, Dense):
                x = dense_head(x, params[spec.name]["w"], spec.relu)
        return x
    return walk(x, specs)


# ---------------------------------------------------------------------------
# network definitions
# ---------------------------------------------------------------------------


def _vgg_block(name, n, c):
    return [Conv(f"{name}_{i}", 3, 3, c) for i in range(n)] + \
        [Pool("max", 2, 2)]


def vgg16():
    return (
        _vgg_block("conv1", 2, 64) + _vgg_block("conv2", 2, 128)
        + _vgg_block("conv3", 3, 256) + _vgg_block("conv4", 3, 512)
        + _vgg_block("conv5", 3, 512)
        + [Dense("fc6", 4096), Dense("fc7", 4096), Dense("fc8", 1000, relu=False)]
    )


def vgg19():
    return (
        _vgg_block("conv1", 2, 64) + _vgg_block("conv2", 2, 128)
        + _vgg_block("conv3", 4, 256) + _vgg_block("conv4", 4, 512)
        + _vgg_block("conv5", 4, 512)
        + [Dense("fc6", 4096), Dense("fc7", 4096), Dense("fc8", 1000, relu=False)]
    )


def _fire(name, squeeze, expand):
    return [
        Conv(f"{name}_sq", 1, 1, squeeze),
        Concat([[Conv(f"{name}_e1", 1, 1, expand)],
                [Conv(f"{name}_e3", 3, 3, expand)]]),
    ]


def squeezenet():
    # SqueezeNet 1.0
    s = [Conv("conv1", 7, 7, 96, stride=2), Pool("max", 3, 2)]
    s += _fire("fire2", 16, 64) + _fire("fire3", 16, 64) + _fire("fire4", 32, 128)
    s += [Pool("max", 3, 2)]
    s += _fire("fire5", 32, 128) + _fire("fire6", 48, 192) + \
        _fire("fire7", 48, 192) + _fire("fire8", 64, 256)
    s += [Pool("max", 3, 2)]
    s += _fire("fire9", 64, 256)
    s += [Conv("conv10", 1, 1, 1000), GlobalAvgPool()]
    return s


def _inception_v1(name, c1, c3r, c3, c5r, c5, cp):
    return Concat([
        [Conv(f"{name}_1x1", 1, 1, c1)],
        [Conv(f"{name}_3r", 1, 1, c3r), Conv(f"{name}_3x3", 3, 3, c3)],
        [Conv(f"{name}_5r", 1, 1, c5r), Conv(f"{name}_5x5", 5, 5, c5)],
        [Pool("max", 3, 1, "SAME"), Conv(f"{name}_pp", 1, 1, cp)],
    ])


def googlenet():
    return [
        Conv("conv1", 7, 7, 64, stride=2), Pool("max", 3, 2, "SAME"),
        Conv("conv2r", 1, 1, 64), Conv("conv2", 3, 3, 192),
        Pool("max", 3, 2, "SAME"),
        _inception_v1("i3a", 64, 96, 128, 16, 32, 32),
        _inception_v1("i3b", 128, 128, 192, 32, 96, 64),
        Pool("max", 3, 2, "SAME"),
        _inception_v1("i4a", 192, 96, 208, 16, 48, 64),
        _inception_v1("i4b", 160, 112, 224, 24, 64, 64),
        _inception_v1("i4c", 128, 128, 256, 24, 64, 64),
        _inception_v1("i4d", 112, 144, 288, 32, 64, 64),
        _inception_v1("i4e", 256, 160, 320, 32, 128, 128),
        Pool("max", 3, 2, "SAME"),
        _inception_v1("i5a", 256, 160, 320, 32, 128, 128),
        _inception_v1("i5b", 384, 192, 384, 48, 128, 128),
        GlobalAvgPool(), Dense("fc", 1000, relu=False),
    ]


def _inc3_a(name, cp):
    return Concat([
        [Conv(f"{name}_1x1", 1, 1, 64)],
        [Conv(f"{name}_5r", 1, 1, 48), Conv(f"{name}_5x5", 5, 5, 64)],
        [Conv(f"{name}_3r", 1, 1, 64), Conv(f"{name}_3a", 3, 3, 96),
         Conv(f"{name}_3b", 3, 3, 96)],
        [Pool("avg", 3, 1, "SAME"), Conv(f"{name}_pp", 1, 1, cp)],
    ])


def _inc3_b(name, c7):
    return Concat([
        [Conv(f"{name}_1x1", 1, 1, 192)],
        [Conv(f"{name}_7r", 1, 1, c7), Conv(f"{name}_1x7a", 1, 7, c7),
         Conv(f"{name}_7x1a", 7, 1, 192)],
        [Conv(f"{name}_7rr", 1, 1, c7), Conv(f"{name}_7x1b", 7, 1, c7),
         Conv(f"{name}_1x7b", 1, 7, c7), Conv(f"{name}_7x1c", 7, 1, c7),
         Conv(f"{name}_1x7c", 1, 7, 192)],
        [Pool("avg", 3, 1, "SAME"), Conv(f"{name}_pp", 1, 1, 192)],
    ])


def _inc3_c(name):
    return Concat([
        [Conv(f"{name}_1x1", 1, 1, 320)],
        [Conv(f"{name}_3r", 1, 1, 384),
         Concat([[Conv(f"{name}_1x3a", 1, 3, 384)],
                 [Conv(f"{name}_3x1a", 3, 1, 384)]])],
        [Conv(f"{name}_dr", 1, 1, 448), Conv(f"{name}_d3", 3, 3, 384),
         Concat([[Conv(f"{name}_1x3b", 1, 3, 384)],
                 [Conv(f"{name}_3x1b", 3, 1, 384)]])],
        [Pool("avg", 3, 1, "SAME"), Conv(f"{name}_pp", 1, 1, 192)],
    ])


def inception_v3():
    return [
        Conv("conv1", 3, 3, 32, stride=2, padding="VALID"),
        Conv("conv2", 3, 3, 32, padding="VALID"),
        Conv("conv3", 3, 3, 64),
        Pool("max", 3, 2),
        Conv("conv4", 1, 1, 80, padding="VALID"),
        Conv("conv5", 3, 3, 192, padding="VALID"),
        Pool("max", 3, 2),
        _inc3_a("m1", 32), _inc3_a("m2", 64), _inc3_a("m3", 64),
        # reduction A
        Concat([[Conv("rA_3", 3, 3, 384, stride=2, padding="VALID")],
                [Conv("rA_r", 1, 1, 64), Conv("rA_3a", 3, 3, 96),
                 Conv("rA_3b", 3, 3, 96, stride=2, padding="VALID")],
                [Pool("max", 3, 2)]]),
        _inc3_b("m4", 128), _inc3_b("m5", 160), _inc3_b("m6", 160),
        _inc3_b("m7", 192),
        # reduction B
        Concat([[Conv("rB_r1", 1, 1, 192),
                 Conv("rB_3", 3, 3, 320, stride=2, padding="VALID")],
                [Conv("rB_r2", 1, 1, 192), Conv("rB_1x7", 1, 7, 192),
                 Conv("rB_7x1", 7, 1, 192),
                 Conv("rB_3b", 3, 3, 192, stride=2, padding="VALID")],
                [Pool("max", 3, 2)]]),
        _inc3_c("m8"), _inc3_c("m9"),
        GlobalAvgPool(), Dense("fc", 1000, relu=False),
    ]


def _make_divisible(c: float, divisor: int = 8) -> int:
    """The slim/MobileNet channel rounding: nearest multiple of `divisor`
    (floored at `divisor`), bumped up one step if rounding dropped more
    than 10% -- the reference convention both MobileNets use, so scaled
    channel counts match published checkpoints at every width multiplier."""
    v = max(int(c + divisor / 2) // divisor * divisor, divisor)
    if v < 0.9 * c:
        v += divisor
    return v


#: MobileNet-v1 body: (c_out, stride) of each depthwise-separable block
#: (Howard et al. 2017, Table 1), after the stride-2 3x3 stem.
_MOBILENET_V1_BLOCKS = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
)


def mobilenet_v1(width_mult: float = 1.0):
    """MobileNet-v1: a stride-2 3x3 stem + 13 depthwise-separable blocks.

    `width_mult` is the paper's width multiplier alpha: every channel count
    is scaled through the slim `make_divisible` rounding."""
    def ch(c: int) -> int:
        return _make_divisible(c * width_mult)

    s = [Conv("conv1", 3, 3, ch(32), stride=2)]
    s += [SeparableConv(f"sep{i + 2}", 3, ch(c), stride=st)
          for i, (c, st) in enumerate(_MOBILENET_V1_BLOCKS)]
    s += [GlobalAvgPool(), Dense("fc", 1000, relu=False)]
    return s


def mobilenet_v1_050():
    """MobileNet-v1 at width multiplier 0.5."""
    return mobilenet_v1(width_mult=0.5)


#: MobileNet-v2 body: (expand t, c_out, repeats n, first-stride s) of each
#: inverted-residual stage (Sandler et al. 2018, Table 2).
_MOBILENET_V2_STAGES = (
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
)


def mobilenet_v2(width_mult: float = 1.0):
    """MobileNet-v2: stride-2 3x3 stem (relu6), 17 inverted-residual blocks,
    1x1 head conv, classifier."""
    def ch(c: int) -> int:
        return _make_divisible(c * width_mult)

    s = [Conv("conv1", 3, 3, ch(32), stride=2, activation="relu6")]
    i = 0
    for t, c, n, st in _MOBILENET_V2_STAGES:
        for j in range(n):
            s.append(InvertedResidual(f"ir{i + 1}", ch(c),
                                      stride=st if j == 0 else 1, expand=t))
            i += 1
    head = ch(1280) if width_mult > 1.0 else 1280
    s += [Conv("conv_head", 1, 1, head, activation="relu6"),
          GlobalAvgPool(), Dense("fc", 1000, relu=False)]
    return s


NETWORKS = {
    "vgg16": (vgg16, 224),
    "vgg19": (vgg19, 224),
    "googlenet": (googlenet, 224),
    "inception_v3": (inception_v3, 299),
    "squeezenet": (squeezenet, 224),
    "mobilenet_v1": (mobilenet_v1, 224),
    "mobilenet_v1_050": (mobilenet_v1_050, 224),
    "mobilenet_v2": (mobilenet_v2, 224),
}
