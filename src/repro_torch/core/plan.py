"""Plan/execute split for convolution: decide once, run many.

The paper's deployment insight (section 4): the fast Winograd / Cook-Toom
scheme pays off once the GEMM phase amortizes the transform phases, and the
*filter* transform never belongs on the inference path. As in the JAX
package's core/plan.py:

  * `plan_conv2d(x_shape, w, ...)` makes every per-layer decision once --
    algorithm, CookToom pair, output tile, padding, tile counts, kernel
    blocking -- and transforms the filter into the execution domain.
  * `ConvPlan.apply(x)` executes with zero per-call filter or geometry work.
  * Which executor may run which layer is a capability-registry query
    (repro_torch.core.registry).

The port runs the executors of the dense path: `pallas_winograd` (the
streaming CUDA kernel), `winograd` (pure PyTorch) and `im2col`. Every other
executor the registry resolves raises NotImplementedError naming its
ROADMAP.md item. `algorithm="auto_tuned"` takes the heuristic decision; the
measured race is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
import typing
from typing import Any, Literal

import torch
from torch import nn

from repro_torch.core import im2col as _im2col
from repro_torch.core import registry
from repro_torch.core import winograd as _wg
from repro_torch.core.registry import LayerQuery
from repro_torch.core.transforms import DEFAULT_OUTPUT_TILE, CookToom, cook_toom
from repro_torch.kernels import ops
from repro_torch.kernels.runtime import ACTIVATIONS as EPILOGUE_ACTIVATIONS
from repro_torch.kernels.runtime import epilogue, resolve_device
from repro_torch.optim import compression as _comp

Algorithm = Literal["auto", "auto_tuned", "winograd", "winograd_f63", "fft",
                    "im2col", "pallas_winograd",
                    "pallas_winograd_materialized", "pallas_im2col"]
#: The requestable algorithm names (the same as the JAX package's).
ALGORITHMS: tuple[str, ...] = typing.get_args(Algorithm)
Padding = _wg.Padding

#: auto_tuned's static crossover (the JAX package's fallback policy):
#: winograd wins when the per-point GEMMs are large enough to amortize the
#: transform passes -- enough output pixels AND enough channel depth.
AMORTIZE_MIN_OUT_PIXELS = 1156            # 34 x 34
AMORTIZE_MIN_C_IN = 64

#: Executors the registry declares that the port does not run yet, with
#: the ROADMAP.md item that ports each.
NOT_PORTED = {
    "winograd_1d": "ROADMAP.md queue 1 item 2 (1xN/Nx1 executor)",
    "winograd_depthwise": "ROADMAP.md queue 1 item 2 (depthwise executor)",
    "winograd_grouped": "ROADMAP.md queue 1 item 2 (grouped executor)",
    "winograd_strided": "ROADMAP.md queue 1 item 2 (strided executor)",
    "winograd_f63": "ROADMAP.md queue 1 item 2 (F(6,3) executor)",
    "fft": "ROADMAP.md queue 1 item 2 (core/fft.py)",
    "pallas_winograd_strided":
        "ROADMAP.md queue 2 item 2 (winograd_strided_streamed)",
    "pallas_winograd_materialized":
        "ROADMAP.md queue 2 item 3 (winograd_fused)",
    "pallas_depthwise": "ROADMAP.md queue 2 item 4 (depthwise_streamed)",
    "pallas_depthwise_strided":
        "ROADMAP.md queue 2 item 5 (depthwise_strided_streamed)",
    "pallas_im2col": "ROADMAP.md queue 2 item 7 (matmul)",
}


def not_ported(executor: str) -> NotImplementedError:
    return NotImplementedError(
        f"executor {executor!r} is not ported to repro_torch yet: "
        f"{NOT_PORTED.get(executor, 'ROADMAP.md queue 1')}")


def winograd_amortizes(h: int, w: int, kh: int, kw: int, c_in: int,
                       padding: str = "SAME", groups: int = 1,
                       stride=1) -> bool:
    """The paper's section-4 amortization insight as a static predicate:
    the auto_tuned decision when nothing is measured. Depthwise layers
    need only the output-pixel threshold."""
    sh, sw = (stride, stride) if isinstance(stride, int) else tuple(stride)
    out_h = -(-h // sh) if padding == "SAME" else (h - kh) // sh + 1
    out_w = -(-w // sw) if padding == "SAME" else (w - kw) // sw + 1
    if out_h * out_w < AMORTIZE_MIN_OUT_PIXELS:
        return False
    if groups > 1 and groups == c_in:     # depthwise
        return True
    return c_in // groups >= AMORTIZE_MIN_C_IN


def dtype_name(dtype) -> str:
    """'float32' / 'bfloat16' / 'int8' from a torch dtype or a name."""
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# Specs: the weight-free part of a plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Everything about a planned conv layer except the weights: the
    resolved executor, transform variant, geometry and kernel blocking."""

    x_shape: tuple[int, ...]          # (N, H, W, C) the plan was built for
                                      # (always NHWC internally; see layout)
    w_shape: tuple[int, ...]          # (kh, kw, C/groups, M)
    dtype: str
    stride: tuple[int, int]
    padding: str
    requested: str                    # the algorithm= the caller asked for
    algorithm: str                    # resolved executor (a registry
                                      # Capability.executor name)
    groups: int = 1
    layout: str = "NHWC"              # caller-facing data format; "NCHW"
                                      # plans transpose weights once at plan
                                      # time and apply() transposes x / y
    compute_dtype: str = "float32"    # transform-domain GEMM dtype; the
                                      # input and inverse transforms always
                                      # run fp32
    output_tile: tuple[int, int] | None = None
    ct_h: CookToom | None = None
    ct_w: CookToom | None = None
    geometry: Any = None              # Conv2DGeometry | Im2RowGeometry
    blocks: tuple[int, ...] | None = None   # kernel block sizes
    stream: Any = None                # StreamGeometry of pallas_winograd


def _resolve_output_tile(kh: int, kw: int, output_tile) -> tuple[int, int]:
    if output_tile is None:
        mt = DEFAULT_OUTPUT_TILE.get(max(kh, kw), 2)
        return (mt, mt)
    if isinstance(output_tile, int):
        return (output_tile, output_tile)
    return tuple(output_tile)


def _build_spec(x_shape, w_shape, dtype, stride, padding, requested,
                resolved, output_tile, groups: int = 1,
                layout: str = "NHWC",
                compute_dtype: str = "float32",
                sms: int = _wg.H100_SMS) -> ConvSpec:
    """Materialize the geometry / transform / blocking decisions of one
    resolved executor; `sms` is the card's multiprocessor count, which the
    streaming kernel's blocking is sized for."""
    n, h, w, c = x_shape
    kh, kw, _, mout = w_shape
    base = dict(x_shape=tuple(x_shape), w_shape=tuple(w_shape), dtype=dtype,
                stride=stride, padding=padding, requested=requested,
                groups=groups, layout=layout, compute_dtype=compute_dtype)

    if (compute_dtype != "float32" and output_tile is None
            and resolved not in ("winograd_f63", "fft", "im2col",
                                 "pallas_im2col")):
        # Low-precision grids pair with the small tile: F(4,3)'s inverse
        # transform amplifies the bf16/int8 quantization grid past any
        # useful budget. An explicit output_tile still wins.
        output_tile = 2

    if resolved == "winograd":
        mh, mw = _resolve_output_tile(kh, kw, output_tile)
        ct_h, ct_w = cook_toom(mh, kh), cook_toom(mw, kw)
        geom = _wg.conv2d_geometry(h, w, kh, kw, mh, mw, padding)
        return ConvSpec(algorithm="winograd", output_tile=(mh, mw),
                        ct_h=ct_h, ct_w=ct_w, geometry=geom, **base)

    if resolved == "pallas_winograd":
        # Streaming executor: conv padding, tile counts and the kernel's
        # halo blocking, derived here, once.
        mh, mw = _resolve_output_tile(kh, kw, output_tile)
        ct_h, ct_w = cook_toom(mh, kh), cook_toom(mw, kw)
        geom = _wg.conv2d_geometry(h, w, kh, kw, mh, mw, padding)
        stream = _wg.stream_geometry(geom.n_h, geom.n_w, c, mout, ct_h, ct_w,
                                     batch=n, sms=sms)
        return ConvSpec(algorithm="pallas_winograd", output_tile=(mh, mw),
                        ct_h=ct_h, ct_w=ct_w, geometry=geom, stream=stream,
                        blocks=(stream.bh * stream.bw, stream.block_c,
                                stream.block_m), **base)

    if resolved == "im2col":
        if groups > 1:
            raise NotImplementedError(
                "grouped im2col is not ported to repro_torch yet: ROADMAP.md "
                "queue 1 item 2 (grouped_im2row)")
        geom = _im2col.im2row_geometry(h, w, kh, kw, stride, padding)
        return ConvSpec(algorithm="im2col", geometry=geom, **base)

    if resolved in NOT_PORTED:
        raise not_ported(resolved)
    raise ValueError(f"unknown algorithm {resolved!r}")


def _domain_filter(spec: ConvSpec, w: torch.Tensor) -> torch.Tensor:
    """Transform the filter into the spec's execution domain (fp32), once
    per plan; ConvPlan.apply never touches it again."""
    kh, kw, c, mout = spec.w_shape
    if spec.algorithm == "winograd":
        return _wg.transform_filter_2d(w, spec.ct_h, spec.ct_w)
    if spec.algorithm == "pallas_winograd":
        u = _wg.transform_filter_2d(w, spec.ct_h, spec.ct_w)
        u = u.reshape(spec.ct_h.t * spec.ct_w.t, c, mout)
        return ops.pad_winograd_filter(u, spec.blocks[1], spec.blocks[2])
    if spec.algorithm == "im2col":
        return w.reshape(kh * kw * c, mout)
    raise not_ported(spec.algorithm)


def _quantize_axes(spec: ConvSpec) -> tuple[tuple[int, ...], str]:
    """(channel_axes, scale_form) of the int8 per-output-channel quantizer:
    'flat' is one f32 per output channel broadcast by ConvPlan._dequantize,
    'row' a (1, M_padded) kernel operand beside the bias."""
    if spec.algorithm in ("winograd", "im2col"):
        return (-1,), "flat"
    if spec.algorithm == "pallas_winograd":
        return (-1,), "row"
    raise not_ported(spec.algorithm)


def _bind_weights(spec: ConvSpec, w: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Filter -> (execution-domain filter, dequantization scale). fp32 plans
    get (fp32 u, None); bf16 plans downcast the transformed filter; int8
    plans quantize per output channel AFTER the transform and padding, so
    `u_int8 * scale` reproduces the fp32 transformed filter up to rounding
    and the hot path dequantizes with one per-channel multiply in the
    epilogue."""
    u = _domain_filter(spec, w)
    cd = spec.compute_dtype
    if cd == "float32":
        return u.contiguous(), None
    if cd == "bfloat16":
        return u.to(torch.bfloat16).contiguous(), None
    if cd == "int8":
        axes, form = _quantize_axes(spec)
        q, scale = _comp.quantize_channelwise(u, channel_axes=axes)
        scale = scale.reshape(1, -1) if form == "row" else scale.reshape(-1)
        return q.contiguous(), scale.contiguous()
    raise ValueError(f"unknown compute_dtype {cd!r}; expected one of "
                     f"{registry.COMPUTE_DTYPES}")


# ---------------------------------------------------------------------------
# ConvPlan: spec + weights in the execution domain
# ---------------------------------------------------------------------------

class ConvPlan(nn.Module):
    """A fully-decided, weight-bound convolution. apply(x, bias=...,
    activation=...) does only input work; on the streaming kernel the bias
    add and activation are fused into the kernel's store.

    `u` (the execution-domain filter, fp32 / bf16 / int8) and `scale` (the
    int8 per-output-channel dequantization scales, or None) are buffers, so
    `.to(device)` moves them. `apply` is the plan's forward and shadows
    nn.Module.apply."""

    def __init__(self, spec: ConvSpec, u: torch.Tensor,
                 scale: torch.Tensor | None = None,
                 build_time_s: float = 0.0):
        super().__init__()
        self.spec = spec
        self.register_buffer("u", u)
        self.register_buffer("scale", scale)
        self.build_time_s = build_time_s

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None = None,
                activation: str = "none") -> torch.Tensor:
        return self.apply(x, bias=bias, activation=activation)

    def apply(self, x: torch.Tensor, bias: torch.Tensor | None = None,
              activation: str = "none") -> torch.Tensor:
        spec = self.spec
        if spec.layout == "NCHW":
            want = (spec.x_shape[3],) + spec.x_shape[1:3]
            if tuple(x.shape[1:]) != want:
                raise ValueError(
                    f"plan built for NCHW input (N, {want[0]}, {want[1]}, "
                    f"{want[2]}) got {tuple(x.shape)} (batch may differ; "
                    f"C/H/W must match)")
            y = self._apply_nhwc(x.permute(0, 2, 3, 1), bias, activation)
            return y.permute(0, 3, 1, 2)
        return self._apply_nhwc(x, bias, activation)

    def _dequantize(self, y: torch.Tensor) -> torch.Tensor:
        if self.scale is None:
            return y
        return y * self.scale.reshape(-1).to(y.dtype)

    def _apply_nhwc(self, x: torch.Tensor, bias: torch.Tensor | None,
                    activation: str) -> torch.Tensor:
        spec = self.spec
        if tuple(x.shape[1:]) != spec.x_shape[1:]:
            raise ValueError(
                f"plan built for input {spec.x_shape} got {tuple(x.shape)} "
                f"(batch may differ; H/W/C must match)")
        if activation not in EPILOGUE_ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; "
                             f"expected one of {EPILOGUE_ACTIVATIONS}")
        alg = spec.algorithm
        if alg == "pallas_winograd":
            return ops.winograd_conv2d_planned(
                x, self.u, ct_h=spec.ct_h, ct_w=spec.ct_w,
                geometry=spec.geometry, stream=spec.stream,
                c_out=spec.w_shape[3], bias=bias, activation=activation,
                scale=self.scale)
        if alg == "winograd":
            y = _wg.winograd_conv2d_pretransformed(
                x, self.u, spec.ct_h, spec.ct_w, padding=spec.padding,
                geometry=spec.geometry)
            return epilogue(self._dequantize(y), bias, activation)
        if alg == "im2col":
            geom = spec.geometry
            kh, kw, _, mout = spec.w_shape
            a, _ = _im2col.im2row(x, kh, kw, spec.stride, spec.padding, geom)
            if self.u.dtype == torch.bfloat16:
                a = a.to(torch.bfloat16)          # bf16 operands, fp32 sums
            y = torch.matmul(a.float(), self.u.float())
            y = y.reshape(x.shape[0], geom.oh, geom.ow, mout).to(x.dtype)
            return epilogue(self._dequantize(y), bias, activation)
        raise not_ported(alg)

    @property
    def algorithm(self) -> str:
        return self.spec.algorithm

    @property
    def out_shape(self) -> tuple[int, ...]:
        spec, g = self.spec, self.spec.geometry
        n, mout = spec.x_shape[0], spec.w_shape[-1]
        if spec.algorithm == "im2col":
            shape = (n, g.oh, g.ow, mout)
        else:
            shape = (n, g.out_h, g.out_w, mout)
        if spec.layout == "NCHW":
            return (shape[0], shape[3], shape[1], shape[2])
        return shape

    def describe(self) -> dict:
        spec = self.spec
        kh, kw = spec.w_shape[:2]
        return {"kind": "conv2d", "executor": spec.algorithm,
                "requested": spec.requested, "filter": f"{kh}x{kw}",
                "stride": f"{spec.stride[0]}x{spec.stride[1]}",
                "groups": spec.groups,
                "tile": ("x".join(map(str, spec.output_tile))
                         if spec.output_tile else "-"),
                "decision": ("heuristic" if spec.requested == "auto_tuned"
                             else "static"),
                "compute_dtype": spec.compute_dtype}


# ---------------------------------------------------------------------------
# plan_conv2d: the public entry point
# ---------------------------------------------------------------------------

def plan_conv2d(
    x_shape: tuple[int, ...],
    w,
    *,
    stride: int | tuple[int, int] = 1,
    padding: Padding = "SAME",
    algorithm: Algorithm = "auto",
    groups: int = 1,
    output_tile: int | tuple[int, int] | None = None,
    dtype=None,
    data_format: str = "NHWC",
    compute_dtype="float32",
    device=None,
) -> ConvPlan:
    """Build a ConvPlan for a (N, H, W, C) x (kh, kw, C/groups, M) conv.

    All per-layer decisions are made here, once, and the filter is
    transformed into the execution domain, once, on `device` (None means
    the CUDA device; pass device="cpu" for the plain versions).
    `data_format="NCHW"` ingests NCHW inputs with an OIHW filter: the filter
    is transposed to HWIO here and apply() transposes x / y at the call
    boundary. `compute_dtype` selects the transform-domain GEMM dtype
    ("float32", "bfloat16", or per-output-channel "int8").
    """
    t0 = time.perf_counter()
    device = resolve_device(device)
    x_shape = tuple(x_shape)
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; expected one of "
                         f"{ALGORITHMS}")
    if data_format not in registry.LAYOUTS:
        raise ValueError(f"unknown data_format {data_format!r}; expected one "
                         f"of {registry.LAYOUTS}")
    w = torch.as_tensor(w, device=device)
    if len(x_shape) != 4 or w.dim() != 4:
        raise ValueError(f"expected 4D input x 4D filter, got {x_shape} x "
                         f"{tuple(w.shape)}")
    if data_format == "NCHW":
        x_shape = (x_shape[0], x_shape[2], x_shape[3], x_shape[1])
        w = w.permute(2, 3, 1, 0)
    w_shape = tuple(w.shape)
    if groups < 1 or x_shape[3] % groups or w_shape[3] % groups:
        raise ValueError(
            f"groups={groups} must divide both C_in={x_shape[3]} and "
            f"C_out={w_shape[3]}")
    if x_shape[3] != w_shape[2] * groups:
        raise ValueError(
            f"channel mismatch: input {x_shape} (NHWC) filter {w_shape} "
            f"(HWIO) groups={groups}")
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    dtype_str = dtype_name(dtype or w.dtype)
    compute_dtype = dtype_name(compute_dtype)
    if compute_dtype not in registry.COMPUTE_DTYPES:
        raise ValueError(
            f"unknown compute_dtype {compute_dtype!r}; expected one of "
            f"{registry.COMPUTE_DTYPES}")
    kh, kw = w_shape[:2]
    n, h, wdt, c = x_shape
    query = LayerQuery(kh=kh, kw=kw, stride=stride, groups=groups, c_in=c,
                       c_out=w_shape[3], layout=data_format)
    if algorithm == "auto":
        resolved = registry.select_auto(query).executor
    elif algorithm == "auto_tuned":
        fast = registry.best_fast(query)
        resolved = (fast.executor if fast is not None and winograd_amortizes(
            h, wdt, kh, kw, c, padding, groups, stride) else "im2col")
    else:
        resolved = registry.resolve(algorithm, query).executor
    if compute_dtype not in registry.compute_dtypes_for(resolved):
        raise ValueError(
            f"executor {resolved!r} does not support "
            f"compute_dtype={compute_dtype!r} (it supports "
            f"{'/'.join(registry.compute_dtypes_for(resolved))})")
    spec = _build_spec(x_shape, w_shape, dtype_str, stride, padding,
                       algorithm, resolved, output_tile, groups, data_format,
                       compute_dtype=compute_dtype,
                       sms=(torch.cuda.get_device_properties(device)
                            .multi_processor_count
                            if device.type == "cuda" else _wg.H100_SMS))
    u, scale = _bind_weights(spec, w)
    return ConvPlan(spec, u, scale, build_time_s=time.perf_counter() - t0)
