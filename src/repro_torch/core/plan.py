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

The port runs every executor the registry declares: the CUDA kernels
`pallas_winograd`, `pallas_winograd_strided`, `pallas_depthwise`,
`pallas_depthwise_strided` and `pallas_im2col`, the A/B baseline
`pallas_winograd_materialized`, and the pure-PyTorch `winograd`,
`winograd_f63` (the row-scaled F(6, 3) set), `fft` (rfft2 tiles on
torch.fft, core/fft.py), `winograd_1d` (1xN / Nx1 layers, under every
Winograd family), `winograd_strided`, `winograd_depthwise`,
`winograd_grouped` and `im2col`. Separable (depthwise + pointwise) blocks
plan as one unit (`plan_separable_block`: the fused `separable_streamed`
kernel where it applies, two ConvPlans otherwise), and MobileNet-v2
inverted residual blocks on top of them (`plan_inverted_residual`).
Sequence convolutions plan through `plan_conv1d` (Conv1DPlan: a 2D plan on
(B, L, 1, C) at stride 1, polyphase sub-plans at stride 2). The
Mamba short conv plans as a causal depthwise Cook-Toom conv1d
(`plan_depthwise_conv1d`, backends "jnp", the pure-PyTorch executor, and
"pallas", the `conv1d_ct_fused` CUDA kernel).

A process-level spec cache keyed on every planning input (and on the card
the blocking is sized for) makes repeated planning of a layer shape a dict
hit. `algorithm="auto_tuned"` is plan-time measured autotuning: the
registry-eligible plain executors are timed on the real layer shape (CUDA
events on the card) and the winner and its evidence are cached and
persisted in artifacts; the static amortization predicate decides only
where nothing may be measured (REPRO_PLAN_NO_MEASURE, a CUDA graph
capture, torch.compile tracing). `compute_dtype="auto"` also races the
bf16 / int8 variants under AUTOTUNE_ACCURACY_BUDGET.

Every plan class conforms to the reference's LayerPlan protocol: apply,
describe, `to_artifact()` -> (meta, arrays) and
`from_artifact(meta, arrays, device=, foreign=)`. The meta records every
decision including the chooser's kernel blocking, so a load re-plans
nothing and transforms no filter (`plan_from_artifact`;
NetworkPlan.save/load in core/compile.py). The JAX package's artifacts
(`foreign=True`) carry no blocking: the choosers pick it, and the weights
are cropped to their logical extent and padded again for it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import typing
from typing import Any, Literal

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import fft as _fft
from repro_torch.core import im2col as _im2col
from repro_torch.core import registry
from repro_torch.core import winograd as _wg
from repro_torch.core.registry import LayerQuery
from repro_torch.core.transforms import (DEFAULT_OUTPUT_TILE, CookToom,
                                         cook_toom, scaled_cook_toom)
from repro_torch.kernels import ops
from repro_torch.kernels.runtime import ACTIVATIONS as EPILOGUE_ACTIVATIONS
from repro_torch.kernels.runtime import epilogue, resolve_device
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.optim import compression as _comp

Algorithm = Literal["auto", "auto_tuned", "winograd", "winograd_f63", "fft",
                    "im2col", "pallas_winograd",
                    "pallas_winograd_materialized", "pallas_im2col"]
#: The requestable algorithm names (the same as the JAX package's).
ALGORITHMS: tuple[str, ...] = typing.get_args(Algorithm)
Padding = _wg.Padding

#: auto_tuned's fallback crossover, used only where plan-time measurement
#: is impossible (REPRO_PLAN_NO_MEASURE, a CUDA graph capture,
#: torch.compile tracing): winograd wins when the per-point GEMMs are large
#: enough to amortize the transform passes -- enough output pixels AND
#: enough channel depth.
AMORTIZE_MIN_OUT_PIXELS = 1156            # 34 x 34
AMORTIZE_MIN_C_IN = 64

#: Bytes per stored filter value by compute dtype: the stride-1 streaming
#: kernel stages the filter raw, so its blocking depends on them.
FILTER_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def spatial_halo(k: int) -> int:
    """Rows of neighbor overlap a stride-1 SAME kxk conv needs on each side
    of a contiguous H strip to produce that strip's output rows exactly --
    the cross-device analogue of the halo-strip overlap stream_geometry
    derives per tile. Spatial partitioning (core/partition.py) exchanges
    this many rows between mesh neighbors and binds the local plan VALID."""
    return (k - 1) // 2


def winograd_suitable(kh: int, kw: int, stride) -> bool:
    """Whether some winograd-family executor covers this filter/stride
    combination (a registry query; stride-2 layers included, through the
    phase-decomposition executors)."""
    return registry.best_fast(registry.as_query(kh, kw, stride)) is not None


def algorithm_supported(algorithm: str, kh: int, kw: int, stride,
                        *, groups: int = 1, c_in: int | None = None,
                        c_out: int | None = None,
                        layout: str = "NHWC") -> bool:
    """Whether plan_conv2d would accept this (algorithm, layer) combination
    without raising: a registry query. Model-level fallback policies
    (models/cnn.py:_layer_algorithm) consult it."""
    q = registry.as_query(kh, kw, stride, groups=groups, c_in=c_in,
                          c_out=c_out, layout=layout)
    return registry.supported(algorithm, q)


def winograd_amortizes(h: int, w: int, kh: int, kw: int, c_in: int,
                       padding: str = "SAME", groups: int = 1,
                       stride=1) -> bool:
    """The paper's section-4 amortization insight as a static predicate:
    the auto_tuned fallback when nothing may be measured. Depthwise layers
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
# Process-level spec cache and planning counters
# ---------------------------------------------------------------------------

#: ConvSpec / SeparableSpec / DepthwiseConv1DSpec by planning key. A conv
#: key holds every plan_conv2d input that decides the spec and the card
#: the kernels' blocking is sized for (device type and multiprocessor
#: count), so a spec made for one card is never reused for another.
_SPEC_CACHE: dict[tuple, Any] = {}
_CACHE_HITS = 0
_CACHE_MISSES = 0
# Serialized-plan (NetworkPlan artifact) load counters: a hit is a
# successful NetworkPlan.load / compile(..., artifact=) warm start, a miss
# is a load that had to fall back to a cold compile (file absent, header
# mismatch, corrupt array). Maintained by core/compile.py via
# record_artifact_load.
_ARTIFACT_HITS = 0
_ARTIFACT_MISSES = 0
# auto_tuned resolutions: 'measured' counts decisions backed by the
# plan-time timing race, 'fallback' those made without one (the heuristic
# where nothing may be measured, or the sole-candidate im2col case). Plans
# rebuilt from an artifact count neither.
_MEASURED = 0
_FALLBACK = 0
# int8 weight-quantization passes (one per int8 _bind_weights); warm
# artifact loads take the quantized payload verbatim.
_QUANTIZED = 0
# auto_tuned resolutions adopted from an installed tuning database (zero
# local measurements); such a resolution counts neither 'measured' nor
# 'fallback'.
_TUNINGDB_HITS = 0


def plan_cache_info() -> dict:
    """{'hits', 'misses', 'size'} of the process-level spec cache,
    {'artifact_hits', 'artifact_misses'} of serialized-plan loads
    (NetworkPlan.load / compile(..., artifact=) warm starts),
    {'measured', 'fallback'} auto_tuned resolutions (the timing race
    against the no-measurement fallback), {'tuningdb_hits'} resolutions
    adopted from an installed tuning database, and {'quantized'} plan-time
    int8 weight-quantization passes -- the JAX package's nine keys."""
    return {"hits": _CACHE_HITS, "misses": _CACHE_MISSES,
            "size": len(_SPEC_CACHE),
            "artifact_hits": _ARTIFACT_HITS,
            "artifact_misses": _ARTIFACT_MISSES,
            "measured": _MEASURED, "fallback": _FALLBACK,
            "tuningdb_hits": _TUNINGDB_HITS,
            "quantized": _QUANTIZED}


def _record_autotune_resolution(measured: bool) -> None:
    global _MEASURED, _FALLBACK
    if measured:
        _MEASURED += 1
        _obs_metrics.count("plan.autotune.measured")
    else:
        _FALLBACK += 1
        _obs_metrics.count("plan.autotune.fallback")


def record_artifact_load(hit: bool) -> None:
    """Count one serialized-plan load attempt (see plan_cache_info),
    mirrored into the default metrics registry."""
    global _ARTIFACT_HITS, _ARTIFACT_MISSES
    if hit:
        _ARTIFACT_HITS += 1
        _obs_metrics.count("plan.artifact.hit")
    else:
        _ARTIFACT_MISSES += 1
        _obs_metrics.count("plan.artifact.miss")


def clear_plan_cache() -> None:
    """Empty the spec cache and reset every counter of plan_cache_info.
    An installed tuning database stays installed."""
    global _CACHE_HITS, _CACHE_MISSES, _ARTIFACT_HITS, _ARTIFACT_MISSES, \
        _MEASURED, _FALLBACK, _QUANTIZED, _TUNINGDB_HITS
    _SPEC_CACHE.clear()
    _CACHE_HITS = _CACHE_MISSES = 0
    _ARTIFACT_HITS = _ARTIFACT_MISSES = 0
    _MEASURED = _FALLBACK = 0
    _QUANTIZED = 0
    _TUNINGDB_HITS = 0


def _cache_enabled() -> bool:
    return not os.environ.get("REPRO_PLAN_NO_CACHE")


def _count_cache(hit: bool) -> None:
    """Spec-cache accounting, mirrored into the default metrics registry
    (plan.cache.hit / plan.cache.miss)."""
    global _CACHE_HITS, _CACHE_MISSES
    if hit:
        _CACHE_HITS += 1
        _obs_metrics.count("plan.cache.hit")
    else:
        _CACHE_MISSES += 1
        _obs_metrics.count("plan.cache.miss")


def _cached_spec(key: tuple, build):
    """The cached spec under `key`, else build(), stored unless the cache
    is disabled; the hit or miss is counted."""
    spec = _SPEC_CACHE.get(key) if _cache_enabled() else None
    _count_cache(spec is not None)
    if spec is None:
        spec = build()
        if _cache_enabled():
            _SPEC_CACHE[key] = spec
    return spec


def _measure_allowed() -> bool:
    """Measured autotuning needs eager execution: it is off under
    REPRO_PLAN_NO_MEASURE, while a CUDA stream is capturing a graph and
    while torch.compile traces (the counterparts of planning inside a jit
    trace)."""
    if os.environ.get("REPRO_PLAN_NO_MEASURE"):
        return False
    if torch.compiler.is_compiling():
        return False
    return not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())


# ---------------------------------------------------------------------------
# Tuning database: adopt measured auto_tuned evidence without racing
# ---------------------------------------------------------------------------

#: Installed database entries ({tuning_db_key: entry}); None means no
#: database, and plan_conv2d measures (or falls back) as always.
_TUNING_DB: dict[str, dict] | None = None
#: The last REPRO_TUNING_DB path loaded, so a path is read once per value.
_TUNING_DB_ENV_PATH: str | None = None


def tuning_db_key(x_shape, w_shape, dtype: str, stride, padding: str,
                  groups: int, layout: str, compute_request: str,
                  output_tile=None) -> str:
    """The database key: every plan_conv2d input that decides an auto_tuned
    race. `compute_request` is the caller's compute_dtype request ("auto"
    when reduced-precision contenders were fielded), `output_tile` the
    requested (not the tuned) tile. The JAX package's key, character for
    character."""
    if output_tile is None:
        ot = None
    elif isinstance(output_tile, (tuple, list)):
        ot = [int(v) for v in output_tile]
    else:
        ot = [int(output_tile), int(output_tile)]
    return json.dumps(
        [list(x_shape), list(w_shape), str(dtype),
         list(stride) if isinstance(stride, (tuple, list))
         else [stride, stride],
         str(padding), int(groups), str(layout), str(compute_request), ot],
        separators=(",", ":"))


def set_tuning_db(entries: dict | None) -> None:
    """Install (or with None remove) tuning-database entries. They stay
    installed across clear_plan_cache(): the database is configuration,
    not cache state."""
    global _TUNING_DB
    _TUNING_DB = dict(entries) if entries is not None else None


def tuning_db() -> dict | None:
    _maybe_load_env_tuning_db()
    return _TUNING_DB


def _maybe_load_env_tuning_db() -> None:
    global _TUNING_DB, _TUNING_DB_ENV_PATH
    path = os.environ.get("REPRO_TUNING_DB")
    if _TUNING_DB is not None or not path or path == _TUNING_DB_ENV_PATH:
        return
    _TUNING_DB_ENV_PATH = path
    try:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("format") == "repro.tuning_db":
            _TUNING_DB = dict(doc.get("entries") or {})
    except (OSError, ValueError):
        pass                     # an unreadable database is no database


def _tuningdb_lookup(x_shape, w_shape, dtype: str, stride, padding: str,
                     groups: int, layout: str, compute_request: str,
                     output_tile) -> tuple | None:
    """A validated database resolution shaped like _measure_autotune's
    return -- (winner, winner_tile, winner_dtype, evidence) -- or None (no
    database, no entry, or an entry naming an executor or dtype this
    registry does not cover)."""
    global _TUNINGDB_HITS
    _maybe_load_env_tuning_db()
    if _TUNING_DB is None:
        return None
    entry = _TUNING_DB.get(tuning_db_key(
        x_shape, w_shape, dtype, stride, padding, groups, layout,
        compute_request, output_tile))
    if not entry:
        return None
    winner = entry.get("winner")
    winner_dtype = str(entry.get("winner_dtype", "float32"))
    known = {cap.executor for cap in registry.CAPABILITIES}
    if winner not in known or \
            winner_dtype not in registry.compute_dtypes_for(winner):
        return None               # stale evidence: race locally
    if compute_request not in ("auto", "float32") and \
            compute_request not in registry.compute_dtypes_for(winner):
        return None               # the winner can't serve the pinned dtype
    tile = entry.get("winner_tile")
    evidence = tuple(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in (entry.get("evidence") or []) if k != "source")
    evidence += (("source", "tuning_db"),)
    _TUNINGDB_HITS += 1
    _obs_metrics.count("plan.autotune.tuningdb_hit")
    _obs_trace.instant("plan.autotune.tuningdb_hit", winner=winner,
                       layer=f"{tuple(x_shape)}x{tuple(w_shape)}")
    return winner, tuple(tile) if tile else None, winner_dtype, evidence


def _sm_count(device: torch.device) -> int:
    """Multiprocessors of the card a plan is made for; the H100's count for
    a CPU plan. The kernels' blocking is sized for it."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return _wg.H100_SMS


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
    fft: Any = None                   # fft.FFTGeometry of the rfft2
                                      # executor (re-derived from
                                      # output_tile on an artifact load)
    autotune: tuple | None = None     # (("t_winograd_s", ...), ...) measured
                                      # evidence behind an auto_tuned choice

    @property
    def autotune_report(self) -> dict | None:
        return dict(self.autotune) if self.autotune is not None else None


def _resolve_output_tile(kh: int, kw: int, output_tile) -> tuple[int, int]:
    if output_tile is None:
        mt = DEFAULT_OUTPUT_TILE.get(max(kh, kw), 2)
        return (mt, mt)
    if isinstance(output_tile, int):
        return (output_tile, output_tile)
    return tuple(output_tile)


#: Shape thresholds below/above which the stride-2 executors default to the
#: F(2, r_ph) tile set instead of F(4, r_ph), as in the JAX package: the
#: larger tile cuts the multiplies per output, but on small output grids
#: its point-GEMMs are too thin to amortize the transforms and on deep
#: layers its four t = 5 phase banks crowd the blocking.
STRIDED_TILE4_MIN_OUT = 24
STRIDED_TILE4_MAX_C = 64


def _resolve_strided_tile(h: int, w: int, kh: int, kw: int, padding,
                          output_tile, c_in: int) -> tuple[int, int]:
    """Output tile of the stride-2 phase algorithm (per-axis F(m, r_ph),
    r_ph = (k+1)//2): an explicit request wins; the default is F(4, .) on
    large-spatial shallow layers, F(2, .) everywhere else."""
    if output_tile is not None:
        if isinstance(output_tile, int):
            return (output_tile, output_tile)
        return tuple(output_tile)
    out_h = _wg.strided_out_size(h, kh, padding)
    out_w = _wg.strided_out_size(w, kw, padding)
    mt = 4 if (min(out_h, out_w) >= STRIDED_TILE4_MIN_OUT
               and c_in <= STRIDED_TILE4_MAX_C) else 2
    return (mt, mt)


def _restored(saved: dict | None, choose):
    """The kernel blocking recorded in an artifact's meta (`saved`), else
    the chooser's: (blocks, stream) with `stream` a StreamGeometry or None.
    `choose()` returns the same pair and runs only without a record, so a
    load re-plans nothing."""
    if saved is None:
        return choose()
    stream = saved.get("stream")
    return (tuple(saved["blocks"]) if saved.get("blocks") else None,
            _wg.StreamGeometry(*stream) if stream else None)


def _blocking_meta(blocks, stream) -> dict:
    """The JSON record of a spec's kernel blocking (see _restored)."""
    return {"blocks": list(blocks) if blocks else None,
            "stream": list(stream) if stream else None}


def _build_spec(x_shape, w_shape, dtype, stride, padding, requested,
                resolved, output_tile, groups: int = 1,
                layout: str = "NHWC",
                compute_dtype: str = "float32",
                sms: int = _wg.H100_SMS,
                saved: dict | None = None) -> ConvSpec:
    """Materialize the geometry / transform / blocking decisions of one
    resolved executor; `sms` is the card's multiprocessor count, which the
    streaming kernels' blocking is sized for. `saved`, an artifact's meta,
    supplies the blocking instead of the choosers (ConvPlan.from_artifact).
    """
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

    if resolved in ("winograd_strided", "pallas_winograd_strided",
                    "pallas_depthwise_strided"):
        # shared stride-2 derivation: phase tile set F(m, (k+1)/2) and the
        # full-resolution phase geometry; only the blocking differs per
        # executor.
        mh, mw = _resolve_strided_tile(h, w, kh, kw, padding, output_tile, c)
        ct_h = cook_toom(mh, (kh + 1) // 2)
        ct_w = cook_toom(mw, (kw + 1) // 2)
        geom = _wg.conv2d_strided_geometry(h, w, kh, kw, mh, mw, padding)
        strided = dict(algorithm=resolved, output_tile=(mh, mw), ct_h=ct_h,
                       ct_w=ct_w, geometry=geom, **base)
        if resolved == "pallas_winograd_strided":
            blocks, stream = _restored(saved, lambda: _tc_blocking(
                _wg.stream_geometry_tf32x3(
                    geom.n_h, geom.n_w, c, mout, ct_h, ct_w, batch=n,
                    sms=sms, u_size=FILTER_BYTES[compute_dtype],
                    phases=4)))
            return ConvSpec(stream=stream, blocks=blocks, **strided)
        if resolved == "pallas_depthwise_strided":
            blocks, stream = _restored(saved, lambda: _dw_blocking(
                _wg.stream_geometry_depthwise(geom.n_h, geom.n_w, c, ct_h,
                                              ct_w, stride=2, batch=n,
                                              sms=sms)))
            return ConvSpec(stream=stream, blocks=blocks, **strided)
        return ConvSpec(**strided)

    if resolved in ("winograd", "winograd_depthwise", "winograd_grouped",
                    "pallas_winograd", "pallas_depthwise",
                    "pallas_winograd_materialized"):
        # shared stride-1 derivation: F(m, k) transform set and the conv
        # padding / tile counts; the kernels add their blocking, once.
        mh, mw = _resolve_output_tile(kh, kw, output_tile)
        ct_h, ct_w = cook_toom(mh, kh), cook_toom(mw, kw)
        geom = _wg.conv2d_geometry(h, w, kh, kw, mh, mw, padding)
        tiled = dict(algorithm=resolved, output_tile=(mh, mw), ct_h=ct_h,
                     ct_w=ct_w, geometry=geom, **base)
        if resolved == "pallas_winograd":
            blocks, stream = _restored(saved, lambda: _tc_blocking(
                _wg.stream_geometry_tf32x3(
                    geom.n_h, geom.n_w, c, mout, ct_h, ct_w, batch=n,
                    sms=sms, u_size=FILTER_BYTES[compute_dtype])))
            return ConvSpec(stream=stream, blocks=blocks, **tiled)
        if resolved == "pallas_depthwise":
            blocks, stream = _restored(saved, lambda: _dw_blocking(
                _wg.stream_geometry_depthwise(geom.n_h, geom.n_w, c, ct_h,
                                              ct_w, mult=mout // c,
                                              batch=n, sms=sms)))
            return ConvSpec(stream=stream, blocks=blocks, **tiled)
        if resolved == "pallas_winograd_materialized":
            blocks, _ = _restored(saved, lambda: (_wg.winograd_blocks(
                n * geom.n_h * geom.n_w, c, mout, ct_h, ct_w, sms=sms),
                None))
            return ConvSpec(blocks=blocks, **tiled)
        return ConvSpec(**tiled)

    if resolved == "winograd_f63":
        # large-tile F(6x6, 3x3): the "winograd" executor with the
        # row-scaled transform set that holds the fp32 error budget at t = 8
        ct_h, ct_w = scaled_cook_toom(6, kh), scaled_cook_toom(6, kw)
        geom = _wg.conv2d_geometry(h, w, kh, kw, 6, 6, padding)
        return ConvSpec(algorithm="winograd_f63", output_tile=(6, 6),
                        ct_h=ct_h, ct_w=ct_w, geometry=geom, **base)

    if resolved == "fft":
        # rfft2 overlap-tiled executor: the transform lengths are the one
        # decision, and output_tile persists them (fft = m + k - 1)
        fftg = _fft.choose_fft_geometry(
            h, w, kh, kw,
            output_tile=(tuple(output_tile)
                         if isinstance(output_tile, (tuple, list))
                         else ((output_tile, output_tile)
                               if output_tile else None)))
        geom = _wg.conv2d_fft_geometry(h, w, kh, kw, fftg.fft_h, fftg.fft_w,
                                       padding)
        return ConvSpec(algorithm="fft", output_tile=(fftg.m_h, fftg.m_w),
                        geometry=geom, fft=fftg, **base)

    if resolved == "winograd_1d":
        # 1xN / Nx1: single-axis Cook-Toom, plain PyTorch (the streamed
        # families declare this executor too: its GEMM is one batched
        # matmul)
        axis = 1 if kh > 1 else 2
        mh, mw = _resolve_output_tile(kh, kw, output_tile)
        m = (mh, mw)[axis - 1]
        ct = cook_toom(m, max(kh, kw))
        geom = _wg.conv1d_axis_geometry(x_shape[axis], axis, max(kh, kw), m,
                                        padding)
        return ConvSpec(algorithm="winograd_1d", output_tile=(m, m), ct_w=ct,
                        geometry=geom, **base)

    if resolved == "im2col":
        geom = _im2col.im2row_geometry(h, w, kh, kw, stride, padding)
        return ConvSpec(algorithm="im2col", geometry=geom, **base)

    if resolved == "pallas_im2col":
        # the GEMM kernel's (block_m, bk, block_n, splits) tile and K split,
        # chosen for this layer's (M, K, N); B pads to
        # core/im2col.py:matmul_b_shape
        geom = _im2col.im2row_geometry(h, w, kh, kw, stride, padding)
        blocks, _ = _restored(saved, lambda: (_im2col.matmul_blocks(
            n * geom.oh * geom.ow, kh * kw * c, mout,
            u_size=FILTER_BYTES[compute_dtype], sms=sms), None))
        return ConvSpec(algorithm="pallas_im2col", geometry=geom,
                        blocks=blocks, **base)

    raise ValueError(f"unknown algorithm {resolved!r}")


def _tc_blocking(stream) -> tuple:
    """(blocks, stream) of the tensor-core streaming kernels."""
    return (stream.bh * stream.bw, stream.block_c, stream.block_m), stream


def _dw_blocking(stream) -> tuple:
    """(blocks, stream) of the depthwise streaming kernels."""
    return (stream.bh * stream.bw, stream.block_c), stream


def _to_artifact(t: torch.Tensor) -> np.ndarray:
    """A plan buffer as an artifact array: bf16 as its int16 bit pattern
    (numpy has no bfloat16); from_artifact views it back."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_artifact(a, device: torch.device,
                   bfloat16: bool = False) -> torch.Tensor:
    """An artifact array as a plan buffer on `device` (see _to_artifact).
    The JAX package saves bf16 as ml_dtypes.bfloat16, which np.load returns
    as raw 2-byte voids: their bytes are read as bf16 whatever the flag."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(
            np.frombuffer(a.tobytes(), np.int16).reshape(a.shape).copy()
        ).view(torch.bfloat16).to(device)
    t = torch.from_numpy(np.array(a))
    if bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def _crop(t: torch.Tensor, shape) -> torch.Tensor:
    """The leading `shape` corner of `t`: a padded execution-domain array
    cut back to its logical extent."""
    return t[tuple(slice(0, n) for n in shape)]


def _pad_to(t: torch.Tensor, shape, value: float = 0) -> torch.Tensor:
    """`t` padded at the end of each axis up to `shape`."""
    pads = []
    for have, want in reversed(list(zip(t.shape, shape))):
        pads += [0, want - have]
    return F.pad(t, pads, value=value).contiguous()


def _sub_arrays(arrays: dict, prefix: str) -> dict:
    """Select the `prefix`-namespaced entries of a nested artifact's array
    dict, prefix stripped."""
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _depthwise_domain_taps(w: torch.Tensor, ct_h: CookToom, ct_w: CookToom,
                           c_in: int, c_pad: int) -> torch.Tensor:
    """(kh, kw, 1, C) depthwise filter -> (P, Cp) Winograd-domain taps,
    channel-padded to the kernel's block grid: the fused separable block's
    depthwise operand."""
    u = _wg.transform_filter_2d(w, ct_h, ct_w)            # (th, tw, 1, C)
    u = u.reshape(ct_h.t * ct_w.t, c_in)
    return F.pad(u, (0, c_pad - c_in))


def _is_depthwise(spec: ConvSpec) -> bool:
    return spec.groups > 1 and spec.groups == spec.x_shape[3]


def _domain_filter(spec: ConvSpec, w: torch.Tensor) -> torch.Tensor:
    """Transform the filter into the spec's execution domain (fp32), once
    per plan; ConvPlan.apply never touches it again."""
    kh, kw, c, mout = spec.w_shape     # c = C/groups (HWIO grouped filter)
    c_in = spec.x_shape[3]
    if spec.algorithm in ("winograd", "winograd_f63", "winograd_grouped"):
        return _wg.transform_filter_2d(w, spec.ct_h, spec.ct_w)
    if spec.algorithm == "fft":
        return _fft.fft_transform_filter(w, spec.fft.fft_h, spec.fft.fft_w)
    if spec.algorithm == "winograd_1d":
        return _wg.transform_filter_1d(w.reshape(max(kh, kw), c, mout),
                                       spec.ct_w)            # (t, C, M)
    if spec.algorithm == "winograd_depthwise":
        u = _wg.transform_filter_2d(w, spec.ct_h, spec.ct_w)  # (th, tw, 1, M)
        return u.reshape(spec.ct_h.t, spec.ct_w.t, c_in, mout // c_in)
    if spec.algorithm == "winograd_strided":
        u = _wg.strided_phase_filters(w, spec.ct_h, spec.ct_w)
        if _is_depthwise(spec):
            # the channel axis made explicit: (2, 2, th, tw, C, mult)
            return u.reshape(*u.shape[:4], c_in, mout // c_in)
        return u                                  # (2, 2, th, tw, Cg, M)
    if spec.algorithm in ("pallas_winograd_strided",
                          "pallas_depthwise_strided"):
        u = _wg.strided_phase_filters(w, spec.ct_h, spec.ct_w)
    elif spec.algorithm in ("pallas_depthwise", "pallas_winograd",
                            "pallas_winograd_materialized"):
        u = _wg.transform_filter_2d(w, spec.ct_h, spec.ct_w)
    elif spec.algorithm == "im2col":
        if spec.groups > 1:
            return _im2col.grouped_filter_matrix(w, spec.groups)
        return w.reshape(kh * kw * c, mout)
    elif spec.algorithm == "pallas_im2col":
        u = w
    else:
        raise ValueError(spec.algorithm)
    return _pad_domain(spec, u.reshape(_padded_layout(spec)))


def _padded_layout(spec: ConvSpec) -> tuple[int, ...] | None:
    """The logical shape of the execution-domain filter of the kernel
    executors, which pad it to their blocking (_pad_domain); None for the
    executors that store it unpadded."""
    kh, kw, c, mout = spec.w_shape
    c_in = spec.x_shape[3]
    alg = spec.algorithm
    if alg in ("pallas_winograd", "pallas_winograd_materialized"):
        return (spec.ct_h.t * spec.ct_w.t, c, mout)
    if alg == "pallas_winograd_strided":
        return (4 * spec.ct_h.t * spec.ct_w.t, c, mout)    # phase-major
    if alg == "pallas_depthwise":
        # (kh, kw, 1, C*mult) -> (P, C, mult): output channel o = c*mult + j
        # (HWIO order), so the reshape peels the multiplier off last.
        return (spec.ct_h.t * spec.ct_w.t, c_in, mout // c_in)
    if alg == "pallas_depthwise_strided":
        return (4 * spec.ct_h.t * spec.ct_w.t, c_in)       # (4P, C)
    if alg == "pallas_im2col":
        return (kh * kw * c, mout)
    return None


def _pad_domain(spec: ConvSpec, u: torch.Tensor) -> torch.Tensor:
    """A logical execution-domain filter (_padded_layout) padded to the
    kernel's block grid, once at plan time."""
    alg = spec.algorithm
    if alg in ("pallas_winograd", "pallas_winograd_materialized",
               "pallas_winograd_strided"):
        return ops.pad_winograd_filter(u, spec.blocks[1], spec.blocks[2])
    if alg == "pallas_depthwise_strided":
        return F.pad(u, (0, spec.stream.c_pad - u.shape[1]))
    if alg == "pallas_depthwise":
        return F.pad(u, (0, 0, 0, spec.stream.c_pad - u.shape[1]))
    if alg == "pallas_im2col":
        return ops.pad_im2col_filter(u, spec.blocks[2])
    return u


def _adopt_foreign(spec: ConvSpec, u: torch.Tensor,
                   scale: torch.Tensor | None):
    """A filter (and int8 scale) the JAX package saved, padded to ITS
    kernels' blocking, re-padded for this spec's: cropped to the logical
    C / M (_padded_layout), padded again by _pad_domain. Padding adds zero
    channels, so the int8 codes and the real channels' scales are the
    saved ones; a pad channel's scale is 1.0, the quantizer's value for an
    all-zero channel."""
    logical = _padded_layout(spec)
    if logical is None:
        return u, scale
    saved = u
    u = _pad_domain(spec, _crop(saved, logical))
    if scale is not None:
        axes = tuple(a % u.dim() for a in _quantize_axes(spec)[0])
        s = scale.reshape([saved.shape[a] for a in axes])
        s = _pad_to(_crop(s, [logical[a] for a in axes]),
                    [u.shape[a] for a in axes], value=1.0)
        scale = s.reshape(1, -1)          # the kernels' (1, Mp) row
    return u, scale


def _quantize_axes(spec: ConvSpec) -> tuple[tuple[int, ...], str]:
    """(channel_axes, scale_form) of the int8 per-output-channel quantizer:
    `channel_axes` together enumerate output channels (depthwise layouts
    split them into (C, mult)); 'flat' is one f32 per output channel
    broadcast by ConvPlan._dequantize, 'row' a (1, M_padded) kernel operand
    beside the bias."""
    alg = spec.algorithm
    if alg in ("winograd", "winograd_1d", "winograd_grouped"):
        return (-1,), "flat"
    if alg == "im2col":           # grouped: (G, K, M/G), channels (G, M/G)
        return ((0, 2) if spec.groups > 1 else (-1,)), "flat"
    if alg == "winograd_depthwise":
        return (-2, -1), "flat"
    if alg == "winograd_strided":
        return ((-2, -1) if _is_depthwise(spec) else (-1,)), "flat"
    if alg in ("pallas_winograd", "pallas_winograd_strided",
               "pallas_depthwise_strided", "pallas_im2col"):
        return (-1,), "row"
    if alg == "pallas_depthwise":
        return (-2, -1), "row"
    raise ValueError(
        f"executor {alg!r} has no int8 transform-domain path")


def _bind_weights(spec: ConvSpec, w: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Filter -> (execution-domain filter, dequantization scale). fp32 plans
    get (fp32 u, None); bf16 plans downcast the transformed filter; int8
    plans quantize per output channel AFTER the transform and padding, so
    `u_int8 * scale` reproduces the fp32 transformed filter up to rounding
    and the hot path dequantizes with one per-channel multiply in the
    epilogue. Each int8 pass counts in plan_cache_info()["quantized"]."""
    global _QUANTIZED
    u = _domain_filter(spec, w)
    cd = spec.compute_dtype
    if cd == "float32":
        return u.contiguous(), None
    if cd == "bfloat16":
        return u.to(torch.bfloat16).contiguous(), None
    if cd == "int8":
        axes, form = _quantize_axes(spec)
        q, scale = _comp.quantize_channelwise(u, channel_axes=axes)
        _QUANTIZED += 1
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
        streamed = {"pallas_winograd": ops.winograd_conv2d_planned,
                    "pallas_winograd_strided":
                        ops.winograd_strided_conv2d_planned,
                    "pallas_depthwise": ops.depthwise_conv2d_planned,
                    "pallas_depthwise_strided":
                        ops.depthwise_strided_conv2d_planned}
        if alg in streamed:
            return streamed[alg](
                x, self.u, ct_h=spec.ct_h, ct_w=spec.ct_w,
                geometry=spec.geometry, stream=spec.stream,
                c_out=spec.w_shape[3], bias=bias, activation=activation,
                scale=self.scale)
        if alg == "pallas_winograd_materialized":
            # the tiles-domain kernel has no epilogue
            y = ops.winograd_conv2d_planned_materialized(
                x, self.u, ct_h=spec.ct_h, ct_w=spec.ct_w,
                geometry=spec.geometry, blocks=spec.blocks,
                c_out=spec.w_shape[3])
            return epilogue(y, bias, activation)
        if alg == "pallas_im2col":
            kh, kw, _, mout = spec.w_shape
            return ops.im2col_conv2d_planned(
                x, self.u, kh=kh, kw=kw, stride=spec.stride,
                padding=spec.padding, geometry=spec.geometry,
                blocks=spec.blocks, c_out=mout,
                bias=bias, scale=self.scale, activation=activation)
        if alg in ("winograd", "winograd_f63"):
            y = _wg.winograd_conv2d_pretransformed(
                x, self.u, spec.ct_h, spec.ct_w, padding=spec.padding,
                geometry=spec.geometry)
            return epilogue(self._dequantize(y), bias, activation)
        if alg == "fft":
            y = _fft.fft_conv2d_pretransformed(
                x, self.u, spec.fft, padding=spec.padding,
                geometry=spec.geometry)
            return epilogue(y, bias, activation)
        if alg == "winograd_grouped":
            y = _wg.winograd_grouped_conv2d_pretransformed(
                x, self.u, spec.ct_h, spec.ct_w, spec.groups,
                padding=spec.padding, geometry=spec.geometry)
            return epilogue(self._dequantize(y), bias, activation)
        if alg == "winograd_1d":
            y = _wg.winograd_conv1d_axis_pretransformed(
                x, self.u, spec.ct_w, spec.geometry)
            return epilogue(self._dequantize(y), bias, activation)
        if alg == "winograd_depthwise":
            y = _wg.winograd_depthwise_conv2d_pretransformed(
                x, self.u, spec.ct_h, spec.ct_w, padding=spec.padding,
                geometry=spec.geometry)
            return epilogue(self._dequantize(y), bias, activation)
        if alg == "winograd_strided":
            y = _wg.winograd_strided_conv2d_pretransformed(
                x, self.u, spec.ct_h, spec.ct_w, groups=spec.groups,
                geometry=spec.geometry)
            return epilogue(self._dequantize(y), bias, activation)
        if alg == "im2col":
            geom = spec.geometry
            kh, kw, _, mout = spec.w_shape
            if spec.groups > 1:
                a, _ = _im2col.grouped_im2row(x, kh, kw, spec.stride,
                                              spec.padding, spec.groups, geom)
                a = a.transpose(0, 1)             # (G, R, K) x (G, K, M/G)
            else:
                a, _ = _im2col.im2row(x, kh, kw, spec.stride, spec.padding,
                                      geom)
            if self.u.dtype == torch.bfloat16:
                a = a.to(torch.bfloat16)          # bf16 operands, fp32 sums
            y = torch.matmul(a.float(), self.u.float())
            if spec.groups > 1:
                y = y.transpose(0, 1)             # (R, G, M/G): o = g*M/G + j
            y = y.reshape(x.shape[0], geom.oh, geom.ow, mout).to(x.dtype)
            return epilogue(self._dequantize(y), bias, activation)
        raise ValueError(alg)

    @property
    def algorithm(self) -> str:
        return self.spec.algorithm

    @property
    def out_shape(self) -> tuple[int, ...]:
        spec, g = self.spec, self.spec.geometry
        n, mout = spec.x_shape[0], spec.w_shape[-1]
        if spec.algorithm in ("im2col", "pallas_im2col"):
            shape = (n, g.oh, g.ow, mout)
        elif spec.algorithm == "winograd_1d":     # only the filter's axis
            h, w = spec.x_shape[1:3]
            shape = ((n, g.out_size, w, mout) if g.axis == 1
                     else (n, h, g.out_size, mout))
        else:
            shape = (n, g.out_h, g.out_w, mout)
        if spec.layout == "NCHW":
            return (shape[0], shape[3], shape[1], shape[2])
        return shape

    def describe(self, kernel: bool = False) -> dict:
        """The plan's row of the algorithm table; with `kernel`, a streamed
        tensor-core plan also names the kernel body that runs it ("ws" or
        "tc", core/winograd.py:stream_body) and its (bR, bC, bM)
        blocking."""
        spec = self.spec
        kh, kw = spec.w_shape[:2]
        if spec.requested == "auto_tuned":
            # how an auto_tuned plan was decided: "measured" carries the
            # race's evidence (spec.autotune_report), "heuristic" means the
            # static fallback decided
            decision = "measured" if spec.autotune is not None else \
                "heuristic"
        else:
            decision = "static"
        row = {"kind": "conv2d", "executor": spec.algorithm,
               "requested": spec.requested, "filter": f"{kh}x{kw}",
               "stride": f"{spec.stride[0]}x{spec.stride[1]}",
               "groups": spec.groups,
               "tile": ("x".join(map(str, spec.output_tile))
                        if spec.output_tile else "-"),
               "decision": decision,
               "compute_dtype": spec.compute_dtype}
        if kernel and spec.algorithm in ("pallas_winograd",
                                         "pallas_winograd_strided"):
            phases = 1 if spec.algorithm == "pallas_winograd" else 4
            s = spec.stream
            row["body"] = _wg.stream_body(spec.ct_h, spec.ct_w, phases)
            row["blocking"] = (s.bh * s.bw, s.block_c, s.block_m)
        return row

    def to_artifact(self) -> tuple[dict, dict]:
        """(meta, arrays): `meta` is the JSON-safe spec record -- every
        decision and the chooser's kernel blocking -- from which
        _build_spec re-derives the geometry; `arrays` is the
        execution-domain filter (the int8 scale beside it; an FFT plan's is
        complex64). Loading re-runs neither the algorithm decision (an
        auto_tuned plan's race evidence is in the meta), the blocking
        choice nor the filter transform."""
        spec = self.spec
        meta = {"kind": "conv2d", "x_shape": list(spec.x_shape),
                "w_shape": list(spec.w_shape), "dtype": spec.dtype,
                "stride": list(spec.stride), "padding": spec.padding,
                "requested": spec.requested, "algorithm": spec.algorithm,
                "groups": spec.groups, "layout": spec.layout,
                "compute_dtype": spec.compute_dtype,
                "output_tile": (list(spec.output_tile)
                                if spec.output_tile else None),
                "autotune": ([list(kv) for kv in spec.autotune]
                             if spec.autotune else None),
                **_blocking_meta(spec.blocks, spec.stream)}
        arrays = {"u": _to_artifact(self.u)}
        if self.scale is not None:
            arrays["scale"] = _to_artifact(self.scale)
        return meta, arrays

    @classmethod
    def from_artifact(cls, meta: dict, arrays: dict, device=None,
                      foreign: bool = False) -> "ConvPlan":
        """Rebuild the plan on `device` (None means the CUDA device) from a
        saved artifact: the geometry is re-derived from the saved resolved
        algorithm and blocking (no chooser runs), and the execution-domain
        filter is taken verbatim -- _bind_weights never runs, so no filter
        transform executes. `foreign` marks an artifact of the JAX package:
        its meta carries no blocking, so the chooser picks this card's, and
        its filter, padded to the JAX kernels' blocking, is cropped and
        re-padded for it (_adopt_foreign)."""
        device = resolve_device(device)
        ot = meta["output_tile"]
        spec = _build_spec(tuple(meta["x_shape"]), tuple(meta["w_shape"]),
                           meta["dtype"], tuple(meta["stride"]),
                           meta["padding"], meta["requested"],
                           meta["algorithm"], tuple(ot) if ot else None,
                           meta["groups"], meta["layout"],
                           meta["compute_dtype"], sms=_sm_count(device),
                           saved=None if foreign else meta)
        if meta.get("autotune"):
            spec = dataclasses.replace(spec, autotune=tuple(
                (k, tuple(v) if isinstance(v, list) else v)
                for k, v in meta["autotune"]))
        scale = (_from_artifact(arrays["scale"], device)
                 if "scale" in arrays else None)
        u = _from_artifact(arrays["u"], device,
                           "bfloat16" in (spec.compute_dtype, spec.dtype))
        if foreign:
            u, scale = _adopt_foreign(spec, u, scale)
        return cls(spec, u, scale)


# ---------------------------------------------------------------------------
# Plan-time measured autotuning (algorithm="auto_tuned")
# ---------------------------------------------------------------------------

def _time_apply(plan: ConvPlan, x: torch.Tensor, warmup: int = 1,
                iters: int = 3) -> float:
    """Best-of-`iters` seconds of one plan.apply(x) after `warmup` calls
    (which absorb one-time work such as a cuFFT plan): CUDA events on the
    card, the host clock on the CPU."""
    with torch.no_grad():
        for _ in range(warmup):
            plan.apply(x)
        best = float("inf")
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                plan.apply(x)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            return best
        for _ in range(iters):
            t0 = time.perf_counter()
            plan.apply(x)
            best = min(best, time.perf_counter() - t0)
        return best


#: Accuracy budgets of a reduced-precision plan: its relative max-abs error
#: against the fp32 plan's output on the same input must stay under budget
#: (the auto_tuned dtype race's gate, and the serving runtime's precision
#: probe). bf16 has ~3 decimal digits of mantissa; int8's budget also
#: absorbs the per-channel quantization grid.
AUTOTUNE_ACCURACY_BUDGET = {"bfloat16": 3e-2, "int8": 6e-2}

_DTYPE_LABEL = {"bfloat16": "bf16", "int8": "int8"}


def _autotune_contenders(x_shape, w_shape, stride, groups,
                         output_tile, fast: str,
                         pin_dtype: str = "float32",
                         dtype_race: bool = False) -> list[tuple]:
    """(label, executor, output_tile, compute_dtype) contenders of the
    N-way auto_tuned race: the registry-matched plain winograd-family
    executor at its default tile, its F(2, 3) variant (dense 3x3), the
    F(6, 3) executor, the rfft2 executor, the im2row baseline, and the fast
    executor's bf16 / int8 variants where its capability declares them --
    each only where the registry covers the layer. The labels key the
    evidence (t_<label>_s; the dtype contenders also err_<label>)."""
    kh, kw = w_shape[:2]
    q = LayerQuery(kh=kh, kw=kw, stride=stride, groups=groups,
                   c_in=x_shape[3], c_out=w_shape[3])
    entries = [("winograd", fast, output_tile, "float32")]
    if fast == "winograd" and output_tile is None and (kh, kw) == (3, 3):
        entries.append(("winograd_f2", "winograd", 2, "float32"))
    if registry.supported("winograd_f63", q):
        entries.append(("f63", "winograd_f63", None, "float32"))
    if registry.supported("fft", q):
        entries.append(("fft", "fft", None, "float32"))
    entries.append(("im2col", "im2col", None, "float32"))
    if dtype_race or pin_dtype != "float32":
        # reduced-precision contenders are opt-in: the default race keeps
        # fp32 numerics. compute_dtype="auto" opts in; a pinned reduced
        # dtype fields its own variant, so the race times what the pinned
        # build will run.
        fast_dts = registry.compute_dtypes_for(fast)
        for dt in ("bfloat16", "int8"):
            if dt in fast_dts:
                entries.append((f"winograd_{_DTYPE_LABEL[dt]}", fast,
                                output_tile, dt))
    if pin_dtype != "float32":
        # a pinned reduced dtype drops the contenders that cannot run it
        entries = [e for e in entries
                   if pin_dtype in registry.compute_dtypes_for(e[1])]
    return entries


def _measure_autotune(x_shape, w_shape, dtype: str, stride, padding,
                      output_tile, groups: int = 1,
                      fast: str = "winograd",
                      pin_dtype: str = "float32",
                      dtype_race: bool = False, *,
                      device: torch.device = torch.device("cpu"),
                      sms: int = _wg.H100_SMS
                      ) -> tuple[str, Any, str, tuple]:
    """Time every contender of _autotune_contenders on the real layer shape
    on `device`; return (winner executor, winner output_tile, winner
    compute_dtype, evidence). Runs once per shape per process (the spec
    cache holds the result), and the evidence is persisted in artifacts, so
    a warm load measures nothing.

    The inputs are the JAX package's: numpy seed 0, x standard normal, w
    standard normal / (kh * kw). A reduced-precision contender is held to
    the fp32 `winograd` contender's output first and dropped from the race
    (its err_<label> still recorded) when its relative max-abs error is
    over AUTOTUNE_ACCURACY_BUDGET. A failing `winograd` or `im2col`
    contender raises; any other failing contender is left out."""
    rng = np.random.default_rng(0)
    tdt = getattr(torch, dtype)
    x = torch.as_tensor(rng.standard_normal(x_shape), dtype=tdt,
                        device=device)
    w = torch.as_tensor(rng.standard_normal(w_shape)
                        / (w_shape[0] * w_shape[1]), dtype=tdt,
                        device=device)
    times: dict[str, tuple[float, str, Any, str]] = {}
    errs: list[tuple[str, float]] = []
    y_ref = None   # the fp32 fast contender's output, the dtype gate's oracle

    def host(y):
        return y.float().cpu().numpy()

    for label, alg, ot, cd in _autotune_contenders(x_shape, w_shape, stride,
                                                   groups, output_tile,
                                                   fast, pin_dtype,
                                                   dtype_race):
        try:
            spec = _build_spec(x_shape, w_shape, dtype, stride, padding, alg,
                               alg, ot, groups, compute_dtype=cd, sms=sms)
            u, scale = _bind_weights(spec, w)
            plan = ConvPlan(spec, u, scale)
            if cd != "float32":
                if y_ref is None:
                    continue   # no fp32 oracle -> no gated contender
                with torch.no_grad():
                    y = host(plan.apply(x))
                err = float(np.max(np.abs(y - y_ref))
                            / (np.max(np.abs(y_ref)) or 1.0))
                errs.append((f"err_{label}", err))
                if err > AUTOTUNE_ACCURACY_BUDGET[cd]:
                    continue   # the accuracy gate: may not win the race
            t = _time_apply(plan, x)
            if label == "winograd":
                with torch.no_grad():
                    y_ref = host(plan.apply(x))
        except Exception:
            if label in ("winograd", "im2col"):
                raise  # the two contenders every eligible layer must have
            continue
        times[label] = (t, spec.algorithm, spec.output_tile, cd)
    win = min(times, key=lambda k: times[k][0])
    _, winner, winner_tile, winner_dtype = times[win]
    evidence = [(f"t_{label}_s", times[label][0]) for label in times]
    evidence.extend(errs)
    # winner: the resolved executor; winner_label: the contender that won
    # (they differ when e.g. the F(2, 3) variant of the same executor wins)
    evidence.append(("winner_label", win))
    evidence.append(("winner", winner))
    evidence.append(("winner_dtype", winner_dtype))
    if winner_tile is not None:
        evidence.append(("winner_tile", tuple(winner_tile)))
    # the race's identity, so a tuning database can rebuild the request
    evidence.append(("pin_dtype", pin_dtype))
    evidence.append(("dtype_race", bool(dtype_race)))
    if output_tile is not None:
        evidence.append(("req_tile", tuple(output_tile)
                         if isinstance(output_tile, (tuple, list))
                         else (output_tile, output_tile)))
    return winner, winner_tile, winner_dtype, tuple(evidence)


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
    the CUDA device; pass device="cpu" for the plain versions). Decisions
    are cached process-wide keyed on every input that decides them (and the
    card the blocking is sized for), so planning a layer shape again -- a
    measured auto_tuned choice included -- is a dict hit plus one filter
    transform. `data_format="NCHW"` ingests NCHW inputs with an OIHW
    filter: the filter is transposed to HWIO here and apply() transposes
    x / y at the call boundary.

    `algorithm="auto_tuned"` races the registry-eligible plain executors on
    the real layer shape (_measure_autotune) and caches the winner with
    its evidence; where nothing may be measured (_measure_allowed) the
    static amortization predicate decides, and that decision is not
    cached. `compute_dtype` selects the transform-domain GEMM dtype
    ("float32", "bfloat16", or per-output-channel "int8"); "auto" (only
    with auto_tuned) also races the bf16 / int8 variants, gated by
    AUTOTUNE_ACCURACY_BUDGET, and adopts the winner's dtype.
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
    dtype_race = compute_dtype == "auto"
    if dtype_race:
        if algorithm != "auto_tuned":
            raise ValueError(
                "compute_dtype='auto' races bf16/int8 against fp32 and "
                "needs measured evidence -- it requires "
                "algorithm='auto_tuned' (got algorithm="
                f"{algorithm!r}); pin a concrete dtype otherwise")
        compute_dtype = "float32"   # the race's baseline; the winner may
    else:                           # lower it
        compute_dtype = dtype_name(compute_dtype)
    if compute_dtype not in registry.COMPUTE_DTYPES:
        raise ValueError(
            f"unknown compute_dtype {compute_dtype!r}; expected one of "
            f"{registry.COMPUTE_DTYPES}")
    kh, kw = w_shape[:2]
    n, h, wdt, c = x_shape
    query = LayerQuery(kh=kh, kw=kw, stride=stride, groups=groups, c_in=c,
                       c_out=w_shape[3], layout=data_format)
    sms = _sm_count(device)
    key = (x_shape, w_shape, dtype_str, stride, padding, algorithm,
           output_tile if not isinstance(output_tile, list) else
           tuple(output_tile), groups, data_format,
           "auto" if dtype_race else compute_dtype, device.type, sms)
    spec = _SPEC_CACHE.get(key) if _cache_enabled() else None
    if spec is not None:
        _count_cache(True)
    else:
        _count_cache(False)
        fast = registry.best_fast(query)
        autotune = None
        build_tile = output_tile
        build_dtype = compute_dtype
        if algorithm == "auto":
            resolved = registry.select_auto(query).executor
        elif algorithm == "auto_tuned":
            if fast is None:
                resolved = "im2col"
                _record_autotune_resolution(measured=False)
            elif (tuned := _tuningdb_lookup(
                    x_shape, w_shape, dtype_str, stride, padding, groups,
                    data_format, "auto" if dtype_race else compute_dtype,
                    output_tile)) is not None or _measure_allowed():
                if tuned is not None:
                    # a tuning database's recorded winner, tile, dtype and
                    # evidence: zero local measurements
                    resolved, tuned_tile, tuned_dtype, autotune = tuned
                else:
                    t_race = time.perf_counter()
                    resolved, tuned_tile, tuned_dtype, autotune = \
                        _measure_autotune(
                            x_shape, w_shape, dtype_str, stride, padding,
                            output_tile, groups, fast=fast.executor,
                            pin_dtype=compute_dtype, dtype_race=dtype_race,
                            device=device, sms=sms)
                    _obs_trace.add_span(
                        "plan.autotune.race", t_race, time.perf_counter(),
                        winner=resolved, contenders=len(
                            [k for k, _ in autotune if k.startswith("t_")]),
                        layer=f"{x_shape}x{w_shape}")
                    _record_autotune_resolution(measured=True)
                if tuned_tile is not None:
                    build_tile = tuned_tile
                # Only compute_dtype="auto" fields reduced contenders, so an
                # un-opted race returns float32. A pinned reduced dtype
                # keeps its dtype (the race picked the executor) and does
                # not inherit an fp32 winner's tile: the low-precision grid
                # needs the small-tile default.
                if compute_dtype == "float32":
                    build_dtype = tuned_dtype
                elif tuned_dtype != compute_dtype:
                    build_tile = output_tile
            else:
                resolved = fast.executor if winograd_amortizes(
                    h, wdt, kh, kw, c, padding, groups, stride) else "im2col"
                _record_autotune_resolution(measured=False)
        else:
            resolved = registry.resolve(algorithm, query).executor
        if build_dtype != "float32":
            supported = registry.compute_dtypes_for(resolved)
            if build_dtype not in supported:
                supporting = sorted({
                    cap.executor for cap in registry.CAPABILITIES
                    if build_dtype in cap.compute_dtypes})
                raise ValueError(
                    f"executor {resolved!r} does not support "
                    f"compute_dtype={build_dtype!r} (it supports "
                    f"{'/'.join(supported)}); executors with a "
                    f"{build_dtype} transform-domain path: {supporting}")
        spec = _build_spec(x_shape, w_shape, dtype_str, stride, padding,
                           algorithm, resolved, build_tile, groups,
                           data_format, compute_dtype=build_dtype, sms=sms)
        if autotune is not None:
            spec = dataclasses.replace(spec, autotune=autotune)
        # A heuristic auto_tuned decision is not cached: a later plan of the
        # same shape where measuring is allowed still gets to measure. Only
        # measured decisions (and the sole-candidate im2col case) last.
        durable = (algorithm != "auto_tuned" or autotune is not None
                   or fast is None)
        if _cache_enabled() and durable:
            _SPEC_CACHE[key] = spec
    u, scale = _bind_weights(spec, w)
    return ConvPlan(spec, u, scale, build_time_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Separable blocks: depthwise kxk -> pointwise 1x1 planned as one fused unit
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeparableSpec:
    """The weight-free decisions of a planned separable (depthwise kxk +
    pointwise 1x1) block. Mode 'fused_pallas' runs both convs and both
    epilogues in ONE kernel (kernels/depthwise.py:separable_streamed; the
    intermediate never touches device memory); mode 'composed' chains two
    ConvPlans, covering strided / multiplier > 1 / reduced-precision /
    non-streamed configurations."""

    x_shape: tuple[int, ...]          # (N, H, W, C)
    w_dw_shape: tuple[int, ...]       # (kh, kw, 1, C*mult)
    w_pw_shape: tuple[int, ...]       # (1, 1, C*mult, M)
    dtype: str
    stride: tuple[int, int]
    padding: str
    requested: str
    mode: str                         # "fused_pallas" | "composed"
    output_tile: tuple[int, int] | None = None
    ct_h: CookToom | None = None
    ct_w: CookToom | None = None
    geometry: Any = None              # Conv2DGeometry (fused mode)
    stream: Any = None                # StreamGeometry (fused mode)


class SeparableBlockPlan(nn.Module):
    """A planned MobileNet-style separable block with a single epilogue
    contract: apply(x, bias_dw=, bias_pw=, inner_activation=, activation=)
    runs depthwise conv -> bias + activation -> pointwise conv -> bias +
    activation. In fused mode all of it happens inside one kernel; in
    composed mode each conv rides its own plan's epilogue. `u_dw` / `u_pw`
    (fused mode) are buffers and `dw` / `pw` (composed mode) submodules, so
    `.to(device)` moves them. `apply` shadows nn.Module.apply."""

    def __init__(self, spec: SeparableSpec, u_dw: torch.Tensor | None = None,
                 u_pw: torch.Tensor | None = None,
                 dw: ConvPlan | None = None, pw: ConvPlan | None = None,
                 build_time_s: float = 0.0):
        super().__init__()
        self.spec = spec
        self.register_buffer("u_dw", u_dw)     # (P, Cp) depthwise taps
        self.register_buffer("u_pw", u_pw)     # (Cp, Mp) pointwise matrix
        self.dw = dw
        self.pw = pw
        self.build_time_s = build_time_s

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.apply(x, **kwargs)

    def apply(self, x: torch.Tensor, bias_dw: torch.Tensor | None = None,
              bias_pw: torch.Tensor | None = None,
              inner_activation: str = "relu",
              activation: str = "relu") -> torch.Tensor:
        spec = self.spec
        if tuple(x.shape[1:]) != spec.x_shape[1:]:
            raise ValueError(
                f"plan built for input {spec.x_shape} got {tuple(x.shape)} "
                f"(batch may differ; H/W/C must match)")
        for act in (inner_activation, activation):
            if act not in EPILOGUE_ACTIVATIONS:
                raise ValueError(f"unknown activation {act!r}; expected one "
                                 f"of {EPILOGUE_ACTIVATIONS}")
        if spec.mode == "fused_pallas":
            return ops.separable_conv2d_planned(
                x, self.u_dw, self.u_pw, ct_h=spec.ct_h, ct_w=spec.ct_w,
                geometry=spec.geometry, stream=spec.stream,
                c_out=spec.w_pw_shape[3], bias_dw=bias_dw, bias_pw=bias_pw,
                inner_activation=inner_activation, activation=activation)
        h = self.dw.apply(x, bias=bias_dw, activation=inner_activation)
        return self.pw.apply(h, bias=bias_pw, activation=activation)

    @property
    def mode(self) -> str:
        return self.spec.mode

    @property
    def out_shape(self) -> tuple[int, ...]:
        if self.spec.mode == "fused_pallas":
            g = self.spec.geometry
            return (self.spec.x_shape[0], g.out_h, g.out_w,
                    self.spec.w_pw_shape[3])
        return self.pw.out_shape

    def describe(self) -> dict:
        spec = self.spec
        if spec.mode == "fused_pallas":
            executor, cd = "separable_streamed", "float32"
        else:
            executor = f"{self.dw.algorithm}+{self.pw.algorithm}"
            cds = [self.dw.spec.compute_dtype, self.pw.spec.compute_dtype]
            cd = cds[0] if cds[0] == cds[1] else "+".join(cds)
        return {"kind": "separable", "executor": executor,
                "compute_dtype": cd,
                "requested": spec.requested, "mode": spec.mode,
                "filter": f"{spec.w_dw_shape[0]}x{spec.w_dw_shape[1]}+1x1",
                "stride": f"{spec.stride[0]}x{spec.stride[1]}",
                "groups": spec.x_shape[3],
                "tile": ("x".join(map(str, spec.output_tile))
                         if spec.output_tile else "-")}

    def to_artifact(self) -> tuple[dict, dict]:
        spec = self.spec
        meta = {"kind": "separable", "mode": spec.mode,
                "x_shape": list(spec.x_shape),
                "w_dw_shape": list(spec.w_dw_shape),
                "w_pw_shape": list(spec.w_pw_shape), "dtype": spec.dtype,
                "stride": list(spec.stride), "padding": spec.padding,
                "requested": spec.requested,
                "output_tile": (list(spec.output_tile)
                                if spec.output_tile else None)}
        if spec.mode == "fused_pallas":
            meta.update(_blocking_meta(None, spec.stream))
            return meta, {"u_dw": _to_artifact(self.u_dw),
                          "u_pw": _to_artifact(self.u_pw)}
        meta["dw"], dw_arrays = self.dw.to_artifact()
        meta["pw"], pw_arrays = self.pw.to_artifact()
        arrays = {f"dw.{k}": v for k, v in dw_arrays.items()}
        arrays.update({f"pw.{k}": v for k, v in pw_arrays.items()})
        return meta, arrays

    @classmethod
    def from_artifact(cls, meta: dict, arrays: dict, device=None,
                      foreign: bool = False) -> "SeparableBlockPlan":
        """Rebuild the block on `device` from a saved artifact (`foreign`:
        the JAX package's, see ConvPlan.from_artifact)."""
        device = resolve_device(device)
        ot = meta["output_tile"]
        if meta["mode"] == "fused_pallas":
            spec = _build_separable_fused_spec(
                tuple(meta["x_shape"]), tuple(meta["w_dw_shape"]),
                tuple(meta["w_pw_shape"]), meta["dtype"],
                tuple(meta["stride"]), meta["padding"], meta["requested"],
                tuple(ot) if ot else None, sms=_sm_count(device),
                saved=None if foreign else meta)
            u_dw = _from_artifact(arrays["u_dw"], device)
            u_pw = _from_artifact(arrays["u_pw"], device)
            if foreign:
                # the taps (P, C) and the pointwise (C, M), re-padded for
                # this block's c_pad / m_pad
                s, c, m = spec.stream, spec.x_shape[3], spec.w_pw_shape[3]
                u_dw = _pad_to(_crop(u_dw, (u_dw.shape[0], c)),
                               (u_dw.shape[0], s.c_pad))
                u_pw = _pad_to(_crop(u_pw, (c, m)), (s.c_pad, s.m_pad))
            return cls(spec, u_dw=u_dw, u_pw=u_pw)
        spec = SeparableSpec(
            x_shape=tuple(meta["x_shape"]),
            w_dw_shape=tuple(meta["w_dw_shape"]),
            w_pw_shape=tuple(meta["w_pw_shape"]), dtype=meta["dtype"],
            stride=tuple(meta["stride"]), padding=meta["padding"],
            requested=meta["requested"], mode="composed",
            output_tile=tuple(ot) if ot else None)
        return cls(spec,
                   dw=ConvPlan.from_artifact(
                       meta["dw"], _sub_arrays(arrays, "dw."), device,
                       foreign),
                   pw=ConvPlan.from_artifact(
                       meta["pw"], _sub_arrays(arrays, "pw."), device,
                       foreign))


def _build_separable_fused_spec(x_shape, dw_shape, pw_shape, dtype_str,
                                stride, padding, requested, output_tile,
                                sms: int = _wg.H100_SMS,
                                saved: dict | None = None) -> SeparableSpec:
    """Derive the fused-mode SeparableSpec: transform set, conv geometry
    and the separable kernel's blocking (`saved`, an artifact's meta,
    supplies the blocking instead of the chooser)."""
    n, h, wdt, c = x_shape
    kh, kw = dw_shape[:2]
    mh, mw = _resolve_output_tile(kh, kw, output_tile)
    ct_h, ct_w = cook_toom(mh, kh), cook_toom(mw, kw)
    geom = _wg.conv2d_geometry(h, wdt, kh, kw, mh, mw, padding)
    _, stream = _restored(saved, lambda: (None, _wg.separable_geometry(
        geom.n_h, geom.n_w, c, pw_shape[3], ct_h, ct_w, batch=n, sms=sms)))
    return SeparableSpec(
        x_shape=x_shape, w_dw_shape=dw_shape, w_pw_shape=pw_shape,
        dtype=dtype_str, stride=stride, padding=padding,
        requested=requested, mode="fused_pallas", output_tile=(mh, mw),
        ct_h=ct_h, ct_w=ct_w, geometry=geom, stream=stream)


def plan_separable_block(
    x_shape: tuple[int, ...],
    w_dw,
    w_pw,
    *,
    stride: int | tuple[int, int] = 1,
    padding: Padding = "SAME",
    algorithm: Algorithm = "auto",
    output_tile: int | tuple[int, int] | None = None,
    dtype=None,
    compute_dtype="float32",
    device=None,
) -> SeparableBlockPlan:
    """Plan a depthwise kxk conv and its following 1x1 pointwise conv as one
    unit (the MobileNet separable block), on `device` (None means the CUDA
    device).

    With algorithm="pallas_winograd" on a fusable configuration (stride 1,
    suitable filter size, channel multiplier 1, fp32) the block is planned
    onto the fused kernel: the depthwise output stays on chip and feeds the
    pointwise GEMM directly, with both epilogues applied in-kernel. Every
    other configuration composes two ConvPlans (the depthwise one falling
    back per the usual suitability rules), so this entry point never
    rejects a block shape. A reduced `compute_dtype` always composes: the
    fused kernel is fp32-only.
    """
    t0 = time.perf_counter()
    device = resolve_device(device)
    x_shape = tuple(x_shape)
    w_dw = torch.as_tensor(w_dw, device=device)
    w_pw = torch.as_tensor(w_pw, device=device)
    dw_shape, pw_shape = tuple(w_dw.shape), tuple(w_pw.shape)
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; expected one of "
                         f"{ALGORITHMS}")
    if len(x_shape) != 4 or len(dw_shape) != 4 or len(pw_shape) != 4:
        raise ValueError(f"expected NHWC x HWIO x HWIO, got {x_shape} x "
                         f"{dw_shape} x {pw_shape}")
    n, h, wdt, c = x_shape
    kh, kw = dw_shape[:2]
    if dw_shape[2] != 1 or dw_shape[3] % c:
        raise ValueError(f"depthwise filter must be (kh, kw, 1, C*mult) for "
                         f"C={c}, got {dw_shape}")
    if pw_shape[:2] != (1, 1) or pw_shape[2] != dw_shape[3]:
        raise ValueError(f"pointwise filter must be (1, 1, {dw_shape[3]}, "
                         f"M), got {pw_shape}")
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    dtype_str = dtype_name(dtype or w_dw.dtype)
    mult = dw_shape[3] // c
    pallas = algorithm in ("pallas_winograd", "pallas_winograd_materialized",
                           "pallas_im2col")
    dw_query = registry.as_query(kh, kw, stride, groups=c, c_in=c,
                                 c_out=dw_shape[3])
    # Only the streamed-kernel request fuses; the kernel baselines are never
    # silently substituted with the fast path. The fused kernel is stride-1
    # only: stride-2 blocks compose a strided depthwise plan with a
    # pointwise plan below.
    fusable = (algorithm == "pallas_winograd" and mult == 1
               and stride == (1, 1)
               and dtype_name(compute_dtype) == "float32"
               and registry.supported("pallas_winograd", dw_query))

    if fusable:
        sms = _sm_count(device)
        key = ("sepblock", x_shape, dw_shape, pw_shape, dtype_str, stride,
               padding, algorithm, output_tile, device.type, sms)
        spec = _cached_spec(key, lambda: _build_separable_fused_spec(
            x_shape, dw_shape, pw_shape, dtype_str, stride, padding,
            algorithm, output_tile, sms=sms))
        s = spec.stream
        u_dw = _depthwise_domain_taps(w_dw, spec.ct_h, spec.ct_w, c, s.c_pad)
        u_pw = F.pad(w_pw.reshape(c, pw_shape[3]),
                     (0, s.m_pad - pw_shape[3], 0, s.c_pad - c))
        return SeparableBlockPlan(spec, u_dw=u_dw.contiguous(),
                                  u_pw=u_pw.contiguous(),
                                  build_time_s=time.perf_counter() - t0)

    # composed fallback: two plans, each on its best available executor.
    if pallas:
        # reached when the block cannot fuse (stride > 1, unsuitable k,
        # mult > 1, reduced precision) or a kernel baseline was requested.
        # The streamed family keeps its own depthwise executors where one
        # is declared (the stride-1 and stride-2 streamed depthwise
        # kernels); the baselines have no depthwise executor and run
        # grouped im2row.
        if algorithm == "pallas_winograd" and registry.supported(algorithm,
                                                                 dw_query):
            dw_alg = "pallas_winograd"
        else:
            dw_alg = "im2col"
        pw_alg = "pallas_im2col"
    else:
        dw_alg = algorithm
        if algorithm == "winograd" and not registry.supported("winograd",
                                                              dw_query):
            dw_alg = "im2col"
        pw_alg = "im2col" if algorithm == "im2col" else "auto"
    dw = plan_conv2d(x_shape, w_dw, stride=stride, padding=padding,
                     algorithm=dw_alg, groups=c, output_tile=output_tile,
                     dtype=dtype, compute_dtype=compute_dtype, device=device)
    pw = plan_conv2d(dw.out_shape, w_pw, stride=1, padding="SAME",
                     algorithm=pw_alg, dtype=dtype,
                     compute_dtype=compute_dtype, device=device)
    spec = SeparableSpec(x_shape=x_shape, w_dw_shape=dw_shape,
                         w_pw_shape=pw_shape, dtype=dtype_str, stride=stride,
                         padding=padding, requested=algorithm,
                         mode="composed")
    return SeparableBlockPlan(spec, dw=dw, pw=pw,
                              build_time_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Inverted residual blocks (MobileNet-v2): expand -> depthwise -> project
# ---------------------------------------------------------------------------

def _no_step(_name: str):
    """InvertedResidualPlan.apply's step context when nothing times it."""
    return _obs_trace.NULL_SPAN


class InvertedResidualPlan(nn.Module):
    """A planned MobileNet-v2 inverted residual unit: 1x1 expand (+bias,
    activation) -> kxk depthwise (+bias, activation) -> 1x1 linear project
    (+bias, NO activation) -> residual add when stride 1 and C_in == C_out.

    The depthwise + project pair is ONE SeparableBlockPlan, so on the
    streamed path (stride 1, suitable k, multiplier 1) it runs as a single
    fused kernel with the intermediate on chip; the expand conv is a plain
    channel GEMM (im2col, torch.matmul). Stride-2 blocks compose, with the
    depthwise half on the strided executors. The residual add runs outside
    any kernel. `apply` shadows nn.Module.apply."""

    def __init__(self, x_shape, stride, residual: bool,
                 expand: ConvPlan | None, sep: SeparableBlockPlan,
                 build_time_s: float = 0.0):
        super().__init__()
        self.x_shape = tuple(x_shape)
        self.stride = tuple(stride)
        self.residual = residual
        self.expand = expand             # None when the expand factor is 1
        self.sep = sep
        self.build_time_s = build_time_s

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.apply(x, **kwargs)

    def apply(self, x: torch.Tensor, bias_exp: torch.Tensor | None = None,
              bias_dw: torch.Tensor | None = None,
              bias_pw: torch.Tensor | None = None,
              activation: str = "relu6", step=None) -> torch.Tensor:
        """`step(name)`, where given, returns a context manager that is
        opened around each step: "expand", "separable", "residual" (the
        profiler's per-step spans, core/compile.py)."""
        step = step or _no_step
        h = x
        if self.expand is not None:
            with step("expand"):
                h = self.expand.apply(h, bias=bias_exp,
                                      activation=activation)
        with step("separable"):
            y = self.sep.apply(h, bias_dw=bias_dw, bias_pw=bias_pw,
                               inner_activation=activation,
                               activation="none")    # linear bottleneck
        if not self.residual:
            return y
        with step("residual"):
            return x + y

    @property
    def mode(self) -> str:
        return self.sep.mode

    @property
    def out_shape(self) -> tuple[int, ...]:
        return self.sep.out_shape

    def describe(self) -> dict:
        d = self.sep.describe()
        executor = d["executor"]
        cd = d.get("compute_dtype", "float32")
        if self.expand is not None:
            executor = f"{self.expand.algorithm}+{executor}"
            exp_cd = self.expand.spec.compute_dtype
            if exp_cd != cd:
                cd = f"{exp_cd}+{cd}"
        return {"kind": "inverted_residual", "executor": executor,
                "compute_dtype": cd,
                "requested": d["requested"], "mode": self.mode,
                "filter": ("1x1+" if self.expand is not None else "")
                + d["filter"],
                "stride": f"{self.stride[0]}x{self.stride[1]}",
                "groups": self.sep.spec.x_shape[3],
                "tile": d["tile"],
                "residual": self.residual}

    def to_artifact(self) -> tuple[dict, dict]:
        meta = {"kind": "inverted_residual", "x_shape": list(self.x_shape),
                "stride": list(self.stride), "residual": self.residual,
                "expand": None}
        arrays = {}
        if self.expand is not None:
            meta["expand"], exp_arrays = self.expand.to_artifact()
            arrays.update({f"exp.{k}": v for k, v in exp_arrays.items()})
        meta["sep"], sep_arrays = self.sep.to_artifact()
        arrays.update({f"sep.{k}": v for k, v in sep_arrays.items()})
        return meta, arrays

    @classmethod
    def from_artifact(cls, meta: dict, arrays: dict, device=None,
                      foreign: bool = False) -> "InvertedResidualPlan":
        device = resolve_device(device)
        expand = None
        if meta["expand"] is not None:
            expand = ConvPlan.from_artifact(
                meta["expand"], _sub_arrays(arrays, "exp."), device, foreign)
        sep = SeparableBlockPlan.from_artifact(
            meta["sep"], _sub_arrays(arrays, "sep."), device, foreign)
        return cls(tuple(meta["x_shape"]), tuple(meta["stride"]),
                   meta["residual"], expand, sep)


def plan_inverted_residual(
    x_shape: tuple[int, ...],
    w_exp,
    w_dw,
    w_pw,
    *,
    stride: int | tuple[int, int] = 1,
    padding: Padding = "SAME",
    algorithm: Algorithm = "auto",
    output_tile: int | tuple[int, int] | None = None,
    dtype=None,
    compute_dtype="float32",
    device=None,
) -> InvertedResidualPlan:
    """Plan a MobileNet-v2 inverted residual block as one unit, on `device`
    (None means the CUDA device).

    `w_exp` is the (1, 1, C, C*t) expansion filter (None for expand factor
    1), `w_dw` the (k, k, 1, C*t) depthwise filter, `w_pw` the
    (1, 1, C*t, M) linear projection. The depthwise + project pair rides
    plan_separable_block (the fused kernel where it applies); the residual
    connection is planned in when stride is 1 and M == C."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    x_shape = tuple(x_shape)
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    expand = None
    inner_shape = x_shape
    if w_exp is not None:
        # 1x1 expand: a plain channel GEMM; "auto" resolves it to the
        # im2row executor, which for 1x1 is one torch.matmul.
        expand = plan_conv2d(x_shape, w_exp, stride=1, padding="SAME",
                             algorithm="auto", dtype=dtype,
                             compute_dtype=compute_dtype, device=device)
        inner_shape = expand.out_shape
    sep = plan_separable_block(inner_shape, w_dw, w_pw, stride=stride,
                               padding=padding, algorithm=algorithm,
                               output_tile=output_tile, dtype=dtype,
                               compute_dtype=compute_dtype, device=device)
    residual = stride == (1, 1) and x_shape[3] == tuple(w_pw.shape)[3]
    return InvertedResidualPlan(x_shape, stride, residual, expand, sep,
                                build_time_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# conv1d plans (sequence convolutions, polyphase stride > 1 included)
# ---------------------------------------------------------------------------

class Conv1DPlan(nn.Module):
    """Planned (B, L, C) x (k, C, M) -> (B, L', M) sequence convolution.

    mode "as2d": stride 1, executed through a 2D plan on (B, L, 1, C).
    mode "polyphase": stride s > 1 decomposed into s stride-1 Cook-Toom
      sub-convolutions (sub-filter w[p::s] over sub-sequence x[p::s],
      VALID), each planned on its own; the SAME padding split and the
      output length are precomputed, and the epilogue runs once, after
      the sum across phases.
    mode "im2col": the strided baseline through a 2D im2col plan.

    `inner` and `subplans` are ConvPlan submodules, so `.to(device)`
    moves them. `apply` shadows nn.Module.apply."""

    def __init__(self, x_shape, w_shape, stride: int, padding: str,
                 requested: str, mode: str, inner: ConvPlan | None = None,
                 subplans=(), pad: tuple[int, int] = (0, 0),
                 out_len: int = 0, build_time_s: float = 0.0):
        super().__init__()
        self.x_shape = tuple(x_shape)
        self.w_shape = tuple(w_shape)
        self.stride = stride
        self.padding = padding
        self.requested = requested
        self.mode = mode
        self.inner = inner
        self.subplans = nn.ModuleList(subplans)
        self.pad = tuple(pad)
        self.out_len = out_len
        self.build_time_s = build_time_s

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.apply(x, **kwargs)

    def apply(self, x: torch.Tensor, bias: torch.Tensor | None = None,
              activation: str = "none") -> torch.Tensor:
        if self.mode in ("as2d", "im2col"):
            return self.inner.apply(x[:, :, None, :], bias=bias,
                                    activation=activation)[:, :, 0, :]
        # polyphase: y[i] = sum_p (w[p::s] (*) x[p::s])[i]; the epilogue
        # can only run after the cross-phase sum
        s = self.stride
        x = F.pad(x, (0, 0, *self.pad))
        acc = None
        for p, sub in enumerate(self.subplans):
            y = sub.apply(x[:, p::s, None, :])[:, :self.out_len, 0, :]
            acc = y if acc is None else acc + y
        return epilogue(acc, bias, activation)

    def describe(self) -> dict:
        if self.mode == "polyphase":
            executor = ("polyphase["
                        + "+".join(s.algorithm for s in self.subplans) + "]")
        else:
            executor = self.inner.algorithm
        return {"kind": "conv1d", "executor": executor,
                "requested": self.requested, "mode": self.mode,
                "filter": f"k={self.w_shape[0]}", "stride": str(self.stride),
                "groups": 1, "tile": "-"}

    def to_artifact(self) -> tuple[dict, dict]:
        """(meta, arrays): the reference's record, the 2D plans' metas
        nested under "inner" / "subplans" and their arrays under the
        prefixes "inner." / "sub{i}."."""
        meta = {"kind": "conv1d", "mode": self.mode,
                "x_shape": list(self.x_shape), "w_shape": list(self.w_shape),
                "stride": self.stride, "padding": self.padding,
                "requested": self.requested, "pad": list(self.pad),
                "out_len": self.out_len}
        arrays = {}
        if self.mode in ("as2d", "im2col"):
            meta["inner"], inner_arrays = self.inner.to_artifact()
            arrays.update({f"inner.{k}": v for k, v in inner_arrays.items()})
        else:
            subs = []
            for i, sub in enumerate(self.subplans):
                sub_meta, sub_arrays = sub.to_artifact()
                subs.append(sub_meta)
                arrays.update({f"sub{i}.{k}": v
                               for k, v in sub_arrays.items()})
            meta["subplans"] = subs
        return meta, arrays

    @classmethod
    def from_artifact(cls, meta: dict, arrays: dict, device=None,
                      foreign: bool = False) -> "Conv1DPlan":
        device = resolve_device(device)
        base = dict(x_shape=tuple(meta["x_shape"]),
                    w_shape=tuple(meta["w_shape"]), stride=meta["stride"],
                    padding=meta["padding"], requested=meta["requested"],
                    mode=meta["mode"], pad=tuple(meta["pad"]),
                    out_len=meta["out_len"])
        if meta["mode"] in ("as2d", "im2col"):
            return cls(inner=ConvPlan.from_artifact(
                meta["inner"], _sub_arrays(arrays, "inner."), device,
                foreign), **base)
        return cls(subplans=[
            ConvPlan.from_artifact(sub, _sub_arrays(arrays, f"sub{i}."),
                                   device, foreign)
            for i, sub in enumerate(meta["subplans"])], **base)


def plan_conv1d(
    x_shape: tuple[int, ...],
    w,
    *,
    stride: int = 1,
    padding: Padding = "SAME",
    algorithm: Algorithm = "auto",
    output_tile: int | None = None,
    device=None,
) -> Conv1DPlan:
    """Plan a (B, L, C) x (k, C, M) sequence convolution on `device` (None
    means the CUDA device; see Conv1DPlan). A stride > 1 runs polyphase
    under "winograd" / "auto" when the filter is longer than the stride,
    im2col otherwise."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    x_shape = tuple(x_shape)
    w = torch.as_tensor(w, device=device)
    if len(x_shape) != 3 or w.dim() != 3 or x_shape[2] != w.shape[1]:
        raise ValueError(f"expected (B, L, C) x (k, C, M), got "
                         f"{x_shape} x {tuple(w.shape)}")
    b, length, c = x_shape
    k = w.shape[0]
    base = dict(x_shape=x_shape, w_shape=tuple(w.shape), stride=stride,
                padding=padding, requested=algorithm)
    if stride == 1:
        inner = plan_conv2d((b, length, 1, c), w[:, None], stride=1,
                            padding=padding, algorithm=algorithm,
                            output_tile=output_tile, device=device)
        return Conv1DPlan(mode="as2d", inner=inner,
                          build_time_s=time.perf_counter() - t0, **base)

    if algorithm in ("winograd", "auto") and k > stride:
        if padding == "SAME":
            out = -(-length // stride)
            total = max((out - 1) * stride + k - length, 0)
            pad = (total // 2, total - total // 2)
        else:
            out = (length - k) // stride + 1
            pad = (0, 0)
        padded = length + pad[0] + pad[1]
        subplans = []
        for p in range(stride):
            sub_w = w[p::stride]                    # (ceil((k-p)/s), C, M)
            sub_len = -(-(padded - p) // stride)
            subplans.append(plan_conv2d(
                (b, sub_len, 1, c), sub_w[:, None], stride=1,
                padding="VALID", algorithm="auto", output_tile=output_tile,
                device=device))
        return Conv1DPlan(mode="polyphase", subplans=subplans, pad=pad,
                          out_len=out, build_time_s=time.perf_counter() - t0,
                          **base)

    inner = plan_conv2d((b, length, 1, c), w[:, None], stride=(stride, 1),
                        padding=padding, algorithm="im2col", device=device)
    return Conv1DPlan(mode="im2col", inner=inner,
                      build_time_s=time.perf_counter() - t0, **base)


# ---------------------------------------------------------------------------
# Depthwise causal Cook-Toom conv1d plans (Mamba's short conv)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DepthwiseConv1DSpec:
    """Decisions of a planned (B, L, C) x (r, C) causal depthwise Cook-Toom
    convolution: the F(m, r) transform set, tile count, padding and kernel
    blocking."""

    x_shape: tuple[int, ...]          # (B, L, C) the plan was built for
    w_shape: tuple[int, ...]          # (r, C)
    dtype: str                        # the taps' dtype
    output_tile: int
    backend: str                      # "jnp" | "pallas"
    ct: CookToom = None
    n_tiles: int = 0
    pad_hi: int = 0                   # right pad so tiles cover n_tiles * m
    blocks: tuple[int, int] | None = None   # (block_s, block_c), pallas only


class DepthwiseConv1DPlan(nn.Module):
    """Spec + taps in the Cook-Toom domain. apply(x) performs no cook_toom
    construction, tile-count or padding derivation -- only the input work.
    `u` is a buffer: (t, C) for "jnp", (t, Cp) padded to the kernel's
    channel step for "pallas". `apply` shadows nn.Module.apply."""

    def __init__(self, spec: DepthwiseConv1DSpec, u: torch.Tensor,
                 build_time_s: float = 0.0):
        super().__init__()
        self.spec = spec
        self.register_buffer("u", u)
        self.build_time_s = build_time_s

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        if tuple(x.shape[1:]) != spec.x_shape[1:]:
            raise ValueError(
                f"plan built for input {spec.x_shape} got {tuple(x.shape)} "
                f"(batch may differ; L/C must match)")
        if spec.backend == "pallas":
            return ops.ct_depthwise_causal_conv1d_planned(
                x, self.u, ct=spec.ct, n_tiles=spec.n_tiles,
                pad_hi=spec.pad_hi, blocks=spec.blocks,
                c_in=spec.w_shape[1])
        return _wg.ct_depthwise_causal_conv1d_pretransformed(
            x, self.u, spec.ct, n_tiles=spec.n_tiles, pad_hi=spec.pad_hi)

    def describe(self) -> dict:
        spec = self.spec
        return {"kind": "conv1d_depthwise",
                "executor": f"ct_causal_{spec.backend}",
                "requested": spec.backend, "filter": f"k={spec.w_shape[0]}",
                "stride": "1", "groups": spec.w_shape[1],
                "tile": str(spec.output_tile)}

    def to_artifact(self) -> tuple[dict, dict]:
        spec = self.spec
        meta = {"kind": "conv1d_depthwise", "x_shape": list(spec.x_shape),
                "w_shape": list(spec.w_shape), "dtype": spec.dtype,
                "output_tile": spec.output_tile, "backend": spec.backend,
                "blocks": list(spec.blocks) if spec.blocks else None}
        return meta, {"u": _to_artifact(self.u)}

    @classmethod
    def from_artifact(cls, meta: dict, arrays: dict, device=None,
                      foreign: bool = False) -> "DepthwiseConv1DPlan":
        """Rebuild the plan on `device` (`foreign`: the JAX package's
        artifact, whose meta has no blocking and whose taps are padded to
        its own channel block)."""
        device = resolve_device(device)
        ct = cook_toom(meta["output_tile"], meta["w_shape"][0])
        length = meta["x_shape"][1]
        nt = -(-length // ct.m)
        c = meta["w_shape"][1]
        if foreign:
            blocks = (ops.conv1d_ct_blocks(c) if meta["backend"] == "pallas"
                      else None)
        else:
            blocks = tuple(meta["blocks"]) if meta["blocks"] else None
        spec = DepthwiseConv1DSpec(
            x_shape=tuple(meta["x_shape"]), w_shape=tuple(meta["w_shape"]),
            dtype=meta["dtype"], output_tile=meta["output_tile"],
            backend=meta["backend"], ct=ct, n_tiles=nt,
            pad_hi=nt * ct.m - length, blocks=blocks)
        u = _from_artifact(arrays["u"], device, spec.dtype == "bfloat16")
        if foreign:
            c_pad = -(-c // blocks[1]) * blocks[1] if blocks else c
            u = _pad_to(_crop(u, (u.shape[0], c)), (u.shape[0], c_pad))
        return cls(spec, u)


def plan_depthwise_conv1d(
    x_shape: tuple[int, ...],
    w,
    *,
    output_tile: int = 4,
    backend: str = "jnp",
    device=None,
) -> DepthwiseConv1DPlan:
    """Plan a causal depthwise Cook-Toom conv (B, L, C) x (r, C) -> (B, L, C)
    on `device` (None means the CUDA device).

    Decisions (cook_toom transform set, tile count, padding, kernel
    blocking) are made once and cached process-wide keyed on (shape,
    dtype, output tile, backend); the taps are transformed into the
    Cook-Toom domain here, in w's dtype: a caller that plans per call, as
    models/mamba.py:mamba_block does, pays a dict hit and a (t x r) .
    (r x C) product.
    """
    t0 = time.perf_counter()
    device = resolve_device(device)
    x_shape = tuple(x_shape)
    w = torch.as_tensor(w, device=device)
    if len(x_shape) != 3 or w.dim() != 2 or x_shape[2] != w.shape[1]:
        raise ValueError(f"expected (B, L, C) x (r, C), got "
                         f"{x_shape} x {tuple(w.shape)}")
    if backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    r, c = w.shape
    length = x_shape[1]
    dtype_str = dtype_name(w.dtype)

    def build():
        ct = cook_toom(output_tile, r)
        nt = -(-length // ct.m)
        return DepthwiseConv1DSpec(
            x_shape=x_shape, w_shape=tuple(w.shape), dtype=dtype_str,
            output_tile=output_tile, backend=backend, ct=ct, n_tiles=nt,
            pad_hi=nt * ct.m - length,
            blocks=ops.conv1d_ct_blocks(c) if backend == "pallas" else None)

    spec = _cached_spec(("dwconv1d", x_shape, tuple(w.shape), dtype_str,
                         output_tile, backend), build)
    u = torch.einsum("ij,jc->ic", torch.as_tensor(spec.ct.G, dtype=w.dtype,
                                                  device=device), w)
    if backend == "pallas":
        bc = spec.blocks[1]
        u = F.pad(u, (0, -(-c // bc) * bc - c))
    return DepthwiseConv1DPlan(spec, u.contiguous(),
                               build_time_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# LayerPlan protocol dispatcher (artifact reload)
# ---------------------------------------------------------------------------

#: kind tag (to_artifact meta["kind"]) -> plan class. Every class conforms
#: to the LayerPlan protocol: apply(x, ...), describe(), to_artifact(),
#: from_artifact(meta, arrays, device).
PLAN_KINDS = {
    "conv2d": ConvPlan,
    "separable": SeparableBlockPlan,
    "inverted_residual": InvertedResidualPlan,
    "conv1d": Conv1DPlan,
    "conv1d_depthwise": DepthwiseConv1DPlan,
}


def plan_from_artifact(meta: dict, arrays: dict, device=None,
                       foreign: bool = False):
    """Rebuild any LayerPlan on `device` (None means the CUDA device) from
    its (meta, arrays) artifact pair. The inverse of .to_artifact():
    geometry is re-derived from the saved decisions and blocking; the
    execution-domain weights are taken verbatim (no filter transform
    runs). `foreign=True` reads a pair the JAX package saved: its metas
    carry no kernel blocking, so the choosers pick it, and its weights,
    padded to the JAX kernels' blocking, are cropped to the logical C / M
    and padded again for this one's."""
    kind = meta.get("kind")
    if kind not in PLAN_KINDS:
        raise ValueError(f"unknown plan artifact kind {kind!r}; expected one "
                         f"of {sorted(PLAN_KINDS)}")
    return PLAN_KINDS[kind].from_artifact(meta, arrays, device,
                                          foreign=foreign)
