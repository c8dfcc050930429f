"""Capability-declaring executor registry: every convolution executor
declares what it can run; algorithm resolution is a registry query.

The same records as the JAX package's core/registry.py, so `place` and
`describe` give the same answers in both packages. Each executor registers
ONE `Capability` record -- supported strides, filter sizes, group kinds,
channel-multiplier constraint, layouts, fusable epilogues, and a cost hint
-- and the planner asks the registry:

  * `resolve(algorithm, query)` -> the matching capability for a requested
    algorithm family (or a ValueError that enumerates the registered
    executors that DO cover the layer);
  * `select_auto(query)` -> the paper's mixed policy (cheapest fast-scheme
    capability where one matches, the im2row baseline everywhere else);
  * `supported(algorithm, query)` -> the coverage predicate the compiler's
    per-layer fallback consults.

Every executor these records declare has a branch in core/plan.py
(_build_spec, _domain_filter, ConvPlan.apply); an unknown executor name is
a ValueError there.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Sequence

#: Filter sizes the exact Cook-Toom generator covers per non-unit axis
#: (2D NxN and 1D 1xN / Nx1) -- the paper's "suitable" filter sizes.
WINOGRAD_FILTER_SIZES = frozenset({2, 3, 4, 5, 7})

#: Odd filter sizes the stride-2 transform-domain phase decomposition
#: covers: the filter is zero-padded to even size k+1 and split into four
#: (k+1)/2-tap phase sub-filters, so (k+1)/2 must be a supported size.
STRIDED_FILTER_SIZES = frozenset(
    k for k in (3, 5, 7) if (k + 1) // 2 in WINOGRAD_FILTER_SIZES)

#: Data layouts the plan/dispatch boundary accepts (NCHW inputs/weights are
#: transposed once at plan time; see plan.plan_conv2d(data_format=...)).
LAYOUTS = ("NHWC", "NCHW")

_KINDS = ("dense", "grouped", "depthwise")

#: Transform-domain compute dtypes an executor may declare, in preference
#: order for display. Input/inverse transforms always run fp32 (the
#: numerically fragile part); a reduced dtype only changes the
#: transform-domain GEMM/Hadamard operand and its plan-time-quantized
#: filter (per-output-channel scales fold into the epilogue).
COMPUTE_DTYPES = ("float32", "bfloat16", "int8")

_DTYPE_SHORT = {"float32": "fp32", "bfloat16": "bf16", "int8": "int8"}

_F32_ONLY = frozenset({"float32"})
_LOW_PRECISION = frozenset(COMPUTE_DTYPES)


@dataclasses.dataclass(frozen=True)
class LayerQuery:
    """One conv layer's shape facts, as the registry sees them."""

    kh: int
    kw: int
    stride: tuple[int, int]
    groups: int = 1
    c_in: int | None = None
    c_out: int | None = None
    layout: str = "NHWC"

    @property
    def group_kind(self) -> str:
        if self.groups == 1:
            return "dense"
        if self.c_in is not None and self.groups == self.c_in:
            return "depthwise"
        return "grouped"

    @property
    def axis_kind(self) -> str:
        """'pointwise' (1x1), 'single_axis' (1xN / Nx1), or 'two_d'."""
        if self.kh == 1 and self.kw == 1:
            return "pointwise"
        if self.kh == 1 or self.kw == 1:
            return "single_axis"
        return "two_d"


def as_query(kh: int, kw: int, stride, *, groups: int = 1,
             c_in: int | None = None, c_out: int | None = None,
             layout: str = "NHWC") -> LayerQuery:
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    return LayerQuery(kh=kh, kw=kw, stride=s, groups=groups, c_in=c_in,
                      c_out=c_out, layout=layout)


@dataclasses.dataclass(frozen=True)
class Capability:
    """What one executor declares it can run.

    `executor` is the resolved name plan._build_spec materializes;
    `algorithm` is the requestable family it serves (one executor may be
    reachable from several families -- e.g. the single-axis executor backs
    both 'winograd' and the streamed families for 1xN layers, whose GEMM is
    a single matmul)."""

    executor: str
    algorithm: str
    strides: frozenset | None            # of (sh, sw); None = any stride
    filter_sizes: frozenset | None       # per non-unit axis; None = any
    axis_kinds: frozenset                # subset of {pointwise, single_axis,
                                         #            two_d}
    group_kinds: frozenset               # subset of {dense, grouped,
                                         #            depthwise}
    unit_multiplier_only: bool = False   # depthwise: requires c_out == c_in
    layouts: frozenset = frozenset(LAYOUTS)
    fused_epilogue: bool = False         # bias+activation fused in-kernel
    cost_hint: float = 1.0               # relative per-output cost rank;
                                         # lower wins within a family and in
                                         # select_auto
    compute_dtypes: frozenset = _F32_ONLY  # transform-domain GEMM/Hadamard
                                           # dtypes (transforms stay fp32)
    note: str = ""

    def matches(self, q: LayerQuery) -> bool:
        if self.strides is not None and q.stride not in self.strides:
            return False
        if q.axis_kind not in self.axis_kinds:
            return False
        if self.filter_sizes is not None:
            for k in (q.kh, q.kw):
                if k != 1 and k not in self.filter_sizes:
                    return False
        if q.group_kind not in self.group_kinds:
            return False
        if self.unit_multiplier_only and q.group_kind == "depthwise":
            if q.c_out is None or q.c_out != q.c_in:
                return False
        if q.layout not in self.layouts:
            return False
        return True

    # ---- human-readable constraint rendering (error messages, README) ----

    @property
    def strides_str(self) -> str:
        if self.strides is None:
            return "any"
        return ", ".join(f"{s[0]}x{s[1]}" for s in sorted(self.strides))

    @property
    def filters_str(self) -> str:
        sizes = ("any" if self.filter_sizes is None
                 else "/".join(str(k) for k in sorted(self.filter_sizes)))
        kinds = []
        if "two_d" in self.axis_kinds:
            kinds.append(f"kxk (k in {sizes})" if sizes != "any" else "kxk")
        if "single_axis" in self.axis_kinds:
            kinds.append("1xN/Nx1")
        if "pointwise" in self.axis_kinds:
            kinds.append("1x1")
        return ", ".join(kinds)

    @property
    def groups_str(self) -> str:
        names = {"dense": "G=1", "grouped": "1<G<C",
                 "depthwise": ("G=C (mult 1)" if self.unit_multiplier_only
                               else "G=C")}
        return ", ".join(names[k] for k in _KINDS if k in self.group_kinds)

    @property
    def dtypes_str(self) -> str:
        return "/".join(_DTYPE_SHORT[d] for d in COMPUTE_DTYPES
                        if d in self.compute_dtypes)


_WFS = WINOGRAD_FILTER_SIZES
_SFS = STRIDED_FILTER_SIZES
_S1 = frozenset({(1, 1)})
_S2 = frozenset({(2, 2)})
_ALL_LAYOUTS = frozenset(LAYOUTS)


def _cap(executor, algorithm, *, strides, filter_sizes, axis_kinds,
         group_kinds, **kw) -> Capability:
    return Capability(
        executor=executor, algorithm=algorithm, strides=strides,
        filter_sizes=filter_sizes, axis_kinds=frozenset(axis_kinds),
        group_kinds=frozenset(group_kinds), **kw)


#: The registry. Order is display order (README table, error messages);
#: resolution prefers lower cost_hint within a family.
CAPABILITIES: tuple[Capability, ...] = (
    # -- plain winograd family (pure PyTorch executors) --------------------
    _cap("winograd", "winograd", strides=_S1, filter_sizes=_WFS,
         axis_kinds=("two_d",), group_kinds=("dense",),
         compute_dtypes=_LOW_PRECISION,
         note="region-wise multi-channel 2D scheme (paper Fig. 2)"),
    _cap("winograd_1d", "winograd", strides=_S1, filter_sizes=_WFS,
         axis_kinds=("single_axis",), group_kinds=("dense",),
         compute_dtypes=_LOW_PRECISION,
         note="single-axis Cook-Toom (paper's Inception 1xN/Nx1 case)"),
    _cap("winograd_depthwise", "winograd", strides=_S1, filter_sizes=_WFS,
         axis_kinds=("two_d",), group_kinds=("depthwise",),
         compute_dtypes=_LOW_PRECISION,
         note="transform-domain Hadamard phase 2, any channel multiplier"),
    _cap("winograd_grouped", "winograd", strides=_S1, filter_sizes=_WFS,
         axis_kinds=("two_d",), group_kinds=("grouped",),
         compute_dtypes=_LOW_PRECISION,
         note="block-diagonal transform-domain reduction"),
    _cap("winograd_strided", "winograd", strides=_S2, filter_sizes=_SFS,
         axis_kinds=("two_d",),
         group_kinds=("dense", "grouped", "depthwise"), cost_hint=1.5,
         compute_dtypes=_LOW_PRECISION,
         note="stride-2 via transform-domain phase decomposition (4 phase "
              "sub-convolutions sharing one inverse transform)"),
    # -- large-tile F(6,3) winograd (own family: a distinct accuracy/speed
    #    point the measured auto_tuned policy races against F(2,3)/F(4,3)) --
    _cap("winograd_f63", "winograd_f63", strides=_S1,
         filter_sizes=frozenset({3}), axis_kinds=("two_d",),
         group_kinds=("dense",), cost_hint=0.9,
         note="F(6x6, 3x3) with power-of-two row-scaled transforms: 2.25x "
              "fewer point-GEMM flops than F(4,3), fp32 error held to "
              "transforms.F63_FP32_ERROR_BUDGET (fp32-only: the large "
              "tile's transform dynamic range amplifies the bf16/int8 "
              "grid ~8e-2 rel err, past any useful budget)"),
    # -- tiled FFT (rfft2) family ------------------------------------------
    _cap("fft", "fft", strides=_S1, filter_sizes=None,
         axis_kinds=("two_d",), group_kinds=("dense",), cost_hint=3.0,
         note="overlap-tiled rfft2 executor; transform cost per output is "
              "O(log t), independent of filter size (plan-time conjugated "
              "filter spectrum)"),
    # -- im2row GEMM baseline ----------------------------------------------
    _cap("im2col", "im2col", strides=None, filter_sizes=None,
         axis_kinds=("pointwise", "single_axis", "two_d"),
         group_kinds=("dense", "grouped", "depthwise"), cost_hint=9.0,
         compute_dtypes=_LOW_PRECISION,
         note="the paper's baseline; per-group lowering for G>1"),
    # -- streamed winograd family (hand-written kernels) --------------------
    _cap("pallas_winograd", "pallas_winograd", strides=_S1, filter_sizes=_WFS,
         axis_kinds=("two_d",), group_kinds=("dense",), fused_epilogue=True,
         compute_dtypes=_LOW_PRECISION,
         note="halo-streaming kernel; input/output are the only HBM tensors"),
    _cap("winograd_1d", "pallas_winograd", strides=_S1, filter_sizes=_WFS,
         axis_kinds=("single_axis",), group_kinds=("dense",), cost_hint=1.1,
         compute_dtypes=_LOW_PRECISION,
         note="1xN routes to the XLA 1D executor (its GEMM is one matmul)"),
    _cap("pallas_depthwise", "pallas_winograd", strides=_S1,
         filter_sizes=_WFS, axis_kinds=("two_d",), group_kinds=("depthwise",),
         fused_epilogue=True, compute_dtypes=_LOW_PRECISION,
         note="streamed depthwise kernel (Hadamard phase 2 in VMEM, any "
              "channel multiplier)"),
    _cap("pallas_winograd_strided", "pallas_winograd", strides=_S2,
         filter_sizes=_SFS, axis_kinds=("two_d",), group_kinds=("dense",),
         fused_epilogue=True, cost_hint=1.5, compute_dtypes=_LOW_PRECISION,
         note="stride-2 phase decomposition inside the streaming kernel"),
    _cap("pallas_depthwise_strided", "pallas_winograd", strides=_S2,
         filter_sizes=_SFS, axis_kinds=("two_d",), group_kinds=("depthwise",),
         unit_multiplier_only=True, fused_epilogue=True, cost_hint=1.5,
         compute_dtypes=_LOW_PRECISION,
         note="stride-2 streamed depthwise kernel"),
    # -- kernel A/B baselines ----------------------------------------------
    _cap("pallas_winograd_materialized", "pallas_winograd_materialized",
         strides=_S1, filter_sizes=_WFS, axis_kinds=("two_d",),
         group_kinds=("dense",), cost_hint=2.0,
         note="pre-streaming tiles-domain kernel, kept for the streaming A/B"),
    _cap("winograd_1d", "pallas_winograd_materialized", strides=_S1,
         filter_sizes=_WFS, axis_kinds=("single_axis",),
         group_kinds=("dense",), cost_hint=2.1,
         note="1xN routes to the XLA 1D executor"),
    _cap("pallas_im2col", "pallas_im2col", strides=None, filter_sizes=None,
         axis_kinds=("pointwise", "single_axis", "two_d"),
         group_kinds=("dense",), fused_epilogue=True, cost_hint=9.0,
         compute_dtypes=_LOW_PRECISION,
         note="blocked Pallas im2row GEMM baseline"),
)

#: Requestable concrete algorithm families, in registration order.
FAMILIES: tuple[str, ...] = tuple(dict.fromkeys(
    c.algorithm for c in CAPABILITIES))


def family(algorithm: str) -> tuple[Capability, ...]:
    return tuple(c for c in CAPABILITIES if c.algorithm == algorithm)


def matching(q: LayerQuery,
             algorithm: str | None = None) -> tuple[Capability, ...]:
    """All capabilities covering the layer, optionally within one family."""
    caps: Iterable[Capability] = (CAPABILITIES if algorithm is None
                                  else family(algorithm))
    return tuple(c for c in caps if c.matches(q))


def supported(algorithm: str, q: LayerQuery) -> bool:
    """Whether the requested algorithm family has an executor for the layer
    ('auto'/'auto_tuned' always resolve to something)."""
    if algorithm in ("auto", "auto_tuned"):
        return True
    return bool(matching(q, algorithm))


def compute_dtypes_for(executor: str) -> tuple[str, ...]:
    """The transform-domain compute dtypes an executor supports, in
    COMPUTE_DTYPES display order (union over every capability record the
    executor is reachable from). Unknown executors get fp32 only -- the
    always-safe answer."""
    found = set()
    for c in CAPABILITIES:
        if c.executor == executor:
            found |= c.compute_dtypes
    if not found:
        found = {"float32"}
    return tuple(d for d in COMPUTE_DTYPES if d in found)


def best_fast(q: LayerQuery) -> Capability | None:
    """The cheapest matching capability of the plain winograd family, or None
    -- the fast-scheme contender 'auto' and 'auto_tuned' consider."""
    caps = matching(q, "winograd")
    return min(caps, key=lambda c: c.cost_hint) if caps else None


def select_auto(q: LayerQuery) -> Capability:
    """The paper's mixed policy as a registry query: the cheapest fast-scheme
    capability where one matches, the im2row baseline everywhere else."""
    return best_fast(q) or resolve("im2col", q)


def resolve(algorithm: str, q: LayerQuery) -> Capability:
    """Resolve a requested algorithm family onto the matching executor
    capability, or raise a ValueError enumerating the registered executors
    that DO cover the layer."""
    caps = matching(q, algorithm)
    if caps:
        return min(caps, key=lambda c: c.cost_hint)
    raise resolution_error(algorithm, q)


def _layer_str(q: LayerQuery) -> str:
    s = (f"k=({q.kh},{q.kw}) stride=({q.stride[0]},{q.stride[1]}) "
         f"groups={q.groups}")
    if q.group_kind == "depthwise" and q.c_out is not None \
            and q.c_in not in (None, q.c_out):
        s += f" (channel multiplier {q.c_out // q.c_in})"
    if q.layout != "NHWC":
        s += f" layout={q.layout}"
    return s


def resolution_error(algorithm: str, q: LayerQuery) -> ValueError:
    """The one place algorithm-coverage errors are written: states what the
    requested family covers, then enumerates every registered capability
    that does match the layer, with the algorithm= that reaches it."""
    fam = family(algorithm)
    if not fam:
        return ValueError(
            f"unknown algorithm {algorithm!r}; requestable families: "
            f"{FAMILIES + ('auto', 'auto_tuned')}")
    covers = "; ".join(
        f"{c.executor}: filters {c.filters_str}, stride {c.strides_str}, "
        f"groups {c.groups_str}" for c in fam)
    alts = matching(q)
    if alts:
        fixes = ", ".join(
            f"{c.executor} (algorithm={c.algorithm!r})"
            for c in dict.fromkeys(alts))
        fix = f"executors that do cover this layer: {fixes}"
    else:
        fix = "no registered executor covers this layer"
    return ValueError(
        f"algorithm={algorithm!r} has no executor for layer {_layer_str(q)}. "
        f"{algorithm!r} covers [{covers}]. {fix}")


# ---------------------------------------------------------------------------
# Registry fingerprint (artifact cache key)
# ---------------------------------------------------------------------------

def fingerprint() -> str:
    """Stable digest of the declared capability records. Serialized network
    plans (repro_torch.core.compile.NetworkPlan.save) stamp this into the
    artifact header: a saved plan's per-layer executor decisions are only
    valid against the registry that made them, so load() refuses an
    artifact whose fingerprint no longer matches and tells the caller to
    recompile. Frozenset fields are canonicalized (sorted) so the digest is
    stable across processes regardless of hash randomization. The records
    are the JAX package's, so the digest is too."""
    def canon(v):
        if isinstance(v, frozenset):
            return "{" + ",".join(sorted(map(repr, v))) + "}"
        return repr(v)

    body = "\n".join(
        ";".join(f"{f.name}={canon(getattr(c, f.name))}"
                 for f in dataclasses.fields(c))
        for c in CAPABILITIES)
    return hashlib.sha256(body.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Markdown table generation (NetworkPlan.describe() renders through it)
# ---------------------------------------------------------------------------

def markdown_table(header: Sequence[str], rows: Iterable[Sequence]) -> str:
    """Render a GitHub-flavored markdown table: capability_table() and
    NetworkPlan.describe() both render through it."""
    out = ["| " + " | ".join(str(h) for h in header) + " |",
           "| " + " | ".join("---" for _ in header) + " |"]
    for row in rows:
        out.append("| " + " | ".join(str(v) for v in row) + " |")
    return "\n".join(out)


def capability_table() -> str:
    """The registry rendered as the README's algorithm table, one row per
    capability record, as the JAX package's capability_table renders its
    own ("XLA" there names an epilogue left to the compiler: here, to
    plain PyTorch ops after the kernel).

    >>> print(capability_table().splitlines()[2].split("|")[1].strip())
    `winograd`
    """
    rows = [(f"`{c.executor}`", f"`{c.algorithm}`", c.filters_str,
             c.strides_str, c.groups_str, ", ".join(sorted(c.layouts)),
             c.dtypes_str, "in-kernel" if c.fused_epilogue else "XLA")
            for c in CAPABILITIES]
    return markdown_table(
        ["executor", "`algorithm=`", "filters", "strides", "groups",
         "layouts", "compute dtypes", "fused epilogue"], rows)
