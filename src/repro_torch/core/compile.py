"""Graph-level convolution compiler: spec list -> layer IR -> pass pipeline
-> one executable NetworkPlan.

The JAX package's core/compile.py, for the dense path:

  * `LayerIR` -- a declarative graph node (conv2d / pool / concat / add /
    dense / ...). `lower()` turns the models/cnn.py spec lists into IR;
    SeparableConv and InvertedResidual specs lower to their *unfused* conv
    chains.
  * the pass pipeline `lower -> fuse -> place -> bind`:
      - `fuse` rewrites depthwise + pointwise chains into `separable` and
        `inverted_residual` nodes, exactly as the reference does, so both
        packages compile the same graph;
      - `place` maps the caller's global algorithm request onto each node
        via capability-registry queries (the paper's mixed policy: a
        forced family falls back to im2col where it does not cover a layer);
      - `bind` builds the LayerPlans (every per-layer decision and filter
        transform happens here, once) and collects the epilogue constants.
  * `compile(params, graph, *, res, ..., artifact=) -> NetworkPlan`.
    NetworkPlan executes the graph (`apply`, with optional per-layer timing
    hooks and error annotation for a serving supervisor), renders the
    per-layer algorithm table (`describe`), re-places one layer in place
    (`replace_layer`) and round-trips to disk (`save` / `load`): the
    reference's artifact format -- an .npz of the execution-domain weights
    under a versioned JSON header with a per-array sha256 -- so a second
    process starts warm, with no re-planning and no filter transform, and
    each package's `verify_artifact` checks the other's files.

`conv1d` nodes (the Whisper stem of models/audio.py) bind to Conv1DPlans
on (B, T, C) inputs.

`compile(..., mesh=, partition=)` partitions the plan over a 1-D device
mesh (launch/mesh.py; core/partition.py): the batch ("data") or H
("spatial", halo exchange between neighbors), the record persisted in the
artifact header. `load` also reads the artifacts the JAX package saves:
their plan weights are cropped to the logical C / M and padded again for
this package's kernel blocking (core/plan.py:plan_from_artifact).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import time
import zipfile
from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core import partition as _partition
from repro_torch.core import plan as _plan
from repro_torch.core import registry
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.layers import dense_head, pool2d
from repro_torch.obs import profile as _obs_profile
from repro_torch.obs import trace as _obs_trace

#: Artifact format tag and version: the reference's, so both packages
#: read each other's headers and integrity records.
ARTIFACT_FORMAT = "repro.network_plan"
ARTIFACT_VERSION = 5

#: IR ops that bind to a LayerPlan (everything else is structural).
PLAN_OPS = ("conv2d", "conv1d", "separable", "inverted_residual")

_DEPRECATION_WARNED: set[str] = set()


def warn_deprecated(api: str, replacement: str) -> None:
    """Emit one DeprecationWarning per legacy entry point per process (the
    legacy plan_* shims call this on their way into compile())."""
    if api in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(api)
    import warnings
    warnings.warn(
        f"{api} is deprecated; use {replacement} -- the compile() API "
        f"subsumes it (fusion passes, per-layer placement, and "
        f"NetworkPlan.save/load deployment artifacts).",
        DeprecationWarning, stacklevel=3)


class ArtifactMismatchError(ValueError):
    """A saved NetworkPlan artifact cannot be loaded by this build: wrong
    format/version, stale capability registry, dtype/layout mismatch, or
    an array that fails its recorded sha256 integrity digest (storage
    corruption). The message states the mismatch and the fix (recompile +
    save)."""


class LayerExecutionError(RuntimeError):
    """One graph node's executor raised during NetworkPlan.apply. Carries
    `node_id` so a supervisor (repro_torch.runtime.serve) can re-place
    exactly the failing layer onto a fallback executor; the original
    exception is chained as __cause__. Only raised when
    apply(annotate_errors=True)."""

    def __init__(self, node_id: str, cause: BaseException):
        super().__init__(f"layer {node_id!r} failed: {cause!r}")
        self.node_id = node_id


def _array_digest(a: np.ndarray) -> str:
    """sha256 over dtype + shape + raw bytes of one artifact array -- the
    per-array integrity record save() writes and load() verifies (the
    reference's digest, byte for byte). The JAX package digests its bf16
    arrays under the dtype name "bfloat16", and np.load returns them as
    2-byte voids: those digest under that name."""
    a = np.ascontiguousarray(a)
    dtype = ("bfloat16" if a.dtype.kind == "V" and a.dtype.itemsize == 2
             else a.dtype)
    h = hashlib.sha256()
    h.update(f"{dtype}:{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Layer IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerIR:
    """One node of the layer IR: an op name, graph edges (`inputs` name
    producer nodes), and op attributes (filter geometry, activation,
    parameter paths into the params pytree). The graph is a tuple of nodes
    in topological order whose first node is the single `input` and whose
    last node is the network output."""

    id: str
    op: str                    # input | conv2d | conv1d | separable |
                               # inverted_residual | pool | concat | add |
                               # global_avg_pool | dense
    inputs: tuple[str, ...] = ()
    attrs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    block: str | None = None   # origin spec name; fusion rewrites name the
                               # fused node after the shared block


def _is_ir(graph) -> bool:
    return (len(graph) > 0
            and all(isinstance(n, LayerIR) for n in graph))


# ---------------------------------------------------------------------------
# lower: models/cnn.py spec lists -> IR
# ---------------------------------------------------------------------------

def lower(specs: Sequence, c_in: int = 3) -> tuple[LayerIR, ...]:
    """Lower a models/cnn.py spec list to the layer IR. Composite specs
    (SeparableConv, InvertedResidual) lower to their UNFUSED conv chains --
    reconstituting the fused execution units is the fuse pass's job, so
    fusion is a graph rewrite, not a property of the input format. Channel
    counts are tracked through the walk (they determine depthwise groups
    and residual feasibility); spatial shapes are inferred later."""
    from repro_torch.models import cnn as _cnn

    nodes = [LayerIR(id="input", op="input")]
    counter = itertools.count()

    def uid(prefix: str) -> str:
        return f"{prefix}_{next(counter)}"

    def conv_node(nid, head, *, kh, kw, c_out, stride, padding, groups,
                  depthwise, activation, w_path, b_path, block):
        nodes.append(LayerIR(
            id=nid, op="conv2d", inputs=(head,),
            attrs=dict(kh=kh, kw=kw, c_out=c_out, stride=(stride, stride),
                       padding=padding, groups=groups, depthwise=depthwise,
                       activation=activation, w_path=w_path, b_path=b_path),
            block=block))
        return nid

    def walk(specs, head: str, c: int) -> tuple[str, int]:
        for spec in specs:
            if isinstance(spec, _cnn.Conv):
                head = conv_node(
                    spec.name, head, kh=spec.kh, kw=spec.kw,
                    c_out=spec.c_out, stride=spec.stride,
                    padding=spec.padding, groups=spec.groups,
                    depthwise=spec.groups > 1 and spec.groups == c,
                    activation=spec.act, w_path=(spec.name, "w"),
                    b_path=(spec.name, "b"), block=spec.name)
                c = spec.c_out
            elif isinstance(spec, _cnn.SeparableConv):
                head = conv_node(
                    f"{spec.name}.dw", head, kh=spec.k, kw=spec.k, c_out=c,
                    stride=spec.stride, padding=spec.padding, groups=c,
                    depthwise=True, activation="relu",
                    w_path=(spec.name, "dw", "w"),
                    b_path=(spec.name, "dw", "b"), block=spec.name)
                head = conv_node(
                    f"{spec.name}.pw", head, kh=1, kw=1, c_out=spec.c_out,
                    stride=1, padding="SAME", groups=1, depthwise=False,
                    activation="relu", w_path=(spec.name, "pw", "w"),
                    b_path=(spec.name, "pw", "b"), block=spec.name)
                c = spec.c_out
            elif isinstance(spec, _cnn.InvertedResidual):
                src = head
                ce = c * spec.expand
                if spec.expand != 1:
                    head = conv_node(
                        f"{spec.name}.exp", head, kh=1, kw=1, c_out=ce,
                        stride=1, padding="SAME", groups=1, depthwise=False,
                        activation="relu6", w_path=(spec.name, "exp", "w"),
                        b_path=(spec.name, "exp", "b"), block=spec.name)
                head = conv_node(
                    f"{spec.name}.dw", head, kh=spec.k, kw=spec.k, c_out=ce,
                    stride=spec.stride, padding="SAME", groups=ce,
                    depthwise=True, activation="relu6",
                    w_path=(spec.name, "dw", "w"),
                    b_path=(spec.name, "dw", "b"), block=spec.name)
                head = conv_node(
                    f"{spec.name}.pw", head, kh=1, kw=1, c_out=spec.c_out,
                    stride=1, padding="SAME", groups=1, depthwise=False,
                    activation="none", w_path=(spec.name, "pw", "w"),
                    b_path=(spec.name, "pw", "b"), block=spec.name)
                if spec.stride == 1 and c == spec.c_out:
                    add_id = f"{spec.name}.add"
                    nodes.append(LayerIR(id=add_id, op="add",
                                         inputs=(src, head),
                                         block=spec.name))
                    head = add_id
                c = spec.c_out
            elif isinstance(spec, _cnn.Pool):
                pid = uid("pool")
                nodes.append(LayerIR(
                    id=pid, op="pool", inputs=(head,),
                    attrs=dict(kind=spec.kind, k=spec.k, stride=spec.stride,
                               padding=spec.padding)))
                head = pid
            elif isinstance(spec, _cnn.Concat):
                tails, c_total = [], 0
                for br in spec.branches:
                    tail, cb = walk(br, head, c)
                    tails.append(tail)
                    c_total += cb
                cid = uid("concat")
                nodes.append(LayerIR(id=cid, op="concat",
                                     inputs=tuple(tails)))
                head, c = cid, c_total
            elif isinstance(spec, _cnn.GlobalAvgPool):
                gid = uid("gap")
                nodes.append(LayerIR(id=gid, op="global_avg_pool",
                                     inputs=(head,)))
                head = gid
            elif isinstance(spec, _cnn.Dense):
                nodes.append(LayerIR(
                    id=spec.name, op="dense", inputs=(head,),
                    attrs=dict(n_out=spec.n_out, relu=spec.relu,
                               w_path=(spec.name, "w"))))
                head, c = spec.name, spec.n_out
            else:
                raise TypeError(
                    f"cannot lower spec {spec!r}; expected one of the "
                    f"models.cnn layer specs or a pre-lowered LayerIR graph")
        return head, c

    walk(specs, "input", c_in)
    return tuple(nodes)


# ---------------------------------------------------------------------------
# shape inference
# ---------------------------------------------------------------------------

def _out_size(size: int, k: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-size // stride)
    return (size - k) // stride + 1


def infer_shapes(graph: Sequence[LayerIR],
                 input_shape: Sequence[int]) -> dict[str, tuple[int, ...]]:
    """Output shape of every node, walking the graph once."""
    shapes: dict[str, tuple[int, ...]] = {}
    for node in graph:
        a = node.attrs
        if node.op == "input":
            shapes[node.id] = tuple(input_shape)
            continue
        ins = [shapes[i] for i in node.inputs]
        s = ins[0]
        if node.op == "conv2d":
            n, h, w, _ = s
            shapes[node.id] = (
                n, _out_size(h, a["kh"], a["stride"][0], a["padding"]),
                _out_size(w, a["kw"], a["stride"][1], a["padding"]),
                a["c_out"])
        elif node.op in ("separable", "inverted_residual"):
            n, h, w, _ = s
            shapes[node.id] = (
                n, _out_size(h, a["k"], a["stride"][0], a["padding"]),
                _out_size(w, a["k"], a["stride"][1], a["padding"]),
                a["c_out"])
        elif node.op == "conv1d":
            b, t, _ = s
            shapes[node.id] = (
                b, _out_size(t, a["k"], a["stride"], a["padding"]),
                a["c_out"])
        elif node.op == "pool":
            n, h, w, c = s
            shapes[node.id] = (
                n, _out_size(h, a["k"], a["stride"], a["padding"]),
                _out_size(w, a["k"], a["stride"], a["padding"]), c)
        elif node.op == "concat":
            shapes[node.id] = s[:-1] + (sum(i[-1] for i in ins),)
        elif node.op == "add":
            shapes[node.id] = s
        elif node.op == "global_avg_pool":
            shapes[node.id] = (s[0], s[-1])
        elif node.op == "dense":
            shapes[node.id] = (s[0], a["n_out"])
        else:
            raise ValueError(f"unknown IR op {node.op!r} ({node.id})")
    return shapes


# ---------------------------------------------------------------------------
# fuse: registry-aware pattern rewrites
# ---------------------------------------------------------------------------

def _consumers(graph: Sequence[LayerIR]) -> dict[str, list[str]]:
    cons: dict[str, list[str]] = {n.id: [] for n in graph}
    for n in graph:
        for i in n.inputs:
            cons[i].append(n.id)
    return cons


def _rewrite(graph, remove: set, replace: dict) -> tuple[LayerIR, ...]:
    """Drop `remove` nodes, swap pattern tails for their fused nodes, and
    rewire edges that referenced a swapped tail."""
    rename = {old: new.id for old, new in replace.items()}
    out = []
    for n in graph:
        if n.id in remove:
            continue
        n = replace.get(n.id, n)
        out.append(dataclasses.replace(
            n, inputs=tuple(rename.get(i, i) for i in n.inputs)))
    return tuple(out)


def _fused_name(tail: LayerIR, parts: list[LayerIR]) -> str:
    blocks = {p.block for p in parts}
    if len(blocks) == 1 and tail.block:
        return tail.block
    return "+".join(p.id for p in parts if p.op == "conv2d")


def _fuse_inverted_residual(graph: Sequence[LayerIR]) -> tuple[LayerIR, ...]:
    """Pattern: [1x1 expand conv (act)] -> kxk depthwise (same act, mult 1)
    -> 1x1 linear projection [-> residual add with the chain input], each
    intermediate consumed exactly once => one `inverted_residual` node
    (the JAX package binds it to plan_inverted_residual)."""
    by_id = {n.id: n for n in graph}
    cons = _consumers(graph)
    remove: set[str] = set()
    replace: dict[str, LayerIR] = {}
    for pw in graph:
        if pw.op != "conv2d" or pw.id in remove:
            continue
        pa = pw.attrs
        if not (pa["kh"] == pa["kw"] == 1 and pa["groups"] == 1
                and tuple(pa["stride"]) == (1, 1)
                and pa["activation"] == "none"):
            continue
        dw = by_id.get(pw.inputs[0])
        if (dw is None or dw.op != "conv2d"
                or not dw.attrs.get("depthwise")
                or dw.attrs["kh"] != dw.attrs["kw"]
                or dw.attrs["c_out"] != dw.attrs["groups"]   # multiplier 1
                or cons[dw.id] != [pw.id] or dw.id in remove):
            continue
        head = dw.inputs[0]
        exp = by_id.get(head)
        exp_node = None
        if (exp is not None and exp.op == "conv2d" and exp.id not in remove
                and exp.attrs["kh"] == exp.attrs["kw"] == 1
                and exp.attrs["groups"] == 1
                and tuple(exp.attrs["stride"]) == (1, 1)
                and exp.attrs["activation"] == dw.attrs["activation"]
                and cons[exp.id] == [dw.id]):
            exp_node = exp
            head = exp.inputs[0]
        tail, residual = pw, False
        if len(cons[pw.id]) == 1:
            cand = by_id[cons[pw.id][0]]
            if cand.op == "add" and set(cand.inputs) == {head, pw.id}:
                tail, residual = cand, True
        parts = ([exp_node] if exp_node else []) + [dw, pw]
        attrs = dict(
            k=dw.attrs["kh"], stride=tuple(dw.attrs["stride"]),
            padding=dw.attrs["padding"], c_out=pa["c_out"],
            activation=dw.attrs["activation"], residual=residual,
            exp_w=exp_node.attrs["w_path"] if exp_node else None,
            exp_b=exp_node.attrs["b_path"] if exp_node else None,
            dw_w=dw.attrs["w_path"], dw_b=dw.attrs["b_path"],
            pw_w=pw.attrs["w_path"], pw_b=pw.attrs["b_path"])
        fused = LayerIR(id=_fused_name(tail, parts), op="inverted_residual",
                        inputs=(head,), attrs=attrs,
                        block=tail.block or dw.block)
        replace[tail.id] = fused
        remove |= {p.id for p in parts} - {tail.id}
    return _rewrite(graph, remove, replace) if replace else tuple(graph)


def _fuse_separable(graph: Sequence[LayerIR]) -> tuple[LayerIR, ...]:
    """Pattern: kxk depthwise conv consumed exactly once by a stride-1
    dense 1x1 conv => one `separable` node (the JAX package binds it to
    plan_separable_block, fused or composed)."""
    by_id = {n.id: n for n in graph}
    cons = _consumers(graph)
    remove: set[str] = set()
    replace: dict[str, LayerIR] = {}
    for pw in graph:
        if pw.op != "conv2d" or pw.id in remove:
            continue
        pa = pw.attrs
        if not (pa["kh"] == pa["kw"] == 1 and pa["groups"] == 1
                and tuple(pa["stride"]) == (1, 1)):
            continue
        dw = by_id.get(pw.inputs[0])
        if (dw is None or dw.op != "conv2d"
                or not dw.attrs.get("depthwise")
                or dw.attrs["kh"] != dw.attrs["kw"]
                or cons[dw.id] != [pw.id] or dw.id in remove):
            continue
        attrs = dict(
            k=dw.attrs["kh"], stride=tuple(dw.attrs["stride"]),
            padding=dw.attrs["padding"], c_out=pa["c_out"],
            inner_activation=dw.attrs["activation"],
            activation=pa["activation"],
            dw_w=dw.attrs["w_path"], dw_b=dw.attrs["b_path"],
            pw_w=pa["w_path"], pw_b=pa["b_path"])
        fused = LayerIR(id=_fused_name(pw, [dw, pw]), op="separable",
                        inputs=dw.inputs, attrs=attrs,
                        block=pw.block or dw.block)
        replace[pw.id] = fused
        remove.add(dw.id)
    return _rewrite(graph, remove, replace) if replace else tuple(graph)


#: The fusion pass pipeline, most specific pattern first (the inverted
#: residual's linear-projection chain would otherwise be half-claimed by the
#: generic separable rewrite).
FUSION_PASSES = (_fuse_inverted_residual, _fuse_separable)


def fuse(graph: Sequence[LayerIR]) -> tuple[LayerIR, ...]:
    """Run the registered fusion rewrites over the IR."""
    for p in FUSION_PASSES:
        graph = p(graph)
    return tuple(graph)


# ---------------------------------------------------------------------------
# place: per-node algorithm decisions (registry queries)
# ---------------------------------------------------------------------------

def place(graph: Sequence[LayerIR], shapes: dict[str, tuple[int, ...]],
          algorithm: str = "auto",
          compute_dtype: str = "float32") -> dict[str, dict]:
    """Map the global algorithm request onto each plan-bearing node. A
    forced family falls back to im2col on layers its executors do not cover
    (the paper's mixed policy applied to a forced setting) -- a capability-
    registry query.
    The same per-layer fallback applies to a reduced compute_dtype: a conv
    layer none of whose covering executors declare the dtype is placed back
    at fp32 instead of refusing the whole network. Block nodes (separable /
    inverted residual) keep the family request: their plan builders run
    their own capability-aware internal placement."""
    placements: dict[str, dict] = {}
    for node in graph:
        if node.op not in PLAN_OPS:
            continue
        a = node.attrs
        if node.op == "conv2d":
            c_in = shapes[node.inputs[0]][-1]
            groups = c_in if a.get("depthwise") else a["groups"]
            q = registry.as_query(a["kh"], a["kw"], tuple(a["stride"]),
                                  groups=groups, c_in=c_in, c_out=a["c_out"])
            alg = (algorithm if registry.supported(algorithm, q)
                   else "im2col")
            cd = compute_dtype
            if cd != "float32":
                fam = None if alg in ("auto", "auto_tuned") else alg
                if not any(cd in cap.compute_dtypes
                           for cap in registry.matching(q, fam)):
                    cd = "float32"
            placements[node.id] = {"algorithm": alg, "groups": groups,
                                   "compute_dtype": cd}
        else:
            placements[node.id] = {"algorithm": algorithm,
                                   "compute_dtype": compute_dtype}
    return placements


# ---------------------------------------------------------------------------
# bind: build the LayerPlans + epilogue constants
# ---------------------------------------------------------------------------

def _param(params, path):
    v = params
    for k in path:
        v = v[k]
    return v


#: attrs keys that are tuples in memory but lists in the JSON header.
_TUPLE_ATTRS = ("stride", "w_path", "b_path", "dw_w", "dw_b", "pw_w",
                "pw_b", "exp_w", "exp_b")


def _node_to_json(n: LayerIR) -> dict:
    attrs = {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in n.attrs.items()}
    return {"id": n.id, "op": n.op, "inputs": list(n.inputs),
            "attrs": attrs, "block": n.block}


def _node_from_json(d: dict) -> LayerIR:
    attrs = dict(d["attrs"])
    for k in _TUPLE_ATTRS:
        if isinstance(attrs.get(k), list):
            attrs[k] = tuple(attrs[k])
    return LayerIR(id=d["id"], op=d["op"], inputs=tuple(d["inputs"]),
                   attrs=attrs, block=d.get("block"))


def bind(graph: Sequence[LayerIR], shapes: dict[str, tuple[int, ...]],
         placements: dict[str, dict], params, *, dtype=None,
         device=None) -> tuple[dict, dict]:
    """Build one LayerPlan per plan-bearing node (every per-layer decision
    and every filter transform happens here, once) and collect the
    epilogue constants (biases, dense weights) on `device`."""
    device = resolve_device(device)
    plans: dict[str, Any] = {}
    consts: dict[str, torch.Tensor] = {}

    def const(nid, tag, path):
        if path is not None:
            consts[f"{nid}.{tag}"] = torch.as_tensor(_param(params, path),
                                                     device=device)

    for node in graph:
        a = node.attrs
        in_shape = shapes[node.inputs[0]] if node.inputs else None
        if node.op == "conv2d":
            pl = placements[node.id]
            plans[node.id] = _plan.plan_conv2d(
                in_shape, _param(params, a["w_path"]),
                stride=tuple(a["stride"]), padding=a["padding"],
                groups=pl["groups"], algorithm=pl["algorithm"], dtype=dtype,
                compute_dtype=pl.get("compute_dtype", "float32"),
                device=device)
            const(node.id, "b", a.get("b_path"))
        elif node.op == "separable":
            pl = placements[node.id]
            plans[node.id] = _plan.plan_separable_block(
                in_shape, _param(params, a["dw_w"]),
                _param(params, a["pw_w"]), stride=tuple(a["stride"]),
                padding=a["padding"], algorithm=pl["algorithm"],
                dtype=dtype, compute_dtype=pl.get("compute_dtype", "float32"),
                device=device)
            const(node.id, "b_dw", a.get("dw_b"))
            const(node.id, "b_pw", a.get("pw_b"))
        elif node.op == "inverted_residual":
            pl = placements[node.id]
            p = _plan.plan_inverted_residual(
                in_shape,
                _param(params, a["exp_w"]) if a.get("exp_w") else None,
                _param(params, a["dw_w"]), _param(params, a["pw_w"]),
                stride=tuple(a["stride"]), padding=a["padding"],
                algorithm=pl["algorithm"], dtype=dtype,
                compute_dtype=pl.get("compute_dtype", "float32"),
                device=device)
            # the graph is the source of truth for the skip edge (a
            # hand-built IR may omit the add even where shapes allow it)
            p.residual = a["residual"]
            plans[node.id] = p
            const(node.id, "b_exp", a.get("exp_b"))
            const(node.id, "b_dw", a.get("dw_b"))
            const(node.id, "b_pw", a.get("pw_b"))
        elif node.op == "conv1d":
            plans[node.id] = _plan.plan_conv1d(
                in_shape, _param(params, a["w_path"]), stride=a["stride"],
                padding=a["padding"],
                algorithm=placements[node.id]["algorithm"], device=device)
            const(node.id, "b", a.get("b_path"))
        elif node.op == "dense":
            const(node.id, "w", a["w_path"])
    return plans, consts


# ---------------------------------------------------------------------------
# NetworkPlan: the compiled, executable network
# ---------------------------------------------------------------------------

class NetworkPlan(nn.Module):
    """A compiled network: the layer IR, one bound LayerPlan per conv,
    separable or inverted-residual node, and the epilogue constants.
    apply(x) executes the graph with zero
    per-call filter-transform or geometry work. The plans are registered
    submodules; `plans` maps node id to plan, and every swap of a bound
    plan goes through `set_plan`, which keeps the two consistent. `apply`
    is the network's forward and shadows nn.Module.apply.

    `partition` is the partition record (core/partition.py; plans bound at
    shard-local geometry when num_shards > 1), persisted in the artifact
    header; `mesh` is the live launch.mesh.Mesh it runs over, never
    serialized -- load() leaves it None, with_mesh() re-attaches one."""

    def __init__(self, graph: tuple[LayerIR, ...], plans: dict[str, Any],
                 consts: dict[str, torch.Tensor], input_shape, algorithm: str,
                 dtype: str, compute_dtype: str = "float32",
                 build_time_s: float = 0.0,
                 params_digest: str | None = None,
                 partition: dict | None = None, mesh=None):
        super().__init__()
        self.partition = partition
        self.mesh = mesh
        self.graph = graph
        self.plans = plans
        # registered under index names: node ids may hold '.'
        self._plan_modules = nn.ModuleList(plans.values())
        self.consts = consts
        self.input_shape = tuple(input_shape)
        self.algorithm = algorithm
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self.build_time_s = build_time_s
        # digest of the raw params the plan was compiled from;
        # compile(artifact=) and replace_layer refuse weights that differ
        self.params_digest = params_digest
        # bumped by invalidate_executables (see there)
        self.generation = 0

    @property
    def device(self) -> torch.device:
        """The device the bound plans' buffers live on."""
        return next(itertools.chain(self.buffers(),
                                    self.consts.values())).device

    def invalidate_executables(self) -> None:
        """Mark every executable captured from this network stale and drop
        the cached sharded program. Anything that swaps a bound plan
        (set_plan, replace_layer, the fault-injection harness) calls this.
        A caller that caches an executable of the forward -- the serving
        runtime's per-bucket CUDA graph -- keys it on `generation` and the
        plans' identities, so a swap forces a re-capture instead of
        replaying the old plan."""
        self.__dict__.pop("_sharded_fn", None)
        self.generation += 1

    def is_sharded(self) -> bool:
        return (self.partition is not None
                and self.partition.get("num_shards", 1) > 1)

    def with_mesh(self, mesh) -> "NetworkPlan":
        """Attach a device mesh to a partitioned plan (artifacts do not
        serialize meshes). Validates the mesh's partition axis against the
        recorded shard count; returns self. The plans stay where they are
        bound; the sharded program copies them to each other distinct
        device of the mesh."""
        if self.partition is None:
            raise ValueError(
                "this NetworkPlan was compiled without a partition; "
                "recompile with compile(mesh=...) to shard it")
        axis, n = _partition.mesh_num_shards(mesh)
        want = self.partition["num_shards"]
        if self.is_sharded() and (axis != self.partition["axis"]
                                  or n != want):
            raise ValueError(
                f"mesh axis {axis!r} x{n} does not match the recorded "
                f"partition ({self.partition['axis']!r} x{want}); build a "
                f"matching mesh (launch.mesh.make_data_mesh({want})) or "
                f"recompile with mesh=")
        self.mesh = mesh
        self.invalidate_executables()
        return self

    def _sharded_callable(self):
        fn = self.__dict__.get("_sharded_fn")
        if fn is None:
            fn = _partition.build_sharded_fn(self)
            self.__dict__["_sharded_fn"] = fn
        return fn

    def set_plan(self, node_id: str, plan: nn.Module) -> None:
        """Bind `plan` to `node_id`: `plans` and the registered submodules
        stay one list (so `.to()` and `state_dict` reach the new plan and
        drop the old), and cached executables are invalidated."""
        if node_id not in self.plans:
            raise KeyError(f"{node_id!r} is not a plan-bearing node; have "
                           f"{sorted(self.plans)}")
        self.plans[node_id] = plan
        self._plan_modules = nn.ModuleList(self.plans.values())
        self.invalidate_executables()

    def __getitem__(self, node_id: str):
        """The plan bound to `node_id` (the legacy dict interface the
        plan_cnn / plan_stem shims return)."""
        return self.plans[node_id]

    def get(self, node_id: str, default=None):
        return self.plans.get(node_id, default)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def apply(self, x: torch.Tensor, *, layer_hook=None,
              annotate_errors: bool = False) -> torch.Tensor:
        """Execute the graph. `layer_hook(node_id, seconds)` is called
        after every plan-bearing node with its synchronous wall time (on
        the card the device is synchronized before and after the node, so
        the time is the node's own; never capture an apply with a hook).
        `annotate_errors=True` wraps any exception a node raises in
        LayerExecutionError carrying the node id, so a serving supervisor
        can re-place exactly the failing layer.

        With profiling on (repro_torch.obs.profile), every node the walk
        runs gets a host span `layer:<node_id>` (planned nodes tagged with
        their executor, the others with their op) and, on the card, its
        device-timed `gpu:` twin, which synchronizes nothing; an inverted
        residual adds `/expand`, `/separable` and `/residual` children.

        A plan compiled with a partition over >1 shards routes through the
        sharded program (core/partition.py:build_sharded_fn) instead of
        the eager walk (hooks and error annotation need the
        single-logical-device plan)."""
        if self.is_sharded():
            if layer_hook is not None or annotate_errors:
                raise ValueError(
                    "layer_hook / annotate_errors need the eager "
                    "single-device walk, but this plan is partitioned "
                    f"({self.partition['kind']} x"
                    f"{self.partition['num_shards']}); compile without "
                    "mesh= for supervised execution")
            if self.mesh is None:
                raise ValueError(
                    f"this NetworkPlan records a {self.partition['kind']} "
                    f"partition over {self.partition['num_shards']} shards "
                    f"but no mesh is attached (artifacts never serialize "
                    f"device meshes); call "
                    f".with_mesh(launch.mesh.make_data_mesh("
                    f"{self.partition['num_shards']})) first")
            return self._sharded_callable()(x)
        return self._eval_graph(x, layer_hook=layer_hook,
                                annotate_errors=annotate_errors)

    def _eval_graph(self, x: torch.Tensor, *, layer_hook=None,
                    annotate_errors: bool = False) -> torch.Tensor:
        """The eager graph walk. Each activation is dropped after its last
        consumer runs, so only the live frontier stays in memory."""
        prof = _obs_profile.active()    # ONE global read; None = off
        remaining = {nid: len(cons)
                     for nid, cons in _consumers(self.graph).items()}
        env = {"input": x}
        c = self.consts
        sync = layer_hook is not None and x.is_cuda
        # the walk's device spans share one event per node boundary
        chain = (prof.tracer.device_chain(x.is_cuda) if prof is not None
                 else _obs_trace.NULL_SPAN)
        with chain:
            for node in self.graph[1:]:
                v = env[node.inputs[0]] if node.inputs else None
                t0 = None
                if layer_hook is not None and node.id in self.plans:
                    if sync:
                        torch.cuda.synchronize(x.device)
                    t0 = time.perf_counter()
                try:
                    if prof is None:
                        y = self._eval_node(node, node.attrs, v, env, c)
                    else:
                        y = self._eval_node_traced(chain, node, v, env, c)
                except Exception as e:
                    if (annotate_errors
                            and not isinstance(e, LayerExecutionError)):
                        raise LayerExecutionError(node.id, e) from e
                    raise
                if t0 is not None:
                    if sync:
                        torch.cuda.synchronize(x.device)
                    layer_hook(node.id, time.perf_counter() - t0)
                env[node.id] = y
                for i in node.inputs:
                    remaining[i] -= 1
                    if remaining[i] == 0:
                        del env[i]
        return env[self.graph[-1].id]

    def _eval_node_traced(self, chain, node, v, env, c):
        """_eval_node inside the node's `layer:` span and its `gpu:` twin
        in the walk's device chain; an inverted residual's three steps get
        child spans."""
        name = f"layer:{node.id}"
        plan = self.plans.get(node.id)
        label = ({"executor": self._executor_label(node.id, plan)}
                 if plan is not None else {"op": node.op})
        step = None
        if node.op == "inverted_residual":
            def step(part):
                return chain.span(f"{name}/{part}")
        with chain.span(name, **label):
            return self._eval_node(node, node.attrs, v, env, c, step)

    def _executor_label(self, node_id: str, plan) -> str:
        """The executor a bound plan describes, cached per plan object (a
        swap binds a new object: set_plan)."""
        cache = self.__dict__.setdefault("_executor_labels", {})
        hit = cache.get(node_id)
        if hit is None or hit[0] is not plan:
            try:
                label = str(plan.describe().get("executor",
                                                type(plan).__name__))
            except Exception:                  # noqa: BLE001 - a label only
                label = type(plan).__name__
            hit = cache[node_id] = (plan, label)
        return hit[1]

    def _eval_node(self, node, a, v, env, c, step=None):
        if node.op == "conv2d":
            return self.plans[node.id].apply(
                v, bias=c.get(f"{node.id}.b"), activation=a["activation"])
        if node.op == "separable":
            return self.plans[node.id].apply(
                v, bias_dw=c.get(f"{node.id}.b_dw"),
                bias_pw=c.get(f"{node.id}.b_pw"),
                inner_activation=a["inner_activation"],
                activation=a["activation"])
        if node.op == "inverted_residual":
            return self.plans[node.id].apply(
                v, bias_exp=c.get(f"{node.id}.b_exp"),
                bias_dw=c.get(f"{node.id}.b_dw"),
                bias_pw=c.get(f"{node.id}.b_pw"),
                activation=a["activation"], step=step)
        if node.op == "conv1d":
            return self.plans[node.id].apply(
                v, bias=c.get(f"{node.id}.b"), activation=a["activation"])
        if node.op == "pool":
            return pool2d(v, a["kind"], a["k"], a["stride"], a["padding"])
        if node.op == "concat":
            return torch.cat([env[i] for i in node.inputs], dim=-1)
        if node.op == "add":
            return env[node.inputs[0]] + env[node.inputs[1]]
        if node.op == "global_avg_pool":
            return torch.mean(v, dim=(1, 2))
        if node.op == "dense":
            return dense_head(v, c[f"{node.id}.w"], a["relu"])
        raise ValueError(f"unknown IR op {node.op!r} ({node.id})")

    @property
    def out_shape(self) -> tuple[int, ...]:
        return infer_shapes(self.graph, self.input_shape)[self.graph[-1].id]

    def describe(self) -> str:
        """The per-layer algorithm table, in the same columns as the JAX
        package's NetworkPlan.describe()."""
        shapes = infer_shapes(self.graph, self.input_shape)
        rows = []
        for node in self.graph:
            if node.id not in self.plans:
                continue
            d = self.plans[node.id].describe()
            rows.append((node.id, d["kind"], f"`{d['executor']}`",
                         d["filter"], d["stride"], d["groups"], d["tile"],
                         d.get("compute_dtype", "float32"),
                         d.get("decision", "static"),
                         "x".join(map(str, shapes[node.id]))))
        return registry.markdown_table(
            ["layer", "kind", "executor", "filter", "stride", "groups",
             "tile", "compute", "decision", "output"], rows)

    def replace_layer(self, node_id: str, params, *,
                      algorithm: str = "im2col",
                      compute_dtype: str = "float32") -> Any:
        """Re-place ONE plan-bearing node onto a different algorithm family
        (and/or transform-domain compute dtype) and re-bind its plan (and
        epilogue constants) from the raw params, on this network's device
        -- the serving supervisor's degrade path when a layer's executor
        misbehaves, and its precision promotion path when a
        reduced-precision layer trips the accuracy probe
        (compute_dtype="float32" is the always-safe landing spot). The
        replacement is a capability-registry placement, exactly like
        compile-time place(): an algorithm the registry does not cover for
        this layer raises the registry's resolution error. Returns the
        freshly bound plan. `params` must be the pytree the network was
        compiled from (checked against params_digest when the plan carries
        one)."""
        if self.is_sharded():
            raise ValueError(
                "replace_layer operates on single-logical-device plans "
                f"(this one is partitioned {self.partition['kind']} x"
                f"{self.partition['num_shards']}); supervisor repairs run "
                "on the unsharded plan, which is then recompiled with "
                "mesh= if sharding should resume")
        by_id = {n.id: n for n in self.graph}
        node = by_id.get(node_id)
        if node is None or node.op not in PLAN_OPS:
            raise ValueError(
                f"{node_id!r} is not a plan-bearing node; replaceable "
                f"layers: {sorted(self.plans)}")
        if self.params_digest is not None \
                and params_digest(params) != self.params_digest:
            raise ValueError(
                "params do not match the weights this NetworkPlan was "
                "compiled from (params_digest mismatch); re-placement from "
                "foreign weights would silently change the served model")
        shapes = infer_shapes(self.graph, self.input_shape)
        a = node.attrs
        if node.op == "conv2d":
            c_in = shapes[node.inputs[0]][-1]
            groups = c_in if a.get("depthwise") else a["groups"]
            q = registry.as_query(a["kh"], a["kw"], tuple(a["stride"]),
                                  groups=groups, c_in=c_in, c_out=a["c_out"])
            if not registry.supported(algorithm, q):
                raise registry.resolution_error(algorithm, q)
            placement = {"algorithm": algorithm, "groups": groups,
                         "compute_dtype": compute_dtype}
        else:
            placement = {"algorithm": algorithm,
                         "compute_dtype": compute_dtype}
        plans, consts = bind((node,), shapes, {node_id: placement}, params,
                             dtype=self.dtype, device=self.device)
        self.consts.update(consts)
        self.set_plan(node_id, plans[node_id])
        return self.plans[node_id]

    # ---- serialization ---------------------------------------------------

    def save(self, path: str) -> None:
        """Serialize the compiled network: a versioned JSON header (graph,
        per-layer plan metas with their kernel blocking,
        dtype/layout/registry-fingerprint cache keys) plus every
        execution-domain weight array, in one .npz file, with a sha256 per
        array. A second process NetworkPlan.load()s this and starts warm:
        no re-planning, no filter-transform work."""
        header = {
            "format": ARTIFACT_FORMAT,
            "version": ARTIFACT_VERSION,
            "registry_fingerprint": registry.fingerprint(),
            "torch_version": torch.__version__,
            "dtype": self.dtype,
            "compute_dtype": self.compute_dtype,
            "layout": "NHWC",
            "input_shape": list(self.input_shape),
            "algorithm": self.algorithm,
            "params_digest": self.params_digest,
            "partition": self.partition,
            "graph": [_node_to_json(n) for n in self.graph],
            "plans": {},
        }
        arrays: dict[str, np.ndarray] = {}
        for nid, p in self.plans.items():
            meta, arr = p.to_artifact()
            header["plans"][nid] = meta
            for k, v in arr.items():
                arrays[f"plan:{nid}:{k}"] = v
        for k, v in self.consts.items():
            arrays[f"const:{k}"] = _plan._to_artifact(v)
        # Per-array integrity digests: load() re-hashes every array against
        # these, so silent corruption between save and load is detected
        # instead of silently serving wrong outputs.
        header["checksums"] = {k: _array_digest(v) for k, v in arrays.items()}
        arrays["__header__"] = np.array(json.dumps(header))
        # atomic emit: a crash mid-write must never leave a truncated file
        # at the final path
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    @classmethod
    def load(cls, path: str, *, expect_dtype=None,
             expect_layout: str | None = None, device=None,
             _record: bool = True) -> "NetworkPlan":
        """Load a saved artifact onto `device` (None means the CUDA
        device). Refuses -- with the mismatch and the fix spelled out --
        when the header does not match this build: wrong format or
        version, a capability registry whose fingerprint changed since the
        plan was compiled, a dtype/layout other than the caller expects,
        or an array that fails its digest. An artifact the JAX package
        saved (a header without `torch_version`) loads too: after its
        digests pass, each plan's weights are cropped to the logical C / M
        and padded again for the blocking this package's choosers pick
        (plan.plan_from_artifact(foreign=True)). A partitioned artifact
        loads with no mesh attached (with_mesh()).
        Successful loads count as artifact hits in plan_cache_info()
        (compile(artifact=) passes _record=False and does its own
        one-hit-or-one-miss accounting per warm-start attempt)."""
        device = resolve_device(device)
        fix = ("; recompile with repro_torch.core.compile.compile(...) and "
               "save() a fresh artifact")

        def refuse(msg: str) -> ArtifactMismatchError:
            if _record:
                _plan.record_artifact_load(False)
            return ArtifactMismatchError(msg + fix)

        with np.load(path, allow_pickle=False) as data:
            if "__header__" not in data:
                raise refuse(f"{path} is not a serialized NetworkPlan "
                             f"(no header)")
            header = json.loads(str(data["__header__"][()]))
            if header.get("format") != ARTIFACT_FORMAT:
                raise refuse(
                    f"{path} has format {header.get('format')!r}, expected "
                    f"{ARTIFACT_FORMAT!r}")
            if header.get("version") != ARTIFACT_VERSION:
                raise refuse(
                    f"{path} is artifact version {header.get('version')}, "
                    f"this build reads version {ARTIFACT_VERSION}")
            if header.get("registry_fingerprint") != registry.fingerprint():
                raise refuse(
                    f"{path} was compiled against capability registry "
                    f"{header.get('registry_fingerprint')}, but this "
                    f"build's registry is {registry.fingerprint()} -- the "
                    f"saved per-layer executor decisions may be stale")
            if expect_dtype is not None and _plan.dtype_name(
                    expect_dtype) != header.get("dtype"):
                raise refuse(
                    f"{path} holds {header.get('dtype')} weights, caller "
                    f"expects {_plan.dtype_name(expect_dtype)}")
            if header.get("layout") not in registry.LAYOUTS or (
                    expect_layout is not None
                    and expect_layout != header.get("layout")):
                raise refuse(
                    f"{path} uses layout {header.get('layout')!r}, "
                    f"expected {expect_layout or '/'.join(registry.LAYOUTS)}")
            checksums = header.get("checksums", {})
            payload = [k for k in data.files if k != "__header__"]
            missing = sorted(set(checksums) - set(payload))
            if missing:
                raise refuse(
                    f"{path} is missing array(s) {missing} recorded in its "
                    f"integrity header -- the artifact is truncated or "
                    f"corrupt")
            for k in payload:
                expect = checksums.get(k)
                if expect is None or _array_digest(data[k]) != expect:
                    raise refuse(
                        f"{path} array {k!r} fails its sha256 integrity "
                        f"digest -- the artifact is corrupt on disk")
            foreign = "torch_version" not in header
            graph = tuple(_node_from_json(d) for d in header["graph"])
            plans = {}
            for nid, meta in header["plans"].items():
                arrays = {k.split(":", 2)[2]: data[k] for k in data.files
                          if k.startswith(f"plan:{nid}:")}
                plans[nid] = _plan.plan_from_artifact(meta, arrays, device,
                                                      foreign=foreign)
            consts = {k[len("const:"):]: _plan._from_artifact(
                data[k], device, header["dtype"] == "bfloat16")
                for k in data.files if k.startswith("const:")}
        if _record:
            _plan.record_artifact_load(True)
        return cls(graph, plans, consts, tuple(header["input_shape"]),
                   header["algorithm"], header["dtype"],
                   compute_dtype=header["compute_dtype"],
                   params_digest=header.get("params_digest"),
                   partition=header.get("partition"))


def verify_artifact(path: str) -> list[str]:
    """Integrity-check a saved NetworkPlan artifact against its per-array
    sha256 digests WITHOUT loading it as a plan. Returns the names of the
    offending arrays (missing from the file, or failing their digest), or
    `["__header__"]` when the file itself is unreadable / has no integrity
    header -- an empty list means the artifact is intact. Reads the JAX
    package's artifacts too (same format). The serving supervisor runs
    this to decide between 'executor bug' (artifact intact, re-place the
    layer) and 'corrupt artifact' (recompile in place)."""
    try:
        with np.load(path, allow_pickle=False) as data:
            if "__header__" not in data:
                return ["__header__"]
            header = json.loads(str(data["__header__"][()]))
            checksums = header.get("checksums")
            if not isinstance(checksums, dict):
                return ["__header__"]
            payload = [k for k in data.files if k != "__header__"]
            bad = sorted(set(checksums) - set(payload))
            for k in payload:
                expect = checksums.get(k)
                if expect is None or _array_digest(data[k]) != expect:
                    bad.append(k)
            return bad
    except _ARTIFACT_FALLBACK_ERRORS:
        return ["__header__"]


def params_digest(params) -> str:
    """Order-independent digest of a params pytree (dict-of-dicts of
    tensors or arrays): key paths + dtypes + shapes + raw bytes -- the
    reference's digest, so the JAX package's params and the same params
    carried into this package digest alike. compile(artifact=) stamps this
    into the artifact and refuses to warm-start from an artifact whose
    weights no longer match the params in hand."""
    h = hashlib.sha256()

    def walk(node, prefix):
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}")
            return
        if isinstance(node, torch.Tensor):
            t = node.detach().cpu().contiguous()
            dtype, shape = _plan.dtype_name(t.dtype), tuple(t.shape)
            raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        else:
            a = np.ascontiguousarray(np.asarray(node))
            dtype, shape, raw = a.dtype, a.shape, a.tobytes()
        h.update(f"{prefix}:{dtype}:{shape}".encode())
        h.update(raw)

    walk(params, "")
    return h.hexdigest()[:16]


#: Errors a warm-start attempt treats as "artifact unusable, recompile":
#: header mismatches, plus anything a truncated / corrupt / foreign file
#: can raise out of np.load or the header parse. Genuine bugs (TypeError,
#: AssertionError, ...) still propagate.
_ARTIFACT_FALLBACK_ERRORS = (ArtifactMismatchError, OSError, EOFError,
                             KeyError, ValueError, zipfile.BadZipFile,
                             json.JSONDecodeError)


def _try_load_artifact(path: str, *, input_shape, algorithm, digest: str,
                       dtype=None, compute_dtype: str = "float32",
                       device=None, mesh=None,
                       partition: str | None = None) -> NetworkPlan | None:
    """The compile(artifact=) warm-start attempt: load without counting,
    then validate the artifact against THIS call's arguments -- input
    shape, algorithm request, params digest, compute_dtype policy, the
    partition request (kind + shard count vs the recorded record) and
    (when explicitly requested) dtype -- so a stale artifact (different
    resolution, different policy, retrained weights, other precision or
    mesh shape) recompiles instead of silently serving old decisions.
    A partition-matched artifact gets the caller's mesh attached; its
    recorded modes/halos are used verbatim (no re-deciding). Returns None
    when the artifact is unusable; the caller does the one-miss
    accounting."""
    try:
        loaded = NetworkPlan.load(path, device=device, _record=False)
    except _ARTIFACT_FALLBACK_ERRORS:
        return None
    if (loaded.input_shape != tuple(input_shape)
            or loaded.algorithm != algorithm
            or loaded.params_digest != digest
            or loaded.compute_dtype != compute_dtype
            or (dtype is not None
                and loaded.dtype != _plan.dtype_name(dtype))):
        return None
    part = loaded.partition
    if mesh is None:
        if part is not None:
            return None
    else:
        axis, n = _partition.mesh_num_shards(mesh)
        want_kind = partition or "data"
        if (part is None or part["kind"] != want_kind
                or part["axis"] != axis
                or part.get("requested_shards", part["num_shards"]) != n):
            return None
        loaded.mesh = mesh
    return loaded


def _bind_partitioned(ir, shapes, placements, params, part: dict, dtype,
                      device) -> tuple[dict, dict]:
    """bind() under a partition record: data-parallel plans bind at the
    local batch; spatial halo-mode plans bind VALID at their exchanged
    local strip; full-mode (re-gathered) nodes bind at the global shape."""
    if part["kind"] == "data":
        return bind(ir, _partition.local_bind_shapes(part, shapes),
                    placements, params, dtype=dtype, device=device)
    plans: dict[str, Any] = {}
    consts: dict[str, torch.Tensor] = {}
    modes = part["modes"]
    for node in ir:
        if not node.inputs:
            continue
        if node.op in PLAN_OPS and modes.get(node.id) == "halo":
            node_v = dataclasses.replace(
                node, attrs={**node.attrs, "padding": "VALID"})
            in_shape = _partition.spatial_halo_in_shape(part, node, shapes)
            p, cs = bind((node_v,), {node.inputs[0]: in_shape}, placements,
                         params, dtype=dtype, device=device)
        elif node.op in PLAN_OPS or node.op == "dense":
            p, cs = bind((node,), {node.inputs[0]: shapes[node.inputs[0]]},
                         placements, params, dtype=dtype, device=device)
        else:
            continue
        plans.update(p)
        consts.update(cs)
    return plans, consts


def compile(params, graph, *, res: int | None = None, c_in: int = 3,
            batch: int = 1, algorithm: str = "auto",
            input_shape: Sequence[int] | None = None, dtype=None,
            compute_dtype="float32", artifact: str | None = None,
            device=None, mesh=None,
            partition: str | None = None) -> NetworkPlan:
    """Compile a network description into one NetworkPlan on `device`
    (None means the CUDA device; pass device="cpu" for the plain versions).

    `graph` is a models/cnn.py spec list (lowered to the layer IR here) or
    a pre-lowered tuple of LayerIR nodes (models/audio.py:stem_graph). The
    pass pipeline runs lower -> fuse -> place -> bind. `res` describes an
    image network's (batch, res, res, c_in) input; sequence networks pass
    `input_shape` (batch, T, C) instead.
    `algorithm` is the global request (plan.ALGORITHMS); uncovered layers
    fall back to im2col, the paper's mixed policy. `compute_dtype` is the
    network-level transform-domain precision policy, with the same
    per-layer fp32 fallback.

    With `artifact=path`, compile() first tries NetworkPlan.load(path) and
    validates the artifact against THIS call (input shape, algorithm,
    params digest, compute dtype) -- a usable artifact is the warm start
    (one artifact hit in plan_cache_info()); a missing, corrupt,
    header-mismatched or argument-stale artifact falls back to a cold
    compile whose result is saved back to `path` (one artifact miss).
    Each pass runs under a `compile.*` trace span (repro_torch.obs.trace).

    With `mesh=` (launch.mesh.make_data_mesh), the plan executes sharded
    over the mesh's "data" axis: `partition="data"` (the default) shards
    the batch dim with weights replicated; `partition="spatial"` splits H
    across the mesh with per-layer halo exchange / re-gather decisions
    recorded in the plan's partition record (core/partition.py).
    Indivisible batches or heights degrade to a single-logical-device
    plan with the reason recorded -- never an error. The plans bind on the
    mesh's first device (`device=`, if given, must be that one); the
    record persists in the artifact so warm starts restore the
    partitioning without re-deciding, and the mesh itself is re-attached
    per process (it never serializes).
    """
    t0 = time.perf_counter()
    if partition is not None:
        if mesh is None:
            raise ValueError(
                f"partition={partition!r} needs mesh= (a launch.mesh.Mesh "
                f"with a 'data' axis; see launch.mesh.make_data_mesh)")
        if partition not in ("data", "spatial"):
            raise ValueError(f"unknown partition {partition!r}; expected "
                             f"'data' or 'spatial'")
    if mesh is not None:
        first = mesh.devices[0]
        if device is not None and torch.device(device) not in (
                first, torch.device(first.type)):
            raise ValueError(f"device={device!r} disagrees with the mesh, "
                             f"whose first device is {first}; pass one of "
                             f"them")
        device = first
    device = resolve_device(device)
    if input_shape is None:
        if res is None:
            raise ValueError("compile() needs res= (image networks, input "
                             "(batch, res, res, c_in)) or input_shape=")
        input_shape = (batch, res, res, c_in)
    input_shape = tuple(input_shape)
    if algorithm not in _plan.ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; expected one "
                         f"of {_plan.ALGORITHMS}")
    compute_dtype = _plan.dtype_name(compute_dtype)
    if compute_dtype not in registry.COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}; "
                         f"expected one of {registry.COMPUTE_DTYPES}")
    digest = params_digest(params) if artifact is not None else None
    if artifact is not None and os.path.exists(artifact):
        with _obs_trace.span("compile.artifact_load", path=artifact):
            loaded = _try_load_artifact(
                artifact, input_shape=input_shape, algorithm=algorithm,
                digest=digest, dtype=dtype, compute_dtype=compute_dtype,
                device=device, mesh=mesh, partition=partition)
        if loaded is not None:
            _plan.record_artifact_load(True)
            return loaded
    with _obs_trace.span("compile.lower"):
        ir = tuple(graph) if _is_ir(graph) else lower(graph,
                                                      c_in=input_shape[-1])
    with _obs_trace.span("compile.fuse") as sp:
        ir = fuse(ir)
        sp.set(nodes=len(ir))
    with _obs_trace.span("compile.infer_shapes"):
        shapes = infer_shapes(ir, input_shape)
    with _obs_trace.span("compile.place", algorithm=algorithm):
        placements = place(ir, shapes, algorithm, compute_dtype)
    part = None
    if mesh is not None:
        with _obs_trace.span("compile.decide_partition"):
            axis, n = _partition.mesh_num_shards(mesh)
            part = _partition.decide_partition(ir, shapes, n,
                                               partition or "data", axis)
    with _obs_trace.span("compile.bind",
                         partitioned=bool(part and part["num_shards"] > 1)):
        if part is not None and part["num_shards"] > 1:
            plans, consts = _bind_partitioned(ir, shapes, placements, params,
                                              part, dtype, device)
        else:
            plans, consts = bind(ir, shapes, placements, params, dtype=dtype,
                                 device=device)
    # the weights' dtype: the first (nested) plan with a spec records it
    dtype_str = (_plan.dtype_name(dtype) if dtype else next(
        (m.spec.dtype for p in plans.values() for m in p.modules()
         if hasattr(m, "spec")), "float32"))
    net = NetworkPlan(ir, plans, consts, input_shape, algorithm, dtype_str,
                      compute_dtype=compute_dtype,
                      build_time_s=time.perf_counter() - t0,
                      params_digest=digest, partition=part, mesh=mesh)
    if artifact is not None:
        _plan.record_artifact_load(False)
        with _obs_trace.span("compile.artifact_save", path=artifact):
            net.save(artifact)
    return net
