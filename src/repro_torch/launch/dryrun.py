"""Dry run of the port's LM program: every (arch x shape x mesh) cell run on
"meta" tensors under launch/opcost.CostMode, with the H100's roofline.

The counterpart of the JAX package's launch/dryrun.py, which lowers and
compiles each cell's jitted step with the production shardings for 512
forced host devices and reads XLA's per-device program. Here the port's
own step runs (make_train_step, make_prefill_step or make_serve_step) on
tensors that carry shapes and dtypes and no storage, so a cell allocates
nothing, needs no card, and counts the same here and on the H100. The
numbers describe the port's program on that card, not XLA's on a TPU.

**Per-device numbers are those of mesh position 0** under the port's
tensor-parallel program (launch/steps.py, models/transformer.py): each
data group runs on its model positions, each position computing its
heads, ffn columns, d_in channels, experts and vocab rows, the residual
split by sequence between them; position 0 is also the first holder of
its pieces, which sums their replicas' gradients. The dry run traces
group 0's part of a step alone (`groups=(0,)` of make_train_step,
make_prefill_step and make_serve_step: its rows' forward (and backward,
the gradients and the update of position 0's pieces) on a placed tree
(and, for decode, a cache placed by cache_specs) whose every piece has
storage of its own, with position 0's pieces held "here" and the others
"away" (opcost's owners). Work the program runs as another position
(distributed/context.at) runs away, and a model position's share that
mirrors position 0's is not run at all (context.each gives it stand-ins
of position 0's shapes), so a cell traces one position's work. So:

  * **argument** -- what position 0 holds: its pieces of the params
    (param_specs) and of AdamW's moments, its data group's batch rows
    (batch_specs), and for a decode cell its pieces of the cache
    (cache_specs);
  * **temp** -- the peak of live bytes above that over position 0's work:
    compute views, activations, checkpointed inputs, gradients, the
    update's new trees of position 0's pieces; **peak** = argument + temp,
    beside the card's memory (`fits`);
  * **collective bytes** -- what position 0's ops read from storage held
    away, by the collective they belong to (compute views and gathers
    "all-gather"; the model axis's "all-reduce" and "reduce-scatter",
    context.py), traced; and, counted from the specs once per
    microbatch, the gradients it computes for the pieces held away (its
    compute views less its pieces), sent to their holders
    ("reduce-scatter"), and the replica sums of its own pieces' gradients
    (launch/steps.py:_grad_view: each replica's gradient in, the sum out
    to each replica; "all-reduce"). The other positions' gradients for
    position 0's pieces are not counted.

A cell's record has the reference's keys (`lower_s` / `compile_s` become
`trace_s`) and the kernels' `launches`. Cells whose peak exceeds the card's
memory are recorded so (`fits`: false); the program is left as it is.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_5_3b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
      --out results/dryrun_torch.jsonl
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback

import torch
from torch.overrides import TorchFunctionMode

from repro_torch import configs as cfglib
from repro_torch.distributed import context as dist
from repro_torch.distributed import sharding as shd
from repro_torch.launch import opcost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map

#: gradient-accumulation steps for the train_4k shape (the JAX package's
#: launch/dryrun.py, copied: sized there for its TPU mesh).
ACCUM_STEPS = {
    "nemotron_4_340b": 2,
    "llama4_maverick_400b_a17b": 8,
    "qwen1_5_32b": 4,
    "yi_34b": 4,
    "chameleon_34b": 4,
    "jamba_v0_1_52b": 8,
    "falcon_mamba_7b": 2,
}

PARAM_DTYPE = torch.bfloat16
#: run_cell(smoke=True)'s sequence length.
SMOKE_SEQ = 64

_I32 = torch.int32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, seq: int, batch: int, kind: str,
                dtype=PARAM_DTYPE) -> dict:
    """"meta" stand-ins for every step input (the reference's
    ShapeDtypeStructs): train {tokens, labels[, frames]}, prefill {tokens[,
    frames]}, decode {cache, tokens (B, 1), cache_pos ()}."""
    frames = ({"frames": _meta((batch, cfg.encoder.n_ctx, cfg.d_model),
                               dtype)} if cfg.encoder is not None else {})
    if kind == "train":
        return {"tokens": _meta((batch, seq), _I32),
                "labels": _meta((batch, seq), _I32), **frames}
    if kind == "prefill":
        return {"tokens": _meta((batch, seq), _I32), **frames}
    if kind == "decode":
        return {"cache": tf.abstract_decode_cache(cfg, batch, seq, dtype),
                "tokens": _meta((batch, 1), _I32),
                "cache_pos": _meta((), _I32)}
    raise ValueError(kind)


def held_bytes(tree, specs, mesh) -> int:
    """Bytes of one mesh position's pieces of `tree` (tensors or shapes
    with a dtype) under `specs` (PartitionSpecs; the guard makes every
    split even, so each position holds the same)."""
    total = 0
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        counts = shd.NamedSharding(mesh, spec).counts(len(leaf.shape))
        total += (math.prod(leaf.shape) // math.prod(counts)
                  * leaf.dtype.itemsize)
    return total


def specs_argument(cfg, kind: str, seq: int, batch: int, mesh,
                   dtype=PARAM_DTYPE, opt_cfg=None, params=None) -> int:
    """Bytes one mesh position holds under the specs: its pieces of the
    params (param_specs), for a train step of AdamW's two moments and its
    step count, and of the step's inputs (batch_specs; for a decode step
    the cache by cache_specs and the cache position)."""
    params = tf.abstract_params(cfg, dtype) if params is None else params
    p_specs = shd.param_specs(params, cfg, mesh)
    total = held_bytes(params, p_specs, mesh)
    specs = input_specs(cfg, seq, batch, kind, dtype)
    if kind == "train":
        m = adamw.abstract_state(params, opt_cfg or adamw.AdamWConfig()).m
        total += 2 * held_bytes(m, p_specs, mesh) + 4
    if kind == "decode":
        cache = specs.pop("cache")
        total += held_bytes(cache, shd.cache_specs(cache, cfg, mesh),
                            mesh) + 4
        specs = {"tokens": specs["tokens"]}
    return total + held_bytes(specs, shd.batch_specs(specs, mesh), mesh)


def _tree_bytes(tree) -> int:
    return sum(math.prod(t.shape) * t.dtype.itemsize
               for t in tree_leaves(tree))


def _hold_pieces(trees, mode: opcost.CostMode) -> None:
    """Register every piece of the placed trees with `mode`: position 0's
    pieces here, the others away."""
    for leaf in tree_leaves(trees):
        own = leaf.sharding.index(0, leaf.ndim)
        for (index, _), t in leaf.pieces.items():
            mode.hold(t, here=index == own)


class _OwnGradients(TorchFunctionMode):
    """A hook on each piece the step differentiates (a tensor made from a
    held piece by `requires_grad_`: position 0's own): a gradient that is
    a view of a larger tensor (its slice of a gathered unit's gradient)
    moves to a tensor of its own (CostMode.moved), as on a mesh, where the
    gradients of a piece from every data group sum into one, so that the
    unit's whole gradient does not stay live through it."""

    def __init__(self, mode: opcost.CostMode):
        super().__init__()
        self.mode = mode

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.Tensor.requires_grad_ and out.requires_grad and \
                self.mode.held(out) == opcost.HERE:
            out.register_hook(self._own)
        return out

    def _own(self, g: torch.Tensor):
        if g.untyped_storage().nbytes() == g.numel() * g.element_size():
            return None
        return self.mode.moved(g)


def _gradient_traffic(params, specs, mesh) -> tuple[int, int]:
    """Position 0's gradient traffic of one microbatch, from the specs:
    (the gradients it computes for the pieces held away, sent to their
    holders, "reduce-scatter": its compute view of a leaf with a "model"
    dim (its model block, gathered over the data axes) less its piece, of
    any other leaf the whole less its piece; the replica sums of its own
    pieces, R - 1 gradients in and the sum out to each of the R - 1 other
    holders, "all-reduce")."""
    n = len(mesh.devices)
    n_model = mesh.shape.get("model", 1)
    sent = replicas = 0
    for leaf, spec in zip(tree_leaves(params), tree_leaves(specs)):
        shards = math.prod(shd.NamedSharding(mesh, spec).counts(
            len(leaf.shape)))
        whole = math.prod(leaf.shape) * leaf.dtype.itemsize
        piece = whole // shards
        view = whole if shd.model_dim(spec) is None else whole // n_model
        sent += view - piece
        replicas += 2 * (n // shards - 1) * piece
    return sent, replicas


def trace_step(cfg, kind: str, seq: int, batch: int, *, mesh=None,
               dtype=PARAM_DTYPE, accum: int = 1, opt_cfg=None,
               one_device: bool = False) -> dict:
    """Run one step of `kind` on "meta" tensors under a CostMode: the
    port's own step, over `mesh` as position 0 runs it (the module
    docstring), or mesh-less, or with `one_device` the whole step over
    `mesh` on one device (every position on one card, each piece stored
    once, every group computed: chip_smoke.py phase 11's program).
    Returns {"mode": the CostMode, "argument", "argument_by_specs",
    "traffic" (the gradient collectives counted from the specs, by kind),
    "local_batch", "trace_s"}."""
    mode = opcost.CostMode(position=None if mesh is None or one_device
                           else 0)
    params = tf.abstract_params(cfg, dtype)
    specs = input_specs(cfg, seq, batch, kind, dtype)
    rows = batch
    if one_device:
        placed = shd.device_put(params, shd.param_shardings(params, cfg,
                                                            mesh))
        mode.hold(placed_pieces(placed))
        arg = _tree_bytes(params)
        mesh_step, mesh = mesh, None
    elif mesh is not None:
        p_specs = shd.param_specs(params, cfg, mesh)
        # a storage of its own for every piece (device_put's pieces on one
        # device may be views of one tensor), for the owners to tell apart
        placed = tree_map(lambda leaf: leaf.with_pieces(
            {k: torch.empty_like(t) for k, t in leaf.pieces.items()}),
            shd.device_put(params, shd.sharding_tree(p_specs, mesh)))
        _hold_pieces(placed, mode)
        rows = shd.batch_groups(mesh, batch)[0][1].stop
        arg = held_bytes(params, p_specs, mesh)
    else:
        placed = params
        mode.hold(params)
        arg = _tree_bytes(params)
    traffic = {}
    t0 = time.perf_counter()
    if kind == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        state = adamw.init_state(placed, opt_cfg)
        if one_device:
            mode.hold((placed_pieces(state.m), placed_pieces(state.v)))
            moments = 2 * _tree_bytes(adamw.abstract_state(params,
                                                           opt_cfg).m)
        elif mesh is not None:
            _hold_pieces((state.m, state.v), mode)
            moments = 2 * held_bytes(adamw.abstract_state(
                params, opt_cfg).m, p_specs, mesh)
            sent, reps = _gradient_traffic(params, p_specs, mesh)
            traffic = {"reduce-scatter": accum * sent,
                       "all-reduce": accum * reps}
        else:
            mode.hold((state.m, state.v))
            moments = 2 * _tree_bytes(state.m)
        mode.hold(state.step)
        b = specs
        mode.hold(b)
        local = {k: v[:rows] for k, v in b.items()}
        arg += moments + 4 + _tree_bytes(local)
        step = (make_train_step(cfg, opt_cfg, accum, mesh=mesh_step)
                if one_device else
                make_train_step(cfg, opt_cfg, accum, mesh=mesh,
                                groups=None if mesh is None else (0,)))
        with mode, (_OwnGradients(mode) if mesh is not None
                    else contextlib.nullcontext()):
            out = step(placed, state, b)
            del out
    elif kind == "prefill":
        # over a mesh, the global batch, of which data group 0's rows are
        # computed (groups=(0,)) and held
        local = {k: _meta((batch if mesh is not None else rows,
                           *v.shape[1:]), v.dtype)
                 for k, v in specs.items()}
        mode.hold(local)
        arg += _tree_bytes({k: v[:rows] for k, v in local.items()})
        step = make_prefill_step(cfg, max_len=seq,
                                 groups=None if mesh is None else (0,))
        with mode:
            out = step(placed, local)
            del out
    else:
        if mesh is None:
            cache = tf.abstract_decode_cache(cfg, rows, seq, dtype)
            tokens = _meta((rows, 1), _I32)
            mode.hold((cache, tokens))
            arg += _tree_bytes((cache, tokens))
        else:
            # the cache placed by cache_specs, position 0's pieces here
            like = tf.abstract_decode_cache(cfg, batch, seq, dtype)
            c_specs = shd.cache_specs(like, cfg, mesh)
            cache = tree_map(lambda leaf: leaf.with_pieces(
                {k: torch.empty_like(t) for k, t in leaf.pieces.items()}),
                shd.device_put(like, shd.sharding_tree(c_specs, mesh)))
            _hold_pieces(cache, mode)
            tokens = _meta((batch, 1), _I32)
            mode.hold(tokens)
            arg += held_bytes(like, c_specs, mesh) + \
                _tree_bytes(tokens[:rows])
        step = make_serve_step(cfg, groups=None if mesh is None else (0,))
        # cache_pos as a Python int: the attention decode reads it with
        # int(), which a "meta" tensor refuses; the step reads the whole
        # cache under a mask, so its cost does not depend on the position
        # (learned positions are read at the last row they have, where
        # the reference's gather clamps)
        pos = seq - 1 if cfg.pos_emb != "learned" else \
            min(seq, cfg.max_seq) - 1
        with mode:
            out = step(placed, cache, tokens, pos)
            del out
    by_specs = arg if mesh is None else specs_argument(
        cfg, kind, seq, batch, mesh, dtype, opt_cfg, params)
    return {"mode": mode, "argument": arg, "argument_by_specs": by_specs,
            "traffic": traffic, "local_batch": rows,
            "trace_s": time.perf_counter() - t0}


def placed_pieces(tree) -> list:
    """Every piece of every placed leaf of `tree`."""
    return [t for leaf in tree_leaves(tree) for t in leaf.pieces.values()]


def model_flops(cfg, kind: str, seq: int, batch: int) -> float:
    """6ND for a train step, 2ND for prefill, 2N per decoded token (N the
    active params), over the global batch (the reference's
    model_flops_6nd)."""
    n = cfg.n_active_params
    if kind == "train":
        return 6.0 * n * seq * batch
    if kind == "prefill":
        return 2.0 * n * seq * batch
    return 2.0 * n * batch


def record_of(traced: dict, n_chips: int, **head) -> dict:
    """A cell's record from trace_step's result."""
    mode = traced["mode"]
    tot = mode.totals()
    for kind, nbytes in traced["traffic"].items():
        tot.coll_bytes += nbytes
        tot.coll_by_kind[kind] += nbytes
    rf = opcost.Roofline.of(tot, n_chips)
    arg, temp = traced["argument"], mode.temp_peak
    at = mode.peak_at
    return {**head, "n_chips": n_chips, "status": "ok",
            "local_batch": traced["local_batch"],
            "trace_s": round(traced["trace_s"], 2),
            "memory": {"argument_size_in_bytes": arg,
                       "temp_size_in_bytes": temp,
                       "peak_bytes": arg + temp,
                       "card_bytes": opcost.CARD_BYTES,
                       "fits": arg + temp <= opcost.CARD_BYTES,
                       "argument_by_specs_bytes":
                           traced["argument_by_specs"],
                       "temp_peak_at": (f"{at.op} {at.fn}" if at else None)},
            "cost": {"flops": tot.flops, "bytes_accessed": tot.bytes,
                     "ops": len(mode.rows)},
            "collectives": tot.coll_by_kind,
            "roofline": {**rf.as_dict(), "t_roofline_s": rf.t_roofline},
            "launches": dict(mode.kernel_launches)}


def run_cell(arch: str, shape: str, *, multi_pod: bool, verbose: bool = True,
             return_rows: bool = False, smoke: bool = False) -> dict:
    """Dry-run one cell; returns its record (with `return_rows`, also the
    CostMode's rows under "_rows"). `smoke`: the arch's smoke config, the
    sequence cut to SMOKE_SEQ and accumulation to at most 2 microbatches,
    on the production mesh (the tests' size)."""
    cfg = (cfglib.get_smoke_config if smoke else cfglib.get_config)(arch)
    seq, batch, kind = {s: (q, b, k)
                        for s, q, b, k in cfglib.cells(arch)}[shape]
    if smoke:
        seq = min(seq, SMOKE_SEQ)
    mesh_name = "multi" if multi_pod else "single"
    if kind == "skip":
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skip",
                "reason": "full attention is quadratic at 500k; "
                          "sub-quadratic archs only (DESIGN.md)"}
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * n)
    opt_cfg = adamw.AdamWConfig(state_dtype=torch.bfloat16
                                if cfg.n_params > 50e9 else torch.float32)
    accum = ACCUM_STEPS.get(arch, 1) if shape == "train_4k" else 1
    if smoke:
        accum = min(accum, 2)
    with dist.use_mesh(mesh):
        traced = trace_step(cfg, kind, seq, batch, mesh=mesh, accum=accum,
                            opt_cfg=opt_cfg)
    record = record_of(traced, n, arch=arch, shape=shape, mesh=mesh_name,
                       kind=kind, seq=seq, batch=batch)
    record["accum_steps"] = accum
    record["model_flops_6nd"] = model_flops(cfg, kind, seq, batch)
    if verbose:
        mem, rf = record["memory"], record["roofline"]
        print(f"[{mesh_name}] {arch} {shape}: kind={kind} "
              f"trace={record['trace_s']:.1f}s "
              f"flops={rf['flops_per_dev']:.3e} "
              f"hbm={rf['hbm_bytes_per_dev']:.3e} "
              f"coll={rf['coll_bytes_per_dev']:.3e} "
              f"bottleneck={rf['bottleneck']} "
              f"t={1e3 * rf['t_roofline_s']:.1f}ms "
              f"mem/dev~{mem['peak_bytes'] / 1e9:.2f}GB "
              f"fits={mem['fits']}", flush=True)
        print(f"  memory: {mem}", flush=True)
        print(f"  launches: {record['launches']}", flush=True)
    if return_rows:
        record["_rows"] = traced["mode"].rows
    return record


def run_all(archs, shapes, meshes, out: str | None = None,
            smoke: bool = False) -> list:
    """run_cell over the cells, a failed cell recorded as "error"; each
    record appended to `out` (JSON lines) as it ends."""
    records = []
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                try:
                    rec = run_cell(arch, shape, multi_pod=multi, smoke=smoke)
                except Exception as e:  # a failed cell is a bug: surface it
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if multi else "single",
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"FAILED {arch} {shape} multi={multi}: {e!r}",
                          flush=True)
                records.append(rec)
                if out:
                    with open(out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    return records


def table(records) -> str:
    """The records as a markdown table, one row per (arch, shape), each
    figure "single / multi": per-position peak GB (and whether it fits the
    card), TFLOP, HBM and collective GB, roofline ms and bottleneck; the
    skipped cells in one line after it."""
    by = {}
    for r in records:
        by.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    head = ["arch", "shape", "peak GB", "fits", "TFLOP", "HBM GB",
            "coll GB", "roofline ms", "bottleneck"]
    lines = ["| " + " | ".join(head) + " |",
             "|" + " --- |" * len(head)]
    skips = []

    def both(cell, fn):
        return " / ".join(fn(cell[m]) if m in cell else "-"
                          for m in ("single", "multi"))

    for (arch, shape), cell in by.items():
        if all(c["status"] == "skip" for c in cell.values()):
            skips.append(f"{arch} {shape}")
            continue
        if any(c["status"] != "ok" for c in cell.values()):
            lines.append(f"| {arch} | {shape} | error |" + " |" * 6)
            continue
        rf = {m: c["roofline"] for m, c in cell.items()}
        lines.append("| " + " | ".join([
            arch, shape,
            both(cell, lambda c: f"{c['memory']['peak_bytes'] / 1e9:.2f}"),
            both(cell, lambda c: "yes" if c["memory"]["fits"] else "no"),
            both(cell, lambda c: f"{c['roofline']['flops_per_dev'] / 1e12:.4g}"),
            both(cell, lambda c:
                 f"{c['roofline']['hbm_bytes_per_dev'] / 1e9:.4g}"),
            both(cell, lambda c:
                 f"{c['roofline']['coll_bytes_per_dev'] / 1e9:.4g}"),
            both(cell, lambda c: f"{1e3 * c['roofline']['t_roofline_s']:.4g}"),
            " / ".join(sorted({r["bottleneck"] for r in rf.values()}))])
            + " |")
    if skips:
        lines.append("")
        lines.append(f"Skipped on both meshes (full attention at 500k): "
                     f"{', '.join(skips)}.")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' smoke configs (a quick check)")
    ap.add_argument("--table", default=None, metavar="JSONL",
                    help="print a results file as a markdown table and stop")
    args = ap.parse_args(argv)
    if args.table:
        with open(args.table) as f:
            print(table([json.loads(line) for line in f if line.strip()]))
        return 0

    archs = cfglib.ARCH_IDS if (args.all or args.arch is None) \
        else [cfglib.canonical(args.arch)]
    shapes = list(cfglib.SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    t0 = time.perf_counter()
    records = run_all(archs, shapes, meshes, args.out, args.smoke)
    ok = sum(r["status"] == "ok" for r in records)
    skip = sum(r["status"] == "skip" for r in records)
    err = sum(r["status"] == "error" for r in records)
    print(f"dry-run: {ok} ok, {skip} skip, {err} error "
          f"of {len(records)} cells in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0 if err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
