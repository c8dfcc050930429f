"""The distribution context, as in the JAX package's distributed/context.py,
and the "model" axis's collectives.

Model code stays mesh-agnostic by calling shard_activations(x, kind). In
the reference, when a mesh is active (set by the launcher), that applies a
`with_sharding_constraint` from the active rule set, and XLA partitions the
program to match. Here one process runs each data group's program over the
group's model positions (models/transformer.py's tensor-parallel program):
an activation of that program is a `Sharded`, one tensor per model
position on the position's device, and shard_activations moves it to the
layout the rule gives ("residual": split by sequence over the positions
where the guard allows, the reference's sequence parallelism; "decode":
the batch only, so each position holds the whole). A plain tensor is a
data group's activation computed whole at one device, and is left as it
is.

The collectives are plain functions on one tensor per model position of a
group (`all_reduce`, `all_gather`, `reduce_scatter`): copies (`.to`) and
adds, which autograd differentiates in one process as it does
Placed.gather. Each position's work runs under `at(position)`, which the
dry run (launch/opcost.py) reads to tell the position it traces from the
others.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional

import torch

from repro_torch.distributed.sharding import (P, _to, batch_groups,
                                              group_positions)

_state = threading.local()

#: Functions of a mesh position that say whether its work is left out (a
#: dry run traces one position; launch/opcost.CostMode pushes one here).
SKIPS: list[Callable[[int], bool]] = []


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over (the pod axis folds into
    data)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def default_activation_rules(mesh) -> dict[str, P]:
    """kind -> PartitionSpec for (B, S, D) activations."""
    ba = batch_axes(mesh)
    return {
        # residual stream: batch over the data axes, sequence over the
        # model axis (sequence parallelism)
        "residual": P(ba, "model", None),
        # decode-time activations (B, 1, D): batch only
        "decode": P(ba, None, None),
    }


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, rules if rules is not None
                  else default_activation_rules(mesh))
    try:
        yield
    finally:
        _state.ctx = prev


def active_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def activation_spec(shape: tuple, kind: str) -> Optional[P]:
    """The spec the active rules give an activation of `shape` and `kind`,
    or None: no active mesh, no rule for `kind`, or (the reference's guard)
    an axis that does not divide its dim."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return None
    mesh, rules = ctx
    spec = rules.get(kind)
    if spec is None:
        return None
    sizes = dict(mesh.shape)
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        axs = ax if isinstance(ax, tuple) else (ax,)
        if dim % math.prod(sizes[a] for a in axs):
            return None
    return spec


# ---------------------------------------------------------------------------
# A data group's model positions
# ---------------------------------------------------------------------------

class Group:
    """One data group of a mesh: its model positions (flat mesh positions,
    in model order), their devices, and the global batch's row count (the
    activation rules' guard reads the global shape)."""

    __slots__ = ("mesh", "positions", "devices", "rows", "n", "batch")

    def __init__(self, mesh, first: int, rows: int,
                 batch: slice | None = None):
        if "model" in mesh.axis_names:
            coords = mesh.coords(first)
            self.positions = tuple(
                mesh.position({**coords, "model": m})
                for m in range(mesh.shape["model"]))
        else:
            self.positions = (first,)
        self.mesh, self.rows, self.n = mesh, rows, len(self.positions)
        #: the group's rows of the global batch
        self.batch = slice(0, rows) if batch is None else batch
        self.devices = tuple(mesh.devices[p] for p in self.positions)

    @property
    def first(self) -> torch.device:
        """The device of the group's first model position, where a layer
        that does not split computes."""
        return self.devices[0]


def groups(mesh, rows: int) -> list[Group]:
    """The data groups of a batch of `rows` rows (sharding.batch_groups),
    in row order."""
    firsts = group_positions(mesh, rows)
    return [Group(mesh, p, rows, sl)
            for p, (_, sl) in zip(firsts, batch_groups(mesh, rows))]


@contextlib.contextmanager
def at(position: int):
    """Run the enclosed work as mesh position `position`'s."""
    prev = getattr(_state, "position", None)
    _state.position = position
    try:
        yield
    finally:
        _state.position = prev


def running_at() -> Optional[int]:
    """The mesh position whose work runs now (None outside `at`)."""
    return getattr(_state, "position", None)


@contextlib.contextmanager
def collective(kind: str):
    prev = getattr(_state, "collective", None)
    _state.collective = kind
    try:
        yield
    finally:
        _state.collective = prev


def running_collective() -> Optional[str]:
    """The collective whose copies and adds run now ("all-reduce",
    "all-gather", "reduce-scatter"), or None."""
    return getattr(_state, "collective", None)


def _skipped(position: int) -> bool:
    return bool(SKIPS) and SKIPS[-1](position)


def _stand_in(x):
    """Tensors of x's shapes and dtypes with nothing computed: a skipped
    position's results (its work is symmetric to the first's)."""
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if isinstance(x, (list, tuple)):
        return type(x)(_stand_in(v) for v in x)
    if isinstance(x, dict):
        return {k: _stand_in(v) for k, v in x.items()}
    return x


def each(group: Group, fn: Callable[[int], object]) -> list:
    """[fn(m) for each model position m of the group], each run at its
    position. A position the dry run leaves out gets stand-ins shaped as
    position 0's results."""
    out = []
    for m, p in enumerate(group.positions):
        with at(p):
            out.append(_stand_in(out[0]) if m and _skipped(p) else fn(m))
    return out


# ---------------------------------------------------------------------------
# The model axis's collectives: one tensor per model position of a group
# ---------------------------------------------------------------------------

def _per_device(group: Group, fn: Callable[[torch.device], torch.Tensor]
                ) -> list:
    """fn(device) for each position, computed once per distinct device
    (positions on one device hold one result), at the first position
    there."""
    done: dict = {}
    for p, dev in zip(group.positions, group.devices):
        if dev not in done:
            with at(p):
                done[dev] = fn(dev)
    return [done[dev] for dev in group.devices]


def _sum(ts: list) -> torch.Tensor:
    """The tensors' sum in position order, rounded once to their dtype,
    as one matmul's output is: three or more add in float64 and cast
    back, so the sum does not depend on the order the positions add in
    (two already round once in their own dtype)."""
    if len(ts) < 3:
        return ts[0] if len(ts) == 1 else ts[0] + ts[1]
    acc = ts[0].double()
    for t in ts[1:]:
        acc = acc + t.double()
    return acc.to(ts[0].dtype)


def all_reduce(parts: list, group: Group) -> list:
    """Each position's copy of the parts' sum (_sum)."""
    def total(dev):
        return _sum([_to(t, dev) for t in parts])
    with collective("all-reduce"):
        return _per_device(group, total)


def all_gather(parts: list, group: Group, dim: int = 1) -> list:
    """Each position's copy of the parts concatenated along `dim`."""
    with collective("all-gather"):
        return _per_device(group, lambda dev: torch.cat(
            [_to(t, dev) for t in parts], dim=dim))


def reduce_scatter(parts: list, group: Group, dim: int = 1) -> list:
    """Position m's n-th of the parts' sum along `dim` (_sum); each
    position reads its rows of every part."""
    step = parts[0].shape[dim] // group.n

    def mine(m):
        dev = group.devices[m]
        return _sum([_to(t.narrow(dim, m * step, step), dev)
                     for t in parts])
    with collective("reduce-scatter"):
        return each(group, mine)


# ---------------------------------------------------------------------------
# Activations of the tensor-parallel program
# ---------------------------------------------------------------------------

#: Layouts of a Sharded: "seq" each position its rows of dim 1; "rep" each
#: the whole; "partial" each a summand of the whole; "first" the whole at
#: the first position alone (a layer computed whole there).
LAYOUTS = ("seq", "rep", "partial", "first")


class Sharded:
    """An activation of a data group's tensor-parallel program: `parts`,
    one tensor per model position on its device (positions on one device
    may share a tensor), in `layout`; `shape` is the whole's."""

    __slots__ = ("group", "parts", "layout", "shape")

    def __init__(self, group: Group, parts: list, layout: str):
        if layout not in LAYOUTS:
            raise ValueError(layout)
        self.group, self.parts, self.layout = group, list(parts), layout
        shape = list(parts[0].shape)
        if layout == "seq":
            shape[1] *= group.n
        self.shape = tuple(shape)

    def __repr__(self):
        return f"Sharded({self.shape}, {self.layout}, {self.group.n} parts)"

    def rows(self, m: int) -> slice:
        """The rows of dim 1 that position m's part holds."""
        if self.layout != "seq":
            return slice(0, self.shape[1])
        step = self.shape[1] // self.group.n
        return slice(m * step, (m + 1) * step)

    def map(self, fn: Callable) -> "Sharded":
        """fn(part, m) over the parts, in this layout; parts that
        positions share are computed once (fn must then give them one
        result)."""
        done: dict = {}

        def one(m):
            key = id(self.parts[m])
            if key not in done:
                done[key] = fn(self.parts[m], m)
            return done[key]
        return Sharded(self.group, each(self.group, one), self.layout)

    def to(self, layout: str) -> "Sharded":
        """The same activation in `layout` ("seq" or "rep")."""
        g, parts = self.group, self.parts
        if layout == self.layout:
            return self
        if self.layout == "partial":
            out = (reduce_scatter(parts, g) if layout == "seq"
                   else all_reduce(parts, g))
        elif self.layout == "first":
            whole = parts[0]
            if layout == "seq":
                step = whole.shape[1] // g.n
                out = each(g, lambda m: _to(whole.narrow(
                    1, m * step, step), g.devices[m]))
            else:
                out = _per_device(g, lambda dev: _to(whole, dev))
        elif self.layout == "rep":
            step = self.shape[1] // g.n
            out = each(g, lambda m: parts[m].narrow(1, m * step, step))
        else:                                     # seq -> rep
            out = all_gather(parts, g)
        return Sharded(g, out, layout)

    def whole(self) -> list:
        """Each position's copy of the whole (all_gather of a "seq"
        activation; a "rep" one's parts)."""
        return self.to("rep").parts


def add(x: Sharded, h: Sharded) -> Sharded:
    """x + h in x's layout ("seq" or "rep"): h reduced or split to it
    first (a row-parallel block's partial sums reduce here, once)."""
    h = h.to(x.layout)
    done: dict = {}

    def one(m):
        key = (id(x.parts[m]), id(h.parts[m]))
        if key not in done:
            done[key] = x.parts[m] + h.parts[m]
        return done[key]
    return Sharded(x.group, each(x.group, one), x.layout)


def layout_for(shape: tuple, kind: str) -> str:
    """The layout the active rule of `kind` gives a (B, S, ...) activation
    of the global `shape`: "seq" where it splits dim 1 over "model", else
    "rep"."""
    spec = activation_spec(shape, kind)
    if spec is not None and len(spec) > 1 and spec[1] is not None and \
            "model" in (spec[1] if isinstance(spec[1], tuple)
                        else (spec[1],)):
        return "seq"
    return "rep"


def shard_activations(x, kind: str):
    """A Sharded activation in the layout the active rule of `kind` gives
    it (layout_for, on the global batch's shape); a plain tensor (an
    activation computed whole at one device), or anything outside a mesh,
    as it is."""
    if not isinstance(x, Sharded) or active_mesh() is None:
        return x
    shape = (x.group.rows, *x.shape[1:])
    return x.to(layout_for(shape, kind))
