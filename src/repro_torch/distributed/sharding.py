"""Partition specs and placement over a mesh (launch/mesh.py), and the
conv-network partition primitives.

**The LM's specs.** 2-D sharding, as in the JAX package: tensor-parallel
over the "model" axis (heads / ffn / experts / vocab) x fully sharded
(ZeRO-3 style) over the "data" axis on the complementary dimension. Pods
replicate parameters (pure data parallelism across the "pod" axis); the
batch shards over ("pod", "data"). Every proposed spec passes through a
divisibility guard, so reduced smoke configs and odd dimensions
(granite's 40 experts on a 16-way model axis, whisper's d_model=384)
degrade to replication on the offending axis. The spec functions read
only a mesh's `axis_names` and `shape`, so they work on "meta" trees
(`transformer.abstract_params`) and on a stand-in mesh.

**Placement.** `device_put(tree, shardings)` splits each leaf into a
`Placed` leaf: one piece per (shard index, device) of the mesh's
positions, so a piece that several positions replicate on one device is
stored once (on `devices=["cuda"] * 4`, every leaf is stored once in
all). `Placed.gather(device)` assembles the full tensor on one device
with copies, through autograd, so a gradient taken through a gather lands
on the pieces it read (the reduce-scatter); `gather_tree` is the inverse
of `device_put`. `Placed.region` reads any part of a leaf the same way,
and `compute_view` is the part a model position computes with (its block
of the "model" dim, gathered over the data axes); `Placed.from_views`
builds a placed tensor from such parts (the decode cache a
tensor-parallel step writes). models/transformer.py gathers one scan
unit at a time onto the devices that compute; launch/steps.py runs the
sharded train step.

**The conv-network primitives.** NHWC activations partitioned over a 1-D
("data",) mesh axis, on the batch dim (data parallel) or on H (spatial
halo partitioning). The JAX package runs its primitives inside a
`shard_map` body, where each sees its own shard and talks to its
neighbors through collectives (`ppermute`, `all_gather`). Here one
process holds every shard: a sharded activation is a list of tensors, one
per mesh position, each on its position's device, and the collectives
are copies (`_to`: not blocking the host, except into host memory, and
skipped where the tensor already lives on the device it goes to). Those lists play the role of the
reference's `shard_map` shim, which is not ported: `halo_exchange` here
and `optim/compression.pod_mean_int8` take one tensor per position.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.tree import tree_map, tree_map_with_path


class PartitionSpec:
    """A tensor's layout over mesh axes, one entry per leading dim: None
    (replicated), an axis name, or a tuple of names (sharded over their
    product, row-major). Missing trailing entries are None. A leaf of the
    port's trees (not a tuple), unlike jax's."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and self.parts == other.parts

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"P{self.parts!r}"


P = PartitionSpec


def _sizes(mesh) -> dict[str, int]:
    return dict(mesh.shape)


def _axes(ax) -> tuple[str, ...]:
    return () if ax is None else ax if isinstance(ax, tuple) else (ax,)


def _guard(mesh, shape: tuple, spec: P) -> P:
    """Drop mesh axes that do not divide the corresponding dim."""
    sizes = _sizes(mesh)
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        if ax is None:
            fixed.append(None)
            continue
        need = math.prod(sizes[a] for a in _axes(ax))
        fixed.append(ax if dim % need == 0 else None)
    return P(*fixed)


def model_dim(spec: P) -> int | None:
    """The dim `spec` shards over the "model" axis (alone or with
    others), or None."""
    for d, ax in enumerate(spec):
        if "model" in _axes(ax):
            return d
    return None


def keeps_model(*leaves) -> bool:
    """Whether every leaf is placed with a "model" dim (the guard kept the
    axis its spec proposed): the condition for a layer to compute
    tensor-parallel."""
    return all(isinstance(t, Placed) and t.model_dim() is not None
               for t in leaves)


def block(size: int, m: int, n: int) -> list[tuple[int, int]]:
    """Position m's contiguous n-th of a dim of `size`: [(start, stop)]."""
    step = size // n
    return [(m * step, (m + 1) * step)]


def compute_view(leaf, m: int, n: int, device, ranges=None,
                 dim: int | None = None) -> torch.Tensor:
    """The block of `leaf` model position m of n computes with, on
    `device`: along `dim` (default: the leaf's "model" dim), `ranges`
    (default: block m of that dim), every other dim whole, gathered over
    the data axes from the pieces that hold it (Placed.region; a view of
    the piece where one piece on `device` holds it). It can differ from
    the storage piece:
    Mamba's in_proj holds [x | z] and a position computes with [x_m |
    z_m]; dt_proj is stored split by rows and computed split by columns; a
    GQA position reads the KV heads its query heads read. A leaf without a
    "model" dim is gathered whole."""
    d = leaf.model_dim() if dim is None else dim
    if d is None:
        return leaf.region({}, device)
    return leaf.region({d: ranges or block(leaf.shape[d], m, n)}, device)


#: parameter-name -> spec. Specs are written for the *unstacked* leaf; the
#: scan-unit axis is prepended for block params.
_COL = {"wq", "wk", "wv", "up", "gate", "in_proj"}          # (D, out*) -> TP out
_ROW = {"wo", "down", "out_proj", "dt_proj"}                # (in*, D) -> TP in
_VEC_TP = {"bq", "bk", "bv", "conv_b", "d_skip", "dt_bias"}


def _leaf_spec(path: tuple[str, ...], shape: tuple, cfg: ArchConfig) -> P:
    name = path[-1]
    if "moe" in path:
        mode = cfg.moe.shard_mode
        if name == "router":
            return P("data", None)
        if name in ("up", "gate"):                           # (E, D, F)
            return P("model", "data", None) if mode == "ep" \
                else P(None, "data", "model")
        if name == "down":                                   # (E, F, D)
            return P("model", None, "data") if mode == "ep" \
                else P(None, "model", "data")
    if name in ("embed", "lm_head"):                         # (V, D)
        return P("model", "data")
    if name == "pos_emb":
        return P(None, "data")
    if name in ("scale", "bias", "q_norm", "k_norm"):
        return P(None)
    if name == "conv_w":                                     # (k, d_in)
        return P(None, "model")
    if name == "a_log":                                      # (d_in, N)
        return P("model", None)
    if name == "x_proj":                                     # (d_in, dt+2N)
        return P("model", "data")
    if name in _COL:
        return P("data", "model")
    if name in _ROW:
        return P("model", "data")
    if name in _VEC_TP:
        return P("model")
    return P()                                               # replicate


def _stacked(names: tuple[str, ...]) -> bool:
    """A leaf stacked over scan units (or the encoder's layers)."""
    return "blocks" in names or ("encoder" in names and "layers" in names)


def param_specs(params_shape: Any, cfg: ArchConfig, mesh) -> Any:
    """A tree of PartitionSpec matching a (possibly "meta") param tree."""
    def one(path, leaf):
        names = tuple(path.split("/"))
        shape = tuple(leaf.shape)
        spec = _leaf_spec(names, shape, cfg)
        if _stacked(names) and len(spec) < len(shape):
            spec = P(None, *spec)                            # scan-unit axis
        return _guard(mesh, shape, spec)

    return tree_map_with_path(one, params_shape)


def param_shardings(params_shape: Any, cfg: ArchConfig, mesh) -> Any:
    return sharding_tree(param_specs(params_shape, cfg, mesh), mesh)


def _batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_specs(batch_shape: Any, mesh) -> Any:
    """tokens / labels (B, S): batch over the data axes; frames (B, T, D)
    the same."""
    ba = _batch_axes(mesh)

    def one(leaf):
        spec = P(ba, *([None] * (len(leaf.shape) - 1)))
        return _guard(mesh, tuple(leaf.shape), spec)

    return tree_map(one, batch_shape)


def cache_specs(cache_shape: Any, cfg: ArchConfig, mesh) -> Any:
    """Decode caches, leading axis n_units. KV caches (U, B, L, H, hd):
    batch over the data axes, heads over model, else the head dim (GQA
    kv=8 on a 16-way model axis); when the batch cannot shard (B = 1) the
    sequence axis takes the data axes. Mamba caches (U, B, d_in, N) /
    (U, B, k-1, d_in): the widest trailing dim over model."""
    ba = _batch_axes(mesh)
    sizes = _sizes(mesh)
    n_data = math.prod(sizes[a] for a in ba)
    n_model = sizes.get("model", 1)

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 5:                                  # KV cache
            hax = "model" if shape[3] % n_model == 0 else None
            dax = "model" if hax is None and shape[4] % n_model == 0 \
                else None
            if shape[1] % n_data == 0:
                spec = P(None, ba, None, hax, dax)
            else:
                spec = P(None, None, ba, hax, dax)
        elif len(shape) == 4:                                # conv or ssm
            if shape[2] >= shape[3]:
                spec = P(None, ba, "model", None)
            else:
                spec = P(None, ba, None, "model")
        else:
            spec = P()
        return _guard(mesh, shape, spec)

    return tree_map(one, cache_shape)


# ---------------------------------------------------------------------------
# Placement: NamedSharding, Placed, device_put and its inverse
# ---------------------------------------------------------------------------

class NamedSharding:
    """A PartitionSpec on a mesh (launch/mesh.Mesh)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec})"

    def counts(self, ndim: int) -> tuple[int, ...]:
        """The number of shards along each of `ndim` dims."""
        sizes = _sizes(self.mesh)
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return tuple(math.prod(sizes[a] for a in _axes(ax))
                     for ax in spec[:ndim])

    def index(self, position: int, ndim: int) -> tuple[int, ...]:
        """The shard index, along each of `ndim` dims, of the mesh
        position `position`."""
        sizes = _sizes(self.mesh)
        coords = self.mesh.coords(position)
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        out = []
        for ax in spec[:ndim]:
            i = 0
            for a in _axes(ax):
                i = i * sizes[a] + coords[a]
            out.append(i)
        return tuple(out)


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """x on `device`. A copy to a card is stream-ordered and does not
    block; one to the host does, since the host reads it next."""
    if x.device == device:
        return x
    return x.to(device, non_blocking=device.type != "cpu")


def _block(x: torch.Tensor, index: tuple, counts: tuple) -> torch.Tensor:
    """Shard `index` of x (a view), its dims split evenly by `counts`."""
    for dim, (i, n) in enumerate(zip(index, counts)):
        if n > 1:
            step = x.shape[dim] // n
            x = x.narrow(dim, i * step, step)
    return x


class Placed:
    """A tensor split over a mesh: `pieces` maps (shard index, device) to
    the piece held there, one per distinct pair among the mesh's
    positions. `shape` and `dtype` are the full tensor's; `device` is the
    mesh's first position, where gathers compute unless told otherwise."""

    __slots__ = ("sharding", "shape", "dtype", "pieces")

    def __init__(self, sharding: NamedSharding, shape, dtype,
                 pieces: dict):
        self.sharding, self.shape, self.dtype = sharding, tuple(shape), dtype
        self.pieces = pieces

    def __repr__(self):
        return (f"Placed({self.shape}, {self.dtype}, {self.sharding.spec}, "
                f"{len(self.pieces)} pieces)")

    @classmethod
    def split(cls, x: torch.Tensor, sharding: NamedSharding) -> "Placed":
        """x's pieces on their positions' devices. A piece on x's own
        device is a view of x where it is contiguous."""
        mesh, n = sharding.mesh, x.dim()
        counts = sharding.counts(n)
        pieces = {}
        for pos, dev in enumerate(mesh.devices):
            key = (sharding.index(pos, n), dev)
            if key not in pieces:
                pieces[key] = _to(_block(x, key[0], counts),
                                  dev).contiguous()
        return cls(sharding, x.shape, x.dtype, pieces)

    @property
    def device(self) -> torch.device:
        return self.sharding.mesh.devices[0]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def with_pieces(self, pieces: dict) -> "Placed":
        """The same layout holding other pieces (gradients, moments)."""
        first = next(iter(pieces.values()))
        return Placed(self.sharding, self.shape, first.dtype, pieces)

    def primaries(self) -> dict:
        """One piece per shard index (the first position's): each element
        of the full tensor exactly once."""
        out = {}
        for (index, _), t in self.pieces.items():
            out.setdefault(index, t)
        return out

    def piece(self, index: tuple, device: torch.device) -> torch.Tensor:
        """Shard `index`, from `device` where it is held there."""
        t = self.pieces.get((index, device))
        return t if t is not None else self.primaries()[index]

    def gather(self, device=None) -> torch.Tensor:
        """The full tensor on `device` (default: self.device), assembled
        from one piece per shard index with copies and concatenations that
        autograd follows back to the pieces (`region` of the whole)."""
        return self.region({}, self.device if device is None else device)

    def region(self, sel: dict, device) -> torch.Tensor:
        """The full tensor's part that `sel` selects, on `device`: sel
        maps a dim to [(start, stop), ...], those ranges of the dim in
        order (a dim not in sel whole). Read from the pieces that hold it,
        with copies and concatenations that autograd follows back to the
        pieces; a part that one piece on `device` holds whole is a view of
        that piece (no copy). A mesh position's compute view
        (`compute_view`) is such a part."""
        device = torch.device(device)
        counts = self.sharding.counts(self.ndim)

        def build(k: int, index: tuple, local: tuple) -> torch.Tensor:
            if k == self.ndim:
                t = self.piece(index, device)
                for d, (a, b) in enumerate(local):
                    if a or b != t.shape[d]:
                        t = t.narrow(d, a, b - a)
                return _to(t, device)
            step = self.shape[k] // counts[k]
            parts = []
            for a, b in sel.get(k, ((0, self.shape[k]),)):
                while a < b:
                    i = a // step
                    hi = min(b, (i + 1) * step)
                    parts.append(build(k + 1, index + (i,), local + (
                        (a - i * step, hi - i * step),)))
                    a = hi
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=k)

        return build(0, (), ())

    @classmethod
    def from_views(cls, sharding: NamedSharding, shape, dtype,
                   views: list, covered_only: bool = False) -> "Placed":
        """A placed tensor of `shape` assembled from `views`, [(sel,
        tensor)]: each tensor the full tensor's part `sel` selects (one
        range per dim in sel, a dim not in sel whole), as `region` reads
        it. Each piece is cut from the first view that covers its block,
        one on the piece's own device first, and copied there (a view of
        the tensor where it already is and covers the block exactly).
        With `covered_only`, pieces no view covers are left out (some data
        groups' part of a tensor), else they raise."""
        n = len(shape)
        counts = sharding.counts(n)
        pieces = {}
        for pos, dev in enumerate(sharding.mesh.devices):
            index = sharding.index(pos, n)
            if (index, dev) in pieces:
                continue
            block = [(i * (s // c), (i + 1) * (s // c))
                     for i, s, c in zip(index, shape, counts)]

            def covers(sel):
                return all(sel.get(d, ((0, shape[d]),))[0][0] <= lo and
                           hi <= sel.get(d, ((0, shape[d]),))[0][1]
                           for d, (lo, hi) in enumerate(block))

            found = [(sel, t) for sel, t in views if covers(sel)]
            if not found and covered_only:
                continue
            if not found:
                raise ValueError(f"no view covers the block {block} of a "
                                 f"{tuple(shape)} tensor")
            sel, t = next((v for v in found if v[1].device == dev), found[0])
            cut = False
            for d, (lo, hi) in enumerate(block):
                a = sel.get(d, ((0, shape[d]),))[0][0]
                if lo - a or hi - lo != t.shape[d]:
                    t, cut = t.narrow(d, lo - a, hi - lo), True
            t = _to(t, dev)
            pieces[(index, dev)] = t.contiguous() if cut else t
        return cls(sharding, shape, dtype, pieces)

    def model_dim(self) -> int | None:
        """The dim this leaf's spec shards over "model", or None."""
        return model_dim(self.sharding.spec)

    def held_at(self, positions) -> "Placed":
        """The pieces held at the mesh positions `positions` (a Placed of
        those pieces only: one position's part of a leaf)."""
        mesh, n = self.sharding.mesh, self.ndim
        keys = {(self.sharding.index(p, n), mesh.devices[p])
                for p in positions}
        return self.with_pieces({k: t for k, t in self.pieces.items()
                                 if k in keys})

    def unit(self, u: int) -> "Placed":
        """Row u of a leaf stacked over scan units (its leading dim is
        never sharded): views of the pieces."""
        spec = NamedSharding(self.sharding.mesh, P(*tuple(
            self.sharding.spec)[1:]))
        return Placed(spec, self.shape[1:], self.dtype,
                      {(index[1:], dev): t[u]
                       for (index, dev), t in self.pieces.items()})


class Stacked:
    """A leaf stacked over scan units held as one Placed per unit, so that
    autograd gives each unit's pieces a gradient of their own (a view of
    the stack would give every unit a zero-filled gradient of the whole
    stack)."""

    __slots__ = ("units",)

    def __init__(self, units: list):
        self.units = units

    def unit(self, u: int) -> Placed:
        return self.units[u]


def piecewise(fn):
    """fn over tensor leaves, lifted to Placed leaves: applied to each
    piece, with the same piece of every other argument (Placed in the same
    layout). A tuple result comes back as a tuple of Placed."""
    def run(leaf, *rest):
        if not isinstance(leaf, Placed):
            return fn(leaf, *rest)
        outs = {k: fn(t, *(r.pieces[k] for r in rest))
                for k, t in leaf.pieces.items()}
        first = next(iter(outs.values()))
        if isinstance(first, tuple):
            return tuple(leaf.with_pieces({k: o[i] for k, o in outs.items()})
                         for i in range(len(first)))
        return leaf.with_pieces(outs)
    return run


def distinct_tensors(leaf) -> list[torch.Tensor]:
    """The tensors holding each element of a leaf once: a Placed leaf's
    primaries, or the tensor itself."""
    if isinstance(leaf, Placed):
        return list(leaf.primaries().values())
    return [leaf]


def sharding_tree(spec_tree: Any, mesh) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def device_put(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of `tree` split into a Placed leaf by the matching
    NamedSharding of `shardings` (a tree of tree's structure)."""
    return tree_map(Placed.split, tree, shardings)


def gather_tree(tree: Any, device=None) -> Any:
    """The inverse of device_put: each Placed leaf as its full tensor on
    `device` (default: its mesh's first position); other leaves as they
    are."""
    return tree_map(lambda t: t.gather(device) if isinstance(t, Placed)
                    else t, tree)


def group_positions(mesh, rows: int) -> list[int]:
    """The first mesh position of each data group of batch_groups(mesh,
    rows), in the same order."""
    spec = _guard(mesh, (rows,), P(_batch_axes(mesh)))
    if spec[0] is None:
        return [0]
    sharding = NamedSharding(mesh, spec)
    first = {}
    for pos in range(len(mesh.devices)):
        first.setdefault(sharding.index(pos, 1)[0], pos)
    return [first[g] for g in range(sharding.counts(1)[0])]


def batch_groups(mesh, rows: int) -> list[tuple[torch.device, slice]]:
    """The data groups of a batch of `rows` rows under batch_specs: (the
    device of the group's first mesh position, its rows), in row order.
    A batch the data axes do not divide is one group on the first
    position, as batch_specs' guard replicates it."""
    spec = _guard(mesh, (rows,), P(_batch_axes(mesh)))
    if spec[0] is None:
        return [(mesh.devices[0], slice(0, rows))]
    sharding = NamedSharding(mesh, spec)
    n = sharding.counts(1)[0]
    first = {}
    for pos, dev in enumerate(mesh.devices):
        first.setdefault(sharding.index(pos, 1)[0], dev)
    step = rows // n
    return [(first[g], slice(g * step, (g + 1) * step)) for g in range(n)]


# ---------------------------------------------------------------------------
# Conv-network partition primitives (sharded NetworkPlan execution)
# ---------------------------------------------------------------------------

def data_axis_name(mesh) -> str:
    """The batch/spatial partition axis: "data" if present, else axis 0."""
    return "data" if "data" in mesh.axis_names else mesh.axis_names[0]


def halo_exchange(shards: Sequence[torch.Tensor],
                  halo: int) -> list[torch.Tensor]:
    """Each shard grown by its neighbors' `halo` boundary rows (axis 1,
    NHWC H) on each side. The edge shards receive zeros, which is exactly
    SAME zero padding -- so a VALID conv over an exchanged strip reproduces
    the unsharded SAME conv's rows owned by that shard."""
    if halo == 0:
        return list(shards)
    out = []
    last = len(shards) - 1
    for i, x in enumerate(shards):
        edge = x.new_zeros((x.shape[0], halo) + tuple(x.shape[2:]))
        up = _to(shards[i - 1][:, -halo:], x.device) if i > 0 else edge
        dn = _to(shards[i + 1][:, :halo], x.device) if i < last else edge
        out.append(torch.cat([up, x, dn], dim=1))
    return out


def gather_rows(shards: Sequence[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """Reassemble the full H from row shards, on `device`."""
    return torch.cat([_to(s, device) for s in shards], dim=1)


def scatter_rows(full: torch.Tensor,
                 devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """Each mesh position's contiguous H rows of a replicated tensor, on
    its device (a view where the device is the tensor's own)."""
    local = full.shape[1] // len(devices)
    return [_to(full[:, i * local:(i + 1) * local], d)
            for i, d in enumerate(devices)]


def split_batch(x: torch.Tensor,
                devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """Each mesh position's contiguous slice of the batch, on its device."""
    local = x.shape[0] // len(devices)
    return [_to(x[i * local:(i + 1) * local], d)
            for i, d in enumerate(devices)]
