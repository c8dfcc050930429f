"""Op-cost walker: the FLOPs, HBM bytes, collective bytes and live memory
of one run of the port's program, counted op by op, and the H100's
roofline. The counterpart of the JAX package's launch/hlo.py, which reads
the same terms from XLA's optimized HLO; there is no HLO here, so the
walker watches the program itself run (on "meta" tensors for a dry run:
shapes and dtypes, no storage, no card).

`CostMode` is a TorchDispatchMode. Under it, every aten op records one
`Row`:

  * flops -- 2*M*N*K for mm, bmm, addmm, baddbmm, convolution and SDPA,
    from torch.utils.flop_counter's registry (hlo.py counts `dot` and
    `convolution`);
  * bytes -- each tensor operand read plus each result written; view and
    metadata ops (SKIP_BYTES_OPS, and any op whose results only alias its
    operands) read and write nothing, as hlo.py's _SKIP_BYTES_OPS;
  * the op's dtype, its shapes and the port function that issued it.

Eager PyTorch runs every scan unit, chunk and microbatch, so the counts
include every trip by construction (hlo.py multiplies a while body by its
trip count); work that repeats exactly and costs many ops (the scan's
backward) can be traced once and replayed (`CostMode.repeat`). A
hand-written kernel has no aten op: its wrapper, given "meta" tensors,
reports one row through `report_kernel` (its operand and result bytes and
the work its PERF.md bound counts). Under inference_mode, composite ops
(matmul, reshape) reach the mode whole and are decomposed there, so their
parts are the rows, as under autograd. "meta" pointwise kernels run as
Python; the mode makes those results itself where the operands are
contiguous (same shape, dtype and layout, ~10x faster).

**Where an op runs.** A dry run of a mesh traces the work of one mesh
position in one process, with every position on the "meta" device, so a
tensor's device cannot say where it lives. Instead each storage has an
owner, "here" (the position whose numbers are wanted) or "away":
arguments are registered with `hold`, and every other storage takes the
owner of the op that makes or reads it (an op runs on one device: its largest operand of known
owner decides, and operands of unknown owner, such as a zero-filled
tensor, take it). Rows of ops that run away are dropped. An op here that
reads an away storage reads it over the interconnect: those bytes are
collective bytes (of the collective that runs it, distributed/context.py,
else "all-gather"), not HBM bytes. Owners are settled when the mode
exits, so an owner learnt late counts from the storage's first op. In a
tensor-parallel program the work of each model position runs under
`context.at`: a CostMode given the `position` it traces runs that
position's ops here and every other's away.

**Live bytes.** Each storage is keyed by its identity and its bytes are
released when the last tensor that views it dies (a weak reference to the
storage). Storages that autograd saves stay live, as they do on the card.
`temp_peak` is the largest sum of live bytes owned here, arguments
excluded, over the run.

`Roofline` holds the card's datasheet figures (NVIDIA H100 SXM5 80GB
HBM3, 700 W); its compute term sums each row's FLOPs over the peak for
that row's unit (the dtype's tensor-core or CUDA-core rate, or the
special-function unit for the scan kernel's exponentials).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from collections import defaultdict
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import context as dist

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

#: View and metadata ops: no bytes read or written (hlo.py:45-48's
#: _SKIP_BYTES_OPS). Any other op whose results only alias its operands
#: (its schema says so) counts none either.
SKIP_BYTES_OPS = frozenset({
    "view", "_unsafe_view", "t", "transpose", "permute", "expand", "slice",
    "select", "as_strided", "unsqueeze", "squeeze", "detach", "alias"})

#: Factory ops that leave their result unwritten.
_UNWRITTEN = frozenset({"empty", "empty_strided", "new_empty",
                        "new_empty_strided", "empty_like"})
#: In-place ops that overwrite their first operand without reading it.
_OVERWRITE = frozenset({"copy_", "zero_", "fill_", "uniform_", "normal_"})

HERE, AWAY = 0, 1

_PORT_DIR = os.sep + "repro_torch" + os.sep
#: Files whose frames are the walker's own, not the program's.
_OWN = (os.sep + os.path.join("launch", "opcost.py"),
        os.sep + os.path.join("launch", "dryrun.py"))

#: The active CostModes, innermost last (report_kernel's target).
_ACTIVE: List["CostMode"] = []


def _pointwise_table() -> dict:
    """{aten overload: how its result's dtype follows} for the pointwise
    ops whose "meta" results CostMode makes itself (_pointwise_meta)."""
    a = torch.ops.aten
    table = {}
    for name in ("add", "sub", "mul", "maximum", "minimum", "rsub"):
        for ov in ("Tensor", "Scalar", "default"):
            if hasattr(getattr(a, name), ov):
                table[getattr(getattr(a, name), ov)] = "promote"
    table[a.pow.Tensor_Scalar] = table[a.pow.Tensor_Tensor] = "promote"
    table[a.div.Tensor] = table[a.div.Scalar] = "float"
    for name in ("eq", "ne", "lt", "le", "gt", "ge"):
        for ov in ("Tensor", "Scalar"):
            table[getattr(getattr(a, name), ov)] = "bool"
    for name in ("exp", "log", "log1p", "expm1", "sqrt", "rsqrt", "sigmoid",
                 "tanh", "sin", "cos", "exp2", "reciprocal"):
        table[getattr(a, name).default] = "unary_float"
    for name in ("neg", "abs", "relu", "silu"):
        table[getattr(a, name).default] = "unary"
    for ov in ("default", "Tensor"):
        table[getattr(a.clamp, ov)] = table[getattr(a.clamp_min, ov)] = \
            table[getattr(a.clamp_max, ov)] = "promote"
    table[a.where.self] = "where"
    table[a.masked_fill.Scalar] = "first"
    table[a._to_copy.default] = "copy"
    return table


def _broadcast(tensors) -> tuple | None:
    """The broadcast shape of the tensors' shapes, or None where they do
    not broadcast (the op's own kernel then raises)."""
    ndim = max(t.dim() for t in tensors)
    out = [1] * ndim
    for t in tensors:
        for i, d in enumerate(t.shape, ndim - t.dim()):
            if d != 1:
                if out[i] not in (1, d):
                    return None
                out[i] = d
    return tuple(out)


_POINTWISE: dict = {}


def _pointwise_meta(func, args, kwargs) -> torch.Tensor | None:
    """The result of a pointwise op on contiguous "meta" tensors made
    directly (a contiguous tensor of the broadcast shape and the promoted
    dtype), for the ops of _pointwise_table: the same shape, dtype and
    layout as the op's own meta kernel, which for these runs as Python and
    is ~10x slower. None for any other call."""
    if not _POINTWISE:
        _POINTWISE.update(_pointwise_table())
    how = _POINTWISE.get(func)
    if how is None:
        return None
    if how == "copy":
        dtype = kwargs.get("dtype") or args[0].dtype
        if args[0].device.type != "meta" or \
                not args[0].is_contiguous() or any(
                kwargs.get(k) not in (None, v) for k, v in (
                    ("device", torch.device("meta")),
                    ("layout", torch.strided))):
            return None
        return torch.empty(args[0].shape, dtype=dtype, device="meta")
    if any(k != "alpha" for k in kwargs):
        return None
    tensors = [x for x in args if isinstance(x, torch.Tensor)]
    if not tensors or any(t.device.type != "meta" or not t.is_contiguous()
                          for t in tensors) or \
            any(not isinstance(x, (torch.Tensor, int, float, bool))
                for x in args):
        return None
    shape = _broadcast(tensors)
    if shape is None:
        return None
    if how == "bool":
        dtype = torch.bool
    elif how in ("unary", "first"):
        dtype = args[0].dtype
    elif how == "unary_float":
        dtype = args[0].dtype
        if not dtype.is_floating_point:
            dtype = torch.get_default_dtype()
    elif how == "where":
        dtype = torch.result_type(args[1], args[2])
    else:
        dtype = (torch.result_type(args[0], args[1]) if len(args) > 1
                 and args[1] is not None else args[0].dtype)
        if how == "float" and not dtype.is_floating_point:
            dtype = torch.get_default_dtype()
    return torch.empty(shape, dtype=dtype, device="meta")


_OPS: dict = {}
_DTYPES: dict = {}


def _name(dtype) -> str:
    _DTYPES[dtype] = n = ("-" if dtype is None
                          else str(dtype).removeprefix("torch."))
    return n


def _op_info(func) -> tuple:
    """(row name, views only, operands it overwrites unread, leaves its
    result unwritten, has a FLOP formula) of an aten overload, cached."""
    info = _OPS.get(func)
    if info is None:
        name = func._overloadpacket.__name__
        returns = func._schema.returns
        skip = name in SKIP_BYTES_OPS or (bool(returns) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in returns))
        _OPS[func] = info = (f"aten.{name}", skip,
                             1 if name in _OVERWRITE else 0,
                             name in _UNWRITTEN,
                             func._overloadpacket in flop_registry)
    return info


_COMPOSITE: dict = {}


def _composite(func) -> bool:
    """Whether an aten overload is CompositeImplicitAutograd (a
    decomposition into other ops, not a kernel of its own)."""
    got = _COMPOSITE.get(func)
    if got is None:
        got = _COMPOSITE[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    return got


def _unit(dtype: torch.dtype) -> str:
    """The compute unit a matmul of this dtype runs on."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32:
        return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "fp32"
    return str(dtype).removeprefix("torch.")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _caller() -> str:
    """The innermost port function on the stack ("models/layers.py:dense"),
    or the autograd node running (a backward op), or "?"."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if _PORT_DIR in name and not name.endswith(_OWN):
            rel = name.split(_PORT_DIR, 1)[1]
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    node = torch._C._current_autograd_node()
    return f"backward:{node.name()}" if node is not None else "?"


def _tensors(obj, out=None) -> list:
    """The tensors in obj (nested lists, tuples, dicts), in order."""
    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple, dict)):
                _tensors(x, out)
    elif isinstance(obj, dict):
        _tensors(list(obj.values()), out)
    return out


@dataclasses.dataclass
class Row:
    """One op (or kernel) of the run, as the position runs it."""
    op: str
    flops: float
    unit: str            # what its flops run on: bf16, fp32, tf32, sfu
    bytes_read: float    # HBM: operands held here
    bytes_written: float
    coll_bytes: float    # operands read from another position
    coll_kind: str | None
    dtype: str
    shapes: tuple        # of its first operands' shapes
    fn: str
    count: int = 1       # ops it stands for (a replayed block sums them)

    @property
    def bytes(self) -> float:
        return self.bytes_read + self.bytes_written


@dataclasses.dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_OPS})
    flops_by_unit: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def of(cls, rows: Iterable[Row]) -> "CostTotals":
        tot = cls()
        for r in rows:
            tot.flops += r.flops
            tot.bytes += r.bytes
            if r.flops:
                tot.flops_by_unit[r.unit] = \
                    tot.flops_by_unit.get(r.unit, 0.0) + r.flops
            if r.coll_bytes:
                tot.coll_bytes += r.coll_bytes
                tot.coll_by_kind[r.coll_kind] += r.coll_bytes
        return tot


@dataclasses.dataclass
class _Storage:
    nbytes: int
    owner: int | None = None
    fixed: bool = False        # owner set by hold / moved, not inferred
    argument: bool = False


class CostMode(TorchDispatchMode):
    """Records a Row per aten op, and the live bytes of the run (module
    docstring). After the `with` block: `rows` (the ops that ran here),
    `totals()`, `temp_peak` (bytes), `peak_at` (the row at the peak),
    `kernel_launches` ({kernel: launches}).

    `position`: the mesh position traced. Work the program runs as another
    position (distributed/context.at) runs away, and a model position's
    share of a layer that mirrors the first's is not run at all (context
    .each gives it stand-ins); work as `position` runs here."""

    def __init__(self, position: int | None = None):
        super().__init__()
        self.position = position
        self._sid: Dict[int, int] = {}          # storage _cdata -> sid
        self._st: List[_Storage] = []
        # the timeline: _add's ops, ("alloc", sid) of moved and ("free",
        # sid)
        self._events: list = []
        self._suspended = 0
        self._depth = 0
        self._open = True
        self._memo: dict = {}
        self.rows: List[Row] = []
        self.temp_peak = 0
        self.peak_at: Row | None = None
        self.kernel_launches: Dict[str, int] = defaultdict(int)

    # -- storages -------------------------------------------------------

    def _storage(self, t: torch.Tensor, new_ok: bool = True):
        """(sid, is_new) of t's storage; registers it when unseen."""
        s = t.untyped_storage()
        key = s._cdata
        sid = self._sid.get(key)
        if sid is not None:
            return sid, False
        if not new_ok:
            return None, False
        sid = len(self._st)
        self._st.append(_Storage(s.nbytes()))
        self._sid[key] = sid
        weakref.finalize(s, self._free, key, sid)
        return sid, True

    def _free(self, key: int, sid: int) -> None:
        if self._open and self._sid.get(key) == sid:
            del self._sid[key]
            self._events.append(("free", sid))

    def hold(self, tree, here: bool = True) -> None:
        """Register every tensor of `tree` as an argument held here (or at
        another position): read by the run, not counted in its temp."""
        for t in _tensors(tree):
            sid, _ = self._storage(t)
            st = self._st[sid]
            st.owner, st.fixed, st.argument = (HERE if here else AWAY,
                                               True, True)

    def held(self, t: torch.Tensor) -> int | None:
        """HERE or AWAY for a tensor viewing an argument `hold` registered,
        else None."""
        sid, _ = self._storage(t, new_ok=False)
        if sid is None or not self._st[sid].argument:
            return None
        return self._st[sid].owner

    def moved(self, t: torch.Tensor) -> torch.Tensor:
        """t in a storage of its own here (as the sum of a piece's
        gradients from every data group is on a mesh), made without a
        row."""
        self._suspended += 1
        try:
            out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        finally:
            self._suspended -= 1
        sid = self._storage(out)[0]
        self._st[sid].owner, self._st[sid].fixed = HERE, True
        self._events.append(("alloc", sid))
        return out

    def repeat(self, key, fn, inputs):
        """fn()'s results (a tuple of tensors or None), with fn's ops
        traced once per `key`: a later call with the same key adds the
        first call's rows again, summed by (op, function, shapes, dtype),
        and the first call's peak of live bytes above its start, and
        returns fresh "meta" results of the same shapes -- the counterpart
        of hlo.py multiplying a loop body by its trip count, for work that
        repeats exactly (the scan's backward, once per Mamba layer).
        `inputs` (tensors or None) decide where the work runs."""
        memo = self._memo.get(key)
        if memo is None:
            n0, sid0 = len(self._events), len(self._st)
            outs = fn()
            self._memo[key] = self._block(self._events[n0:], sid0, outs)
            return outs
        rows, peak, shapes = memo
        self._suspended += 1
        try:
            outs = tuple(None if sd is None else
                         torch.empty(sd[0], dtype=sd[1], device="meta")
                         for sd in shapes)
        finally:
            self._suspended -= 1
        reads = [(self._storage(t)[0], 0) for t in inputs if t is not None]
        got = [self._storage(t) for t in outs if t is not None]
        self._events.append(("block", [dataclasses.replace(r) for r in rows],
                             reads, [sid for sid, new in got if new],
                             peak))
        return outs

    def _block(self, events, sid0: int, outs) -> tuple:
        """A traced call's events summed: (its rows summed by key, with
        every operand read counted as HBM bytes; its peak of live bytes
        above its start; its results' shapes and dtypes)."""
        agg: dict = {}
        live = peak = 0
        for ev in events:
            if ev[0] == "free":
                if ev[1] >= sid0:
                    live -= self._st[ev[1]].nbytes
                continue
            if ev[0] == "alloc":
                live += self._st[ev[1]].nbytes
                peak = max(peak, live)
                continue
            if ev[0] != "op":
                continue
            _, row, reads, news, _, _ = ev
            live += sum(self._st[x].nbytes for x in news if x >= sid0)
            peak = max(peak, live)
            key = (row.op, row.fn, row.shapes, row.dtype, row.unit)
            a = agg.get(key)
            if a is None:
                agg[key] = a = dataclasses.replace(
                    row, count=0, flops=0.0, bytes_read=0.0,
                    bytes_written=0.0)
            a.count += row.count
            a.flops += row.flops
            a.bytes_read += sum(nb for _, nb in reads)
            a.bytes_written += row.bytes_written
        return (list(agg.values()), peak,
                [None if t is None else (t.shape, t.dtype) for t in outs])

    def _away(self, ins) -> bool:
        """Whether every operand but 0-dim ones is held away (fixed): the
        op runs at another position."""
        seen = False
        for t in ins:
            if t.dim() == 0:
                continue
            sid = self._sid.get(t.untyped_storage()._cdata)
            if sid is None or self._st[sid].owner != AWAY or \
                    not self._st[sid].fixed:
                return False
            seen = True
        return seen

    # -- rows -----------------------------------------------------------

    def _add(self, row: Row, reads, news, outs, fixed=None) -> None:
        """An op of the timeline: its row, [(sid, bytes read)], the sids it
        allocated, the sids of its results, and its owner when known."""
        self._events.append(("op", row, reads, news, outs, fixed))

    def kernel(self, name: str, inputs, outputs, work: float,
               unit: str) -> None:
        """A hand-written kernel's one launch: its operands read once, its
        results written once, `work` on `unit`."""
        reads = [(self._storage(t)[0], _nbytes(t)) for t in inputs]
        got = [self._storage(t) for t in outputs]
        row = Row(f"kernel:{name}", float(work), unit, 0.0,
                  float(sum(_nbytes(t) for t in outputs)), 0.0, None,
                  _dtype(inputs[0]), tuple(t.shape for t in inputs),
                  _caller())
        self._add(row, reads, [sid for sid, new in got if new],
                  [sid for sid, _ in got])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # reached as a whole under inference_mode (autograd's key, which
            # decomposes it otherwise, is skipped): its parts are the ops
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = _pointwise_meta(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        if self._suspended:
            return out
        ins = _tensors(kwargs, _tensors(args))
        outs = _tensors(out)
        at = None if self.position is None else dist.running_at()
        if (at is not None and at != self.position) or self._away(ins):
            # another position's work (its pieces' update): no row, its
            # results held away
            for t in outs:
                sid, _ = self._storage(t)
                st = self._st[sid]
                if st.owner is None:
                    st.owner, st.fixed = AWAY, True
            return out
        name, skip, unread, unwritten, counts_flops = _op_info(func)
        reads, seen = [], set()
        for j, t in enumerate(ins):
            sid, _ = self._storage(t)
            if id(t) in seen:
                continue
            seen.add(id(t))
            counted = not (skip or unwritten or j < unread)
            reads.append((sid, _nbytes(t) if counted else 0))
        news, out_sids = [], []
        for t in outs:
            sid, new = self._storage(t)
            out_sids.append(sid)
            if new:
                news.append(sid)
        written = 0 if (skip or unwritten) else sum(_nbytes(t) for t in outs)
        flops = 0.0
        if counts_flops:
            flops = float(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        dt = ins[0].dtype if ins else (outs[0].dtype if outs else None)
        row = Row(name, flops, _unit(dt) if flops else "-", 0.0,
                  float(written), 0.0, dist.running_collective(),
                  _DTYPES.get(dt) or _name(dt),
                  tuple(t.shape for t in ins[:3]), _caller())
        self._add(row, reads, news, out_sids,
                  None if at is None else HERE)
        return out

    def _skip(self, position: int) -> bool:
        return position != self.position

    def __enter__(self):
        if self._depth == 0:
            _ACTIVE.append(self)
            if self.position is not None:
                dist.SKIPS.append(self._skip)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                _ACTIVE.remove(self)
                if self.position is not None:
                    dist.SKIPS.remove(self._skip)
                self._settle()

    # -- settling owners, rows and the peak -------------------------------

    def _settle(self) -> None:
        st = self._st
        ops = [e for e in self._events if e[0] in ("op", "block")]
        owners: list = [None] * len(ops)
        changed = True
        while changed:
            changed = False
            for i, ev in enumerate(ops):
                reads, outs = ev[2], (ev[4] if ev[0] == "op" else ev[3])
                own, best = (ev[5] if ev[0] == "op" else None), -1
                if own is None:
                    for sid, _ in reads:
                        if st[sid].owner is not None and \
                                st[sid].nbytes > best:
                            best, own = st[sid].nbytes, st[sid].owner
                if own is None:
                    own = next((st[sid].owner for sid in outs
                                if st[sid].owner is not None), None)
                if own is None:
                    continue
                if owners[i] != own:
                    owners[i], changed = own, True
                for sid in [sid for sid, _ in reads] + outs:
                    if st[sid].owner is None:
                        st[sid].owner, changed = own, True
        live = peak = 0
        at, counted, rows, k = None, set(), [], 0
        for ev in self._events:
            if ev[0] == "free":
                if ev[1] in counted:
                    counted.discard(ev[1])
                    live -= st[ev[1]].nbytes
                continue
            if ev[0] == "alloc":
                counted.add(ev[1])
                live += st[ev[1]].nbytes
                if live > peak:
                    peak = live
                continue
            own = HERE if owners[k] is None else owners[k]
            k += 1
            if ev[0] == "block":
                _, block_rows, _, news, block_peak = ev
                if own == HERE:
                    rows += block_rows
                    if live + block_peak > peak:
                        peak, at = live + block_peak, block_rows[0]
            else:
                _, row, reads, news, _, _ = ev
            for sid in news:
                if st[sid].owner in (None, HERE) and not st[sid].argument:
                    counted.add(sid)
                    live += st[sid].nbytes
            if own != HERE or ev[0] == "block":
                continue
            for sid, nb in reads:
                if st[sid].owner == AWAY:
                    row.coll_bytes += nb
                    row.coll_kind = row.coll_kind or "all-gather"
                else:
                    row.bytes_read += nb
            rows.append(row)
            if live > peak:
                peak, at = live, row
        for row in rows:
            if row.op.startswith("kernel:"):
                self.kernel_launches[row.op[len("kernel:"):]] += row.count
        self.rows, self.temp_peak, self.peak_at = rows, peak, at
        self._open, self._events, self._sid = False, [], {}
        self._memo = {}

    def totals(self) -> CostTotals:
        return CostTotals.of(self.rows)


def _dtype(t: torch.Tensor) -> str:
    return _DTYPES.get(t.dtype) or _name(t.dtype)


def active() -> CostMode | None:
    """The innermost CostMode in effect, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


def report_kernel(name: str, inputs, outputs, work: float,
                  unit: str) -> None:
    """A kernel wrapper's report of one launch on "meta" tensors to the
    active CostMode (nothing when none is active)."""
    mode = active()
    if mode is not None:
        mode.kernel(name, list(inputs), list(outputs), work, unit)


def profile_bytes(rows: Iterable[Row], top: int = 25
                  ) -> list[tuple[float, str, str]]:
    """The rows' bytes (HBM and collective) summed by (op, issuing
    function, shapes, dtype), descending: [(bytes, op, "fn shapes dtype
    xN")] -- hlo.py's profile_bytes, the dry-run 'profiler'."""
    agg: dict = {}
    for r in rows:
        key = (r.op, r.fn, r.shapes, r.dtype)
        b, n = agg.get(key, (0.0, 0))
        agg[key] = (b + r.bytes + r.coll_bytes, n + r.count)
    out = [(b, op, f"{fn} {' '.join(str(tuple(x)) for x in shapes)} {dt} "
               f"x{n}")
           for (op, fn, shapes, dt), (b, n) in agg.items()]
    out.sort(key=lambda x: -x[0])
    return out[:top]


# ---------------------------------------------------------------------------
# Roofline terms: NVIDIA H100 SXM5 80GB HBM3, 700 W (datasheet figures)
# ---------------------------------------------------------------------------

#: The card the figures are for.
CARD = "NVIDIA H100 80GB HBM3, 700 W (SXM5)"
#: Dense tensor-core and CUDA-core peaks by unit, FLOP/s (datasheet; fp32
#: is the CUDA cores, the port's default with TF32 off). "sfu": the
#: special-function unit's exponentials, 16 per SM per clock on compute
#: capability 9.0 (CUDA C++ Programming Guide) x 132 SMs x 1.98 GHz.
PEAK_FLOPS = {"bf16": 989.4e12, "tf32": 494.7e12, "fp32": 66.9e12,
              "sfu": 16 * 132 * 1.98e9}
#: HBM3 bandwidth, bytes/s.
HBM_BW = 3.35e12
#: NVLink 4, bytes/s per direction.
LINK_BW = 450e9
#: The card's memory (datasheet: 80 GB).
CARD_BYTES = 80e9


@dataclasses.dataclass
class Roofline:
    flops: float                # per-position FLOPs
    hbm_bytes: float            # per-position HBM traffic
    coll_bytes: float           # per-position collective bytes
    n_chips: int
    flops_by_unit: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def of(cls, tot: CostTotals, n_chips: int) -> "Roofline":
        return cls(tot.flops, tot.bytes, tot.coll_bytes, n_chips,
                   dict(tot.flops_by_unit))

    @property
    def t_compute(self) -> float:
        by_unit = self.flops_by_unit or {"bf16": self.flops}
        return sum(f / PEAK_FLOPS.get(u, PEAK_FLOPS["fp32"])
                   for u, f in by_unit.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def t_roofline(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops, "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes, "n_chips": self.n_chips,
            "flops_by_unit": self.flops_by_unit,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck, "card": CARD,
        }
