"""Token-choice top-k Mixture-of-Experts with capacity-bounded scatter
dispatch, as in the JAX package's models/moe.py. Plain PyTorch (the
reference's scatter and batched einsums reach no Pallas kernel).

The formulation is the reference's, kept so routing and drops agree token
for token: each of the top_k choices scatters the tokens into an
(E, C + 1, D) buffer at their cumsum position (slot C is the overflow bin,
dropped), the experts run as one batched FFN over (E, C, D), and each
token gathers its row back, weighted by its gate. Dropless routing
(capacity C = T) therefore does E times the work of the tokens' own
experts: a per-expert gather is a later performance item.

A data-parallel train step (launch/steps.py) runs a batch's rows as data
groups, one after another. Capacity-bounded routing depends on the whole
batch (the capacity counts all its tokens, a token's slot counts the
tokens before it, the aux loss averages over all of them), so each group
routes through a `GroupRouting`: the batch's token count, the expert
counts of the groups before it as slot offsets, and the router's summed
probabilities returned for the step to form the batch's aux loss. The
groups then route exactly as the whole batch does.

Over the "model" axis (models/transformer.py's tensor-parallel program),
`moe_block_tp` keeps the router and the routing replicated and splits the
experts: "ep" gives each model position its experts' rows, "tp" each
expert's ffn columns; the positions' outputs are partial sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import context as dist
from repro_torch.distributed.sharding import compute_view, keeps_model
from repro_torch.models.config import ArchConfig, MoEConfig
from repro_torch.models.layers import truncated_normal_init

_F32 = torch.float32


def init_moe(generator: torch.Generator, cfg: ArchConfig, dtype,
             device=None) -> dict:
    """The reference's tree: an fp32 router (D, E) and per-expert 'up'
    (E, D, F), 'down' (E, F, D) and, for SwiGLU, 'gate' (E, D, F)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts

    def tn(shape, scale, dt=dtype):
        return truncated_normal_init(generator, shape, scale, dt, device)

    p = {"router": tn((d, e), d ** -0.5, _F32),
         "up": tn((e, d, f), d ** -0.5),
         "down": tn((e, f, d), f ** -0.5)}
    if cfg.act == "swiglu":
        p["gate"] = tn((e, d, f), d ** -0.5)
    return p


def _expert_ffn(p: dict, xs: torch.Tensor, act: str) -> torch.Tensor:
    """(E, C, D) -> (E, C, D), batched over experts. The SwiGLU gate stays
    fp32 until the activation, as the reference's preferred_element_type
    leaves it."""
    dtype = xs.dtype
    up = torch.bmm(xs, p["up"].to(dtype))
    if act == "swiglu":
        gate = torch.bmm(xs.float(), p["gate"].to(dtype).float())
        h = F.silu(gate).to(dtype) * up
    elif act == "squared_relu":
        h = F.relu(up.float()).square().to(dtype)
    else:
        h = F.gelu(up.float(), approximate="tanh").to(dtype)
    return torch.bmm(h, p["down"].to(dtype))


def capacity(m: MoEConfig, tokens: int, dropless: bool) -> int:
    """Rows per expert in the dispatch buffer: every token when dropless,
    else the reference's max(int(capacity_factor * T / E) + 1, 4)."""
    if dropless:
        return tokens
    return max(int(m.capacity_factor * tokens * 1.0 / m.n_experts) + 1, 4)


class GroupRouting:
    """Capacity-bounded routing of a batch whose rows run as data groups,
    in order. `counts[key][g]` holds group g's (top_k, E) expert counts at
    the MoE layer `key`, recorded by its first forward; a checkpoint
    recompute reads the same offsets and records nothing."""

    def __init__(self, tokens: int):
        self.tokens = tokens
        self.counts: dict = {}

    def at(self, group: int, key) -> "LayerRoute":
        return LayerRoute(self, group, key)

    def aux(self, psums: list, cfg: ArchConfig) -> torch.Tensor:
        """The batch's summed load-balance aux loss (Switch), from each
        group's (n_layers, E) summed router probabilities (`psums`, in
        group order, the layers in `counts`' key order) and the recorded
        top-1 counts: E * sum_e mean_t(probs) * mean_t(top-1 one-hot) at
        every layer."""
        dev = psums[0].device
        me = sum(p.to(dev) for p in psums) / self.tokens
        ce = torch.stack([sum(c[0].to(dev) for c in self.counts[k])
                          for k in self.counts]).float() / self.tokens
        aux = torch.zeros((), dtype=_F32, device=dev)
        for row in cfg.moe.n_experts * (me * ce).sum(dim=-1):
            aux = aux + row
        return aux


class LayerRoute:
    """One group's view of one MoE layer of a GroupRouting."""

    def __init__(self, routing: GroupRouting, group: int, key):
        self.routing, self.group, self.key = routing, group, key

    def offsets(self, shape, device) -> torch.Tensor:
        """(top_k, E) expert counts of the groups before this one."""
        before = self.routing.counts.get(self.key, [])[:self.group]
        out = torch.zeros(shape, dtype=torch.long, device=device)
        for c in before:
            out = out + c.to(device)
        return out

    def record(self, counts: torch.Tensor) -> None:
        seen = self.routing.counts.setdefault(self.key, [])
        if len(seen) == self.group:
            seen.append(counts.detach())


def _route(p: dict, xf: torch.Tensor, cfg: ArchConfig, dropless: bool,
           route: LayerRoute | None) -> dict:
    """The routing of the (T, D) tokens xf: the router's probabilities,
    each top-k choice's expert, gate and slot (slot `cap`: dropped), and
    the capacity."""
    m = cfg.moe
    t = xf.shape[0]
    probs = torch.softmax(torch.matmul(xf.float(), p["router"]), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, m.top_k, dim=-1)   # (T, k)
    if m.top_k > 1:                                              # renormalize
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    cap = capacity(m, t if route is None else route.routing.tokens,
                   dropless)
    rows = torch.arange(t, device=xf.device)
    onehots = [F.one_hot(expert_ids[:, k], m.n_experts)
               for k in range(m.top_k)]
    if route is not None:
        offsets = route.offsets((m.top_k, m.n_experts), xf.device)
        route.record(torch.stack([o.sum(dim=0) for o in onehots]))
    choices = []
    for k in range(m.top_k):
        eid = expert_ids[:, k]                                   # (T,)
        pos = onehots[k].cumsum(dim=0)[rows, eid] - 1            # (T,)
        if route is not None:
            pos = pos + offsets[k][eid]
        keep = pos < cap
        pos_c = torch.where(keep, pos, torch.full_like(pos, cap))
        choices.append((eid, gate_vals[:, k], keep, pos_c))
    return {"probs": probs, "onehot0": onehots[0], "choices": choices,
            "cap": cap}


def _experts(p: dict, xf: torch.Tensor, routing: dict, cfg: ArchConfig,
             first: int = 0) -> torch.Tensor:
    """The (T, D) sum over the top-k choices of each token's expert
    output times its gate, for the experts p holds: all of them, or
    (`first` given, "ep") experts first .. first + E_p - 1, a token's other
    choices counting zero (their slot is the buffer's dropped one)."""
    t, d = xf.shape
    cap = routing["cap"]
    n_here = p["up"].shape[0]
    y = torch.zeros((t, d), dtype=xf.dtype, device=xf.device)
    for eid, gv, keep, pos_c in routing["choices"]:
        if n_here != cfg.moe.n_experts:
            own = (eid >= first) & (eid < first + n_here)
            pos_c = torch.where(own, pos_c, torch.full_like(pos_c, cap))
            eid = (eid - first).clamp(0, n_here - 1)
        buf = torch.zeros((n_here, cap + 1, d), dtype=xf.dtype,
                          device=xf.device)
        buf[eid, pos_c] = xf                 # slot C: the dropped tokens
        out = F.pad(_expert_ffn(p, buf[:, :cap], cfg.act), (0, 0, 0, 1))
        y = y + out[eid, pos_c] * (gv.to(xf.dtype)
                                   * keep.to(xf.dtype))[:, None]
    return y


def _aux(routing: dict, cfg: ArchConfig) -> torch.Tensor:
    """The load-balance aux loss (Switch): E * sum_e f_e * p_e."""
    me = routing["probs"].mean(dim=0)
    ce = routing["onehot0"].float().mean(dim=0)
    return cfg.moe.n_experts * (me * ce).sum()


def moe_block(p: dict, x: torch.Tensor, cfg: ArchConfig,
              dropless: bool = False, route: LayerRoute | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, fp32 load-balance aux loss); with `route` (a
    data group of a larger batch, capacity-bounded), the aux loss's part
    is the (E,) summed router probabilities instead.

    dropless=True is the serving semantics: no token can overflow, so a
    token's output does not depend on its batch neighbours and prefill +
    decode reproduce the full forward. dropless=False bounds each expert at
    `capacity` rows (bulk prefill, training): tokens past it, in token
    order, contribute zero.
    """
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    routing = _route(p, xf, cfg, dropless, route)
    y = _experts(p, xf, routing, cfg)
    if route is not None:
        return y.reshape(b, s, d), routing["probs"].sum(dim=0)
    return y.reshape(b, s, d), _aux(routing, cfg)


def tp_splits(p: dict) -> bool:
    """Whether the placed experts split over the model positions: every
    expert leaf kept its "model" axis (the router stays replicated)."""
    return keeps_model(*(p[k] for k in ("up", "down", "gate") if k in p))


def moe_block_tp(p: dict, hs: list, cfg: ArchConfig, group,
                 dropless: bool = False, route: LayerRoute | None = None
                 ) -> tuple[list, torch.Tensor]:
    """moe_block split over the group's model positions, hs[m] the whole
    (B, S, D) input at position m: the routing replicated (computed once
    per device, exactly as moe_block's: the same choices, slots and
    drops), then each position runs its experts' rows ("ep") or every
    expert's ffn columns ("tp") and gathers its tokens' outputs back.
    Returns (each position's partial output, the aux term at the first
    position)."""
    n = group.n
    b, s, d = hs[0].shape
    ep = cfg.moe.shard_mode == "ep"
    per = cfg.moe.n_experts // n
    routings: list = []
    for m, dev in enumerate(group.devices):
        if dev in group.devices[:m]:
            routings.append(routings[group.devices.index(dev)])
            continue
        with dist.at(group.positions[m]):
            routings.append(_route(
                {"router": compute_view(p["router"], m, n, dev)},
                hs[m].reshape(b * s, d), cfg, dropless, route))

    def run(m):
        dev = group.devices[m]
        views = {k: compute_view(leaf, m, n, dev) for k, leaf in p.items()
                 if k != "router"}
        y = _experts(views, hs[m].reshape(b * s, d), routings[m], cfg,
                     first=m * per if ep else 0)
        return y.reshape(b, s, d)
    parts = dist.each(group, run)
    first = routings[0]
    aux = (first["probs"].sum(dim=0) if route is not None
           else _aux(first, cfg))
    return parts, aux
