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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def moe_block(p: dict, x: torch.Tensor, cfg: ArchConfig,
              dropless: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, fp32 load-balance aux loss).

    dropless=True is the serving semantics: no token can overflow, so a
    token's output does not depend on its batch neighbours and prefill +
    decode reproduce the full forward. dropless=False bounds each expert at
    `capacity` rows (bulk prefill, training): tokens past it, in token
    order, contribute zero.
    """
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    probs = torch.softmax(torch.matmul(xf.float(), p["router"]), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, m.top_k, dim=-1)   # (T, k)
    if m.top_k > 1:                                              # renormalize
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    cap = capacity(m, t, dropless)
    rows = torch.arange(t, device=x.device)

    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for k in range(m.top_k):
        eid = expert_ids[:, k]                                   # (T,)
        gv = gate_vals[:, k].to(x.dtype)
        onehot = F.one_hot(eid, m.n_experts)
        pos = onehot.cumsum(dim=0)[rows, eid] - 1                # (T,)
        keep = pos < cap
        pos_c = torch.where(keep, pos, torch.full_like(pos, cap))
        buf = torch.zeros((m.n_experts, cap + 1, d), dtype=x.dtype,
                          device=x.device)
        buf[eid, pos_c] = xf                 # slot C: the dropped tokens
        out = F.pad(_expert_ffn(p, buf[:, :cap], cfg.act), (0, 0, 0, 1))
        y = y + out[eid, pos_c] * (gv * keep.to(x.dtype))[:, None]

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_ids[:, 0], m.n_experts).float().mean(dim=0)
    aux = m.n_experts * (me * ce).sum()
    return y.reshape(b, s, d), aux
