"""Mamba-1 (S6) block: gated selective state-space layer, as in the JAX
package's models/mamba.py.

The short depthwise causal conv (k = d_conv) is where the paper's technique
lands in this family: it runs as a planned region-wise 1D Cook-Toom conv
(core.plan.plan_depthwise_conv1d, the "jnp" backend, as the reference
plans it; the "pallas" backend runs the conv1d_ct_fused kernel and is
reached through the plan's own entry point only).
`SSMConfig.conv_algorithm` switches between cook_toom and the direct conv.

Selective scan: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ; y_t = C_t h_t + D x_t,
through kernels.selective_scan.selective_scan: the hand-written CUDA kernel
on the card, its plain chunked version on the CPU (the reference routes to
its Pallas kernel on the TPU and to the chunked scan elsewhere; the two
agree to 1e-5). With autograd on, the scan is a torch.autograd.Function
with the reference's gradient (_selective_scan_fused): the forward is that
wrapper, the backward the plain chunked scan recomputed chunk by chunk.

Over the "model" axis (models/transformer.py's tensor-parallel program),
d_in splits over the model positions (`mamba_block_tp`,
`mamba_decode_tp`): each position's conv and scan run on its d_in / n
channels, as contiguous tensors of their own (no copy is made for the
kernel), and x_proj's output is summed across positions before dt_proj.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.plan import plan_depthwise_conv1d
from repro_torch.distributed import context as dist
from repro_torch.distributed.sharding import compute_view, keeps_model
from repro_torch.kernels import selective_scan as _k_scan
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense, truncated_normal_init

_F32 = torch.float32


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or cfg.d_model // 16
    return s, d_in, dt_rank


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) in the exact stable form of jax.nn.softplus
    (torch's F.softplus switches to x above a threshold)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def init_mamba(generator: torch.Generator, cfg: ArchConfig, dtype,
               device) -> dict:
    """One Mamba layer's parameters, drawn from `generator` on its own
    device and placed on `device`; the reference's shapes, scales and
    dtypes (dt_bias, a_log and d_skip stay fp32)."""
    s, d_in, dt_rank = _dims(cfg)
    d = cfg.d_model

    def tn(shape, scale):
        return truncated_normal_init(generator, shape, scale, dtype, device)

    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((d_in,), generator=generator, dtype=_F32,
                   device=generator.device)
    dt0 = torch.exp(lo + (hi - lo) * u).clamp_min(1e-4)
    return {
        "in_proj": tn((d, 2 * d_in), d ** -0.5),
        "conv_w": tn((s.d_conv, d_in), s.d_conv ** -0.5),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "x_proj": tn((d_in, dt_rank + 2 * s.d_state), d_in ** -0.5),
        "dt_proj": tn((dt_rank, d_in), dt_rank ** -0.5),
        "dt_bias": torch.log(torch.expm1(dt0)).to(device),
        # S4D-real init: A = -(1 .. N), stored as log(-A).
        "a_log": torch.log(torch.arange(1, s.d_state + 1, dtype=_F32,
                                        device=device)).expand(
                                            d_in, s.d_state).contiguous(),
        "d_skip": torch.ones((d_in,), dtype=_F32, device=device),
        "out_proj": tn((d_in, d), d_in ** -0.5),
    }


def _scan_chunk(cfg: ArchConfig, length: int) -> int:
    """The reference's chunk rule: scan_chunk, or the whole sequence when
    it does not divide L. Only the plain version (and so the gradient)
    uses it."""
    chunk = min(cfg.ssm.scan_chunk, length)
    return length if length % chunk else chunk


class _SelectiveScan(torch.autograd.Function):
    """The selective scan with the reference's gradient (models/mamba.py:
    _selective_scan_fused): the forward runs kernels.selective_scan.
    selective_scan (the kernel on the card, its plain version on the CPU);
    the backward recomputes the plain chunked scan under autograd, each
    chunk under torch.utils.checkpoint as the reference's jax.checkpoint'd
    chunk_step, so one chunk's (B, chunk, D, N) prefix tensors are live
    at a time, and backpropagates the cotangents of y and h_last (either
    may be None, which counts as zero)."""

    @staticmethod
    def forward(ctx, dt, xs, bmat, cmat, a_mat, chunk):
        ctx.save_for_backward(dt, xs, bmat, cmat, a_mat)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _k_scan.selective_scan(dt, xs, bmat, cmat, a_mat, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dh):
        saved, needs = ctx.saved_tensors, ctx.needs_input_grad

        def grads():
            return _scan_grads(saved, needs, ctx.chunk, dy, dh)
        if saved[0].device.type == "meta":
            # a dry run (launch/opcost.py): the plain recompute is counted
            # op by op once per shape, and replayed for every other layer
            from repro_torch.launch import opcost
            mode = opcost.active()
            if mode is not None:
                key = ("selective_scan backward", ctx.chunk, needs,
                       dy is None, dh is None,
                       *((t.shape, t.dtype) for t in saved))
                return mode.repeat(key, grads, (*saved, dy, dh))
        return grads()


def _scan_grads(saved, needs, chunk: int, dy, dh) -> tuple:
    """_SelectiveScan's gradients: the plain chunked scan recomputed under
    autograd on the saved inputs and differentiated against the
    cotangents dy, dh (either may be None)."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(saved, needs)]
    wanted = [t for t in inputs if t.requires_grad]
    cots = [(i, c) for i, c in enumerate((dy, dh)) if c is not None]
    if not wanted or not cots:
        return (None,) * 6
    with torch.enable_grad():
        outs = _k_scan.selective_scan_plain(*inputs, chunk=chunk,
                                            remat=True)
    grads = iter(torch.autograd.grad([outs[i] for i, _ in cots], wanted,
                                     [c for _, c in cots]))
    return (*(next(grads) if t.requires_grad else None for t in inputs),
            None)


def _mamba_in(p: dict, x: torch.Tensor, cfg: ArchConfig, d_in: int):
    """The block up to x_proj: (xs after the conv and SiLU, z, xs before
    the conv, xs @ x_proj), over the d_in channels p holds."""
    s = cfg.ssm
    length = x.shape[1]
    xz = dense(x, p["in_proj"])                        # (B, L, 2*d_in)
    xs, z = xz.split(d_in, dim=-1)
    xs_raw = xs                                        # pre-conv (decode cache)

    if s.conv_algorithm == "cook_toom":
        conv_plan = plan_depthwise_conv1d(xs.shape, p["conv_w"].to(xs.dtype),
                                          device=x.device)
        xs = conv_plan.apply(xs)
    else:
        pad = F.pad(xs, (0, 0, s.d_conv - 1, 0))
        xs = sum(pad[:, k:k + length] * p["conv_w"][k].to(xs.dtype)[None, None]
                 for k in range(s.d_conv))
    xs = F.silu((xs + p["conv_b"].to(xs.dtype)).to(_F32)).to(x.dtype)
    return xs, z, xs_raw, dense(xs, p["x_proj"])       # (B, L, dt_rank + 2N)


def _mamba_out(p: dict, xs: torch.Tensor, z: torch.Tensor,
               proj: torch.Tensor, cfg: ArchConfig, dtype):
    """The block from x_proj's output on: the selective scan over the
    channels p holds and out_proj. Returns (out, h_last)."""
    s, _, dt_rank = _dims(cfg)
    length = xs.shape[1]
    dt, bmat, cmat = proj.split([dt_rank, s.d_state, s.d_state], dim=-1)
    dt = softplus(dense(dt, p["dt_proj"]).to(_F32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])                         # (d_in, N)

    xs32 = xs.to(_F32)
    args = (dt, xs32.contiguous(), bmat.to(_F32).contiguous(),
            cmat.to(_F32).contiguous(), a)
    chunk = _scan_chunk(cfg, length)
    if torch.is_grad_enabled():
        y, h_last = _SelectiveScan.apply(*args, chunk)
    else:
        y, h_last = _k_scan.selective_scan(*args, chunk=chunk)
    y = (y + xs32 * p["d_skip"]).to(dtype)
    y = y * F.silu(z.to(_F32)).to(dtype)
    return dense(y, p["out_proj"]), h_last


def _conv_state(xs_raw: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The decode cache's conv window: the last k - 1 inputs of the conv,
    zero-padded in front for a shorter sequence. A copy: a view would keep
    the whole (B, L, 2*d_in) projection alive."""
    k = cfg.ssm.d_conv
    conv_cache = xs_raw[:, -(k - 1):].clone()          # (B, k-1, d_in)
    if xs_raw.shape[1] < k - 1:
        conv_cache = F.pad(conv_cache, (0, 0, k - 1 - xs_raw.shape[1], 0))
    return conv_cache


def mamba_block(p: dict, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False):
    """x: (B, L, D) -> (B, L, D). Training / prefill path.

    With return_state, also returns the decode cache {"conv", "ssm"} at the
    final position (prefill)."""
    xs, z, xs_raw, proj = _mamba_in(p, x, cfg, _dims(cfg)[1])
    out, h_last = _mamba_out(p, xs, z, proj, cfg, x.dtype)
    if not return_state:
        return out
    return out, {"conv": _conv_state(xs_raw, cfg), "ssm": h_last}


# ---------------------------------------------------------------------------
# Single-token decode (recurrent form): O(1) per token, plain PyTorch (the
# reference has no kernel here either).
# ---------------------------------------------------------------------------

def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    s, d_in, _ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, d_in), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, d_in, s.d_state), dtype=_F32,
                           device=device),
    }


def _decode_in(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig,
               d_in: int):
    """The decode step up to x_proj, over the d_in channels p and the cache
    hold: (xs, z, the new conv window, xs @ x_proj)."""
    xz = dense(x[:, 0], p["in_proj"])
    xs, z = xz.split(d_in, dim=-1)                     # (B, d_in)

    window = torch.cat([cache["conv"], xs[:, None]], dim=1)   # (B, k, d_in)
    conv_out = (window * p["conv_w"].to(xs.dtype)[None]).sum(dim=1)
    xs = F.silu((conv_out + p["conv_b"].to(xs.dtype)).to(_F32)).to(x.dtype)
    return xs, z, window[:, 1:], dense(xs, p["x_proj"])


def _decode_out(p: dict, xs: torch.Tensor, z: torch.Tensor,
                proj: torch.Tensor, ssm: torch.Tensor, cfg: ArchConfig,
                dtype):
    """The decode step from x_proj's output on: (out (B, 1, D), the new
    SSM state)."""
    s, _, dt_rank = _dims(cfg)
    dt, bvec, cvec = proj.split([dt_rank, s.d_state, s.d_state], dim=-1)
    dt = softplus(dense(dt, p["dt_proj"]).to(_F32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    a_bar = torch.exp(dt[..., None] * a[None])         # (B, d_in, N)
    bx = (dt * xs.to(_F32))[..., None] * bvec.to(_F32)[:, None, :]
    h = a_bar * ssm + bx                               # (B, d_in, N)
    y = torch.einsum("bds,bs->bd", h, cvec.to(_F32))
    y = (y + xs.to(_F32) * p["d_skip"]).to(dtype)
    y = y * F.silu(z.to(_F32)).to(dtype)
    return dense(y, p["out_proj"])[:, None], h


def mamba_decode_step(p: dict, x: torch.Tensor, cache: dict,
                      cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, D) -> (B, 1, D), updating the {conv, ssm} cache."""
    xs, z, conv, proj = _decode_in(p, x, cache, cfg, _dims(cfg)[1])
    out, h = _decode_out(p, xs, z, proj, cache["ssm"], cfg, x.dtype)
    return out, {"conv": conv, "ssm": h}


# ---------------------------------------------------------------------------
# Tensor-parallel over the "model" axis: d_in split over the positions
# ---------------------------------------------------------------------------

#: The leaves that split over "model" (all must keep the axis).
_TP_LEAVES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
              "a_log", "d_skip", "out_proj")


def tp_splits(p: dict) -> bool:
    """Whether the placed block computes split over the model positions:
    every leaf that the specs split over "model" kept that axis."""
    return keeps_model(*(p[k] for k in _TP_LEAVES))


def tp_views(p: dict, cfg: ArchConfig, n: int, m: int, device) -> dict:
    """Model position m's blocks of the (placed) Mamba params on `device`:
    its d_in / n channels -- in_proj's [x_m | z_m] columns (stored as [x |
    z], so not the storage block), conv_w / conv_b / dt_bias / d_skip /
    a_log's channels, x_proj's and out_proj's rows, dt_proj's columns
    (stored split by rows)."""
    d_in = _dims(cfg)[1]
    c = d_in // n
    views = {name: compute_view(leaf, m, n, device)
             for name, leaf in p.items()
             if name not in ("in_proj", "dt_proj")}
    views["in_proj"] = compute_view(p["in_proj"], m, n, device, [
        (m * c, (m + 1) * c), (d_in + m * c, d_in + (m + 1) * c)])
    views["dt_proj"] = compute_view(p["dt_proj"], m, n, device, dim=1)
    return views


def mamba_block_tp(p: dict, hs: list, cfg: ArchConfig, group,
                   return_state: bool = False):
    """mamba_block split over the group's model positions: hs[m] the whole
    (B, L, D) input at position m. Each position runs in_proj's [x_m |
    z_m], the conv and the selective scan (the kernel, on its d_in / n
    channels) on its channels; x_proj is row-parallel, so its (dt + 2N)
    output is summed across positions (all-reduce) before dt_proj; out_proj
    is row-parallel. Returns (each position's partial output; with
    return_state, also each position's {conv, ssm} state of its
    channels)."""
    n = group.n
    c = _dims(cfg)[1] // n
    views = dist.each(group, lambda m: tp_views(p, cfg, n, m,
                                                group.devices[m]))
    ins = dist.each(group, lambda m: _mamba_in(views[m], hs[m], cfg, c))
    projs = dist.all_reduce([i[3] for i in ins], group)
    outs = dist.each(group, lambda m: _mamba_out(
        views[m], ins[m][0], ins[m][1], projs[m], cfg, hs[m].dtype))
    parts = [o for o, _ in outs]
    if not return_state:
        return parts
    return parts, [{"conv": _conv_state(ins[m][2], cfg), "ssm": outs[m][1]}
                   for m in range(n)]


def mamba_decode_tp(p: dict, hs: list, caches: list, cfg: ArchConfig,
                    group) -> tuple[list, list]:
    """mamba_decode_step split over the group's model positions as
    mamba_block_tp: caches[m] position m's {conv, ssm} of its channels.
    Returns (each position's partial output, its new cache)."""
    n = group.n
    c = _dims(cfg)[1] // n
    views = dist.each(group, lambda m: tp_views(p, cfg, n, m,
                                                group.devices[m]))
    ins = dist.each(group, lambda m: _decode_in(views[m], hs[m], caches[m],
                                                cfg, c))
    projs = dist.all_reduce([i[3] for i in ins], group)
    outs = dist.each(group, lambda m: _decode_out(
        views[m], ins[m][0], ins[m][1], projs[m], caches[m]["ssm"], cfg,
        hs[m].dtype))
    return ([o for o, _ in outs],
            [{"conv": ins[m][2], "ssm": outs[m][1]} for m in range(n)])
