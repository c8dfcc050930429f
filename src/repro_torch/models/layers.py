"""Shared layers: conv init, the per-call conv layer, classifier head and
pooling (the CNNs); the truncated-normal init, RMS and layer norms, the
dense matmul, the MLPs and rotary embeddings (the LM stack).

Plain functions over tensors, NHWC activations and HWIO filters as in the
JAX package's models/layers.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.im2col import _same_pads


def init_conv2d(generator: torch.Generator, kh: int, kw: int, c_in: int,
                c_out: int, dtype=torch.float32, groups: int = 1,
                device=None) -> dict:
    """He-style conv init, HWIO weight + zero bias, drawn from `generator`
    on its own device and moved to `device`. Grouped filters carry
    c_in/groups input channels (groups = c_in is a depthwise conv)."""
    if c_in % groups or c_out % groups:
        raise ValueError(f"groups={groups} must divide c_in={c_in} and "
                         f"c_out={c_out}")
    cg = c_in // groups
    scale = (kh * kw * cg) ** -0.5
    w = torch.randn((kh, kw, cg, c_out), generator=generator, dtype=dtype,
                    device=generator.device)
    return {"w": (scale * w).to(device),
            "b": torch.zeros((c_out,), dtype=dtype, device=device)}


def conv2d_layer(p: dict, x: torch.Tensor, *, plan=None, relu: bool = True,
                 activation: str | None = None,
                 **conv_kwargs) -> torch.Tensor:
    """Conv + bias + epilogue activation. `activation` (a name of
    kernels.runtime.ACTIVATIONS) overrides the legacy `relu` flag. With
    `plan` (any plan with the ConvPlan apply contract, built once) the call
    does no filter transform or geometry work and the epilogue rides the
    plan's fused path; without one it goes through the per-call dispatcher
    (core.dispatch.conv2d; conv_kwargs: stride / padding / algorithm /
    ...)."""
    if activation is None:
        activation = "relu" if relu else "none"
    if plan is not None:
        return plan.apply(x, bias=p["b"], activation=activation)
    from repro_torch.core.dispatch import conv2d  # imports models.layers
    return conv2d(x, p["w"], bias=p["b"], activation=activation,
                  **conv_kwargs)


def dense_head(x: torch.Tensor, w: torch.Tensor,
               relu: bool = True) -> torch.Tensor:
    """Classifier head: flatten all non-batch axes in NHWC order, matmul,
    optional ReLU. A plain large matrix product, left to torch.matmul."""
    y = torch.matmul(x.reshape(x.shape[0], -1), w)
    return F.relu(y) if relu else y


def pool2d(x: torch.Tensor, kind: str, k: int, stride: int,
           padding: str) -> torch.Tensor:
    """Max/avg spatial pooling over NHWC, matching lax.reduce_window: VALID
    drops the ragged edge, SAME pads with lax's lo/hi split (-inf for max,
    zeros for avg), and avg divides by the full window k * k."""
    n, h, w, c = x.shape
    if padding == "SAME":
        ph, pw = _same_pads(h, k, stride), _same_pads(w, k, stride)
    else:
        ph = pw = (0, 0)
    xc = x.permute(0, 3, 1, 2)
    if any(ph) or any(pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]),
                   value=float("-inf") if kind == "max" else 0.0)
    if kind == "max":
        y = F.max_pool2d(xc, k, stride)
    elif kind == "avg":
        y = F.avg_pool2d(xc, k, stride)
    else:
        raise ValueError(f"unknown pool kind {kind!r}")
    return y.permute(0, 2, 3, 1)


def truncated_normal_init(generator: torch.Generator, shape, scale: float,
                          dtype=torch.float32, device=None) -> torch.Tensor:
    """`scale` times a standard normal truncated to [-2, 2], drawn in fp32
    from `generator` on its own device, then cast to `dtype` and moved to
    `device` (None: stay on the generator's). The distribution of the JAX
    package's truncated_normal_init; the numbers differ. On the "meta"
    device nothing is drawn (transformer.abstract_params)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    t = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMS norm over the last axis, computed in fp32, returned in x's
    dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Layer norm over the last axis in fp32 with the population variance
    (jnp.var's), returned in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


class _DenseMM(torch.autograd.Function):
    """x @ w with the reference's mixed-precision backward (models/layers.py:
    _dense_mm): the cotangent is cast to w's dtype before the two products;
    dx = dy @ w.T (fp32 accumulation) in x's dtype, and dw, every leading
    axis of x contracted with dy's, in w's dtype, so bf16 weights get bf16
    gradients. Plain large products, left to torch.matmul."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x, w.to(x.dtype))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(w.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dy, w.t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(x.reshape(-1, x.shape[-1]).to(w.dtype).t(),
                              dy.reshape(-1, dy.shape[-1]))
        return dx, dw


def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w (+ b) in x's dtype, accumulated in fp32 (the reference's
    `_dense_mm`, with its mixed-precision backward when autograd is on);
    the bias is added in fp32 and the sum cast back. A plain large matrix
    product, left to torch.matmul: fp32 with TF32 off, bf16 with fp32
    accumulation."""
    y = (_DenseMM.apply(x, w) if torch.is_grad_enabled()
         else torch.matmul(x, w.to(x.dtype)))
    if b is not None:
        y = (y.float() + b.float()).to(x.dtype)
    return y


def mlp(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """SwiGLU ('gate' / 'up' / 'down') or 2-matrix ('up' / 'down') MLP; the
    activation runs in fp32 and is cast back to x's dtype. GELU is the tanh
    form, jax.nn.gelu's default. Given a model position's column blocks of
    up / gate and row block of down (models/transformer.py's
    tensor-parallel program), it is the column-parallel then row-parallel
    MLP: the result is the position's partial sum, reduced once per
    block."""
    if act == "swiglu":
        g = dense(x, p["gate"])
        u = dense(x, p["up"])
        h = F.silu(g.float()).to(x.dtype) * u
    elif act == "gelu":
        h = F.gelu(dense(x, p["up"]).float(),
                   approximate="tanh").to(x.dtype)
    elif act == "squared_relu":
        h = F.relu(dense(x, p["up"]).float()).square().to(x.dtype)
    else:
        raise ValueError(act)
    return dense(h, p["down"])


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype, device=None) -> dict:
    """The reference's MLP tree: 'up' (d_model, d_ff), 'down' (d_ff,
    d_model) and, for SwiGLU, 'gate' (d_model, d_ff), truncated normals at
    fan-in scale."""
    def tn(shape, scale):
        return truncated_normal_init(generator, shape, scale, dtype, device)
    p = {"up": tn((d_model, d_ff), d_model ** -0.5),
         "down": tn((d_ff, d_model), d_ff ** -0.5)}
    if act == "swiglu":
        p["gate"] = tn((d_model, d_ff), d_model ** -0.5)
    return p


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, hd) at `positions`, (S,) in prefill
    or (B, S) in decode: the first and second halves of hd rotate as pairs
    (not interleaved), in fp32, cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions.float()[..., None] * freqs            # (..., S, hd/2)
    if angles.ndim == 2:                                      # (S, hd/2)
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
