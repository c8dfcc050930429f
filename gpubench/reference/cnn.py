"""The plain reference of a CNN configuration: F.conv2d, F.linear-style
matmuls and pools over the configuration's frozen layer list, in fp32 with
TF32 off.

It takes the raw weights and images the benchmark made (the program's
params layout: HWIO conv filters with a bias "b", (n_in, n_out) dense
weights without bias; NHWC images) and works out everything else itself.
It follows the layer list alone and imports nothing of the program.

`forward(..., tf32=True)` is the control: the same network one precision
step below the configuration's fp32. On the card it runs with TF32 on in
cuDNN and cuBLAS; on the CPU it rounds every conv and matmul operand to
TF32's 10 mantissa bits (round to nearest even), as the tensor cores do.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """TensorFlow's SAME split: the odd pixel goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10 mantissa bits, nearest even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def _precision(tf32: bool, device: torch.device):
    """TF32 on or off in cuDNN and cuBLAS for the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = tf32 and device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return F.relu(y)
    if act == "relu6":
        return F.relu6(y)
    if act == "none":
        return y
    raise ValueError(f"unknown activation {act!r}")


def forward(layers: list[dict], params: dict, x: torch.Tensor, *,
            tf32: bool = False) -> torch.Tensor:
    """Logits (N, classes) of NHWC images `x` through `layers`."""
    emulate = tf32 and x.device.type != "cuda"
    op_in = round_tf32 if emulate else (lambda t: t)

    def conv(h, p, k, stride, groups, act):
        pt, pb = _same_pads(h.shape[2], k, stride)
        pl, pr = _same_pads(h.shape[3], k, stride)
        if pt or pb or pl or pr:
            h = F.pad(h, (pl, pr, pt, pb))
        w = p["w"].permute(3, 2, 0, 1)                  # HWIO -> OIHW
        y = F.conv2d(op_in(h), op_in(w), p["b"], stride=stride,
                     groups=groups)
        return _act(y, act)

    with _precision(tf32, x.device), torch.inference_mode():
        h = x.permute(0, 3, 1, 2).contiguous()          # NCHW
        for layer in layers:
            op = layer["op"]
            if op == "conv":
                h = conv(h, params[layer["name"]], layer["k"],
                         layer["stride"], 1, layer["act"])
            elif op == "inverted_residual":
                p = params[layer["name"]]
                src = h
                if "exp" in p:
                    h = conv(h, p["exp"], 1, 1, 1, "relu6")
                h = conv(h, p["dw"], 3, layer["stride"], h.shape[1],
                         "relu6")
                h = conv(h, p["pw"], 1, 1, 1, "none")
                if layer["stride"] == 1 and src.shape[1] == h.shape[1]:
                    h = h + src
            elif op == "maxpool":
                h = F.max_pool2d(h, layer["k"], layer["stride"])
            elif op == "avgpool":
                h = F.avg_pool2d(h, layer["k"], layer["stride"])
            elif op == "global_avg_pool":
                h = h.mean(dim=(2, 3), keepdim=True)
            elif op == "dense":
                flat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
                h = op_in(flat) @ op_in(params[layer["name"]]["w"])
                if layer["relu"]:
                    h = F.relu(h)
                h = h[:, :, None, None]
            else:
                raise ValueError(f"unknown op {op!r} in the layer list")
        return h.reshape(h.shape[0], -1)


def forward_blocks(layers: list[dict], params: dict, x: torch.Tensor, *,
                   block: int, tf32: bool = False) -> torch.Tensor:
    """`forward` over `x` in blocks of `block` images, so that the
    reference's activations stay small beside what the run holds."""
    return torch.cat([forward(layers, params, x[i:i + block], tf32=tf32)
                      for i in range(0, x.shape[0], block)])
