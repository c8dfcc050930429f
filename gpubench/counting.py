"""The work a CNN forward needs, counted from a configuration's frozen layer
list (`configs/<config>.json`, key "layers"), and the card's peaks.

Work is counted for the direct convolution, whatever executor, tile or
fusion the program picks, so a roofline share reads the same work before
and after a change to the kernels:

  * FLOPs of a conv: 2 * N * OH * OW * (C / groups) * M * kh * kw; of a
    dense layer: 2 * N * n_in * n_out. Pools, adds and activations are not
    counted.
  * Compulsory bytes of a conv: its input, its raw filter, its bias and its
    output, each once (fp32). Of a whole inverted-residual block: the
    block's input and output and all of its weights and biases, since the
    expanded activation need not leave the chip.

Imports nothing outside the standard library.
"""

from __future__ import annotations

import math

#: Dense peaks of one card (NVIDIA's data sheet, SXM part, without
#: sparsity), by `torch.cuda.get_device_name()`. The fp32 configurations
#: run TF32x3 tensor-core products, so their FLOPs are held against the
#: TF32 rate.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"tf32_flops": 495e12, "hbm_bytes": 3.35e12},
}
FP32_BYTES = 4


def peaks(device_name: str) -> dict:
    """The peaks of `device_name`; KeyError names the cards in the table."""
    try:
        return PEAKS[device_name]
    except KeyError:
        raise KeyError(f"no peaks for {device_name!r}; the table has "
                       f"{sorted(PEAKS)}") from None


def _same_out(size: int, stride: int) -> int:
    return -(-size // stride)


def walk(layers: list[dict], res: int, c_in: int) -> list[dict]:
    """Each layer of the list with its input and output (h, w, c) filled
    in, and for a parametrised layer the shapes of its parameters in the
    program's layout (HWIO conv filters, (n_in, n_out) dense weights)."""
    h = w = res
    c = c_in
    out = []
    for layer in layers:
        row = dict(layer, inp=(h, w, c))
        op = layer["op"]
        if op == "conv":
            k, s, m = layer["k"], layer["stride"], layer["c_out"]
            h, w = _same_out(h, s), _same_out(w, s)
            row["params"] = {"w": (k, k, c, m), "b": (m,)}
            c = m
        elif op == "inverted_residual":
            s, m, t = layer["stride"], layer["c_out"], layer["expand"]
            ce = c * t
            p = {}
            if t != 1:
                p["exp"] = {"w": (1, 1, c, ce), "b": (ce,)}
            p["dw"] = {"w": (3, 3, 1, ce), "b": (ce,)}
            p["pw"] = {"w": (1, 1, ce, m), "b": (m,)}
            row["params"] = p
            h, w = _same_out(h, s), _same_out(w, s)
            c = m
        elif op in ("maxpool", "avgpool"):
            k, s = layer["k"], layer["stride"]
            h, w = (h - k) // s + 1, (w - k) // s + 1
        elif op == "global_avg_pool":
            h = w = 1
        elif op == "dense":
            row["params"] = {"w": (h * w * c, layer["n_out"])}
            h = w = 1
            c = layer["n_out"]
        else:
            raise ValueError(f"unknown op {op!r} in the layer list")
        row["out"] = (h, w, c)
        out.append(row)
    return out


def _leaves(p) -> list[tuple]:
    if isinstance(p, dict):
        return [s for v in p.values() for s in _leaves(v)]
    return [p]


def param_count(rows: list[dict]) -> int:
    return sum(math.prod(s) for r in rows
               for s in _leaves(r.get("params", {})))


def _conv_flops(n, oh, ow, cg, m, k) -> int:
    return 2 * n * oh * ow * cg * m * k * k


def layer_flops(row: dict, n: int) -> int:
    """Direct-convolution (or dense) FLOPs of one walked layer at batch n."""
    op = row["op"]
    h, w, c = row["inp"]
    oh, ow, m = row["out"]
    if op == "conv":
        return _conv_flops(n, oh, ow, c, m, row["k"])
    if op == "inverted_residual":
        ce = c * row["expand"]
        f = _conv_flops(n, h, w, c, ce, 1) if row["expand"] != 1 else 0
        return (f + _conv_flops(n, oh, ow, 1, ce, 3)
                + _conv_flops(n, oh, ow, ce, m, 1))
    if op == "dense":
        n_in, n_out = row["params"]["w"]
        return 2 * n * n_in * n_out
    return 0


def layer_bytes(row: dict, n: int) -> int:
    """Compulsory fp32 bytes of one walked conv layer or whole
    inverted-residual block at batch n: input, output and parameters once."""
    weights = sum(math.prod(s) for s in _leaves(row.get("params", {})))
    return FP32_BYTES * (n * math.prod(row["inp"]) + n * math.prod(row["out"])
                         + weights)


def forward_flops(rows: list[dict], n: int = 1) -> int:
    """Conv + dense FLOPs of a whole forward at batch n."""
    return sum(layer_flops(r, n) for r in rows)


def least_seconds(row: dict, n: int, peak: dict) -> tuple[float, str]:
    """The least time the card could take for a layer at batch n: the
    larger of its FLOPs over the TF32 rate and its compulsory bytes over
    HBM bandwidth, and which of the two bounds it."""
    t_ops = layer_flops(row, n) / peak["tf32_flops"]
    t_bytes = layer_bytes(row, n) / peak["hbm_bytes"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
