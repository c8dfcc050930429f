"""The paper's technique inside an assigned architecture, on the PyTorch
port: falcon-mamba's depthwise causal conv1d routed through the 1D
Cook-Toom algorithm.

  PYTHONPATH=src python examples/torch/mamba_cook_toom.py
  PYTHONPATH=src python examples/torch/mamba_cook_toom.py --device cpu \\
      --batch 2 --length 64 --channels 32

Shows the multiply-count reduction, the conv three ways (the planned
Cook-Toom executor the model uses, the `conv1d_ct_fused` kernel, the
direct sum), the per-layer A/B the dispatcher enables (the conv_algorithm
switch in SSMConfig), and end-to-end equivalence of the two paths through
a Mamba block, whose selective scan runs the `selective_scan` kernel on
the card. `main(argv)` returns the outputs, errors and timings.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import configs as cfglib
from repro_torch.core.transforms import cook_toom
from repro_torch.core.winograd import ct_depthwise_causal_conv1d
from repro_torch.kernels import ops
from repro_torch.models import mamba as ssm


def pick_device(name: str) -> torch.device:
    """--device's device; the card is the default and is never replaced by
    the CPU on its own."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def make_inputs(cfg, b: int, length: int, c: int, dev: torch.device):
    """The conv's seeded (B, L, C) input and (r, C) taps, the block's
    weights from a seeded generator and its seeded (2, 64, d_model)
    input."""
    rng = np.random.default_rng(0)
    r = cfg.ssm.d_conv
    x = rng.standard_normal((b, length, c)).astype(np.float32)
    w = (rng.standard_normal((r, c)) / r).astype(np.float32)
    p = ssm.init_mamba(torch.Generator().manual_seed(0), cfg, torch.float32,
                       dev)
    xin = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    return (torch.as_tensor(x, device=dev), torch.as_tensor(w, device=dev),
            p, torch.as_tensor(xin, device=dev))


def seconds_per_call(fn, dev: torch.device, iters: int = 5) -> float:
    """Host seconds of one fn() call after a warm-up, the device's work
    included (a synchronize ends the timed loop)."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / iters


def rel(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float((y - ref).abs().max() / ref.abs().max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--length", type=int, default=2048)
    ap.add_argument("--channels", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfglib.get_smoke_config("falcon_mamba_7b")

    # --- the conv itself ----------------------------------------------------
    r = cfg.ssm.d_conv
    ct = cook_toom(4, r)
    print(f"mamba short conv: depthwise causal k={r}")
    print(f"F({ct.m},{ct.r}): {ct.m * ct.r} multiplies -> {ct.t} per channel "
          f"per tile ({ct.mult_reduction_1d:.2f}x reduction)")

    b, length, c = args.batch, args.length, args.channels
    x, w, p, xin = make_inputs(cfg, b, length, c, dev)
    xp = F.pad(x, (0, 0, r - 1, 0))
    paths = {
        "cook_toom": lambda: ct_depthwise_causal_conv1d(x, w),
        "kernel": lambda: ops.ct_depthwise_causal_conv1d(x, w),
        "direct": lambda: sum(xp[:, k:k + length] * w[k][None, None]
                              for k in range(r)),
    }
    with torch.inference_mode():
        conv = {name: fn() for name, fn in paths.items()}
        errs = {name: rel(conv[name], conv["direct"])
                for name in ("cook_toom", "kernel")}
        print(f"cook-toom vs direct ({b}x{length}x{c}): "
              f"rel_err={errs['cook_toom']:.2e}; conv1d kernel vs direct: "
              f"rel_err={errs['kernel']:.2e}")
        t = {name: seconds_per_call(fn, dev)
             for name, fn in paths.items()}
    print(f"direct {t['direct']*1e3:.1f}ms vs cook-toom "
          f"{t['cook_toom']*1e3:.1f}ms ({t['direct']/t['cook_toom']:.2f}x), "
          f"conv1d kernel {t['kernel']*1e3:.1f}ms "
          f"({t['direct']/t['kernel']:.2f}x)")

    # --- through the full Mamba block ----------------------------------------
    cfg_direct = dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, conv_algorithm="direct"))
    with torch.inference_mode():
        y1 = ssm.mamba_block(p, xin, cfg)        # cook_toom (config default)
        y2 = ssm.mamba_block(p, xin, cfg_direct)
    err = rel(y1, y2)
    print(f"full mamba block, cook_toom vs direct: rel_err={err:.2e}")
    if not err < 1e-4:
        raise RuntimeError(f"the block's two conv paths disagree: {err:.2e}")
    return {"device": str(dev), "conv": conv, "rel_err": errs,
            "ms": {k: v * 1e3 for k, v in t.items()}, "block": y1,
            "block_direct": y2, "block_rel_err": err}


if __name__ == "__main__":
    main()
