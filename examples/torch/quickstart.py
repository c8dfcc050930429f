"""Quickstart on the PyTorch port: the paper's region-wise multi-channel
Winograd convolution as a drop-in PyTorch op, on the H100's kernels.

  PYTHONPATH=src python examples/torch/quickstart.py               # the card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu  # the CPU

Shows: (1) the unified conv entry point with algorithm selection, (2) the
correctness contract vs direct convolution, (3) the multiplication-reduction
math that motivates the whole paper, (4) the streamed Winograd kernel
(`winograd_streamed` on the card; on the CPU its plain PyTorch version),
(5) the plan/execute split, (6) the graph compiler and its deployment
artifact. `main(argv)` returns the outputs, errors and timings.
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.compile import NetworkPlan
from repro_torch.core.compile import compile as compile_network
from repro_torch.core.dispatch import conv2d
from repro_torch.core.im2col import direct_conv2d
from repro_torch.core.plan import plan_conv2d
from repro_torch.core.transforms import cook_toom
from repro_torch.kernels import ops
from repro_torch.models import cnn


def pick_device(name: str) -> torch.device:
    """--device's device; the card is the default and is never replaced by
    the CPU on its own."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain PyTorch versions on the CPU")
    return dev


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


def make_inputs(res: int, channels: int, net_res: int):
    """The seeded numpy inputs: the (1, res, res, C) activation, the 3x3
    C -> C filter and the network's (1, net_res, net_res, 3) image."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, res, res, channels)).astype(np.float32)
    w = (rng.standard_normal((3, 3, channels, channels)) / 3).astype(
        np.float32)
    image = rng.standard_normal((1, net_res, net_res, 3)).astype(np.float32)
    return x, w, image


def rel(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float((y - ref).abs().max() / ref.abs().max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--res", type=int, default=56)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--net-res", type=int, default=64)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    # fp32 throughout: the direct oracle's cuDNN conv without TF32, as the
    # port's own GEMMs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    x_np, w_np, image_np = make_inputs(args.res, args.channels, args.net_res)
    x = torch.as_tensor(x_np, device=dev)
    w = torch.as_tensor(w_np, device=dev)
    out: dict = {"device": str(dev), "outputs": {}, "rel_err": {}}

    with torch.inference_mode():
        # 1. the algorithm choices, one entry point -------------------------
        y_ref = direct_conv2d(x, w)
        for name in ("winograd", "im2col", "auto", "pallas_winograd"):
            y = conv2d(x, w, algorithm=name)
            out["outputs"][name] = y
            out["rel_err"][name] = err = rel(y, y_ref)
            print(f"{name:15s}: shape={tuple(y.shape)} rel_err={err:.2e}")

        # 2. the multiplication-reduction math --------------------------------
        out["mult_reduction"] = {}
        for m, r in [(2, 3), (4, 3), (2, 5), (2, 7)]:
            ct = cook_toom(m, r)
            out["mult_reduction"][f"F({m}x{m}, {r}x{r})"] = \
                ct.mult_reduction_2d
            print(f"F({m}x{m}, {r}x{r}): {m*m*r*r:4d} MACs -> {ct.t**2:3d} "
                  f"multiplies ({ct.mult_reduction_2d:.2f}x reduction)")

        # 3. per-call wall clock, batch 1 -- the paper's setting -------------
        t = {name: seconds_per_call(
                lambda name=name: conv2d(x, w, algorithm=name), dev)
             for name in ("im2col", "winograd", "pallas_winograd")}
        out["ms"] = {k: v * 1e3 for k, v in t.items()}
        print(f"\n{args.res}x{args.res}x{args.channels}->{args.channels} 3x3 "
              f"conv: im2col {t['im2col']*1e3:.1f}ms, winograd "
              f"{t['winograd']*1e3:.1f}ms, pallas_winograd "
              f"{t['pallas_winograd']*1e3:.1f}ms "
              f"({t['im2col']/t['pallas_winograd']:.2f}x speedup)")

        # 4. the streamed Winograd kernel (transform + GEMM + inverse in one
        # launch; on the CPU its plain version) -------------------------------
        y_kernel = ops.winograd_conv2d(x, w)
        out["outputs"]["kernel"] = y_kernel
        out["rel_err"]["kernel"] = err = rel(y_kernel, y_ref)
        where = "winograd_streamed" if dev.type == "cuda" else "plain version"
        print(f"winograd kernel ({where}): rel_err={err:.2e}")

        # 5. the plan/execute split (paper section 4: transform filters ONCE)
        plan = plan_conv2d(tuple(x.shape), w, algorithm="pallas_winograd",
                           device=dev)
        y_plan = plan.apply(x)
        out["outputs"]["planned"] = y_plan
        out["rel_err"]["planned"] = err = rel(y_plan, y_ref)
        t_planned = seconds_per_call(lambda: plan.apply(x), dev)
        out["ms"]["planned"] = t_planned * 1e3
        print(f"planned ({plan.algorithm}, filter pre-transformed once): "
              f"rel_err={err:.2e} steady-state {t_planned*1e3:.1f}ms "
              f"vs per-call {t['pallas_winograd']*1e3:.1f}ms")

        # 6. the graph compiler + deployment artifact (compile/save/load) -----
        specs = cnn.NETWORKS["mobilenet_v1_050"][0]()
        params = cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                              res=args.net_res, device=dev)
        net = compile_network(params, specs, res=args.net_res,
                              algorithm="pallas_winograd", device=dev)
        image = torch.as_tensor(image_np, device=dev)
        y_cold = net.apply(image)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "mbv1.npz")
            net.save(path)                         # pre-transformed weights +
            warm = NetworkPlan.load(path, device=dev)  # per-layer decisions
            same = bool(torch.equal(warm.apply(image), y_cold))
    n_fused = sum(1 for row in net.describe().splitlines()
                  if "separable" in row)
    out.update(logits=y_cold, layers=len(net.plans), fused=n_fused,
               roundtrip_bitwise=same)
    print(f"compile(): {len(net.plans)} layer plans ({n_fused} fused "
          f"separable blocks), save/load round-trip bitwise identical: "
          f"{same}")
    return out


if __name__ == "__main__":
    main()
