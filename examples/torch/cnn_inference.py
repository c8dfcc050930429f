"""Paper scenario on the PyTorch port: SqueezeNet inference on the CNN zoo,
flipping between the paper's benchmark configurations.

  PYTHONPATH=src python examples/torch/cnn_inference.py [--network squeezenet]
  PYTHONPATH=src python examples/torch/cnn_inference.py --device cpu --res 32

Reproduces the Table 1 measurement protocol for one network at full width
and its own resolution: batch-1 latency of the compiled NetworkPlan with
(a) im2row everywhere, (b) the paper's mixed policy ("auto": Winograd on
suitable layers, im2row on the rest, plain PyTorch executors) and (c) the
same policy on the H100's kernels ("pallas_winograd": `winograd_streamed`
and, on the 7x7 stride-2 stem, `winograd_strided_streamed`).
`main(argv)` returns the layer census, the logits and the timings.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.compile import compile as compile_network
from repro_torch.models import cnn

ALGORITHMS = ("im2col", "auto", "pallas_winograd")


def pick_device(name: str) -> torch.device:
    """--device's device; the card is the default and is never replaced by
    the CPU on its own."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def make_inputs(network: str, res: int, dev: torch.device):
    """(specs, params, x): the network's weights from a seeded generator and
    a seeded (1, res, res, 3) image."""
    specs = cnn.NETWORKS[network][0]()
    params = cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                          res=res, device=dev)
    x = np.random.default_rng(0).standard_normal((1, res, res, 3))
    return specs, params, torch.as_tensor(x.astype(np.float32), device=dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", default="squeezenet",
                    choices=sorted(cnn.NETWORKS))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--res", type=int, default=None,
                    help="input resolution (default: the network's own)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = args.res or cnn.NETWORKS[args.network][1]
    specs, params, x = make_inputs(args.network, res, dev)

    with torch.inference_mode():
        # layer census: which layers does the paper's scheme accelerate?
        layers: dict = {}
        cnn.cnn_forward(params, x, specs, algorithm="im2col",
                        layer_times=layers)
        fast = [k for k, v in layers.items() if v["suitable"]]
        print(f"{args.network}: {len(layers)} conv layers, "
              f"{len(fast)} Winograd-suitable")

        logits, ms = {}, {}
        for algo in ALGORITHMS:
            net = compile_network(params, specs, res=res, algorithm=algo,
                                  device=dev)
            logits[algo] = net.apply(x)                 # warm-up + check
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                net.apply(x)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = (time.perf_counter() - t0) / args.iters
            ms[algo] = dt * 1e3
            print(f"algorithm={algo:15s}: {dt*1e3:8.1f} ms/inference "
                  f"({1/dt:.1f} fps)")

    base = logits["im2col"]
    errs = {algo: float((logits[algo] - base).abs().max()
                        / (base.abs().max() + 1e-9))
            for algo in ALGORITHMS[1:]}
    for algo, err in errs.items():
        print(f"prediction agreement {algo} vs im2col: rel_err={err:.2e}")
    if max(errs.values()) >= 1e-3:
        raise RuntimeError(f"the schemes disagree: {errs}")
    return {"network": args.network, "res": res, "device": str(dev),
            "conv_layers": len(layers), "suitable": len(fast),
            "logits": logits, "ms": ms, "rel_err": errs}


if __name__ == "__main__":
    main()
