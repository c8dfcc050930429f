"""Batched TRANSFORMER-decode serving on the PyTorch port: continuous
batching over a smoke-size autoregressive model with mixed-length requests
(repro_torch.launch.serve -- slot-based decode ticks, not the conv
runtime).

For the conv side of the repo -- batched inference over compiled
NetworkPlan artifacts with bounded admission, deadlines, and the
fault-tolerant degrade ladder (repro_torch.runtime.serve) -- see
examples/torch/serve_conv.py.

  PYTHONPATH=src python examples/torch/serve_batched.py [--arch qwen2_5_3b]
  PYTHONPATH=src python examples/torch/serve_batched.py --device cpu

The server runs under a ("data", "model") mesh of the cards present
(launch.mesh.make_host_mesh; with --device, of that one device), on its
first position. `main(argv)` returns each request's greedy tokens, the
decode ticks and the rate.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.distributed import context as dist
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import Request, Server
from repro_torch.models import transformer as tf


def pick_device(name: str) -> torch.device:
    """--device's device; the card is the default and is never replaced by
    the CPU on its own."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def make_inputs(cfg, n_requests: int, max_new: int, dev: torch.device):
    """fp32 params from a seeded generator (drawn on the CPU, placed on
    `dev`) and the seeded requests: prompts of 3-6 tokens."""
    params = tf.init_params(torch.Generator().manual_seed(0), cfg,
                            torch.float32, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        size=(3 + i % 4,)).astype(np.int32),
                    max_new=max_new)
            for i in range(n_requests)]
    return params, reqs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-batch", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = cfglib.get_smoke_config(args.arch)
    mesh = make_host_mesh(devices=None if args.device == "cuda" else [dev])
    with dist.use_mesh(mesh):
        params, reqs = make_inputs(cfg, args.requests, args.max_new,
                                   mesh.devices[0])
        srv = Server(cfg, params, max_batch=args.max_batch, max_len=64,
                     mesh=mesh)
        t0 = time.time()
        done, ticks = srv.run(reqs)
        dt = time.time() - t0

    tok = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)} requests -> {tok} tokens in {dt:.2f}s "
          f"({tok/dt:.1f} tok/s, {ticks} decode ticks, "
          f"max_batch={args.max_batch})")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req {r.rid}: prompt={r.prompt.tolist()} -> {r.out}")
    if len(done) != args.requests or \
            not all(len(r.out) == args.max_new for r in done):
        raise RuntimeError(f"{len(done)} of {args.requests} requests done, "
                           f"lengths {[len(r.out) for r in done]}")
    return {"arch": args.arch, "device": str(mesh.devices[0]),
            "tokens": {r.rid: list(r.out) for r in done}, "ticks": ticks,
            "seconds": dt, "tok_per_s": tok / dt}


if __name__ == "__main__":
    main()
