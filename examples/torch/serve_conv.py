"""Fault-tolerant conv serving on the PyTorch port: MobileNet-v2 behind the
batched serving runtime, warm-started from per-bucket NetworkPlan
artifacts, with a live fault drill against the supervisor's degrade
ladder.

First run compiles one plan per batch bucket and saves the artifacts
(cold); re-running with the same --artifacts warm-starts every bucket from
disk with zero filter transforms. The drill then injects a permanent
executor failure into one layer mid-traffic and shows the ladder re-place
it onto the im2row fallback without dropping a single in-flight request.
The server runs the eager supervised path (jit_dispatch=False): a fault
under the CUDA-graph dispatch fires only when a graph is captured.

On the card, "pallas_winograd" serves MobileNet-v2's blocks on the
`separable_streamed`, `depthwise_strided_streamed` and `matmul` kernels.

  PYTHONPATH=src python examples/torch/serve_conv.py                # res 96
  PYTHONPATH=src python examples/torch/serve_conv.py --res 224      # paper res
  PYTHONPATH=src python examples/torch/serve_conv.py --artifacts D  # warm demo
  PYTHONPATH=src python examples/torch/serve_conv.py --device cpu

`main(argv)` returns the answers before and through the fault, the
latencies and the server's counters.
"""

import argparse
import contextlib
import tempfile

import numpy as np
import torch

from repro_torch.models import cnn
from repro_torch.runtime import inject
from repro_torch.runtime.serve import ServeConfig, Server


def pick_device(name: str) -> torch.device:
    """--device's device; the card is the default and is never replaced by
    the CPU on its own."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def make_inputs(net: str, res: int, dev: torch.device):
    """(specs, params, the 8 seeded (res, res, 3) requests the traffic
    cycles through)."""
    specs = cnn.NETWORKS[net][0]()
    params = cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                          res=res, device=dev)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((res, res, 3)).astype(np.float32)
          for _ in range(8)]
    return specs, params, xs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", default="mobilenet_v2",
                    choices=sorted(cnn.NETWORKS))
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--artifacts", default=None,
                    help="artifact dir (default: a temp dir -- pass a real "
                         "path and re-run to see the warm start)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    specs, params, xs = make_inputs(args.net, args.res, dev)

    cfg = ServeConfig(buckets=(1, 2, 4), queue_capacity=32, verbose=True,
                      jit_dispatch=False)
    with (tempfile.TemporaryDirectory(prefix="serve_conv_")
          if args.artifacts is None
          else contextlib.nullcontext(args.artifacts)) as art:
        srv = Server(params, specs, res=args.res,
                     algorithm="pallas_winograd", config=cfg,
                     artifact_dir=art, device=dev)
        s = srv.stats
        print(f"[serve_conv] {args.net}@{args.res}: "
              f"{s.artifact_warm_starts} warm / {s.artifact_cold_starts} "
              f"cold bucket plans from {art}")

        with srv:
            tickets = [srv.submit(xs[i % len(xs)], deadline_s=30.0)
                       for i in range(args.requests)]
            ys = [t.result(timeout=300) for t in tickets]
            lat = sorted(t.latency_s for t in tickets)
            print(f"[serve_conv] clean: {len(ys)} served, "
                  f"p50 {lat[len(lat) // 2] * 1e3:.1f} ms, "
                  f"buckets {srv.stats.bucket_batches}")

            # fault drill: a permanently failing executor in one mid layer.
            victim = sorted(srv.nets[1].plans)[len(srv.nets[1].plans) // 2]
            print(f"[serve_conv] injecting permanent executor failure into "
                  f"layer {victim!r} ...")
            inject.install_on_server(srv, inject.ExecutorRaise(victim))
            tickets = [srv.submit(xs[i % len(xs)])
                       for i in range(args.requests)]
            ys2 = [t.result(timeout=300) for t in tickets]

    s = srv.stats.snapshot()
    print(f"[serve_conv] drill: {len(ys2)} served through the fault -- "
          f"retries={s['retries']}, replacements={s['replacements']}, "
          f"failed={s['failed']}, dropped={s['in_flight']}")
    err = max(float(np.max(np.abs(ys2[i] - ys[i]))
                    / (np.max(np.abs(ys[i])) + 1e-9))
              for i in range(len(ys2)))
    print(f"[serve_conv] parity vs pre-fault outputs: "
          f"max rel err {err:.2e}")
    if s["in_flight"] != 0 or s["failed"] != 0 or not err < 2e-3:
        raise RuntimeError(f"the drill dropped, failed or changed answers: "
                           f"in_flight={s['in_flight']} "
                           f"failed={s['failed']} rel_err={err:.2e}")
    return {"net": args.net, "res": args.res, "device": str(dev),
            "outputs": np.stack(ys), "drill_outputs": np.stack(ys2),
            "p50_ms": lat[len(lat) // 2] * 1e3, "victim": victim,
            "parity_rel_err": err, "stats": s}


if __name__ == "__main__":
    main()
