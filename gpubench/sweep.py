"""Find a served cell's knee: the highest offered image rate the program
sustains with no growing backlog, by one sweep on the card. The knee is
found once and written into the mix's file as a number; the benchmark's
runs never search for a rate.

    python3 gpubench/sweep.py --workload <served cell> --seed <n> \
        --seconds <s> --rates <images/s> [...]

One process: set-up once, then a window per rate on the mix's traffic
shape. Prints one JSON line per rate: p50 / p95 latency, the p50 of the
first and last quarter of the requests (a backlog that grows shows as a
last quarter far above the first), refused requests, and the batches.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def prepare_process() -> None:
    """As run.py: the checkout's root and src/ on the import path, the
    caches inside the checkout."""
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from gpubench import run
    run.prepare_process()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, required=True, nargs="+")
    args = ap.parse_args(argv)
    prepare_process()

    import torch

    from gpubench import harness, traffic
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    _, params, pool, res = harness.draw(cell, args.seed, device)
    images = pool.cpu().numpy()
    server = harness.start_server(cell, params, res, device)
    try:
        for b in cell.config["serve_buckets"]:
            for tk in [server.submit(images[i]) for i in range(b)]:
                tk.result(timeout=60)
        for rate in args.rates:
            gcw = harness.GcWatch()
            sched = traffic.served_schedule(cell.mix, args.seed, args.seconds,
                                            image_rate_per_s=rate)
            s0 = server.stats.snapshot()
            w = harness.serve_window(server, images, sched,
                                     time.perf_counter() + 0.01)
            s1 = server.stats.snapshot()
            gcp = gcw.stop()
            lat = w["latency_s"]
            q = len(lat) // 4
            print(json.dumps({
                "rate": rate, "requests": len(lat),
                "p50_ms": 1e3 * traffic.percentile(lat, 50),
                "p95_ms": 1e3 * traffic.percentile(lat, 95),
                "first_quarter_p50_ms": 1e3 * float(np.median(lat[:q])),
                "last_quarter_p50_ms": 1e3 * float(np.median(lat[-q:])),
                "refused": w["refused"], "unanswered": w["unanswered"],
                "client_late_max_ms": 1e3 * float(w["client_late_s"].max()),
                "gc_collections": len(gcp),
                "gc_longest_ms": 1e3 * max(gcp, default=0.0),
                "batches": s1["batches"] - s0["batches"],
                "bucket_batches": {k: v - s0["bucket_batches"].get(k, 0)
                                   for k, v in
                                   s1["bucket_batches"].items()}}),
                  flush=True)
    finally:
        server.stop()
    print(json.dumps({"workload": args.workload,
                      "device": torch.cuda.get_device_name(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
