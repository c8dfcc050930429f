"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

With --trace 0 the result carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (a traced run; see harness.py). The last
line of standard output is one JSON object: correct, attempted, failed,
metrics, device, (traced) breakdown, and last the numbers `correct`
compared, each beside its limit; they are also the last lines of standard
error. Exits non-zero, printing no result, without a CUDA card (or fewer
than the cell asks for), or when JAX or the JAX package is loaded once the
window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def prepare_process() -> None:
    """The checkout's root and src/ on the import path, and the kernel and
    extension caches at fixed paths inside the checkout, so that only a
    checkout's first run builds (the port's own CUDA libraries go to
    build/kernels/ beside them). Runs before torch is imported."""
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ.setdefault("USE_FLAX", "0")


#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e!r})"


def _number(v: float):
    """JSON has no infinity: an infinitely late percentile prints as a
    string, which the check cannot mistake for a fast one."""
    return v if math.isfinite(v) else str(v)


def result(rec: dict, dev: dict, trace: bool) -> dict:
    """The result line: correct, attempted, failed, metrics, device,
    breakdown (traced runs), and last the numbers compared with their
    limits."""
    out = {"correct": rec["correct"], "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]),
           "metrics": {k: {"value": _number(m["value"]), "unit": m["unit"]}
                       for k, m in rec["metrics"].items()},
           "device": dict(dev)}
    if trace:
        out["device"]["busy_s"] = rec.get("busy_s")
        out["device"]["window_s"] = rec["window_s"]
        if "breakdown" in rec:
            out["breakdown"] = rec["breakdown"]
    out["checks"] = {k: {"value": _number(c["value"]), "limit": c["limit"]}
                     for k, c in rec["checks"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_process()
    marks = [("process start", T_PROCESS),
             ("python imports", time.perf_counter())]

    import torch
    marks.append(("import torch", time.perf_counter()))

    from gpubench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    marks.append(("gpubench imports, CUDA context", time.perf_counter()))
    rec = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device, marks)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures repro_torch "
              f"alone", file=sys.stderr)
        return 3

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": rec["memory_peak_bytes"]}
    late = rec.get("client_late_s")
    if late is not None and len(late):
        print(f"client lateness: median "
              f"{1e3 * float(np.median(late)):.4f} ms, max "
              f"{1e3 * float(np.max(late)):.4f} ms over {len(late)} "
              f"requests", file=sys.stderr)
    print("set-up phases (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in rec["setup_phases"].items()),
        file=sys.stderr)
    gcp = rec["gc_pauses_s"]
    print(f"gc in the window: {len(gcp)} collections, longest "
          f"{1e3 * max(gcp, default=0.0):.4f} ms", file=sys.stderr)
    print(f"card: {power_limit()}", file=sys.stderr)
    out = result(rec, dev, bool(args.trace))
    for k, c in rec["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
