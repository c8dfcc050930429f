"""Resumable runner of the full dry-run sweep, the counterpart of the JAX
package's launch/sweep.py.

Reads every results/*.jsonl, finds the (arch x shape x mesh) cells that are
missing or errored, and runs only those (launch/dryrun.run_cell),
appending to --out. Safe to rerun after a crash.

  PYTHONPATH=src python -m repro_torch.launch.sweep [--arch ARCH]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import traceback

from repro_torch import configs as cfglib
from repro_torch.launch import dryrun


def done_cells(results_dir: str) -> set:
    """(arch, shape, mesh) of every ok or skip record in
    results_dir/*.jsonl."""
    done = set()
    for f in glob.glob(os.path.join(results_dir, "*.jsonl")):
        with open(f) as fh:
            for line in fh:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("ok", "skip"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--out", default="results/dryrun_main.jsonl")
    ap.add_argument("--arch", default=None, help="restrict to one arch")
    args = ap.parse_args(argv)

    done = done_cells(args.results_dir)
    archs = [cfglib.canonical(args.arch)] if args.arch \
        else list(cfglib.ARCH_IDS)
    todo = [(a, s, m)
            for a in archs
            for s in cfglib.SHAPES
            for m in ("single", "multi")
            if (a, s, m) not in done]
    print(f"sweep: {len(done)} cells done, {len(todo)} to run", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    n_err = 0
    for i, (arch, shape, mesh) in enumerate(todo):
        print(f"--- [{i + 1}/{len(todo)}] {arch} {shape} {mesh}", flush=True)
        try:
            rec = dryrun.run_cell(arch, shape, multi_pod=(mesh == "multi"))
        except Exception as e:  # a failed cell is a bug: surface it
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "status": "error", "error": repr(e),
                   "trace": traceback.format_exc()[-2000:]}
            print(f"FAILED {arch} {shape} {mesh}: {e!r}", flush=True)
            n_err += 1
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    print(f"sweep finished: {n_err} errors of {len(todo)}", flush=True)
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
