"""The control of `correct`: read on the card, at a cell's own size, what
the comparison says of the reference computed one precision step below the
configuration's (TF32 for fp32 with TF32 off) in the program's place. Its
smallest reading over the seeds is the upper reading a cell's limit sits
below (limits/<cell>.json); the benchmark's own runs never run it.

    python3 gpubench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed, then one with the smallest reading.
"""

import argparse
import json
import sys
from pathlib import Path


def prepare_process() -> None:
    """As run.py: the checkout's root and src/ on the import path, the
    caches inside the checkout."""
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from gpubench import run
    run.prepare_process()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, nargs="+")
    ap.add_argument("--seeds", type=int, required=True, nargs="+")
    args = ap.parse_args(argv)
    prepare_process()

    import torch

    from gpubench import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for workload in args.workload:
        cell = harness.load_cell(workload)
        errs = []
        for seed in args.seeds:
            errs.append(harness.control_err(cell, seed, device))
            print(json.dumps({"workload": workload, "seed": seed,
                              "control_logit_err": errs[-1]}), flush=True)
            harness.free(device)
        print(json.dumps({"workload": workload, "control_min": min(errs),
                          "limit": cell.limits["logit_err"],
                          "device": torch.cuda.get_device_name(device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
