"""Per-op HBM / collective profile of one dry-run cell (the perf loop's
'profiler': reads the dry run's rows, no card), the counterpart of the JAX
package's launch/profile_cell.py, which reads the compiled HLO.

  PYTHONPATH=src python -m repro_torch.launch.profile_cell \
      --arch falcon_mamba_7b --shape train_4k [--multi] [--top 25]
"""

from __future__ import annotations

import argparse

from repro_torch.launch import dryrun, opcost


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (a quick check)")
    args = ap.parse_args(argv)

    rec = dryrun.run_cell(args.arch, args.shape, multi_pod=args.multi,
                          verbose=True, return_rows=True, smoke=args.smoke)
    if rec["status"] != "ok":
        print(f"{args.arch} {args.shape}: {rec['status']} "
              f"({rec.get('reason', '')})")
        return 0
    rows = rec.pop("_rows")
    total = opcost.CostTotals.of(rows)
    moved = total.bytes + total.coll_bytes
    print(f"\n== top {args.top} ops by HBM + collective bytes ==")
    print(f"total bytes/dev: {total.bytes:.3e}  flops/dev: "
          f"{total.flops:.3e}  coll/dev (traced): {total.coll_bytes:.3e}")
    for b, op, txt in opcost.profile_bytes(rows, args.top):
        print(f"{b:12.3e}  {100 * b / max(moved, 1):5.1f}%  {op:22s} "
              f"{txt[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
