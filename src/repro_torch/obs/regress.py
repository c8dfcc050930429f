"""Tracked-metric extraction + regression compare over BENCH_*.json: the
JAX package's obs/regress.py with its CLI (benchmarks/regress.py) as
`main`, for the port.

Every benchmark of the JAX package emits a JSON artifact (BENCH_PR2..PR10)
and the port's smoke test writes a `repro.observe/v1` document; this
module gives them one regression contract: `extract(doc)` maps any known
artifact format to a flat {metric_name: Metric} dict, and
`compare(base, current)` evaluates each shared metric against a threshold
in the metric's own improvement direction.

    python -m repro_torch.obs.regress BASE.json CURRENT.json
    python -m repro_torch.obs.regress --trajectory CI_DIR [--root DIR]

Pair mode exits 1 when a gated metric regressed past the threshold.
Trajectory mode pairs every committed BENCH_PR<n>.json under --root (the
repository root by default) with BENCH_PR<n>_ci*.json (or
BENCH_PR<n>.json) under CI_DIR: pairs in the observe format gate hard
(their metrics are machine-relative), the absolute-latency formats only
warn unless --strict. Exit codes: 0 passed (or --warn-only), 1 a gated
regression, 2 no pair found.

Metric semantics (`kind`):

- "ratio":      regression when worse by more than `threshold` x
                (cur/base for lower-is-better, base/cur for higher).
- "pct_points": additive compare for percentage metrics (the PR10
                observability overhead): regression when worse by more
                than `pct_margin` points. Ratio compares break down when
                the base is ~0%, which a healthy overhead gauge is.
- "count":      zero-tolerance counters (dropped requests, incorrect
                responses): ANY worsening is a regression.
- "bool":       pass/fail gates: True -> False is a regression.

Direction `None` marks informational metrics -- reported, never gated
(e.g. absolute ms in the PR10 artifact, which CI compares across
unrelated machines; its machine-relative overhead metrics carry the
gate instead).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
from pathlib import Path
from typing import Any

__all__ = ["Metric", "Finding", "detect", "extract", "compare",
           "summarize", "load", "main"]

#: The repository root that holds the committed BENCH_PR<n>.json files.
ROOT = Path(__file__).resolve().parents[3]


@dataclasses.dataclass(frozen=True)
class Metric:
    value: float
    direction: str | None = "lower"   # "lower" | "higher" | None (info)
    kind: str = "ratio"               # "ratio" | "pct_points" | "count"
                                      # | "bool"
    gate: bool = True                 # participates in pass/fail


@dataclasses.dataclass(frozen=True)
class Finding:
    metric: str
    base: float
    current: float
    direction: str | None
    kind: str
    gate: bool
    ratio: float | None               # worsening factor (ratio kind)
    regressed: bool


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Format detection + per-format extractors
# ---------------------------------------------------------------------------

def detect(doc: dict) -> str:
    if doc.get("format") == "repro.observe/v1":
        return "observe"
    if "clean" in doc and "faults" in doc:
        return "serving"
    if "curve" in doc and "speedup_vs_1dev" in doc:
        return "scaling"
    if "rows" in doc and "res" in doc:
        return "startup"
    if "layers" in doc and "summary" in doc:
        return "per_layer"
    return "unknown"


def _num(x: Any) -> float | None:
    return float(x) if isinstance(x, (int, float)) \
        and not isinstance(x, bool) else None


def _extract_serving(doc: dict) -> dict[str, Metric]:
    out: dict[str, Metric] = {}
    for row in doc.get("clean", []):
        p = f"serving.rate{row.get('rate_rps', '?'):g}"
        for k, direction in (("p50_ms", "lower"), ("p99_ms", "lower"),
                             ("mean_ms", "lower"),
                             ("throughput_rps", "higher")):
            v = _num(row.get(k))
            if v is not None:
                out[f"{p}.{k}"] = Metric(v, direction)
        for k in ("dropped", "incorrect"):
            v = _num(row.get(k))
            if v is not None:
                out[f"{p}.{k}"] = Metric(v, "lower", kind="count")
    for k in ("zero_dropped", "zero_incorrect", "fault_survived"):
        if isinstance(doc.get(k), bool):
            out[f"serving.{k}"] = Metric(float(doc[k]), "higher",
                                         kind="bool")
    return out


def _extract_scaling(doc: dict) -> dict[str, Metric]:
    out: dict[str, Metric] = {}
    sp = doc.get("speedup_vs_1dev") or []
    if sp:
        out["scaling.speedup_max_dev"] = Metric(float(sp[-1]), "higher")
    for pt in doc.get("curve", []):
        dev = pt.get("devices", "?")
        for mode in ("batch_sharded", "halo_sharded"):
            v = _num((pt.get(mode) or {}).get("throughput_img_s"))
            if v is not None:
                out[f"scaling.{mode}.throughput_img_s@{dev}dev"] = \
                    Metric(v, "higher")
    for k, v in (doc.get("gates") or {}).items():
        if isinstance(v, bool):
            out[f"scaling.gate.{k}"] = Metric(float(v), "higher",
                                              kind="bool")
    return out


def _extract_startup(doc: dict) -> dict[str, Metric]:
    out: dict[str, Metric] = {}
    for row in doc.get("rows", []):
        p = f"startup.{row.get('network', '?')}"
        for k, direction in (("cold_compile_s", "lower"),
                             ("warm_load_s", "lower"),
                             ("artifact_bytes", "lower"),
                             ("startup_speedup", "higher")):
            v = _num(row.get(k))
            if v is not None:
                out[f"{p}.{k}"] = Metric(v, direction)
        if isinstance(row.get("fresh_process_parity"), bool):
            out[f"{p}.fresh_process_parity"] = Metric(
                float(row["fresh_process_parity"]), "higher", kind="bool")
    return out


def _summary_direction(name: str) -> str | None:
    n = name.lower()
    if "speedup" in n or "agreement" in n or "ratio" in n or "wins" in n:
        return "higher"
    if n.endswith(("_ms", "_s", "_bytes")) or "err" in n or "time" in n:
        return "lower"
    return None


def _extract_per_layer(doc: dict) -> dict[str, Metric]:
    out: dict[str, Metric] = {}
    summary = doc.get("summary")
    rows = summary if isinstance(summary, list) else [summary]
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            continue
        tag = str(row.get("net", row.get("ltype", i)))
        if isinstance(summary, list) and "ltype" in row and "net" in row:
            tag = f"{row['net']}.{row['ltype']}"
        for k, v in row.items():
            if isinstance(v, dict):      # PR8-style nested {dtype: value}
                for dk, dv in v.items():
                    dv = _num(dv)
                    d = _summary_direction(k)
                    if dv is not None and d is not None:
                        out[f"summary.{tag}.{k}.{dk}"] = Metric(dv, d)
                continue
            v = _num(v)
            d = _summary_direction(k)
            if v is not None and d is not None:
                out[f"summary.{tag}.{k}"] = Metric(v, d)
    return out


def _extract_observe(doc: dict) -> dict[str, Metric]:
    out: dict[str, Metric] = {}
    # Machine-relative gates: both arms measured in the same run on the
    # same machine, so these compare across hosts (CI vs the committed
    # baseline) without tracking absolute hardware speed.
    v = _num(doc.get("overhead_pct"))
    if v is not None:
        out["observe.overhead_pct"] = Metric(v, "lower",
                                             kind="pct_points")
    v = _num((doc.get("decomposition") or {}).get("max_residual_pct"))
    if v is not None:
        out["observe.decomposition_max_residual_pct"] = \
            Metric(v, "lower", kind="pct_points")
    for k, val in (doc.get("gates") or {}).items():
        if isinstance(val, bool):
            out[f"observe.gate.{k}"] = Metric(float(val), "higher",
                                              kind="bool")
    # Absolute latencies: informational (cross-machine compare).
    for k in ("p50_disabled_ms", "p50_enabled_ms"):
        v = _num(doc.get(k))
        if v is not None:
            out[f"observe.{k}"] = Metric(v, None, gate=False)
    v = _num(doc.get("trace_events"))
    if v is not None:
        out["observe.trace_events"] = Metric(v, None, gate=False)
    return out


_EXTRACTORS = {"serving": _extract_serving, "scaling": _extract_scaling,
               "startup": _extract_startup, "per_layer": _extract_per_layer,
               "observe": _extract_observe}


def extract(doc: dict) -> dict[str, Metric]:
    """Tracked metrics of one BENCH artifact ({} for unknown formats)."""
    fn = _EXTRACTORS.get(detect(doc))
    return fn(doc) if fn else {}


# ---------------------------------------------------------------------------
# Compare
# ---------------------------------------------------------------------------

def compare(base: dict, current: dict, *, threshold: float = 1.5,
            pct_margin: float = 5.0) -> list[Finding]:
    """Findings over every metric present in BOTH artifacts, worst first.
    `threshold` is the multiplicative worsening that fails ratio metrics
    (2.0 = twice as slow / half the throughput); `pct_margin` the additive
    worsening (percentage points) that fails pct_points metrics."""
    bm, cm = extract(base), extract(current)
    findings: list[Finding] = []
    for name in sorted(set(bm) & set(cm)):
        b, c = bm[name], cm[name]
        ratio = None
        regressed = False
        if b.direction is not None and b.gate:
            if b.kind == "ratio":
                if b.direction == "lower" and b.value > 0 and c.value > 0:
                    ratio = c.value / b.value
                elif b.direction == "higher" and c.value > 0 \
                        and b.value > 0:
                    ratio = b.value / c.value
                regressed = ratio is not None and ratio > threshold
            elif b.kind == "pct_points":
                delta = (c.value - b.value if b.direction == "lower"
                         else b.value - c.value)
                regressed = delta > pct_margin
            elif b.kind == "count":
                regressed = (c.value > b.value if b.direction == "lower"
                             else c.value < b.value)
            elif b.kind == "bool":
                regressed = bool(b.value) and not bool(c.value)
        findings.append(Finding(name, b.value, c.value, b.direction,
                                b.kind, b.gate, ratio, regressed))
    findings.sort(key=lambda f: (not f.regressed,
                                 -(f.ratio or 0.0), f.metric))
    return findings


def summarize(findings: list[Finding]) -> list[str]:
    lines = []
    for f in findings:
        mark = "REGRESSED" if f.regressed else "ok"
        extra = f" ({f.ratio:.2f}x worse)" if f.regressed and f.ratio \
            else ""
        lines.append(f"  [{mark:>9}] {f.metric}: {f.base:g} -> "
                     f"{f.current:g}{extra}")
    return lines


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _compare_pair(base_path: str, cur_path: str, *, threshold: float,
                  pct_margin: float, hard: bool) -> tuple[int, int]:
    """Print one pair's findings; return (n_gated, n_regressed)."""
    base, cur = load(base_path), load(cur_path)
    fmt = detect(base)
    findings = compare(base, cur, threshold=threshold,
                       pct_margin=pct_margin)
    regressed = [f for f in findings if f.regressed]
    mode = "gate" if hard else "warn-only"
    print(f"\n== {os.path.basename(base_path)} -> "
          f"{os.path.basename(cur_path)}  [format={fmt}, {mode}] ==")
    if not findings:
        print("  (no shared tracked metrics)")
        return 0, 0
    for line in summarize(findings):
        print(line)
    print(f"  {len(findings)} metric(s) compared, "
          f"{len(regressed)} regressed")
    return len(findings), len(regressed)


_CI_TAG = re.compile(r"^BENCH_PR(\d+)(?:_ci.*)?\.json$")


def _trajectory_pairs(root: str, ci_dir: str) -> list[tuple[str, str]]:
    """(committed, fresh) pairs: BENCH_PR<n>.json in `root` matched with
    BENCH_PR<n>_ci*.json (or BENCH_PR<n>.json) under `ci_dir`."""
    pairs = []
    for committed in sorted(glob.glob(os.path.join(root,
                                                   "BENCH_PR[0-9]*.json"))):
        m = _CI_TAG.match(os.path.basename(committed))
        if not m:
            continue
        n = m.group(1)
        fresh = (sorted(glob.glob(os.path.join(
                    ci_dir, f"BENCH_PR{n}_ci*.json")))
                 or sorted(glob.glob(os.path.join(
                    ci_dir, f"BENCH_PR{n}.json"))))
        if fresh:
            pairs.append((committed, fresh[0]))
    return pairs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="Regression gate over BENCH_*.json artifacts.")
    ap.add_argument("base", nargs="?", help="baseline BENCH_*.json")
    ap.add_argument("current", nargs="?", help="candidate BENCH_*.json")
    ap.add_argument("--trajectory", metavar="CI_DIR", default=None,
                    help="compare every committed BENCH_PR<n>.json in the "
                         "repo root against BENCH_PR<n>_ci*.json under "
                         "CI_DIR")
    ap.add_argument("--root", default=None,
                    help="override the repo root that holds the committed "
                         "trajectory (default: this repository's root)")
    ap.add_argument("--threshold", type=float, default=1.5,
                    help="ratio-metric failure factor (default 1.5x)")
    ap.add_argument("--pct-margin", type=float, default=5.0,
                    help="percentage-point metric failure margin "
                         "(default 5.0)")
    ap.add_argument("--warn-only", action="store_true",
                    help="report but always exit 0")
    ap.add_argument("--strict", action="store_true",
                    help="trajectory mode: gate pre-existing absolute-"
                         "latency formats too, not just the machine-"
                         "relative observe format")
    args = ap.parse_args(argv)

    failures = 0
    if args.trajectory is not None:
        root = args.root or str(ROOT)
        pairs = _trajectory_pairs(root, args.trajectory)
        if not pairs:
            print(f"error: no (committed, fresh) BENCH_PR<n> pairs between "
                  f"{root} and {args.trajectory}")
            return 2
        for committed, fresh in pairs:
            hard = args.strict or \
                detect(load(committed)) == "observe"
            _, regressed = _compare_pair(
                committed, fresh, threshold=args.threshold,
                pct_margin=args.pct_margin, hard=hard)
            if regressed and hard:
                failures += regressed
            elif regressed:
                print(f"  (warn-only: {regressed} regression(s) not gated "
                      f"-- absolute metrics across machines)")
    else:
        if not args.base or not args.current:
            ap.error("need BASE and CURRENT (or --trajectory CI_DIR)")
        _, failures = _compare_pair(
            args.base, args.current, threshold=args.threshold,
            pct_margin=args.pct_margin, hard=True)

    if failures and not args.warn_only:
        print(f"\nREGRESSION GATE FAILED: {failures} gated metric(s) "
              f"regressed")
        return 1
    if failures:
        print(f"\nwarn-only: {failures} regression(s) reported, exit 0")
    else:
        print("\nregression gate passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
