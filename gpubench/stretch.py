"""The program's own spans on the card, outside the benchmark's runs: an
offline stretch of back-to-back NetworkPlan.apply calls with the
program's profiler on, which gpubench/harness.py:run_offline does not yet
make (PERF.md, Open questions); the PR that adds the stretch there deletes
this file.

    python3 gpubench/stretch.py --seed <n> [--seconds 5] \
        [--cells <offline cell> ...] [--out build/stretch.json]

For each offline cell: the cell's weights and pool from the seed,
`compile`, then stretches of about `--seconds` (at least 100 calls) with
the profiler off, on, on, off (images/s of each), and one more with the
profiler on under a device trace (gpubench/devtrace.py):

  * the walk's `gpu:layer:<node>` spans summed over the stretch against
    the trace's busy time over the same calls;
  * each node's device ms a call from those spans, and the cell's roofline
    readers (its BENCHMARK.json per-layer metrics named `*_roofline`)
    over them beside the same run's hooked reading (harness._trace_layers);
  * an inverted residual's `/expand`, `/separable` and `/residual` device
    ms a call, and the device operations whose midpoint falls in each,
    with the `gpu:` spans moved onto the device trace's clock by clock
    probes (a kernel alone in a device span, its end in both clocks).

One JSON object goes to `--out` and to standard output's last line. Runs
on a CUDA card only.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from gpubench import counting, devtrace, harness  # noqa: E402

STEPS = ("expand", "separable", "residual")


def _offline_cells() -> list[str]:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]
            if harness.load_cell(w["name"], bench).mix["kind"] == "offline"]


def _stretch(net, pool, calls: int) -> tuple[float, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i in range(calls):
            net.apply(pool[i % pool.shape[0]])
    torch.cuda.synchronize()
    return t0, time.perf_counter()


def _issue_ms(net, x, calls: int = 7) -> float:
    """Median host ms to issue one forward on an idle card."""
    out = []
    with torch.inference_mode():
        for _ in range(calls):
            torch.cuda.synchronize()
            t = time.perf_counter()
            net.apply(x)
            out.append(1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    return sorted(out)[calls // 2]


def _profiled(fn):
    """fn() with the program's profiler on; (fn's result, its spans)."""
    from repro_torch.obs import profile
    prof = profile.enable(capacity=1 << 22)
    try:
        out = fn()
        spans = prof.tracer.spans()
    finally:
        profile.disable()
    return out, spans


def _clock_probes(n: int = 5) -> None:
    """`n` short kernels, each alone on an idle card inside a device span
    of the program's tracer (gpu:clock_probe): the span's end against the
    kernel's end in the device trace measures how far the tracer's clock
    tie sits from the trace's."""
    from repro_torch.obs import profile
    tracer = profile.active().tracer
    x = torch.zeros(1 << 20, device="cuda")
    for _ in range(n):
        torch.cuda.synchronize()
        with tracer.device_span("clock_probe"):
            x.neg_()
    torch.cuda.synchronize()


def _by_midpoint(events, intervals) -> dict[str, list]:
    """The events whose midpoint lies in an interval (key, start, end);
    the intervals do not overlap."""
    intervals = sorted(intervals, key=lambda iv: iv[1])
    starts = [iv[1] for iv in intervals]
    out: dict[str, list] = {}
    for ev in events:
        mid = (ev[1] + ev[2]) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= intervals[i][2]:
            out.setdefault(intervals[i][0], []).append(ev)
    return out


def offline(name: str, seed: int, seconds: float, device) -> dict:
    from repro_torch.core.compile import compile as port_compile
    cell = harness.load_cell(name)
    cfg, B = cell.config, cell.mix["batch"]
    rows, params, pool, res = harness.draw(cell, seed, device)
    net = port_compile(params, harness.port_specs(cfg), res=res,
                       c_in=cfg["c_in"], batch=B, algorithm=cfg["algorithm"],
                       compute_dtype=cfg["compute_dtype"], device=device)
    t0, t1 = _stretch(net, pool, 10)
    calls = max(100, round(seconds / ((t1 - t0) / 10)))
    rate = {"off": [], "on": []}
    for arm in ("off", "on", "on", "off"):
        if arm == "on":
            (t0, t1), _ = _profiled(lambda: _stretch(net, pool, calls))
        else:
            t0, t1 = _stretch(net, pool, calls)
        rate[arm].append(calls * B / (t1 - t0))
    for attempt in range(3):     # a trace that lost a marker is read again
        with devtrace.DeviceTrace(device) as dt:
            ((t0, t1), _), spans = _profiled(
                lambda: (_stretch(net, pool, calls), _clock_probes()))
        if dt.events:
            break
    else:
        raise SystemExit(f"{name}: three device traces read nothing")
    probes = [s.t1 for s in spans if s.name == "gpu:clock_probe"]
    ends = sorted(e for n, _, e in dt.events if "neg_kernel" in n)
    shift = (sorted(e - t for e, t in zip(ends, probes))[len(probes) // 2]
             if probes and len(ends) == len(probes) else 0.0)
    ev = [e for e in dt.events if t0 <= e[1] <= t1]
    busy = devtrace.busy_seconds(ev, t0, t1)
    gpu = [s for s in spans if s.name.startswith("gpu:layer:")]
    for s in gpu:                    # onto the device trace's clock
        s.t0 += shift
        s.t1 += shift
    nodes = [s for s in gpu if "/" not in s.name]
    per_node: dict[str, float] = {}
    for s in nodes:
        nid = s.name.removeprefix("gpu:layer:")
        per_node[nid] = per_node.get(nid, 0.0) + s.duration_s / calls
    # device time inside each node's span that no kernel of it used
    hit = _by_midpoint(ev, [(s.name, s.t0, s.t1) for s in nodes])
    idle_in: dict[str, float] = {}
    for s in nodes:
        k = s.name.removeprefix("gpu:layer:")
        idle_in[k] = idle_in.get(k, 0.0) + s.duration_s
    for key, evs in hit.items():
        k = key.removeprefix("gpu:layer:")
        idle_in[k] -= devtrace.busy_seconds(evs, -1e30, 1e30) or 0.0
    host = {"off": _issue_ms(net, pool[0]),
            "on": _profiled(lambda: _issue_ms(net, pool[0]))[0]}
    with devtrace.DeviceTrace(device):
        host["off_under_device_trace"] = _issue_ms(net, pool[0])
        host["on_under_device_trace"] = _profiled(
            lambda: _issue_ms(net, pool[0]))[0]
    peak = counting.peaks(torch.cuda.get_device_name(device))
    hooked: dict = {}
    harness._trace_layers(net, pool[0], device, hooked)
    base = {"rows": rows, "batch": B, "peak": peak}
    out = {
        "cell": name, "calls": calls, "batch": B,
        "images_per_s": rate,
        "host_spans": sum(1 for s in spans if not s.name.startswith("gpu:")),
        "device_spans": len(gpu),
        "stretch_s": t1 - t0, "busy_s": busy,
        "trace_minus_tracer_clock_us": 1e6 * shift,
        "gpu_layer_sum_s": sum(s.duration_s for s in nodes),
        "idle_in_node_spans_ms_per_call": sorted(
            ([k, 1e3 * v / calls] for k, v in idle_in.items()),
            key=lambda kv: -kv[1])[:8],
        "host_issue_ms": host,
        "layer_device_ms": {k: 1e3 * v for k, v in per_node.items()},
    }
    for roof in (m for m in cell.per_layer if m.endswith("_roofline")):
        reader = harness.load_metric(roof)
        out[roof + ".unhooked"] = reader.read(
            dict(base, layer_device_s=per_node))
        out[roof + ".hooked"] = reader.read(
            dict(base, layer_device_s=hooked.get("layer_device_s")))
    out["gpu_layer_over_busy"] = out["gpu_layer_sum_s"] / busy
    steps = [s for s in gpu if "/" in s.name]
    if steps:
        kind = lambda s: s.name.rsplit("/", 1)[1]  # noqa: E731
        out["ir_step_ms_per_call"] = {
            k: 1e3 * sum(s.duration_s for s in steps if kind(s) == k) / calls
            for k in STEPS}
        blocks = {s.name.removeprefix("gpu:layer:").rsplit("/", 1)[0]
                  for s in steps}
        out["ir_block_ms_per_call"] = 1e3 * sum(per_node[b] for b in blocks)
        hit = _by_midpoint(ev, [(kind(s), s.t0, s.t1) for s in steps])
        out["ir_step_ops_ms_per_call"] = {
            k: [[n, 1e3 * t / calls] for n, t in devtrace.top_ops(v, 6)]
            for k, v in hit.items()}
        outside = _by_midpoint(ev, [("node", s.t0, s.t1) for s in nodes])
        out["ops_outside_nodes_ms"] = 1e3 * (busy - sum(
            e - s for _, s, e in outside.get("node", [])))
    del net
    harness.free(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--cells", nargs="*", default=None,
                    help="offline cells (default: every one)")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "stretch.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this runs on the card only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    doc = {"card": torch.cuda.get_device_name(device), "seed": args.seed}
    for name in args.cells or _offline_cells():
        print(f"stretch: {name}", file=sys.stderr, flush=True)
        doc[name] = offline(name, args.seed, args.seconds, device)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
