"""One run of one cell: set-up, the measured window, the traced readings
and the check against the plain reference.

Everything that belongs to one configuration, traffic mix, metric or cell
sits in a file of its own, found by the names in BENCHMARK.json:

  configs/<config>.json   the sizes, the port's entry points, the frozen
                          layer list the reference and the counting read
  traffic/<mix>.json      the mix's parameters (traffic.py reads them)
  metrics/<metric>.py     a reader over the run's record (NAME, UNIT,
                          read(record) -> number or None)
  limits/<cell>.json      the limit of each number `correct` compares

The program is `repro_torch`: `core.compile.compile` -> `NetworkPlan.apply`
for an offline mix, `runtime.serve.Server` for a served one. Weights and
inputs are made here from the seed, on the device, and handed to both the
program and the reference (reference/cnn.py).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from gpubench import counting, devtrace, traffic
from gpubench.reference import cnn as reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: a request's answer is waited for this long past the window's close
ANSWER_GRACE_S = 60.0
#: bias draws are scaled by this; weights by He's rule (see make_params)
BIAS_STD = 0.05


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list[str]
    per_layer: list[str]
    chips: int


def load_cell(workload: str, bench: dict | None = None) -> Cell:
    """The cell named `workload` of BENCHMARK.json, with its files."""
    bench = bench or _load_json(ROOT / "BENCHMARK.json")
    try:
        w = next(w for w in bench["workloads"] if w["name"] == workload)
    except StopIteration:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"have {[w['name'] for w in bench['workloads']]}")

    def mine(metrics):
        return [m["name"] for m in metrics
                if workload in m.get("workloads", [workload])]

    return Cell(workload, _load_json(HERE / "configs" / f"{w['config']}.json"),
                _load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                _load_json(HERE / "limits" / f"{workload}.json"),
                mine(bench["end_to_end"]), mine(bench["per_layer"]),
                w["chips"])


def load_metric(name: str):
    """The reader module metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if mod.NAME != name:
        raise ValueError(f"{path} declares NAME {mod.NAME!r}")
    return mod


# ---------------------------------------------------------------------------
# weights and inputs, from the seed, on the device
# ---------------------------------------------------------------------------

def make_params(rows: list[dict], generator: torch.Generator,
                device: torch.device) -> dict:
    """Random weights in the program's params layout, drawn in one call on
    `device` and scaled so that activations and logits stay O(1): He's
    sqrt(2 / fan_in) before a ReLU / ReLU6, sqrt(1 / fan_in) before none,
    biases BIAS_STD."""
    shapes = []

    def collect(p, act):
        for key, v in p.items():
            if isinstance(v, dict):
                collect(v, {"exp": "relu6", "dw": "relu6",
                            "pw": "none"}.get(key, act))
            else:
                shapes.append((v, key, act))

    for r in rows:
        if "params" in r:
            act = r.get("act", "relu" if r.get("relu", True) else "none")
            collect(r["params"], act)
    flat = torch.randn(sum(math.prod(s) for s, _, _ in shapes),
                       generator=generator, device=device)
    off, views = 0, []
    for shape, key, act in shapes:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        if key == "b":
            v.mul_(BIAS_STD)
        else:
            fan_in = math.prod(shape[:-1])
            v.mul_(math.sqrt((1.0 if act == "none" else 2.0) / fan_in))
        views.append(v)
    leaves = iter(views)

    def fill(p):
        return {k: fill(v) if isinstance(v, dict) else next(leaves)
                for k, v in p.items()}

    return {r["name"]: fill(r["params"]) for r in rows if "params" in r}


def draw(cell: Cell, seed: int, device: torch.device,
         res: int | None = None):
    """(walked layers, params, input pool, res) of a run: the weights, then
    the pool ((pool_batches, batch, res, res, c) offline, (pool_images,
    res, res, c) served), from one generator on `device` seeded by `seed`.
    `res` shrinks the images (CPU tests only)."""
    cfg, mix = cell.config, cell.mix
    res = res or cfg["res"]
    rows = counting.walk(cfg["layers"], res, cfg["c_in"])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = make_params(rows, g, device)
    lead = ((mix["pool_batches"], mix["batch"]) if mix["kind"] == "offline"
            else (mix["pool_images"],))
    pool = torch.randn(lead + (res, res, cfg["c_in"]), generator=g,
                       device=device)
    return rows, params, pool, res


def control_err(cell: Cell, seed: int, device: torch.device,
                res: int | None = None) -> float:
    """The control: the reference computed one precision step below the
    configuration's (TF32 for fp32 with TF32 off) in the program's place,
    on the inputs and weights a run of `seed` draws, in the cell's batches
    (offline) or its largest bucket (served), judged as a run's answers."""
    cfg, mix = cell.config, cell.mix
    _, params, pool, _ = draw(cell, seed, device, res)
    x = pool.flatten(0, 1) if mix["kind"] == "offline" else pool
    block = (mix["batch"] if mix["kind"] == "offline"
             else max(cfg["serve_buckets"]))
    refs = reference.forward_blocks(cfg["layers"], params, x, block=block)
    ctl = reference.forward_blocks(cfg["layers"], params, x, block=block,
                                   tf32=True)
    return logit_err(row_gaps(ctl, refs), refs)


def port_specs(config: dict):
    from repro_torch.models.cnn import NETWORKS
    return NETWORKS[config["network"]][0]()


# ---------------------------------------------------------------------------
# the comparison that decides `correct`
# ---------------------------------------------------------------------------

def logit_err(gaps: torch.Tensor, refs: torch.Tensor) -> float:
    """The widest gap between an answer's logit and the reference's, over
    every answer (`gaps`: each answer's widest gap), as a share of the
    median over the reference rows of their largest |logit|. NaN when an
    answer holds a NaN."""
    return float(gaps.max() / refs.abs().amax(dim=1).median())


def row_gaps(answers: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """Each answer row's widest gap to its reference row."""
    return (answers.to(refs.device, torch.float32) - refs).abs().amax(dim=1)


def judge(checks: dict) -> bool:
    """Every check's value within its limit (NaN fails)."""
    return all(c["value"] <= c["limit"] for c in checks.values())


# ---------------------------------------------------------------------------
# offline: NetworkPlan.apply back to back
# ---------------------------------------------------------------------------

def run_offline(cell: Cell, seed: int, seconds: float, trace: bool,
                device: torch.device, marks: list,
                res: int | None = None, fault=None) -> dict:
    """One offline run; returns the record the metric readers read.
    `res` shrinks the images (CPU tests only); `fault(y) -> y` breaks
    each answer where it is produced (the fault tests).

    The check needs the widest gap of every answer to its reference, and
    the window's answers to one pool batch share that reference, so the
    window keeps, per pool batch, each logit's largest and smallest value
    over the calls (two elementwise kernels a call) instead of every
    call's logits: the widest gap over all calls is the larger of
    hi - ref and ref - lo, exactly, and no output outlives its call."""
    from repro_torch.core.compile import compile as port_compile
    marks.append(("import repro_torch", time.perf_counter()))

    cfg, mix = cell.config, cell.mix
    rows, params, pool, res = draw(cell, seed, device, res)
    B, P = mix["batch"], mix["pool_batches"]
    t0 = time.perf_counter()
    marks.append(("draw weights and pool", t0))
    net = port_compile(params, port_specs(cfg), res=res, c_in=cfg["c_in"],
                       batch=B, algorithm=cfg["algorithm"],
                       compute_dtype=cfg["compute_dtype"], device=device)
    compile_s = time.perf_counter() - t0
    marks.append(("compile", time.perf_counter()))
    apply = net.apply if fault is None else (lambda x: fault(net.apply(x)))
    with torch.inference_mode():
        ys = [apply(pool[i]) for i in range(P)]
        hi = torch.full((P,) + ys[0].shape, -math.inf, device=device)
        lo = torch.full_like(hi, math.inf)
        del ys
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    gcw = GcWatch()
    marks.append(("gc.collect", time.perf_counter()))

    rec: dict = {"kind": "offline", "rows": rows, "batch": B,
                 "setup": {"compile_s": compile_s}}
    spans: list[tuple[str, float, float]] = []
    with devtrace.DeviceTrace(device) if trace else \
            contextlib.nullcontext() as dt, \
            torch.inference_mode():
        t_start = time.perf_counter()
        rec["setup_s"], rec["setup_phases"] = _setup(marks, t_start)
        i = 0
        while time.perf_counter() - t_start < seconds:
            a0 = time.perf_counter()
            k = i % P
            y = apply(pool[k])
            torch.maximum(hi[k], y, out=hi[k])
            torch.minimum(lo[k], y, out=lo[k])
            if trace:
                spans.append(("NetworkPlan.apply walk", a0,
                              time.perf_counter()))
            i += 1
        d0 = time.perf_counter()
        _sync(device)
        t_end = time.perf_counter()
    rec["gc_pauses_s"] = gcw.stop()
    rec.update(images=i * B, calls=i, window_s=t_end - t_start,
               t_window=(t_start, t_end))
    rec["memory_peak_bytes"] = _peak(device)
    if trace:
        spans.append(("window drain (synchronize)", d0, t_end))
        rec["device_events"] = dt.events
        rec["host_spans"] = spans
        _trace_layers(net, pool[0], device, rec)
        rec["apply_host_s"] = _host_issue_times(net, pool[0], device)

    del net
    free(device)
    used = min(i, P)
    refs = torch.stack([reference.forward_blocks(
        cfg["layers"], params, pool[k], block=min(B, 32))
        for k in range(used)])
    gaps = torch.cat([row_gaps(hi[:used].flatten(0, 1), refs.flatten(0, 1)),
                      row_gaps(lo[:used].flatten(0, 1), refs.flatten(0, 1))])
    err = logit_err(gaps, refs.flatten(0, 1))
    rec["checks"] = {"logit_err": {"value": err,
                                   "limit": cell.limits["logit_err"]}}
    rec["attempted"], rec["failed"] = rec["images"], 0
    return rec


def _trace_layers(net, x, device, rec, calls: int = 3,
                  tries: int = 3) -> None:
    """A few hooked calls under the device trace: NetworkPlan.apply's
    layer_hook synchronizes around each planned node, so the kernels that
    run inside a node's host interval are that node's. Every planned node
    launches kernels; a trace that gives one of them none is read again,
    `tries` times at most, and each such trace is named on stderr."""
    for attempt in range(1, tries + 1):
        intervals = []

        def hook(node_id, seconds):
            t = time.perf_counter()
            intervals.append((node_id, t - seconds, t))

        with devtrace.DeviceTrace(device) as dt, torch.inference_mode():
            for _ in range(calls):
                net.apply(x, layer_hook=hook)
        dev = devtrace.attribute(dt.events, intervals)
        missing = sorted({k for k, _, _ in intervals} - set(dev))
        if dev:
            rec["layer_device_s"] = {k: v / calls for k, v in dev.items()}
        if dev and not missing:
            return
        print(f"hooked trace {attempt} of {tries}: no device time for "
              f"{missing if dev else 'any node'}", file=sys.stderr)


def _host_issue_times(net, x, device, calls: int = 7) -> list[float]:
    """Host seconds to issue one forward on an idle card (a synchronize
    before each call, none inside it)."""
    out = []
    with torch.inference_mode():
        for _ in range(calls):
            _sync(device)
            t = time.perf_counter()
            net.apply(x)
            out.append(time.perf_counter() - t)
    _sync(device)
    return out


# ---------------------------------------------------------------------------
# served: an open loop behind runtime.serve.Server
# ---------------------------------------------------------------------------

def start_server(cell: Cell, params, res: int, device, fault=None):
    """The program's Server for the cell, started (every bucket compiled,
    warmed and captured); `fault(y) -> y` breaks each batch's answers where
    they are produced (the fault tests)."""
    from repro_torch.runtime.serve import ServeConfig, Server
    cfg = cell.config
    server = Server(params, port_specs(cfg), res=res, c_in=cfg["c_in"],
                    algorithm=cfg["algorithm"],
                    compute_dtype=cfg["compute_dtype"],
                    config=ServeConfig(buckets=tuple(cfg["serve_buckets"])),
                    device=device)
    if fault is not None:
        dispatch = server._dispatch
        server._dispatch = lambda b, X: (lambda r: (fault(r[0]), r[1]))(
            dispatch(b, X))
    server.start()
    return server


def serve_window(server, images: np.ndarray, schedule: traffic.Schedule,
                 t_start: float) -> dict:
    """Send `schedule` from a client thread, each request at its due time
    (t_start + due_s), and wait for every answer, ANSWER_GRACE_S past the
    window at most. Latency runs from the due time to the moment the
    answer reached the client's ticket; a refused or unanswered request is
    infinitely late. The client keeps a ticket only until it is answered,
    as a caller would: a window's worth of live tickets would make every
    full garbage collection in the process longer as the window goes on."""
    from repro_torch.runtime.serve import QueueFullError
    n = len(schedule)
    due = t_start + schedule.due_s
    late = np.zeros(n)
    lat = np.full(n, math.inf)
    rows: list = [None] * n
    pending: collections.deque = collections.deque()
    tally = {"refused": 0, "unanswered": 0, "errors": 0}

    def retire(j, tk):
        try:
            rows[j] = tk.result(timeout=0)
            lat[j] = tk.finished_at - due[j]
        except Exception:                    # noqa: BLE001 - answered wrong
            tally["errors"] += 1

    def client():
        for j in range(n):
            wait = due[j] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            try:
                pending.append((j, server.submit(images[schedule.image[j]])))
            except QueueFullError:
                tally["refused"] += 1
            late[j] = time.perf_counter() - due[j]
            while pending and pending[0][1].done():
                retire(*pending.popleft())

    th = threading.Thread(target=client, name="gpubench-client")
    th.start()
    th.join()
    close = t_start + float(schedule.due_s[-1])
    for j, tk in pending:
        try:
            tk.result(timeout=max(
                0.0, close + ANSWER_GRACE_S - time.perf_counter()))
        except TimeoutError:
            tally["unanswered"] += 1
            continue
        except Exception:                    # noqa: BLE001 - retire counts it
            pass
        retire(j, tk)
    return dict(tally, latency_s=lat, rows=rows, client_late_s=late,
                t_window=(t_start, max(close, time.perf_counter())))


def run_served(cell: Cell, seed: int, seconds: float, trace: bool,
               device: torch.device, marks: list,
               res: int | None = None, fault=None) -> dict:
    from repro_torch.obs import profile as obs_profile
    marks.append(("import repro_torch", time.perf_counter()))

    cfg, mix = cell.config, cell.mix
    rows, params, pool, res = draw(cell, seed, device, res)
    images = pool.cpu().numpy()
    schedule = traffic.served_schedule(mix, seed, seconds)
    t0 = time.perf_counter()
    marks.append(("draw weights, pool and schedule", t0))
    server = start_server(cell, params, res, device, fault)
    compile_s = time.perf_counter() - t0
    marks.append(("Server construction and start", time.perf_counter()))
    # the client's path once per bucket size, before the window
    for b in cfg["serve_buckets"]:
        for tk in [server.submit(images[i]) for i in range(b)]:
            tk.result(timeout=ANSWER_GRACE_S)
    marks.append(("warm-up", time.perf_counter()))
    rec: dict = {"kind": "served", "rows": rows,
                 "setup": {"compile_s": compile_s}}
    stats0 = server.stats.snapshot()
    prof = obs_profile.enable(capacity=1 << 22) if trace else None
    gcw = GcWatch()
    marks.append(("gc.collect", time.perf_counter()))
    with devtrace.DeviceTrace(device) if trace else \
            contextlib.nullcontext() as dt:
        t_start = time.perf_counter() + 0.01
        rec["setup_s"], rec["setup_phases"] = _setup(marks, t_start)
        w = serve_window(server, images, schedule, t_start)
    rec["gc_pauses_s"] = gcw.stop()
    stats1 = server.stats.snapshot()
    rec["memory_peak_bytes"] = _peak(device)
    if trace:
        rec["obs_spans"] = [(s.name, s.t0, s.t1) for s in prof.tracer.spans()]
        obs_profile.disable()
        rec["device_events"] = dt.events
        rec["host_spans"] = _serve_host_spans(rec["obs_spans"])
    server.stop()
    del server
    free(device)
    rec.update(latency_s=w["latency_s"], client_late_s=w["client_late_s"],
               t_window=w["t_window"],
               window_s=w["t_window"][1] - w["t_window"][0],
               stats={k: _delta(stats0[k], stats1[k])
                      for k in ("completed", "batches", "bucket_batches",
                                "jit_dispatches", "failed", "rejected")})
    answered = [j for j, r in enumerate(w["rows"]) if r is not None]
    used_t = torch.as_tensor(np.unique(schedule.image), device=device)
    refs = torch.zeros((mix["pool_images"], rows[-1]["out"][2]),
                       device=device)
    refs[used_t] = reference.forward_blocks(
        cfg["layers"], params, pool[used_t], block=32)
    if answered:
        ans = torch.as_tensor(np.stack([w["rows"][j] for j in answered]),
                              device=device)
        idx = torch.as_tensor(schedule.image[answered], device=device)
        err = logit_err(row_gaps(ans, refs[idx]), refs[used_t])
    else:
        err = math.nan
    rec["checks"] = {
        "logit_err": {"value": err, "limit": cell.limits["logit_err"]},
        "unanswered": {"value": w["unanswered"] + w["errors"], "limit": 0}}
    rec["attempted"] = len(schedule)
    rec["failed"] = w["refused"] + w["unanswered"] + w["errors"]
    return rec


def _serve_host_spans(obs_spans) -> list[tuple[str, float, float]]:
    """One host span per batch and kind from the server's request spans:
    batch formation (selection, stacking), dispatch (copy in, graph
    replay, synchronize) and respond (copy out, answering the tickets)."""
    seen, out = set(), []
    for name, t0, t1 in obs_spans:
        if name in ("serve.batch_formation", "serve.dispatch",
                    "serve.respond") and (name, t0) not in seen:
            seen.add((name, t0))
            out.append((name, t0, t1))
    return out


def _delta(a, b):
    if isinstance(a, dict) or isinstance(b, dict):
        keys = set(a) | set(b)
        return {k: b.get(k, 0) - a.get(k, 0) for k in keys}
    return b - a


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

class GcWatch:
    """Ends set-up with a full collection, so that set-up's garbage is not
    collected inside the window (a long-running process has collected it
    long before), and records each collection's pause until stop(). The
    collector's policy is left as the program has it."""

    def __init__(self):
        gc.collect()
        self.pauses: list[float] = []
        self._t0 = None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append(time.perf_counter() - self._t0)

    def stop(self) -> list[float]:
        gc.callbacks.remove(self._cb)
        return self.pauses


def _setup(marks: list, t_start: float) -> tuple[float, dict]:
    """(set-up seconds, seconds of each phase) from `marks`, a list of
    (phase, time it ended) whose first entry is the process's start."""
    marks = marks + [("to the window", t_start)]
    return t_start - marks[0][1], {
        name: t - t0 for (_, t0), (name, t) in zip(marks, marks[1:])}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device: torch.device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, marks: list, **kw) -> dict:
    """The run's record, with its metrics read and `correct` decided.
    `marks`: (set-up phase, time it ended), from the process's start on;
    the run adds its own. The program builds its kernel libraries at their
    first launch, in warm-up: only a checkout's first run builds them."""
    # fp32 with TF32 off, as every configuration's compute_dtype states
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = run_offline if cell.mix["kind"] == "offline" else run_served
    rec = run(cell, seed, seconds, trace, device, marks, **kw)
    rec["peak"] = (counting.peaks(torch.cuda.get_device_name(device))
                   if device.type == "cuda" else None)
    if trace and rec.get("device_events"):
        t0, t1 = rec["t_window"]
        ev = rec["device_events"]
        rec["busy_s"] = devtrace.busy_seconds(ev, t0, t1)
        rec["breakdown"] = {
            "device_ops": devtrace.top_ops(
                [e for e in ev if t0 <= e[1] <= t1]),
            "idle_gaps": devtrace.idle_gaps(
                ev, t0, t1, rec["host_spans"],
                other=("harness loop" if rec["kind"] == "offline"
                       else "no batch in flight"))}
    names = cell.per_layer if trace else cell.end_to_end
    rec["metrics"] = {}
    for name in names:
        m = load_metric(name)
        v = m.read(rec)
        if v is not None:
            rec["metrics"][name] = {"value": v, "unit": m.UNIT}
    rec["correct"] = judge(rec["checks"])
    return rec
