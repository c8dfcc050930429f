"""Fault-tolerant batched serving runtime over compiled NetworkPlan artifacts,
on the card: the JAX package's runtime/serve.py for the PyTorch port.

Compile once, ship the transformed weights as a versioned artifact,
warm-start with zero filter transforms -- this module is the layer that
drives those artifacts under load:

  * **Admission with backpressure.** A bounded queue; `submit()` on a full
    queue raises `QueueFullError` carrying `retry_after_s` (queue depth over
    the measured batch service rate), so overload degrades into bounded
    rejection instead of unbounded latency.
  * **Dynamic batch formation into bucketed batch sizes.** Plan geometry is
    batch-shape-specific, so the server compiles ONE NetworkPlan per bucket
    (each warm-started from its own artifact when `artifact_dir` is given)
    and pre-warms every bucket before traffic arrives: one supervised
    batch, then the capture of its CUDA graph.
    Arrivals coalesce for `batch_wait_s`, are dispatched
    earliest-deadline-first, and are padded up to the smallest covering
    bucket.
  * **Deadlines.** Per-request deadlines; requests that expire while queued
    are timeout-cancelled before dispatch (never executed), and responses
    that land past their deadline are flagged `deadline_missed`.
  * **The degrade ladder.** A supervisor wraps every batch execution:
      1. in-place retries paced by exponential backoff with jitter
         (`fault.Backoff`);
      2. re-place the failing layer (identified via
         `compile.LayerExecutionError.node_id`) onto the im2row fallback
         through the capability registry -- across every bucket plan;
      3. recompile in place from raw params when the rung above does not
         cure it, counting per-array checksum findings against the on-disk
         artifacts (`compile.verify_artifact`) -- the corrupt-artifact path.
    The failing batch is retried after each rung, so in-flight requests
    survive every recoverable fault; only a fully exhausted ladder answers
    tickets with the error (failed, but never silently dropped).
  * **Mixed-precision supervision.** A server compiled with a reduced
    `compute_dtype` (bf16/int8 transform-domain plans) runs an accuracy
    probe at warmup (and on demand via `probe_precision()`): each quantized
    conv layer is checked against a fresh fp32 plan on its real shape, and
    a layer outside its per-dtype error budget is promoted back to fp32
    across every bucket plan before traffic sees it. `stats` surfaces the
    per-layer compute dtypes currently being served.
  * **Straggler eviction.** A `fault.StepTimer` per bucket flags outlier
    batches; per-layer times (NetworkPlan.apply's layer_hook) attribute the
    spike, and a layer that stragglers `straggler_evict_after` times is
    evicted onto the fallback executor.
  * **Graph dispatch.** The reference serves each bucket through
    `jax.jit(net.apply)`; here each bucket replays a CUDA graph of
    `net.apply` captured from a static input buffer (`_jitted_apply`; on
    the CPU, the eager apply under `torch.inference_mode()`), re-captured
    whenever a bound plan is swapped. The stats keep the reference's names
    (`jit_dispatches`, `jit_fallbacks`).
  * **Mesh-sharded buckets.** `Server(mesh=, partition=)` compiles, beside
    each bucket's plan, a plan partitioned over the mesh
    (core/partition.py) for every bucket the partition covers
    (`stats.sharded_buckets`, artifacts `plan_b{B}_{kind}{n}.npz`); only
    the graph-dispatch happy path runs it. A bucket the mesh cannot serve
    logs why and serves its unsharded plan; supervision (hooks, the
    degrade ladder, the probe) always runs the unsharded plans. A sharded
    program whose mesh repeats one card is captured like any bucket; on a
    mesh of several cards it runs eagerly.

The server runs on the card (`device=None`); without CUDA it raises unless
`device="cpu"` is passed. Results are numpy rows, as the requests are.
Deterministic fault injection for all of this lives in
`repro_torch.runtime.inject`.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import compile as _compile
from repro_torch.core import partition as _partition
from repro_torch.core import plan as _plan
from repro_torch.kernels.runtime import resolve_device
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import profile as _obs_profile
from repro_torch.obs import trace as _obs_trace
from repro_torch.runtime.fault import Backoff, StepTimer


class QueueFullError(RuntimeError):
    """Admission rejected: the bounded queue is full. `retry_after_s` is the
    server's estimate of when capacity frees (queue depth over the measured
    batch service rate) -- the client-visible backpressure signal."""

    def __init__(self, retry_after_s: float, capacity: int):
        super().__init__(
            f"admission queue full (capacity {capacity}); retry in "
            f"{retry_after_s:.3f}s")
        self.retry_after_s = retry_after_s
        self.capacity = capacity


@dataclass
class ServeConfig:
    """Serving-runtime knobs (batching, admission, supervision)."""

    buckets: Sequence[int] = (1, 2, 4, 8)
    queue_capacity: int = 64
    #: dynamic batch formation window: how long the scheduler lets a
    #: non-full queue coalesce before dispatching what it has.
    batch_wait_s: float = 0.002
    default_deadline_s: float | None = None
    #: supervisor rung 1: in-place retries before degrading.
    max_retries: int = 2
    backoff_base_s: float = 0.01
    backoff_cap_s: float = 0.25
    #: straggler detection (per-bucket StepTimer) + eviction policy.
    straggler_sigma: float = 3.0
    straggler_window: int = 32
    straggler_min_baseline: int = 8
    straggler_evict_after: int = 3
    #: a layer is blamed for a straggler batch only when its time exceeds
    #: this multiple of its own non-straggler EWMA baseline.
    straggler_layer_ratio: float = 2.0
    fallback_algorithm: str = "im2col"
    ewma_alpha: float = 0.3
    #: the graph-dispatch happy path (the reference's jitted path, under its
    #: name): batch dispatch replays a per-bucket CUDA graph of
    #: NetworkPlan.apply (on the CPU, the eager apply under
    #: torch.inference_mode()), captured again whenever a bound plan is
    #: swapped, until the FIRST fault on that bucket, then falls back to
    #: the eager supervised path -- where per-layer hooks, error
    #: annotation, and the degrade ladder can see every layer -- for that
    #: bucket. Disable for tests or drills that need per-layer
    #: observability from the first batch.
    jit_dispatch: bool = True
    #: continuous re-placement: a layer evicted onto the fallback executor
    #: gets a probation window of this many CLEAN batches (no executor
    #: failures), after which the supervisor re-probes the original
    #: algorithm against the serving fallback on a real-shape input and
    #: promotes the layer back when it passes; a failed probe doubles the
    #: window. 0 pins evicted layers on the fallback forever.
    probation_batches: int = 256
    #: max relative error of the re-probe vs the serving fallback plan.
    probation_tol: float = 2e-3
    #: run the reduced-precision accuracy probe during warmup (servers with
    #: compute_dtype="float32" never probe); per-dtype relative max-abs
    #: error budgets default to plan.AUTOTUNE_ACCURACY_BUDGET.
    precision_probe: bool = True
    precision_budget: dict | None = None
    verbose: bool = True


class Ticket:
    """One admitted request: the Future-ish handle the client waits on.

    Terminal states: 'ok' (result ready), 'timeout' (deadline expired while
    queued), 'cancelled', 'error' (the supervisor's degrade ladder was
    exhausted). Exactly one terminal transition wins; every admitted ticket
    reaches one -- the zero-drop contract."""

    def __init__(self, rid: int, x: np.ndarray, deadline: float | None,
                 submitted_at: float):
        self.rid = rid
        self.x = x
        self.deadline = deadline          # absolute perf_counter time
        self.submitted_at = submitted_at
        self.finished_at: float | None = None
        self.deadline_missed = False
        self.status = "pending"
        self._value = None
        self._error: BaseException | None = None
        self._done = threading.Event()
        self._once = threading.Lock()

    def _finish(self, status: str, value=None,
                error: BaseException | None = None) -> bool:
        with self._once:
            if self._done.is_set():
                return False
            self.status = status
            self._value = value
            self._error = error
            self.finished_at = time.perf_counter()
            self._done.set()
            return True

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Best-effort cancel; wins only if the request was not already
        dispatched into a batch."""
        return self._finish("cancelled",
                            error=RuntimeError(f"request {self.rid} "
                                               f"cancelled"))

    def result(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still pending")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def latency_s(self) -> float | None:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at


#: every ServerStats counter, in snapshot order. Each is a live view over
#: a repro_torch.obs.metrics Counter in the server's own registry
#: ("serve.<name>"), so attribute reads/writes and the metrics snapshot see
#: one value.
_STAT_COUNTERS = (
    "admitted", "rejected", "completed", "timed_out", "cancelled",
    "failed", "deadline_missed", "batches", "executor_failures", "retries",
    "replacements", "evictions", "stragglers", "recompiles",
    "corrupt_artifacts", "corrupt_arrays", "artifact_warm_starts",
    "artifact_cold_starts",
    # layers the accuracy probe promoted back to fp32 (reduced-precision
    # outputs outside budget never keep serving).
    "precision_promotions",
    # graph-dispatch accounting (the reference's jitted-path names):
    # batches served by a CUDA-graph replay (on the CPU, the hook-free
    # inference-mode apply), and buckets whose capture or replay failed
    # and fell back to the eager supervised path on their first fault.
    "jit_dispatches", "jit_fallbacks",
    # continuous re-placement: probation re-probes run, and evicted layers
    # promoted back onto their original algorithm.
    "probation_reprobes", "probation_promotions",
)
#: dict-shaped stats state, guarded by the SAME registry lock as the
#: counters so snapshot() is one atomic cut across everything.
_STAT_DICTS = ("bucket_batches", "sharded_buckets", "layer_compute_dtypes")


class ServerStats:
    """Serving counters; `snapshot()` is the JSON-safe view benchmarks and
    the CI gate read. `in_flight` is admitted minus every terminal state --
    zero after a drained stop, or requests were dropped.

    Counters are views over a repro_torch.obs.metrics registry (one
    registry per server, enrolled in `metrics.snapshot_all()`): attribute
    reads return the counter value, attribute writes and `inc()` mutate it
    under the registry lock. The dict fields -- `bucket_batches`
    (per-bucket batch counts, int keys), `sharded_buckets` ({bucket:
    num_shards} served by a mesh-sharded plan on the graph-dispatch
    path), `layer_compute_dtypes` (the
    transform-domain dtype per layer of the CURRENTLY served plans,
    refreshed after compile / re-place / recompile / promotion) -- share
    that lock, so `snapshot()` returns an atomic deep copy: no torn
    multi-counter reads, and never a RuntimeError from a dict resized
    mid-iteration while the scheduler thread keeps serving."""

    def __init__(self, registry: "_obs_metrics.MetricsRegistry | None"
                 = None):
        reg = registry or _obs_metrics.new_registry("serve")
        d = self.__dict__
        d["registry"] = reg
        d["_lock"] = reg.lock
        d["_counters"] = {n: reg.counter(f"serve.{n}")
                          for n in _STAT_COUNTERS}
        d["bucket_batches"] = {}
        d["sharded_buckets"] = {}
        d["layer_compute_dtypes"] = {}

    # -- counter views: stats.admitted reads, stats.admitted = v writes --

    def __getattr__(self, name: str):
        try:
            return self.__dict__["_counters"][name].value
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value) -> None:
        c = self.__dict__["_counters"].get(name)
        if c is not None:
            c.set(value)
        elif name in _STAT_DICTS:
            with self.__dict__["_lock"]:
                self.__dict__[name] = value
        else:
            self.__dict__[name] = value

    def inc(self, name: str, n: int = 1) -> None:
        self.__dict__["_counters"][name].inc(n)

    def bump_bucket(self, bucket: int) -> None:
        with self._lock:
            self.bucket_batches[bucket] = \
                self.bucket_batches.get(bucket, 0) + 1

    def set_sharded(self, bucket: int, num_shards: int) -> None:
        with self._lock:
            self.sharded_buckets[str(bucket)] = int(num_shards)

    @property
    def in_flight(self) -> int:
        with self._lock:
            c = self.__dict__["_counters"]
            return (c["admitted"].value - c["completed"].value
                    - c["timed_out"].value - c["cancelled"].value
                    - c["failed"].value)

    def snapshot(self) -> dict:
        """Atomic deep-copied JSON-safe view: taken under the registry
        lock, so no counter increment, dict mutation, or in-flight
        transition interleaves with the copy."""
        with self._lock:
            d: dict[str, Any] = {n: c.value
                                 for n, c in
                                 self.__dict__["_counters"].items()}
            d["bucket_batches"] = {str(k): v
                                   for k, v in self.bucket_batches.items()}
            d["sharded_buckets"] = dict(self.sharded_buckets)
            d["layer_compute_dtypes"] = dict(self.layer_compute_dtypes)
            d["in_flight"] = (d["admitted"] - d["completed"]
                              - d["timed_out"] - d["cancelled"]
                              - d["failed"])
            return d


#: the docs' name for the stats object; same class.
ServeStats = ServerStats


class Server:
    """Batched inference server over per-bucket compiled NetworkPlans.

    `params` + `graph` describe the network exactly as for
    `repro_torch.core.compile.compile()`; the server compiles (or
    warm-starts from `artifact_dir`) one plan per batch bucket on `device`
    (None means the CUDA device; without one it raises unless
    device="cpu"). `start()` launches the scheduler thread; `submit()`
    admits single examples of shape `example_shape`; `stop()` drains.
    Usable as a context manager.

    With `mesh=` (launch.mesh.make_data_mesh) every bucket the
    `partition` ("data" by default, or "spatial") covers also gets a
    sharded plan, which the graph-dispatch happy path runs; the unsharded
    plans live on the mesh's first device unless `device=` says
    otherwise."""

    def __init__(self, params, graph, *, res: int | None = None,
                 c_in: int = 3, input_shape: Sequence[int] | None = None,
                 algorithm: str = "auto", dtype=None,
                 compute_dtype: str = "float32",
                 config: ServeConfig | None = None,
                 artifact_dir: str | None = None,
                 mesh=None, partition: str | None = None, device=None):
        if device is None and mesh is not None:
            device = mesh.devices[0]
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the scheduler thread selects this card by index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.config = cfg = config or ServeConfig()
        self.params = params
        self._graph_desc = graph
        self._algorithm = algorithm
        self._dtype = dtype
        self.compute_dtype = _plan.dtype_name(compute_dtype)
        self.mesh = mesh
        self._partition = partition
        self._artifact_dir = artifact_dir
        if artifact_dir is not None:
            os.makedirs(artifact_dir, exist_ok=True)
        if input_shape is not None:
            self.example_shape = tuple(input_shape)[1:]
        elif res is not None:
            self.example_shape = (res, res, c_in)
        else:
            raise ValueError("Server needs res= (image networks) or "
                             "input_shape= (leading dim is the batch)")
        self.buckets = tuple(sorted(set(int(b) for b in cfg.buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got "
                             f"{cfg.buckets}")
        self.stats = ServerStats()
        self.nets: dict[int, _compile.NetworkPlan] = {
            b: self._compile_bucket(b) for b in self.buckets}
        # Mesh binding: buckets the partition covers additionally get a
        # sharded plan that ONLY the graph-dispatch happy path runs.
        # Supervision (per-layer hooks, the degrade ladder, replace_layer)
        # stays on the single-logical-device plans above.
        self.sharded_nets: dict[int, _compile.NetworkPlan] = {}
        if mesh is not None:
            for b in self.buckets:
                net = self._compile_bucket(b, sharded=True)
                if net is not None and net.is_sharded():
                    self.sharded_nets[b] = net
                    self.stats.set_sharded(b, net.partition["num_shards"])
                elif net is not None:
                    self._log(f"bucket {b}: {net.partition['degraded']}; "
                              f"serving the unsharded plan")
        self._eager_sharded_logged = False
        self.np_dtype = np.dtype(self.nets[self.buckets[0]].dtype)
        self._refresh_layer_dtypes()
        # scheduling state
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: list[Ticket] = []
        self._rid = itertools.count()
        self._stop = False
        self._draining = True
        self._thread: threading.Thread | None = None
        # supervision state
        self._batch_timer = {
            b: StepTimer(window=cfg.straggler_window,
                         sigma=cfg.straggler_sigma,
                         min_baseline=cfg.straggler_min_baseline)
            for b in self.buckets}
        self._layer_ewma: dict[tuple[int, str], float] = {}
        self._straggler_counts: dict[str, int] = {}
        self._replaced: set[str] = set()
        self._recompiled = False
        self._service_ewma: float | None = None
        # graph-dispatch happy path: per-bucket (plan-identity token,
        # callable, the network and plans it was captured from -- held so
        # their ids cannot be reused while the entry lives); a bucket lands
        # in _jit_broken on its first graph-path fault and serves eagerly
        # (supervised) from then on.
        self._jit: dict[int, tuple[tuple, Any, tuple]] = {}
        self._jit_broken: set[int] = set()
        # continuous re-placement: evicted layer -> {clean, need}; the
        # per-layer window doubles on every failed re-probe.
        self._probation: dict[str, dict] = {}
        self._probation_window: dict[str, int] = {}

    # ---- plan lifecycle --------------------------------------------------

    def _log(self, msg: str) -> None:
        if self.config.verbose:
            print(f"[serve] {msg}", flush=True)

    def _artifact_path(self, bucket: int,
                       sharded: bool = False) -> str | None:
        if self._artifact_dir is None:
            return None
        if sharded:
            _, n = _partition.mesh_num_shards(self.mesh)
            kind = self._partition or "data"
            return os.path.join(self._artifact_dir,
                                f"plan_b{bucket}_{kind}{n}.npz")
        return os.path.join(self._artifact_dir, f"plan_b{bucket}.npz")

    def _compile_bucket(self, bucket: int, force_cold: bool = False,
                        sharded: bool = False
                        ) -> "_compile.NetworkPlan | None":
        art = self._artifact_path(bucket, sharded=sharded)
        if art is not None and os.path.exists(art):
            if force_cold:
                os.remove(art)
            else:
                bad = _compile.verify_artifact(art)
                if bad:
                    # detected by the per-array checksums: count it, then
                    # let compile()'s load fallback recompile in place.
                    self.stats.inc("corrupt_artifacts")
                    self.stats.inc("corrupt_arrays", len(bad))
                    self._log(f"bucket {bucket} artifact fails integrity "
                              f"check ({len(bad)} arrays, e.g. {bad[0]!r}); "
                              f"recompiling in place")
        before = _plan.plan_cache_info()["artifact_hits"]
        try:
            net = _compile.compile(
                self.params, self._graph_desc,
                input_shape=(bucket,) + self.example_shape,
                algorithm=self._algorithm, dtype=self._dtype,
                compute_dtype=self.compute_dtype, artifact=art,
                device=None if sharded else self.device,
                mesh=self.mesh if sharded else None,
                partition=self._partition if sharded else None)
        except Exception as e:
            if not sharded:
                raise
            # a bucket the mesh cannot serve is not fatal: the graph path
            # simply runs that bucket's single-logical-device plan.
            self._log(f"bucket {bucket}: sharded compile unavailable "
                      f"({e!r}); serving the unsharded plan")
            return None
        if art is not None:
            if _plan.plan_cache_info()["artifact_hits"] > before:
                self.stats.inc("artifact_warm_starts")
            else:
                self.stats.inc("artifact_cold_starts")
        return net

    def _refresh_layer_dtypes(self) -> None:
        """Re-derive stats.layer_compute_dtypes from the currently served
        plans (the smallest bucket; placement is identical across
        buckets)."""
        net = self.nets[self.buckets[0]]
        self.stats.layer_compute_dtypes = {
            nid: p.describe().get("compute_dtype", "float32")
            for nid, p in net.plans.items()}

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _sync(self) -> None:
        """Wait for the device: a batch's time and its errors are the
        device's, not the enqueue's."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """Pre-warm every bucket: one zero batch per bucket plan, so every
        kernel library is built and loaded and every transform matrix is
        on the device, then the bucket's CUDA graph is captured -- all
        before traffic. Runs under the same supervisor as live batches -- a
        faulty executor discovered at warmup degrades instead of failing
        startup. Servers with a reduced compute_dtype also run the accuracy
        probe here, so a layer whose quantized output is outside budget is
        promoted to fp32 before any client traffic sees it."""
        for b in self.buckets:
            x = self._to_device(
                np.zeros((b,) + self.example_shape, self.np_dtype))
            self._supervised_apply(b, x)
            if self.config.jit_dispatch:
                try:
                    self._jitted_apply(b, x)
                    self._sync()
                except Exception as e:
                    self._jit_broken.add(b)
                    self.stats.inc("jit_fallbacks")
                    self._log(f"bucket {b}: graph dispatch failed at "
                              f"warmup ({e!r}); serving eagerly")
        if self.compute_dtype != "float32" and self.config.precision_probe:
            self.probe_precision()

    def _fresh_plan(self, node, in_shape, *, algorithm: str,
                    compute_dtype: str = "float32", groups: int = 1):
        """A freshly planned executor for one conv-family node at its real
        serving shape, on the server's device -- the shared oracle builder
        behind the precision probe and probation re-probes."""
        a = node.attrs
        param = lambda path: _compile._param(self.params, path)
        if node.op == "conv2d":
            return _plan.plan_conv2d(
                in_shape, param(a["w_path"]), stride=tuple(a["stride"]),
                padding=a["padding"], groups=groups, algorithm=algorithm,
                dtype=self._dtype, compute_dtype=compute_dtype,
                device=self.device)
        if node.op == "separable":
            return _plan.plan_separable_block(
                in_shape, param(a["dw_w"]), param(a["pw_w"]),
                stride=tuple(a["stride"]), padding=a["padding"],
                algorithm=algorithm, dtype=self._dtype,
                compute_dtype=compute_dtype, device=self.device)
        if node.op == "inverted_residual":
            return _plan.plan_inverted_residual(
                in_shape,
                param(a["exp_w"]) if a.get("exp_w") else None,
                param(a["dw_w"]), param(a["pw_w"]),
                stride=tuple(a["stride"]), padding=a["padding"],
                algorithm=algorithm, dtype=self._dtype,
                compute_dtype=compute_dtype, device=self.device)
        raise ValueError(f"no fresh-plan recipe for op {node.op!r}")

    def probe_precision(self, *, seed: int = 0) -> dict:
        """The reduced-precision accuracy probe: every conv layer currently
        serving a bf16/int8 transform-domain plan is checked against a
        freshly planned fp32 executor on a random input of the layer's real
        shape (relative max-abs error -- the same oracle shape as the
        reference's auto_tuned dtype gate), drawn on the host from
        np.random.default_rng(seed) as the reference draws it. A layer
        whose error exceeds its per-dtype budget (config.precision_budget,
        defaulting to plan.AUTOTUNE_ACCURACY_BUDGET) is promoted back to
        fp32 across EVERY bucket plan, counted in
        stats.precision_promotions. Returns
        {layer: {compute_dtype, rel_err, budget, promoted}}."""
        budget = dict(_plan.AUTOTUNE_ACCURACY_BUDGET,
                      **(self.config.precision_budget or {}))
        net = self.nets[self.buckets[0]]
        shapes = _compile.infer_shapes(net.graph, net.input_shape)
        rng = np.random.default_rng(seed)
        report: dict[str, dict] = {}
        for node in net.graph:
            p = net.plans.get(node.id)
            if p is None or node.op not in ("conv2d", "separable",
                                            "inverted_residual"):
                continue
            cd = p.describe().get("compute_dtype", "float32")
            if cd == "float32":
                continue
            in_shape = shapes[node.inputs[0]]
            x = self._to_device(
                np.asarray(rng.standard_normal(in_shape), np.float32))
            ref = self._fresh_plan(node, in_shape, algorithm="auto",
                                   groups=getattr(
                                       getattr(p, "spec", None), "groups", 1))
            with torch.inference_mode():
                y = p.apply(x).float().cpu().numpy()
                y0 = ref.apply(x).float().cpu().numpy()
            err = float(np.max(np.abs(y - y0))
                        / (float(np.max(np.abs(y0))) or 1.0))
            # block describes may join differing sub-plan dtypes with "+";
            # the tightest component budget judges the whole block.
            bud = min((budget.get(c, math.inf) for c in cd.split("+")),
                      default=math.inf)
            promoted = False
            if err > bud:
                try:
                    for n in self.nets.values():
                        n.replace_layer(node.id, self.params,
                                        algorithm=self._algorithm,
                                        compute_dtype="float32")
                    promoted = True
                    self.stats.inc("precision_promotions")
                    self._log(f"promoted layer {node.id!r} {cd} -> float32 "
                              f"(probe rel err {err:.3g} > budget {bud:g})")
                except Exception as e:
                    self._log(f"could not promote layer {node.id!r} to "
                              f"fp32: {e!r}")
            report[node.id] = {"compute_dtype": cd, "rel_err": err,
                               "budget": bud, "promoted": promoted}
        if any(r["promoted"] for r in report.values()):
            self._refresh_layer_dtypes()
        return report

    # ---- lifecycle -------------------------------------------------------

    def start(self, warmup: bool = True) -> "Server":
        if self._thread is not None:
            raise RuntimeError("server already started")
        if warmup:
            self.warmup()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-serve-scheduler")
        self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the scheduler. `drain=True` (default) serves everything
        already admitted first; `drain=False` cancels the queue."""
        with self._cv:
            self._stop = True
            self._draining = drain
            if not drain:
                for t in self._queue:
                    if t.cancel():
                        self.stats.inc("cancelled")
                self._queue.clear()
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=120)
            self._thread = None

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- admission -------------------------------------------------------

    def submit(self, x, *, deadline_s: float | None = None) -> Ticket:
        """Admit one example (shape `example_shape`). Raises QueueFullError
        (with retry_after_s) when the bounded queue is full."""
        x = np.asarray(x, self.np_dtype)
        if x.shape != self.example_shape:
            raise ValueError(f"expected example of shape "
                             f"{self.example_shape}, got {x.shape}")
        now = time.perf_counter()
        dl = (deadline_s if deadline_s is not None
              else self.config.default_deadline_s)
        deadline = now + dl if dl is not None else None
        with self._cv:
            if self._stop:
                raise RuntimeError("server is stopped")
            if len(self._queue) >= self.config.queue_capacity:
                self.stats.inc("rejected")
                raise QueueFullError(self._retry_after_locked(),
                                     self.config.queue_capacity)
            t = Ticket(next(self._rid), x, deadline, now)
            self._queue.append(t)
            self.stats.inc("admitted")
            self._cv.notify()
        return t

    def _retry_after_locked(self) -> float:
        est = self._service_ewma if self._service_ewma else 0.05
        waves = math.ceil((len(self._queue) + 1) / self.buckets[-1])
        return waves * est

    # ---- scheduling ------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _loop(self) -> None:
        cfg = self.config
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            prof = _obs_profile.active()   # ONE global read; None = off
            with self._cv:
                t_idle = (time.perf_counter() if prof is not None
                          and not self._queue and not self._stop else None)
                while not self._queue and not self._stop:
                    self._cv.wait(0.1)
                if t_idle is not None:
                    prof.tracer.add_span("serve.idle", t_idle,
                                         time.perf_counter())
                if self._stop and (not self._queue or not self._draining):
                    return
                # dynamic batch formation: let a burst coalesce into a
                # fuller bucket instead of dispatching singles.
                if (0 < len(self._queue) < self.buckets[-1]
                        and not self._stop and cfg.batch_wait_s > 0):
                    queued = len(self._queue)
                    t_wait = time.perf_counter() if prof is not None else None
                    woken = self._cv.wait(cfg.batch_wait_s)
                    if t_wait is not None:
                        prof.tracer.add_span(
                            "serve.coalesce", t_wait, time.perf_counter(),
                            queued=queued, woken=woken)
                now = time.perf_counter()
                live = []
                for t in self._queue:
                    if t.done():                    # client-side cancel
                        self.stats.inc("cancelled")
                    elif t.deadline is not None and t.deadline <= now:
                        # timeout-cancel while queued: never executed
                        t._finish("timeout", error=TimeoutError(
                            f"request {t.rid} deadline expired "
                            f"{now - t.deadline:.3f}s before dispatch"))
                        self.stats.inc("timed_out")
                    else:
                        live.append(t)
                # EDF: earliest deadline first, FIFO among deadline-less.
                live.sort(key=lambda t: (
                    t.deadline if t.deadline is not None else math.inf,
                    t.rid))
                take = min(len(live), self.buckets[-1])
                batch, self._queue = live[:take], live[take:]
                # queue-wait / batch-formation boundary for the profiler:
                # everything before this stamp is time spent queued,
                # everything until dispatch start is batch assembly.
                t_select = time.perf_counter()
            if batch:
                self._run_batch(batch, t_select)

    def _run_batch(self, batch: list[Ticket],
                   t_select: float | None = None) -> None:
        prof = _obs_profile.active()   # ONE global read; None = disabled
        b = self._bucket_for(len(batch))
        t_stack = time.perf_counter() if prof is not None else None
        X = np.zeros((b,) + self.example_shape, self.np_dtype)
        for i, t in enumerate(batch):
            X[i] = t.x
        t0 = time.perf_counter()
        if prof is not None:
            prof.tracer.add_span("serve.stack", t_stack, t0, bucket=b,
                                 batch=len(batch))
        fails_before = self.stats.executor_failures
        jit_before = self.stats.jit_dispatches
        try:
            with (prof.tracer.span("serve.copy_in", bucket=b)
                  if prof is not None else _obs_trace.NULL_SPAN):
                Xd = self._to_device(X)
            y, layer_times = self._dispatch(b, Xd)
        except Exception as e:
            # ladder exhausted: answer every ticket with the error --
            # failed, but never silently dropped.
            for t in batch:
                if t._finish("error", error=e):
                    self.stats.inc("failed")
            self.stats.inc("batches")
            if prof is not None:
                prof.serve_batch_error(bucket=b, batch=batch, error=e)
            return
        t1 = time.perf_counter()
        dt = t1 - t0
        a = self.config.ewma_alpha
        self._service_ewma = (dt if self._service_ewma is None
                              else (1 - a) * self._service_ewma + a * dt)
        self._observe_stragglers(b, dt, layer_times)
        y = y.cpu().numpy()
        now = time.perf_counter()
        for i, t in enumerate(batch):
            if t.deadline is not None and t.deadline < now:
                t.deadline_missed = True
                self.stats.inc("deadline_missed")
            if t._finish("ok", value=y[i]):
                self.stats.inc("completed")
        self.stats.inc("batches")
        self.stats.bump_bucket(b)
        if prof is not None:
            prof.serve_batch(
                bucket=b, batch=batch,
                t_select=t_select if t_select is not None else t0,
                t0=t0, t1=t1,
                jitted=self.stats.jit_dispatches > jit_before,
                sharded=b in self.sharded_nets)
        if self.stats.executor_failures == fails_before:
            self._note_clean_batch()

    # ---- dispatch: the graph-dispatch happy path --------------------------

    def _jitted_apply(self, bucket: int, X: torch.Tensor) -> torch.Tensor:
        """One batch through the bucket's captured forward (the
        reference's jitted apply). The callable is cached per bucket keyed
        on a plan-identity token (the network's id and generation, every
        bound plan's id), so swapping ANY bound plan (re-placement,
        recompile, fault injection) forces a re-capture -- a python-level
        fault proxy always executes at least once instead of being
        silently baked out of a stale graph. Returns a fresh tensor (the
        graph's static output is copied before the next replay). Prefers
        the mesh-sharded plan when the bucket has one."""
        net = self.sharded_nets.get(bucket) or self.nets[bucket]
        plans = tuple(net.plans.values())
        token = (id(net), net.generation, *map(id, plans))
        cached = self._jit.get(bucket)
        if cached is None or cached[0] != token:
            self._jit.pop(bucket, None)       # free the stale graph first
            cached = (token, self._capture(net, bucket), (net, plans))
            self._jit[bucket] = cached
        return cached[1](X)

    def _capture(self, net, bucket: int):
        """The bucket's forward as a callable X -> y. On the card: a CUDA
        graph of the hook-free `net.apply` over a static input buffer,
        captured on a side stream after one warm-up run on that stream
        (which builds and loads the kernel libraries and caches every
        transform matrix, so the capture itself allocates only from its
        graph's pool and never synchronizes). Capture errors are
        thread-local, so another thread's CUDA calls (probe_precision,
        replace_layer) cannot invalidate it, and a capture that raises is
        ended before the exception leaves, leaving no stream capturing. On
        the CPU: the eager apply under torch.inference_mode(). A sharded
        plan over a mesh of several cards also runs eagerly: its program
        spans their streams, which one capture cannot hold."""
        multi_card = net.is_sharded() and len(
            net.mesh.distinct_devices()) > 1
        if multi_card and not self._eager_sharded_logged:
            self._eager_sharded_logged = True
            self._log(f"bucket {bucket}: the sharded plan spans "
                      f"{len(net.mesh.distinct_devices())} cards; its "
                      f"happy path runs eagerly, not from a CUDA graph")
        if self.device.type != "cuda" or multi_card:
            def run_eager(X):
                with torch.inference_mode():
                    return net.apply(X)
            return run_eager
        static_x = torch.zeros((bucket,) + self.example_shape,
                               dtype=getattr(torch, net.dtype),
                               device=self.device)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.inference_mode():
            net.apply(static_x)
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                static_y = net.apply(static_x)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(side)

        def run_graph(X):
            with torch.inference_mode():
                static_x.copy_(X)
                graph.replay()
                return static_y.clone()
        return run_graph

    def _dispatch(self, bucket: int, X) -> tuple[Any, dict]:
        """Graph dispatch until the bucket's first fault, then the eager
        supervised path (per-layer hooks + the degrade ladder) for that
        bucket from then on. The graph-path failure (its capture or its
        replay) counts as the batch's first failure+retry: the batch is
        immediately retried eagerly, on the same device. The profiler,
        where active, times the replay (its own read: callers, the
        benchmark's fault injection among them, wrap `_dispatch(bucket,
        X)`)."""
        if self.config.jit_dispatch and bucket not in self._jit_broken:
            prof = _obs_profile.active()   # ONE global read; None = off
            try:
                with (prof.tracer.twin_span(
                        "serve.replay", self.device.type == "cuda",
                        bucket=bucket)
                      if prof is not None else _obs_trace.NULL_SPAN):
                    y = self._jitted_apply(bucket, X)
                self._sync()
                self.stats.inc("jit_dispatches")
                return y, {}
            except Exception as e:
                self._jit_broken.add(bucket)
                self.stats.inc("jit_fallbacks")
                self.stats.inc("executor_failures")
                self.stats.inc("retries")
                self._log(f"bucket {bucket}: graph dispatch fault ({e!r}); "
                          f"falling back to the eager supervised path")
        return self._supervised_apply(bucket, X)

    # ---- supervision: the degrade ladder ---------------------------------

    def _supervised_apply(self, bucket: int, X) -> tuple[Any, dict]:
        """Retry with backoff -> re-place the failing layer -> recompile in
        place. The batch re-runs after every rung, so in-flight requests
        survive each recoverable fault; raises only when the whole ladder
        is exhausted."""
        cfg = self.config
        backoff = Backoff(base=cfg.backoff_base_s, cap=cfg.backoff_cap_s,
                          seed=self.stats.batches)
        failures = 0
        while True:
            layer_times: dict[str, float] = {}
            try:
                with torch.inference_mode():
                    y = self.nets[bucket].apply(
                        X, layer_hook=layer_times.__setitem__,
                        annotate_errors=True)
                self._sync()
                return y, layer_times
            except Exception as e:
                failures += 1
                self.stats.inc("executor_failures")
                if failures <= cfg.max_retries:
                    self.stats.inc("retries")
                    time.sleep(backoff.next())
                    continue
                node = getattr(e, "node_id", None)
                if (node is not None and node not in self._replaced
                        and node in self.nets[bucket].plans
                        and self._replace_layer(
                            node, reason=f"executor failure: "
                                         f"{e.__cause__ or e!r}")):
                    failures = 0
                    backoff.reset()
                    continue
                if self._recompile_in_place():
                    failures = 0
                    backoff.reset()
                    continue
                raise

    def _replace_layer(self, node_id: str, *, reason: str = "",
                       count_eviction: bool = False) -> bool:
        """Rung 2: re-place one layer onto the fallback executor across
        EVERY bucket plan (a bad executor is bad at every batch size)."""
        alg = self.config.fallback_algorithm
        try:
            for net in self.nets.values():
                net.replace_layer(node_id, self.params, algorithm=alg)
        except Exception as e:
            self._log(f"could not re-place layer {node_id!r} onto "
                      f"{alg!r}: {e!r}")
            return False
        self._replaced.add(node_id)
        self.stats.inc("replacements")
        self._refresh_layer_dtypes()
        if count_eviction:
            self.stats.inc("evictions")
        if self.config.probation_batches > 0:
            win = self._probation_window.setdefault(
                node_id, self.config.probation_batches)
            self._probation[node_id] = {"clean": 0, "need": win}
        self._log(f"re-placed layer {node_id!r} onto {alg!r} ({reason})")
        return True

    # ---- probation: continuous re-placement ------------------------------

    def _note_clean_batch(self) -> None:
        """Count a fault-free batch towards every on-probation layer; when
        a layer's window fills, re-probe it for promotion."""
        if not self._probation:
            return
        for nid in list(self._probation):
            st = self._probation[nid]
            st["clean"] += 1
            if st["clean"] >= st["need"]:
                self._probe_and_promote(nid)

    def _probe_and_promote(self, node_id: str) -> bool:
        """Probation window expired: re-probe the evicted layer's original
        algorithm against the serving fallback plan on a random input of
        the layer's real shape. On parity (rel err <= probation_tol) the
        layer is promoted back onto the primary algorithm across EVERY
        bucket plan; on a failed probe the window doubles and probation
        restarts, so a persistently bad executor is re-probed ever more
        rarely instead of flapping."""
        cfg = self.config
        self.stats.inc("probation_reprobes")
        net = self.nets[self.buckets[0]]
        node = next(n for n in net.graph if n.id == node_id)
        shapes = _compile.infer_shapes(net.graph, net.input_shape)
        in_shape = shapes[node.inputs[0]]
        rng = np.random.default_rng(self.stats.batches)
        x = self._to_device(
            np.asarray(rng.standard_normal(in_shape), np.float32))
        err = math.inf
        try:
            cand = self._fresh_plan(node, in_shape,
                                    algorithm=self._algorithm)
            cur = net.plans[node_id]
            if hasattr(cand, "residual") and hasattr(cur, "residual"):
                cand.residual = cur.residual
            with torch.inference_mode():
                y = cand.apply(x).float().cpu().numpy()
                y0 = cur.apply(x).float().cpu().numpy()
            err = float(np.max(np.abs(y - y0))
                        / (float(np.max(np.abs(y0))) or 1.0))
            ok = err <= cfg.probation_tol
            if ok:
                for n in self.nets.values():
                    n.replace_layer(node_id, self.params,
                                    algorithm=self._algorithm)
        except Exception as e:
            self._log(f"probation re-probe of {node_id!r} raised {e!r}")
            ok = False
        if not ok:
            win = self._probation_window.get(
                node_id, cfg.probation_batches) * 2
            self._probation_window[node_id] = win
            self._probation[node_id] = {"clean": 0, "need": win}
            self._log(f"layer {node_id!r} failed its probation re-probe "
                      f"(rel err {err:.3g} > {cfg.probation_tol:g}); "
                      f"window doubled to {win} clean batches")
            return False
        self._replaced.discard(node_id)
        self._probation.pop(node_id, None)
        self._probation_window.pop(node_id, None)
        self._straggler_counts.pop(node_id, None)
        self.stats.inc("probation_promotions")
        self._refresh_layer_dtypes()
        self._log(f"promoted layer {node_id!r} back onto "
                  f"{self._algorithm!r} after probation "
                  f"(re-probe rel err {err:.3g})")
        return True

    def _recompile_in_place(self) -> bool:
        """Rung 3: rebuild every bucket plan from raw params, recording the
        per-array integrity findings of the on-disk artifacts (the
        corrupt-artifact fault class) and overwriting them with fresh
        ones. One shot per server lifetime -- a fault that survives a full
        recompile is not recoverable here."""
        if self._recompiled:
            return False
        self._recompiled = True
        corrupt = []
        for b in self.buckets:
            art = self._artifact_path(b)
            if art and os.path.exists(art):
                corrupt += [f"b{b}:{k}"
                            for k in _compile.verify_artifact(art)]
        if corrupt:
            self.stats.inc("corrupt_artifacts")
            self.stats.inc("corrupt_arrays", len(corrupt))
        for b in self.buckets:
            self.nets[b] = self._compile_bucket(b, force_cold=True)
        self._replaced.clear()
        self._straggler_counts.clear()
        self._probation.clear()
        self._probation_window.clear()
        self._jit_broken.clear()
        self._refresh_layer_dtypes()
        self.stats.inc("recompiles")
        self._log(f"recompiled all bucket plans in place "
                  f"({len(corrupt)} corrupt artifact arrays"
                  + (f", e.g. {corrupt[0]!r}" if corrupt else "") + ")")
        return True

    def _observe_stragglers(self, bucket: int, dt: float,
                            layer_times: dict[str, float]) -> None:
        cfg = self.config
        if self._batch_timer[bucket].record(dt):
            self.stats.inc("stragglers")
            worst, ratio = None, cfg.straggler_layer_ratio
            for nid, t in layer_times.items():
                base = self._layer_ewma.get((bucket, nid))
                if base and t / base >= ratio:
                    worst, ratio = nid, t / base
            if worst is not None:
                n = self._straggler_counts.get(worst, 0) + 1
                self._straggler_counts[worst] = n
                if (n >= cfg.straggler_evict_after
                        and worst not in self._replaced):
                    self._replace_layer(
                        worst, count_eviction=True,
                        reason=f"straggler x{n}, {ratio:.1f}x baseline")
            return
        # only non-straggler batches update the per-layer baselines
        # (mirrors StepTimer: outliers never pollute the window that
        # judges the next sample).
        a = cfg.ewma_alpha
        for nid, t in layer_times.items():
            k = (bucket, nid)
            old = self._layer_ewma.get(k)
            self._layer_ewma[k] = t if old is None else \
                (1 - a) * old + a * t


# ---------------------------------------------------------------------------
# CLI: artifact audit
# ---------------------------------------------------------------------------

def audit_artifact(path: str) -> list[tuple[str, str]]:
    """Per-array digest status of one NetworkPlan artifact: a list of
    (array_name, status) with status one of "ok", "corrupt" (digest
    mismatch), "missing" (named in the integrity header but absent from
    the file), or "unreadable" (the file / header itself is broken,
    reported as the pseudo-array "__header__"). Unlike
    `compile.verify_artifact` -- which only returns the offenders for the
    supervisor's corrupt-vs-bug decision -- this keeps the full roster so
    the CLI can show what was checked."""
    try:
        with np.load(path, allow_pickle=False) as data:
            if "__header__" not in data:
                return [("__header__", "unreadable")]
            header = json.loads(str(data["__header__"][()]))
            checksums = header.get("checksums")
            if not isinstance(checksums, dict):
                return [("__header__", "unreadable")]
            payload = {k for k in data.files if k != "__header__"}
            rows: list[tuple[str, str]] = []
            for name in sorted(set(checksums) | payload):
                if name not in payload:
                    rows.append((name, "missing"))
                elif checksums.get(name) is None:
                    rows.append((name, "corrupt"))
                elif _compile._array_digest(data[name]) \
                        == checksums[name]:
                    rows.append((name, "ok"))
                else:
                    rows.append((name, "corrupt"))
            return rows
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return [("__header__", "unreadable")]


def main(argv: Sequence[str] | None = None) -> int:
    """`python -m repro_torch.runtime.serve verify-artifacts <dir>`: audit
    every plan_b<B>.npz bucket artifact in a server artifact directory and
    print per-array digest status. Exit 0 when every array in every bucket
    verifies, 1 on any corruption, 2 on usage / empty directory."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.serve",
        description="Serving-runtime maintenance commands.")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_verify = sub.add_parser(
        "verify-artifacts",
        help="integrity-audit every plan_b<B>.npz in an artifact dir")
    p_verify.add_argument("dir", help="artifact directory (the "
                          "`artifact_dir` a Server was compiled against)")
    p_verify.add_argument("-q", "--quiet", action="store_true",
                          help="only print per-file summaries and failures")
    args = parser.parse_args(argv)

    if not os.path.isdir(args.dir):
        print(f"error: not a directory: {args.dir}")
        return 2
    paths = sorted(
        os.path.join(args.dir, f) for f in os.listdir(args.dir)
        if f.startswith("plan_b") and f.endswith(".npz"))
    if not paths:
        print(f"error: no plan_b<B>.npz artifacts under {args.dir}")
        return 2

    corrupt_total = 0
    for path in paths:
        rows = audit_artifact(path)
        bad = [(n, s) for n, s in rows if s != "ok"]
        corrupt_total += len(bad)
        verdict = "OK" if not bad else "CORRUPT"
        print(f"{os.path.basename(path)}: {verdict} "
              f"({len(rows) - len(bad)}/{len(rows)} arrays verified)")
        for name, status in rows:
            if status == "ok" and args.quiet:
                continue
            mark = "ok     " if status == "ok" else status.upper().ljust(7)
            print(f"  [{mark}] {name}")
    total = len(paths)
    print(f"{total} artifact(s) audited, "
          f"{corrupt_total} bad array(s)" if corrupt_total
          else f"{total} artifact(s) audited, all digests verified")
    return 1 if corrupt_total else 0


if __name__ == "__main__":
    raise SystemExit(main())
