"""Zero-dependency observability for the planned-convolution stack: the JAX
package's `repro.obs`, for the port.

- `repro_torch.obs.trace`   -- thread-safe nested span recorder
  (ring-buffered, explicit monotonic timestamps) exportable as
  chrome://tracing JSON.
- `repro_torch.obs.metrics` -- process-level registry of counters / gauges /
  log-bucketed histograms with an atomic deep-copied snapshot. The serving
  runtime's ServerStats counters are views over one of these registries.
- `repro_torch.obs.profile` -- the Profiler that wires both through the
  serve hot path (per-request queue-wait / batch-formation / dispatch /
  respond spans, the scheduler loop's waits, copy-in and replay) and the
  graph walk (a host span and a device-timed `gpu:` twin per node of
  NetworkPlan.apply); compile() reports its pass phases through the
  global tracer directly.

- `repro_torch.obs.tuningdb` -- the fleet tuning database: exports the
  measured auto_tuned evidence of artifacts and NetworkPlans, merges and
  installs it, so plan_conv2d adopts recorded winners with no race.
- `repro_torch.obs.regress` -- tracked-metric extraction and the
  regression compare over BENCH_*.json / repro.observe/v1 documents, with
  its CLI (`python -m repro_torch.obs.regress`).

Everything here is disabled by default and imports only the standard
library; the disabled fast path of every hook is a single global None
check.
"""

from repro_torch.obs import metrics, trace  # noqa: F401  (stdlib-only)

__all__ = ["trace", "metrics", "profile"]
