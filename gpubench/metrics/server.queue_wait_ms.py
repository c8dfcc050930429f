"""Server admission and batching: the median of the program's
serve.queue_wait spans (submit to batch selection) over the window."""
import statistics

NAME, UNIT = "server.queue_wait_ms", "ms"
LAYER = "runtime/serve.py:Server (admission, EDF batching, buckets)"
MOVES = "latency_p95_ms"


def read(rec):
    waits = [t1 - t0 for n, t0, t1 in rec.get("obs_spans", ())
             if n == "serve.queue_wait"]
    return 1e3 * statistics.median(waits) if waits else None
