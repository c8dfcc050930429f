"""Server batching: the program's serve.coalesce spans (the scheduler's
batch_wait_s wait for a fuller bucket, which the next arrival's notify
can end early) summed over the window and divided by the batches
dispatched (serve.dispatch spans), so a batch whose loop did not wait
adds 0. Nothing where the program records no scheduler spans
(serve.stack)."""
NAME, UNIT = "server.coalesce_ms", "ms"
LAYER = "runtime/serve.py:Server (admission, EDF batching, buckets)"
MOVES = "latency_p95_ms"


def read(rec):
    spans = rec.get("obs_spans", ())
    names = [n for n, _, _ in spans]
    batches = names.count("serve.dispatch")
    if not batches or "serve.stack" not in names:
        return None
    waits = sum(t1 - t0 for n, t0, t1 in spans if n == "serve.coalesce")
    return 1e3 * waits / batches
