"""Server batching: images served over the rows dispatched, padding
included, from the program's counters `completed` and `bucket_batches`
over the window."""
NAME, UNIT = "server.batch_fill", "%"
LAYER = "runtime/serve.py:Server (admission, EDF batching, buckets)"
MOVES = "latency_p95_ms"


def read(rec):
    if rec["kind"] != "served":
        return None
    rows = sum(int(b) * n for b, n in rec["stats"]["bucket_batches"].items())
    return 100.0 * rec["stats"]["completed"] / rows if rows else None
