"""Served: the median (nearest rank) over the same requests as
latency_p95_ms."""
from gpubench.traffic import percentile

NAME, UNIT, LAYER, MOVES = "latency_p50_ms", "ms", None, None


def read(rec):
    if rec["kind"] != "served":
        return None
    return 1e3 * percentile(rec["latency_s"], 50)
