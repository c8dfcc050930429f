"""Served: the 95th percentile (nearest rank) over every request due in the
window, from its due time to its answer; a refused or unanswered request
counts as infinitely late."""
from gpubench.traffic import percentile

NAME, UNIT, LAYER, MOVES = "latency_p95_ms", "ms", None, None


def read(rec):
    if rec["kind"] != "served":
        return None
    return 1e3 * percentile(rec["latency_s"], 95)
