"""The eager graph walk: host milliseconds to issue one
NetworkPlan.apply on an idle card (a synchronize before each call, none
inside it), the median of a few calls after the traced window."""
import statistics

NAME, UNIT = "apply.host_ms", "ms"
LAYER = "core/compile.py:NetworkPlan.apply eager graph walk (host)"
MOVES = "images_per_s"


def read(rec):
    t = rec.get("apply_host_s")
    return 1e3 * statistics.median(t) if t else None
