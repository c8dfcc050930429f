"""The device in a served cell: the share of the traced window in which
the card is idle (devtrace's merge of the device events, as idle_gaps
reads it) and the idle gap's midpoint lies in none of the scheduler's
serve.* spans: idle, coalesce, batch formation and stack, dispatch,
copy-in, replay, respond. serve.queue_wait is left out: it is a
request's wait, which covers whatever the scheduler does meanwhile.
Nothing where the program records no scheduler spans (serve.stack)."""
import bisect

from gpubench import devtrace

NAME, UNIT, LAYER, MOVES = ("device_idle.serve.unspanned", "%", "device",
                            "latency_p95_ms")


def read(rec):
    events, spans = rec.get("device_events"), rec.get("obs_spans", ())
    if (rec["kind"] != "served" or not events
            or not any(n == "serve.stack" for n, _, _ in spans)):
        return None
    t0, t1 = rec["t_window"]
    named = sorted((sp for sp in spans if sp[0].startswith("serve.")
                    and sp[0] != "serve.queue_wait"), key=lambda sp: sp[1])
    cover = devtrace._merged(named, t0, t1)
    starts = [s for s, _ in cover]
    unspanned, cursor = 0.0, t0
    for s, e in devtrace._merged(events, t0, t1) + [(t1, t1)]:
        if s > cursor:
            mid = (cursor + s) / 2
            i = bisect.bisect_right(starts, mid) - 1
            if i < 0 or mid > cover[i][1]:
                unspanned += s - cursor
        cursor = max(cursor, e)
    return 100.0 * unspanned / (t1 - t0)
