"""Graph dispatch: the mean of the program's serve.copy_in spans (the
batch's pageable host-to-device copy, inside serve.dispatch), one per
batch, over the window."""
NAME, UNIT = "server.copy_in_ms", "ms"
LAYER = ("graph dispatch: Server._dispatch -> _jitted_apply "
         "(copy in, replay, sync)")
MOVES = "latency_p95_ms"


def read(rec):
    d = [t1 - t0 for n, t0, t1 in rec.get("obs_spans", ())
         if n == "serve.copy_in"]
    return 1e3 * sum(d) / len(d) if d else None
