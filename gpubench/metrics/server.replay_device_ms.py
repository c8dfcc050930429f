"""Graph dispatch: the mean device time of a batch's CUDA-graph replay,
the program's gpu:serve.replay spans (two timing events around
_jitted_apply on the card's stream: the input copy into the graph's
buffer, the replay, the output's clone), one per batch, over the
window."""
NAME, UNIT = "server.replay_device_ms", "ms"
LAYER = ("graph dispatch: Server._dispatch -> _jitted_apply "
         "(copy in, replay, sync)")
MOVES = "latency_p95_ms"


def read(rec):
    d = [t1 - t0 for n, t0, t1 in rec.get("obs_spans", ())
         if n == "gpu:serve.replay"]
    return 1e3 * sum(d) / len(d) if d else None
