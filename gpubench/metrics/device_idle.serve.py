"""The device in a served cell: the share of the traced window, from the
first request's due time to the last answer, in which no kernel, copy or
fill ran on the card."""
NAME, UNIT, LAYER, MOVES = ("device_idle.serve", "%", "device",
                            "latency_p95_ms")


def read(rec):
    if rec["kind"] != "served" or rec.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
