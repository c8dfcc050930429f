"""The device in an offline cell: the share of the traced window in which
no kernel, copy or fill ran on the card."""
NAME, UNIT, LAYER, MOVES = "device_idle.offline", "%", "device", "images_per_s"


def read(rec):
    if rec["kind"] != "offline" or rec.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
