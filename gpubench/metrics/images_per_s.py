"""Offline: images whose logits came back in the window over the window's
seconds; the window ends with a synchronize, so queued work is waited for
and counted in the time."""
NAME, UNIT, LAYER, MOVES = "images_per_s", "images/s", None, None


def read(rec):
    if rec["kind"] != "offline":
        return None
    return rec["images"] / rec["window_s"]
