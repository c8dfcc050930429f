"""Set-up: process start (the first line of run.py, before torch is
imported) to the window's first timed request or call: imports, the CUDA
context, weights, compile, warm-up, capture."""
NAME, UNIT, LAYER, MOVES = "setup_s", "s", None, None


def read(rec):
    return rec["setup_s"]
