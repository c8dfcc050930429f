"""Start-up: the benchmark's span around core.compile.compile (offline) or
around runtime.serve.Server's construction and start, which compile,
warm and capture every bucket (served)."""
NAME, UNIT = "setup.compile_s", "s"
LAYER = "start-up: core/compile.py:compile, Server.__init__ / start"
MOVES = "setup_s"


def read(rec):
    return rec["setup"]["compile_s"]
