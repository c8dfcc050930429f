"""The readers of the program's scheduler and dispatch spans on synthetic
records: what each reads, and that each reads nothing from a program
that records no such span (the parent of the change that added them)."""

import pytest

from gpubench import harness


def _served(spans, events=None, window=(0.0, 1.0)):
    return {"kind": "served", "obs_spans": spans, "t_window": window,
            "window_s": window[1] - window[0],
            "device_events": events or []}


def _batch(t, replay_ms=5.0, coalesce_ms=None):
    """One batch's spans starting at t (seconds): an optional coalesce
    wait, formation with stacking, dispatch with copy-in and replay,
    respond."""
    out = []
    if coalesce_ms is not None:
        out.append(("serve.coalesce", t, t + coalesce_ms * 1e-3))
        t += coalesce_ms * 1e-3
    out += [("serve.queue_wait", t - 0.004, t),
            ("serve.batch_formation", t, t + 0.001),
            ("serve.stack", t + 0.0002, t + 0.001),
            ("serve.dispatch", t + 0.001, t + 0.009),
            ("serve.copy_in", t + 0.001, t + 0.0015),
            ("serve.replay", t + 0.0015, t + 0.002),
            ("gpu:serve.replay", t + 0.0016, t + 0.0016 + replay_ms * 1e-3),
            ("serve.respond", t + 0.009, t + 0.0095)]
    return out


def read(name, rec):
    return harness.load_metric(name).read(rec)


def test_scheduler_and_dispatch_readers():
    spans = (_batch(0.0, 5.0, coalesce_ms=2.0) + _batch(0.1, 6.0)
             + _batch(0.2, 7.0, coalesce_ms=1.0))
    rec = _served(spans)
    assert read("server.coalesce_ms", rec) == pytest.approx(1.0)
    assert read("server.copy_in_ms", rec) == pytest.approx(0.5)
    assert read("server.replay_device_ms", rec) == pytest.approx(6.0)


def test_readers_read_nothing_without_the_programs_spans():
    old = [sp for sp in _batch(0.0) if sp[0] in (
        "serve.queue_wait", "serve.batch_formation", "serve.dispatch",
        "serve.respond")]
    rec = _served(old, events=[("k", 0.0, 0.5)])
    for name in ("server.coalesce_ms", "server.copy_in_ms",
                 "server.replay_device_ms", "device_idle.serve.unspanned"):
        assert read(name, rec) is None, name
    assert read("server.dispatch_ms", rec) == pytest.approx(8.0)


def test_unspanned_idle_counts_gaps_outside_the_schedulers_spans():
    """Window [0, 1]: the card is busy on [0.1, 0.2] and [0.5, 0.6]. The
    gap [0, 0.1] lies in serve.idle; [0.2, 0.5] has its midpoint 0.35 in
    no scheduler span (a request's queue wait does not count); [0.6, 1.0]
    has its midpoint 0.8 in a respond span."""
    spans = [("serve.idle", 0.0, 0.1), ("serve.stack", 0.1, 0.11),
             ("serve.queue_wait", 0.2, 0.5),
             ("gpu:serve.replay", 0.3, 0.4),
             ("serve.respond", 0.75, 0.85)]
    events = [("k1", 0.1, 0.2), ("k2", 0.5, 0.55), ("k3", 0.54, 0.6)]
    rec = _served(spans, events)
    assert read("device_idle.serve.unspanned", rec) == pytest.approx(30.0)
    assert read("device_idle.serve.unspanned",
                dict(rec, kind="offline")) is None
    # every gap inside a span: nothing unspanned
    rec = _served(spans + [("serve.coalesce", 0.3, 0.4)], events)
    assert read("device_idle.serve.unspanned", rec) == pytest.approx(0.0)
