"""Fleet-shareable tuning database over auto_tuned measurement evidence:
the JAX package's obs/tuningdb.py, for the port. Both packages write the
same keys for the same layer (core/plan.py:tuning_db_key), so a database
one exports installs in the other.

The measured auto_tuned race (core/plan.py:_measure_autotune) already
persists its per-contender evidence into every NetworkPlan artifact, so a
warm artifact load never re-measures -- but a *different* network, batch
bucket, or host that plans the same layer shape starts the race from
scratch. This module closes that gap (the ROADMAP "artifact-level
autotuning" item): it walks artifacts (or live NetworkPlans), lifts each
measured decision into a standalone JSON database keyed by the layer's
planning identity, merges databases from many hosts (fastest winner
wins), and installs the result into `core/plan.py` so `plan_conv2d`
resolves `algorithm="auto_tuned"` layers with ZERO measurements --
adopting the recorded winner/tile/dtype with the original evidence
attached (decision still reports "measured"; the evidence gains a
`source: tuning_db` marker).

Consumption paths, warmest first:

    tuningdb.install("fleet.json")            # explicit, this process
    REPRO_TUNING_DB=fleet.json python ...     # env var, any process

Database shape (JSON):

    {"format": "repro.tuning_db", "version": 1,
     "hosts": [{"node": ..., "machine": ..., "entries": N}, ...],
     "entries": {<layer key>: {"winner": ..., "winner_label": ...,
                               "winner_dtype": ..., "winner_tile": ...,
                               "winner_time_s": ..., "evidence": [[k,v]..]}}}

The layer key is `repro_torch.core.plan.tuning_db_key(...)` -- shapes,
dtype, stride, padding, groups, layout, and the compute_dtype *request*
("auto" when the race fielded reduced-precision contenders), exactly the
inputs that decide a fresh race. Entries recorded by builds predating the
`pin_dtype`/`dtype_race` evidence keys key themselves conservatively
(pinned float32).
"""

from __future__ import annotations

import json
import os
import platform
import time
from typing import Any, Iterable, Iterator

__all__ = ["FORMAT", "VERSION", "collect", "export", "merge", "load",
           "save", "install", "clear"]

FORMAT = "repro.tuning_db"
VERSION = 1


# ---------------------------------------------------------------------------
# Collection: artifacts / NetworkPlans -> entries
# ---------------------------------------------------------------------------

def _iter_conv_metas(obj: Any) -> Iterator[dict]:
    """Every conv2d plan meta nested anywhere in a header/meta structure
    (separable dw/pw, inverted-residual expand/sep, conv1d inner/subplans
    all carry conv2d metas in nested dicts/lists)."""
    if isinstance(obj, dict):
        if obj.get("kind") == "conv2d":
            yield obj
        for v in obj.values():
            yield from _iter_conv_metas(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _iter_conv_metas(v)


def _entry_from_meta(meta: dict) -> tuple[str, dict] | None:
    """(key, entry) for one conv meta, or None when it carries no measured
    auto_tuned evidence."""
    if meta.get("requested") != "auto_tuned" or not meta.get("autotune"):
        return None
    ev = {k: v for k, v in meta["autotune"]}
    if "winner" not in ev:
        return None
    from repro_torch.core import plan as _plan
    request = "auto" if ev.get("dtype_race") else \
        str(ev.get("pin_dtype", "float32"))
    req_tile = ev.get("req_tile")
    key = _plan.tuning_db_key(
        meta["x_shape"], meta["w_shape"], meta["dtype"], meta["stride"],
        meta["padding"], meta["groups"], meta.get("layout", "NHWC"),
        request, req_tile)
    label = ev.get("winner_label")
    t_win = ev.get(f"t_{label}_s") if label else None
    tile = ev.get("winner_tile")
    entry = {
        "winner": ev["winner"],
        "winner_label": label,
        "winner_dtype": str(ev.get("winner_dtype", "float32")),
        "winner_tile": list(tile) if tile is not None else None,
        "winner_time_s": float(t_win) if t_win is not None else None,
        "evidence": [[k, (list(v) if isinstance(v, tuple) else v)]
                     for k, v in meta["autotune"]],
    }
    return key, entry


def _header_of_artifact(path: str) -> dict:
    import numpy as np
    with np.load(path, allow_pickle=False) as data:
        if "__header__" not in data:
            raise ValueError(f"{path}: not a NetworkPlan artifact "
                             f"(no __header__)")
        return json.loads(str(data["__header__"][()]))


def collect(source: Any) -> dict[str, dict]:
    """Entries from one source: an artifact path (.npz), a directory of
    artifacts, a live NetworkPlan, or an already-loaded header dict."""
    metas: Iterable[dict]
    if isinstance(source, str):
        if os.path.isdir(source):
            out: dict[str, dict] = {}
            for name in sorted(os.listdir(source)):
                if name.endswith(".npz"):
                    out.update(collect(os.path.join(source, name)))
            return out
        metas = _iter_conv_metas(_header_of_artifact(source))
    elif isinstance(source, dict):
        metas = _iter_conv_metas(source)
    else:
        # a live NetworkPlan: serialize plan metas without touching arrays
        metas = _iter_conv_metas(
            [plan.to_artifact()[0] for plan in source.plans.values()])
    out = {}
    for meta in metas:
        kv = _entry_from_meta(meta)
        if kv is not None:
            key, entry = kv
            prev = out.get(key)
            if prev is None or _faster(entry, prev):
                out[key] = entry
    return out


def _faster(a: dict, b: dict) -> bool:
    ta, tb = a.get("winner_time_s"), b.get("winner_time_s")
    if ta is None:
        return False
    return tb is None or ta < tb


# ---------------------------------------------------------------------------
# Databases: export / merge / save / load
# ---------------------------------------------------------------------------

def _host() -> dict:
    return {"node": platform.node(), "machine": platform.machine(),
            "system": platform.system(),
            "python": platform.python_version(),
            "exported_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime())}


def export(sources: Any, path: str | None = None) -> dict:
    """Build a database document from one source or a list of sources
    (artifact paths / dirs / NetworkPlans); optionally write it."""
    if not isinstance(sources, (list, tuple)):
        sources = [sources]
    entries: dict[str, dict] = {}
    for src in sources:
        for key, entry in collect(src).items():
            prev = entries.get(key)
            if prev is None or _faster(entry, prev):
                entries[key] = entry
    doc = {"format": FORMAT, "version": VERSION,
           "hosts": [dict(_host(), entries=len(entries))],
           "entries": entries}
    if path is not None:
        save(doc, path)
    return doc


def merge(*docs: dict) -> dict:
    """Fleet merge: union of entries, conflicts resolved to the entry with
    the fastest recorded winner time; host provenance concatenates."""
    entries: dict[str, dict] = {}
    hosts: list[dict] = []
    for doc in docs:
        _check(doc)
        hosts.extend(doc.get("hosts", []))
        for key, entry in doc["entries"].items():
            prev = entries.get(key)
            if prev is None or _faster(entry, prev):
                entries[key] = entry
    return {"format": FORMAT, "version": VERSION, "hosts": hosts,
            "entries": entries}


def _check(doc: dict) -> None:
    if doc.get("format") != FORMAT:
        raise ValueError(f"not a tuning database (format="
                         f"{doc.get('format')!r}, expected {FORMAT!r})")
    if doc.get("version", 0) > VERSION:
        raise ValueError(f"tuning database version {doc.get('version')} "
                         f"is newer than this reader ({VERSION})")


def save(doc: dict, path: str) -> None:
    _check(doc)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def load(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    _check(doc)
    return doc


# ---------------------------------------------------------------------------
# Installation: make plan_conv2d consume the database
# ---------------------------------------------------------------------------

def install(db: dict | str) -> int:
    """Install a database (document or path) into core/plan.py; returns
    the number of entries now consulted before any autotune measurement."""
    if isinstance(db, str):
        db = load(db)
    _check(db)
    from repro_torch.core import plan as _plan
    _plan.set_tuning_db(db["entries"])
    return len(db["entries"])


def clear() -> None:
    from repro_torch.core import plan as _plan
    _plan.set_tuning_db(None)
