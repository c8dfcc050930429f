"""Deterministic fault injection for the serving runtime.

Each fault class exercises one rung of repro_torch.runtime.serve's degrade
ladder, deterministically (call-count schedules, not randomness), so tests
and fault drills are reproducible:

  * `ExecutorRaise` -- a layer's executor raises (stands in for a kernel
    crash / numerical abort). Drives retry-with-backoff and, when
    permanent, the registry re-placement rung.
  * `LatencySpike` -- a layer sleeps before executing (straggler). Drives
    the StepTimer straggler counter and the eviction rung.
  * `flip_bit` -- flips one bit of one array inside a saved NetworkPlan
    .npz WITHOUT touching the recorded checksums: silent storage
    corruption, which load() must catch via the per-array sha256 digests
    and the serving layer must answer with recompile-in-place.
  * Queue overload has no injector: it is produced by submitting a burst
    past `queue_capacity`.

Faults install as a proxy around one bound LayerPlan (`install`). The
supervisor's re-placement and recompile rungs bind FRESH plan objects,
which drops the proxy -- exactly the semantics the degrade ladder assumes:
repair replaces the faulty executor. A new proxy also changes the server's
plan-identity token, so a bucket's captured CUDA graph is captured again
and the fault runs instead of a stale replay.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
from torch import nn


class InjectedExecutorError(RuntimeError):
    """Raised by an installed ExecutorRaise fault."""


@dataclass
class ExecutorRaise:
    """Raise InjectedExecutorError on calls [after, after + times)."""

    node_id: str
    times: int = 10**9          # default: permanent until repaired
    after: int = 0


@dataclass
class LatencySpike:
    """Sleep delay_s before executing on calls [after, after + times)."""

    node_id: str
    delay_s: float = 0.25
    times: int = 10**9
    after: int = 0


class FaultyPlan(nn.Module):
    """Proxy around one bound LayerPlan that consults a fault schedule on
    every apply() call; everything else delegates to the wrapped plan.

    A module whose one submodule is the wrapped plan, so the network's
    `.to()` and `state_dict` still reach the plan's buffers while the
    proxy is installed."""

    def __init__(self, inner: nn.Module, fault):
        super().__init__()
        self.inner = inner
        self._fault = fault
        self.calls = 0

    def apply(self, *args, **kwargs):
        i = self.calls
        self.calls += 1
        f = self._fault
        if f.after <= i < f.after + f.times:
            if isinstance(f, ExecutorRaise):
                raise InjectedExecutorError(
                    f"injected executor failure in layer {f.node_id!r} "
                    f"(call {i})")
            time.sleep(f.delay_s)
        return self.inner.apply(*args, **kwargs)

    def forward(self, *args, **kwargs):
        return self.apply(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(super().__getattr__("inner"), name)


def install(net, fault) -> FaultyPlan:
    """Wrap `net.plans[fault.node_id]` (a NetworkPlan's bound layer plan)
    in a FaultyPlan following the fault's schedule, through
    NetworkPlan.set_plan (which keeps the registered modules consistent
    and invalidates cached executables). Returns the proxy (its `calls`
    counter is the test observability hook)."""
    if fault.node_id not in net.plans:
        raise KeyError(f"{fault.node_id!r} is not a plan-bearing node; "
                       f"have {sorted(net.plans)}")
    proxy = FaultyPlan(net.plans[fault.node_id], fault)
    net.set_plan(fault.node_id, proxy)
    return proxy


def install_on_server(server, fault) -> list[FaultyPlan]:
    """Install the same fault on every bucket plan of a serve.Server (a
    faulty executor is faulty at every batch size)."""
    return [install(net, fault) for net in server.nets.values()]


def flip_bit(path: str, match: str = "plan:", *, byte: int = 0,
             bit: int = 0) -> str:
    """Silently corrupt a saved NetworkPlan artifact: flip one bit in the
    first array whose npz key contains `match`, re-writing the file with
    the ORIGINAL header (checksums untouched). Returns the corrupted
    array's key. NetworkPlan.load must now fail that array's sha256
    digest with ArtifactMismatchError."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    name = next((k for k in arrays
                 if k != "__header__" and match in k
                 and arrays[k].dtype.kind in "fiu"), None)
    if name is None:
        raise KeyError(f"no numeric array matching {match!r} in {path}")
    a = arrays[name]
    raw = bytearray(a.tobytes())
    raw[byte % len(raw)] ^= 1 << (bit % 8)
    arrays[name] = np.frombuffer(bytes(raw), a.dtype).reshape(a.shape)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return name
