"""The distribution context, as in the JAX package's distributed/context.py.

Model code stays mesh-agnostic by calling shard_activations(x, kind). In
the reference, when a mesh is active (set by the launcher), that applies a
`with_sharding_constraint` from the active rule set, and XLA moves the
activation to that layout. Here one process holds each data group's
activations whole on the device that computes them (launch/steps.py runs
one group after another), so there is no layout to move to: the
constraint is the identity. The rules and the guard are kept, so
`activation_spec` says which spec the reference would apply.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from repro_torch.distributed.sharding import P

_state = threading.local()


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over (the pod axis folds into
    data)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def default_activation_rules(mesh) -> dict[str, P]:
    """kind -> PartitionSpec for (B, S, D) activations."""
    ba = batch_axes(mesh)
    return {
        # residual stream: batch over the data axes, sequence over the
        # model axis (sequence parallelism)
        "residual": P(ba, "model", None),
        # decode-time activations (B, 1, D): batch only
        "decode": P(ba, None, None),
    }


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, rules if rules is not None
                  else default_activation_rules(mesh))
    try:
        yield
    finally:
        _state.ctx = prev


def active_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def activation_spec(shape: tuple, kind: str) -> Optional[P]:
    """The spec the active rules give an activation of `shape` and `kind`,
    or None: no active mesh, no rule for `kind`, or (the reference's guard)
    an axis that does not divide its dim."""
    ctx = getattr(_state, "ctx", None)
    if ctx is None:
        return None
    mesh, rules = ctx
    spec = rules.get(kind)
    if spec is None:
        return None
    sizes = dict(mesh.shape)
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        axs = ax if isinstance(ax, tuple) else (ax,)
        if dim % math.prod(sizes[a] for a in axs):
            return None
    return spec


def shard_activations(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x itself: each data group's activations live whole on the device
    that computes them (module docstring)."""
    return x
