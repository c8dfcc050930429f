"""Nested containers of tensors (dicts, lists, tuples, NamedTuples), as
`jax.tree` walks the JAX package's pytrees: map over trees of one
structure, list the leaves, flatten to path keys and rebuild, and carry a
tree of numpy arrays over as tensors.

Leaves come in jax's order: a dict's keys sorted, a sequence's items and a
NamedTuple's fields in order. A path key is the JAX package's checkpoint
key (checkpoint/manager.py): dict keys, sequence indices and, for a
NamedTuple field, "." + its name, joined by "/" ("opt/.m/embed").
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`, in a
    tree of tree's structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return (type(tree)(*items) if _is_namedtuple(tree)
                else type(tree)(items))
    return fn(tree, *rest)


def tree_flatten_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path key, leaf) pairs in jax's leaf order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [kv for k, v in items
            for kv in tree_flatten_with_path(v, f"{prefix}/{k}" if prefix
                                             else k)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves: list):
    """A tree of like's structure holding `leaves` in jax's leaf order."""
    it = iter(leaves)
    keyed = {k: next(it) for k, _ in tree_flatten_with_path(like)}
    return tree_map_with_path(lambda k, _: keyed[k], like)


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """fn(path key, leaf) over the leaves of `tree`."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, key(k)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, key(f".{f}"))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, key(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_from_numpy(tree, device: torch.device):
    """A tree of numpy arrays (the JAX package's leaves through np.asarray)
    as tensors on `device`: the same structure, shapes and dtypes. bf16
    leaves arrive as ml_dtypes.bfloat16, which torch cannot take; they go
    through fp32 and are cast back."""
    def convert(v):
        v = np.array(v)                  # a writable copy
        if v.dtype.name == "bfloat16":
            return torch.as_tensor(v.astype(np.float32),
                                   device=device).to(torch.bfloat16)
        return torch.as_tensor(v, device=device)
    return tree_map(convert, tree)
