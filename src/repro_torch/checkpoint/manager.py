"""Asynchronous checkpoints with atomic commits, in the JAX package's
layout (checkpoint/manager.py), so each package reads the other's files:

  <dir>/step_<k>.tmp/      -- in-flight write
  <dir>/step_<k>/          -- committed (atomic os.replace of the tmp dir)
      manifest.json        -- step, flat leaf keys, shapes / dtypes
      arrays.npz           -- one entry per leaf, under its key

A leaf's key is its path in the tree, as the reference writes it
(repro_torch.tree): "params/blocks/layer_0/mamba/in_proj", and for an
optimizer state "opt/.step", "opt/.m/embed". bf16 leaves are written as
the reference writes them, 2-byte voids under the manifest dtype
"bfloat16" (numpy has no bfloat16), and read back through their int16
bits, the reference's own files included.

* The host copy happens in `save` (consistency); the disk write runs on a
  thread (training continues; `wait()` joins and raises its error).
* keep_last bounds disk usage; partial (.tmp) dirs are ignored on
  restore, so a crash mid-write never corrupts the latest checkpoint.
* A placed tree (distributed/sharding.device_put) is gathered on the
  host into the same keys and dtypes, so either package reads a sharded
  run's checkpoint.
* `restore` casts each leaf to the dtype of its `like` leaf and places it:
  with `shardings`, by its NamedSharding over the mesh of now (elastic: a
  checkpoint written on one mesh restores onto another), else on a device
  (the CUDA device unless the caller passes one).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.plan import _from_artifact
from repro_torch.distributed.sharding import Placed
from repro_torch.kernels.runtime import resolve_device
from repro_torch.tree import tree_flatten_with_path, tree_map_with_path


def _host(leaf) -> tuple[np.ndarray, str]:
    """(the array written, the manifest dtype) of one leaf."""
    if isinstance(leaf, Placed):
        leaf = leaf.gather(torch.device("cpu"))
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        leaf = t.numpy()
    a = np.asarray(leaf)
    return a, str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = False):
        """Snapshot `tree` (tensors, numpy arrays or scalars) at `step`.
        Non-blocking by default: the host copy happens here, the disk
        write on a thread."""
        self.wait()
        flat, dtypes = {}, {}
        for key, leaf in tree_flatten_with_path(tree):
            flat[key], dtypes[key] = _host(leaf)

        def write():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                manifest = {"step": step,
                            "keys": sorted(flat),
                            "shapes": {k: list(v.shape)
                                       for k, v in flat.items()},
                            "dtypes": dtypes}
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                self._gc()
            except BaseException as e:  # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in self.steps()[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None,
                device=None) -> Any:
        """The checkpoint of `step` in the structure of `like` (a tree of
        tensors, "meta" ones included), each leaf cast to its like leaf's
        dtype and placed by its NamedSharding in `shardings` (a tree of
        like's structure), or without shardings on `device` (None means
        the CUDA device)."""
        if shardings is None:
            device = resolve_device(device)
        placements = dict(tree_flatten_with_path(shardings or {}))
        self.wait()
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}

        def leaf(key, like_leaf):
            if key not in flat:
                raise KeyError(f"checkpoint step {step} in {self.dir} has "
                               f"no leaf {key!r}")
            sharding = placements.get(key)
            t = _from_artifact(flat[key], device if sharding is None
                               else sharding.mesh.devices[0])
            if tuple(t.shape) != tuple(like_leaf.shape):
                raise ValueError(f"checkpoint leaf {key!r} has shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{tuple(like_leaf.shape)}")
            t = t.to(like_leaf.dtype)
            return t if sharding is None else Placed.split(t, sharding)

        return tree_map_with_path(leaf, like)
