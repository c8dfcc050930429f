"""Fault-tolerant training loop, as in the JAX package's launch/train.py.

Wires together: the config registry, init, the deterministic data
pipeline with prefetch, the train step (gradient accumulation + AdamW),
asynchronous checkpoints, preemption handling, straggler logging and
crash-retry from the last committed checkpoint.

Two layouts. With `mesh=` (a ("data", "model") or ("pod", "data",
"model") mesh, launch/mesh.make_host_mesh), the reference's: params drawn
leaf by leaf and placed by sharding.param_shardings, AdamW's moments in
the same shardings (ZeRO), the sharded train step of launch/steps.py, and
restores placed by those shardings onto the mesh of now (elastic). With
`mesh=None`, everything on one device (`device=`; None means the CUDA
device).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \\
      --steps 50 --batch 8 --seq 64 --smoke --ckpt-dir /tmp/ckpt \\
      [--device cpu] [--model-parallel 2]
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.distributed import context as dist
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime.fault import PreemptionGuard, StepTimer, run_with_retries
from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                              tree_map_with_path)


def _check_mesh(mesh, device) -> None:
    """A mesh must have the axes the specs shard over."""
    if "model" not in mesh.axis_names or "data" not in mesh.axis_names:
        raise ValueError(
            f"train(mesh=) needs a ('data', 'model') or ('pod', 'data', "
            f"'model') mesh (launch.mesh.make_host_mesh); this one has axes "
            f"{mesh.axis_names}")
    if device is not None:
        raise ValueError("pass mesh= or device=, not both")


def _init_placed(cfg, param_dtype, shardings):
    """Params drawn on the mesh's first device (a seeded generator there)
    and placed leaf by leaf, each full leaf dropped once placed."""
    first = tree_leaves(shardings)[0].mesh.devices[0]
    params = tf.init_params(torch.Generator(device=first).manual_seed(0),
                            cfg, param_dtype, device=first)
    flat = dict(tree_flatten_with_path(params))
    del params

    def place(key, sharding):
        return shd.Placed.split(flat.pop(key), sharding)

    return tree_map_with_path(place, shardings)


def train(arch: str, *, steps: int, batch: int, seq: int, smoke: bool,
          ckpt_dir: str | None, ckpt_every: int = 50, accum: int = 1,
          lr: float = 3e-4, param_dtype=torch.float32, device=None,
          mesh=None, log_every: int = 10, max_failures: int = 3,
          config=None):
    """Train `arch` (its smoke config with `smoke`) for `steps` steps of
    `batch` sequences of `seq` tokens; `config`, an ArchConfig, is trained
    instead of the registry's (a variant of an arch, such as
    examples/torch/train_lm.py's ~100M qwen2.5). With `ckpt_dir`, a
    checkpoint every `ckpt_every` steps, at the last step and on
    preemption, and a start from the latest one found there. With `mesh`,
    the sharded layout of the module docstring. Returns ((params,
    opt_state), the losses of the steps this call ran)."""
    if mesh is None:
        device = resolve_device(device)
    else:
        _check_mesh(mesh, device)
    if config is not None:
        cfg = config
    else:
        cfg = (cfglib.get_smoke_config(arch) if smoke
               else cfglib.get_config(arch))
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=steps,
                                warmup_steps=max(steps // 20, 5))
    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    guard = PreemptionGuard()
    timer = StepTimer()
    pipeline = SyntheticLM(cfg, batch, seq)
    step_fn = make_train_step(cfg, opt_cfg, accum_steps=accum, mesh=mesh)
    params_like = tf.abstract_params(cfg, param_dtype)
    p_shard = None
    if mesh is not None:
        p_shard = shd.param_shardings(params_like, cfg, mesh)
        # moments inherit the param shardings (ZeRO), the step replicates
        o_shard = adamw.AdamWState(step=shd.NamedSharding(mesh, shd.P()),
                                   m=p_shard, v=p_shard)
    history = []

    def body(_start):
        start = 0
        if manager and manager.latest_step() is not None:
            start = manager.latest_step()
            like = {"params": params_like,
                    "opt": adamw.init_state(params_like, opt_cfg)}
            if mesh is None:
                restored = manager.restore(start, like, device=device)
            else:
                restored = manager.restore(
                    start, like, {"params": p_shard, "opt": o_shard})
                restored["opt"] = restored["opt"]._replace(
                    step=restored["opt"].step.gather())
            params, opt_state = restored["params"], restored["opt"]
            print(f"[train] restored step {start} from {ckpt_dir}")
        elif mesh is None:
            params = tf.init_params(
                torch.Generator(device=device).manual_seed(0), cfg,
                param_dtype, device=device)
            opt_state = adamw.init_state(params, opt_cfg)
        else:
            params = _init_placed(cfg, param_dtype, p_shard)
            opt_state = adamw.init_state(params, opt_cfg)

        it = Prefetcher(pipeline.iterate(start), depth=2)
        try:
            for step in range(start, steps):
                t0 = time.time()
                with dist.use_mesh(mesh) if mesh is not None \
                        else contextlib.nullcontext():
                    params, opt_state, metrics = step_fn(params, opt_state,
                                                         next(it))
                loss = float(metrics["loss"])
                dt = time.time() - t0
                straggle = timer.record(dt)
                history.append(loss)
                if step % log_every == 0 or step == steps - 1:
                    print(f"[train] step={step} loss={loss:.4f} "
                          f"gnorm={float(metrics['grad_norm']):.3f} "
                          f"lr={float(metrics['lr']):.2e} dt={dt*1e3:.0f}ms"
                          + (" STRAGGLER" if straggle else ""), flush=True)
                if np.isnan(loss):
                    raise FloatingPointError(f"NaN loss at step {step}")
                if manager and ((step + 1) % ckpt_every == 0
                                or step == steps - 1 or guard.requested):
                    manager.save(step + 1,
                                 {"params": params, "opt": opt_state})
                if guard.requested:
                    print("[train] preemption requested; checkpointed, "
                          "exiting cleanly")
                    break
        finally:
            it.close()
            if manager:
                manager.wait()
        return params, opt_state

    result = run_with_retries(
        body, max_failures=max_failures,
        on_failure=lambda e: print(f"[train] step loop failed ({e!r}); "
                                   f"restarting from last checkpoint"))
    return result, history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions")
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="train on make_host_mesh(N) over the CUDA cards "
                         "(over --device repeated 4 times with --device)")
    args = ap.parse_args()
    mesh, device = None, args.device
    if args.model_parallel is not None:
        mesh = make_host_mesh(args.model_parallel, devices=None if device
                              is None else [device] * 4)
        device = None
    _, history = train(args.arch, steps=args.steps, batch=args.batch,
                       seq=args.seq, smoke=args.smoke, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, accum=args.accum,
                       lr=args.lr, device=device, mesh=mesh)
    print(f"[train] done. loss {history[0]:.3f} -> {history[-1]:.3f}")


if __name__ == "__main__":
    main()
