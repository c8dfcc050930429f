"""Fault-tolerant training driver, as in the JAX package's launch/train.py,
on one device.

Wires together: the config registry, init on the device, the deterministic
data pipeline with prefetch, the train step (gradient accumulation +
AdamW), asynchronous checkpoints, preemption handling, straggler logging
and crash-retry from the last committed checkpoint. The reference's
`mesh=` becomes `device=` (None means the CUDA device); a mesh of more
than one device waits for the LM's meshes (ROADMAP.md queue 1 item 9).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \\
      --steps 50 --batch 8 --seq 64 --smoke --ckpt-dir /tmp/ckpt \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.runtime.fault import PreemptionGuard, StepTimer, run_with_retries


def _train_device(device, mesh) -> torch.device:
    """The one device training runs on: `device`, or the one device of
    `mesh` (launch/mesh.Mesh); None means the CUDA device."""
    if mesh is None:
        return resolve_device(device)
    devices = mesh.distinct_devices()
    if len(devices) > 1:
        raise NotImplementedError(
            f"training over a mesh of {len(devices)} devices waits for the "
            f"LM's meshes: ROADMAP.md queue 1 item 9")
    if device is not None and torch.device(device) != devices[0]:
        raise ValueError(f"device={device} and mesh on {devices[0]} differ")
    return devices[0]


def train(arch: str, *, steps: int, batch: int, seq: int, smoke: bool,
          ckpt_dir: str | None, ckpt_every: int = 50, accum: int = 1,
          lr: float = 3e-4, param_dtype=torch.float32, device=None,
          mesh=None, log_every: int = 10, max_failures: int = 3):
    """Train `arch` (its smoke config with `smoke`) for `steps` steps of
    `batch` sequences of `seq` tokens. With `ckpt_dir`, a checkpoint every
    `ckpt_every` steps, at the last step and on preemption, and a start
    from the latest one found there. Returns ((params, opt_state), the
    losses of the steps this call ran)."""
    device = _train_device(device, mesh)
    cfg = (cfglib.get_smoke_config(arch) if smoke else cfglib.get_config(arch))
    opt_cfg = adamw.AdamWConfig(lr=lr, total_steps=steps,
                                warmup_steps=max(steps // 20, 5))
    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    guard = PreemptionGuard()
    timer = StepTimer()
    pipeline = SyntheticLM(cfg, batch, seq)
    step_fn = make_train_step(cfg, opt_cfg, accum_steps=accum)
    history = []

    def body(_start):
        start = 0
        if manager and manager.latest_step() is not None:
            start = manager.latest_step()
            params_like = tf.abstract_params(cfg, param_dtype)
            restored = manager.restore(
                start, {"params": params_like,
                        "opt": adamw.init_state(params_like, opt_cfg)},
                device=device)
            params, opt_state = restored["params"], restored["opt"]
            print(f"[train] restored step {start} from {ckpt_dir}")
        else:
            params = tf.init_params(
                torch.Generator(device=device).manual_seed(0), cfg,
                param_dtype, device=device)
            opt_state = adamw.init_state(params, opt_cfg)

        it = Prefetcher(pipeline.iterate(start), depth=2)
        try:
            for step in range(start, steps):
                t0 = time.time()
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
    args = ap.parse_args()
    _, history = train(args.arch, steps=args.steps, batch=args.batch,
                       seq=args.seq, smoke=args.smoke, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, accum=args.accum,
                       lr=args.lr, device=args.device)
    print(f"[train] done. loss {history[0]:.3f} -> {history[-1]:.3f}")


if __name__ == "__main__":
    main()
