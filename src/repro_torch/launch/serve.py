"""Batched LM serving driver: a continuous-batching prefill + decode loop,
as in the JAX package's launch/serve.py.

Requests enter a queue; the scheduler packs up to `max_batch` active
sequences, prefills new arrivals into the shared cache and steps decode
for all active slots each tick. The slot lifecycle (free -> prefill ->
decode -> done) runs on the host; the device work is the decode step
(launch/steps.make_serve_step), eager.

The reference's semantics are kept exactly, so the two servers emit the
same tokens: an fp32 cache; prefill one token at a time through the
decode step for the whole batch, token 0 in the other slots (which
advances their caches too); one shared cache_pos, the largest slot
position, per tick (a slot behind it attends to rows written at that
position); greedy argmax decoding; a request completes at max_new
tokens or at position max_len - 1.

With `mesh=` (launch/mesh.make_host_mesh), the server runs its steps
under distributed/context.use_mesh, as the tensor-parallel program of
models/transformer.py: it places whole params by param_shardings (placed
ones are taken as they are) and holds its decode cache placed by
cache_specs, so each data group's model positions compute their heads,
ffn columns, channels and vocab rows and read and write their part of
the cache; the logits come back to the mesh's first position. main()
serves under make_host_mesh() over the cards present, as the
reference's does.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b \\
      --smoke --requests 12 --max-batch 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.distributed import context as dist
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as tf


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,)
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


class Server:
    """Continuous batching over `max_batch` slots of an fp32 decode cache
    of `max_len` rows, on `device` (None means the CUDA device), where the
    params must already be; with `mesh`, over the mesh under use_mesh, the
    params whole on its first position (placed by param_shardings here)
    or placed over the mesh, the cache placed by cache_specs."""

    def __init__(self, cfg, params, *, max_batch: int = 4,
                 max_len: int = 256, device=None, mesh=None):
        if mesh is not None:
            if device is not None:
                raise ValueError("pass mesh= or device=, not both")
            device = mesh.devices[0]
        self.mesh = mesh
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"the params are on {params['embed'].device}, "
                             f"the server on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.serve_step = make_serve_step(cfg)
        self.cache = tf.init_decode_cache(cfg, max_batch, max_len,
                                          torch.float32, device=self.device)
        if mesh is not None:
            if not isinstance(params["embed"], shd.Placed):
                self.params = shd.device_put(params, shd.param_shardings(
                    params, cfg, mesh))
            self.cache = shd.device_put(self.cache, shd.sharding_tree(
                shd.cache_specs(self.cache, cfg, mesh), mesh))
        self.slots: list[Request | None] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int32)

    def _step(self, tokens: np.ndarray, pos: int) -> torch.Tensor:
        with (dist.use_mesh(self.mesh) if self.mesh is not None
              else contextlib.nullcontext()):
            logits, self.cache = self.serve_step(
                self.params, self.cache,
                torch.as_tensor(tokens, device=self.device).long(), pos)
        return logits

    def _prefill_into_slot(self, slot: int, req: Request):
        """Prefill one request through the decode step, a token at a time
        (the reference's warm start with one compiled program)."""
        for tok in req.prompt:
            tokens = np.zeros((self.max_batch, 1), np.int64)
            tokens[slot, 0] = tok
            self._step(tokens, int(self.pos[slot]))
            self.pos[slot] += 1
        self.slots[slot] = req

    def run(self, requests: list[Request]):
        """Serve `requests` to completion, greedily: (completed in
        finishing order, decode ticks). The reference's sampled branch
        (greedy=False) raises on its own fp32 probabilities, which
        numpy's choice finds not to sum to 1, and is not ported."""
        pending = list(requests)
        completed = []
        ticks = 0
        while pending or any(s is not None for s in self.slots):
            # admit
            for i in range(self.max_batch):
                if self.slots[i] is None and pending:
                    req = pending.pop(0)
                    self.pos[i] = 0
                    self._prefill_into_slot(i, req)
            # decode one token for every active slot
            tokens = np.zeros((self.max_batch, 1), np.int64)
            for i, req in enumerate(self.slots):
                if req is not None:
                    tokens[i, 0] = req.out[-1] if req.out else req.prompt[-1]
            # one shared cache_pos: slots decode in lockstep off the max
            logits = self._step(tokens, int(self.pos.max()))
            ticks += 1
            choice = logits.argmax(dim=-1).cpu().numpy()
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                req.out.append(int(choice[i]))
                self.pos[i] += 1
                if len(req.out) >= req.max_new or \
                        self.pos[i] >= self.max_len - 1:
                    req.done = True
                    completed.append(req)
                    self.slots[i] = None
        return completed, ticks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    if cfg.encoder is not None:
        raise SystemExit("the serve driver targets decoder-only archs; "
                         "whisper decodes through models.transformer's "
                         "prefill(frames=) and decode_step")
    mesh = make_host_mesh(devices=None if args.device is None
                          else [args.device])
    device = mesh.devices[0]
    params = tf.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, torch.float32, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=(4,)),
                    max_new=args.max_new)
            for i in range(args.requests)]
    srv = Server(cfg, params, max_batch=args.max_batch, mesh=mesh)
    t0 = time.time()
    done, ticks = srv.run(reqs)
    dt = time.time() - t0
    tok = sum(len(r.out) for r in done)
    print(f"[serve] {cfg.name} on {device}: {len(done)} requests, {tok} "
          f"tokens in {dt:.2f}s ({tok / dt:.1f} tok/s, {ticks} decode "
          f"ticks)")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt={r.prompt.tolist()} -> {r.out[:8]}")


if __name__ == "__main__":
    main()
