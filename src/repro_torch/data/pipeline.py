"""Deterministic sharded synthetic data pipeline, a copy of the JAX
package's data/pipeline.py (numpy only): the same batches, bit for bit.

Batches are a pure function of (seed, step): restart-safe (a restore at step
k regenerates exactly the batch the failed run would have seen) and
host-shardable (each host materializes only its slice; here single-host, but
the slicing path is exercised). A background prefetch thread keeps
`prefetch_depth` batches ahead of the training loop.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.models.config import ArchConfig


class SyntheticLM:
    """Next-token LM batches with a learnable structure (token t+1 depends on
    token t modulo a small alphabet), so loss measurably decreases."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                 host_index: int = 0, host_count: int = 1):
        self.cfg = cfg
        self.global_batch = batch
        self.batch = batch // host_count
        self.host_index = host_index
        self.seq = seq
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed, step, self.host_index))
        vocab = self.cfg.vocab
        b, s = self.batch, self.seq
        # markov-ish stream: x[t+1] = (a * x[t] + drift) % K, lifted into vocab
        k = min(257, vocab)
        x0 = rng.integers(0, k, size=(b, 1))
        a = 1 + 2 * rng.integers(0, 3, size=(b, 1))
        toks = [x0]
        for _ in range(s):
            toks.append((a * toks[-1] + 17) % k)
        seqs = np.concatenate(toks, axis=1) % vocab
        out = {"tokens": seqs[:, :-1].astype(np.int32),
               "labels": seqs[:, 1:].astype(np.int32)}
        if self.cfg.encoder is not None:
            out["frames"] = rng.standard_normal(
                (b, self.cfg.encoder.n_ctx, self.cfg.d_model)).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(item)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
