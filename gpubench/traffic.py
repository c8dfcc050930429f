"""The one traffic generator: it reads a mix's parameters
(`traffic/<mix>.json`) and turns them into the work of one run.

Two kinds of mix:

  * "offline": back-to-back batches of `batch` images, drawn in turn from a
    pool of `pool_batches` batches made on the card at set-up.
  * "served": an open loop of single-image requests. Arrival instants form
    a Poisson-like process at `image_rate_per_s` / (mean burst size);
    each instant carries a burst of `burst_min`..`burst_max` requests (1..1
    is plain Poisson), all due at that instant. Each request names an image
    of a host pool of `pool_images` images.

Every seed gets the same work in another order: the gaps between instants
are the quantiles of the exponential distribution, the burst sizes cycle
through burst_min..burst_max, and the seed permutes both, so the count of
requests, their sizes and the mean rate do not move with the seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Due times (seconds from the window's start), one per request,
    sorted, with the pool image each request sends."""

    due_s: np.ndarray
    image: np.ndarray

    def __len__(self) -> int:
        return len(self.due_s)


def served_schedule(mix: dict, seed: int, seconds: float,
                    image_rate_per_s: float | None = None) -> Schedule:
    """The requests due in a window of `seconds` (see the module
    docstring); `image_rate_per_s` overrides the mix's rate (the sweep)."""
    rate = image_rate_per_s or mix["image_rate_per_s"]
    lo, hi = mix["burst_min"], mix["burst_max"]
    mean_burst = (lo + hi) / 2
    n = max(1, round(rate / mean_burst * seconds))
    rng = np.random.default_rng(seed)
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q))
    gaps *= seconds / gaps.sum()
    starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    sizes = rng.permutation(lo + np.arange(n) % (hi - lo + 1))
    due = np.repeat(starts, sizes)
    image = rng.integers(0, mix["pool_images"], size=len(due))
    return Schedule(due, image)


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) over all values;
    inf (a request refused or never answered) sorts last."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if len(v) == 0:
        raise ValueError("no values")
    rank = int(np.ceil(q / 100 * len(v))) - 1
    return float(v[min(max(rank, 0), len(v) - 1)])
