"""Conv-network partition primitives (sharded NetworkPlan execution).

NHWC activations partitioned over a 1-D ("data",) mesh axis, on the batch
dim (data parallel) or on H (spatial halo partitioning). The JAX package
runs its primitives inside a `shard_map` body, where each sees its own
shard and talks to its neighbors through collectives (`ppermute`,
`all_gather`). Here one process holds every shard: a sharded activation is
a list of tensors, one per mesh position, each on its position's device,
and the collectives are copies (`.to(device, non_blocking=True)`, skipped
where the tensor already lives on the device it goes to).

The JAX package's module also holds the LM's parameter, optimizer and cache
partition specs (its lines 26-187); they wait for the LM stack (ROADMAP.md
queue 1 item 9).
"""

from __future__ import annotations

from typing import Sequence

import torch


def data_axis_name(mesh) -> str:
    """The batch/spatial partition axis: "data" if present, else axis 0."""
    return "data" if "data" in mesh.axis_names else mesh.axis_names[0]


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x if x.device == device else x.to(device, non_blocking=True)


def halo_exchange(shards: Sequence[torch.Tensor],
                  halo: int) -> list[torch.Tensor]:
    """Each shard grown by its neighbors' `halo` boundary rows (axis 1,
    NHWC H) on each side. The edge shards receive zeros, which is exactly
    SAME zero padding -- so a VALID conv over an exchanged strip reproduces
    the unsharded SAME conv's rows owned by that shard."""
    if halo == 0:
        return list(shards)
    out = []
    last = len(shards) - 1
    for i, x in enumerate(shards):
        edge = x.new_zeros((x.shape[0], halo) + tuple(x.shape[2:]))
        up = _to(shards[i - 1][:, -halo:], x.device) if i > 0 else edge
        dn = _to(shards[i + 1][:, :halo], x.device) if i < last else edge
        out.append(torch.cat([up, x, dn], dim=1))
    return out


def gather_rows(shards: Sequence[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """Reassemble the full H from row shards, on `device`."""
    return torch.cat([_to(s, device) for s in shards], dim=1)


def scatter_rows(full: torch.Tensor,
                 devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """Each mesh position's contiguous H rows of a replicated tensor, on
    its device (a view where the device is the tensor's own)."""
    local = full.shape[1] // len(devices)
    return [_to(full[:, i * local:(i + 1) * local], d)
            for i, d in enumerate(devices)]


def split_batch(x: torch.Tensor,
                devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """Each mesh position's contiguous slice of the batch, on its device."""
    local = x.shape[0] // len(devices)
    return [_to(x[i * local:(i + 1) * local], d)
            for i, d in enumerate(devices)]
