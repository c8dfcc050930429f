"""Device meshes for sharded NetworkPlan execution.

The JAX package's `make_data_mesh` builds a 1-D ("data",) `jax.sharding.Mesh`
and runs a partitioned plan as one `shard_map` program. Here a mesh is the
same axis as a tuple of `torch.device`s, and one process evaluates every
shard (core/partition.py): no process group, no NCCL. A mesh position is a
device, and positions may repeat -- `devices=["cuda"] * 4` puts four
shards on one card, `devices=["cpu"] * 4` four on the CPU, and the
default spreads over the cards present.

`make_host_mesh` and `make_production_mesh`, the LM's 2-D meshes, wait
for the LM stack (ROADMAP.md queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one device per position along `axis_names[0]`."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)

    @property
    def shape(self) -> dict[str, int]:
        """{axis: size}, as jax.sharding.Mesh.shape."""
        return {self.axis_names[0]: len(self.devices)}

    def distinct_devices(self) -> tuple[torch.device, ...]:
        """The devices of the mesh, each once, in position order."""
        return tuple(dict.fromkeys(self.devices))


def _normalize(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_data_mesh(num_devices: int | None = None, *,
                   devices: Sequence | None = None) -> Mesh:
    """1-D ("data",) mesh for sharded NetworkPlan execution.

    Without `devices=`, the first `num_devices` CUDA cards (default: all of
    them); asking for more cards than are present raises, and nothing falls
    back to the CPU. `devices=` names the positions outright, repeats
    included: `make_data_mesh(devices=["cuda"] * 4)` is a 4-shard mesh on
    one card (what partitioning costs there, not how it scales), and
    `devices=["cpu"] * D` the CPU mesh the tests use."""
    if devices is None:
        avail = torch.cuda.device_count()
        n = avail if num_devices is None else num_devices
        if n < 1 or n > avail:
            raise ValueError(
                f"make_data_mesh: num_devices={num_devices} out of range for "
                f"the {avail} CUDA device(s) present; pass devices= to name "
                f"the mesh positions (repeats allowed, e.g. "
                f"devices=['cuda'] * {num_devices} on one card)")
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    devs = tuple(_normalize(d) for d in devices)
    if not devs:
        raise ValueError("make_data_mesh: devices= is empty")
    if num_devices is not None and num_devices != len(devs):
        raise ValueError(f"make_data_mesh: num_devices={num_devices} but "
                         f"{len(devs)} devices named")
    return Mesh(devs)
