"""Device meshes: the 1-D ("data",) mesh of sharded NetworkPlan execution
and the LM's ("data", "model") / ("pod", "data", "model") meshes.

The JAX package's meshes are `jax.sharding.Mesh`es over its devices, and
a sharded program runs as one SPMD program. Here a mesh is a tuple of
`torch.device`s in row-major order with each axis's size, and one process
evaluates every shard (core/partition.py for the CNNs,
distributed/sharding.py and launch/steps.py for the LM): no process group,
no NCCL. A mesh position is a device, and positions may repeat --
`devices=["cuda"] * 4` puts four positions on one card, `devices=["cpu"]
* 4` four on the CPU, and the default spreads over the cards present.
Nothing falls back to the CPU.

Functions, not module constants, as in the reference: importing this
module touches no device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out over named axes: `devices` row-major over
    `axis_sizes` (one size per axis; a 1-D mesh when left out)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)
    axis_sizes: tuple[int, ...] = ()

    def __post_init__(self):
        if not self.axis_sizes:
            object.__setattr__(self, "axis_sizes", (len(self.devices),))
        if len(self.axis_sizes) != len(self.axis_names) or \
                math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"a mesh of axes {self.axis_names} sized "
                             f"{self.axis_sizes} cannot hold "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> dict[str, int]:
        """{axis: size}, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def coords(self, position: int) -> dict[str, int]:
        """{axis: index} of the flat position `position`."""
        out = {}
        for name, size in zip(reversed(self.axis_names),
                              reversed(self.axis_sizes)):
            position, out[name] = divmod(position, size)
        return out

    def position(self, coords: dict[str, int]) -> int:
        """The flat position of {axis: index} (the inverse of coords)."""
        flat = 0
        for name, size in zip(self.axis_names, self.axis_sizes):
            flat = flat * size + coords[name]
        return flat

    def distinct_devices(self) -> tuple[torch.device, ...]:
        """The devices of the mesh, each once, in position order."""
        return tuple(dict.fromkeys(self.devices))


def _normalize(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _named(devices: Sequence, what: str) -> tuple[torch.device, ...]:
    devs = tuple(_normalize(d) for d in devices)
    if not devs:
        raise ValueError(f"{what}: devices= is empty")
    return devs


def _cards(n: int) -> tuple[torch.device, ...]:
    return tuple(torch.device("cuda", i) for i in range(n))


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
        return Mesh(_cards(n))
    devs = _named(devices, "make_data_mesh")
    if num_devices is not None and num_devices != len(devs):
        raise ValueError(f"make_data_mesh: num_devices={num_devices} but "
                         f"{len(devs)} devices named")
    return Mesh(devs)


def make_host_mesh(model_parallel: int = 1, *,
                   devices: Sequence | None = None) -> Mesh:
    """("data", "model") mesh of (n // model_parallel, model_parallel) over
    the n CUDA cards present, or over the positions `devices=` names
    (repeats allowed: `devices=["cuda"] * 4` with model_parallel=2 is a
    (2, 2) mesh on one card)."""
    devs = (_cards(torch.cuda.device_count()) if devices is None
            else _named(devices, "make_host_mesh"))
    n = len(devs)
    if model_parallel < 1 or n == 0 or n % model_parallel != 0:
        raise ValueError(
            f"make_host_mesh: model_parallel={model_parallel} must be a "
            f"positive divisor of the {n} available device(s) "
            f"({[d.type for d in devs]}); pass devices= to name the mesh "
            f"positions (repeats allowed) or lower model_parallel")
    return Mesh(devs, ("data", "model"), (n // model_parallel,
                                          model_parallel))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Sequence | None = None) -> Mesh:
    """The reference's production mesh: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with `multi_pod`. Without
    `devices=` it takes that many CUDA cards and raises when fewer are
    present."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if devices is None:
        avail = torch.cuda.device_count()
        if avail < n:
            raise ValueError(
                f"make_production_mesh: a {shape} mesh needs {n} devices and "
                f"{avail} CUDA device(s) are present; pass devices= to name "
                f"the mesh positions (repeats allowed)")
        devs = _cards(n)
    else:
        devs = _named(devices, "make_production_mesh")
        if len(devs) != n:
            raise ValueError(f"make_production_mesh: a {shape} mesh needs "
                             f"{n} devices, {len(devs)} named")
    return Mesh(devs, axes, shape)
