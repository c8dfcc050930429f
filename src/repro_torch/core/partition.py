"""Multi-device partitioning of compiled NetworkPlans.

Two partition kinds over a 1-D ("data",) mesh axis (launch/mesh.py), as in
the JAX package:

  * "data" -- data-parallel batch sharding: the batch dim splits across
    the mesh, weights replicate, and every shard runs the same kernels at
    the local batch. Legal whenever the batch divides the axis; otherwise
    the plan degrades to a single-logical-device plan with the reason
    recorded.
  * "spatial" -- halo partitioning of H: each mesh position owns a
    contiguous strip of output rows. Stride-1 SAME odd-k convs
    (dense/depthwise/separable, and residual-free inverted-residual blocks)
    run VALID on their strip after exchanging (k-1)//2 halo rows with
    their neighbors (edge shards receive zeros, which IS the SAME zero
    padding). Layers the walk cannot keep row-local (stride-2, pooling,
    residual adds against a haloed input) re-gather the full plane at a
    recorded cut point and re-shard after when the new H still divides
    the axis.

`decide_partition` is a pure function over the layer IR + global shapes,
a copy of the JAX package's: its JSON-serializable record (modes, halos,
re-scatter points, per-node shardedness) is key for key the one the JAX
package writes for the same graph, and compile() persists it in version-5
artifacts so a warm start restores the partitioning without re-deciding.

`build_sharded_fn` turns a partitioned NetworkPlan and its attached mesh
into the callable `NetworkPlan.apply` routes through. The JAX package
runs a `shard_map` program, which evaluates a replicated node on every
device; here one process evaluates every shard, and the plans, the
weights and every replicated (`full`, replicated `local`) evaluation
exist once per DISTINCT device of the mesh. On a mesh that repeats one
card, a `full` node launches once and a `halo` node once per shard; on a
mesh of several cards, the plans are copied once to each other card. The
numbers are the same either way.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch

from repro_torch.core.plan import spatial_halo
from repro_torch.distributed.sharding import (data_axis_name, gather_rows,
                                              halo_exchange, scatter_rows,
                                              split_batch)


def mesh_num_shards(mesh) -> tuple[str, int]:
    """(axis_name, size) of the partition axis of a NetworkPlan mesh."""
    axis = data_axis_name(mesh)
    return axis, int(mesh.shape[axis])


def _degraded(kind: str, axis: str, requested: int, reason: str) -> dict:
    return {"kind": kind, "axis": axis, "num_shards": 1,
            "requested_shards": requested, "degraded": reason}


def decide_partition(graph: Sequence, shapes: dict[str, tuple[int, ...]],
                     num_shards: int, kind: str = "data",
                     axis: str = "data") -> dict:
    """Decide how a lowered+fused graph partitions over `num_shards`.

    Pure IR walk (no device state), so it unit-tests without a mesh. The
    returned record is everything the sharded executor needs; degradation
    to replication (num_shards=1 + reason) is a record, not an error --
    indivisible batches/heights must keep serving.
    """
    if kind not in ("data", "spatial"):
        raise ValueError(f"unknown partition kind {kind!r}; expected "
                         f"'data' or 'spatial'")
    in_shape = shapes["input"]
    if num_shards <= 1:
        return _degraded(kind, axis, num_shards, "single-device mesh axis")

    if kind == "data":
        b = in_shape[0]
        if b % num_shards:
            return _degraded(
                kind, axis, num_shards,
                f"batch {b} does not divide over {num_shards} shards")
        return {"kind": "data", "axis": axis, "num_shards": num_shards,
                "requested_shards": num_shards, "degraded": None}

    # -- spatial: walk the graph deciding a mode per node -------------------
    if len(in_shape) != 4:
        return _degraded(kind, axis, num_shards,
                         f"spatial partitioning needs NHWC input, got "
                         f"{in_shape}")
    if in_shape[1] % num_shards:
        return _degraded(
            kind, axis, num_shards,
            f"H={in_shape[1]} does not divide over {num_shards} shards")

    sharded: dict[str, bool] = {"input": True}
    modes: dict[str, str] = {}
    halo: dict[str, int] = {}
    rescatter: dict[str, bool] = {}

    def halo_ok(node, k: int, stride, padding) -> bool:
        s_in = shapes[node.inputs[0]]
        local_h = s_in[1] // num_shards
        return (sharded[node.inputs[0]] and tuple(stride) == (1, 1)
                and padding == "SAME" and k % 2 == 1
                and spatial_halo(k) <= local_h)

    for node in graph[1:]:
        a = node.attrs
        ins = node.inputs
        if node.op == "conv2d":
            if a["kh"] == a["kw"] and halo_ok(node, a["kh"], a["stride"],
                                              a["padding"]):
                modes[node.id] = "halo"
                halo[node.id] = spatial_halo(a["kh"])
                sharded[node.id] = True
                continue
        elif node.op == "separable":
            if halo_ok(node, a["k"], a["stride"], a["padding"]):
                modes[node.id] = "halo"
                halo[node.id] = spatial_halo(a["k"])
                sharded[node.id] = True
                continue
        elif node.op == "inverted_residual":
            # The residual add happens inside the block plan against the
            # (haloed) block input -- shapes no longer line up, so residual
            # blocks re-gather instead.
            if not a["residual"] and halo_ok(node, a["k"], a["stride"],
                                             a["padding"]):
                modes[node.id] = "halo"
                halo[node.id] = spatial_halo(a["k"])
                sharded[node.id] = True
                continue
        elif node.op == "global_avg_pool":
            if sharded[ins[0]]:
                # local spatial mean, then the mean over equal-height
                # strips, is exactly the global mean; output is replicated.
                modes[node.id] = "reduce"
                sharded[node.id] = False
                continue
        elif node.op in ("concat", "add"):
            if all(sharded[i] for i in ins):
                modes[node.id] = "local"
                sharded[node.id] = True
                continue
        elif node.op in ("dense",):
            if not sharded[ins[0]]:
                modes[node.id] = "local"      # replicated in, replicated out
                sharded[node.id] = False
                continue

        # Everything else (strided/even-k convs, pooling, conv1d, mixed
        # concat inputs, dense over a sharded map): re-gather the full
        # plane, evaluate at the global shape, and re-shard the output
        # when its H still divides the axis -- a recorded graph cut point.
        modes[node.id] = "full"
        s_out = shapes[node.id]
        re = len(s_out) == 4 and s_out[1] % num_shards == 0
        rescatter[node.id] = re
        sharded[node.id] = re

    out_id = graph[-1].id
    return {"kind": "spatial", "axis": axis, "num_shards": num_shards,
            "requested_shards": num_shards, "degraded": None,
            "modes": modes, "halo": halo, "rescatter": rescatter,
            "sharded": sharded, "out_sharded": bool(sharded[out_id])}


def local_bind_shapes(partition: dict,
                      shapes: dict[str, tuple[int, ...]]) -> dict:
    """Per-node *plan-binding* input geometry under a partition.

    data: every shape carries the local batch. spatial: halo-mode nodes
    bind at their exchanged local strip (spatial_halo_in_shape, one bind
    per node); everything else binds at the global shape (full-mode nodes
    evaluate gathered)."""
    d = partition["num_shards"]
    if partition["kind"] == "data":
        return {nid: (s[0] // d,) + tuple(s[1:]) for nid, s in shapes.items()}
    return dict(shapes)


def spatial_halo_in_shape(partition: dict, node,
                          shapes: dict[str, tuple[int, ...]]) -> tuple:
    """The local exchanged input shape a halo-mode node's plan binds at:
    (B, H/D + 2p, W + 2p, C), bound VALID."""
    p = partition["halo"][node.id]
    b, h, w, c = shapes[node.inputs[0]]
    local_h = h // partition["num_shards"]
    return (b, local_h + 2 * p, w + 2 * p, c)


def halo_strips(shards, p: int) -> list[torch.Tensor]:
    """The input strips of a halo-mode node: each shard with its
    neighbors' `p` rows exchanged (zeros at the two edges, the SAME
    padding of H) and W padded by `p` on both sides, the VALID-bound
    plan's (B, H/D + 2p, W + 2p, C). A 1x1 conv (p = 0) takes its shards
    as they are."""
    if p == 0:
        return list(shards)
    return [torch.nn.functional.pad(v, (0, 0, p, p))
            for v in halo_exchange(shards, p)]


def replicate(net, device: torch.device):
    """`net`'s plans and epilogue constants on `device`, as an unsharded
    NetworkPlan that shares `net`'s graph (`net` itself on its own
    device). The plans are copied, never moved."""
    if device == net.device:
        return net
    plans = {nid: copy.deepcopy(p).to(device) for nid, p in net.plans.items()}
    consts = {k: v.to(device) for k, v in net.consts.items()}
    return type(net)(net.graph, plans, consts, net.input_shape,
                     net.algorithm, net.dtype,
                     compute_dtype=net.compute_dtype,
                     params_digest=net.params_digest)


def build_sharded_fn(net):
    """The callable a partitioned NetworkPlan executes: x (the global
    input, on any device) -> the global output on the mesh's first device.

    Weights replicate (once per distinct device, `replicate`); only the
    activation is sharded -- the batch dim for "data", H for "spatial",
    one tensor per mesh position. The kernels run unchanged on each shard,
    in one stream order per device, so on a mesh that repeats one card the
    whole program is one capturable sequence of launches."""
    part = net.partition
    mesh = net.mesh
    _, d = mesh_num_shards(mesh)
    devices = tuple(mesh.devices)
    first = devices[0]
    reps = {dev: replicate(net, dev) for dev in mesh.distinct_devices()}
    shard_nets = [reps[dev] for dev in devices]

    if part["kind"] == "data":
        def run_data(x):
            ys = [shard_nets[i]._eval_graph(xs)
                  for i, xs in enumerate(split_batch(x, devices))]
            return torch.cat([y if y.device == first else y.to(first)
                              for y in ys], dim=0)
        return run_data

    modes = part["modes"]
    halo = part["halo"]
    rescatter = part["rescatter"]
    sharded = part["sharded"]
    from repro_torch.core.compile import _consumers
    consumers = {nid: len(cons)
                 for nid, cons in _consumers(net.graph).items()}
    head = reps[first]

    def run_spatial(x):
        remaining = dict(consumers)
        # a sharded value is a list of D tensors (one per mesh position,
        # on its device); a replicated one is one tensor on `first`
        env = {"input": scatter_rows(x, devices)}
        for node in net.graph[1:]:
            a = node.attrs
            mode = modes[node.id]
            if mode == "halo":
                strips = halo_strips(env[node.inputs[0]], halo[node.id])
                y = [shard_nets[i]._eval_node(node, a, v, None,
                                              shard_nets[i].consts)
                     for i, v in enumerate(strips)]
            elif mode == "full":
                vals = {i: (gather_rows(env[i], first) if sharded[i]
                            else env[i]) for i in node.inputs}
                y = head._eval_node(
                    node, a, vals[node.inputs[0]] if node.inputs else None,
                    vals, head.consts)
                if rescatter[node.id]:
                    y = scatter_rows(y, devices)
            elif mode == "reduce":
                means = [torch.mean(v, dim=(1, 2))
                         for v in env[node.inputs[0]]]
                y = torch.stack([m if m.device == first else m.to(first)
                                 for m in means]).mean(dim=0)
            elif sharded[node.id]:                   # local, sharded
                y = [shard_nets[i]._eval_node(
                        node, a, env[node.inputs[0]][i],
                        {k: env[k][i] for k in node.inputs},
                        shard_nets[i].consts) for i in range(d)]
            else:                                    # local, replicated
                y = head._eval_node(node, a, env[node.inputs[0]], env,
                                    head.consts)
            env[node.id] = y
            for i in node.inputs:
                remaining[i] -= 1
                if remaining[i] == 0 and i in env:
                    del env[i]
        out = env[net.graph[-1].id]
        return gather_rows(out, first) if part["out_sharded"] else out

    return run_spatial
