"""Train, prefill and serve steps, as in the JAX package's launch/steps.py.

The reference jits them; PyTorch runs them eagerly. The train step
supports gradient accumulation (microbatches run one after another, so one
microbatch's activations are live at a time) and returns scalar metrics.
launch/serve.py:Server drives make_serve_step, launch/train.py the train
step.

**Over a mesh** (`make_train_step(..., mesh=)`), the step has the
reference's semantics, `jax.jit(make_train_step(...),
in_shardings=(p_shard, None, None), out_shardings=(p_shard, None, None))`,
in one process: the params (and so AdamW's moments) are a tree placed by
distributed/sharding.device_put, and the batch splits by batch_specs over
("pod", "data") into data groups. The step enters
distributed/context.use_mesh itself (as the reference's jit partitions
without a context), and each group runs its forward at its local batch
as the tensor-parallel program of models/transformer.py, one group after
another: each of the group's model positions computes its heads, ffn
columns, d_in channels, experts and vocab rows on its compute view of
each scan unit's leaves (its block, gathered over the data axes just
before the unit runs), the residual split by sequence between them;
then one backward runs the groups' graphs in turn (autograd takes the
last group first) and sums their gradients into the pieces the views
read. The loss and the gradients are the global batch's mean, as in the
unsharded step: each group adds its summed cross-entropy, divided by the
batch's label count, and a MoE batch routes across its groups exactly as
whole (models/moe.py:GroupRouting). Accumulation splits the global batch
into microbatches of consecutive rows, as unsharded, and each microbatch
into its data groups.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import context as dist
from repro_torch.distributed.sharding import (Placed, Stacked, _stacked,
                                              batch_groups, group_positions,
                                              piecewise)
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw
from repro_torch.tree import (tree_leaves, tree_map, tree_map_with_path,
                              tree_unflatten)

_F32 = torch.float32


def make_loss_and_grads(cfg: ArchConfig):
    """loss_and_grads(params, batch) -> (fp32 loss, gradient tree like
    params): tf.forward and its backward (the reference's
    jax.value_and_grad(loss_fn)). batch leaves are tensors or arrays,
    moved to the params' device.

    A frame of the call can outlive it in a reference cycle (an import
    that torch.utils.checkpoint's first call makes captures the stack), and
    such a frame keeps its locals until the collector runs: so the call
    drops its arguments and returns its result from a list it empties,
    leaving its frame nothing that holds the params or the gradients."""
    def loss_and_grads(params, batch):
        device = tree_leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_()
                      for t in tree_leaves(params)]
            loss = tf.forward(tree_unflatten(params, leaves), batch, cfg)
            out = [(loss.detach(), tree_unflatten(
                params, list(torch.autograd.grad(loss, leaves))))]
        del params, batch, leaves, loss
        return out.pop()
    return loss_and_grads


def _grad_view(params, positions=None):
    """A placed tree's view for autograd: (the leaves to differentiate,
    the tree the forward reads, a function from their gradients to a
    gradient tree in the params' layout). Each piece becomes a leaf of
    its own, a stacked leaf's piece one leaf per unit (sharding.Stacked).
    With `positions`, only the pieces held at those mesh positions are
    differentiated, and the gradient tree holds those pieces alone."""
    leaves = []

    def local(leaf):
        return leaf if positions is None else leaf.held_at(positions)

    def fresh(t):
        t = t.detach().requires_grad_()
        leaves.append(t)
        return t

    def view(path, leaf):
        if not isinstance(leaf, Placed):
            raise TypeError(f"a train step over a mesh takes a placed "
                            f"tree (sharding.device_put); {path!r} is a "
                            f"{type(leaf).__name__}")
        keep = local(leaf).pieces
        if not _stacked(tuple(path.split("/"))):
            return leaf.with_pieces({k: fresh(t) if k in keep else t
                                     for k, t in leaf.pieces.items()})
        units = [leaf.unit(u) for u in range(leaf.shape[0])]
        keep = {(index[1:], dev) for index, dev in keep}    # unit keys
        return Stacked([p.with_pieces({k: fresh(t) if k in keep else t
                                       for k, t in p.pieces.items()})
                        for p in units])

    tree = tree_map_with_path(view, params)

    def grads_of(grads):
        it = iter(grads)

        def one(path, leaf):
            leaf = local(leaf)
            stacked = _stacked(tuple(path.split("/")))
            rows = [{k: next(it) for k in leaf.pieces}
                    for _ in range(leaf.shape[0] if stacked else 1)]
            got = {}
            for k, t in leaf.pieces.items():
                gs = [torch.zeros(t.shape[1:] if stacked else t.shape,
                                  dtype=t.dtype, device=t.device)
                      if r[k] is None else r[k] for r in rows]
                got[k] = torch.stack(gs) if stacked else gs[0]
            # replicas of one shard index: the gradients their gathers
            # received, summed in key order, copied to each replica
            total = {}
            for (index, dev), g in got.items():
                total[index] = g if index not in total else \
                    total[index] + g.to(total[index].device)
            return leaf.with_pieces({(index, dev): total[index].to(dev)
                                     for index, dev in got})

        return tree_map_with_path(one, params)

    return leaves, tree, grads_of


def _held_at(tree, positions):
    """Each placed leaf of `tree` restricted to its pieces held at the
    mesh positions `positions` (everything when None)."""
    if positions is None:
        return tree
    return tree_map(lambda leaf: leaf.held_at(positions), tree)


def _merged(tree, part):
    """`tree` with the pieces of `part` (its leaves restricted to some
    positions) in place of its own."""
    return tree_map(lambda leaf, new: leaf.with_pieces(
        {**leaf.pieces, **new.pieces}), tree, part)


def make_sharded_loss_and_grads(cfg: ArchConfig, mesh, groups=None):
    """make_loss_and_grads over `mesh` (the module docstring): params a
    placed tree, the loss on the first data group's device, the gradients
    a placed tree in the params' layout.

    `groups`: the indices of the data groups to compute (default: every
    group). With them, the call is those groups' part of the step, as
    their first positions run it on a mesh of several cards (the dry run,
    launch/dryrun.py, traces group 0 so): their rows' loss (still divided
    by the whole batch's label count, a MoE layer still bounded by the
    whole batch's capacity) and the gradients of the pieces those
    positions hold, the gradient tree holding those pieces alone; the
    rest of each gathered unit's gradient belongs to the other holders."""
    def loss_and_grads(params, batch):
        rows, seq = batch["tokens"].shape[:2]
        groups_all = batch_groups(mesh, rows)
        chosen = range(len(groups_all)) if groups is None else groups
        dev0 = groups_all[0][0]
        at = None if groups is None else group_positions(mesh, rows)
        positions = None if groups is None else [at[g] for g in groups]
        leaves, view, grads_of = _grad_view(params, positions)
        routing = (moe_lib.GroupRouting(rows * seq)
                   if cfg.moe is not None else None)
        mesh_groups = dist.groups(mesh, rows)
        with torch.enable_grad(), dist.use_mesh(mesh):
            tot = torch.zeros((), dtype=_F32, device=dev0)
            auxes = []
            for g in chosen:
                dev, sl = groups_all[g]
                part = {k: torch.as_tensor(v[sl], device=dev)
                        for k, v in batch.items()}
                route = None if routing is None else \
                    (lambda u, i, g=g: routing.at(g, (u, i)))
                xent, aux = tf.loss_terms(view, part, cfg, route,
                                          mesh_groups[g])
                tot = tot + xent.to(dev0)
                auxes.append(aux)
            loss = tot / tf.n_labels(torch.as_tensor(batch["labels"],
                                                     device=dev0))
            aux = (routing.aux(auxes, cfg) if routing is not None
                   else sum(a.to(dev0) for a in auxes))
            loss = loss + 0.01 * aux
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), grads_of(grads)
    return loss_and_grads


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    accum_steps: int = 1, mesh=None, groups=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {loss, grad_norm (of the unclipped gradients), lr (the
    schedule at the step just taken)}), new trees, its inputs left as they
    were.

    batch leaves have leading dim = global batch; with accum_steps > 1 the
    batch splits into that many microbatches (consecutive rows), whose
    gradients are summed in an fp32 buffer, divided and cast back to each
    parameter's dtype; the loss is their mean.

    With `mesh` (launch/mesh.Mesh), the step over the mesh of the module
    docstring: params a tree placed by sharding.device_put with
    param_shardings, and so the new params and AdamW's moments; `groups`
    as make_sharded_loss_and_grads', the update then of the pieces the
    groups' first positions hold (the others returned as they were), its
    norm over those pieces."""
    loss_and_grads = (make_loss_and_grads(cfg) if mesh is None
                      else make_sharded_loss_and_grads(cfg, mesh, groups))

    def train_step(params, opt_state, batch):
        whole, whole_state = params, opt_state
        positions = None
        if groups is not None:
            at = group_positions(mesh, len(batch["tokens"]) // accum_steps)
            positions = [at[g] for g in groups]
            params = _held_at(params, positions)
            opt_state = opt_state._replace(
                m=_held_at(opt_state.m, positions),
                v=_held_at(opt_state.v, positions))
        if accum_steps == 1:
            loss, grads = loss_and_grads(whole, batch)
        else:
            rows = len(batch["tokens"])
            if rows % accum_steps:
                raise ValueError(f"a batch of {rows} rows does not split "
                                 f"into {accum_steps} microbatches")
            mb = rows // accum_steps
            micro = [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                     for i in range(accum_steps)]
            acc = tree_map(piecewise(lambda p: torch.zeros(
                p.shape, dtype=_F32, device=p.device)), params)
            loss = 0.0
            for mb in micro:
                mb_loss, g = loss_and_grads(whole, mb)
                tree_map(piecewise(lambda a, x: a.add_(x.to(_F32))), acc, g)
                loss = loss + mb_loss
                del g
            loss = loss / accum_steps
            grads = tree_map(piecewise(
                lambda a, p: (a / accum_steps).to(p.dtype)), acc, params)
            del acc
        grad_norm = adamw.global_norm(grads)
        params, opt_state = adamw.apply_updates(params, grads, opt_state,
                                                opt_cfg)
        if positions is not None:
            params = _merged(whole, params)
            opt_state = opt_state._replace(
                m=_merged(whole_state.m, opt_state.m),
                v=_merged(whole_state.v, opt_state.v))
        metrics = {"loss": loss.to(_F32), "grad_norm": grad_norm,
                   "lr": adamw.schedule(opt_state.step - 1, opt_cfg)}
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, max_len: int, groups=None):
    """prefill_step(params, batch {tokens (B, S)[, frames]}) ->
    (last-token logits (B, V), decode cache). Bulk prefill: MoE routing is
    capacity-bounded (dropless=False), as in the reference; a dropless
    buffer is O(T) rows per expert. Under a mesh with placed params, the
    tensor-parallel program, the cache placed by cache_specs; `groups`
    (indices of data groups) computes those groups' rows only."""
    def prefill_step(params, batch):
        return tf.prefill(params, batch["tokens"], cfg, max_len,
                          batch.get("frames"), dropless=False,
                          groups=groups)
    return prefill_step


def make_serve_step(cfg: ArchConfig, groups=None):
    """One-token decode: (params, cache, tokens (B, 1), cache_pos) ->
    (next_token_logits (B, V), new_cache); `groups` as
    make_prefill_step's."""
    def serve_step(params, cache, tokens, cache_pos):
        return tf.decode_step(params, cache, tokens, cache_pos, cfg,
                              groups=groups)
    return serve_step
