"""The port's tensor-parallel program over the "model" axis on CPU meshes
(`make_host_mesh(m, devices=["cpu"] * 4)`), at the smoke configs: each
model position's compute view against the matching slice of the whole
leaf (in_proj's [x_m | z_m], dt_proj's columns, the GQA KV heads a
position reads); the three collectives and their gradients; the residual
split by sequence where the rule and guard allow; forward_logits, prefill
and four decode ticks under use_mesh at (2, 2) and (1, 4) against the
unsharded port and the reference's single-device forward_logits, for
qwen2.5-3b, falcon-mamba-7b, granite-moe ("tp" and "ep" experts) and
whisper-tiny; the cache placed by cache_specs; and the selective-scan
calls of a sharded train step, per position and width.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_cfgs
from repro.models import transformer as ref_tf
from repro_torch import configs as pt_cfgs
from repro_torch.distributed import context as pt_dist
from repro_torch.distributed import sharding as pt_shd
from repro_torch.kernels import selective_scan as pt_scan
from repro_torch.launch import mesh as pt_mesh
from repro_torch.launch import serve as pt_serve
from repro_torch.launch import steps as pt_steps
from repro_torch.models import attention as pt_attn
from repro_torch.models import mamba as pt_mamba
from repro_torch.models import transformer as pt_tf
from repro_torch.tree import tree_flatten_with_path, tree_leaves

from test_torch_train import batch_for, one_thread  # noqa: F401

ARCHS = ("qwen2_5_3b", "falcon_mamba_7b", "granite_moe_3b_a800m",
         "whisper_tiny")
#: (data, model) sizes, each over four CPU positions.
SHAPES = ((2, 2), (1, 4))
SHAPE_IDS = ["2x2", "1x4"]
#: The tensor-parallel program against the unsharded port and against the
#: reference's single-device forward_logits: the same fp32 arithmetic with
#: each row-parallel block's sum split by position (relative Frobenius of
#: the logits; measured <= 8.0e-7, the greatest against the reference).
TOL_TP = 1e-6
B, PROMPT, TICKS, MAX_LEN = 2, 8, 4, 16


def mesh_of(shape):
    return pt_mesh.make_host_mesh(shape[1], devices=["cpu"] * 4)


def placed(params, cfg, mesh):
    return pt_shd.device_put(params, pt_shd.param_shardings(params, cfg,
                                                            mesh))


def frob(got, want) -> float:
    got, want = torch.as_tensor(np.array(got)), torch.as_tensor(
        np.array(want))
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp_min(1e-30))


def smoke_config(arch):
    if arch == "granite_moe_ep":
        cfg = pt_cfgs.get_smoke_config("granite_moe_3b_a800m")
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, shard_mode="ep"))
    return pt_cfgs.get_smoke_config(arch)


@pytest.fixture(scope="module")
def models():
    """(cfg, the reference's fp32 weights in the port, tokens, frames,
    the reference's forward_logits) per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            name = "granite_moe_3b_a800m" if arch == "granite_moe_ep" \
                else arch
            cfg_r = ref_cfgs.get_smoke_config(name)
            ref = ref_tf.init_params(jax.random.key(0), cfg_r, jnp.float32)
            port = pt_tf.params_from_reference(jax.tree.map(np.asarray, ref),
                                               device="cpu")
            rng = np.random.default_rng(1)
            toks = rng.integers(0, cfg_r.vocab,
                                (B, PROMPT + TICKS)).astype(np.int64)
            frames = (rng.standard_normal(
                (B, cfg_r.encoder.n_ctx, cfg_r.d_model)).astype(np.float32)
                if cfg_r.encoder else None)
            want = np.asarray(ref_tf.forward_logits(
                ref, jnp.asarray(toks), cfg_r,
                None if frames is None else jnp.asarray(frames)))
            cache[arch] = (smoke_config(arch), port, torch.tensor(toks),
                           None if frames is None else torch.tensor(frames),
                           want)
        return cache[arch]
    return get


# ---------------------------------------------------------------------------
# compute views
# ---------------------------------------------------------------------------

def test_compute_views_are_the_slices_a_position_computes_with():
    """Mamba's views on (2, 2): in_proj's [x_m | z_m] columns (not its
    storage block), dt_proj's d_in columns (stored split by rows), the
    channel blocks of conv_w / a_log / x_proj / out_proj; attention's on
    (1, 4) for qwen2.5-3b (one KV head for four query heads): each
    position's query-head columns and wo rows, and the one KV head's K / V
    columns whole."""
    cfg = pt_cfgs.get_smoke_config("falcon_mamba_7b")
    params = pt_tf.init_params(torch.Generator().manual_seed(0), cfg,
                               torch.float32, device="cpu")
    mesh = mesh_of((2, 2))
    layer = pt_tf._unit(placed(params, cfg, mesh)["blocks"], 0)["layer_0"]
    whole = pt_tf._unit(params["blocks"], 0)["layer_0"]["mamba"]
    d_in = pt_mamba._dims(cfg)[1]
    c = d_in // 2
    assert pt_mamba.tp_splits(layer["mamba"])
    for m in range(2):
        v = pt_mamba.tp_views(layer["mamba"], cfg, 2, m, "cpu")
        ch = slice(m * c, (m + 1) * c)
        assert torch.equal(v["in_proj"], torch.cat(
            [whole["in_proj"][:, ch], whole["in_proj"][:, d_in:][:, ch]], 1))
        assert torch.equal(v["dt_proj"], whole["dt_proj"][:, ch])
        for name, dim in (("conv_w", 1), ("a_log", 0), ("x_proj", 0),
                          ("out_proj", 0), ("d_skip", 0), ("dt_bias", 0)):
            assert torch.equal(v[name], whole[name].narrow(dim, m * c, c)), \
                name
    piece = layer["mamba"]["in_proj"].pieces
    assert all(t.shape[1] == d_in for t in piece.values())

    cfg = pt_cfgs.get_smoke_config("qwen2_5_3b")
    assert (cfg.n_heads, cfg.n_kv_heads) == (4, 1)
    params = pt_tf.init_params(torch.Generator().manual_seed(0), cfg,
                               torch.float32, device="cpu")
    attn = pt_tf._unit(placed(params, cfg, mesh_of((1, 4)))["blocks"],
                       0)["layer_0"]["attn"]
    whole = pt_tf._unit(params["blocks"], 0)["layer_0"]["attn"]
    hd = cfg.head_dim
    assert pt_attn.tp_split(cfg, 4) == (1, 1)
    assert pt_attn.kv_layout(cfg, 4) == "dims"
    for m in range(4):
        v = pt_attn.tp_views(attn, cfg, 4, m, "cpu")
        q = slice(m * hd, (m + 1) * hd)
        assert torch.equal(v["wq"], whole["wq"][:, q])
        assert torch.equal(v["bq"], whole["bq"][q])
        assert torch.equal(v["wo"], whole["wo"][q])
        for name in ("wk", "wv", "bk", "bv"):
            assert torch.equal(v[name], whole[name]), name
        # the storage piece is a quarter of the KV head's columns
        assert {t.shape[-1] for t in attn["wk"].pieces.values()} == {hd // 4}


# ---------------------------------------------------------------------------
# the collectives and the residual's layout
# ---------------------------------------------------------------------------

def test_collectives_and_their_gradients():
    """all_reduce, all_gather and reduce_scatter over one group's four
    positions against their definitions, and the gradients autograd takes
    through them against the same definitions' (the transposes:
    reduce-scatter for all-gather, all-gather for reduce-scatter, the sum
    for all-reduce)."""
    group = pt_dist.groups(mesh_of((1, 4)), 2)[0]
    assert group.positions == (0, 1, 2, 3) and group.n == 4
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn((2, 8, 3), generator=gen, dtype=torch.float64,
                         requires_grad=True) for _ in range(4)]
    w = torch.randn((2, 8, 3), generator=gen, dtype=torch.float64)
    total = parts[0] + parts[1] + parts[2] + parts[3]

    def grads(outs, weights):
        loss = sum((o * wt).sum() for o, wt in zip(outs, weights))
        return torch.autograd.grad(loss, parts)

    red = pt_dist.all_reduce(parts, group)
    assert all(torch.equal(r, total) for r in red)
    ws = [w * (m + 1) for m in range(4)]
    for g in grads(red, ws):
        assert torch.allclose(g, sum(ws))
    gat = pt_dist.all_gather([p[:, 2 * m:2 * m + 2] for m, p in
                              enumerate(parts)], group)
    whole = torch.cat([p[:, 2 * m:2 * m + 2] for m, p in enumerate(parts)],
                      1)
    assert all(torch.equal(t, whole) for t in gat)
    for m, g in enumerate(grads(gat, ws)):
        want = torch.zeros_like(w)
        want[:, 2 * m:2 * m + 2] = sum(ws)[:, 2 * m:2 * m + 2]
        assert torch.allclose(g, want)
    sc = pt_dist.reduce_scatter(parts, group)
    for m, t in enumerate(sc):
        assert torch.equal(t, total[:, 2 * m:2 * m + 2])
    small = [wt[:, :2] for wt in ws]
    for g in grads(sc, small):
        assert torch.allclose(g, torch.cat(small, 1))


def test_shard_activations_splits_the_residual_by_sequence():
    """Under use_mesh, a Sharded residual of a group's partial sums goes
    to each position's rows of the sequence where the rule and the guard
    allow, to the whole at each position where they do not (a sequence
    the model axis does not divide, the decode kind); a plain tensor is
    left as it is."""
    mesh = mesh_of((2, 2))
    group = pt_dist.groups(mesh, 4)[0]
    x = torch.randn((2, 6, 4))
    parts = [x, 2 * x]
    with pt_dist.use_mesh(mesh):
        res = pt_dist.shard_activations(
            pt_dist.Sharded(group, parts, "partial"), "residual")
        assert res.layout == "seq" and res.shape == (2, 6, 4)
        for m in range(2):
            assert torch.equal(res.parts[m], (3 * x)[:, 3 * m:3 * m + 3])
        assert torch.equal(torch.cat(res.parts, 1), 3 * x)
        dec = pt_dist.shard_activations(
            pt_dist.Sharded(group, parts, "partial"), "decode")
        assert dec.layout == "rep" and torch.equal(dec.parts[1], 3 * x)
        odd = pt_dist.Sharded(group, [x[:, :5], x[:, :5]], "partial")
        assert pt_dist.shard_activations(odd, "residual").layout == "rep"
        assert pt_dist.shard_activations(x, "residual") is x
    assert pt_dist.shard_activations(res, "residual") is res


# ---------------------------------------------------------------------------
# the serving entry points under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("arch", ARCHS + ("granite_moe_ep",))
def test_forward_prefill_and_decode_match_unsharded_and_reference(
        models, arch, shape):
    """forward_logits, prefill and four greedy-fed decode ticks under
    use_mesh on a placed tree against the unsharded port on the same
    weights, and forward_logits against the reference's single-device
    forward_logits; the cache comes back placed by cache_specs."""
    cfg, params, toks, frames, want_ref = models(arch)
    mesh = mesh_of(shape)
    pp = placed(params, cfg, mesh)
    want = pt_tf.forward_logits(params, toks, cfg, frames)
    with pt_dist.use_mesh(mesh):
        got = pt_tf.forward_logits(pp, toks, cfg, frames)
    assert frob(got, want) <= TOL_TP
    assert frob(got, want_ref) <= TOL_TP

    l1, c1 = pt_tf.prefill(params, toks[:, :PROMPT], cfg, MAX_LEN, frames)
    with pt_dist.use_mesh(mesh):
        l2, c2 = pt_tf.prefill(pp, toks[:, :PROMPT], cfg, MAX_LEN, frames)
    assert frob(l2, l1) <= TOL_TP
    specs = pt_shd.cache_specs(c1, cfg, mesh)
    for (k, leaf), (_, spec) in zip(tree_flatten_with_path(c2),
                                    tree_flatten_with_path(specs)):
        assert isinstance(leaf, pt_shd.Placed) and \
            leaf.sharding.spec == spec, k
    for (k, a), (_, b) in zip(
            tree_flatten_with_path(pt_shd.gather_tree(c2, "cpu")),
            tree_flatten_with_path(c1)):
        assert frob(a, b) <= TOL_TP, k
    for t in range(PROMPT, PROMPT + TICKS):
        d1, c1 = pt_tf.decode_step(params, c1, toks[:, t:t + 1], t, cfg)
        with pt_dist.use_mesh(mesh):
            d2, c2 = pt_tf.decode_step(pp, c2, toks[:, t:t + 1], t, cfg)
        assert frob(d2, d1) <= TOL_TP, t
        assert frob(d2, want[:, t]) <= TOL_TP, t


def test_server_holds_a_cache_placed_by_cache_specs():
    """Server(mesh=) on whole params: the params placed by
    param_shardings, the cache by cache_specs, before and after serving,
    and the mesh-less server's tokens."""
    cfg = pt_cfgs.get_smoke_config("qwen2_5_3b")
    params = pt_tf.init_params(torch.Generator().manual_seed(0), cfg,
                               torch.float32, device="cpu")
    mesh = mesh_of((2, 2))

    def serve(**kw):
        rng = np.random.default_rng(0)
        srv = pt_serve.Server(cfg, params, max_batch=2, max_len=24, **kw)
        done, _ = srv.run([pt_serve.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, size=(4,)), max_new=4) for i in range(3)])
        return srv, [(r.rid, r.out) for r in done]

    srv, got = serve(mesh=mesh)
    assert got == serve(device="cpu")[1]
    assert isinstance(srv.params["embed"], pt_shd.Placed)
    specs = pt_shd.cache_specs(srv.cache, cfg, mesh)
    for leaf, spec in zip(tree_leaves(srv.cache), tree_leaves(specs)):
        assert isinstance(leaf, pt_shd.Placed) and leaf.sharding.spec == spec
        counts = leaf.sharding.counts(leaf.ndim)
        for t in leaf.pieces.values():
            assert tuple(t.shape) == tuple(s // c for s, c in
                                           zip(leaf.shape, counts))


# ---------------------------------------------------------------------------
# the sharded train step's scan calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_train_step_scans_each_positions_channels(monkeypatch, shape):
    """falcon-mamba-7b's sharded loss and gradients: each Mamba layer's
    selective scan runs once per model position of each data group in the
    forward and once in its unit's checkpoint recompute, on d_in / n
    channels; the loss equals the unsharded one."""
    cfg = pt_cfgs.get_smoke_config("falcon_mamba_7b")
    params = pt_tf.init_params(torch.Generator().manual_seed(0), cfg,
                               torch.float32, device="cpu")
    mesh = mesh_of(shape)
    batch = batch_for(cfg)
    calls = []
    scan = pt_scan.selective_scan

    def counted(dt, *args, **kw):
        calls.append(tuple(dt.shape))
        return scan(dt, *args, **kw)
    want, _ = pt_steps.make_loss_and_grads(cfg)(params, batch)
    monkeypatch.setattr(pt_scan, "selective_scan", counted)
    got, _ = pt_steps.make_sharded_loss_and_grads(cfg, mesh)(
        placed(params, cfg, mesh), batch)
    n_data, n_model = shape
    d_in = pt_mamba._dims(cfg)[1]
    rows = batch["tokens"].shape[0] // n_data
    assert calls == [(rows, batch["tokens"].shape[1], d_in // n_model)] * (
        2 * cfg.n_layers * n_data * n_model)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
