"""The sharded train step on CPU meshes (`devices=["cpu"] * 4`): for
qwen2.5-3b, falcon-mamba-7b and granite-moe at their smoke configs on
(2, 2), (4, 1) and (1, 4), the loss and every gradient leaf against the
port's unsharded step, the AdamW update on the same gradients, a whole
step's metrics and moments, and accumulation; qwen2.5-3b's step once
against the reference's single-device `make_train_step`; and the elastic
checkpoint restore from (4, 1) onto (2, 2), which the reference's manager
reads too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_cfgs
from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.models import transformer as ref_tf
from repro_torch import configs as pt_cfgs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed import sharding as pt_shd
from repro_torch.launch import mesh as pt_mesh
from repro_torch.launch import steps as pt_steps
from repro_torch.models import transformer as pt_tf
from repro_torch.optim import adamw as pt_adamw
from repro_torch.tree import tree_flatten_with_path, tree_map

from test_torch_train import (PT_OPT, TOL_GRAD, TOL_LOSS, _flat, _frob,
                              batch_for, check_trees, one_thread,  # noqa: F401
                              reference)

ARCHS = ("qwen2_5_3b", "falcon_mamba_7b", "granite_moe_3b_a800m")
#: (data, model) sizes of the meshes, each over four CPU positions.
SHAPES = ((2, 2), (4, 1), (1, 4))
#: The sharded step against the unsharded one: the same fp32 arithmetic
#: with the batch's sums split by data group (measured to 5.5e-7, falcon's
#: Mamba leaves at (4, 1)).
TOL_MESH = 1e-6


def mesh_of(shape):
    return pt_mesh.make_host_mesh(shape[1], devices=["cpu"] * 4)


def placed(params, cfg, mesh):
    return pt_shd.device_put(params, pt_shd.param_shardings(params, cfg,
                                                            mesh))


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check_close(got, want, tol, what):
    """Each leaf of the gathered tree `got` within `tol` (relative
    Frobenius) of `want`, the same keys."""
    g = dict(tree_flatten_with_path(pt_shd.gather_tree(got, "cpu")))
    w = dict(tree_flatten_with_path(want))
    assert list(g) == list(w)
    errs = {k: _frob(g[k].numpy(), w[k].numpy()) for k in w}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{what}: {worst} {errs[worst]:.3e}"


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = pt_cfgs.get_smoke_config(arch)
            params = pt_tf.init_params(torch.Generator().manual_seed(0), cfg,
                                       torch.float32, device="cpu")
            batch = batch_for(cfg)
            loss, grads = pt_steps.make_loss_and_grads(cfg)(params, batch)
            cache[arch] = cfg, params, batch, loss, grads
        return cache[arch]
    return get


@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "4x1", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_grads_and_update_match_unsharded(models, arch, shape):
    """The loss and every gradient leaf, each landing on its pieces, and
    AdamW on the same gradients with the moments in the params'
    shardings (the norm counts each element once)."""
    cfg, params, batch, loss, grads = models(arch)
    mesh = mesh_of(shape)
    pp = placed(params, cfg, mesh)
    got_loss, got = pt_steps.make_sharded_loss_and_grads(cfg, mesh)(pp,
                                                                     batch)
    assert abs(float(got_loss) - float(loss)) <= TOL_MESH * abs(float(loss))
    for (k, g), (_, p) in zip(tree_flatten_with_path(got),
                              tree_flatten_with_path(pp)):
        assert g.pieces.keys() == p.pieces.keys(), k
    check_close(got, grads, TOL_MESH, f"{arch} {shape} grads")

    state = pt_adamw.init_state(params, PT_OPT)
    want_p, want_s = pt_adamw.apply_updates(params, grads, state, PT_OPT)
    p_state = pt_adamw.init_state(pp, PT_OPT)
    assert isinstance(p_state.m["embed"], pt_shd.Placed)
    assert not isinstance(p_state.step, pt_shd.Placed)
    new_p, new_s = pt_adamw.apply_updates(
        pp, placed(grads, cfg, mesh), p_state, PT_OPT)
    for a, b in ((new_p, want_p), (new_s.m, want_s.m), (new_s.v, want_s.v)):
        ga = dict(tree_flatten_with_path(pt_shd.gather_tree(a, "cpu")))
        for k, w in tree_flatten_with_path(b):
            assert _rel(ga[k], w) <= TOL_MESH, k
    assert float(pt_adamw.global_norm(placed(grads, cfg, mesh))) == \
        pytest.approx(float(pt_adamw.global_norm(grads)), rel=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
def test_sharded_train_step_matches_unsharded(models, accum):
    """A whole step on (2, 2) against the unsharded step: the metrics and
    the moments (the gradients in the state), the inputs left as they
    were, the new params placed in the params' layout."""
    cfg, params, batch, _, _ = models("qwen2_5_3b")
    mesh = mesh_of((2, 2))
    pp = placed(params, cfg, mesh)
    want_p, want_s, want_m = pt_steps.make_train_step(
        cfg, PT_OPT, accum)(params, pt_adamw.init_state(params, PT_OPT),
                            batch)
    state = pt_adamw.init_state(pp, PT_OPT)
    new_p, new_s, m = pt_steps.make_train_step(cfg, PT_OPT, accum,
                                               mesh=mesh)(pp, state, batch)
    for key in ("loss", "grad_norm", "lr"):
        assert float(m[key]) == pytest.approx(float(want_m[key]),
                                              rel=TOL_MESH), key
    check_close(new_s.m, want_s.m, TOL_MESH, "m")
    check_close(new_s.v, want_s.v, 2 * TOL_MESH, "v")
    assert int(new_s.step) == 1
    assert all(isinstance(t, pt_shd.Placed) for _, t in
               tree_flatten_with_path(new_p))
    assert float(pt_shd.gather_tree(state.m)["embed"].abs().max()) == 0
    old = dict(tree_flatten_with_path(params))
    for k, t in tree_flatten_with_path(pt_shd.gather_tree(pp, "cpu")):
        assert torch.equal(t, old[k]), k


def test_sharded_step_matches_reference_single_device_step(reference):
    """qwen2.5-3b's sharded step on (2, 2) against the JAX package's
    jitted single-device make_train_step on the same weights and batch,
    at tests/test_torch_train.py's tolerances."""
    _, cfg, _, port, batch, _, steps = reference("qwen2_5_3b")
    _, st_r, m_r = steps[1]
    mesh = mesh_of((2, 2))
    pp = placed(port, cfg, mesh)
    _, st, m = pt_steps.make_train_step(cfg, PT_OPT, mesh=mesh)(
        pp, pt_adamw.init_state(pp, PT_OPT), batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(m_r[key])) <= \
            TOL_LOSS * abs(float(m_r[key])), key
    check_trees(pt_shd.gather_tree(st.m, "cpu"), st_r.m, TOL_GRAD, "m")
    check_trees(pt_shd.gather_tree(st.v, "cpu"), st_r.v, 2 * TOL_GRAD, "v")


def test_elastic_restore_across_mesh_shapes(tmp_path, models):
    """A checkpoint of params and AdamW state placed on (4, 1) restores
    onto (2, 2) bitwise, each piece at its new spec's shape; the
    reference's CheckpointManager reads the port's placed params."""
    cfg, params, _, _, _ = models("qwen2_5_3b")
    a, b = mesh_of((4, 1)), mesh_of((2, 2))
    like = pt_tf.abstract_params(cfg, torch.float32)
    state = pt_adamw.init_state(params, PT_OPT)
    state = state._replace(m=tree_map(lambda t: t + 1.5, state.m))
    tree = {"params": placed(params, cfg, a),
            "opt": pt_adamw.AdamWState(state.step, placed(state.m, cfg, a),
                                       placed(state.v, cfg, a))}
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(3, tree, blocking=True)
    p_b = pt_shd.param_shardings(like, cfg, b)
    restored = mgr.restore(3, {"params": like,
                               "opt": pt_adamw.init_state(like, PT_OPT)},
                           {"params": p_b, "opt": pt_adamw.AdamWState(
                               pt_shd.NamedSharding(b, pt_shd.P()), p_b,
                               p_b)})
    want = dict(tree_flatten_with_path({"params": params, "opt": state}))
    got = pt_shd.gather_tree(restored, "cpu")
    for k, t in tree_flatten_with_path(got):
        assert t.dtype == want[k].dtype and torch.equal(t, want[k]), k
    wq = restored["params"]["blocks"]["layer_0"]["attn"]["wq"]
    assert wq.sharding.spec == pt_shd.P(None, "data", "model")
    assert {tuple(t.shape) for t in wq.pieces.values()} == {
        (wq.shape[0], wq.shape[1] // 2, wq.shape[2] // 2)}

    CheckpointManager(str(tmp_path / "params")).save(
        3, tree["params"], blocking=True)
    ref_like = jax.eval_shape(lambda: ref_tf.init_params(
        jax.random.key(0), ref_cfgs.get_smoke_config("qwen2_5_3b"),
        jnp.float32))
    out = RefManager(str(tmp_path / "params")).restore(3, ref_like)
    for k, t in _flat(out).items():
        assert np.array_equal(t, want[f"params/{k}"].numpy()), k
