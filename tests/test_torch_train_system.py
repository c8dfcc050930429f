"""The port's training system on the CPU, mirroring tests/test_system.py:
the train driver (the loss decreases, a restart resumes from its
checkpoint, accumulation keeps the loss scale, a mesh without a "model"
axis is refused and a (2, 2) mesh trains), the checkpoint manager (round trip, keep-last garbage
collection, partial writes ignored, the dtype cast on restore) and the
data pipeline (deterministic, shifted labels, host sharding); then against
the JAX package: the pipeline's batches bit for bit, and checkpoints
across packages (the reference's fp32 and bf16 files restore in the port,
the port's fp32 files in the reference)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_cfgs
from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import transformer as ref_tf
from repro.optim import adamw as ref_adamw
from repro_torch import configs as pt_cfgs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.distributed.sharding import Placed
from repro_torch.launch.mesh import make_data_mesh, make_host_mesh
from repro_torch.launch.train import train
from repro_torch.models import transformer as pt_tf
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten_with_path, tree_map

from test_torch_train import one_thread  # noqa: F401


# ---------------------------------------------------------------------------
# training loop
# ---------------------------------------------------------------------------

def test_train_loss_decreases():
    _, history = train("qwen2_5_3b", steps=30, batch=8, seq=32, smoke=True,
                       ckpt_dir=None, lr=3e-3, log_every=100, device="cpu")
    assert len(history) == 30
    assert history[-1] < history[0] * 0.9, history
    assert np.isfinite(history).all()


def test_train_restart_resumes_from_checkpoint(tmp_path):
    """A second train() in the same directory restores step 6 and runs
    only steps 6..9, with the losses an uninterrupted run reads."""
    ck = str(tmp_path / "ckpt")
    kw = dict(batch=4, seq=16, smoke=True, log_every=100, device="cpu")
    train("qwen2_5_3b", steps=6, ckpt_dir=ck, ckpt_every=3, **kw)
    assert CheckpointManager(ck).latest_step() == 6
    (params, opt), history = train("qwen2_5_3b", steps=10, ckpt_dir=ck,
                                   ckpt_every=5, **kw)
    assert len(history) == 4
    assert CheckpointManager(ck).latest_step() == 10
    assert int(opt.step) == 10
    _, whole = train("qwen2_5_3b", steps=10, ckpt_dir=None, **kw)
    np.testing.assert_allclose(history, whole[6:], rtol=1e-5)


def test_train_with_grad_accum_matches_no_accum_loss_scale():
    """accum=2 over the same global batch gives a (near-)identical
    first-step loss on a dense arch; a MoE arch under accum trains
    finitely (its capacity is per microbatch)."""
    kw = dict(steps=3, batch=8, seq=16, smoke=True, ckpt_dir=None,
              log_every=100, device="cpu")
    _, h1 = train("qwen2_5_3b", accum=1, **kw)
    _, h2 = train("qwen2_5_3b", accum=2, **kw)
    np.testing.assert_allclose(h1[0], h2[0], rtol=1e-3)
    _, h3 = train("granite_moe_3b_a800m", steps=2, batch=8, seq=16,
                  smoke=True, ckpt_dir=None, accum=2, log_every=100,
                  device="cpu")
    assert np.isfinite(h3).all()


def test_train_refuses_a_mesh_of_several_devices():
    """train(mesh=) refuses a mesh without a "model" axis (a data mesh of
    several devices), naming make_host_mesh, and trains on a (2, 2) CPU
    mesh with the losses of the one-device run, its params placed."""
    kw = dict(steps=2, batch=4, seq=8, smoke=True, ckpt_dir=None,
              log_every=100)
    for devices in (["cpu", "meta"], ["cpu"] * 2):
        with pytest.raises(ValueError, match="make_host_mesh"):
            train("qwen2_5_3b", mesh=make_data_mesh(devices=devices), **kw)
    (params, opt), history = train(
        "qwen2_5_3b", mesh=make_host_mesh(2, devices=["cpu"] * 4), **kw)
    _, whole = train("qwen2_5_3b", device="cpu", **kw)
    np.testing.assert_allclose(history, whole, rtol=1e-5)
    assert isinstance(params["embed"], Placed) and \
        isinstance(opt.m["embed"], Placed) and int(opt.step) == 2


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": torch.tensor(rng.standard_normal((4, 3)),
                                    dtype=torch.float32)},
            "b": [torch.tensor(rng.standard_normal(5), dtype=torch.float32),
                  np.int32(7)],
            "h": torch.tensor(rng.standard_normal(6)).to(torch.bfloat16)}


def _like(tree):
    return {"a": {"w": torch.empty((4, 3), device="meta")},
            "b": [torch.empty((5,), device="meta"),
                  torch.empty((), dtype=torch.int32, device="meta")],
            "h": torch.empty((6,), dtype=torch.bfloat16, device="meta")}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(5, tree, blocking=True)
    out = mgr.restore(5, _like(tree), device="cpu")
    for (k, a), (_, b) in zip(tree_flatten_with_path(tree),
                              tree_flatten_with_path(out)):
        assert b.device.type == "cpu"
        assert torch.equal(torch.as_tensor(a), b), k
    assert out["h"].dtype == torch.bfloat16
    with np.load(tmp_path / "step_5" / "arrays.npz") as z:
        assert sorted(z.files) == ["a/w", "b/0", "b/1", "h"]


def test_checkpoint_keep_last_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.steps() == [3, 4]


def test_checkpoint_partial_write_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    os.makedirs(tmp_path / "step_2.tmp")
    with open(tmp_path / "step_2.tmp" / "arrays.npz", "w") as f:
        f.write("garbage")
    assert mgr.latest_step() == 1


def test_checkpoint_dtype_cast_on_restore(tmp_path):
    """Restore casts to the dtype of `like` (bf16 params from an fp32
    run)."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones((3,)) * 1.5}, blocking=True)
    out = mgr.restore(1, {"w": torch.empty((3,), dtype=torch.bfloat16)},
                      device="cpu")
    assert out["w"].dtype == torch.bfloat16
    assert out["w"].float().tolist() == [1.5] * 3
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"w": torch.empty((4,))}, device="cpu")


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_pipeline_deterministic_across_restarts():
    cfg = pt_cfgs.get_smoke_config("qwen2_5_3b")
    p1 = SyntheticLM(cfg, batch=4, seq=16, seed=3)
    p2 = SyntheticLM(cfg, batch=4, seq=16, seed=3)
    for step in (0, 5, 100):
        b1, b2 = p1.batch_at(step), p2.batch_at(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["labels"], b2["labels"])
    assert not np.array_equal(p1.batch_at(0)["tokens"],
                              p1.batch_at(1)["tokens"])


def test_pipeline_labels_are_shifted_tokens():
    cfg = pt_cfgs.get_smoke_config("qwen2_5_3b")
    b = SyntheticLM(cfg, batch=2, seq=32).batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_host_sharding_partitions_batch():
    cfg = pt_cfgs.get_smoke_config("qwen2_5_3b")
    shards = [SyntheticLM(cfg, batch=8, seq=16, seed=1, host_index=i,
                          host_count=4) for i in range(4)]
    assert all(s.batch == 2 for s in shards)
    got = [s.batch_at(7)["tokens"] for s in shards]
    assert not np.array_equal(got[0], got[1])


def test_prefetcher_delivers_in_order_and_closes():
    it = Prefetcher(iter([{"i": i} for i in range(5)]), depth=2)
    assert [next(it)["i"] for _ in range(5)] == list(range(5))
    it.close()


@pytest.mark.parametrize("arch,host", [("qwen2_5_3b", (0, 1)),
                                       ("whisper_tiny", (0, 1)),
                                       ("falcon_mamba_7b", (2, 4))])
def test_pipeline_equals_the_reference_bitwise(arch, host):
    """Tokens, labels and (whisper) frames, host-sharded included."""
    kw = dict(batch=8, seq=24, seed=5, host_index=host[0],
              host_count=host[1])
    mine = SyntheticLM(pt_cfgs.get_smoke_config(arch), **kw)
    ref = RefSyntheticLM(ref_cfgs.get_smoke_config(arch), **kw)
    for step in (0, 3):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

ARCH = "falcon_mamba_7b"


def _ref_state(dtype):
    cfg = ref_cfgs.get_smoke_config(ARCH)
    params = ref_tf.init_params(jax.random.key(0), cfg, dtype)
    opt_cfg = ref_adamw.AdamWConfig()
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, opt = ref_adamw.apply_updates(
        params, grads, ref_adamw.init_state(params, opt_cfg), opt_cfg)
    return {"params": params, "opt": opt}


def _port_like(dtype):
    params = pt_tf.abstract_params(pt_cfgs.get_smoke_config(ARCH), dtype)
    return {"params": params,
            "opt": adamw.init_state(params, adamw.AdamWConfig())}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    """The reference's `{"params", "opt": AdamWState}` checkpoint (keys
    params/..., opt/.step, opt/.m/...) restores into the port's tree;
    bf16 leaves, which np.load returns as 2-byte voids, through their
    bits."""
    state = _ref_state(getattr(jnp, dtype))
    RefManager(str(tmp_path)).save(3, state, blocking=True)
    with open(tmp_path / "step_3" / "manifest.json") as f:
        assert '"opt/.step"' in f.read()
    out = CheckpointManager(str(tmp_path)).restore(
        3, _port_like(getattr(torch, dtype)), device="cpu")
    assert isinstance(out["opt"], adamw.AdamWState)
    want = dict(tree_flatten_with_path(jax.tree.map(np.asarray, state)))
    got = tree_flatten_with_path(out)
    assert {k for k, _ in got} == set(want)
    for k, t in got:
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k
        np.testing.assert_array_equal(t.float().numpy(),
                                      want[k].astype(np.float32), err_msg=k)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port's fp32 params and AdamW state, saved by its manager, read
    back by the reference's restore into its own tree."""
    cfg = pt_cfgs.get_smoke_config(ARCH)
    params = pt_tf.init_params(torch.Generator().manual_seed(1), cfg,
                               torch.float32, device="cpu")
    opt_cfg = adamw.AdamWConfig()
    params, opt = adamw.apply_updates(
        params, tree_map(lambda p: torch.full_like(p, 0.01), params),
        adamw.init_state(params, opt_cfg), opt_cfg)
    CheckpointManager(str(tmp_path)).save(2, {"params": params, "opt": opt},
                                          blocking=True)
    cfg_r = ref_cfgs.get_smoke_config(ARCH)
    like_p = ref_tf.abstract_params(cfg_r, jnp.float32)
    like = {"params": like_p,
            "opt": ref_adamw.abstract_state(like_p, ref_adamw.AdamWConfig())}
    out = RefManager(str(tmp_path)).restore(2, like)
    got = dict(tree_flatten_with_path(jax.tree.map(np.asarray, out)))
    mine = tree_flatten_with_path({"params": params, "opt": opt})
    assert {k for k, _ in mine} == set(got)
    for k, t in mine:
        np.testing.assert_array_equal(t.numpy(), got[k], err_msg=k)
