"""The LM's meshes in the port against the JAX package on the CPU: the
partition specs leaf by leaf (`param_specs` for all ten archs at their full
configs, `batch_specs`, `cache_specs` with their fallbacks) on the
production mesh shapes and three host shapes, through stand-in meshes (the
spec code reads only axis names and sizes); the activation rules and
`shard_activations`' guard; mesh construction; placement and its inverse;
the int8 pod mean against the reference's `shard_map` on four forced host
devices (one subprocess); and `Server(mesh=)`'s tokens.
"""

import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

from repro import configs as ref_cfgs
from repro.distributed import context as ref_dist
from repro.distributed import sharding as ref_shd
from repro.models import transformer as ref_tf
from repro_torch import configs as pt_cfgs
from repro_torch.distributed import context as pt_dist
from repro_torch.distributed import sharding as pt_shd
from repro_torch.launch import mesh as pt_mesh
from repro_torch.launch import serve as pt_serve
from repro_torch.models import transformer as pt_tf
from repro_torch.optim import compression as pt_comp
from repro_torch.tree import tree_flatten_with_path

from test_torch_train import one_thread  # noqa: F401

#: (shape, axes) of the meshes the specs are compared on: the production
#: single- and multi-pod meshes and three host meshes.
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((8, 1), ("data", "model")),
          ((4, 2), ("data", "model")),
          ((2, 4), ("data", "model")))
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


def ref_mesh(shape, axes):
    """The reference's stand-in mesh (tests/test_sharding.py:fake_mesh)."""
    return types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, object))


def port_mesh(shape, axes):
    """The port's mesh of that shape over "meta" positions."""
    n = int(np.prod(shape))
    return pt_mesh.Mesh((torch.device("meta"),) * n, axes, shape)


def norm(spec) -> tuple:
    """A spec as a tuple, a one-name tuple entry as the bare name."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def ref_flat(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, RefP))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): norm(s) for path, s in flat}


def port_flat(specs) -> dict:
    return {k: norm(s) for k, s in tree_flatten_with_path(specs)}


@pytest.fixture(scope="module")
def trees():
    """Per arch, once: the reference's abstract params (bf16, as its
    tests) and decode caches (batch 128 x 1024 rows and batch 1 x 2048),
    and the port's "meta" counterparts."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cr, cp = ref_cfgs.get_config(arch), pt_cfgs.get_config(arch)
            cache[arch] = (
                cr, cp, ref_tf.abstract_params(cr, jnp.bfloat16),
                pt_tf.abstract_params(cp, torch.bfloat16),
                {b: ref_tf.abstract_decode_cache(cr, b, n, jnp.bfloat16)
                 for b, n in ((128, 1024), (1, 2048))},
                {b: pt_tf.init_decode_cache(cp, b, n, torch.bfloat16,
                                            device="meta")
                 for b, n in ((128, 1024), (1, 2048))})
        return cache[arch]
    return get


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ref_cfgs.ARCH_IDS)
def test_param_specs_match_reference(trees, arch, mesh):
    cr, cp, ref_p, port_p, _, _ = trees(arch)
    want = ref_flat(ref_shd.param_specs(ref_p, cr, ref_mesh(*mesh)))
    got = port_flat(pt_shd.param_specs(port_p, cp, port_mesh(*mesh)))
    assert list(got) == list(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ref_cfgs.ARCH_IDS)
def test_cache_specs_match_reference(trees, arch, mesh):
    """Both batch sizes: the KV heads, else the head dim (jamba's 8 KV
    heads on a 16-way model axis), over model; batch 1 puts the data axes
    on the sequence."""
    cr, cp, _, _, ref_c, port_c = trees(arch)
    for b in ref_c:
        want = ref_flat(ref_shd.cache_specs(ref_c[b], cr, ref_mesh(*mesh)))
        got = port_flat(pt_shd.cache_specs(port_c[b], cp, port_mesh(*mesh)))
        assert got == want, b


def test_cache_specs_fallbacks():
    """The fallbacks the comparison covers: jamba's KV head dim on the
    model axis, and the sequence axis at batch 1."""
    cfg = pt_cfgs.get_config("jamba_v0_1_52b")
    mesh = port_mesh((16, 16), ("data", "model"))
    for b, n, at in ((128, 1024, 1), (1, 2048, 2)):
        cache = pt_tf.init_decode_cache(cfg, b, n, device="meta")
        kv = pt_shd.cache_specs(cache, cfg, mesh)["layer_4"]["k"]
        assert kv[4] == "model" and kv[3] is None
        assert norm(kv)[at] == "data"


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_batch_specs_match_reference(mesh):
    sd = jax.ShapeDtypeStruct
    for rows in (256, 6, 1):
        ref_b = {"tokens": sd((rows, 4096), jnp.int32),
                 "labels": sd((rows, 4096), jnp.int32),
                 "frames": sd((rows, 1500, 384), jnp.float32)}
        port_b = {k: torch.empty(v.shape, device="meta")
                  for k, v in ref_b.items()}
        want = ref_flat(ref_shd.batch_specs(ref_b, ref_mesh(*mesh)))
        got = port_flat(pt_shd.batch_specs(port_b, port_mesh(*mesh)))
        assert got == want, rows


def test_guard_matches_reference():
    cases = [((512, 256), ("data", "model")), ((40, 128, 64),
                                                ("model", "data", None)),
             ((64, 8), (("pod", "data"), None)), ((30, 8), (("pod", "data"),
                                                             None)),
             ((32, 32, 32), ("data",))]
    for shape, spec in cases:
        for mshape, axes in MESHES[:2]:
            if "pod" in str(spec) and "pod" not in axes:
                continue
            want = ref_shd._guard(ref_mesh(mshape, axes), shape, RefP(*spec))
            got = pt_shd._guard(port_mesh(mshape, axes), shape,
                                pt_shd.P(*spec))
            assert norm(got) == norm(want), (shape, spec)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_activation_rules_and_guard_match_reference(monkeypatch, mesh):
    """default_activation_rules, and which spec shard_activations'
    guard lets through for each shape: the reference's, recorded at its
    with_sharding_constraint, against the port's activation_spec; the
    port's constraint itself is the identity."""
    rm, pm = ref_mesh(*mesh), port_mesh(*mesh)
    want_rules = {k: norm(v) for k, v in
                  ref_dist.default_activation_rules(rm).items()}
    assert {k: norm(v) for k, v in
            pt_dist.default_activation_rules(pm).items()} == want_rules
    seen = []
    monkeypatch.setattr(ref_dist, "NamedSharding", lambda m, s: s)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(norm(s)) or x)
    monkeypatch.setattr(ref_dist._state, "ctx",
                        (rm, ref_dist.default_activation_rules(rm)),
                        raising=False)
    with pt_dist.use_mesh(pm):
        assert pt_dist.active_mesh() is pm
        for shape in ((512, 32, 64), (6, 32, 64), (32, 1, 64),
                      (512, 16, 8)):
            for kind in ("residual", "decode", "other"):
                seen.clear()
                ref_dist.shard_activations(jnp.zeros(shape), kind)
                got = pt_dist.activation_spec(shape, kind)
                assert (seen[0] if seen else None) == \
                    (None if got is None else norm(got)), (shape, kind)
                x = torch.zeros(shape)
                assert pt_dist.shard_activations(x, kind) is x
    assert pt_dist.active_mesh() is None
    assert pt_dist.activation_spec((512, 32, 64), "residual") is None


# ---------------------------------------------------------------------------
# meshes and placement
# ---------------------------------------------------------------------------

def test_meshes():
    m = pt_mesh.make_host_mesh(2, devices=["cpu"] * 4)
    assert m.axis_names == ("data", "model") and m.shape == {"data": 2,
                                                              "model": 2}
    assert m.coords(3) == {"data": 1, "model": 1}
    assert m.distinct_devices() == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="positive divisor of the 4"):
        pt_mesh.make_host_mesh(3, devices=["cpu"] * 4)
    prod = pt_mesh.make_production_mesh(devices=["meta"] * 256)
    assert prod.shape == {"data": 16, "model": 16}
    multi = pt_mesh.make_production_mesh(multi_pod=True,
                                         devices=["meta"] * 512)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="needs 256 devices, 4 named"):
        pt_mesh.make_production_mesh(devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="positive divisor of the 0"):
            pt_mesh.make_host_mesh()
        with pytest.raises(ValueError, match="0 CUDA device"):
            pt_mesh.make_production_mesh()
    data = pt_mesh.make_data_mesh(devices=["cpu"] * 4)
    assert data.shape == {"data": 4} and data.axis_sizes == (4,)


@pytest.mark.parametrize("model_parallel", [1, 2, 4])
def test_device_put_and_gather_roundtrip(model_parallel):
    """Pieces at their specs' shapes, one per shard index (the positions
    repeat the CPU), and the gather bitwise equal to the tree put."""
    cfg = pt_cfgs.get_smoke_config("jamba_v0_1_52b")
    params = pt_tf.init_params(torch.Generator().manual_seed(0), cfg,
                               torch.float32, device="cpu")
    mesh = pt_mesh.make_host_mesh(model_parallel, devices=["cpu"] * 4)
    specs = pt_shd.param_specs(params, cfg, mesh)
    placed = pt_shd.device_put(params, pt_shd.sharding_tree(specs, mesh))
    sizes = mesh.shape
    for (k, p), (_, spec) in zip(tree_flatten_with_path(placed),
                                 tree_flatten_with_path(specs)):
        counts = [int(np.prod([sizes[a] for a in (ax if isinstance(ax, tuple)
                                                  else (ax,))]))
                  if ax is not None else 1 for ax in spec]
        assert len(p.pieces) == int(np.prod(counts) if counts else 1), k
        for (index, dev), t in p.pieces.items():
            assert dev == torch.device("cpu")
            assert tuple(t.shape) == tuple(
                s // c for s, c in zip(p.shape, counts + [1] * (
                    len(p.shape) - len(counts)))), k
    back = pt_shd.gather_tree(placed, "cpu")
    for (k, a), (_, b) in zip(tree_flatten_with_path(params),
                              tree_flatten_with_path(back)):
        assert torch.equal(a, b), k


def test_placed_forward_prefill_and_decode_match_unplaced():
    """The serving entry points on a placed tree: the same numbers as on
    the whole tree (the gathers copy, nothing else changes)."""
    cfg = pt_cfgs.get_smoke_config("whisper_tiny")
    params = pt_tf.init_params(torch.Generator().manual_seed(1), cfg,
                               torch.float32, device="cpu")
    mesh = pt_mesh.make_host_mesh(2, devices=["cpu"] * 4)
    placed = pt_shd.device_put(params, pt_shd.param_shardings(params, cfg,
                                                              mesh))
    rng = np.random.default_rng(0)
    tok = torch.tensor(rng.integers(0, cfg.vocab, (2, 6)))
    frames = torch.tensor(rng.standard_normal(
        (2, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32))
    want = pt_tf.forward_logits(params, tok, cfg, frames)
    assert torch.equal(pt_tf.forward_logits(placed, tok, cfg, frames), want)
    (l1, c1), (l2, c2) = (pt_tf.prefill(p, tok, cfg, 8, frames)
                          for p in (params, placed))
    assert torch.equal(l1, l2)
    d1 = pt_tf.decode_step(params, c1, tok[:, :1], 6, cfg)[0]
    d2 = pt_tf.decode_step(placed, c2, tok[:, :1], 6, cfg)[0]
    assert torch.equal(d1, d2)


def test_server_on_a_mesh_matches_the_meshless_server():
    """Server(mesh=) with the params placed on (2, 2), and with them
    whole: the tokens and ticks of the mesh-less server."""
    cfg = pt_cfgs.get_smoke_config("qwen2_5_3b")
    params = pt_tf.init_params(torch.Generator().manual_seed(0), cfg,
                               torch.float32, device="cpu")
    mesh = pt_mesh.make_host_mesh(2, devices=["cpu"] * 4)
    placed = pt_shd.device_put(params, pt_shd.param_shardings(params, cfg,
                                                              mesh))

    def serve(p, **kw):
        rng = np.random.default_rng(0)
        reqs = [pt_serve.Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, size=(4,)), max_new=int(n))
            for i, n in enumerate((3, 7, 2, 5, 6))]
        done, ticks = pt_serve.Server(cfg, p, max_batch=3, max_len=24,
                                      **kw).run(reqs)
        return [(r.rid, r.out) for r in done], ticks

    want = serve(params, device="cpu")
    assert serve(params, mesh=mesh) == want
    assert serve(placed, mesh=mesh) == want
    with pytest.raises(ValueError, match="not both"):
        pt_serve.Server(cfg, params, mesh=mesh, device="cpu")


# ---------------------------------------------------------------------------
# the int8 cross-pod mean
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def test_pod_mean_int8_matches_reference_shard_map(tmp_path):
    """Two rounds of the int8 pod mean with error feedback over four pods:
    the reference's pod_mean_int8 inside its shard_map on four forced host
    devices (a subprocess), the port's on one tensor per pod. The means
    agree to 1e-6; the new errors agree to fp32 rounding of the largest
    entry but where a code sits at a rounding boundary, where they differ
    by one quantization step."""
    rng = np.random.default_rng(0)
    gs = rng.standard_normal((2, 4, 96)).astype(np.float32)
    gs[:, 2] *= 10.0                                  # one loud pod
    np.save(tmp_path / "gs.npy", gs)
    code = f"""
        import json, numpy as np, jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from repro.distributed.sharding import shard_map
        from repro.optim import compression as comp
        assert jax.device_count() == 4
        mesh = jax.make_mesh((4,), ("pod",))
        fn = jax.jit(shard_map(
            lambda g, e: tuple(o[None] for o in comp.pod_mean_int8(
                g[0], e[0], "pod")), mesh=mesh,
            in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")),
            check_replication=False))
        gs = np.load({str(tmp_path / "gs.npy")!r})
        err = jnp.zeros((4, 96))
        out = {{}}
        for r in range(2):
            mean, err = fn(jnp.asarray(gs[r]), err)
            out[r] = [np.asarray(mean).tolist(),
                      np.asarray(err).tolist()]
        print(json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=_SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    want = json.loads(run.stdout.strip().splitlines()[-1])
    errs = [torch.zeros(96) for _ in range(4)]
    for r in range(2):
        means, new = pt_comp.pod_mean_int8(
            [torch.tensor(g) for g in gs[r]], errs)
        w_mean, w_err = (np.asarray(a, np.float32) for a in want[str(r)])
        for m in means:
            assert np.abs(m.numpy() - w_mean[0]).max() <= \
                1e-6 * np.abs(w_mean[0]).max()
        for p in range(4):
            assert np.allclose(w_mean[p], w_mean[0])
            step = np.abs(gs[r, p] + errs[p].numpy()).max() / 127.0
            diff = np.abs(new[p].numpy() - w_err[p])
            off = diff > 1e-6 * 127.0 * step       # beyond fp32 rounding
            assert off.sum() <= 2 and np.allclose(diff[off], step,
                                                  rtol=1e-3), (r, p)
        errs = new
    trees, err_trees = pt_comp.pod_mean_int8_tree(
        [{"a": torch.tensor(g)} for g in gs[0]],
        [{"a": torch.zeros(96)} for _ in range(4)])
    direct, _ = pt_comp.pod_mean_int8([torch.tensor(g) for g in gs[0]],
                                      [torch.zeros(96)] * 4)
    assert all(torch.equal(t["a"], d) for t, d in zip(trees, direct))
    assert len(err_trees) == 4
