"""The port's dry run (repro_torch/launch/dryrun.py, profile_cell.py,
sweep.py) against the JAX package on the CPU: the step inputs, abstract
caches and optimizer states, per-position argument bytes under the
reference's own specs, and FLOPs against the reference's HLO cost walker
(repro.launch.hlo) on its jitted steps compiled for one CPU device; then
every cell at smoke size, the per-position attribution, and the sweep's
resume.

The reference's launch/dryrun.py, profile_cell.py and sweep.py are never
imported here: each sets XLA_FLAGS to 512 forced host devices at import,
which would hold for every later test of this worker. ACCUM_STEPS is read
from dryrun.py's source, and the reference's specs are built from
repro.configs, repro.models.transformer and repro.optim as its
input_specs builds them.
"""

import ast
import json
import math
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_cfgs
from repro.distributed import sharding as ref_shd
from repro.launch import hlo as ref_hlo
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_tf
from repro.optim import adafactor as ref_adafactor
from repro.optim import adamw as ref_adamw
from repro_torch import configs as pt_cfgs
from repro_torch.distributed import sharding as pt_shd
from repro_torch.launch import dryrun, opcost, profile_cell, sweep
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as pt_tf
from repro_torch.optim import adafactor as pt_adafactor
from repro_torch.optim import adamw as pt_adamw
from repro_torch.tree import tree_flatten_with_path

from test_torch_train import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROD = {"single": ((16, 16), ("data", "model")),
        "multi": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s) for a in ref_cfgs.ARCH_IDS
         for s, _, _, k in ref_cfgs.cells(a) if k != "skip"]
#: FLOPs of a smoke prefill against the reference's HLO walker, relative
#: (the falcon gap is the scan's C contraction, a dot in the reference's
#: chunked scan and inside the kernel here), and of a smoke train step
#: (the port recomputes the loss chunk's logits in the backward, one
#: (B, S, D) x (D, V) product that XLA merges with the forward's when the
#: chunk scan has one trip).
TOL_PREFILL_FLOPS, TOL_TRAIN_FLOPS = 0.02, 0.05
SEQ, BATCH = 64, 2


def ref_accum_steps() -> dict:
    """ACCUM_STEPS as the reference's launch/dryrun.py assigns it, read
    from its source (importing it would force 512 host devices)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "ACCUM_STEPS" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("ACCUM_STEPS not found")


def ref_input_specs(cfg, seq, batch, kind):
    """The reference's input_specs (its launch/dryrun.py:58-81)."""
    sd, i32, dt = jax.ShapeDtypeStruct, jnp.int32, jnp.bfloat16
    frames = ({"frames": sd((batch, cfg.encoder.n_ctx, cfg.d_model), dt)}
              if cfg.encoder is not None else {})
    if kind == "train":
        return {"tokens": sd((batch, seq), i32),
                "labels": sd((batch, seq), i32), **frames}
    if kind == "prefill":
        return {"tokens": sd((batch, seq), i32), **frames}
    return {"cache": ref_tf.abstract_decode_cache(cfg, batch, seq, dt),
            "tokens": sd((batch, 1), i32), "cache_pos": sd((), i32)}


def ref_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx",
                                                    getattr(p, "name", p))))
                     for p in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


def port_leaves(tree) -> dict:
    return {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for k, t in tree_flatten_with_path(tree)}


def test_accum_steps_match_reference():
    assert dryrun.ACCUM_STEPS == ref_accum_steps()
    assert dryrun.PARAM_DTYPE == torch.bfloat16


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    """Every input of every cell: the same keys, shapes and dtypes (a
    decode cell's cache leaf by leaf)."""
    seq, batch, kind = {s: (q, b, k)
                        for s, q, b, k in ref_cfgs.cells(arch)}[shape]
    want = ref_input_specs(ref_cfgs.get_config(arch), seq, batch, kind)
    got = dryrun.input_specs(pt_cfgs.get_config(arch), seq, batch, kind)
    assert set(got) == set(want)
    for k in want:
        if k == "cache":
            assert port_leaves(got[k]) == ref_leaves(want[k])
        else:
            assert (tuple(got[k].shape), got[k].dtype.itemsize) == \
                (want[k].shape, want[k].dtype.itemsize), k
            assert str(got[k].dtype).removeprefix("torch.") == \
                str(want[k].dtype)


@pytest.fixture(scope="module")
def abstract():
    """Per arch, once: the reference's and the port's abstract params
    (bf16, the dry run's dtype)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = (
                ref_tf.abstract_params(ref_cfgs.get_config(arch),
                                       jnp.bfloat16),
                pt_tf.abstract_params(pt_cfgs.get_config(arch),
                                      torch.bfloat16))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ref_cfgs.ARCH_IDS)
def test_abstract_trees_match_reference(abstract, arch):
    """abstract_decode_cache and both optimizers' abstract_state, leaf by
    leaf, at the full config."""
    cr, cp = ref_cfgs.get_config(arch), pt_cfgs.get_config(arch)
    want = ref_tf.abstract_decode_cache(cr, 4, 64, jnp.bfloat16)
    got = pt_tf.abstract_decode_cache(cp, 4, 64, torch.bfloat16)
    assert port_leaves(got) == ref_leaves(want)
    assert all(t.device.type == "meta" for _, t in
               tree_flatten_with_path(got))
    ref_p, port_p = abstract(arch)
    for dt_ref, dt_port in ((jnp.float32, torch.float32),
                            (jnp.bfloat16, torch.bfloat16)):
        want = ref_adamw.abstract_state(
            ref_p, ref_adamw.AdamWConfig(state_dtype=dt_ref))
        got = pt_adamw.abstract_state(
            port_p, pt_adamw.AdamWConfig(state_dtype=dt_port))
        assert port_leaves(got.m) == ref_leaves(want.m)
        assert port_leaves(got.v) == ref_leaves(want.v)
        assert (tuple(got.step.shape), got.step.dtype) == \
            ((), torch.int32) and got.step.device.type == "meta"
    want = ref_adafactor.abstract_state(ref_p,
                                        ref_adafactor.AdafactorConfig())
    got = pt_adafactor.abstract_state(port_p,
                                      pt_adafactor.AdafactorConfig())
    for name in ("vr", "vc", "m"):
        assert port_leaves(getattr(got, name)) == \
            ref_leaves(getattr(want, name)), name


def ref_held_bytes(tree, specs, sizes: dict) -> int:
    """One position's bytes of `tree` under the reference's
    PartitionSpecs."""
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(leaves, specs):
        shards = 1
        for ax in spec:
            for a in (() if ax is None else ax if isinstance(ax, tuple)
                      else (ax,)):
                shards *= sizes[a]
        total += math.prod(leaf.shape) // shards * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh", list(PROD))
@pytest.mark.parametrize("arch", ref_cfgs.ARCH_IDS)
def test_argument_bytes_match_reference_specs(abstract, arch, mesh):
    """Per position, on both production meshes, for every cell: the
    params, AdamW's moments and step, and the inputs under the port's
    specs, against the same under the reference's specs on its stand-in
    mesh (tests/test_torch_mesh.py:ref_mesh)."""
    shape, axes = PROD[mesh]
    ref_mesh = types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(shape, object))
    sizes = dict(zip(axes, shape))
    port_mesh = make_production_mesh(multi_pod=mesh == "multi",
                                     devices=["meta"] * math.prod(shape))
    cr, cp = ref_cfgs.get_config(arch), pt_cfgs.get_config(arch)
    ref_p, port_p = abstract(arch)
    p_specs = ref_shd.param_specs(ref_p, cr, ref_mesh)
    held = ref_held_bytes(ref_p, p_specs, sizes)
    big = cr.n_params > 50e9
    for shape_name, seq, batch, kind in ref_cfgs.cells(arch):
        if kind == "skip":
            continue
        inputs = ref_input_specs(cr, seq, batch, kind)
        want = held
        if kind == "train":
            st = ref_adamw.abstract_state(ref_p, ref_adamw.AdamWConfig(
                state_dtype=jnp.bfloat16 if big else jnp.float32))
            want += 2 * ref_held_bytes(st.m, p_specs, sizes) + 4
        if kind == "decode":
            cache = inputs.pop("cache")
            want += ref_held_bytes(
                cache, ref_shd.cache_specs(cache, cr, ref_mesh), sizes)
        want += ref_held_bytes(
            inputs, ref_shd.batch_specs(inputs, ref_mesh), sizes)
        opt_cfg = pt_adamw.AdamWConfig(
            state_dtype=torch.bfloat16 if big else torch.float32)
        got = dryrun.specs_argument(cp, kind, seq, batch, port_mesh,
                                    opt_cfg=opt_cfg, params=port_p)
        assert got == want, (shape_name, got, want)


def ref_step_flops(arch: str, kind: str) -> float:
    """HloCost's FLOPs of the reference's jitted smoke step (fp32),
    compiled for one CPU device."""
    cfg = ref_cfgs.get_smoke_config(arch)
    params = ref_tf.abstract_params(cfg, jnp.float32)
    sd = jax.ShapeDtypeStruct
    batch = {"tokens": sd((BATCH, SEQ), jnp.int32)}
    if cfg.encoder is not None:
        batch["frames"] = sd((BATCH, cfg.encoder.n_ctx, cfg.d_model),
                             jnp.float32)
    if kind == "prefill":
        lowered = jax.jit(ref_steps.make_prefill_step(cfg, SEQ)).lower(
            params, batch)
    else:
        batch["labels"] = sd((BATCH, SEQ), jnp.int32)
        opt = ref_adamw.AdamWConfig()
        lowered = jax.jit(ref_steps.make_train_step(cfg, opt)).lower(
            params, ref_adamw.abstract_state(params, opt), batch)
    return ref_hlo.HloCost(lowered.compile().as_text()).total().flops


@pytest.mark.parametrize("arch,kind", [("qwen2_5_3b", "prefill"),
                                       ("whisper_tiny", "prefill"),
                                       ("falcon_mamba_7b", "prefill"),
                                       ("qwen2_5_3b", "train")])
def test_flops_match_reference_hlo(arch, kind):
    want = ref_step_flops(arch, kind)
    traced = dryrun.trace_step(pt_cfgs.get_smoke_config(arch), kind, SEQ,
                               BATCH, dtype=torch.float32)
    by_unit = traced["mode"].totals().flops_by_unit
    got = by_unit["fp32"]
    tol = TOL_PREFILL_FLOPS if kind == "prefill" else TOL_TRAIN_FLOPS
    assert abs(got - want) / want <= tol, (got, want)
    if kind == "prefill":
        # the scan kernel's C contraction (2 B L D N) is the whole gap
        assert got + 2 * by_unit.get("sfu", 0) == want


def test_every_cell_at_smoke_size():
    """run_cell on every arch x shape x production mesh at smoke size:
    each ok or skip (long_500k for the eight full-attention archs on both
    meshes), never an error; position 0 holds what the specs give it in a
    train or prefill cell."""
    records = dryrun.run_all(ref_cfgs.ARCH_IDS, list(ref_cfgs.SHAPES),
                             [False, True], smoke=True)
    assert len(records) == 80
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error"))
           for r in records if r["status"] not in ("ok", "skip")]
    assert not bad, bad
    skips = [r for r in records if r["status"] == "skip"]
    assert len(skips) == 16 and {r["shape"] for r in skips} == {"long_500k"}
    for r in records:
        if r["status"] != "ok":
            continue
        mem = r["memory"]
        assert mem["peak_bytes"] == (mem["argument_size_in_bytes"]
                                     + mem["temp_size_in_bytes"])
        assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                               "collective")
        if r["kind"] != "decode":
            assert mem["argument_size_in_bytes"] == \
                mem["argument_by_specs_bytes"], (r["arch"], r["shape"])
        if r["kind"] == "train":
            assert r["collectives"]["all-gather"] > 0
        scans = r["launches"].get("selective_scan", 0)
        assert (scans > 0) == (r["arch"] in ("falcon_mamba_7b",
                                             "jamba_v0_1_52b")
                               and r["kind"] != "decode"), r["arch"]


def test_position_zero_runs_one_group():
    """The attribution the module docstring states: on a (2, 1) mesh,
    position 0 runs one of the two data groups -- half the whole step's
    matmul FLOPs -- holds half of each data-sharded leaf, and updates
    only its own pieces; the whole program on one device holds it all."""
    cfg = pt_cfgs.get_smoke_config("qwen2_5_3b")
    mesh = make_host_mesh(1, devices=["meta"] * 2)
    pos0 = dryrun.trace_step(cfg, "train", SEQ, 4, mesh=mesh,
                             dtype=torch.float32)
    whole = dryrun.trace_step(cfg, "train", SEQ, 4, mesh=mesh,
                              dtype=torch.float32, one_device=True)
    f0, fw = (t["mode"].totals().flops for t in (pos0, whole))
    assert 2 * f0 == fw
    assert pos0["local_batch"] == 2 and whole["local_batch"] == 4
    assert pos0["argument"] < whole["argument"]
    upd0, updw = (sum(r.bytes for r in t["mode"].rows
                      if r.fn == "optim/adamw.py:upd")
                  for t in (pos0, whole))
    assert 0 < upd0 < updw
    assert pos0["mode"].temp_peak < whole["mode"].temp_peak
    assert pos0["mode"].totals().coll_bytes > 0
    assert whole["mode"].totals().coll_bytes == 0


def test_profile_cell_and_cli(capsys, tmp_path):
    assert profile_cell.main(["--arch", "falcon_mamba_7b", "--shape",
                              "prefill_32k", "--smoke", "--top", "5"]) == 0
    out = capsys.readouterr().out
    assert "top 5 ops" in out and "kernel:selective_scan" in out
    path = tmp_path / "dr.jsonl"
    assert dryrun.main(["--arch", "qwen2_5_3b", "--shape", "long_500k",
                        "--smoke", "--out", str(path)]) == 0
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["status"] for r in recs] == ["skip", "skip"]


def test_sweep_resumes_from_partial_results(tmp_path, monkeypatch):
    """Cells recorded ok or skip are not run again; errored and missing
    ones are, appended to --out."""
    done = [{"arch": a, "shape": s, "mesh": m, "status": "ok"}
            for a in ref_cfgs.ARCH_IDS[:3] for s in ref_cfgs.SHAPES
            for m in ("single", "multi")]
    done[0]["status"] = "error"
    (tmp_path / "old.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in done) + "not json\n")
    ran = []

    def fake(arch, shape, *, multi_pod, smoke=False):
        ran.append((arch, shape, "multi" if multi_pod else "single"))
        return {"arch": arch, "shape": shape, "mesh": ran[-1][2],
                "status": "ok"}

    monkeypatch.setattr(dryrun, "run_cell", fake)
    out = tmp_path / "new.jsonl"
    assert sweep.main(["--results-dir", str(tmp_path), "--out",
                       str(out)]) == 0
    assert len(ran) == 80 - len(done) + 1
    assert (done[0]["arch"], done[0]["shape"], done[0]["mesh"]) in ran
    assert len(out.read_text().splitlines()) == len(ran)
    ran.clear()
    assert sweep.main(["--results-dir", str(tmp_path), "--out",
                       str(out)]) == 0
    assert ran == []
