"""The port's six entry-point scripts (examples/torch/) on the CPU, each
through its `main(argv)` with --device cpu at a small size, held against
the JAX package's computation on the same inputs: the scripts' own seeded
numpy inputs and the port's seeded weights, carried over as numpy arrays.

- quickstart: every conv output against `repro.core.dispatch.conv2d`
  (the kernel paths against the reference's "winograd"), 1e-5;
- cnn_inference: SqueezeNet's logits at res 32 against the reference's
  `cnn_forward(..., algorithm="winograd")`, 1e-5 (never its
  "pallas_winograd": jax 0.9 lacks `pl.Unblocked`);
- serve_conv: MobileNet-v2's served answers, before and through the fault
  drill, against the same reference network, 1e-5;
- mamba_cook_toom: the conv1d (planned executor and kernel path) against
  `repro.core.winograd.ct_depthwise_causal_conv1d` and the Mamba block
  against `repro.models.mamba.mamba_block`, 1e-5;
- train_lm: the first step's loss against the mean of the reference's
  `transformer.forward` over the step's two microbatches, 1e-5 (the
  reference's `launch.train.train` fails on this host: a
  ShardingTypeError in its sharded step);
- serve_batched: the greedy tokens and the tick count equal the
  reference's `launch.serve.Server`'s.

Every script refuses to run without a card unless given --device cpu.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_cfgs
from repro.core import dispatch as ref_dispatch
from repro.core import winograd as ref_wg
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.launch import serve as ref_serve
from repro.models import cnn as ref_cnn
from repro.models import mamba as ref_ssm
from repro.models import transformer as ref_tf
from repro_torch import configs as pt_cfgs
from repro_torch.launch.train import train
from repro_torch.models import transformer as pt_tf

from test_torch_train import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ("quickstart", "cnn_inference", "serve_conv", "mamba_cook_toom",
           "train_lm", "serve_batched")
#: fp32 against fp32: the same arithmetic summed in other orders (the
#: repo's per-network and per-layer parity bound)
TOL = 1e-5


def script(name: str):
    """examples/torch/<name>.py as a module (the directory is no package)."""
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_ref(tree):
    """A tree of torch tensors as the same tree of jax arrays."""
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)


def rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def ref_logits(network: str, params, x: np.ndarray) -> np.ndarray:
    """The reference network on the port's weights, "winograd" executors."""
    specs = ref_cnn.NETWORKS[network][0]()
    p = to_ref(params)
    fn = jax.jit(lambda x: ref_cnn.cnn_forward(p, x, specs,
                                               algorithm="winograd"))
    return np.asarray(fn(jnp.asarray(x)))


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_needs_a_card_or_the_cpu_flag(name):
    """Without a card a script raises and names --device cpu; nothing falls
    back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        script(name).main([])


def test_quickstart_matches_reference():
    mod = script("quickstart")
    out = mod.main(["--device", "cpu", "--res", "12", "--channels", "8",
                    "--net-res", "32"])
    x, w, _ = mod.make_inputs(12, 8, 32)
    want = {a: np.asarray(ref_dispatch.conv2d(jnp.asarray(x), jnp.asarray(w),
                                              algorithm=a))
            for a in ("winograd", "im2col", "auto")}
    for name, y in out["outputs"].items():
        assert y.device.type == "cpu"
        err = rel(y, want.get(name, want["winograd"]))
        assert err <= TOL, (name, err)
    assert out["roundtrip_bitwise"]
    assert out["layers"] == 14 and out["fused"] == 13
    assert out["mult_reduction"]["F(4x4, 3x3)"] == 4.0


def test_cnn_inference_matches_reference():
    mod = script("cnn_inference")
    out = mod.main(["--device", "cpu", "--network", "squeezenet", "--res",
                    "32", "--iters", "1"])
    _, params, x = mod.make_inputs("squeezenet", 32, torch.device("cpu"))
    want = ref_logits("squeezenet", params, x.numpy())
    for algo in mod.ALGORITHMS:
        assert rel(out["logits"][algo], want) <= TOL, algo
    assert (out["conv_layers"], out["suitable"]) == (26, 9)


def test_serve_conv_matches_reference():
    mod = script("serve_conv")
    out = mod.main(["--device", "cpu", "--res", "32", "--requests", "4"])
    _, params, xs = mod.make_inputs("mobilenet_v2", 32, torch.device("cpu"))
    want = ref_logits("mobilenet_v2", params, np.stack(xs[:4]))
    assert rel(out["outputs"], want) <= TOL
    assert rel(out["drill_outputs"], want) <= TOL
    s = out["stats"]
    assert s["replacements"] == 1 and s["failed"] == 0
    assert s["in_flight"] == 0


def test_mamba_cook_toom_matches_reference():
    mod = script("mamba_cook_toom")
    out = mod.main(["--device", "cpu", "--batch", "2", "--length", "64",
                    "--channels", "32"])
    cfg = pt_cfgs.get_smoke_config("falcon_mamba_7b")
    x, w, p, xin = mod.make_inputs(cfg, 2, 64, 32, torch.device("cpu"))
    want = np.asarray(ref_wg.ct_depthwise_causal_conv1d(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy())))
    for name in ("cook_toom", "kernel", "direct"):
        assert rel(out["conv"][name], want) <= TOL, name
    cfg_r = ref_cfgs.get_smoke_config("falcon_mamba_7b")
    want = np.asarray(ref_ssm.mamba_block(to_ref(p), jnp.asarray(
        xin.numpy()), cfg_r))
    assert rel(out["block"], want) <= TOL
    cfg_d = dataclasses.replace(
        cfg_r, ssm=dataclasses.replace(cfg_r.ssm, conv_algorithm="direct"))
    want = np.asarray(ref_ssm.mamba_block(to_ref(p), jnp.asarray(
        xin.numpy()), cfg_d))
    assert rel(out["block_direct"], want) <= TOL


def test_train_lm_first_loss_matches_reference(tmp_path):
    """The first step's loss (accum 2: the mean of its two microbatches'
    losses) on the weights train() draws, torch.Generator seed 0."""
    mod = script("train_lm")
    out = mod.main(["--device", "cpu", "--smoke", "--steps", "6",
                    "--batch", "2", "--seq", "16",
                    "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()
    cfg = mod.make_config(16, smoke=True)
    params = to_ref(pt_tf.init_params(torch.Generator().manual_seed(0), cfg,
                                      torch.float32, device="cpu"))
    cfg_r = dataclasses.replace(ref_cfgs.get_smoke_config("qwen2_5_3b"),
                                max_seq=cfg.max_seq)
    batch = RefSyntheticLM(cfg_r, 2, 16).batch_at(0)
    loss = jax.jit(lambda p, b: ref_tf.forward(p, b, cfg_r))
    want = np.mean([float(loss(params, {k: v[i:i + 1]
                                        for k, v in batch.items()}))
                    for i in range(2)])
    assert abs(out["losses"][0] - want) <= TOL * abs(want)


def test_train_config_argument_trains_that_config():
    """train(config=) trains the given ArchConfig: the smoke config passed
    in reads the losses of smoke=True."""
    kw = dict(steps=2, batch=2, seq=8, ckpt_dir=None, log_every=100,
              device="cpu")
    _, want = train("qwen2_5_3b", smoke=True, **kw)
    cfg = pt_cfgs.get_smoke_config("qwen2_5_3b")
    _, got = train("any-name", smoke=False, config=cfg, **kw)
    assert got == want


def test_serve_batched_matches_reference():
    mod = script("serve_batched")
    out = mod.main(["--device", "cpu", "--requests", "4", "--max-new", "3"])
    cfg = pt_cfgs.get_smoke_config("qwen2_5_3b")
    params, reqs = mod.make_inputs(cfg, 4, 3, torch.device("cpu"))
    srv = ref_serve.Server(ref_cfgs.get_smoke_config("qwen2_5_3b"),
                           to_ref(params), max_batch=3, max_len=64)
    done, ticks = srv.run([ref_serve.Request(rid=r.rid, prompt=r.prompt,
                                             max_new=r.max_new)
                           for r in reqs])
    assert ticks == out["ticks"]
    assert {r.rid: list(map(int, r.out)) for r in done} == out["tokens"]
