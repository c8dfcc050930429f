"""The port's continuous-batching LM server (launch/serve.py) against the
JAX package's on the same smoke params and requests: the completed
tokens, their order and the tick count must be equal (greedy), for
qwen2.5-3b (dense GQA) and jamba (the hybrid: Mamba, attention and MoE
layers), with three slots and with one. Also the CLI and the device
rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_cfgs
from repro.launch import serve as ref_serve
from repro.models import transformer as ref_tf
from repro_torch import configs as pt_cfgs
from repro_torch.launch import serve as pt_serve
from repro_torch.models import transformer as pt_tf


def _requests(mod, vocab, seed=0):
    """Seven requests, more than the slots: prompts of 3-6 tokens and
    max_new from 2 to 20, so that some finish at max_new and some at
    max_len - 1."""
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i,
                        prompt=rng.integers(0, vocab,
                                            size=(int(rng.integers(3, 7)),)),
                        max_new=int(n))
            for i, n in enumerate((2, 8, 20, 5, 12, 3, 20))]


@pytest.fixture(scope="module", params=["qwen2_5_3b", "jamba_v0_1_52b"])
def model(request):
    arch = request.param
    cfg_r = ref_cfgs.get_smoke_config(arch)
    cfg_p = pt_cfgs.get_smoke_config(arch)
    ref = ref_tf.init_params(jax.random.key(0), cfg_r, jnp.float32)
    port = pt_tf.params_from_reference(jax.tree.map(np.asarray, ref),
                                       device="cpu")
    return arch, cfg_r, cfg_p, ref, port


def _serve(mod, cfg, params, max_batch=3):
    if mod is ref_serve:
        srv = ref_serve.Server(cfg, params, max_batch=max_batch, max_len=20)
    else:
        srv = pt_serve.Server(cfg, params, max_batch=max_batch, max_len=20,
                              device="cpu")
    done, ticks = srv.run(_requests(mod, cfg.vocab))
    return [(r.rid, list(map(int, r.out)), r.done) for r in done], ticks, srv


@pytest.mark.parametrize("max_batch", [3, 1])
def test_server_matches_reference(model, max_batch):
    arch, cfg_r, cfg_p, ref, port = model
    want, want_ticks, _ = _serve(ref_serve, cfg_r, ref, max_batch)
    got, ticks, srv = _serve(pt_serve, cfg_p, port, max_batch)
    assert ticks == want_ticks
    assert got == want
    assert len(got) == 7 and all(d for _, _, d in got)
    # some requests stopped at max_len - 1 before reaching max_new
    assert any(len(out) < n for (_, out, _), n in
               zip(sorted(got), (2, 8, 20, 5, 12, 3, 20)))
    assert all(s is None for s in srv.slots)


def test_one_slot_server_is_greedy_prefill_then_decode(model):
    """A one-slot server's tokens are greedy decoding through prefill +
    decode_step, whose logits are forward_logits'. As in the reference,
    the server's first tick feeds the prompt's last token again, at
    position len(prompt), so the decoding here does too."""
    _, _, cfg, _, port = model
    req = pt_serve.Request(rid=0, prompt=np.array([5, 17, 3, 99, 42]),
                           max_new=6)
    srv = pt_serve.Server(cfg, port, max_batch=1, max_len=16, device="cpu")
    (done,), ticks = srv.run([req])
    assert ticks == 6
    toks = torch.tensor(req.prompt).long()[None]
    _, cache = pt_tf.prefill(port, toks, cfg, 16)
    fed, out, steps = [int(req.prompt[-1])], [], []
    for i in range(6):
        logits, cache = pt_tf.decode_step(port, cache, torch.tensor(
            [[fed[-1]]]), 5 + i, cfg)
        steps.append(logits)
        out.append(int(logits.argmax(-1)))
        fed.append(out[-1])
    assert done.out == out
    full = pt_tf.forward_logits(port, torch.cat(
        [toks, torch.tensor([fed[:-1]])], 1), cfg)
    for j, lg in enumerate(steps):
        ref = full[:, 5 + j]
        assert float((lg - ref).abs().max() / ref.abs().max()) <= 1e-5


def test_server_needs_params_on_its_device():
    cfg = pt_cfgs.get_smoke_config("qwen2_5_3b")
    params = pt_tf.init_params(torch.Generator(), cfg, torch.float32,
                               device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt_serve.Server(cfg, params)
    with pytest.raises(ValueError, match="the server on meta"):
        pt_serve.Server(cfg, params, device="meta")


def test_cli_on_cpu(capsys):
    pt_serve.main(["--arch", "qwen2_5_3b", "--smoke", "--requests", "5",
                   "--max-batch", "2", "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "qwen2.5-3b on cpu: 5 requests, 15 tokens" in out
    with pytest.raises(SystemExit, match="decoder-only"):
        pt_serve.main(["--arch", "whisper_tiny", "--smoke", "--device",
                       "cpu"])
