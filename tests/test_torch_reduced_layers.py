"""bf16 networks layer by layer: each plan of the port's bf16 network is
held against the JAX package's plan of the same layer on the input the
port's network gave it.

tests/test_torch_reduced.py holds bf16 networks only at the logits, to 0.1
of their magnitude: a 1e-7 difference upstream flips bf16 roundings
(`im2col` rounds its input activations to bf16) and grows to ~1e-3 at the
logits. Single bf16 layers, on the same input, agree far closer. Here
every conv layer's input is recorded as the port's `NetworkPlan.apply(x,
layer_hook=...)` runs (the hook confirms each plan ran once): each conv
node's plan, and each sub-plan of a (composed) separable or inverted
residual block, whose inner layers round to bf16 too. The reference's
plan of the same layer, from its own network compiled on the same weights
under the same algorithm and compute_dtype, runs on that input with the
same bias and activation. Both networks run their plain
executors (`winograd` / `im2col` families), whose placements are equal
leaf by leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile as ref_compile
from repro.models import cnn as ref_cnn
from repro_torch.core import compile as pt_compile
from repro_torch.models import cnn as pt_cnn

#: One bf16 layer, port against reference on the same input: the same
#: bf16 filter taps (bitwise) and, under `im2col`, the same bf16-rounded
#: activations, with fp32 transforms and sums in another order; single
#: layers read <= 1.9e-5 of their output's largest magnitude.
TOL_LAYER = 2e-5
RES, BATCH = 32, 2
NETS = ["vgg16", "mobilenet_v1", "mobilenet_v2"]
ALGORITHMS = ["winograd", "im2col"]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


@pytest.fixture(scope="module", autouse=True)
def _no_measure():
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_PLAN_NO_MEASURE", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module")
def nets():
    """name -> (reference params, port params on the CPU, input)."""
    out = {}
    for i, name in enumerate(NETS):
        specs = getattr(ref_cnn, name)()
        ref_params = ref_cnn.init_cnn(jax.random.key(30 + i), specs, 3,
                                      res=RES)
        x = np.random.default_rng(30 + i).standard_normal(
            (BATCH, RES, RES, 3)).astype(np.float32)
        out[name] = (ref_params, pt_cnn.params_from_reference(
            jax.tree.map(np.array, ref_params), "cpu"), x)
    return out


def _leaves(plans):
    """(label, ConvPlan) of every conv layer: a conv node's plan, and the
    composed separable and inverted-residual blocks' sub-plans (a fused
    block has none; the bf16 networks compose every block)."""
    for nid, p in plans.items():
        sep = getattr(p, "sep", None)
        if getattr(p, "expand", None) is not None:
            yield f"{nid}.expand", p.expand
        if sep is not None or hasattr(p, "dw"):
            block = sep if sep is not None else p
            yield f"{nid}.dw", block.dw
            yield f"{nid}.pw", block.pw
        else:
            yield nid, p


def _to_jax(v):
    return jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("name", NETS)
def test_bf16_layers_match_reference_on_recorded_inputs(nets, name,
                                                        algorithm):
    ref_params, pt_params, x = nets[name]
    net = pt_compile.compile(pt_params, getattr(pt_cnn, name)(), res=RES,
                             batch=BATCH, algorithm=algorithm,
                             compute_dtype="bfloat16", device="cpu")
    ref = ref_compile.compile(ref_params, getattr(ref_cnn, name)(), res=RES,
                              batch=BATCH, algorithm=algorithm,
                              compute_dtype="bfloat16")
    assert net.describe() == ref.describe()
    record, ran = {}, []
    leaves = dict(_leaves(net.plans))
    for label, plan in leaves.items():
        def recorded(*args, _label=label, _apply=plan.apply, **kwargs):
            y = _apply(*args, **kwargs)
            record.setdefault(_label, (args, kwargs, y))
            return y
        plan.apply = recorded
    try:
        net.apply(torch.from_numpy(x),
                  layer_hook=lambda nid, seconds: ran.append(nid))
    finally:
        for plan in leaves.values():
            del plan.apply
    assert sorted(ran) == sorted(net.plans)
    assert sorted(record) == sorted(leaves)
    assert any(p.spec.compute_dtype == "bfloat16" for p in leaves.values())
    ref_leaves = dict(_leaves(ref.plans))
    for label, (args, kwargs, y) in record.items():
        want = np.asarray(ref_leaves[label].apply(
            *[_to_jax(a) for a in args],
            **{k: _to_jax(v) for k, v in kwargs.items()}))
        got = y.numpy()
        assert got.shape == want.shape, label
        assert _rel(got, want) <= TOL_LAYER, (label, _rel(got, want))
