"""The port's per-call API against the JAX package's on the same seeded
numpy inputs: `core.dispatch.conv2d` / `conv1d` under every requestable
algorithm family (stride 2, groups, NCHW, bias + activation), the per-call
`core.winograd.winograd_conv2d` executor, and the unplanned wrappers of
`kernels.ops` (`winograd_conv2d`, `im2col_conv2d`, `fft_conv2d`,
`winograd_f63_conv2d`).

On the CPU each kernel wrapper runs its plain version, so these check the
wrappers' planning, padding and epilogues; the kernels themselves are held
against their plain versions on the card (chip_smoke.py, phase 7). The
reference's `ops.winograd_conv2d` reaches its streamed Pallas kernel,
which does not run on jax 0.9, so the port's wrapper is held against the
reference's `core.winograd.winograd_conv2d` instead; the reference's
`ops.im2col_conv2d` runs its Pallas `matmul` in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as ref_dispatch
from repro.core import winograd as ref_wg
from repro.kernels import ops as ref_ops
from repro.kernels.runtime import epilogue_jnp as ref_epilogue
from repro_torch.core import dispatch as pt_dispatch
from repro_torch.core import plan as pt_plan
from repro_torch.core import winograd as pt_wg
from repro_torch.core.transforms import F63_FP32_ERROR_BUDGET
from repro_torch.kernels import ops as pt_ops

#: Output against the reference, relative max-abs error (of the
#: reference's max |y|): both sides run the same fp32 transforms and fp32
#: GEMMs summed in other orders.
TOL = 1e-5
#: FFT: both sides run fp32 FFTs that round differently
#: (tests/test_torch_fft_f63.py, TOL_FFT_PARITY).
TOL_FFT = 1e-5

ALGORITHMS = ("auto", "winograd", "im2col", "fft", "winograd_f63",
              "auto_tuned")

#: (name, x_shape, w_shape, stride, groups, padding, activation,
#: data_format): a dense 3x3, a stride-2 3x3, a depthwise, a grouped, a
#: 1x7, a VALID 5x5 and an NCHW layer (OIHW filter), odd sizes throughout.
CASES = [
    ("dense3x3", (2, 11, 9, 6), (3, 3, 6, 8), 1, 1, "SAME", "relu", "NHWC"),
    ("stride2", (2, 13, 10, 5), (3, 3, 5, 7), 2, 1, "SAME", "relu6",
     "NHWC"),
    ("depthwise", (2, 12, 9, 6), (3, 3, 1, 6), 1, 6, "SAME", "relu",
     "NHWC"),
    ("grouped", (2, 10, 10, 8), (3, 3, 4, 8), 1, 2, "SAME", "gelu", "NHWC"),
    ("1x7", (2, 9, 13, 5), (1, 7, 5, 6), 1, 1, "SAME", "relu", "NHWC"),
    ("valid5x5", (2, 14, 12, 4), (5, 5, 4, 6), 1, 1, "VALID", "none",
     "NHWC"),
    ("nchw", (2, 6, 11, 9), (8, 6, 3, 3), 1, 1, "SAME", "relu", "NCHW"),
]


@pytest.fixture(autouse=True)
def _fresh_port_cache(monkeypatch):
    """The port's spec cache must not leak between tests; auto_tuned
    decides by the static predicate on both sides (the reference's race
    cannot run on jax 0.9)."""
    monkeypatch.setenv("REPRO_PLAN_NO_MEASURE", "1")
    pt_plan.clear_plan_cache()
    yield
    pt_plan.clear_plan_cache()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _inputs(x_shape, w_shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    fan_in = int(np.prod(w_shape[:-1])) if len(w_shape) == 4 else 1
    w = (rng.standard_normal(w_shape) / np.sqrt(fan_in)).astype(np.float32)
    return x, w


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_conv2d_matches_reference(case, algorithm):
    """dispatch.conv2d with bias + activation: the same output as the
    reference's, or the same refusal where the family does not cover the
    layer."""
    _, x_shape, w_shape, stride, groups, padding, act, fmt = case
    x, w = _inputs(x_shape, w_shape)
    c_out = w_shape[0] if fmt == "NCHW" else w_shape[3]
    b = np.random.default_rng(1).standard_normal(c_out).astype(np.float32)
    kw = dict(stride=stride, padding=padding, algorithm=algorithm,
              groups=groups, activation=act, data_format=fmt)
    try:
        want = np.asarray(ref_dispatch.conv2d(
            jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b), **kw))
    except (ValueError, NotImplementedError) as e:
        with pytest.raises(type(e)):
            pt_dispatch.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                               bias=torch.from_numpy(b), **kw)
        return
    got = pt_dispatch.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                             bias=torch.from_numpy(b), **kw)
    assert tuple(got.shape) == want.shape
    tol = TOL_FFT if algorithm == "fft" else TOL
    assert _rel(_np(got), want) < tol


def test_conv2d_refusals_are_exercised():
    """The refusal branch of test_conv2d_matches_reference is reached: fft
    covers no stride-2 layer, while every case runs under auto and
    im2col."""
    refused = set()
    for case in CASES:
        _, x_shape, w_shape, stride, groups, padding, _, fmt = case
        for alg in ALGORITHMS:
            try:
                pt_plan.plan_conv2d(x_shape, torch.zeros(w_shape),
                                    stride=stride, padding=padding,
                                    algorithm=alg, groups=groups,
                                    data_format=fmt, device="cpu")
            except ValueError:
                refused.add((case[0], alg))
    assert ("stride2", "fft") in refused
    assert not {alg for _, alg in refused} & {"auto", "im2col"}


@pytest.mark.parametrize("algorithm", ["auto", "winograd", "im2col",
                                       "pallas_winograd"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("length", [20, 33])
def test_conv1d_matches_reference(length, stride, algorithm):
    x, w = _inputs((2, length, 6), (3, 6, 10))
    want = np.asarray(ref_dispatch.conv1d(
        jnp.asarray(x), jnp.asarray(w), stride=stride, algorithm=algorithm))
    got = pt_dispatch.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                             stride=stride, algorithm=algorithm)
    assert tuple(got.shape) == want.shape == (2, -(-length // stride), 10)
    assert _rel(_np(got), want) < TOL


@pytest.mark.parametrize("w_shape,output_tile", [
    ((3, 3, 6, 8), 4), ((3, 3, 6, 8), (2, 4)), ((1, 7, 6, 8), 2),
    ((7, 1, 6, 8), (2, 2)), ((1, 1, 6, 8), 4)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_per_call_winograd_conv2d_matches_reference(w_shape, output_tile,
                                                    padding):
    """core.winograd.winograd_conv2d: 3x3 on the 2D scheme, 1x7 / 7x1 on
    the single-axis path at F(2, 7), the tile plans give them (a per-axis
    tile tuple included), 1x1 as a channel GEMM."""
    x, w = _inputs((2, 11, 13, 6), w_shape)
    want = np.asarray(ref_wg.winograd_conv2d(
        jnp.asarray(x), jnp.asarray(w), output_tile=output_tile,
        padding=padding))
    got = pt_wg.winograd_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                output_tile=output_tile, padding=padding)
    assert tuple(got.shape) == want.shape
    assert _rel(_np(got), want) < TOL


@pytest.mark.parametrize("w_shape", [(3, 3, 6, 8), (5, 5, 6, 8),
                                     (1, 7, 6, 8)])
def test_ops_winograd_conv2d_matches_reference(w_shape):
    """ops.winograd_conv2d against the reference's per-call Winograd conv
    plus its epilogue, and bitwise equal to the planned pallas_winograd
    apply (the same chooser picks the blocking)."""
    x, w = _inputs((2, 12, 10, 6), w_shape)
    b = np.linspace(-1, 1, 8).astype(np.float32)
    want = np.asarray(ref_epilogue(
        ref_wg.winograd_conv2d(jnp.asarray(x), jnp.asarray(w),
                               output_tile=2 if w_shape[0] == 5 else 4),
        jnp.asarray(b), "relu"))
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    got = pt_ops.winograd_conv2d(xt, wt, bias=bt, activation="relu")
    assert _rel(_np(got), want) < TOL
    planned = pt_plan.plan_conv2d(x.shape, wt, algorithm="pallas_winograd",
                                  device="cpu")
    assert torch.equal(got, planned.apply(xt, bias=bt, activation="relu"))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("w_shape", [(3, 3, 5, 7), (1, 1, 5, 7)])
def test_ops_im2col_conv2d_matches_reference(w_shape, stride):
    """ops.im2col_conv2d against the reference's (its Pallas matmul in
    interpret mode), and bitwise equal to the planned pallas_im2col
    apply."""
    x, w = _inputs((2, 9, 11, 5), w_shape)
    b = np.linspace(-1, 1, 7).astype(np.float32)
    want = np.asarray(ref_ops.im2col_conv2d(
        jnp.asarray(x), jnp.asarray(w), stride=stride, bias=jnp.asarray(b),
        activation="relu6"))
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    got = pt_ops.im2col_conv2d(xt, wt, stride=stride, bias=bt,
                               activation="relu6")
    assert tuple(got.shape) == want.shape
    assert _rel(_np(got), want) < TOL
    planned = pt_plan.plan_conv2d(x.shape, wt, stride=stride,
                                  algorithm="pallas_im2col", device="cpu")
    assert torch.equal(got, planned.apply(xt, bias=bt, activation="relu6"))


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_ops_fft_and_f63_match_reference(padding):
    x, w = _inputs((2, 14, 11, 6), (3, 3, 6, 8))
    b = np.linspace(-1, 1, 8).astype(np.float32)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    for name, tol in (("fft_conv2d", TOL_FFT),
                      ("winograd_f63_conv2d", F63_FP32_ERROR_BUDGET)):
        want = np.asarray(getattr(ref_ops, name)(
            jnp.asarray(x), jnp.asarray(w), padding=padding,
            bias=jnp.asarray(b), activation="gelu"))
        got = getattr(pt_ops, name)(xt, wt, padding=padding, bias=bt,
                                    activation="gelu")
        assert tuple(got.shape) == want.shape
        assert _rel(_np(got), want) < tol, name
    with pytest.raises(ValueError, match="3x3 filters only"):
        pt_ops.winograd_f63_conv2d(xt, torch.zeros(5, 5, 6, 8))


def test_per_call_entry_points_run_on_the_input_device():
    """No device argument: a CPU tensor plans and runs on the CPU (where
    the plan-building entry points without device= would raise), and the
    reference's precision argument accepts only None."""
    x = torch.randn(1, 8, 8, 4)
    w = torch.randn(3, 3, 4, 4)
    assert pt_dispatch.conv2d(x, w).device.type == "cpu"
    assert pt_dispatch.conv1d(torch.randn(1, 9, 4),
                              torch.randn(3, 4, 5)).shape == (1, 9, 5)
    with pytest.raises(ValueError, match="precision"):
        pt_dispatch.conv2d(x, w, precision="highest")
    assert set(pt_dispatch.__all__) == set(ref_dispatch.__all__)
    assert pt_dispatch.ALGORITHMS == ref_dispatch.ALGORITHMS
