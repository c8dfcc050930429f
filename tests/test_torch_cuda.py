"""The CUDA kernel against its plain version, on the card. Each test skips
without a CUDA device; on the card run

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports JAX, which that machine lacks.)
"""

import pytest
import torch

from repro_torch.core import plan as pt_plan
from repro_torch.kernels import ops
from repro_torch.kernels import winograd as kw

#: fp32 transforms and FMAs on both sides, C summed in another order.
TOL = 2e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("k,compute_dtype,tile", [
    (2, "float32", None), (3, "float32", None), (4, "float32", None),
    (5, "float32", None), (7, "float32", None), (3, "float32", 6),
    (3, "bfloat16", None), (3, "int8", None)])
def test_kernel_matches_plain_version(cuda, k, compute_dtype, tile):
    g = torch.Generator().manual_seed(k)
    n, h, w, c, m = 2, 23, 17, 13, 40
    x = torch.randn(n, h, w, c, generator=g).to(cuda)
    wt = (torch.randn(k, k, c, m, generator=g) / (k * k * c) ** 0.5).to(cuda)
    bias = torch.randn(m, generator=g).to(cuda)
    plan = pt_plan.plan_conv2d((n, h, w, c), wt, algorithm="pallas_winograd",
                               compute_dtype=compute_dtype, output_tile=tile,
                               device=cuda)
    s = plan.spec.stream
    xp = ops.pad_streamed_input(x, plan.spec.geometry, s)
    args = dict(ct_h=plan.spec.ct_h, ct_w=plan.spec.ct_w, bh=s.bh, bw=s.bw,
                activation="gelu")
    before = kw.winograd_streamed.LAUNCHES
    got = kw.winograd_streamed(xp, plan.u, bias, plan.scale,
                               block_m=s.block_m, **args)
    torch.cuda.synchronize()
    assert kw.winograd_streamed.LAUNCHES == before + 1
    want = kw.winograd_streamed_plain(xp, plan.u, bias, plan.scale, **args)
    err = (got - want).abs().max() / want.abs().max()
    assert float(err) <= TOL


def test_kernel_rejects_bad_operands(cuda):
    plan = pt_plan.plan_conv2d((1, 8, 8, 8), torch.randn(3, 3, 8, 16),
                               algorithm="pallas_winograd", device=cuda)
    s = plan.spec
    xp = torch.zeros(1, 10, 10, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        kw.winograd_streamed(xp.double(), plan.u, None, ct_h=s.ct_h,
                             ct_w=s.ct_w, bh=s.stream.bh, bw=s.stream.bw,
                             block_m=s.stream.block_m)
    with pytest.raises(RuntimeError, match="blocking"):
        kw.winograd_streamed(xp, plan.u, None, ct_h=s.ct_h, ct_w=s.ct_w,
                             bh=1, bw=1, block_m=16)
