"""The TF32x3 split product of the tensor-core kernels (kernels/csrc/
mma_tf32x3.cuh), emulated in numpy on the CPU and held against float64.

Each fp32 operand is split a = hi + lo into two TF32 values (10 explicit
mantissa bits), hi = tf32(a) and lo = tf32(a - hi); every 8-deep k-step of
the m16n8k8 products adds hi*lo, lo*hi and hi*hi to an fp32 accumulator.
The GEMMs are the main path's at batch 1: VGG-16's point-GEMMs on F(4, 3)-
and F(2, 3)-transformed inputs (K = C <= 512), MobileNet-v1's sep14
pointwise GEMM (K = 1024), the matmul kernel's K = 1024 GEMM with an fp32,
bf16 and int8 B (kernels/csrc/matmul.cu: each 32-deep K step summed into
a zeroed fragment, then added in fp32), and the MobileNet stem's 4-phase
point-GEMM sum (winograd_strided_streamed.cu: F(4, 2), C = 3 padded to
one 8-channel step per phase, the four phases summed into one
accumulator). The kernels round with cvt.rna (ties away from zero);
round-to-nearest-even is emulated beside it, as the two differ only on
ties.
"""

import numpy as np
import pytest

from repro_torch.core import transforms as pt_tf
from repro_torch.models import cnn

#: The kernels' limit against their plain versions (chip_smoke.TOL_KERNEL).
TOL_KERNEL = 2e-5
#: The split product must leave the kernels most of that budget.
SPLIT_MARGIN = 10
ROUNDINGS = ("rna", "rne")


def tf32(a: np.ndarray, rounding: str) -> np.ndarray:
    """fp32 -> TF32 (kept in fp32): the low 13 mantissa bits rounded off,
    to nearest, ties away from zero ("rna") or to even ("rne")."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    if rounding == "rna":
        bits = bits + 0x1000
    else:
        bits = bits + 0x0FFF + ((bits >> 13) & 1)
    return (bits & 0xFFFFE000).astype(np.uint32).view(np.float32)


def split(a: np.ndarray, rounding: str) -> tuple[np.ndarray, np.ndarray]:
    hi = tf32(a, rounding)
    return hi, tf32(a - hi, rounding)      # a - hi is exact in fp32


def mma_gemm(a: np.ndarray, b: np.ndarray, rounding: str,
             terms: str = "x3", step: int = 8) -> np.ndarray:
    """(..., R, K) x (..., K, N) as the kernels run it: k-steps of 8, each
    product of TF32 values exact in fp32, the sums in fp32; every `step`
    channels (a multiple of 8: the kernel's C or K step) sum into a zeroed
    part that is then added to the accumulator. `terms`: "x3" the split
    product, "x1" one-pass TF32 (hi * hi only)."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    (a_hi, a_lo), (b_hi, b_lo) = split(a, rounding), split(b, rounding)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], step):
        part = np.zeros_like(acc)
        for k in range(k0, min(k0 + step, a.shape[-1]), 8):
            ks = slice(k, k + 8)
            if terms == "x3":
                part += np.matmul(a_hi[..., ks], b_lo[..., ks, :])
                part += np.matmul(a_lo[..., ks], b_hi[..., ks, :])
            part += np.matmul(a_hi[..., ks], b_hi[..., ks, :])
        acc += part
    return acc


def _vgg16_layers() -> list[tuple[str, int, int]]:
    """(name, C, M) of VGG-16's 3x3 convs."""
    out, c = [], 3
    for spec in cnn.vgg16():
        if isinstance(spec, cnn.Conv):
            out.append((spec.name, c, spec.c_out))
            c = spec.c_out
    return out


def _point_gemm_operands(c: int, m: int, mt: int, seed: int):
    """V (P, R, C) from B^T d B of random NHWC tiles and U (P, C, M') from
    G w G^T of a random 3x3 filter at F(mt, 3): 32 tiles and 32 output
    channels of the layer, every Winograd point."""
    rng = np.random.default_rng(seed)
    ct = pt_tf.cook_toom(mt, 3)
    bt, g = ct.BT.astype(np.float64), ct.G.astype(np.float64)
    d = rng.standard_normal((32, ct.t, ct.t, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, min(m, 32)))
         / np.sqrt(9 * c)).astype(np.float32)
    v = np.einsum("it,rtuc,ju->ijrc", bt, d, bt).astype(np.float32)
    u = np.einsum("it,tucm,ju->ijcm", g, w, g).astype(np.float32)
    p = ct.t * ct.t
    return v.reshape(p, 32, c), u.reshape(p, c, -1)


def _sep14_operands(seed: int):
    """MobileNet-v1 sep14's pointwise GEMM: 49 pixels of ReLU'd depthwise
    output, K = 1024, against 64 columns of a 1024 x 1024 1x1 filter."""
    rng = np.random.default_rng(seed)
    z = np.maximum(rng.standard_normal((49, 1024)), 0).astype(np.float32)
    w = (rng.standard_normal((1024, 64)) / 32).astype(np.float32)
    return z, w


def _matmul_operands(dtype: str, seed: int):
    """The matmul kernel at K = 1024 (MobileNet-v1 sep14's pointwise conv
    at bf16 / int8, M = 196 at batch 4): ReLU'd activations against 64
    columns of B as the plan stores it, fp32, bf16 values or int8 codes
    (the int8 scale multiplies in the epilogue, after the sum)."""
    rng = np.random.default_rng(seed)
    a = np.maximum(rng.standard_normal((196, 1024)), 0).astype(np.float32)
    b = (rng.standard_normal((1024, 64)) / 32).astype(np.float32)
    if dtype == "bfloat16":
        b = (b.view(np.uint32) & 0xFFFF0000).view(np.float32)
    elif dtype == "int8":
        b = np.clip(np.round(b * 127 / np.abs(b).max()), -127, 127)
    return a, b.astype(np.float32)


def _stem_operands(seed: int):
    """The MobileNet stem's point-GEMMs (224 x 224 x 3 -> 32, stride 2,
    F(4, 2)): for each of the four input phases, V (P, R, 8) from B^T d B
    of 32 random phase tiles with C = 3 padded to the 8-channel step, U
    (P, 8, 32) from G w G^T of that phase's 2 x 2 sub-filter of a random
    3 x 3 filter zero-padded to 4 x 4; the phases side by side along K, one
    8-channel step each, as the kernel sums them."""
    rng = np.random.default_rng(seed)
    ct = pt_tf.cook_toom(4, 2)
    bt, g = ct.BT.astype(np.float64), ct.G.astype(np.float64)
    w = np.zeros((4, 4, 8, 32), np.float32)
    w[:3, :3, :3] = rng.standard_normal((3, 3, 3, 32)) / np.sqrt(27)
    d = np.zeros((4, 32, ct.t, ct.t, 8), np.float32)
    d[..., :3] = rng.standard_normal((4, 32, ct.t, ct.t, 3))
    vs, us = [], []
    for ph in range(4):
        wp = w[ph // 2::2, ph % 2::2]                     # (2, 2, 8, 32)
        v = np.einsum("it,rtuc,ju->ijrc", bt, d[ph], bt).astype(np.float32)
        u = np.einsum("it,tucm,ju->ijcm", g, wp, g).astype(np.float32)
        vs.append(v.reshape(ct.t * ct.t, 32, 8))
        us.append(u.reshape(ct.t * ct.t, 8, 32))
    return np.concatenate(vs, -1), np.concatenate(us, -2)


GEMMS = ([(f"vgg16.{name} F({mt},3)", c, m, mt)
          for name, c, m in _vgg16_layers() for mt in (4, 2)]
         + [("mobilenet_v1.sep14 pointwise", 1024, 1024, None)])
#: (label, operands, the kernel's step): the two kernels redesigned after
#: the GEMMS above.
KERNEL_GEMMS = ([(f"matmul K 1024 {dt}", dt, 32)
                 for dt in ("float32", "bfloat16", "int8")]
                + [("mobilenet stem 4 phases F(4,2)", "stem", 8)])


def _operands(label, c, m, mt):
    seed = sum(map(ord, label))
    if mt is None:
        return _sep14_operands(seed)
    return _point_gemm_operands(c, m, mt, seed)


def _kernel_operands(label, kind):
    seed = sum(map(ord, label))
    return _stem_operands(seed) if kind == "stem" else \
        _matmul_operands(kind, seed)


def _rel(got: np.ndarray, a: np.ndarray, b: np.ndarray) -> float:
    want = np.matmul(a.astype(np.float64), b.astype(np.float64))
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("label,c,m,mt", GEMMS, ids=[g[0] for g in GEMMS])
def test_split_product_keeps_fp32_accuracy(label, c, m, mt, rounding):
    """hi*lo + lo*hi + hi*hi within a tenth of TOL_KERNEL of float64."""
    a, b = _operands(label, c, m, mt)
    err = _rel(mma_gemm(a, b, rounding), a, b)
    assert err <= TOL_KERNEL / SPLIT_MARGIN, err


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("label,kind,step", KERNEL_GEMMS,
                         ids=[g[0] for g in KERNEL_GEMMS])
def test_split_product_keeps_fp32_accuracy_in_matmul_and_stem(
        label, kind, step, rounding):
    """The matmul kernel's K = 1024 GEMM (two products for a bf16 / int8 B:
    its lo half is 0) and the stem's 4-phase sum, each step summed into a
    zeroed part: within a tenth of TOL_KERNEL of float64."""
    a, b = _kernel_operands(label, kind)
    if kind in ("bfloat16", "int8"):
        assert not split(b, rounding)[1].any()
    err = _rel(mma_gemm(a, b, rounding, step=step), a, b)
    assert err <= TOL_KERNEL / SPLIT_MARGIN, err


@pytest.mark.parametrize("label,c,m,mt", GEMMS, ids=[g[0] for g in GEMMS])
def test_one_pass_tf32_breaks_the_limit(label, c, m, mt):
    """hi*hi alone exceeds TOL_KERNEL on the same data: a kernel that
    dropped the cross terms would fail its checks."""
    a, b = _operands(label, c, m, mt)
    assert _rel(mma_gemm(a, b, "rna", terms="x1"), a, b) > TOL_KERNEL


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_int8_codes_have_no_lo_half(rounding):
    """Every int8 code is exact in TF32: lo = 0, so a widened int8 filter
    needs two products, not three."""
    codes = np.arange(-128, 128, dtype=np.float32)
    hi, lo = split(codes, rounding)
    np.testing.assert_array_equal(hi, codes)
    assert not lo.any()


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_bf16_values_have_no_lo_half(rounding):
    """bf16 values (8 significant bits) widened to fp32 are exact in TF32:
    lo = 0, across the exponent range the transformed filters span."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-30, 30, 4096))
         ).astype(np.float32)
    bf16 = (x.view(np.uint32) & 0xFFFF0000).view(np.float32)
    hi, lo = split(bf16, rounding)
    np.testing.assert_array_equal(hi, bf16)
    assert not lo.any()


def test_fp32_values_need_the_lo_half():
    """A generic fp32 value is not TF32: lo carries its low 13 bits, and
    hi + lo restores it to within 2^-22 relative."""
    x = np.random.default_rng(4).standard_normal(4096).astype(np.float32)
    hi, lo = split(x, "rna")
    assert lo.any()
    np.testing.assert_allclose(hi.astype(np.float64) + lo, x, rtol=2.0 ** -21,
                               atol=0)


@pytest.mark.parametrize("label,kind,step", KERNEL_GEMMS,
                         ids=[g[0] for g in KERNEL_GEMMS])
def test_one_pass_tf32_breaks_the_limit_in_matmul_and_stem(label, kind,
                                                           step):
    """hi*hi alone exceeds TOL_KERNEL on the matmul and stem data too: A
    (the activations, the transformed input) is fp32 whatever B's dtype."""
    a, b = _kernel_operands(label, kind)
    assert _rel(mma_gemm(a, b, "rna", terms="x1", step=step), a, b) > \
        TOL_KERNEL
