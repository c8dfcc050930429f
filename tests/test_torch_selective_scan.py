"""Parity of the port's selective scan with the JAX package: the plain
version of the `selective_scan` kernel (which the wrapper runs on the CPU)
against the reference's Pallas kernel in interpret mode, its sequential
oracle (kernels/ref.py) and its chunked pure-JAX scan (models/mamba.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref
from repro.kernels import selective_scan as ref_k
from repro.models.mamba import _chunked_selective_scan
from repro_torch.kernels import selective_scan as pt_k

#: fp32: the reference's own limit for its kernel against the sequential
#: oracle (tests/test_selective_scan.py): the chunked doubling scan
#: multiplies the decays in another order.
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _inputs(seed, b, length, d, n):
    rng = np.random.default_rng(seed)
    dt = (0.001 + 0.1 * rng.random((b, length, d))).astype(np.float32)
    xs = rng.standard_normal((b, length, d)).astype(np.float32)
    bmat = rng.standard_normal((b, length, n)).astype(np.float32)
    cmat = rng.standard_normal((b, length, n)).astype(np.float32)
    a_mat = -np.exp(rng.standard_normal((d, n))).astype(np.float32)
    return dt, xs, bmat, cmat, a_mat


def _port(args, dtype=torch.float32, chunk=256):
    dt, xs, bmat, cmat, a_mat = (torch.tensor(a) for a in args)
    y, h = pt_k.selective_scan(dt.to(dtype), xs.to(dtype), bmat.to(dtype),
                               cmat.to(dtype), a_mat, chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("b,length,d,n,chunk,bd", [
    (1, 64, 128, 16, 16, 128),
    (2, 128, 256, 16, 32, 128),
    (2, 64, 128, 8, 64, 64),
    (1, 96, 128, 4, 32, 128),
])
def test_plain_matches_reference_kernel(b, length, d, n, chunk, bd):
    args = _inputs(b * length + n, b, length, d, n)
    y_k, h_k = ref_k.selective_scan(*map(jnp.asarray, args), chunk=chunk,
                                    block_d=bd, interpret=True)
    y_o, h_o = ref_ref.selective_scan(*map(jnp.asarray, args))
    y, h = _port(args, chunk=chunk)
    assert y.shape == (b, length, d) and h.shape == (b, d, n)
    for want_y, want_h in ((y_k, h_k), (y_o, h_o)):
        assert _rel(y, want_y) <= TOL
        assert _rel(h, want_h) <= TOL


@pytest.mark.parametrize("length,chunk", [(37, 16), (100, 32), (2, 256),
                                          (1, 1)])
def test_plain_any_length(length, chunk):
    """L not a multiple of the chunk: the last chunk is shorter, and the
    result is the sequential oracle's."""
    args = _inputs(length, 2, length, 48, 16)
    y_o, h_o = ref_ref.selective_scan(*map(jnp.asarray, args))
    y, h = _port(args, chunk=chunk)
    assert _rel(y, y_o) <= TOL
    assert _rel(h, h_o) <= TOL


def test_plain_chunk_invariance():
    """The chunk is an implementation detail: every chunk length gives the
    result of the reference's chunked scan."""
    args = _inputs(5, 1, 128, 64, 8)
    y_c, h_c = _chunked_selective_scan(*map(jnp.asarray, args), chunk=32)
    for chunk in (1, 7, 16, 64, 128, 1000):
        y, h = _port(args, chunk=chunk)
        assert _rel(y, y_c) <= TOL
        assert _rel(h, h_c) <= TOL


def test_plain_bf16_inputs():
    args = _inputs(9, 2, 64, 128, 16)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in args[:4]]
    y_k, h_k = ref_k.selective_scan(*bf, jnp.asarray(args[4]), chunk=32,
                                    block_d=128, interpret=True)
    y_o, h_o = ref_ref.selective_scan(*bf, jnp.asarray(args[4]))
    y, h = _port(args, dtype=torch.bfloat16, chunk=32)
    # bf16 dt / xs / B / C: both sides widen the same bf16 values and scan
    # in fp32, so only the order differs and the fp32 limit holds (reads
    # ~2e-7); a plain version that rounded dt*x, the decays or h to bf16
    # would miss it.
    for want_y, want_h in ((y_k, h_k), (y_o, h_o)):
        assert _rel(y, want_y) <= TOL
        assert _rel(h, want_h) <= TOL


def test_state_carries_across_calls():
    """Two half-sequences, the second seeded with the first's state through
    the recurrence, give the whole sequence's state: h_last is the decode
    handoff."""
    dt, xs, bmat, cmat, a_mat = (torch.tensor(a)
                                 for a in _inputs(11, 1, 64, 32, 8))
    y, h = pt_k.selective_scan(dt, xs, bmat, cmat, a_mat, chunk=16)
    _, h1 = pt_k.selective_scan(dt[:, :40], xs[:, :40], bmat[:, :40],
                                cmat[:, :40], a_mat, chunk=16)
    for t in range(40, 64):
        h1 = torch.exp(dt[:, t, :, None] * a_mat) * h1 + \
            (dt[:, t] * xs[:, t])[..., None] * bmat[:, t, None, :]
        yt = torch.einsum("bds,bs->bd", h1, cmat[:, t])
        assert _rel(yt.numpy(), y[:, t].numpy()) <= TOL
    assert _rel(h1.numpy(), h.numpy()) <= TOL


def test_kernel_wrapper_counts_no_launch_on_cpu():
    args = [torch.tensor(a) for a in _inputs(1, 1, 4, 8, 4)]
    before = pt_k.selective_scan.LAUNCHES
    y, h = pt_k.selective_scan(*args)
    assert y.shape == (1, 4, 8) and h.shape == (1, 8, 4)
    assert pt_k.selective_scan.LAUNCHES == before


#: (B, D, N) of every selective_scan shape chip_smoke.py checks on the card
#: (L does not enter the blocking): the falcon-mamba-7b layer at fp32 and
#: bf16 dt / xs, and the odd D, N and bf16 shapes.
SMOKE_SHAPES = [(4, 8192, 16), (2, 8200, 16), (2, 1000, 4), (2, 1000, 8),
                (1, 200, 12), (2, 1000, 16)]
#: scan_blocking's (lanes, channels, chunk) at each.
SMOKE_PICKS = {(4, 8192, 16): (2, 64, 32), (2, 8200, 16): (2, 32, 32),
               (2, 1000, 4): (1, 32, 32), (2, 1000, 8): (1, 32, 32),
               (1, 200, 12): (2, 32, 32), (2, 1000, 16): (2, 32, 32)}


@pytest.mark.parametrize("b,d,n", SMOKE_SHAPES)
def test_scan_blocking_picks(b, d, n):
    """The kernel's blocking at the layer shape and the odd ones: a
    blocking the launcher takes at fp32 and at bf16, and the listed pick."""
    pick = pt_k.scan_blocking(b, d, n)
    assert pick == SMOKE_PICKS[(b, d, n)]
    for x_size, bc_size in ((4, 4), (2, 4), (2, 2)):
        assert pt_k.scan_blocking_fits(*pick, n, x_size, bc_size)


@pytest.mark.parametrize("lanes,channels,chunk,n,fits", [
    (4, 64, 32, 16, True),
    (1, 256, 16, 16, True),
    (3, 64, 32, 16, False),            # lanes not 1, 2 or 4
    (4, 64, 32, 3, True),              # 1 state a lane (N 3 padded to 4)
    (2, 48, 32, 16, False),            # channels not a power of two
    (2, 16, 32, 16, False),            # channels below a warp
    (4, 256, 16, 16, False),           # 1024 threads
    (4, 64, 24, 16, False),            # chunk not a power of two
    (4, 64, 256, 16, False),           # chunk past 128
    (2, 256, 128, 16, False),          # 557 KB of shared memory
])
def test_scan_blocking_fits_is_the_kernels_rule(lanes, channels, chunk, n,
                                                fits):
    """scan_blocking_fits mirrors selective_scan_launch's checks; each
    rejected case fails one rule."""
    assert pt_k.scan_blocking_fits(lanes, channels, chunk, n) is fits


def test_scan_smem_is_the_kernels_formula():
    """Two stages of 32 steps of dt and xs (64 channels) and of B and C
    (N 12 padded to 16), fp32; bf16 dt / xs halve their part."""
    assert pt_k.scan_smem_bytes(64, 32, 12) == \
        2 * 32 * (2 * 64 * 4 + 2 * 16 * 4)
    assert pt_k.scan_smem_bytes(64, 32, 12, x_size=2) == \
        2 * 32 * (2 * 64 * 2 + 2 * 16 * 4)
    assert [pt_k.padded_states(n) for n in (1, 4, 5, 8, 9, 16)] == \
        [4, 4, 8, 8, 16, 16]


@pytest.mark.parametrize("dt_hi", [0.101, 10.0])
def test_exp2_decay_matches_float64(dt_hi):
    """The kernel's decay, exp2(dt * (A * log2 e)) with A scaled once, in
    fp32, against float64 exp(dt * A): within 1e-6 relative (of the
    largest decay, as TOL is read) over the reference tests' ranges (dt in
    [0.001, 0.101), A = -exp(normal)) and over dt up to 10. Element by
    element it is no further from float64 than fp32 exp(dt * A) is, but
    for a rounding of the scaled exponent (|x| 2^-23 relative)."""
    rng = np.random.default_rng(7)
    dt = (0.001 + (dt_hi - 0.001) * rng.random((256, 1))).astype(np.float32)
    a = (-np.exp(rng.standard_normal((1, 64)))).astype(np.float32)
    dt_t, a_t = torch.tensor(dt), torch.tensor(a)
    got = torch.exp2(dt_t * (a_t * 1.4426950408889634)).double().numpy()
    want = np.exp(dt.astype(np.float64) * a.astype(np.float64))
    assert _rel(got, want) <= 1e-6
    x = np.abs(dt.astype(np.float64) * a * 1.4426950408889634)
    ref32 = torch.exp(dt_t * a_t).double().numpy()
    slack = (x + 2) * 2.0 ** -23 * want
    assert np.all(np.abs(got - want) <= np.abs(ref32 - want) + slack)
