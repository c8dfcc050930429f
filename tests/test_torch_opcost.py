"""The port's op-cost walker (repro_torch/launch/opcost.py), the counterpart
of the JAX package's launch/hlo.py: trip counts, byte widths, views, a
kernel's row, live bytes, owners, the H100 roofline, a real step on "meta"
against the same step on CPU tensors, and the reference cycle the
unsharded loss and gradients used to leave (mirrors tests/test_hlo.py)."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import configs as pt_cfgs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import selective_scan as ks
from repro_torch.launch import opcost
from repro_torch.launch import steps as pt_steps
from repro_torch.models import transformer as pt_tf
from repro_torch.optim import adamw

from test_torch_train import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_loop_of_matmuls_counts_every_trip():
    """12 matmuls in a Python loop count 12 times (hlo.py multiplies a
    while body by its trip count; eager runs every trip)."""
    a, b = meta(64, 32), meta(32, 16)
    with opcost.CostMode() as mode:
        for _ in range(12):
            a @ b
    mm = [r for r in mode.rows if r.op == "aten.mm"]
    assert len(mm) == 12
    assert mode.totals().flops == 12 * 2 * 64 * 32 * 16
    assert all(r.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16) for r in mm)


@pytest.mark.parametrize("dtype,width", [(torch.float32, 4),
                                         (torch.bfloat16, 2),
                                         (torch.int8, 1),
                                         (torch.float64, 8)])
def test_byte_widths(dtype, width):
    a = meta(8, 16, dtype=dtype)
    with opcost.CostMode() as mode:
        a + a
    (row,) = [r for r in mode.rows if r.op == "aten.add"]
    assert row.bytes_read == width * 128            # one operand, once
    assert row.bytes_written == width * 128
    assert row.dtype == str(dtype).removeprefix("torch.")


def test_views_count_no_bytes():
    a = meta(4, 8, 16)
    with opcost.CostMode() as mode:
        a.view(32, 16)
        a.transpose(0, 1)
        a.permute(2, 0, 1)
        a[:, None].expand(4, 3, 8, 16)
        a[1:3]
        a[0]
        a.unsqueeze(0).squeeze(0)
        a.detach()
        a.t() if a.dim() == 2 else a.reshape(4, 128)
    assert mode.rows and all(r.bytes == 0 for r in mode.rows)
    assert {r.op for r in mode.rows} >= {"aten.view", "aten.transpose",
                                         "aten.permute", "aten.expand",
                                         "aten.slice", "aten.select",
                                         "aten.unsqueeze", "aten.squeeze",
                                         "aten.detach"}
    assert mode.temp_peak == 0


def test_kernel_row_on_meta(monkeypatch):
    """The scan's wrapper on "meta" tensors: one kernel row (its operands
    read once, its results written once, B*L*D*N exponentials on the
    special-function unit), results of the kernel's shapes, no launch
    counted and the plain version never run."""
    monkeypatch.setattr(ks, "selective_scan_plain", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("the plain version ran")))
    b, length, d, n = 2, 64, 32, 16
    args = (meta(b, length, d), meta(b, length, d), meta(b, length, n),
            meta(b, length, n), meta(d, n))
    before = ks.selective_scan.LAUNCHES
    with opcost.CostMode() as mode:
        y, h = ks.selective_scan(*args)
    assert ks.selective_scan.LAUNCHES == before
    assert (y.shape, h.shape) == ((b, length, d), (b, d, n))
    assert y.device.type == h.device.type == "meta"
    (row,) = [r for r in mode.rows if r.op.startswith("kernel:")]
    assert row.op == "kernel:selective_scan" and row.unit == "sfu"
    assert row.flops == b * length * d * n
    assert row.bytes_read == 4 * (2 * b * length * d + 2 * b * length * n
                                  + d * n)
    assert row.bytes_written == 4 * (b * length * d + b * d * n)
    assert mode.kernel_launches == {"selective_scan": 1}
    # without a CostMode the wrapper still runs nothing and counts nothing
    y, _ = ks.selective_scan(*args)
    assert y.device.type == "meta" and ks.selective_scan.LAUNCHES == before


def test_live_bytes_peak_of_a_hand_program():
    """Arguments are not counted; a storage is released when its last
    view dies; a storage autograd saves stays live until the graph goes."""
    mb = 2 ** 20
    x = meta(mb // 4)                        # 1 MiB, the argument
    w = torch.empty(mb // 4, device="meta", requires_grad=True)
    with opcost.CostMode() as mode:
        mode.hold((x, w))
        a = x * 2                            # 1 MiB live
        b = a + 1                            # 2 MiB
        v = b[:10]                           # a view keeps b
        del b
        c = a * 3                            # 3 MiB: the peak
        del a, c, v                          # 0
        s = (x * w).sin()                    # x*w saved for sin's backward
        del s                                # the graph goes with s
        d = x + 1                            # 1 MiB
        del d
    assert mode.temp_peak == 3 * mb
    assert mode.peak_at.op == "aten.mul"


def test_owners_and_gathers():
    """An op reading a storage held away reads it over the interconnect
    (all-gather bytes, not HBM); ops on away storages alone are another
    position's and add no row; a tensor moved here is a storage of its
    own."""
    here, away = meta(256), meta(256)
    with opcost.CostMode() as mode:
        mode.hold(here)
        mode.hold(away, here=False)
        (away * 2).sqrt()                    # away's work: no rows
        g = torch.cat([here, away])          # a gather
        own = mode.moved(g[:256])            # no row, 1 KiB here
        del g
        own + 1
    cat = [r for r in mode.rows if r.op == "aten.cat"]
    assert len(cat) == 1 and cat[0].bytes_read == 1024
    assert cat[0].coll_bytes == 1024 and cat[0].coll_kind == "all-gather"
    tot = mode.totals()
    assert tot.coll_by_kind["all-gather"] == tot.coll_bytes == 1024
    assert {r.op for r in mode.rows} == {"aten.cat", "aten.slice",
                                         "aten.add"}
    assert mode.temp_peak == 2048 + 1024     # the gather and the copy


def test_repeat_replays_the_first_trace():
    """A keyed repeat adds its first call's rows and peak again: the same
    totals as tracing every call."""
    def work(t):
        return ((t * 2).exp() + 1,)

    def run(memo):
        x = meta(1024)
        with opcost.CostMode() as mode:
            mode.hold(x)
            outs = []
            for _ in range(5):
                outs.append(mode.repeat("k", lambda: work(x), (x,))
                            if memo else work(x))
        return mode

    a, b = run(True), run(False)
    assert a.totals().bytes == b.totals().bytes
    assert a.temp_peak == b.temp_peak == 5 * 4096 + 4096
    assert sum(r.count for r in a.rows) == len(b.rows)


def test_roofline_bottleneck_on_the_h100():
    assert opcost.PEAK_FLOPS["bf16"] == 989.4e12
    assert opcost.PEAK_FLOPS["tf32"] == 494.7e12
    assert opcost.PEAK_FLOPS["fp32"] == 66.9e12
    assert opcost.HBM_BW == 3.35e12 and opcost.LINK_BW == 450e9
    rf = opcost.Roofline(989.4e12, 1e12, 1e9, 1, {"bf16": 989.4e12})
    assert rf.t_compute == pytest.approx(1.0) and rf.bottleneck == "compute"
    rf = opcost.Roofline(66.9e12, 6.7e12, 0.0, 1, {"fp32": 66.9e12})
    assert rf.t_memory == pytest.approx(2.0) and rf.bottleneck == "memory"
    rf = opcost.Roofline(0.0, 0.0, 900e9, 256)
    assert rf.bottleneck == "collective"
    assert rf.as_dict()["t_collective_s"] == pytest.approx(2.0)
    # the compute term sums each unit's FLOPs over its own peak
    rf = opcost.Roofline(2e12, 0, 0, 1, {"bf16": 989.4e12, "fp32": 66.9e12,
                                         "sfu": 16 * 132 * 1.98e9})
    assert rf.t_compute == pytest.approx(3.0)


def test_profile_bytes_sums_like_ops():
    a, b = meta(64, 32), meta(32, 16)
    with opcost.CostMode() as mode:
        for _ in range(3):
            a @ b
        a + a
    top = opcost.profile_bytes(mode.rows, 2)
    assert top[0][1] == "aten.mm" and top[0][0] == 3 * 4 * (2048 + 512
                                                           + 1024)
    assert top[0][2].endswith("x3")


def test_dense_step_counts_the_same_on_meta_and_on_cpu(one_thread):
    """A dense smoke train step (qwen2.5-3b) counts the same FLOPs and
    HBM bytes on "meta" tensors as on CPU tensors."""
    cfg = pt_cfgs.get_smoke_config("qwen2_5_3b")
    opt_cfg = adamw.AdamWConfig()
    batch = SyntheticLM(cfg, 2, 16).batch_at(0)
    step = pt_steps.make_train_step(cfg, opt_cfg)
    totals = {}
    for device in ("cpu", "meta"):
        params = pt_tf.init_params(torch.Generator().manual_seed(0), cfg,
                                   torch.float32, device=device)
        state = adamw.init_state(params, opt_cfg)
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        with opcost.CostMode() as mode:
            mode.hold((params, state, b))
            step(params, state, b)
        totals[device] = (mode.totals(), mode.temp_peak)
    (cpu, cpu_peak), (met, met_peak) = totals["cpu"], totals["meta"]
    assert met.flops == cpu.flops > 0
    assert met.bytes == cpu.bytes > 0
    assert met_peak == cpu_peak


def test_unsharded_loss_and_grads_leave_no_cycle():
    """A fresh process, the collector off: a weakref to a returned
    gradient leaf dies as soon as the caller drops the tree (the first
    call, whose lazy imports under torch.utils.checkpoint once kept the
    call's frame, and its gradient tree, in a reference cycle)."""
    prog = textwrap.dedent("""
        import gc, weakref
        import torch
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.data.pipeline import SyntheticLM
        from repro_torch.launch import steps
        from repro_torch.models import transformer as tf
        from repro_torch.tree import tree_leaves
        gc.disable()
        cfg = configs.get_smoke_config("qwen2_5_3b")
        params = tf.init_params(torch.Generator().manual_seed(0), cfg,
                                torch.float32, device="cpu")
        batch = SyntheticLM(cfg, 2, 16).batch_at(0)
        loss, grads = steps.make_loss_and_grads(cfg)(params, batch)
        leaf = weakref.ref(tree_leaves(grads)[0])
        assert leaf() is not None
        del loss, grads
        print("alive" if leaf() is not None else "freed")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "freed"
