#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
`ok` line:

  1. build   -- compile every CUDA kernel from the sources in this checkout;
  2. kernels -- hold each kernel against its plain PyTorch version on the
                card: VGG-16's 13 conv shapes at 224 (batch 2, bias + relu,
                fp32 filter), one odd shape per filter size k in
                {2, 3, 4, 5, 7}, and bf16 / int8 filters on one layer;
  3. slice   -- the port's main path as a user calls it: init_cnn (seeded
                torch.Generator) -> compile(vgg16(), res=224,
                algorithm="pallas_winograd") -> NetworkPlan.apply on 4
                images, twice, with the kernel's launch counter read around
                it; the logits are checked against the same network on the
                plain Winograd executor and against a direct F.conv2d
                network, on the card with TF32 off;
  4. timing  -- per layer on the main path's own plans at batch 4, the
                kernel held once more against its plain version, then
                CUDA-event medians (the kernel, its plain version, cuDNN's
                F.conv2d + bias + relu as a yardstick the port never calls);
                and of the whole forward at batch 1 and 4.

It prints the card's name and power limit, one `{"kernels": [...]}` line,
and as its last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Kernel vs plain version, relative max-abs error (of max |plain|): both
#: run the same fp32 transforms and fp32 FMAs but sum C in another order.
TOL_KERNEL = 2e-5
#: Logits of the slice, relative max-abs error, vs the same network on the
#: plain Winograd executor (same transforms, other summation order) and vs
#: a direct F.conv2d network, both fp32 with TF32 off. On an H100 both
#: read about 3.9e-6 (PERF.md); the limit is about 13 times that, well
#: below what TF32 or bf16 sums in the kernel would give (1e-4 and more).
TOL_NET_PLAIN = 5e-5
TOL_NET_DIRECT = 5e-5
#: H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 on the CUDA cores and
#: HBM3 bandwidth. Bounds below are computed from these.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

MAIN_BATCH = 4
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/winograd_streamed.cu"
REPLACES = "src/repro/kernels/winograd.py:152"


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of one fn() call, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def layer_bound(n, h, w, c, m, ct, geom, u_bytes):
    """(bound_ms, bound_by, flops, bytes) of one streamed conv: the
    point-GEMM FLOPs of F(m, r) over the layer's tiles at the fp32 peak, or
    its input + filter + bias + output bytes at the memory rate."""
    flops = 2 * ct.t * ct.t * n * geom.n_h * geom.n_w * c * m
    nbytes = 4 * (n * h * w * c + n * geom.out_h * geom.out_w * m + m) \
        + u_bytes
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def streamed_operands(plan, x):
    """The padded input ops.winograd_conv2d_planned hands the kernel."""
    from repro_torch.kernels import ops
    return ops.pad_streamed_input(x, plan.spec.geometry, plan.spec.stream)


def kernel_call(plan, xp, bias, *, plain: bool):
    from repro_torch.kernels import winograd as kw
    s = plan.spec
    fn = kw.winograd_streamed_plain if plain else kw.winograd_streamed
    kwargs = dict(ct_h=s.ct_h, ct_w=s.ct_w, bh=s.stream.bh, bw=s.stream.bw,
                  activation="relu")
    if not plain:
        kwargs["block_m"] = s.stream.block_m
    return fn(xp, plan.u, bias, plan.scale, **kwargs)


def compare(label, plan, xp, bias) -> tuple[float, float]:
    """The kernel against its plain version on the same operands, each
    followed by a synchronize; raises past TOL_KERNEL. Returns the relative
    and absolute max-abs errors."""
    import torch
    got = kernel_call(plan, xp, bias, plain=False)
    torch.cuda.synchronize()
    want = kernel_call(plan, xp, bias, plain=True)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    if not torch.isfinite(got).all() or err > TOL_KERNEL:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version ({err:.3e} > {TOL_KERNEL})")
    return err, float((got - want).abs().max())


def profile_forward(net, x, runs: int = 3) -> dict:
    """Device time by kernel name over `runs` warm forwards, from a
    torch.profiler trace, and the device's busy share of the host wall
    time. Empty when the trace holds no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    net.apply(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            net.apply(x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            by_name[name] = by_name.get(name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    if not by_name:
        log("[profile] the trace holds no device events: device time not "
            "measured")
        return {}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"profile_wall_ms_per_forward": wall_ms / runs,
           "profile_device_ms_per_forward": busy / runs,
           "profile_busy_share": busy / wall_ms,
           "profile_top_kernels_ms_per_forward":
               {k: v / runs for k, v in top}}
    log(f"[profile] {json.dumps(out)}")
    return out


def direct_forward(params, specs, x):
    """VGG-16 with cuDNN convolutions (the yardstick): NHWC in and out."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import cnn
    y = x.permute(0, 3, 1, 2)
    for spec in specs:
        if isinstance(spec, cnn.Conv):
            p = params[spec.name]
            y = F.relu(F.conv2d(y, p["w"].permute(3, 2, 0, 1), p["b"],
                                padding=spec.kh // 2))
        elif isinstance(spec, cnn.Pool):
            y = F.max_pool2d(y, spec.k, spec.stride)
        elif isinstance(spec, cnn.Dense):
            if y.dim() == 4:
                y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
            y = torch.matmul(y, params[spec.name]["w"])
            y = F.relu(y) if spec.relu else y
    return y


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only "
              "on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.nn.functional as F

    from repro_torch.core import compile as pt_compile
    from repro_torch.core import plan as pt_plan
    from repro_torch.core.transforms import DEFAULT_OUTPUT_TILE
    from repro_torch.kernels import build
    from repro_torch.kernels import winograd as kw
    from repro_torch.models import cnn

    dev = torch.device("cuda")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {len(built)} kernel librar{'y' if len(built) == 1 else 'ies'}"
        f" in {time.perf_counter() - t0:.2f} s")
    for source, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {source}: {line.strip()}")

    # ---- 2. kernel vs plain version ------------------------------------------
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    specs = cnn.vgg16()
    vgg_layers = []           # (name, h, c, m) at res 224
    h, c = 224, 3
    for spec in specs:
        if isinstance(spec, cnn.Conv):
            vgg_layers.append((spec.name, h, c, spec.c_out))
            c = spec.c_out
        elif isinstance(spec, cnn.Pool):
            h //= spec.stride
    cases = [(f"vgg16.{name} {h}x{h}x{c}->{m}", 2, h, h, c, m, 3, None,
              "float32") for name, h, c, m in vgg_layers]
    cases += [(f"k{k} 37x29x19->40", 2, 37, 29, 19, 40, k, None, "float32")
              for k in sorted(DEFAULT_OUTPUT_TILE)]
    cases += [(f"vgg16.conv3_1 56x56x256->256 {cd}", 2, 56, 56, 256, 256, 3,
               None, cd) for cd in ("bfloat16", "int8")]
    max_abs = max_rel = 0.0
    for label, n, h, w, c, m, k, tile, cd in cases:
        x = randn(n, h, w, c)
        wt = randn(k, k, c, m, scale=(k * k * c) ** -0.5)
        bias = randn(m, scale=0.1)
        plan = pt_plan.plan_conv2d((n, h, w, c), wt,
                                   algorithm="pallas_winograd",
                                   output_tile=tile, compute_dtype=cd,
                                   device=dev)
        err, abs_err = compare(label, plan, streamed_operands(plan, x), bias)
        max_rel, max_abs = max(max_rel, err), max(max_abs, abs_err)
        s = plan.spec.stream
        log(f"[kernels] {label}: F({plan.spec.output_tile[0]},{k}) blocks "
            f"{s.bh}x{s.bw}x{s.block_m} max_rel_err {err:.3e}")

    # ---- 3. the slice: VGG-16 at 224 through compile() -> apply ------------
    params = cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                          res=224, device=dev)
    t0 = time.perf_counter()
    net = pt_compile.compile(params, specs, res=224, batch=MAIN_BATCH,
                             algorithm="pallas_winograd", device=dev)
    torch.cuda.synchronize()
    log(f"[slice] compiled VGG-16 at 224 in {time.perf_counter() - t0:.2f} s")
    log(net.describe())
    n_convs = sum(p.spec.algorithm == "pallas_winograd"
                  for p in net.plans.values())
    x = randn(MAIN_BATCH, 224, 224, 3)

    # each conv plan's apply is wrapped to read the launch counter around
    # it, so every layer's launches are counted, not inferred from the sum
    layer_launches = {name: 0 for name, *_ in vgg_layers}

    def counted(name, apply):
        def run(*args, **kwargs):
            before = kw.winograd_streamed.LAUNCHES
            y = apply(*args, **kwargs)
            layer_launches[name] += kw.winograd_streamed.LAUNCHES - before
            return y
        return run

    for name in layer_launches:
        net.plans[name].apply = counted(name, net.plans[name].apply)
    kw.winograd_streamed.LAUNCHES = 0
    y1 = net.apply(x)
    y2 = net.apply(x)
    torch.cuda.synchronize()
    launches = kw.winograd_streamed.LAUNCHES
    for name in layer_launches:
        del net.plans[name].apply
    log(f"[slice] 2 forwards, {launches} winograd_streamed launches "
        f"({n_convs} streamed convs), by layer {json.dumps(layer_launches)}")
    if (n_convs != 13 or launches != 2 * 13
            or sum(layer_launches.values()) != launches
            or set(layer_launches.values()) != {2}):
        raise AssertionError(f"expected 1 launch per conv per forward, got "
                             f"{layer_launches} ({launches} in all) over 2 "
                             f"forwards")
    if y1.shape != (MAIN_BATCH, 1000) or not torch.isfinite(y1).all():
        raise AssertionError(f"bad logits: shape {tuple(y1.shape)}")
    if not torch.equal(y1, y2):
        raise AssertionError("two forwards of the same input differ")
    plain_net = pt_compile.compile(params, specs, res=224, batch=MAIN_BATCH,
                                   algorithm="winograd", device=dev)
    y_plain = plain_net.apply(x)
    y_direct = direct_forward(params, specs, x)
    torch.cuda.synchronize()
    e_plain, e_direct = rel_err(y1, y_plain), rel_err(y1, y_direct)
    log(f"[slice] logits rel err vs plain-executor network {e_plain:.3e} "
        f"(tol {TOL_NET_PLAIN}), vs direct F.conv2d network {e_direct:.3e} "
        f"(tol {TOL_NET_DIRECT}); top-1 agreement "
        f"{int((y1.argmax(1) == y_direct.argmax(1)).sum())}/{MAIN_BATCH}")
    if e_plain > TOL_NET_PLAIN or e_direct > TOL_NET_DIRECT:
        raise AssertionError("slice logits disagree with the oracles")
    del plain_net, y_plain

    # ---- 4. timings ---------------------------------------------------------
    layers = []
    for name, h, c, m in vgg_layers:
        plan = net.plans[name]
        s, g = plan.spec, plan.spec.geometry
        xl = randn(MAIN_BATCH, h, h, c)
        xp = streamed_operands(plan, xl)
        bias = params[name]["b"]
        # the main path's own plan and shapes, against the plain version
        err, abs_err = compare(f"{name} batch {MAIN_BATCH}", plan, xp, bias)
        max_rel, max_abs = max(max_rel, err), max(max_abs, abs_err)
        ms = cuda_ms(lambda: kernel_call(plan, xp, bias, plain=False), 20)
        plain_ms = cuda_ms(lambda: kernel_call(plan, xp, bias, plain=True), 3,
                           warmup=1)
        xc = xl.permute(0, 3, 1, 2)                        # channels_last view
        wc = params[name]["w"].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib_ms = cuda_ms(lambda: F.relu(F.conv2d(xc, wc, bias, padding=1)),
                         20)
        bound, by, flops, nbytes = layer_bound(
            MAIN_BATCH, h, h, c, m, s.ct_h, g,
            plan.u.numel() * plan.u.element_size())
        layers.append(dict(layer=name, shape=[MAIN_BATCH, h, h, c, m],
                           blocks=[s.stream.bh, s.stream.bw,
                                   s.stream.block_m],
                           launches=layer_launches[name], max_rel_err=err,
                           max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bound, bound_by=by,
                           gflop=flops / 1e9, mbytes=nbytes / 1e6))
        log(f"[timing] {name} {h}x{h}x{c}->{m}: max_rel_err {err:.3e}, "
            f"kernel {ms:.3f} ms "
            f"({flops / (ms * 1e9):.2f} TFLOP/s), plain {plain_ms:.3f} ms, "
            f"cuDNN {lib_ms:.3f} ms, bound {bound:.3f} ms ({by})")

    forward = {}
    for batch in (1, MAIN_BATCH):
        nb = net if batch == MAIN_BATCH else pt_compile.compile(
            params, specs, res=224, batch=batch,
            algorithm="pallas_winograd", device=dev)
        xb = randn(batch, 224, 224, 3)
        forward[f"batch{batch}_ms"] = cuda_ms(lambda: nb.apply(xb), 10)
        forward[f"batch{batch}_cudnn_ms"] = cuda_ms(
            lambda: direct_forward(params, specs, xb), 10)
    log(f"[timing] whole forward: {json.dumps(forward)}")
    forward.update(profile_forward(net, randn(MAIN_BATCH, 224, 224, 3)))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])

    total = lambda key: sum(layer[key] for layer in layers)  # noqa: E731
    bound_ops = sum(layer["bound_ms"] for layer in layers
                    if layer["bound_by"] == "operations")
    print(json.dumps({"kernels": [{
        "name": "winograd_streamed", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if bound_ops >= total("bound_ms") / 2
                     else "bytes"),
        "library_ms": total("library_ms"),
        "shapes": "VGG-16's 13 convs at 224, batch 4; times summed",
        "layers": layers, "forward": forward}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
