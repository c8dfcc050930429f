#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # the phases below
    python3 chip_smoke.py --sweep [kernel ...]
                                     # the blocked kernels under every
                                     # blocking, all eight or the ones
                                     # named (see sweep)
    python3 chip_smoke.py --lm-decode [SRC]
                                     # path C's prefill and decode timed
                                     # alone, repro_torch from SRC (see
                                     # lm_decode)
    python3 chip_smoke.py --training # phase 10 alone (training_only)
    python3 chip_smoke.py --mesh     # phase 11 alone (mesh_only)
    python3 chip_smoke.py --dryrun   # phase 12 alone (dryrun_only)
    python3 chip_smoke.py --examples # phase 13 alone (examples_only)

Phases, in order; any failure ends the run with a non-zero exit and no
`ok` line:

  1. build   -- compile every CUDA kernel from the sources in this checkout
                (one nvcc each, all at once) and print nvcc's register and
                spill report (per instantiation for selective_scan.cu,
                depthwise_strided_streamed.cu and separable_streamed.cu);
  2. kernels -- hold each kernel against its plain PyTorch version on the
                card (the five TF32x3 kernels against it run in float64,
                see compare), with a synchronize after each launch: every layer
                that reaches a kernel in the eight networks of
                models/cnn.py:NETWORKS at their own resolution (224;
                Inception-v3 299), batch 2, under
                algorithm="pallas_winograd" at fp32, bf16 and int8 and under
                "pallas_winograd_materialized" (VGG-16, Inception-v3); odd
                shapes for every filter size, stride-2 tile, depthwise tile
                and channel multiplier, VALID padding at stride 1 and 2, a
                7x7 stride-2 stem at full width; bf16 and int8 (+ scale)
                filters; selective_scan at the falcon-mamba-7b layer shape
                (4, 2048, 8192, 16), launched twice (bitwise equal), and
                odd L, D, N and bf16 operands, against its plain version
                run in float64 (see TOL_SCAN);
                conv1d_ct_fused at its short-conv tile shape and odd r,
                F(m, r), C, L and bf16 tiles;
  3. slices  -- the port's main paths as a user calls them: init_cnn
                (seeded torch.Generator) -> compile(<net>, res=<its own>,
                ...) -> NetworkPlan.apply, twice per path:
                  * fp32 pallas_winograd, all eight networks, batch 4 (the
                    five of the rest of the zoo -- VGG-19, GoogleNet,
                    SqueezeNet, MobileNet-v1 0.5, Inception-v3 with its
                    1xN / Nx1 layers on winograd_1d -- also batch 1);
                  * path A: pallas_winograd at compute_dtype bfloat16 and
                    int8, all eight, batch 4 (VGG-16 and the MobileNets
                    also batch 1);
                  * path B: pallas_winograd_materialized, VGG-16 and
                    Inception-v3, batch 4.
                Every launch counter is set to 0 just before a path's two
                forwards and read just after; each plan's launches are
                counted around its own apply. fp32 and path B logits are
                checked against the same network on the plain executors
                (algorithm="winograd") or the streamed network, and against
                a direct F.conv2d network (direct_forward), on the card with
                TF32 off. Path
                A's gate is per plan: every plan of the network is run
                again on its own recorded input with every kernel replaced
                by its plain version and held to TOL_NET_PLAIN (see there);
                its logits are compared, ungated, with the same plan on the
                plain versions end to end and with the fp32 network;
                  * path C: falcon-mamba-7b at full width and 64 layers,
                    init_params (seeded CUDA torch.Generator, fp32) ->
                    make_prefill_step on 4 prompts of 2048 tokens -> 16
                    greedy make_serve_step ticks, counters read around the
                    prefill (64 selective_scan) and the ticks (none);
                    gates, fp32: (a) every layer's scan against its plain
                    version as a prefill runs, (b) the prefill logits
                    against the model on the plain versions, (c) prefill +
                    16 teacher-forced ticks against forward_logits on the
                    2064 tokens; then the same weights cast to bf16 (the
                    reference's fp32 leaves kept), gate (a), logits and
                    tokens against fp32 reported;
                  * path D: plan_depthwise_conv1d(backend="pallas") on
                    layer 0's recorded short-conv input and on random
                    input, fp32 and bf16, one conv1d_ct_fused launch per
                    apply, against the "jnp" plan and a direct F.conv1d;
  4. timing  -- per kernel-bearing layer of the main paths at batch 4 (the
                fp32 networks, path A's depthwise (stride 1 and 2), matmul
                and stem layers,
                path B's layers),
                the kernel held once more against its plain version, then
                CUDA-event medians per call of the kernel, its plain
                version and a cuDNN / cuBLAS yardstick the port never
                calls, and the device time of the kernel and the yardstick
                (CUDA-graph replays, no host work inside; the rest of the
                zoo's fp32 layers under the path "float32 zoo"); path B's
                per-layer A/B against the streamed plans (VGG-16); the whole
                forward of each path (batch 1 and 4 where it runs both,
                path B batch 4) beside the cuDNN network, per call and on
                the device; a torch.profiler split of the MobileNet-v1
                forward at batch 4, fp32 and bf16, and of Inception-v3's at
                fp32 with its winograd_1d layers as a family, which are
                also timed one by one on their recorded inputs against
                cuDNN's 1xN / Nx1 convs;
                path C's prefill ms, decode ms per tick and tokens/s at
                fp32 and bf16 with a torch.profiler split of one prefill
                and one tick; selective_scan on layer 0's recorded inputs
                and conv1d_ct_fused on its recorded short-conv input, per
                call, on the device, plain, against their bounds and (the
                conv) cuDNN's depthwise F.conv1d.
  5. serve   -- the serving runtime (repro_torch.runtime.serve.Server),
                serve_phase:
                  (a) MobileNet-v2 at 224, fp32, pallas_winograd, buckets
                      (1, 2, 4, 8): a cold server saves 4 artifacts, a
                      second warm-starts from them with no filter transform;
                      the launch counters are set to 0 before its start
                      (a supervised batch and the CUDA-graph capture per
                      bucket) and read after 64 requests in bursts of 1, 3,
                      8 and 16, which must add no launch (graph replays);
                      every answer within TOL_NET_PLAIN of the eager
                      bucket-1 apply, no failure, no fallback; p50 / p99
                      latency, requests/s, batches per bucket;
                  (b) ms per batch through the graph dispatch, the eager
                      supervised path and the hook-free apply, and the
                      device time, MobileNet-v2 at every bucket and
                      Inception-v3 at 299, bucket 4;
                  (c) the fault drill, MobileNet-v2 buckets (1, 4): a
                      transient executor fault (one retry), a permanent one
                      raising inside the capture (one graph fallback, the
                      layer re-placed onto im2col in every bucket), a
                      flipped artifact bit (counted and recompiled), a
                      burst past the queue (rejected with retry_after_s,
                      nothing dropped), a latency spike without graph
                      dispatch (one eviction); answers against the
                      un-faulted server's;
                  (d) GoogleNet at 224, int8, buckets (1, 4): the
                      precision probe's report, a second probe promoting
                      nothing, the served logits against the fp32 network.
  6. autotune -- the measured auto_tuned planner, autotune_phase (every
                contender is a plain PyTorch executor, so the counters
                read around the two networks' forwards must stay 0):
                  (a) VGG-16 and (b) GoogleNet at 224, batch 4, through
                      compile(..., algorithm="auto_tuned"): per layer the
                      race's t_* (CUDA events, best of 3), winner, tile
                      and planning seconds; each raced plan on its
                      recorded input against F.conv2d in float64
                      (TOL_AUTOTUNE; F(6, 3) its fp32 budget), the
                      contenders per filter size (3x3: F(4, 3), F(2, 3),
                      F(6, 3), FFT, im2col; 5x5: F(2, 5), FFT, im2col; the
                      7x7 stride-2 stem: the strided executor, im2col);
                      the logits against the cuDNN network (reported);
                  (c) compute_dtype="auto" on GoogleNet's nine 5x5 layers
                      and VGG-16's conv1_2 / conv5_3: err_winograd_bf16 /
                      err_winograd_int8, the winner's dtype, no winner
                      over its budget;
                  (d) a second compile of VGG-16 (13 spec-cache hits,
                      nothing measured) and a save / load (nothing
                      measured, describe() and evidence equal, logits
                      bitwise equal);
                  (e) ResNeXt-50 32x4d's stage-1 grouped conv under
                      "winograd" and "auto_tuned" against float64
                      F.conv2d(groups=32);
                  (f) device ms of the auto_tuned, pallas_winograd and
                      cuDNN networks, and of every plain executor the race
                      fields, per layer, beside cuDNN's conv.
  7. per call -- the per-call API and the 1-D path (per_call_phase,
                tuningdb_phase, observe_phase), counters set to 0 just
                before each path and read just after:
                  (a) the Whisper-tiny stem at full width (80 mels, 3000
                      frames, d_model 384), batch 4 and 1, through
                      compile(params, audio.stem_graph(384), input_shape=)
                      under "auto", "im2col" and "pallas_winograd": each
                      describe() the JAX package's (STEM_TABLES), no launch,
                      every output within TOL_STEM of the float64 F.conv1d
                      stem, the per-call stem and stem(plans=) within
                      TOL_STEM_PATHS of the compiled apply, save / load
                      bitwise (batch 4); ms per call and on the device
                      against the same stem on cuDNN's F.conv1d;
                  (b) cnn_forward(..., algorithm="pallas_winograd") on
                      VGG-16 and MobileNet-v1 at 224, batch 4, on phase 3's
                      inputs (EXPECTED_PER_CALL launches), logits against
                      the compiled network and the direct one, every
                      depthwise leaf (fp32 taps) against its plain version
                      and timed, ms per call against the compiled apply;
                  (c) ops.winograd_conv2d / im2col_conv2d / fft_conv2d /
                      winograd_f63_conv2d on VGG-16 conv3_1 and conv5_1,
                      batch 4: the two kernel wrappers bitwise equal to the
                      planned applies, all four against float64, ms per
                      call beside the planned apply;
                  (d) phase 6's networks and the same at batch 1 exported
                      into one tuning database, saved under build/; a fresh
                      process compiling both with REPRO_TUNING_DB set
                      measures nothing and plans phase 6's winners;
                  (e) the profiler's overhead on MobileNet-v2 served from
                      buckets (1, 2, 4, 8): OBSERVE_ROUNDS rounds of
                      OBSERVE_PER_ROUND requests, profiler off then on;
                      eager dispatch gated (overhead < 10 %, residual
                      < 1 %, a valid chrome trace, layer spans), graph
                      dispatch reported; build/observe.json read back
                      through repro_torch.obs.regress.

  8. partition -- partitioned NetworkPlans (partition_phase) on
                make_data_mesh(D, devices=[card] * D), fp32
                pallas_winograd, counters set to 0 just before each path
                and read just after:
                  (a) VGG-16 at 224, batch 4, partition="spatial", D = 2
                      and 4: the record's modes (PARTITION_SPATIAL), each
                      halo node's kernel launched once per shard and every
                      other node once, every halo leaf against its plain
                      version at its strip shape, logits against the
                      unsharded plan and the float64 direct network,
                      device ms sharded and unsharded with the share in the
                      halo / gather / scatter copies (torch.profiler), and
                      per halo layer the D strips against the whole layer;
                  (b) GoogleNet at 224, batch 4, spatial over 4 (the 5x5
                      layers with 2-row halos, the concats local): the same;
                  (c) MobileNet-v2 at 224, batch 8, partition="data" over
                      4 (local batch 2): the same against the unsharded
                      plan at batch 8;
                  (d) Server(mesh=, partition="data") on MobileNet-v2,
                      buckets (1, 2, 4, 8): sharded buckets 4 and 8, each
                      replaying a CUDA graph of its sharded plan (traffic
                      adds no launch), answers against the eager bucket-1
                      apply, p50 / p99 beside phase 5's;
                  (e) (a)'s D = 4 plan warm-started from its artifact
                      (1 hit, 0 misses, the same record, bitwise-equal
                      logits) against its cold compile, and MobileNet-v2's
                      four bucket artifacts warm against cold, with the
                      time in the two digest passes (verify_artifact and
                      load) and in building the plans from their arrays.

  9. LM serve -- the rest of the LM stack (lm_serving_phase), fp32, TF32
                off, counters set to 0 just before each path and read just
                after:
                  * path E: jamba-v0.1-52b at full width, one 8-layer
                    period (n_layers 32 -> 8: attention at index 4, seven
                    Mamba layers, four MoE layers of 16 experts top-2, four
                    MLP layers), init_params (seeded CUDA generator) ->
                    make_prefill_step (capacity-bounded MoE) on 4 prompts of
                    512 tokens (7 selective_scan launches) -> 16 greedy
                    make_serve_step ticks (none); gates: (a) every Mamba
                    layer's scan against its plain version in float64, (b)
                    the prefill logits against the model on the plain
                    versions, (c) prefill(dropless) + 16 teacher-forced
                    ticks against forward_logits on the 528 tokens; prefill
                    ms, tokens/s, ms per tick against the bytes a tick
                    reads, peak memory, a profile of one prefill and one
                    tick; selective_scan timed at its layer shape;
                  * path F: qwen2.5-3b, the full config, behind
                    launch/serve.Server (4 slots, 256 rows): 8 requests of
                    16-token prompts, 16 new tokens each; tokens/s, ticks,
                    a profile of one server step; gate: a one-slot server's tokens for request 0 are
                    greedy decoding through prefill + decode_step, whose
                    logits are within TOL_LM_SERVE of forward_logits;
                  * path G: whisper-tiny, the full config: the stem on
                    (2, 3000, 80) mel -> frames (2, 1500, 384), prefill of 8
                    tokens with the frames and 8 greedy ticks against
                    forward_logits(frames=); ms of each;
                  * the other six architectures at full width (ARCH_SWEEP:
                    granite-moe-3b-a800m whole, the rest cut to one scan
                    unit): prefill + 4 teacher-forced ticks against
                    forward_logits, then prefill and tick ms.

 10. training -- the LM stack trained (training_phase), fp32, TF32 off,
                counters set to 0 just before each path and read just
                after:
                  (a) falcon-mamba-7b at full width, n_layers 64 -> 1, one
                      batch of 2 x 512 tokens: make_loss_and_grads (the
                      scan kernel forward, launched in the forward and in
                      the unit's checkpoint recompute) against the same
                      weights and batch in float64 through the plain
                      versions (float64_model); the loss and each gradient
                      leaf within TOL_TRAIN_GRAD;
                  * path H: falcon-mamba-7b at full width, n_layers 64 ->
                    8, 4 AdamW steps of make_train_step on SyntheticLM
                    batches of 4 x 2048 tokens (16 selective_scan
                    launches a step, gated), every loss finite; ms per
                    step, tokens/s, peak memory beside the 16 bytes a
                    parameter reckoned, a profile of one step (the scan's
                    backward and the update as ranges); accum_steps=2 on
                    the first batch within TOL_TRAIN_ACCUM of its loss;
                    one bf16 step, every gradient leaf bf16 (the fp32
                    leaves fp32) and finite;
                  * path I: launch/train.train("whisper_tiny") at full
                    config, 8 steps with a checkpoint every 4 in a
                    temporary directory; a fresh train() in a directory
                    holding only step_4 resumes there, its losses within
                    TOL_TRAIN_RESTART of the uninterrupted run's, the
                    restored tensors on the card.

 11. LM mesh -- the LM's meshes (mesh_phase), fp32, TF32 off, on meshes
                that repeat the card (the cost of a mesh on one card, not a
                scaling), counters set to 0 just before each path and read
                just after:
                  (a) falcon-mamba-7b at full width, n_layers 64 -> 8 (path
                      H's weights and first 4 x 2048 batch), placed by
                      param_shardings on make_host_mesh(2, devices=[card] *
                      4), tensor-parallel over the model axis: the
                      sharded loss and gradients (profiled, the gathers,
                      the model axis's collectives and the scatter as
                      ranges) against the unsharded ones (loss
                      TOL_MESH_LOSS, every gathered gradient leaf
                      TOL_MESH_GRAD), AdamW on the same gradients on the
                      pieces against the unsharded update
                      (TOL_MESH_UPDATE), then MESH_STEPS sharded AdamW
                      steps, 64 selective_scan launches each (8 layers x
                      forward and recompute x 2 data groups x 2 model
                      positions, each on d_in / 2 = 4096 channels); one
                      scan at that width against its plain version in
                      float64 (TOL_SCAN); ms per step beside path H's,
                      peak memory, replicas bitwise equal;
                  (b) launch/train.train("whisper_tiny", mesh=) on (4, 1),
                      8 steps with a checkpoint every 4, then a fresh
                      train() on (2, 2) in a directory holding only step_4:
                      its losses within TOL_TRAIN_RESTART of the
                      uninterrupted run's, the restored pieces on the card
                      at their specs' shapes;
                  (c) qwen2.5-3b, the full config, placed on (2, 2) behind
                      launch/serve.Server(mesh=) (tensor-parallel, its
                      cache placed by cache_specs): path F's 8 requests,
                      the tokens equal to the mesh-less server's; ms per
                      step beside it and path F's.

 12. dry run -- the port's dry run (launch/dryrun.py: the step on "meta"
                tensors under launch/opcost.CostMode, the H100's datasheet
                roofline) held against the card (dryrun_phase), fp32, TF32
                off: (a) path H's configuration (falcon-mamba-7b at full
                width, 8 layers, 4 x 2048, mesh-less) dry-run, then one
                real path H step under FlopCounterMode, after gc.collect()
                and reset_peak_memory_stats() from the resident params and
                moments, with the counters set to 0 just before it and
                read just after; gates: the dry run's launches
                equal to the counters' for every kernel, its matmul FLOPs
                within TOL_DRYRUN_FLOPS of FlopCounterMode's, its peak
                (argument + temp) within TOL_DRYRUN_PEAK of the step's
                measured one (the argument plus max_memory_allocated's
                growth); printed beside them: the roofline ms and
                bottleneck against path H's measured ms; (b) phase 11
                (a)'s tensor-parallel (2, 2) step dry-run on one device,
                its launches gated equal to EXPECTED_MESH_STEP, its peak
                beside phase 11's measured one.

 13. examples -- the six scripts of examples/torch/ (examples_phase), each
                through its main(argv) as a user first runs it: on the
                card at its defaults (train_lm with --steps 20): quickstart
                (56 x 56 x 64 convs, MobileNet-v1 0.5 compiled at 64),
                cnn_inference (SqueezeNet at 224 under im2col, auto and
                pallas_winograd), serve_conv (MobileNet-v2 at 96 behind
                Server, buckets (1, 2, 4), eager, the fault drill),
                mamba_cook_toom (the short conv at 4 x 2048 x 4096, a
                smoke-size Mamba block), train_lm (the ~100M qwen2.5,
                batch 8 x 128, accum 2), serve_batched (smoke qwen2.5-3b
                under make_host_mesh); counters set to 0 just before each
                script's counted run and read just after, which must show
                quickstart on winograd_streamed, cnn_inference on it and
                winograd_strided_streamed, serve_conv on
                separable_streamed, depthwise_strided_streamed and matmul,
                mamba_cook_toom on conv1d_ct_fused and selective_scan;
                every number returned finite; wall seconds of the counted
                run, device ms of a second, profiled run.

It prints the card's name and power limit, one `{"kernels": [...]}` line,
and as its last line `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: Kernel vs plain version, relative max-abs error (of max |plain|): both
#: run the same fp32 transforms and fp32 sums in another order. The TF32x3
#: kernels (TF32X3) are held to it against the plain version in float64.
TOL_KERNEL = 2e-5
#: Logits of a slice, relative max-abs error, vs the same network on the
#: plain executors (same transforms, other summation order) and vs a
#: direct F.conv2d network, both fp32 with TF32 off. VGG-16 reads about
#: 3.9e-6 on an H100 (PERF.md); the limit is about 13 times that, well
#: below what TF32 or bf16 sums in a kernel would give (1e-4 and more).
TOL_NET_PLAIN = 5e-5
TOL_NET_DIRECT = 5e-5
#: Path A (bf16 / int8) is gated per plan, not on its logits: each plan on
#: the input it received in the kernel run, against the same plan with
#: every kernel replaced by its plain version, at TOL_NET_PLAIN. The
#: end-to-end logits would need no upstream difference: a bf16 `im2col`
#: layer (MobileNet-v2's 1x1 expands and head) rounds its input activations
#: to bf16, as the JAX package's does, so a kernel-vs-plain difference of
#: 1e-7 upstream flips some roundings and moves those activations by a
#: bf16 step (MobileNet-v2 bf16 logits read 9.7e-4 on an H100, PERF.md).
#: Both runs share the plan's wiring, so the logits add no check of their
#: own; they are printed beside the fp32 network's.
#: H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 on the CUDA cores and
#: HBM3 bandwidth. Bounds below are computed from these.
#: The kernels that run their GEMMs as TF32x3 tensor-core products and
#: are held against their plain version in float64 (see compare).
TF32X3 = ("winograd_streamed", "separable_streamed", "matmul",
          "winograd_strided_streamed", "winograd_fused")
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: The special-function unit (MUFU.EX2, the exponential each scan update
#: takes): 16 results per SM per clock on compute capability 9.0 (the CUDA
#: C++ Programming Guide's arithmetic-instruction throughput table), on
#: 132 SMs at the 1.98 GHz that PEAK_FP32_FLOPS implies (128 FMA lanes x 2
#: x 132 x 1.98e9 = 67e12).
PEAK_SFU_OPS = 16 * 132 * 1.98e9
#: Dense TF32 on the tensor cores (same data sheet): the rate the TF32x3
#: kernels' products run at.
PEAK_TF32_FLOPS = 495e12

#: selective_scan against its plain version, relative max-abs error of
#: y and of h_last: the reference's own limit for its kernel against the
#: sequential oracle (tests/test_selective_scan.py). The kernel is held to
#: it against the plain version run in float64 (scan_exact), as the
#: TF32X3 kernels are: its decays are ex2.approx (one MUFU.EX2) where the
#: fp32 plain version's are expf, and at the layer shape the fp32 plain
#: version itself reads 8.6e-6 from float64, the kernel 3.5e-6, the two
#: 1.2e-5 apart (an H100, PERF.md). The error against the fp32 plain
#: version is reported beside it.
TOL_SCAN = 1e-5
#: A kernel whose output is bf16 (conv1d_ct_fused on bf16 tiles) against
#: its plain version: both compute in fp32 and round once, so a sum that
#: lands on a rounding boundary may round the other way, one bf16 step
#: (2^-8 of the value, at most 3.9e-3 of max |y|).
TOL_BF16_OUT = 8e-3
#: Path D at bf16 against a direct fp32 F.conv1d on the same bf16 input
#: and taps: the Cook-Toom taps G w are rounded to bf16 (2^-9 relative)
#: and the F(4, 4) inverse transform (entries up to 8) amplifies that; the
#: CPU reads 1.1e-2 to 1.8e-2 on random data, and the model's own "jnp"
#: plan, which also rounds its intermediates, up to 3e-2. A wrong kernel
#: reads O(1).
TOL_CONV1D_BF16_DIRECT = 5e-2
#: Path C gate (b): the fp32 prefill logits against the same model with
#: every kernel swapped for its plain version. Each layer's scan differs
#: by ~5e-7 (gate (a)) and 64 layers of fp32 GEMMs carry that to the
#: logits: an H100 reads 1.26e-5 (PERF.md); the limit is 4 times that,
#: where a wrong layer would read 1e-3 and more.
TOL_LM_PLAIN = 5e-5
#: Path C gate (c), fp32: prefill(2048) and 16 teacher-forced decode
#: steps against forward_logits on the 2064 tokens. The decode step (a
#: direct conv sum, one recurrent scan step, (B, D) GEMVs) and the forward
#: (the Cook-Toom conv, the scan kernel, (B*L, D) GEMMs) sum in other
#: orders through 64 layers: an H100 reads 2.1e-5 to 2.9e-5 by position
#: (PERF.md); the limit is 3.5 times the largest.
TOL_LM_INVARIANT = 1e-4

MAIN_BATCH = 4
CHECK_BATCH = 2
REDUCED = ("bfloat16", "int8")
#: Path C: falcon-mamba-7b at full width and depth, 4 prompts of 2048
#: tokens, 16 greedy decode ticks.
LM_ARCH = "falcon_mamba_7b"
LM_BATCH, LM_PROMPT, LM_TICKS = 4, 2048, 16
#: Launches per prefill (one scan per Mamba layer) and per decode tick
#: (the recurrent step has no kernel, as in the reference).
EXPECTED_PREFILL = {"selective_scan": 64}
EXPECTED_DECODE: dict = {}
#: Leaves the reference keeps in fp32 whatever the params' dtype.
FP32_LEAVES = ("dt_bias", "a_log", "d_skip")
#: name -> (source, the TPU kernel it replaces)
KERNELS = {
    "winograd_streamed": ("src/repro_torch/kernels/csrc/winograd_streamed.cu",
                          "src/repro/kernels/winograd.py:152"),
    "winograd_strided_streamed": (
        "src/repro_torch/kernels/csrc/winograd_strided_streamed.cu",
        "src/repro/kernels/winograd.py:317"),
    "depthwise_strided_streamed": (
        "src/repro_torch/kernels/csrc/depthwise_strided_streamed.cu",
        "src/repro/kernels/depthwise.py:220"),
    "separable_streamed": (
        "src/repro_torch/kernels/csrc/separable_streamed.cu",
        "src/repro/kernels/depthwise.py:340"),
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
               "src/repro/kernels/matmul.py:56"),
    "depthwise_streamed": (
        "src/repro_torch/kernels/csrc/depthwise_streamed.cu",
        "src/repro/kernels/depthwise.py:109"),
    "winograd_fused": ("src/repro_torch/kernels/csrc/winograd_fused.cu",
                       "src/repro/kernels/winograd.py:435"),
    "conv1d_ct_fused": ("src/repro_torch/kernels/csrc/conv1d_ct_fused.cu",
                        "src/repro/kernels/conv1d_ct.py:36"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:76"),
}
#: Launches per forward of each main path, by kernel: fp32
#: pallas_winograd, path A (the same at bfloat16 / int8: the separable
#: blocks compose onto depthwise_streamed + matmul, F(2, 3) everywhere) and
#: path B (pallas_winograd_materialized).
#: The 1x1 layers of VGG-19, GoogleNet, SqueezeNet and Inception-v3 run on
#: `im2col` (torch.matmul) and their 1xN / Nx1 layers on `winograd_1d`
#: (plain PyTorch, as the reference's XLA executor): neither launches a
#: kernel at any dtype.
EXPECTED = {
    "vgg16": {"winograd_streamed": 13},
    "mobilenet_v1": {"winograd_strided_streamed": 1, "separable_streamed": 9,
                     "depthwise_strided_streamed": 4, "matmul": 4},
    "mobilenet_v2": {"winograd_strided_streamed": 1, "separable_streamed": 13,
                     "depthwise_strided_streamed": 4, "matmul": 4},
    "vgg19": {"winograd_streamed": 16},
    "googlenet": {"winograd_streamed": 19, "winograd_strided_streamed": 1},
    "squeezenet": {"winograd_streamed": 8, "winograd_strided_streamed": 1},
    "mobilenet_v1_050": {"winograd_strided_streamed": 1,
                         "separable_streamed": 9,
                         "depthwise_strided_streamed": 4, "matmul": 4},
    "inception_v3": {"winograd_streamed": 15, "winograd_strided_streamed": 5},
}
EXPECTED_REDUCED = {
    **EXPECTED,
    "mobilenet_v1": {"depthwise_streamed": 9,
                     "depthwise_strided_streamed": 4,
                     "winograd_strided_streamed": 1, "matmul": 13},
    "mobilenet_v2": {"depthwise_streamed": 13,
                     "depthwise_strided_streamed": 4,
                     "winograd_strided_streamed": 1, "matmul": 17},
    "mobilenet_v1_050": {"depthwise_streamed": 9,
                         "depthwise_strided_streamed": 4,
                         "winograd_strided_streamed": 1, "matmul": 13},
}
#: Path B (pallas_winograd_materialized): its stride-2 layers fall back to
#: im2col.
EXPECTED_MATERIALIZED = {"vgg16": {"winograd_fused": 13},
                         "inception_v3": {"winograd_fused": 15}}
#: The networks of the earlier slices (batch 1 and 4 at every dtype) and
#: the rest of models/cnn.py:NETWORKS (batch 1 and 4 at fp32, batch 4 at
#: bf16 / int8), each at its own resolution.
FIRST = ("vgg16", "mobilenet_v1", "mobilenet_v2")
ZOO = ("vgg19", "googlenet", "squeezenet", "mobilenet_v1_050",
       "inception_v3")
#: The yardstick each kernel is timed against (never called by the port).
LIBRARY = {
    "winograd_streamed": "cuDNN F.conv2d + bias + act",
    "winograd_strided_streamed":
        "F.pad (asymmetric SAME pads) + cuDNN F.conv2d stride 2 + bias + act",
    "depthwise_strided_streamed":
        "F.pad (asymmetric SAME pads) + cuDNN F.conv2d groups=C stride 2 "
        "+ bias + act",
    "separable_streamed": "cuDNN dw F.conv2d + act + 1x1 F.conv2d + act",
    "matmul": "torch.addmm + act (cuBLAS, TF32 off)",
    "depthwise_streamed":
        "cuDNN F.conv2d groups=C + bias + act, fp32 filter",
    "winograd_fused": "cuDNN F.conv2d on the same layer (no bias or act: "
                      "the kernel has no epilogue)",
    "conv1d_ct_fused": "cuDNN depthwise F.conv1d (groups=C, padding r-1) on "
                       "the same conv, contiguous NCL input, fp32 taps",
    "selective_scan": None,       # no single PyTorch call computes it
}


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


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Median device milliseconds of one fn() call: `reps` calls captured
    in one CUDA graph, replayed `iters` times between CUDA events. The
    host's per-call work (Python, argument checks, the launch itself) stays
    outside the graph, so this is the device's time, where cuda_ms also
    counts any gap the host leaves the device."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                      # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def kernel_modules() -> tuple:
    from repro_torch.kernels import conv1d_ct as kc
    from repro_torch.kernels import depthwise as kd
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import selective_scan as ks
    from repro_torch.kernels import winograd as kw
    return kd, km, kw, kc, ks


def wrappers() -> dict:
    kd, km, kw, kc, ks = kernel_modules()
    return {"winograd_streamed": kw.winograd_streamed,
            "winograd_strided_streamed": kw.winograd_strided_streamed,
            "depthwise_strided_streamed": kd.depthwise_strided_streamed,
            "separable_streamed": kd.separable_streamed,
            "matmul": km.matmul,
            "depthwise_streamed": kd.depthwise_streamed,
            "winograd_fused": kw.winograd_fused,
            "conv1d_ct_fused": kc.conv1d_ct_fused,
            "selective_scan": ks.selective_scan}


def plains() -> dict:
    kd, km, kw, kc, ks = kernel_modules()
    return {"winograd_streamed": kw.winograd_streamed_plain,
            "winograd_strided_streamed": kw.winograd_strided_streamed_plain,
            "depthwise_strided_streamed": kd.depthwise_strided_streamed_plain,
            "separable_streamed": kd.separable_streamed_plain,
            "matmul": km.matmul_plain,
            "depthwise_streamed": kd.depthwise_streamed_plain,
            "winograd_fused": kw.winograd_fused_plain,
            "conv1d_ct_fused": kc.conv1d_ct_fused_plain,
            "selective_scan": ks.selective_scan_plain}


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper replaced, in its module, by its plain version on
    the same (CUDA) tensors: a compiled plan run inside runs its own
    operands, the same quantized filters, through fp32 PyTorch ops. The
    substitutes drop the blocking arguments the plain versions do not take
    and count no launch."""
    modules = {name: mod for mod in kernel_modules() for name in KERNELS
               if hasattr(mod, name)}
    saved = {name: getattr(mod, name) for name, mod in modules.items()}
    plain = plains()

    def substitute(fn):
        def run(*args, block_r=None, block_s=None, block_c=None,
                block_m=None, block_n=None, splits=None, **kwargs):
            return fn(*args, **kwargs)
        return run

    for name, mod in modules.items():
        setattr(mod, name, substitute(plain[name]))
    try:
        yield
    finally:
        for name, mod in modules.items():
            setattr(mod, name, saved[name])


def reset_counts() -> None:
    for fn in wrappers().values():
        fn.LAUNCHES = 0


def read_counts() -> dict:
    return {name: fn.LAUNCHES for name, fn in wrappers().items()}


# ---------------------------------------------------------------------------
# the kernel-bearing leaves of a compiled network
# ---------------------------------------------------------------------------

class Leaf(NamedTuple):
    """One kernel launch of a network's forward: the kernel, the layer, the
    plan that launches it and its epilogue activations."""

    kernel: str
    layer: str
    plan: Any
    acts: tuple


_EXECUTOR_KERNEL = {"pallas_winograd": "winograd_streamed",
                    "pallas_winograd_strided": "winograd_strided_streamed",
                    "pallas_depthwise_strided": "depthwise_strided_streamed",
                    "pallas_im2col": "matmul",
                    "pallas_depthwise": "depthwise_streamed",
                    "pallas_winograd_materialized": "winograd_fused"}


def leaves_of(layer: str, plan, acts: tuple) -> list[Leaf]:
    """The kernel launches of one plan; `im2col` and `winograd_1d` plans
    (plain PyTorch) have none."""
    from repro_torch.core import plan as pt_plan
    if isinstance(plan, pt_plan.InvertedResidualPlan):
        # the 1x1 expand runs on im2col (torch.matmul): no kernel
        return leaves_of(layer, plan.sep, (acts[0], "none"))
    if isinstance(plan, pt_plan.SeparableBlockPlan):
        if plan.mode == "fused_pallas":
            return [Leaf("separable_streamed", layer, plan, acts)]
        return (leaves_of(f"{layer}.dw", plan.dw, acts[:1])
                + leaves_of(f"{layer}.pw", plan.pw, acts[1:]))
    kernel = _EXECUTOR_KERNEL.get(plan.spec.algorithm)
    return [Leaf(kernel, layer, plan, acts)] if kernel else []


def network_leaves(net) -> list[Leaf]:
    out = []
    for node in net.graph:
        if node.id not in net.plans:
            continue
        a = node.attrs
        acts = {"conv2d": (a.get("activation"),),
                "separable": (a.get("inner_activation"), a.get("activation")),
                "inverted_residual": (a.get("activation"), "none")}[node.op]
        out += leaves_of(node.id, net.plans[node.id], acts)
    return out


def pad_for_conv(xc, ph: tuple, pw: tuple):
    """(input, padding=) for F.conv2d with lo/hi pads: symmetric pads go
    to cuDNN's own padding, asymmetric ones (stride-2 SAME) to an F.pad."""
    import torch.nn.functional as F
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return xc, (ph[0], pw[0])
    return F.pad(xc, (pw[0], pw[1], ph[0], ph[1])), 0


@contextlib.contextmanager
def double_plain():
    """The plain versions in float64: their `.float()` casts become no-ops,
    so the same arithmetic runs in double precision, the yardstick of both
    the kernel's and the fp32 plain version's rounding error."""
    import torch
    cast = torch.Tensor.float
    torch.Tensor.float = lambda self: self
    try:
        yield
    finally:
        torch.Tensor.float = cast


def leaf_calls(leaf: Leaf, x, randn):
    """(kernel thunk, plain thunk, library thunk, float64 plain thunk or
    None) of one leaf on input x (NHWC, the plan's input shape at any
    batch), with random biases. The fourth, for the TF32X3 kernels, runs
    the plain version in float64 on the same operands (the oracle of
    those kernels, see compare)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import im2col
    from repro_torch.kernels import depthwise as kd
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ops
    from repro_torch.kernels import winograd as kw
    from repro_torch.kernels.runtime import apply_activation
    plan, s = leaf.plan, leaf.plan.spec
    xc = x.permute(0, 3, 1, 2)                   # channels_last NCHW view
    if leaf.kernel == "separable_streamed":
        c, m, k = s.x_shape[3], s.w_pw_shape[3], s.w_dw_shape[0]
        b_dw, b_pw = randn(c, scale=0.1), randn(m, scale=0.1)
        xp = ops.pad_streamed_input(x, s.geometry, s.stream)
        kwargs = dict(ct_h=s.ct_h, ct_w=s.ct_w, bh=s.stream.bh,
                      bw=s.stream.bw, inner_activation=leaf.acts[0],
                      activation=leaf.acts[1])
        # the yardstick's filters, from the plan's own operands
        w_dw = randn(k, k, 1, c).permute(3, 2, 0, 1).contiguous()
        w_pw = plan.u_pw[:c, :m].t().reshape(m, c, 1, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            z = apply_activation(F.conv2d(xc, w_dw, b_dw, padding=k // 2,
                                          groups=c), leaf.acts[0])
            return apply_activation(F.conv2d(z, w_pw, b_pw), leaf.acts[1])
        ops64 = [t.double() for t in (xp, plan.u_dw, plan.u_pw, b_dw, b_pw)]

        def exact():
            with double_plain():
                return kd.separable_streamed_plain(*ops64, **kwargs)
        return (lambda: kd.separable_streamed(
                    xp, plan.u_dw, plan.u_pw, b_dw, b_pw,
                    block_c=s.stream.block_c, block_m=s.stream.block_m,
                    **kwargs),
                lambda: kd.separable_streamed_plain(
                    xp, plan.u_dw, plan.u_pw, b_dw, b_pw, **kwargs),
                library, exact)
    kh, kw_, cg, m = s.w_shape
    w_lib = randn(kh, kw_, cg, m, scale=(kh * kw_ * cg) ** -0.5).permute(
        3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    if leaf.kernel == "winograd_fused":
        tiles = ops.extract_tiles(x, ct_h=s.ct_h, ct_w=s.ct_w,
                                  geometry=s.geometry, blocks=s.blocks)
        kwargs = dict(ct_h=s.ct_h, ct_w=s.ct_w)
        ops64 = (tiles.double(), plan.u.double())

        def exact():
            with double_plain():
                return kw.winograd_fused_plain(*ops64, **kwargs)
        g = im2col.im2row_geometry(s.x_shape[1], s.x_shape[2], kh, kw_,
                                   s.stride, s.padding)

        def library():
            xin, pad = pad_for_conv(xc, g.ph, g.pw)
            return F.conv2d(xin, w_lib, padding=pad)
        return (lambda: kw.winograd_fused(tiles, plan.u, block_r=s.blocks[0],
                                          block_c=s.blocks[1],
                                          block_m=s.blocks[2], **kwargs),
                lambda: kw.winograd_fused_plain(tiles, plan.u, **kwargs),
                library, exact)
    bias = randn(m, scale=0.1)
    if leaf.kernel == "matmul":
        if (kh, kw_) == (1, 1) and s.stride == (1, 1):
            a = x.reshape(-1, x.shape[3])
        else:
            a, _ = im2col.im2row(x, kh, kw_, s.stride, s.padding, s.geometry)
            a = a.contiguous()
        b_log = plan.u[:a.shape[1], :m].float().contiguous()
        args = (a, plan.u, bias, plan.scale)
        kwargs = dict(n_out=m, activation=leaf.acts[0])
        ops64 = [None if t is None else t.double() for t in args]

        def exact():
            with double_plain():
                return km.matmul_plain(*ops64, **kwargs)
        return (lambda: km.matmul(*args, block_m=s.blocks[0],
                                  block_n=s.blocks[2], splits=s.blocks[3],
                                  **kwargs),
                lambda: km.matmul_plain(*args, **kwargs),
                lambda: apply_activation(torch.addmm(bias, a, b_log),
                                         leaf.acts[0]),
                exact)
    stride = s.stride[0]
    xp = ops.pad_streamed_input(x, s.geometry, s.stream, stride=stride)
    kwargs = dict(ct_h=s.ct_h, ct_w=s.ct_w, bh=s.stream.bh, bw=s.stream.bw,
                  activation=leaf.acts[0])
    fn, plain = wrappers()[leaf.kernel], plains()[leaf.kernel]
    block = ({"block_c": s.stream.block_c}
             if leaf.kernel.startswith("depthwise")
             else {"block_c": s.stream.block_c, "block_m": s.stream.block_m})
    groups = s.groups
    g = im2col.im2row_geometry(s.x_shape[1], s.x_shape[2], kh, kw_,
                               s.stride, s.padding)

    def library():
        xin, pad = pad_for_conv(xc, g.ph, g.pw)
        return apply_activation(F.conv2d(xin, w_lib, bias, stride=stride,
                                         padding=pad, groups=groups),
                                leaf.acts[0])
    exact = None
    if leaf.kernel in TF32X3:
        ops64 = [None if t is None else t.double()
                 for t in (xp, plan.u, bias, plan.scale)]

        def exact():
            with double_plain():
                return plain(*ops64, **kwargs)
    return (lambda: fn(xp, plan.u, bias, plan.scale, **block, **kwargs),
            lambda: plain(xp, plan.u, bias, plan.scale, **kwargs),
            library, exact)


def leaf_bound(leaf: Leaf, batch: int) -> dict:
    """The least time the card could take for one leaf, as the kernel does
    the work: `bound_ms` the larger of its operations' time and its bytes
    at the memory rate, `bound_by` which. Operations: the point-GEMMs /
    Hadamard products in the transform domain and the pointwise GEMM;
    the TF32X3 kernels run their GEMMs as TF32 products on the tensor cores
    (3 per multiply-add, 2 for a filter widened from bf16 / int8) at
    PEAK_TF32_FLOPS and their transforms (dense t x t products: B^T d B
    once per tile, input channel and phase, A^T y A once per tile and
    output channel; `winograd_fused` the same over its tiles) and the
    depthwise stage at PEAK_FP32_FLOPS, the two
    units running side by side (`matmul` has no transform); the others run
    every operation at PEAK_FP32_FLOPS. `bound_fp32_ms` is the older
    reckoning, every GEMM FLOP at PEAK_FP32_FLOPS, kept beside it. The
    bytes are the real operands, none of the blocking's padding: input,
    filter at its stored dtype (in the transform domain where the kernel
    reads it there), int8 scale, bias and output, each once; for
    `winograd_fused` the input is the tile tensor, (t/m)^2 the image, with
    no bias (no epilogue)."""
    plan, s = leaf.plan, leaf.plan.spec
    _, h, w, c = s.x_shape
    tc_flops = xform_flops = 0
    if leaf.kernel == "separable_streamed":
        g, m = s.geometry, s.w_pw_shape[3]
        th, tw, mh, mw = s.ct_h.t, s.ct_w.t, s.ct_h.m, s.ct_w.m
        p = th * tw
        tiles = batch * g.n_h * g.n_w
        flops = 2 * p * tiles * c + 2 * batch * g.out_h * g.out_w * c * m
        tc_flops = 3 * 2 * batch * g.out_h * g.out_w * c * m
        xform_flops = tiles * c * (2 * p + 2 * (th * th * tw + th * tw * tw)
                                   + 2 * (mh * th * tw + mh * mw * tw))
        nbytes = (4 * (batch * h * w * c + batch * g.out_h * g.out_w * m
                       + c + m)
                  + plan.u_dw.element_size() * p * c
                  + plan.u_pw.element_size() * c * m)
    else:
        kh, kw_, cg, m = s.w_shape
        scale_bytes = 0 if plan.scale is None else 4 * m
        products = 3 if plan.u.element_size() == 4 else 2
        if leaf.kernel == "matmul":
            rows = batch * s.geometry.oh * s.geometry.ow
            flops = 2 * rows * kh * kw_ * cg * m
            tc_flops = products * flops
            nbytes = (4 * (rows * kh * kw_ * cg + rows * m + m) + scale_bytes
                      + plan.u.element_size() * kh * kw_ * cg * m)
        elif leaf.kernel == "winograd_fused":
            g = s.geometry
            r = batch * g.n_h * g.n_w
            th, tw, mh, mw = s.ct_h.t, s.ct_w.t, s.ct_h.m, s.ct_w.m
            p = th * tw
            flops = 2 * p * r * cg * m
            tc_flops = products * flops
            xform_flops = (r * cg * 2 * (th * th * tw + th * tw * tw)
                           + r * m * 2 * (mh * th * tw + mh * mw * tw))
            nbytes = (4 * r * (p * cg + mh * mw * m)
                      + plan.u.element_size() * p * cg * m)
        else:
            g = s.geometry
            phases = 4 if s.stride == (2, 2) else 1
            th, tw, mh, mw = s.ct_h.t, s.ct_w.t, s.ct_h.m, s.ct_w.m
            p = phases * th * tw
            depth = 1 if leaf.kernel.startswith("depthwise") else cg
            tiles = batch * g.n_h * g.n_w
            flops = 2 * p * tiles * depth * m
            if leaf.kernel in TF32X3:
                tc_flops = products * flops
                xform_flops = (phases * tiles * cg * 2
                               * (th * th * tw + th * tw * tw)
                               + tiles * m * 2 * (mh * th * tw
                                                  + mh * mw * tw))
            nbytes = (4 * (batch * h * w * c + batch * g.out_h * g.out_w * m
                           + m) + scale_bytes
                      + plan.u.element_size() * p * depth * m)
    t_bytes = nbytes / PEAK_BYTES
    t_fp32 = flops / PEAK_FP32_FLOPS
    t_ops = (max(tc_flops / PEAK_TF32_FLOPS, xform_flops / PEAK_FP32_FLOPS)
             if tc_flops else t_fp32)
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_fp32_ms": 1e3 * max(t_fp32, t_bytes),
            "gflop": flops / 1e9, "tf32_gflop": tc_flops / 1e9,
            "mbytes": nbytes / 1e6}


def compare(label: str, calls) -> tuple[float, float, float | None]:
    """The kernel against its plain version on the same operands, each
    followed by a synchronize; raises past TOL_KERNEL. The TF32X3 kernels
    are held against their plain version run in float64 (calls[3]): they
    round their sums in groups, where the fp32 plain version's cuBLAS GEMM
    rounds after every product, so the two fp32 roundings are independent
    and each reaches ~1e-5 of max |y| at F(4x4, 3x3) over 512 channels
    (PERF.md); against float64 the reading is the kernel's own
    error. Returns the relative and absolute max-abs errors against the
    oracle, and for the TF32X3 kernels the relative error against the
    fp32 plain version (reported, not gated), else None."""
    import torch
    got = calls[0]()
    torch.cuda.synchronize()
    want = calls[1]()
    torch.cuda.synchronize()
    err_fp32 = None
    if len(calls) > 3 and calls[3] is not None:
        err_fp32 = rel_err(got, want)
        want = calls[3]()
        torch.cuda.synchronize()
        got = got.double()
    err = rel_err(got, want)
    if got.shape != want.shape or not torch.isfinite(got).all() \
            or err > TOL_KERNEL:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version ({err:.3e} > {TOL_KERNEL})")
    return err, float((got - want).abs().max()), err_fp32


# ---------------------------------------------------------------------------
# the direct network (the yardstick and the second oracle)
# ---------------------------------------------------------------------------

def direct_forward(params, specs, x):
    """A network with cuDNN convolutions: NHWC in, logits out. Explicit
    SAME pads per axis (the JAX package's lo/hi split, which torch's
    padding="same" cannot express at stride 2), depthwise convs as
    groups=C, residual adds where MobileNet-v2 has them, inception
    branches concatenated on the channel axis, and the port's own pool2d
    (lax's SAME pads; an average divides by the whole window)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.im2col import _same_pads
    from repro_torch.kernels.runtime import apply_activation
    from repro_torch.models import cnn
    from repro_torch.models.layers import pool2d

    def conv(y, p, kh, kw, stride, groups, act, padding="SAME"):
        pad = 0
        if padding == "SAME":
            y, pad = pad_for_conv(y, _same_pads(y.shape[2], kh, stride),
                                  _same_pads(y.shape[3], kw, stride))
        y = F.conv2d(y, p["w"].permute(3, 2, 0, 1), p["b"], stride=stride,
                     padding=pad, groups=groups)
        return apply_activation(y, act)

    def walk(specs, y):
        for spec in specs:
            if isinstance(spec, cnn.Conv):
                y = conv(y, params[spec.name], spec.kh, spec.kw, spec.stride,
                         spec.groups, spec.act, spec.padding)
            elif isinstance(spec, cnn.SeparableConv):
                p, c = params[spec.name], y.shape[1]
                y = conv(y, p["dw"], spec.k, spec.k, spec.stride, c, "relu",
                         spec.padding)
                y = conv(y, p["pw"], 1, 1, 1, 1, "relu")
            elif isinstance(spec, cnn.InvertedResidual):
                p, src, c = params[spec.name], y, y.shape[1]
                if spec.expand != 1:
                    y = conv(y, p["exp"], 1, 1, 1, 1, "relu6")
                y = conv(y, p["dw"], spec.k, spec.k, spec.stride, y.shape[1],
                         "relu6")
                y = conv(y, p["pw"], 1, 1, 1, 1, "none")
                if spec.stride == 1 and c == spec.c_out:
                    y = src + y
            elif isinstance(spec, cnn.Pool):
                y = pool2d(y.permute(0, 2, 3, 1), spec.kind, spec.k,
                           spec.stride, spec.padding).permute(0, 3, 1, 2)
            elif isinstance(spec, cnn.Concat):
                y = torch.cat([walk(br, y) for br in spec.branches], 1)
            elif isinstance(spec, cnn.GlobalAvgPool):
                y = y.mean(dim=(2, 3))
            elif isinstance(spec, cnn.Dense):
                if y.dim() == 4:
                    y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
                y = torch.matmul(y, params[spec.name]["w"])
                y = F.relu(y) if spec.relu else y
            else:
                raise NotImplementedError(f"direct network: {spec}")
        return y

    return walk(specs, x.permute(0, 3, 1, 2))


def profile_forward(net, x, runs: int = 3, ranges: dict | None = None
                    ) -> dict:
    """Device time by kernel name over `runs` warm forwards, from a
    torch.profiler trace, and the device's busy share of the host wall
    time. `ranges` maps a family label to node ids: each of their plans'
    applies runs inside a record_function of that label, and the device
    time of the kernels launched there is reported per family. Empty when
    the trace holds no device events."""
    import torch
    by_name: dict[str, float] = {}
    families = {label: 0.0 for label in ranges or {}}
    for label, nids in (ranges or {}).items():
        for nid in nids:
            def run(*args, _apply=net.plans[nid].apply, _label=label,
                    **kwargs):
                with torch.profiler.record_function(_label):
                    return _apply(*args, **kwargs)
            net.plans[nid].apply = run
    try:
        full, wall_ms = profile_device(lambda: net.apply(x), runs, families)
    finally:
        for nids in (ranges or {}).values():
            for nid in nids:
                del net.plans[nid].apply
    for name, ms in full.items():
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + ms
    if not by_name:
        return {}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {"profile_wall_ms_per_forward": wall_ms / runs,
           "profile_device_ms_per_forward": busy / runs,
           "profile_busy_share": busy / wall_ms,
           "profile_top_kernels_ms_per_forward":
               {k: v / runs for k, v in top}}
    if ranges:
        out["profile_family_device_ms_per_forward"] = {
            label: ms / runs for label, ms in families.items()}
    log(f"[profile] {json.dumps(out)}")
    return out


def winograd_1d_family(net, nids, record, params) -> dict:
    """The plain-PyTorch `winograd_1d` layers `nids` of `net` as a family,
    each on the input it received in a recorded forward (drive): per call
    and device ms of the plan's apply (transform einsums, the channel
    GEMM, the epilogue) against cuDNN's F.conv2d with the layer's own
    weights, bias and activation at the same shape, summed. Each layer is
    held against that cuDNN conv at TOL_NET_DIRECT (fp32, TF32 off)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import im2col
    from repro_torch.kernels.runtime import apply_activation
    out = {"layers": len(nids), "ms": 0.0, "device_ms": 0.0,
           "cudnn_ms": 0.0, "cudnn_device_ms": 0.0, "max_rel_err": 0.0,
           "by_filter": {}}
    for nid in nids:
        plan = net.plans[nid]
        (xl,), kwargs, _ = record[nid]
        s = plan.spec
        kh, kw_ = s.w_shape[:2]
        g = im2col.im2row_geometry(s.x_shape[1], s.x_shape[2], kh, kw_,
                                   s.stride, s.padding)
        w_lib = params[nid]["w"].permute(3, 2, 0, 1)
        xc = xl.permute(0, 3, 1, 2)

        def cudnn():
            xin, pad = pad_for_conv(xc, g.ph, g.pw)
            return apply_activation(F.conv2d(xin, w_lib, kwargs["bias"],
                                             padding=pad),
                                    kwargs["activation"])

        def port():
            return plan.apply(xl, **kwargs)
        err = rel_err(port(), cudnn().permute(0, 2, 3, 1))
        torch.cuda.synchronize()
        if err > TOL_NET_DIRECT:
            raise AssertionError(f"winograd_1d {nid}: {err:.3e} from cuDNN's "
                                 f"conv (> {TOL_NET_DIRECT})")
        row = {"ms": cuda_ms(port, 10), "device_ms": graph_ms(port, reps=5),
               "cudnn_ms": cuda_ms(cudnn, 10),
               "cudnn_device_ms": graph_ms(cudnn, reps=5)}
        for k, v in row.items():
            out[k] += v
        key = f"{kh}x{kw_} F({s.output_tile[0]},{max(kh, kw_)})"
        fam = out["by_filter"].setdefault(key, {"layers": 0, **{
            k: 0.0 for k in row}})
        fam["layers"] += 1
        for k, v in row.items():
            fam[k] += v
        out["max_rel_err"] = max(out["max_rel_err"], err)
    log(f"[timing] inception_v3 winograd_1d family, batch "
        f"{record[nids[0]][0][0].shape[0]}: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# the sequence kernels and path C / path D helpers
# ---------------------------------------------------------------------------

def scan_inputs(b, length, d, n, x_dtype, bc_dtype, gen, dev):
    """Random selective-scan operands in the reference tests' ranges: dt
    in [0.001, 0.101), A = -exp(normal)."""
    import torch
    dt = (0.001 + 0.1 * torch.rand(b, length, d, generator=gen,
                                   device=dev)).to(x_dtype)
    xs = torch.randn(b, length, d, generator=gen, device=dev).to(x_dtype)
    bmat = torch.randn(b, length, n, generator=gen, device=dev).to(bc_dtype)
    cmat = torch.randn(b, length, n, generator=gen, device=dev).to(bc_dtype)
    a_mat = -torch.exp(torch.randn(d, n, generator=gen, device=dev))
    return dt, xs, bmat, cmat, a_mat


def compare_outputs(label: str, got, want, tol: float) -> tuple[float, float]:
    """Tuples of outputs (the kernel's, its plain version's), each held to
    `tol` (relative max-abs); returns the largest relative and absolute
    errors."""
    import torch
    errs = []
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{label}: bad output {tuple(g.shape)}")
        errs.append((rel_err(g.float(), w.float()),
                     float((g.float() - w.float()).abs().max())))
    err, abs_err = max(e[0] for e in errs), max(e[1] for e in errs)
    if err > tol:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version ({err:.3e} > {tol})")
    return err, abs_err


def scan_exact(args, chunk: int = 256):
    """selective_scan's plain version on `args` run in float64 (its
    `.float()` casts made no-ops, as double_plain does): the kernel's
    oracle."""
    from repro_torch.kernels import selective_scan as ks
    with double_plain():
        return ks.selective_scan_plain(*(t.double() for t in args),
                                       chunk=chunk)


def scan_errors(label: str, got, args, chunk: int = 256
                ) -> tuple[float, float, float, float]:
    """(rel err against the float64 plain version, gated at TOL_SCAN; its
    absolute max; rel err against the fp32 plain version; the fp32 plain
    version's own rel err against float64; the last two reported) of the
    kernel's (y, h_last) on `args`."""
    from repro_torch.kernels import selective_scan as ks
    exact = scan_exact(args, chunk)
    err, abs_err = compare_outputs(label, [g.double() for g in got], exact,
                                   TOL_SCAN)
    want = ks.selective_scan_plain(*args, chunk=chunk)
    return (err, abs_err, max(rel_err(g, w) for g, w in zip(got, want)),
            max(rel_err(w.double(), e) for w, e in zip(want, exact)))


def scan_bound(b, length, d, n, x_size, bc_size) -> tuple[float, str]:
    """(bound_ms, bound_by) of one selective_scan: bytes of dt, xs (x_size
    each), B, C (bc_size), A and of y, h_last (fp32), once each, at the
    memory rate; the B*L*D*N decays (one exponential per state update) at
    PEAK_SFU_OPS; the other operations at the fp32 rate, per state update
    the exponent's product (1), the decay FMA (2), dt*x*B (1) and the C
    FMA (2), plus dt*x per (b, l, d). The two units run side by side.
    bound_by is "sfu", "operations" (the fp32 FLOPs) or "bytes", whichever
    takes longest."""
    nbytes = (2 * x_size * b * length * d + 2 * bc_size * b * length * n
              + 4 * d * n + 4 * b * length * d + 4 * b * d * n)
    updates = b * length * d * n
    times = {"sfu": updates / PEAK_SFU_OPS,
             "operations": (6 * updates + b * length * d) / PEAK_FP32_FLOPS,
             "bytes": nbytes / PEAK_BYTES}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def conv1d_bound(b, s, c, ct, x_size, u_size) -> tuple[float, str]:
    """(bound_ms, bound_by) of one conv1d_ct_fused: the real tiles
    (B, S, t, C), taps (t, C) and outputs (B, S, m, C), once each, at the
    memory rate; the dense B^T (t x t) and A^T (m x t) products and the
    Hadamard product at the fp32 rate."""
    nbytes = (x_size * b * s * c * (ct.t + ct.m) + u_size * ct.t * c)
    flops = b * s * c * (2 * ct.t * ct.t + ct.t + 2 * ct.m * ct.t)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def tree_leaves(tree) -> list:
    """The tensors of a nested dict of params."""
    return [leaf for v in tree.values()
            for leaf in (tree_leaves(v) if isinstance(v, dict) else [v])]


def cast_like_init(params, dtype):
    """The same weights cast to `dtype`, but the leaves the reference's
    init keeps in fp32 whatever its dtype (FP32_LEAVES)."""
    return {k: (cast_like_init(v, dtype) if isinstance(v, dict)
                else v if k in FP32_LEAVES else v.to(dtype))
            for k, v in params.items()}


@contextlib.contextmanager
def scan_checked(errors: list, record: dict | None = None):
    """Every selective_scan call runs the kernel and then its plain version
    on the same inputs, in float64 (gated) and in fp32 (reported), keeping
    only the errors (scan_errors) in `errors`; no layer's inputs are kept,
    but the first call's go to `record`."""
    import torch
    from repro_torch.kernels import selective_scan as ks
    kernel = ks.selective_scan

    def run(dt, xs, bmat, cmat, a_mat, *, chunk=256):
        y, h = kernel(dt, xs, bmat, cmat, a_mat, chunk=chunk)
        torch.cuda.synchronize()
        errors.append(scan_errors(f"selective_scan layer {len(errors)}",
                                  (y, h), (dt, xs, bmat, cmat, a_mat),
                                  chunk))
        if record is not None and "scan" not in record:
            record["scan"] = (dt, xs, bmat, cmat, a_mat)
        return y, h

    # the wrapper counts its launch on the module's `selective_scan`, which
    # is `run` while this context is active: those counts go back to the
    # wrapper on exit
    run.LAUNCHES = 0
    ks.selective_scan = run
    try:
        yield
    finally:
        ks.selective_scan = kernel
        kernel.LAUNCHES += run.LAUNCHES


@contextlib.contextmanager
def conv_recorded(record: dict):
    """The first short-conv plan apply keeps its input in `record`."""
    from repro_torch.core import plan as pt_plan
    cls = pt_plan.DepthwiseConv1DPlan
    apply = cls.apply

    def run(self, x):
        record.setdefault("conv", x.clone())
        return apply(self, x)

    cls.apply = run
    try:
        yield
    finally:
        cls.apply = apply


def profile_device(fn, runs: int = 3, families: dict | None = None,
                   warm: bool = True) -> tuple[dict, float]:
    """Device milliseconds by kernel name over `runs` warm calls of fn
    (after one call outside the trace; `warm=False`: none), from a
    torch.profiler trace, and the host wall milliseconds. Empty when the
    trace holds no device events. `families`, a dict, receives the device
    milliseconds of the kernels launched inside each record_function range
    (by its name) that fn opens."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict[str, float] = {}
    families = {} if families is None else families
    for e in prof.events():
        if e.name in families:
            # the range on the host: the kernels launched inside it (the
            # range's own span on the device is not a kernel)
            if e.device_type == DeviceType.CPU:
                families[e.name] += getattr(e, "device_time_total",
                                            0.0) / 1e3
        elif e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    if not by_name:
        log("[profile] the trace holds no device events: device time not "
            "measured")
    return by_name, wall_ms


# ---------------------------------------------------------------------------
# phase 5: the serving runtime
# ---------------------------------------------------------------------------

#: MobileNet-v2 at 224 behind repro_torch.runtime.serve.Server: its
#: buckets and the bursts its 64 requests arrive in (each burst is
#: answered before the next is sent).
SERVE_BUCKETS = (1, 2, 4, 8)
SERVE_BURSTS = (1, 3, 8, 16, 1, 3, 8, 16, 8)
#: The fault drill's buckets and the layer its faults hit: an inverted
#: residual block whose depthwise + project pair is the fused
#: separable_streamed kernel (im2col+separable_streamed).
DRILL_BUCKETS = (1, 4)
DRILL_LAYER = "ir3"
#: Forwards per bucket at a server's start: its supervised warm-up batch,
#: then the warm-up run on the capture stream and the capture itself.
WARMUP_FORWARDS = 3


def host_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median host milliseconds of one fn() call that ends synchronized
    with the device."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def serve_phase(dev, params: dict, nets: dict, res: dict, fp32_b4: dict
                ) -> tuple[dict, dict]:
    """Phase 5 (module docstring): (a) traffic, (b) graph against eager,
    (c) the fault drill, (d) the precision probe, each network at its
    resolution in `res` and `fp32_b4` the fp32 networks at batch 4.
    Returns the report and the launch counts of each traffic run, by path;
    raises on any gate."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import compile as pt_compile
    from repro_torch.core import plan as pt_plan
    from repro_torch.runtime import inject
    from repro_torch.runtime.serve import QueueFullError, ServeConfig, Server

    name = "mobilenet_v2"
    r = res[name]
    rng = np.random.default_rng(20)
    images = [rng.standard_normal((r, r, 3)).astype(np.float32)
              for _ in range(sum(SERVE_BURSTS))]
    report: dict[str, Any] = {}
    counts_by_path: dict[str, dict] = {}

    def config(buckets, **kw):
        base = dict(buckets=buckets, queue_capacity=64, verbose=False,
                    probation_batches=0)
        base.update(kw)
        return ServeConfig(**base)

    def mbv2(buckets, artifact_dir, **kw):
        return Server(params[name], nets[name], res=r,
                      algorithm="pallas_winograd",
                      config=config(buckets, **kw),
                      artifact_dir=artifact_dir, device=dev)

    def eager_b1(srv, x):
        with torch.inference_mode():
            y = srv.nets[1].apply(torch.from_numpy(x[None]).to(dev))
        return y[0].cpu().numpy()

    def np_rel(a, b):
        return float(np.abs(a - b).max() / max(float(np.abs(b).max()),
                                               1e-30))

    def gate(label, ok, detail):
        if not ok:
            raise AssertionError(f"[serve] {label}: {detail}")

    def served(srv, xs):
        """Warm-started server, warmup done: admit every request before the
        scheduler starts (batches form deterministically), serve, stop."""
        tickets = [srv.submit(x) for x in xs]
        srv.start(warmup=False)
        try:
            return [t.result(timeout=300) for t in tickets]
        finally:
            srv.stop()

    with tempfile.TemporaryDirectory() as adir:
        # ---- (a) traffic ---------------------------------------------------
        t0 = time.perf_counter()
        cold = mbv2(SERVE_BUCKETS, adir)
        cold_s = time.perf_counter() - t0
        files = sorted(os.listdir(adir))
        gate("cold start", cold.stats.artifact_cold_starts == 4
             and files == [f"plan_b{b}.npz" for b in sorted(
                 SERVE_BUCKETS, key=str)], (cold.stats.snapshot(), files))
        del cold
        transforms = []
        saved = {f: getattr(pt_plan, f)
                 for f in ("_domain_filter", "_depthwise_domain_taps")}

        def counting(f):
            def run(*a, **k):
                transforms.append(f)
                return saved[f](*a, **k)
            return run

        for f in saved:
            setattr(pt_plan, f, counting(f))
        try:
            t0 = time.perf_counter()
            srv = mbv2(SERVE_BUCKETS, adir)
            warm_s = time.perf_counter() - t0
        finally:
            for f, fn in saved.items():
                setattr(pt_plan, f, fn)
        gate("warm start", srv.stats.artifact_warm_starts == 4
             and not transforms, (srv.stats.snapshot(), transforms))
        log(f"[serve] {name} buckets {SERVE_BUCKETS}: cold start (compile + "
            f"save 4 artifacts) {cold_s:.2f} s, warm start from them "
            f"{warm_s:.2f} s with 0 filter transforms")
        reset_counts()
        t0 = time.perf_counter()
        srv.start()             # warmup: a supervised batch + the capture
        start_s = time.perf_counter() - t0
        after_warmup = read_counts()
        want = {k: WARMUP_FORWARDS * len(SERVE_BUCKETS)
                * EXPECTED[name].get(k, 0) for k in KERNELS}
        gate("warmup launches", after_warmup == want, (after_warmup, want))
        tickets, i = [], 0
        t0 = time.perf_counter()
        try:
            for burst in SERVE_BURSTS:
                batch = [srv.submit(images[i + j]) for j in range(burst)]
                i += burst
                for t in batch:
                    t.result(timeout=300)
                tickets += batch
            wall = time.perf_counter() - t0
        finally:
            srv.stop()
        counts = read_counts()
        counts_by_path[f"serve {name} (warmup and traffic)"] = counts
        s = srv.stats.snapshot()
        gate("replays launch nothing", counts == after_warmup,
             (counts, after_warmup))
        gate("tickets", all(t.status == "ok" for t in tickets),
             [t.status for t in tickets])
        gate("stats", s["failed"] == 0 and s["executor_failures"] == 0
             and s["jit_fallbacks"] == 0
             and s["jit_dispatches"] == s["batches"]
             and s["completed"] == len(images) and s["in_flight"] == 0, s)
        errs = [np_rel(t.result(), eager_b1(srv, x))
                for t, x in zip(tickets, images)]
        gate("answers", max(errs) <= TOL_NET_PLAIN, max(errs))
        lat = np.array([t.latency_s for t in tickets]) * 1e3
        report["traffic"] = {
            "requests": len(tickets), "bursts": list(SERVE_BURSTS),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "requests_per_s": len(tickets) / wall, "wall_s": wall,
            "batches": s["batches"], "bucket_batches": s["bucket_batches"],
            "jit_dispatches": s["jit_dispatches"],
            "max_rel_err_vs_eager_bucket1": max(errs),
            "cold_start_s": cold_s, "warm_start_s": warm_s,
            "start_with_capture_s": start_s,
            "launches_warmup_and_captures": {k: v for k, v in
                                             after_warmup.items() if v}}
        log(f"[serve] traffic: {json.dumps(report['traffic'])}")

        # ---- (b) graph dispatch against the eager supervised path ---------
        timing = {}

        def time_server(label, srv, b, x):
            net = srv.nets[b]
            y_graph = srv._jitted_apply(b, x)
            with torch.inference_mode():
                y_eager = net.apply(x)
            e = rel_err(y_graph, y_eager)
            gate(f"{label} graph vs eager", e <= TOL_NET_PLAIN, e)
            row = {
                "graph_ms": host_ms(lambda: (srv._jitted_apply(b, x),
                                             srv._sync()), 20),
                "eager_supervised_ms": host_ms(
                    lambda: srv._supervised_apply(b, x), 10),
                "eager_apply_ms": cuda_ms(lambda: net.apply(x), 10),
                "device_ms": graph_ms(lambda: net.apply(x), reps=3),
                "graph_vs_eager_rel_err": e}
            timing[label] = row
            log(f"[serve] {label}: graph dispatch {row['graph_ms']:.3f} ms "
                f"per batch, eager supervised {row['eager_supervised_ms']:.3f}"
                f", eager apply {row['eager_apply_ms']:.3f}, device "
                f"{row['device_ms']:.3f}")

        for b in SERVE_BUCKETS:
            x = torch.from_numpy(np.stack(images[:b])).to(dev)
            time_server(f"{name} bucket {b}", srv, b, x)
        del srv
        r_inc = res["inception_v3"]
        inc = Server(params["inception_v3"], nets["inception_v3"],
                     res=r_inc, algorithm="pallas_winograd",
                     config=config((4,)), device=dev)
        inc.warmup()
        x = torch.from_numpy(rng.standard_normal(
            (4, r_inc, r_inc, 3)).astype(np.float32)).to(dev)
        time_server("inception_v3 bucket 4", inc, 4, x)
        del inc, x
        report["graph_vs_eager"] = timing

    # ---- (c) the fault drill ------------------------------------------------
    drill: dict[str, Any] = {}
    with tempfile.TemporaryDirectory() as ddir:
        base = mbv2(DRILL_BUCKETS, ddir)
        base.warmup()
        clean = served(base, images[:5])        # a 4-batch, then a 1-batch
        del base

        def drilled(label, fault=None, n=5, **kw):
            srv = mbv2(DRILL_BUCKETS, ddir, **kw)
            gate(f"{label} warm start", srv.stats.artifact_warm_starts == 2,
                 srv.stats.snapshot())
            srv.warmup()
            if fault is not None:
                inject.install_on_server(srv, fault)
            ys = served(srv, images[:n])
            e = max(np_rel(y, c) for y, c in zip(ys, clean))
            s = srv.stats.snapshot()
            gate(f"{label} answers", e <= TOL_NET_PLAIN
                 and s["failed"] == 0 and s["in_flight"] == 0, (e, s))
            drill[label] = {k: s[k] for k in (
                "batches", "retries", "executor_failures", "replacements",
                "recompiles", "jit_fallbacks", "jit_dispatches",
                "corrupt_artifacts", "corrupt_arrays", "evictions",
                "stragglers", "rejected")}
            drill[label]["max_rel_err_vs_unfaulted"] = e
            log(f"[serve] drill {label}: {json.dumps(drill[label])}")
            return srv, s

        _, s = drilled("transient", inject.ExecutorRaise(DRILL_LAYER,
                                                         times=1), n=4)
        gate("transient", s["retries"] == 1 and s["jit_fallbacks"] == 1
             and s["replacements"] == 0, s)
        # permanent from its second call: the warm-up before the capture
        # passes, the capture itself raises
        srv, s = drilled("permanent, raising inside the capture",
                         inject.ExecutorRaise(DRILL_LAYER, after=1))
        executors = {b: srv.nets[b].plans[DRILL_LAYER].describe()["executor"]
                     for b in DRILL_BUCKETS}
        drill["permanent, raising inside the capture"]["executors"] = \
            executors
        gate("permanent", s["jit_fallbacks"] == 1 and s["replacements"] == 1
             and s["retries"] == 3 and s["jit_dispatches"] == 1
             and not torch.cuda.is_current_stream_capturing()
             and all(set(e.split("+")) == {"im2col"}
                     for e in executors.values()), (s, executors))
        del srv
        path = os.path.join(ddir, "plan_b4.npz")
        flipped = inject.flip_bit(path)
        srv = mbv2(DRILL_BUCKETS, ddir)
        s = srv.stats.snapshot()
        gate("corrupt artifact", s["corrupt_artifacts"] == 1
             and s["corrupt_arrays"] >= 1 and s["artifact_cold_starts"] == 1
             and s["artifact_warm_starts"] == 1
             and pt_compile.verify_artifact(path) == [], s)
        srv.warmup()
        e = max(np_rel(y, c) for y, c in zip(served(srv, images[:5]), clean))
        gate("corrupt artifact answers", e <= TOL_NET_PLAIN, e)
        drill["corrupt artifact"] = {"flipped": flipped, **{
            k: s[k] for k in ("corrupt_artifacts", "corrupt_arrays",
                              "artifact_cold_starts",
                              "artifact_warm_starts")},
            "max_rel_err_vs_unfaulted": e}
        log(f"[serve] drill corrupt artifact: "
            f"{json.dumps(drill['corrupt artifact'])}")
        del srv
        srv = mbv2(DRILL_BUCKETS, ddir, queue_capacity=8)
        accepted, retry_after = [], []
        for x in images[:13]:
            try:
                accepted.append(srv.submit(x))
            except QueueFullError as err:
                retry_after.append(err.retry_after_s)
        srv.start()
        try:
            ys = [t.result(timeout=300) for t in accepted]
        finally:
            srv.stop()
        s = srv.stats.snapshot()
        e = max(np_rel(y, eager_b1(srv, x)) for y, x in zip(ys, images))
        gate("queue full", len(accepted) == 8 and len(retry_after) == 5
             and min(retry_after) > 0 and s["completed"] == 8
             and s["rejected"] == 5 and s["in_flight"] == 0
             and e <= TOL_NET_PLAIN, (s, retry_after, e))
        drill["queue full"] = {"accepted": 8, "rejected": s["rejected"],
                               "retry_after_s": retry_after,
                               "max_rel_err_vs_eager_bucket1": e}
        log(f"[serve] drill queue full: {json.dumps(drill['queue full'])}")
        del srv
        srv = mbv2(DRILL_BUCKETS, ddir, jit_dispatch=False,
                   straggler_window=16, straggler_min_baseline=5,
                   straggler_evict_after=2, batch_wait_s=0.0)
        srv.start()
        try:
            for x in images[:8]:                 # the baseline
                srv.submit(x).result(timeout=300)
            inject.install_on_server(srv, inject.LatencySpike(
                DRILL_LAYER, delay_s=0.2))
            for x in images[8:14]:
                srv.submit(x).result(timeout=300)
        finally:
            srv.stop()
        s = srv.stats.snapshot()
        executors = {b: srv.nets[b].plans[DRILL_LAYER].describe()["executor"]
                     for b in DRILL_BUCKETS}
        gate("straggler", s["evictions"] == 1 and s["stragglers"] >= 2
             and s["failed"] == 0
             and all(set(e.split("+")) == {"im2col"}
                     for e in executors.values()), (s, executors))
        drill["latency spike"] = {k: s[k] for k in (
            "batches", "stragglers", "evictions", "replacements")}
        drill["latency spike"]["executors"] = executors
        log(f"[serve] drill latency spike: "
            f"{json.dumps(drill['latency spike'])}")
        del srv
    report["drill"] = drill

    # ---- (d) the precision probe: GoogleNet int8 ---------------------------
    g = Server(params["googlenet"], nets["googlenet"],
               res=res["googlenet"], algorithm="pallas_winograd",
               compute_dtype="int8",
               config=config((1, 4), precision_probe=False), device=dev)
    rg = res["googlenet"]
    x4 = rng.standard_normal((4, rg, rg, 3)).astype(np.float32)
    with torch.inference_mode():
        y_unprobed = g.nets[4].apply(torch.from_numpy(x4).to(dev))
        y32 = fp32_b4["googlenet"].apply(torch.from_numpy(x4).to(dev))
    first = g.probe_precision()
    second = g.probe_precision()
    for nid, row in first.items():
        log(f"[serve] probe googlenet int8 {nid}: {row['compute_dtype']} "
            f"rel_err {row['rel_err']:.3e} budget {row['budget']:g} "
            f"promoted {row['promoted']}")
    gate("second probe promotes nothing",
         not any(r["promoted"] for r in second.values()), second)
    reset_counts()
    g.start()
    try:
        ys = [t.result(timeout=300) for t in [g.submit(x) for x in x4]]
    finally:
        g.stop()
    counts = read_counts()
    counts_by_path["serve googlenet int8 (warmup and traffic)"] = counts
    gate("googlenet launches", all(counts[k] > 0 for k in
                                   EXPECTED_REDUCED["googlenet"]), counts)
    served_y = torch.from_numpy(np.stack(ys)).to(dev)
    s = g.stats.snapshot()
    report["probe"] = {
        "layers": len(first),
        "promoted": sorted(k for k, r in first.items() if r["promoted"]),
        "rel_err": {k: r["rel_err"] for k, r in first.items()},
        "budget": next(iter(first.values()))["budget"] if first else None,
        "second_probe_promoted": sum(r["promoted"] for r in second.values()),
        "precision_promotions": s["precision_promotions"],
        "served_logits_vs_fp32": rel_err(served_y, y32),
        "unprobed_int8_logits_vs_fp32": rel_err(y_unprobed, y32),
        "served_top1_vs_fp32": int((served_y.argmax(1)
                                    == y32.argmax(1)).sum()),
        "failed": s["failed"]}
    gate("googlenet served", s["failed"] == 0 and s["completed"] == 4,
         s)
    log(f"[serve] probe: {json.dumps(report['probe'])}")
    del g
    return report, counts_by_path


# ---------------------------------------------------------------------------
# phase 6: the measured auto_tuned planner
# ---------------------------------------------------------------------------

#: The networks compiled with algorithm="auto_tuned" (full width, their own
#: resolution, batch MAIN_BATCH).
AUTOTUNE_NETS = ("vgg16", "googlenet")
#: A raced plan on its recorded input against F.conv2d in float64, relative
#: max-abs error: the fp32 plain executors (`winograd` up to F(4, 3) /
#: F(2, 7), `fft`, `im2col`) read up to 1.9e-5 at C = 512; `winograd_f63`
#: is held to its declared budget (transforms.F63_FP32_ERROR_BUDGET).
TOL_AUTOTUNE = 2e-5
#: The compute_dtype="auto" races of (c): VGG-16's conv1_2 and conv5_3 (the
#: node ids count from 0), beside every 5x5 layer of GoogleNet.
AUTO_DTYPE_VGG = ("conv1_1", "conv5_2")
#: ResNeXt-50 32x4d's stage-1 grouped conv: NHWC input, HWIO filter, groups.
RESNEXT_STAGE1 = ((MAIN_BATCH, 56, 56, 128), (3, 3, 4, 128), 32)


def conv_f64(x, w, spec):
    """One conv layer in float64 through F.conv2d, NHWC in and out, at the
    plan spec's stride, padding (the reference's SAME pads) and groups."""
    import torch.nn.functional as F
    from repro_torch.core.im2col import _same_pads
    xc = x.double().permute(0, 3, 1, 2)
    kh, kw = w.shape[:2]
    pad = 0
    if spec.padding == "SAME":
        xc, pad = pad_for_conv(
            xc, _same_pads(xc.shape[2], kh, spec.stride[0]),
            _same_pads(xc.shape[3], kw, spec.stride[1]))
    y = F.conv2d(xc, w.double().permute(3, 2, 0, 1), stride=spec.stride,
                 padding=pad, groups=spec.groups)
    return y.permute(0, 2, 3, 1)


def autotune_phase(dev, params: dict, nets: dict, res: dict,
                   fp32_b4: dict, randn) -> tuple[dict, dict]:
    """Phase 6 (module docstring): (a) VGG-16 and (b) GoogleNet through
    compile(..., algorithm="auto_tuned"), each raced plan held on its
    recorded input against float64 F.conv2d and the logits against the
    cuDNN network; (c) compute_dtype="auto" races; (d) the spec cache and
    an artifact warm start; (e) ResNeXt's grouped conv; (f) device times.
    `fp32_b4` are the pallas_winograd networks at batch 4. Returns the
    report, the launch counts of the two networks' runs (none: every
    contender is plain PyTorch) and the two auto_tuned networks; raises on
    any gate."""
    import tempfile

    import torch

    from repro_torch.core import compile as pt_compile
    from repro_torch.core import plan as pt_plan
    from repro_torch.core.transforms import F63_FP32_ERROR_BUDGET

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def gate(label, ok, detail):
        if not ok:
            raise AssertionError(f"[autotune] {label}: {detail}")

    def weight(name, net, nid):
        node = next(n for n in net.graph if n.id == nid)
        return pt_compile._param(params[name], node.attrs["w_path"])

    def evidence_ms(plan):
        return {k[2:-2]: v * 1e3 for k, v in plan.spec.autotune or ()
                if k.startswith("t_")}

    report: dict[str, Any] = {}
    counts_by_path: dict[str, dict] = {}
    auto_nets, images = {}, {}
    pt_plan.clear_plan_cache()
    # ---- (a) VGG-16 and (b) GoogleNet: compile, hold, logits --------------
    for name in AUTOTUNE_NETS:
        t0 = time.perf_counter()
        net = pt_compile.compile(params[name], nets[name], res=res[name],
                                 batch=MAIN_BATCH, algorithm="auto_tuned",
                                 device=dev)
        sync()
        compile_s = time.perf_counter() - t0
        info = pt_plan.plan_cache_info()
        log(f"[autotune] compiled {name} auto_tuned batch {MAIN_BATCH} at "
            f"{res[name]} in {compile_s:.2f} s; plan_cache_info "
            f"{json.dumps(info)}")
        x = randn(MAIN_BATCH, res[name], res[name], 3)
        record, ran = {}, []
        for nid, plan in net.plans.items():
            def recorded(*args, _nid=nid, _apply=plan.apply, **kwargs):
                record.setdefault(_nid, args[0])
                return _apply(*args, **kwargs)
            plan.apply = recorded
        reset_counts()
        try:
            y = net.apply(x, layer_hook=lambda nid, s: ran.append(nid))
        finally:
            for plan in net.plans.values():
                del plan.apply
        sync()
        counts = read_counts()
        counts_by_path[f"{name} auto_tuned batch {MAIN_BATCH}"] = counts
        gate(f"{name} runs no kernel", not any(counts.values()), counts)
        gate(f"{name} every plan ran once", sorted(ran) == sorted(net.plans)
             == sorted(record), (len(ran), len(net.plans)))
        gate(f"{name} logits", tuple(y.shape) == (MAIN_BATCH, 1000)
             and bool(torch.isfinite(y).all()), tuple(y.shape))
        layers = []
        for nid, plan in net.plans.items():
            d = plan.describe()
            w = weight(name, net, nid)
            with torch.no_grad():
                got = plan.apply(record[nid])
            want = conv_f64(record[nid], w, plan.spec)
            err = rel_err(got.double(), want)
            tol = (F63_FP32_ERROR_BUDGET if plan.algorithm == "winograd_f63"
                   else TOL_AUTOTUNE)
            row = {"layer": nid, "x_shape": list(plan.spec.x_shape),
                   "w_shape": list(plan.spec.w_shape),
                   "stride": list(plan.spec.stride),
                   "decision": d["decision"], "executor": plan.algorithm,
                   "tile": d["tile"],
                   "winner_label": (plan.spec.autotune_report or {}).get(
                       "winner_label"),
                   "t_ms": evidence_ms(plan),
                   "plan_s": plan.build_time_s,
                   "max_rel_err_vs_f64": err, "tol": tol}
            layers.append(row)
            log(f"[autotune] {name}.{nid} {tuple(plan.spec.x_shape)} "
                f"{d['filter']}/{d['stride']}: {d['decision']} -> "
                f"{plan.algorithm} tile {d['tile']} (label "
                f"{row['winner_label']}); race ms "
                f"{json.dumps({k: round(v, 4) for k, v in row['t_ms'].items()})}"
                f"; planned in {plan.build_time_s:.3f} s; rel err vs float64 "
                f"F.conv2d {err:.2e} (tol {tol:g})")
            gate(f"{name}.{nid} vs float64", err <= tol, err)
            gate(f"{name}.{nid} decision", d["decision"] == (
                "measured" if plan.spec.w_shape[:2] != (1, 1)
                else "heuristic"), d)
        # the contenders each filter size fields
        for row in layers:
            k, s = row["w_shape"][0], row["stride"][0]
            want = {(3, 1): {"winograd", "winograd_f2", "f63", "fft",
                             "im2col"},
                    (5, 1): {"winograd", "fft", "im2col"},
                    (7, 2): {"winograd", "im2col"}}.get((k, s))
            if want is not None:
                gate(f"{name}.{row['layer']} contenders",
                     set(row["t_ms"]) == want, sorted(row["t_ms"]))
        y_direct = direct_forward(params[name], nets[name], x)
        y_pallas = fp32_b4[name].apply(x)
        sync()
        report[name] = {
            "compile_s": compile_s, "plan_cache_info": info,
            "winners": {e: sum(r["executor"] == e for r in layers)
                        for e in sorted({r["executor"] for r in layers})},
            "logits_vs_cudnn_network": rel_err(y, y_direct),
            "logits_vs_pallas_winograd_network": rel_err(y, y_pallas),
            "layers": layers}
        log(f"[autotune] {name} winners {json.dumps(report[name]['winners'])}"
            f"; logits rel err vs the cuDNN network "
            f"{report[name]['logits_vs_cudnn_network']:.3e}, vs the "
            f"pallas_winograd network "
            f"{report[name]['logits_vs_pallas_winograd_network']:.3e}")
        auto_nets[name], images[name] = net, x

    # ---- (c) compute_dtype="auto" ------------------------------------------
    vgg, goog = auto_nets["vgg16"], auto_nets["googlenet"]
    dtype_layers = [("vgg16", vgg, nid) for nid in AUTO_DTYPE_VGG] + [
        ("googlenet", goog, nid) for nid, p in goog.plans.items()
        if p.spec.w_shape[:2] == (5, 5)]
    gate("nine 5x5 GoogleNet layers", len(dtype_layers) == 11,
         len(dtype_layers))
    auto_rows = []
    for name, net, nid in dtype_layers:
        plan = pt_plan.plan_conv2d(
            net.plans[nid].spec.x_shape, weight(name, net, nid),
            algorithm="auto_tuned", compute_dtype="auto", device=dev)
        rep = plan.spec.autotune_report
        wd = rep["winner_dtype"]
        row = {"layer": f"{name}.{nid}", "winner": rep["winner"],
               "winner_label": rep["winner_label"], "winner_dtype": wd,
               "tile": plan.describe()["tile"],
               "err_winograd_bf16": rep.get("err_winograd_bf16"),
               "err_winograd_int8": rep.get("err_winograd_int8"),
               "t_ms": evidence_ms(plan)}
        auto_rows.append(row)
        log(f"[autotune] compute_dtype=auto {row['layer']}: "
            f"{json.dumps(row)}")
        gate(f"{row['layer']} winner within budget", wd == "float32"
             or rep[f"err_{rep['winner_label']}"]
             <= pt_plan.AUTOTUNE_ACCURACY_BUDGET[wd], row)
        gate(f"{row['layer']} plan dtype", plan.spec.compute_dtype == wd,
             plan.spec.compute_dtype)
    report["compute_dtype_auto"] = auto_rows

    # ---- (d) the spec cache and the warm start ----------------------------
    before = pt_plan.plan_cache_info()
    t0 = time.perf_counter()
    again = pt_compile.compile(params["vgg16"], nets["vgg16"],
                               res=res["vgg16"], batch=MAIN_BATCH,
                               algorithm="auto_tuned", device=dev)
    sync()
    warm_compile_s = time.perf_counter() - t0
    after = pt_plan.plan_cache_info()
    gate("second compile: 13 spec-cache hits, nothing measured",
         after["hits"] - before["hits"] == 13
         and after["measured"] == before["measured"], (before, after))
    gate("second compile: the same plans",
         {n: (p.describe(), p.spec.autotune) for n, p in again.plans.items()}
         == {n: (p.describe(), p.spec.autotune)
             for n, p in vgg.plans.items()}, "describe or evidence differ")
    del again
    with tempfile.TemporaryDirectory() as tdir:
        path = f"{tdir}/vgg16_auto_tuned.npz"
        vgg.save(path)
        before = pt_plan.plan_cache_info()
        t0 = time.perf_counter()
        loaded = pt_compile.NetworkPlan.load(path, device=dev)
        sync()
        load_s = time.perf_counter() - t0
        after = pt_plan.plan_cache_info()
        verified = pt_compile.verify_artifact(path)
    gate("warm load measures nothing", after["measured"] == before["measured"]
         and after["artifact_hits"] == before["artifact_hits"] + 1
         and verified == [], (before, after, verified))
    gate("warm load describes alike, evidence included",
         {n: (p.describe(), p.spec.autotune) for n, p in loaded.plans.items()}
         == {n: (p.describe(), p.spec.autotune)
             for n, p in vgg.plans.items()}, "describe or evidence differ")
    e_load = rel_err(loaded.apply(images["vgg16"]),
                     vgg.apply(images["vgg16"]))
    gate("warm load answers", e_load == 0.0, e_load)
    del loaded
    report["cache_and_warm_start"] = {
        "second_compile_s": warm_compile_s, "load_s": load_s,
        "plan_cache_info": after}
    log(f"[autotune] second compile of vgg16 {warm_compile_s:.2f} s (13 "
        f"spec-cache hits, nothing measured); save + load {load_s:.2f} s, "
        f"describe and evidence equal, logits bitwise equal")

    # ---- (e) ResNeXt-50's grouped stage-1 conv ----------------------------
    x_shape, w_shape, groups = RESNEXT_STAGE1
    xg = randn(*x_shape)
    wg = randn(*w_shape, scale=(9 * w_shape[2]) ** -0.5)
    grouped = {}
    for alg in ("winograd", "auto_tuned"):
        plan = pt_plan.plan_conv2d(x_shape, wg, groups=groups, algorithm=alg,
                                   device=dev)
        with torch.no_grad():
            err = rel_err(plan.apply(xg).double(),
                          conv_f64(xg, wg, plan.spec))
        grouped[alg] = {"executor": plan.algorithm,
                        "tile": plan.describe()["tile"],
                        "t_ms": evidence_ms(plan), "max_rel_err_vs_f64": err,
                        "device_ms": graph_ms(lambda: plan.apply(xg),
                                              reps=3, iters=5)}
        log(f"[autotune] resnext50 stage-1 grouped conv {x_shape} "
            f"groups {groups} {alg}: {json.dumps(grouped[alg])}")
        gate(f"grouped {alg}", err <= TOL_AUTOTUNE, err)
    gate("grouped winograd executor",
         grouped["winograd"]["executor"] == "winograd_grouped", grouped)
    xg_nchw, wg_oihw = xg.permute(0, 3, 1, 2), wg.permute(3, 2, 0, 1)
    grouped["cudnn_device_ms"] = graph_ms(
        lambda: torch.nn.functional.conv2d(xg_nchw, wg_oihw, padding=1,
                                           groups=groups), reps=3, iters=5)
    report["grouped"] = grouped

    # ---- (f) device times ---------------------------------------------------
    timing = {}
    for name in AUTOTUNE_NETS:
        x = images[name]
        row = {"auto_tuned_device_ms": graph_ms(
                   lambda: auto_nets[name].apply(x), reps=3),
               "pallas_winograd_device_ms": graph_ms(
                   lambda: fp32_b4[name].apply(x), reps=3),
               "cudnn_device_ms": graph_ms(
                   lambda: direct_forward(params[name], nets[name], x),
                   reps=3)}
        timing[name] = row
        log(f"[autotune] {name} batch {MAIN_BATCH} device ms: "
            f"{json.dumps(row)}")
        # every plain executor the race fields, per layer, on the device
        per_layer = {}
        for nid, plan in auto_nets[name].plans.items():
            if plan.spec.autotune is None:
                continue
            w = weight(name, auto_nets[name], nid)
            xin = randn(*plan.spec.x_shape)
            rows = {}
            for label in evidence_ms(plan):
                alg, tile = {"winograd_f2": ("winograd", 2),
                             "f63": ("winograd_f63", None)}.get(
                                 label, (label, None))
                p = pt_plan.plan_conv2d(
                    plan.spec.x_shape, w, stride=plan.spec.stride,
                    padding=plan.spec.padding, groups=plan.spec.groups,
                    algorithm=alg, output_tile=tile, device=dev)
                rows[label] = graph_ms(lambda: p.apply(xin), reps=3, iters=5)
            rows["cudnn"] = graph_ms(lambda: torch.nn.functional.conv2d(
                xin.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                stride=plan.spec.stride, padding=(
                    plan.spec.w_shape[0] // 2, plan.spec.w_shape[1] // 2)),
                reps=3, iters=5)
            per_layer[nid] = rows
            log(f"[autotune] {name}.{nid} device ms per executor: "
                f"{json.dumps({k: round(v, 4) for k, v in rows.items()})}")
        row["per_layer_device_ms"] = per_layer
    report["timing"] = timing
    return report, counts_by_path, auto_nets


# ---------------------------------------------------------------------------
# phase 7: the per-call API, the Whisper stem, the tuning DB, the profiler
# ---------------------------------------------------------------------------

#: The Whisper-tiny stem at full width (configs/whisper_tiny.py, d_model
#: 384, 80 mels): 30 s of audio at 100 frames/s, 3000 frames in, 1500 out
#: (the encoder's n_ctx).
STEM_BATCH, STEM_FRAMES, STEM_MELS = 4, 3000, 80
#: The executor of (conv1, conv2) per algorithm, as the JAX package's
#: describe() reads for the same compile (its stride-2 polyphase branch is
#: taken only under "winograd" / "auto").
STEM_TABLES = {"auto": ("winograd_1d", "polyphase[winograd_1d+im2col]"),
               "im2col": ("im2col", "im2col"),
               "pallas_winograd": ("winograd_1d", "im2col")}
#: The stem against F.conv1d + bias + GELU (tanh) in float64, relative
#: max-abs error: two fp32 convs over 240 and 1152 products per output
#: (F(4, 3) transforms, the polyphase F(4, 2) and 1x1 sums) and their
#: epilogues; fp32 reads about 1e-6 there.
TOL_STEM = 5e-5
#: The per-call stem and stem(plans=) against the compiled apply: the same
#: plans and arithmetic, the epilogue applied outside the plan.
TOL_STEM_PATHS = 1e-6
#: Launches per cnn_forward(algorithm="pallas_winograd") forward: the
#: separable blocks compose into a depthwise conv (depthwise_streamed at
#: stride 1 on fp32 taps, depthwise_strided_streamed at stride 2) and a 1x1
#: conv that pallas_winograd does not cover (im2col, torch.matmul).
EXPECTED_PER_CALL = {"vgg16": {"winograd_streamed": 13},
                     "mobilenet_v1": {"winograd_strided_streamed": 1,
                                      "depthwise_streamed": 9,
                                      "depthwise_strided_streamed": 4}}
#: (VGG-16 layer, NHWC input, output channels) of the per-call wrappers.
WRAPPER_LAYERS = (("conv3_1", (MAIN_BATCH, 56, 56, 256), 256),
                  ("conv5_1", (MAIN_BATCH, 14, 14, 512), 512))
#: The profiler-overhead protocol (benchmarks/observe.py of the JAX
#: package): rounds, requests per arm per round, and its gates.
OBSERVE_ROUNDS, OBSERVE_PER_ROUND = 10, 20
OBSERVE_MAX_OVERHEAD_PCT = 10.0
OBSERVE_MAX_RESIDUAL_PCT = 1.0


def stem_direct(params, mel):
    """The Whisper stem through F.conv1d in mel's dtype: the JAX package's
    SAME pads (lo = total // 2), bias, GELU (tanh)."""
    import torch.nn.functional as F

    def conv(x, w, b, stride):
        t, k = x.shape[1], w.shape[0]
        total = max((-(-t // stride) - 1) * stride + k - t, 0)
        xc = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
        y = F.conv1d(xc, w.to(x.dtype).permute(2, 1, 0), b.to(x.dtype),
                     stride=stride).transpose(1, 2)
        return F.gelu(y, approximate="tanh")

    x = conv(mel, params["conv1_w"], params["conv1_b"], 1)
    return conv(x, params["conv2_w"], params["conv2_b"], 2)


def per_call_phase(dev, params: dict, nets: dict, fp32_b4: dict, randn
                   ) -> tuple[dict, dict, dict]:
    """Phase 7 (a)-(c) (module docstring): the Whisper stem through
    compile() under three algorithms, cnn_forward on VGG-16 and
    MobileNet-v1 against the compiled networks, and the per-call kernel
    wrappers. `fp32_b4` maps a network to its pallas_winograd network at
    batch 4, that network's input and its logits. Returns the report, the
    launch counts of each path and, per kernel, the largest (relative,
    absolute) error of the leaves held against their plain versions;
    raises on any gate."""
    import tempfile
    import types

    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.core import compile as pt_compile
    from repro_torch.core import plan as pt_plan
    from repro_torch.core.transforms import F63_FP32_ERROR_BUDGET
    from repro_torch.kernels import depthwise as kd
    from repro_torch.kernels import ops
    from repro_torch.models import audio, cnn

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def gate(label, ok, detail):
        if not ok:
            raise AssertionError(f"[per-call] {label}: {detail}")

    report: dict[str, Any] = {}
    counts_by_path: dict[str, dict] = {}
    held: dict[str, list] = {}

    # ---- (a) the Whisper-tiny stem at full width --------------------------
    cfg = configs.get_config("whisper_tiny")
    gen = torch.Generator(device=dev).manual_seed(22)
    sp = audio.init_stem(gen, cfg, n_mels=STEM_MELS, device=dev)
    for k in ("conv1_b", "conv2_b"):          # non-zero: check the epilogue
        sp[k] = 0.1 * torch.randn(sp[k].shape, generator=gen, device=dev)
    stem_rows = []
    for batch in (STEM_BATCH, 1):
        mel = torch.randn(batch, STEM_FRAMES, STEM_MELS, generator=gen,
                          device=dev)
        want = stem_direct(sp, mel.double())
        cudnn = lambda: stem_direct(sp, mel)                  # noqa: E731
        for alg, table in STEM_TABLES.items():
            net = pt_compile.compile(sp, audio.stem_graph(cfg.d_model),
                                     input_shape=tuple(mel.shape),
                                     algorithm=alg, device=dev)
            if batch == STEM_BATCH:
                log(net.describe())
            got_table = tuple(net.plans[n].describe()["executor"]
                              for n in ("conv1", "conv2"))
            gate(f"stem {alg} describe", got_table == table, got_table)
            label = f"whisper_tiny stem {alg} batch {batch}"
            reset_counts()
            y = net.apply(mel)
            y_call = audio.stem(sp, mel, algorithm=alg)
            y_plans = audio.stem(sp, mel, plans=net)
            sync()
            counts_by_path[label] = read_counts()
            gate(f"{label} launches no kernel",
                 not any(counts_by_path[label].values()),
                 counts_by_path[label])
            gate(f"{label} output", tuple(y.shape) == (
                batch, STEM_FRAMES // 2, cfg.d_model)
                and bool(torch.isfinite(y).all()), tuple(y.shape))
            err = rel_err(y.double(), want)
            e_call, e_plans = rel_err(y_call, y), rel_err(y_plans, y)
            gate(f"{label} vs float64", err <= TOL_STEM, err)
            gate(f"{label} per call and plans= vs compiled",
                 max(e_call, e_plans) <= TOL_STEM_PATHS, (e_call, e_plans))
            row = {"algorithm": alg, "batch": batch,
                   "executors": list(got_table),
                   "max_rel_err_vs_f64": err,
                   "per_call_vs_compiled": e_call,
                   "plans_vs_compiled": e_plans,
                   "ms": cuda_ms(lambda: net.apply(mel), 10),
                   "device_ms": graph_ms(lambda: net.apply(mel), reps=5),
                   "per_call_ms": cuda_ms(
                       lambda: audio.stem(sp, mel, algorithm=alg), 10),
                   "cudnn_ms": cuda_ms(cudnn, 10),
                   "cudnn_device_ms": graph_ms(cudnn, reps=5)}
            if batch == STEM_BATCH:
                with tempfile.TemporaryDirectory() as tdir:
                    path = f"{tdir}/stem_{alg}.npz"
                    net.save(path)
                    loaded = pt_compile.NetworkPlan.load(path, device=dev)
                    verified = pt_compile.verify_artifact(path)
                same = torch.equal(loaded.apply(mel), y)
                gate(f"{label} save / load bitwise",
                     same and verified == []
                     and loaded.describe() == net.describe(),
                     (same, verified))
                row["save_load_bitwise"] = same
            stem_rows.append(row)
            log(f"[per-call] {label}: {json.dumps(row)}")
            del net
    report["stem"] = stem_rows

    # ---- (b) cnn_forward: every conv planned per call ---------------------
    calls: list = []
    original = kd.depthwise_streamed

    def recorder(*args, **kwargs):
        y = original(*args, **kwargs)
        calls.append((args, kwargs, y))
        return y
    # the wrapper counts into the module's attribute: here, the recorder's
    recorder.LAUNCHES = 0

    forwards = {}
    for name, expected in EXPECTED_PER_CALL.items():
        net, x, y_compiled = fp32_b4[name]
        label = f"{name} per call pallas_winograd batch {x.shape[0]}"

        def forward(name=name, x=x):
            return cnn.cnn_forward(params[name], x, nets[name],
                                   algorithm="pallas_winograd")
        reset_counts()
        y = forward()
        sync()
        counts = read_counts()
        counts_by_path[label] = counts
        log(f"[per-call] {label}: launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
        gate(f"{label} launches", counts == {k: expected.get(k, 0)
                                             for k in KERNELS}, counts)
        gate(f"{label} logits", tuple(y.shape) == (x.shape[0], 1000)
             and bool(torch.isfinite(y).all()), tuple(y.shape))
        y_direct = direct_forward(params[name], nets[name], x)
        sync()
        e_compiled, e_direct = rel_err(y, y_compiled), rel_err(y, y_direct)
        gate(f"{label} vs the compiled network", e_compiled <= TOL_NET_PLAIN,
             e_compiled)
        gate(f"{label} vs the direct network", e_direct <= TOL_NET_DIRECT,
             e_direct)
        row = {"launches": {k: v for k, v in counts.items() if v},
               "logits_vs_compiled": e_compiled,
               "logits_vs_direct": e_direct,
               "per_call_ms": cuda_ms(forward, 5),
               "compiled_ms": cuda_ms(lambda: net.apply(x), 10)}
        forwards[name] = row
        log(f"[per-call] {label}: logits rel err vs the compiled network "
            f"{e_compiled:.3e}, vs the direct network {e_direct:.3e}; "
            f"{row['per_call_ms']:.3f} ms per call against the compiled "
            f"apply's {row['compiled_ms']:.3f} (every filter transformed "
            f"on every call)")
        if name == "mobilenet_v1":
            kd.depthwise_streamed = recorder
            try:
                forward()
            finally:
                kd.depthwise_streamed = original
            sync()
    report["cnn_forward"] = forwards

    # every depthwise leaf of MobileNet-v1's per-call forward: fp32 taps
    gate("nine depthwise leaves", len(calls) == 9, len(calls))
    leaves = []
    for i, (args, kwargs, y) in enumerate(calls):
        xp, u = args[0], args[1]
        plain_kwargs = {k: v for k, v in kwargs.items() if k != "block_c"}
        gate(f"depthwise leaf {i} taps", u.dtype == torch.float32, u.dtype)
        want = kd.depthwise_streamed_plain(*args, **plain_kwargs)
        err, abs_err = rel_err(y, want), float((y - want).abs().max())
        held.setdefault("depthwise_streamed", []).append((err, abs_err))
        gate(f"depthwise leaf {i} vs plain", err <= TOL_KERNEL, err)
        c = xp.shape[3]
        k = kwargs["ct_h"].r
        w_lib = randn(c, 1, k, k, scale=1 / k)
        xc = xp.permute(0, 3, 1, 2)
        row = {"shape": list(xp.shape), "tile": f"F({kwargs['ct_h'].m},{k})",
               "blocking": [kwargs["bh"], kwargs["bw"], kwargs["block_c"]],
               "max_rel_err": err, "max_abs_err": abs_err,
               "device_ms": graph_ms(lambda: original(*args, **kwargs),
                                     reps=5),
               "plain_ms": cuda_ms(lambda: kd.depthwise_streamed_plain(
                   *args, **plain_kwargs), 3, warmup=1),
               "library_device_ms": graph_ms(
                   lambda: F.conv2d(xc, w_lib, groups=c), reps=5)}
        leaves.append(row)
        log(f"[per-call] depthwise_streamed fp32 leaf {i}: "
            f"{json.dumps(row)}")
    report["depthwise_fp32_leaves"] = {
        "device_ms": sum(r["device_ms"] for r in leaves),
        "plain_ms": sum(r["plain_ms"] for r in leaves),
        "library_device_ms": sum(r["library_device_ms"] for r in leaves),
        "max_rel_err": max(r["max_rel_err"] for r in leaves),
        "layers": leaves}
    del calls

    # ---- (c) the per-call kernel wrappers on VGG-16 layers -----------------
    wrappers_report = {}
    same_pads = types.SimpleNamespace(padding="SAME", stride=(1, 1),
                                      groups=1)
    for layer, shape, m in WRAPPER_LAYERS:
        c = shape[3]
        x = randn(*shape)
        w = randn(3, 3, c, m, scale=(9 * c) ** -0.5)
        b = randn(m, scale=0.1)
        exact = F.relu(conv_f64(x, w, same_pads) + b.double())
        epi = dict(bias=b, activation="relu")
        pairs = {}
        for wrapper, alg, tol in (
                ("winograd_conv2d", "pallas_winograd", TOL_KERNEL),
                ("im2col_conv2d", "pallas_im2col", TOL_KERNEL),
                ("fft_conv2d", "fft", TOL_KERNEL),
                ("winograd_f63_conv2d", "winograd_f63",
                 F63_FP32_ERROR_BUDGET)):
            plan = pt_plan.plan_conv2d(shape, w, algorithm=alg, device=dev)
            pairs[wrapper] = (
                lambda fn=getattr(ops, wrapper): fn(x, w, **epi),
                lambda plan=plan: plan.apply(x, **epi), tol)
        label = f"per-call wrappers vgg16.{layer} batch {shape[0]}"
        reset_counts()
        outs = {k: call() for k, (call, _, _) in pairs.items()}
        sync()
        counts = read_counts()
        counts_by_path[label] = counts
        gate(f"{label} launches", counts == {
            k: int(k in ("winograd_streamed", "matmul")) for k in KERNELS},
            counts)
        rows = {}
        for wrapper, (call, planned, tol) in pairs.items():
            y_plan = planned()
            sync()
            bitwise = torch.equal(outs[wrapper], y_plan)
            err = rel_err(outs[wrapper].double(), exact)
            rows[wrapper] = {"bitwise_equal_planned": bitwise,
                             "max_rel_err_vs_f64": err, "tol": tol,
                             "ms": cuda_ms(call, 10),
                             "planned_ms": cuda_ms(planned, 10)}
            log(f"[per-call] {label} ops.{wrapper}: "
                f"{json.dumps(rows[wrapper])}")
            gate(f"{label} {wrapper} vs float64", err <= tol, err)
            if wrapper in ("winograd_conv2d", "im2col_conv2d"):
                gate(f"{label} {wrapper} bitwise equal to the planned apply",
                     bitwise, err)
        wrappers_report[layer] = rows
        del outs
    report["wrappers"] = wrappers_report
    kernel_errs = {k: (max(e for e, _ in v), max(a for _, a in v))
                   for k, v in held.items()}
    return report, counts_by_path, kernel_errs


def tuningdb_phase(dev, params: dict, nets: dict, res: dict,
                   auto_nets: dict, autotune_report: dict) -> dict:
    """Phase 7 (d): export phase 6's auto_tuned networks (batch 4) and the
    same networks compiled at batch 1 into one merged tuning database under
    build/, then compile both networks in a fresh process on the card with
    REPRO_TUNING_DB set: nothing may be measured, every raced layer must
    hit the database, and each winner and tile must be phase 6's."""
    import os

    from repro_torch.core import compile as pt_compile
    from repro_torch.obs import tuningdb

    def gate(label, ok, detail):
        if not ok:
            raise AssertionError(f"[tuning-db] {label}: {detail}")

    batch1 = {name: pt_compile.compile(params[name], nets[name],
                                       res=res[name], batch=1,
                                       algorithm="auto_tuned", device=dev)
              for name in AUTOTUNE_NETS}
    doc_b4 = tuningdb.export([auto_nets[n] for n in AUTOTUNE_NETS])
    doc_b1 = tuningdb.export(list(batch1.values()))
    merged = tuningdb.merge(doc_b4, doc_b1)
    gate("merge is the union", set(merged["entries"])
         == set(doc_b4["entries"]) | set(doc_b1["entries"]),
         (len(merged["entries"]), len(doc_b4["entries"]),
          len(doc_b1["entries"])))
    path = ROOT / "build" / "tuning_db.json"
    path.parent.mkdir(exist_ok=True)
    tuningdb.save(merged, str(path))
    raced = {name: {nid: [p.algorithm, p.describe()["tile"]]
                    for nid, p in auto_nets[name].plans.items()
                    if p.spec.autotune is not None}
             for name in AUTOTUNE_NETS}
    # the fresh process: argv[1] is {network: resolution}, argv[2] the
    # device, argv[3] the batch
    prog = (
        "import json, sys, time, torch\n"
        "from repro_torch.core import compile as C, plan\n"
        "from repro_torch.models import cnn\n"
        "nets, dev, batch = json.loads(sys.argv[1]), sys.argv[2],"
        " int(sys.argv[3])\n"
        "out = {'placement': {}, 'compile_s': {}}\n"
        "for name, res in nets.items():\n"
        "    specs = cnn.NETWORKS[name][0]()\n"
        "    params = cnn.init_cnn(torch.Generator().manual_seed(0), specs,"
        " 3, res=res, device=dev)\n"
        "    t0 = time.perf_counter()\n"
        "    net = C.compile(params, specs, res=res, batch=batch,"
        " algorithm='auto_tuned', device=dev)\n"
        "    out['compile_s'][name] = time.perf_counter() - t0\n"
        "    out['placement'][name] = {n: [p.algorithm,"
        " p.describe()['tile']] for n, p in net.plans.items()"
        " if p.spec.autotune is not None}\n"
        "info = plan.plan_cache_info()\n"
        "out.update(measured=info['measured'],"
        " tuningdb_hits=info['tuningdb_hits'])\n"
        "print(json.dumps(out))\n")
    argv = [json.dumps({n: res[n] for n in AUTOTUNE_NETS}), dev.type,
            str(MAIN_BATCH)]
    env = dict(os.environ, REPRO_TUNING_DB=str(path),
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("REPRO_PLAN_NO_MEASURE", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", prog, *argv], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=str(ROOT))
    wall_s = time.perf_counter() - t0
    gate("fresh process", proc.returncode == 0, proc.stderr[-2000:])
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    # a layer shape raced twice in phase 6 (GoogleNet repeats some) is one
    # database entry: its first plan hits the database, the rest the spec
    # cache
    n_raced = sum(len(v) for v in raced.values())
    gate("nothing measured", got["measured"] == 0, got["measured"])
    gate("every raced layer shape hits the database",
         got["tuningdb_hits"] == len(doc_b4["entries"]),
         (got["tuningdb_hits"], len(doc_b4["entries"]), n_raced))
    gate("phase 6's winners and tiles", got["placement"] == raced,
         (got["placement"], raced))
    report = {"entries": {"batch4": len(doc_b4["entries"]),
                          "batch1": len(doc_b1["entries"]),
                          "merged": len(merged["entries"])},
              "raced_layers": n_raced,
              "raced_layer_shapes": len(doc_b4["entries"]),
              "tuningdb_hits": got["tuningdb_hits"],
              "measured": got["measured"],
              "db_warm_compile_s": got["compile_s"],
              "cold_compile_s": {n: autotune_report[n]["compile_s"]
                                 for n in AUTOTUNE_NETS},
              "fresh_process_wall_s": wall_s, "path": str(path)}
    log(f"[tuning-db] {json.dumps(report)}")
    return report


def observe_protocol(srv, inputs: list, rng, rounds: int, per_round: int,
                     trace_out: str, meta: dict | None = None) -> dict:
    """The JAX package's observability-overhead protocol
    (benchmarks/observe.py) on a started Server: warm both arms up, then
    `rounds` rounds of `per_round` sequential requests with the profiler
    disabled, then enabled; audit the enabled arm's spans (the four
    request spans must tile [submit, finish]) and export the chrome trace
    to `trace_out`. Returns the repro.observe/v1 document."""
    import numpy as np

    from repro_torch.obs import profile, trace

    def serve(n):
        lat = []
        for _ in range(n):
            t = srv.submit(inputs[int(rng.integers(len(inputs)))])
            t.result(timeout=300)
            lat.append(t.latency_s)
        return lat

    profile.disable()
    serve(2)
    profile.enable()
    serve(2)
    profile.disable()
    lat_dis, lat_en = [], []
    for _ in range(rounds):
        lat_dis += serve(per_round)
        profile.enable()
        lat_en += serve(per_round)
        profile.disable(tracing=False)           # keep spans for the audit
    tracer = trace.get()
    # a ticket finishes before the scheduler records its batch's spans:
    # wait for the last batch's
    deadline = time.perf_counter() + 30
    while (len(tracer.spans("serve.respond")) < rounds * per_round
           and time.perf_counter() < deadline):
        time.sleep(0.001)
    by_rid: dict = {}
    for s in tracer.spans():
        rid = s.args.get("rid")
        if rid is not None and s.name in ("serve.queue_wait",
                                          "serve.batch_formation",
                                          "serve.respond"):
            by_rid.setdefault(rid, {})[s.name] = (s.t0, s.t1)
    decomp = []
    for rid, parts in sorted(by_rid.items()):
        if len(parts) != 3:
            continue
        qw, bf, rp = (parts["serve.queue_wait"],
                      parts["serve.batch_formation"], parts["serve.respond"])
        latency = rp[1] - qw[0]
        pieces = {"queue_wait_ms": (qw[1] - qw[0]) * 1e3,
                  "batch_formation_ms": (bf[1] - bf[0]) * 1e3,
                  "dispatch_ms": (rp[0] - bf[1]) * 1e3,
                  "respond_ms": (rp[1] - rp[0]) * 1e3}
        resid = (abs(sum(pieces.values()) - latency * 1e3)
                 / max(latency * 1e3, 1e-9) * 100)
        decomp.append({"rid": rid, **pieces, "latency_ms": latency * 1e3,
                       "residual_pct": resid})
    # the layer spans of the last audited request's dispatch
    n_layer_spans, span_table = 0, []
    if decomp:
        rid = decomp[-1]["rid"]
        bf_end = by_rid[rid]["serve.batch_formation"][1]
        dispatch = next((d for d in tracer.spans("serve.dispatch")
                         if abs(d.t0 - bf_end) < 1e-6), None)
        if dispatch is not None:
            span_table = [{"span": s.name, "ms": (s.t1 - s.t0) * 1e3,
                           "executor": s.args.get("executor", "?")}
                          for s in tracer.spans("layer:")
                          if dispatch.t0 - 1e-9 <= s.t0
                          and s.t1 <= dispatch.t1 + 1e-9]
            n_layer_spans = len(span_table)
    chrome = tracer.export_chrome(trace_out)
    trace.disable()
    p50_dis = float(np.percentile(lat_dis, 50)) * 1e3
    p50_en = float(np.percentile(lat_en, 50)) * 1e3
    overhead = (p50_en - p50_dis) / p50_dis * 100
    max_resid = max((r["residual_pct"] for r in decomp), default=1e9)
    events = chrome.get("traceEvents")
    valid = (isinstance(events, list) and len(events) > 0
             and all("ph" in e for e in events))
    return {
        "format": "repro.observe/v1", "meta": meta or {},
        "rounds": rounds, "requests_per_arm": rounds * per_round,
        "p50_disabled_ms": p50_dis, "p50_enabled_ms": p50_en,
        "overhead_pct": overhead,
        "decomposition": {"max_residual_pct": max_resid,
                          "requests": len(decomp),
                          "per_request": decomp[:16]},
        "span_table": span_table,
        "trace_events": len(events) if isinstance(events, list) else 0,
        "trace_dropped": chrome["otherData"]["dropped_spans"],
        "serve_stats": {k: v for k, v in srv.stats.snapshot().items()
                        if isinstance(v, int)},
        "gates": {
            "overhead_lt_10pct": overhead < OBSERVE_MAX_OVERHEAD_PCT,
            "decomposition_residual_lt_1pct":
                max_resid < OBSERVE_MAX_RESIDUAL_PCT,
            "valid_chrome_trace": bool(valid),
            "layer_spans_present": n_layer_spans > 0,
        },
    }


def observe_phase(dev, params: dict, nets: dict, res: dict) -> dict:
    """Phase 7 (e): the profiler's overhead on served MobileNet-v2 batches
    at 224 (observe_protocol), eager supervised dispatch (gated as the JAX
    package gates it) and graph dispatch (reported); the eager document is
    written under build/ and read back through repro_torch.obs.regress."""
    import numpy as np
    import torch

    from repro_torch.obs import regress
    from repro_torch.runtime.serve import ServeConfig, Server

    name = "mobilenet_v2"
    r = res[name]
    rng = np.random.default_rng(7)
    inputs = [rng.standard_normal((r, r, 3)).astype(np.float32)
              for _ in range(4)]
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    meta = {"device_kind": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "torch_version": torch.__version__, "network": name, "res": r,
            "buckets": list(SERVE_BUCKETS), "algorithm": "pallas_winograd"}
    docs = {}
    for arm, jit in (("eager", False), ("graph", True)):
        config = ServeConfig(buckets=SERVE_BUCKETS, jit_dispatch=jit,
                             verbose=False, probation_batches=0)
        with Server(params[name], nets[name], res=r,
                    algorithm="pallas_winograd", config=config,
                    device=dev) as srv:
            docs[arm] = observe_protocol(
                srv, inputs, rng, OBSERVE_ROUNDS, OBSERVE_PER_ROUND,
                str(out_dir / f"observe_{arm}.trace.json"),
                dict(meta, jit_dispatch=jit))
        log(f"[observe] {arm}: p50 disabled "
            f"{docs[arm]['p50_disabled_ms']:.4f} ms, enabled "
            f"{docs[arm]['p50_enabled_ms']:.4f} ms, overhead "
            f"{docs[arm]['overhead_pct']:+.3f} %, max residual "
            f"{docs[arm]['decomposition']['max_residual_pct']:.5f} % over "
            f"{docs[arm]['decomposition']['requests']} requests, "
            f"{docs[arm]['trace_events']} trace events; gates "
            f"{json.dumps(docs[arm]['gates'])}")
    path = out_dir / "observe.json"
    path.write_text(json.dumps(docs["eager"], indent=1))
    metrics = regress.extract(regress.load(str(path)))
    gates = {k.removeprefix("observe.gate."): bool(m.value)
             for k, m in metrics.items() if k.startswith("observe.gate.")}
    if (regress.detect(docs["eager"]) != "observe"
            or gates != docs["eager"]["gates"] or not all(gates.values())
            or "observe.overhead_pct" not in metrics):
        raise AssertionError(f"[observe] eager arm: gates {gates}, metrics "
                             f"{sorted(metrics)}")
    # the committed BENCH_PR10.json is a CPU run: printed, never gated
    findings = regress.compare(regress.load(str(ROOT / "BENCH_PR10.json")),
                               docs["eager"])
    for line in regress.summarize(findings):
        log(f"[observe] vs BENCH_PR10.json (CPU, information only):{line}")
    return {arm: {k: doc[k] for k in ("p50_disabled_ms", "p50_enabled_ms",
                                      "overhead_pct", "trace_events",
                                      "trace_dropped", "gates")}
            | {"max_residual_pct":
               doc["decomposition"]["max_residual_pct"]}
            for arm, doc in docs.items()} | {"path": str(path)}


# ---------------------------------------------------------------------------
# phase 8: partitioned NetworkPlans on a mesh that repeats the card
# ---------------------------------------------------------------------------

#: Spatial partitions of VGG-16 and GoogleNet at 224, batch MAIN_BATCH:
#: (network, shards) -> the record's node count per mode, as the JAX
#: package's decide_partition gives them for the same graphs. VGG-16's
#: conv5_* re-gather over 4 shards (14 rows do not divide by 4); GoogleNet
#: halos its 3a / 3b blocks (the 5x5 layers with 2-row halos).
PARTITION_SPATIAL = {("vgg16", 2): {"halo": 13, "full": 5, "local": 3},
                     ("vgg16", 4): {"halo": 10, "full": 8, "local": 3},
                     ("googlenet", 4): {"halo": 14, "full": 64, "local": 3}}
#: The data partition of MobileNet-v2: batch 8 over 4 shards (local batch 2).
PARTITION_DATA = ("mobilenet_v2", 8, 4)
#: The sharded serving buckets of MobileNet-v2 over 4 shards: 1 and 2 do
#: not divide and serve their unsharded plans, as in the JAX package.
PARTITION_SERVE_SHARDED = {"4": 4, "8": 4}


def partition_phase(dev, params: dict, nets: dict, res: dict, mains: dict,
                    serve_traffic: dict, check, randn) -> tuple[dict, dict]:
    """Phase 8 (module docstring): partitioned plans on make_data_mesh(D,
    devices=[card] * D). `mains` maps a network to its fp32 batch-4
    (unsharded net, input, logits) of phase 3, `serve_traffic` is phase 5's
    traffic report, `check(label, kernel, calls)` holds a kernel against its
    plain version. Returns the report and the launch counts of each driven
    path; raises on any gate."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import compile as pt_compile
    from repro_torch.core import partition as pt_partition
    from repro_torch.core import plan as pt_plan
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.runtime.serve import ServeConfig, Server

    report: dict[str, Any] = {}
    counts_by_path: dict[str, dict] = {}

    def gate(label, ok, detail):
        if not ok:
            raise AssertionError(f"[partition] {label}: {detail}")

    def card_mesh(d):
        return make_data_mesh(d, devices=[dev] * d)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def compiled(name, batch, mesh=None, partition=None, artifact=None):
        t0 = time.perf_counter()
        net = pt_compile.compile(params[name], nets[name], res=res[name],
                                 batch=batch, algorithm="pallas_winograd",
                                 mesh=mesh, partition=partition,
                                 artifact=artifact,
                                 device=None if mesh else dev)
        sync()
        return net, time.perf_counter() - t0

    def f64_logits(name, x):
        """The direct F.conv2d network in float64 (the oracle of phase 3's
        TF32x3 kernels, here of the whole partitioned network)."""
        with torch.no_grad():
            return direct_forward(cast_like_init(params[name],
                                                 torch.float64),
                                  nets[name], x.double())

    def multiplicity(net):
        """Launches per forward of each plan's kernels: a halo-mode node
        once per shard, a data partition's every node once per shard, any
        other node once."""
        part, d = net.partition, net.partition["num_shards"]
        if part["kind"] == "data":
            return lambda nid: d
        return lambda nid: d if part["modes"].get(nid) == "halo" else 1

    def drive(label, net, x):
        """Two forwards of the partitioned `net`, every launch counter set
        to 0 just before them and read just after, each plan's launches
        counted around its own apply: a halo node's kernels must launch
        once per shard, every other node's once (a data partition: every
        node once per shard). Logits finite, (batch, 1000), bitwise equal
        across the two forwards."""
        mult = multiplicity(net)
        per_plan = {nid: {k: 0 for k in KERNELS} for nid in net.plans}

        def counted(nid, apply):
            def run(*args, **kwargs):
                before = read_counts()
                y = apply(*args, **kwargs)
                for k, v in read_counts().items():
                    per_plan[nid][k] += v - before[k]
                return y
            return run

        for nid in per_plan:
            net.plans[nid].apply = counted(nid, net.plans[nid].apply)
        reset_counts()
        y1 = net.apply(x)
        y2 = net.apply(x)
        sync()
        counts = read_counts()
        for nid in per_plan:
            del net.plans[nid].apply
        want_plan = {nid: {k: 0 for k in KERNELS} for nid in net.plans}
        for leaf in network_leaves(net):
            nid = leaf.layer.split(".")[0]
            want_plan[nid][leaf.kernel] += 2 * mult(nid)
        want = {k: sum(p[k] for p in want_plan.values()) for k in KERNELS}
        log(f"[partition] {label}: 2 forwards, launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
        gate(f"{label} launches", counts == want and per_plan == want_plan,
             (counts, want, per_plan))
        gate(f"{label} logits", y1.shape == (x.shape[0], 1000)
             and bool(torch.isfinite(y1).all()) and torch.equal(y1, y2),
             tuple(y1.shape))
        counts_by_path[f"partition {label}"] = counts
        return y1, counts

    def held(label, name, x, y, want, want_label):
        y64 = f64_logits(name, x)
        sync()
        e_want, e64 = rel_err(y, want), rel_err(y.double(), y64)
        log(f"[partition] {label} logits rel err vs {want_label} "
            f"{e_want:.3e} (tol {TOL_NET_PLAIN}), vs the float64 direct "
            f"network {e64:.3e} (tol {TOL_NET_DIRECT})")
        gate(f"{label} logits", e_want <= TOL_NET_PLAIN
             and e64 <= TOL_NET_DIRECT, (e_want, e64))
        return {"vs_" + want_label.replace(" ", "_"): e_want,
                "vs_float64_direct": e64}

    def kernel_checks(label, net, only_halo):
        """Every kernel leaf of `net` (of its halo nodes, `only_halo`) held
        against its plain version on a random input of its bound shape:
        the strips are new geometry to the choosers."""
        modes = net.partition.get("modes", {})
        n = 0
        for leaf in network_leaves(net):
            nid = leaf.layer.split(".")[0]
            if only_halo and modes.get(nid) != "halo":
                continue
            x = randn(*leaf.plan.spec.x_shape)
            err, _ = check(f"{label}.{leaf.layer} {leaf.kernel}",
                           leaf.kernel, leaf_calls(leaf, x, randn))
            log(f"[partition] {label}.{leaf.layer} {leaf.kernel} "
                f"{tuple(x.shape)} blocking "
                f"{getattr(leaf.plan.spec, 'blocks', None)}: "
                f"max_rel_err {err:.3e}")
            n += 1
        return n

    def copy_share(net, x):
        """Device ms of one sharded forward by torch.profiler, and the part
        inside the halo exchanges (with their W pads), the gathers and the
        scatters (record_function ranges around the partition module's
        primitives)."""
        ranges = {"partition.halo": 0.0, "partition.gather": 0.0,
                  "partition.scatter": 0.0}
        saved = {"halo_strips": pt_partition.halo_strips,
                 "gather_rows": pt_partition.gather_rows,
                 "scatter_rows": pt_partition.scatter_rows}
        tags = {"halo_strips": "partition.halo",
                "gather_rows": "partition.gather",
                "scatter_rows": "partition.scatter"}

        def ranged(fn, tag):
            def run(*a, **k):
                with torch.profiler.record_function(tag):
                    return fn(*a, **k)
            return run

        for f, fn in saved.items():
            setattr(pt_partition, f, ranged(fn, tags[f]))
        try:
            by_name, _ = profile_device(lambda: net.apply(x), runs=3,
                                        families=ranges)
        finally:
            for f, fn in saved.items():
                setattr(pt_partition, f, fn)
        total = sum(by_name.values()) / 3
        copies = {k.removeprefix("partition."): v / 3
                  for k, v in ranges.items()}
        return {"profiled_device_ms": total,
                "copies_device_ms": copies,
                "copies_share": (sum(copies.values()) / total
                                 if total else None)}

    def timed(label, net, plain, x):
        row = {"sharded_device_ms": graph_ms(lambda: net.apply(x), reps=3),
               "unsharded_device_ms": graph_ms(lambda: plain.apply(x),
                                               reps=3),
               "sharded_ms": cuda_ms(lambda: net.apply(x), 10),
               "unsharded_ms": cuda_ms(lambda: plain.apply(x), 10)}
        row.update(copy_share(net, x))
        log(f"[partition] {label} timing: {json.dumps(row)}")
        return row

    def record_counts(net):
        m = net.partition["modes"]
        return {mode: sum(v == mode for v in m.values())
                for mode in sorted(set(m.values()))}

    (ROOT / "build").mkdir(exist_ok=True)
    adir = tempfile.mkdtemp(dir=ROOT / "build")
    vgg_art = os.path.join(adir, "vgg16_spatial4.npz")

    # ---- (a) VGG-16 and (b) GoogleNet, spatial ---------------------------
    for (name, d), want_modes in PARTITION_SPATIAL.items():
        label = f"{name} spatial x{d} batch {MAIN_BATCH}"
        plain, x, y_plain = mains[name]
        art = vgg_art if (name, d) == ("vgg16", 4) else None
        if art:
            pt_plan.clear_plan_cache()
        net, build_s = compiled(name, MAIN_BATCH, card_mesh(d), "spatial",
                                art)
        table = net.describe()
        log(table)
        modes = record_counts(net)
        log(f"[partition] {label}: record modes {json.dumps(modes)}, halos "
            f"{json.dumps(net.partition['halo'])}, compiled in "
            f"{build_s:.2f} s")
        gate(f"{label} record", net.is_sharded() and modes == want_modes
             and net.partition["num_shards"] == d
             and all(f"| {nid} |" in table for nid in net.plans),
             (modes, want_modes))
        if art:
            info = pt_plan.plan_cache_info()
            gate(f"{label} cold artifact", info["artifact_misses"] == 1
                 and os.path.exists(art), info)
        n_checked = kernel_checks(label, net, only_halo=True)
        y, counts = drive(label, net, x)
        row = {"record": modes, "halo": net.partition["halo"],
               "compile_s": build_s, "launches_per_forward": {
                   k: v // 2 for k, v in counts.items() if v},
               "halo_leaves_checked": n_checked}
        row["logits"] = held(label, name, x, y, y_plain, "unsharded plan")
        row["timing"] = timed(label, net, plain, x)
        if name == "vgg16":
            # per halo layer: D strips against the unsharded layer
            layers = {}
            for node in net.graph:
                if net.partition["modes"].get(node.id) != "halo":
                    continue
                xs = randn(*net.plans[node.id].spec.x_shape)
                xf = randn(*plain.plans[node.id].spec.x_shape)
                strip = graph_ms(lambda: net._eval_node(
                    node, node.attrs, xs, None, net.consts))
                whole = graph_ms(lambda: plain._eval_node(
                    node, node.attrs, xf, None, plain.consts))
                layers[node.id] = {
                    "strip_shape": list(xs.shape),
                    "blocking": list(net.plans[node.id].spec.blocks),
                    "strips_device_ms": d * strip,
                    "unsharded_device_ms": whole}
            row["layers"] = layers
            log(f"[partition] {label} per halo layer: {json.dumps(layers)}")
        report[label] = row
        if (name, d) == ("vgg16", 4):
            vgg4 = (net, build_s, x, y)
        else:
            del net

    # ---- (c) MobileNet-v2, data --------------------------------------------
    name, batch, d = PARTITION_DATA
    label = f"{name} data x{d} batch {batch}"
    plain, _ = compiled(name, batch)
    net, build_s = compiled(name, batch, card_mesh(d), "data")
    gate(f"{label} record", net.is_sharded()
         and net.partition == {"kind": "data", "axis": "data",
                               "num_shards": d, "requested_shards": d,
                               "degraded": None}, net.partition)
    x = randn(batch, res[name], res[name], 3)
    n_checked = kernel_checks(label, net, only_halo=False)
    y, counts = drive(label, net, x)
    gate(f"{label} launches", {k: v // 2 for k, v in counts.items() if v}
         == {k: d * v for k, v in EXPECTED[name].items()}, counts)
    row = {"local_batch": batch // d, "compile_s": build_s,
           "launches_per_forward": {k: v // 2 for k, v in counts.items()
                                    if v},
           "leaves_checked": n_checked}
    row["logits"] = held(label, name, x, y, plain.apply(x),
                         f"unsharded plan batch {batch}")
    row["timing"] = timed(label, net, plain, x)
    report[label] = row
    del net, plain

    # ---- (d) the server with mesh-sharded buckets ---------------------------
    rng = np.random.default_rng(20)
    r = res[name]
    images = [rng.standard_normal((r, r, 3)).astype(np.float32)
              for _ in range(sum(SERVE_BURSTS))]
    config = ServeConfig(buckets=SERVE_BUCKETS, queue_capacity=64,
                         verbose=False, probation_batches=0)
    t0 = time.perf_counter()
    srv = Server(params[name], nets[name], res=r,
                 algorithm="pallas_winograd", config=config,
                 mesh=card_mesh(d), partition="data")
    build_s = time.perf_counter() - t0
    gate("server sharded buckets",
         srv.stats.sharded_buckets == PARTITION_SERVE_SHARDED,
         srv.stats.sharded_buckets)
    reset_counts()
    srv.start()            # warmup: a supervised batch and a capture each
    after_warmup = read_counts()
    e = EXPECTED[name]
    want = {k: sum(e.get(k, 0) * (1 + 2 * (d if str(b) in
                                            PARTITION_SERVE_SHARDED else 1))
                   for b in SERVE_BUCKETS) for k in KERNELS}
    gate("server warmup launches", after_warmup == want,
         (after_warmup, want))
    tickets, i = [], 0
    t0 = time.perf_counter()
    try:
        for burst in SERVE_BURSTS:
            batch_t = [srv.submit(images[i + j]) for j in range(burst)]
            i += burst
            for t in batch_t:
                t.result(timeout=300)
            tickets += batch_t
        wall = time.perf_counter() - t0
    finally:
        srv.stop()
    counts = read_counts()
    counts_by_path[f"partition serve {name} data x{d} (warmup and "
                   f"traffic)"] = counts
    s = srv.stats.snapshot()
    gate("server replays launch nothing", counts == after_warmup,
         (counts, after_warmup))
    gate("server stats", s["failed"] == 0 and s["jit_fallbacks"] == 0
         and s["jit_dispatches"] == s["batches"]
         and s["completed"] == len(images)
         and all(s["bucket_batches"].get(b, 0) > 0 for b in ("4", "8")), s)
    gate("server graphs are the sharded plans", all(
        srv._jit[b][2][0] is srv.sharded_nets[b] for b in (4, 8)), "")

    def eager_b1(x):
        with torch.inference_mode():
            y = srv.nets[1].apply(torch.from_numpy(x[None]).to(dev))
        return y[0].cpu().numpy()

    errs = [float(np.abs(t.result() - eager_b1(x)).max()
                  / np.abs(eager_b1(x)).max())
            for t, x in zip(tickets, images)]
    gate("server answers", max(errs) <= TOL_NET_PLAIN, max(errs))
    lat = np.array([t.latency_s for t in tickets]) * 1e3
    report["serve"] = {
        "sharded_buckets": s["sharded_buckets"],
        "bucket_batches": s["bucket_batches"], "requests": len(tickets),
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "requests_per_s": len(tickets) / wall,
        "phase5_p50_ms": serve_traffic["p50_ms"],
        "phase5_p99_ms": serve_traffic["p99_ms"],
        "max_rel_err_vs_eager_bucket1": max(errs), "build_s": build_s,
        "graph_ms": {str(b): host_ms(lambda: (srv._jitted_apply(b, xb),
                                              srv._sync()), 20)
                     for b, xb in ((b, torch.from_numpy(np.stack(
                         images[:b])).to(dev)) for b in SERVE_BUCKETS)}}
    log(f"[partition] serve: {json.dumps(report['serve'])}")
    del srv

    # ---- (e) warm starts, and where their time goes ------------------------
    net, cold_s, x, y = vgg4
    spent = {"verify_s": 0.0, "digest_in_verify_s": 0.0,
             "digest_in_load_s": 0.0, "plans_from_artifact_s": 0.0}
    in_verify = [False]
    digest, verify = pt_compile._array_digest, pt_compile.verify_artifact
    from_artifact = pt_plan.plan_from_artifact

    def timed_from_artifact(*a, **k):
        t = time.perf_counter()
        try:
            return from_artifact(*a, **k)
        finally:
            spent["plans_from_artifact_s"] += time.perf_counter() - t

    def timed_digest(a):
        t = time.perf_counter()
        out = digest(a)
        key = "digest_in_verify_s" if in_verify[0] else "digest_in_load_s"
        spent[key] += time.perf_counter() - t
        return out

    def timed_verify(path):
        in_verify[0] = True
        t = time.perf_counter()
        try:
            return verify(path)
        finally:
            spent["verify_s"] += time.perf_counter() - t
            in_verify[0] = False

    pt_compile._array_digest = timed_digest
    pt_compile.verify_artifact = timed_verify
    pt_plan.plan_from_artifact = timed_from_artifact
    try:
        pt_plan.clear_plan_cache()
        warm, warm_s = compiled("vgg16", MAIN_BATCH, card_mesh(4),
                                "spatial", vgg_art)
        info = pt_plan.plan_cache_info()
        vgg_spent = dict(spent)
        gate("vgg16 warm start", (info["artifact_hits"],
                                  info["artifact_misses"]) == (1, 0)
             and warm.partition == net.partition
             and torch.equal(warm.apply(x), y), info)
        del warm, net
        for k in spent:
            spent[k] = 0.0
        sdir = tempfile.mkdtemp(dir=ROOT / "build")
        config = ServeConfig(buckets=SERVE_BUCKETS, verbose=False)
        t0 = time.perf_counter()
        Server(params[name], nets[name], res=r, algorithm="pallas_winograd",
               config=config, artifact_dir=sdir, device=dev)
        sync()
        srv_cold_s = time.perf_counter() - t0
        for k in spent:
            spent[k] = 0.0
        t0 = time.perf_counter()
        srv = Server(params[name], nets[name], res=r,
                     algorithm="pallas_winograd", config=config,
                     artifact_dir=sdir, device=dev)
        sync()
        srv_warm_s = time.perf_counter() - t0
        gate("mobilenet_v2 warm start", srv.stats.artifact_warm_starts == 4,
             srv.stats.snapshot())
        del srv
    finally:
        pt_compile._array_digest = digest
        pt_compile.verify_artifact = verify
        pt_plan.plan_from_artifact = from_artifact
    report["warm_start"] = {
        "vgg16_spatial4": {"cold_compile_and_save_s": cold_s,
                           "warm_s": warm_s, **vgg_spent,
                           "artifact_mb": os.path.getsize(vgg_art) / 1e6},
        "mobilenet_v2_buckets": {"cold_s": srv_cold_s, "warm_s": srv_warm_s,
                                 **spent,
                                 "artifact_mb": sum(
                                     os.path.getsize(os.path.join(sdir, f))
                                     for f in os.listdir(sdir)) / 1e6}}
    log(f"[partition] warm start: {json.dumps(report['warm_start'])}")
    shutil.rmtree(adir)
    shutil.rmtree(sdir)
    return report, counts_by_path


# ---------------------------------------------------------------------------
# phase 9: the rest of the LM stack served -- paths E, F, G and the sweep of
# the other architectures at full width
# ---------------------------------------------------------------------------

#: Path E: jamba-v0.1-52b at full width, one 8-layer period (n_layers 32
#: cut to 8: one attention layer at index 4, seven Mamba layers, four MoE
#: layers of 16 experts top-2 at d_ff 14336, four MLP layers; ~13.3 B
#: params, 53 GB at fp32), 4 prompts of 512 tokens, 16 greedy ticks.
JAMBA_ARCH, JAMBA_LAYERS = "jamba_v0_1_52b", 8
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_TICKS = 4, 512, 16
#: Launches per prefill (one scan per Mamba layer); a tick launches none.
EXPECTED_JAMBA_PREFILL = {"selective_scan": 7}
#: Path F: qwen2.5-3b, the full config (36 layers, ~3.1 B params), behind
#: launch/serve.Server: 8 requests of 16-token prompts, 16 new tokens each.
SERVE_ARCH = "qwen2_5_3b"
SERVE_MAX_BATCH, SERVE_MAX_LEN = 4, 256
SERVE_REQUESTS, SERVE_PROMPT, SERVE_MAX_NEW = 8, 16, 16
#: Path G: whisper-tiny, the full config: the stem on (2, 3000, 80) mel,
#: prefill of 8 tokens with the frames, 8 greedy ticks.
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_TICKS = 2, 8, 8
#: The sweep of the other six architectures at full width, fp32, each
#: (arch, n_layers): granite-moe-3b-a800m whole (32 layers, 13.2 GB); the
#: rest cut to one scan unit, their full depth 137-1579 GB (qwen1.5-32b
#: 64 -> 1 layer, 8.3 GB; nemotron-4-340b 96 -> 1, 51.6 GB; yi-34b 60 ->
#: 1, 5.9 GB; chameleon-34b 48 -> 1, 7.1 GB; llama4-maverick 48 -> 2, the
#: 128-expert MoE layer and a dense one, 73.7 GB). Prefill of 8 tokens and
#: 4 teacher-forced ticks against forward_logits, then the main path's
#: prefill step and greedy ticks timed.
ARCH_SWEEP = (("qwen1_5_32b", 1), ("nemotron_4_340b", 1), ("yi_34b", 1),
              ("chameleon_34b", 1), ("granite_moe_3b_a800m", None),
              ("llama4_maverick_400b_a17b", 2))
ARCH_BATCH, ARCH_PROMPT, ARCH_TICKS = 2, 8, 4
#: Paths F and G and the sweep, fp32, TF32 off: prefill + decode ticks
#: against forward_logits on the same tokens, relative max-abs error by
#: position. The two sum in other orders (GEMV against GEMM rows, one
#: decode row of attention against the masked square); the CPU reads
#: 4e-7 to 7e-7 on the smoke configs (tests/test_torch_archs.py).
TOL_LM_SERVE = 1e-5


def lm_tokens(shape, vocab, seed, dev):
    import torch
    return torch.randint(0, vocab, shape, generator=torch.Generator()
                         .manual_seed(seed)).to(dev)


def by_position(steps, full, first: int) -> list[float]:
    """Relative error of each step's (B, V) logits against full[:, first
    + j]."""
    return [rel_err(s, full[:, first + j]) for j, s in enumerate(steps)]


def decode_run(serve_step, params, cache, tok, first: int, ticks: int,
               feed=None):
    """`ticks` decode steps from `cache` at positions first, first + 1, ...:
    greedy (tick 0 feeds `tok`, each later tick the last tick's argmax), or
    teacher-forced (tick i feeds feed[:, i]). Returns the ticks' logits
    and the tokens fed, (B, ticks)."""
    import torch
    steps, fed = [], []
    for i in range(ticks):
        if feed is not None:
            tok = feed[:, i:i + 1]
        fed.append(tok)
        logits, cache = serve_step(params, cache, tok, first + i)
        steps.append(logits)
        tok = logits.argmax(-1, keepdim=True)
    return steps, torch.cat(fed, 1)


def lm_generate(prefill_step, serve_step, params, prompt, ticks: int,
                label: str, expected_prefill: dict) -> tuple:
    """The LM main path: prefill the prompts, then `ticks` greedy ticks,
    every launch counter set to 0 just before each of the two and read
    just after; the prefill must launch `expected_prefill` and the ticks
    nothing (no LM decode step reaches a kernel). Returns the
    (B, 1 + ticks, V) logits (prefill's, then each tick's), the (B, ticks)
    decoded tokens and the counts by phase."""
    import torch
    reset_counts()
    logits0, cache = prefill_step(params, {"tokens": prompt})
    torch.cuda.synchronize()
    c_pre = read_counts()
    reset_counts()
    steps, tokens = decode_run(serve_step, params, cache,
                               logits0.argmax(-1, keepdim=True),
                               prompt.shape[1], ticks)
    torch.cuda.synchronize()
    c_dec = read_counts()
    log(f"[lm] {label}: launches in the prefill "
        f"{json.dumps({k: v for k, v in c_pre.items() if v})}, in {ticks} "
        f"decode ticks {json.dumps({k: v for k, v in c_dec.items() if v})}")
    if c_pre != {k: expected_prefill.get(k, 0) for k in KERNELS} or \
            any(c_dec.values()):
        raise AssertionError(f"{label}: expected {expected_prefill} "
                             f"launches per prefill and none per tick")
    logits = torch.stack([logits0] + steps, 1)
    if logits.shape != (*prompt.shape[:1], 1 + ticks, logits0.shape[-1]) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"{label}: bad logits {tuple(logits.shape)}")
    for row in tokens.tolist():
        log(f"[lm] {label} decoded: {row}")
    return logits, tokens, {f"{label} prefill": c_pre,
                            f"{label} {ticks} decode ticks": c_dec}


def lm_gate_scan(prefill_step, params, prompt, n_scans: int, label: str,
                 record: dict | None = None) -> tuple:
    """Gate (a): a prefill whose every scan runs the kernel and then its
    plain version on the same inputs (scan_checked, which holds each to
    TOL_SCAN), the errors only.
    Returns the logits and [largest rel err vs float64, largest abs err,
    largest rel err vs the fp32 plain version, largest fp32-plain vs
    float64]."""
    import torch
    scan_errs: list = []
    reset_counts()
    with scan_checked(scan_errs, record):
        logits, _ = prefill_step(params, {"tokens": prompt})
    torch.cuda.synchronize()
    n = read_counts()["selective_scan"]
    if n != n_scans or len(scan_errs) != n_scans:
        raise AssertionError(f"{label}: {n} scan launches, "
                             f"{len(scan_errs)} layers checked, expected "
                             f"{n_scans}")
    worst = [max(e[i] for e in scan_errs) for i in range(4)]
    log(f"[lm] {label} gate (a): each of the {n_scans} scans against its "
        f"plain version in float64 on the same inputs, largest rel err "
        f"{worst[0]:.3e} (layer "
        f"{max(range(n_scans), key=lambda i: scan_errs[i][0])}; tol "
        f"{TOL_SCAN}); against the fp32 plain version {worst[2]:.3e}, "
        f"which reads up to {worst[3]:.3e} from float64")
    return logits, worst


def split_profile(fn, label: str, ranges: tuple = (),
                  warm: bool = True) -> dict:
    """A torch.profiler split of one call of fn by kernel family, and the
    share of its wall time the device is busy; with `ranges`, also the
    device ms of the kernels launched inside each record_function range of
    those names that fn opens. `warm=False`: no call before the traced
    one."""
    families = dict.fromkeys(ranges, 0.0)
    by_name, wall_ms = profile_device(fn, runs=1, families=families,
                                      warm=warm)
    groups = {"selective_scan": 0.0, "gemm": 0.0, "gemv": 0.0,
              "elementwise, copy, reduce": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        if "scan_kernel" in low:
            group = "selective_scan"
        elif "gemv" in low or "gemmsn" in low:
            # cuBLAS's batched GEMV: in falcon's prefill the short conv's
            # 7-point transform einsums, in a decode tick the head
            group = "gemv"
        elif any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet")):
            group = "gemm"
        else:
            group = "elementwise, copy, reduce"
        groups[group] += ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {"wall_ms": wall_ms, "device_ms": busy,
           "busy_share": busy / wall_ms if wall_ms else None,
           "by_family_ms": groups,
           "top_kernels_ms": [[k[:100], v] for k, v in top]}
    if ranges:
        out["ranges_ms"] = families
    log(f"[profile] {label}: {json.dumps(out)}")
    return out


def time_lm(prefill_step, serve_step, params, prompt, ticks: int,
            label: str, profile: bool = True) -> dict:
    """Whole prefill (host clock around a synchronized call, median of 3)
    and decode ms per tick (median of 5 runs of `ticks` greedy ticks, each
    from the same prefilled cache; the decode step leaves its input cache
    as it was); with `profile`, a torch.profiler split of one prefill and
    of one tick."""
    import torch
    batch, length = prompt.shape
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, {"tokens": prompt})
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    prefill_ms = statistics.median(times)
    tok0, cache0 = logits.argmax(-1, keepdim=True), cache
    decode_runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_run(serve_step, params, cache0, tok0, length, ticks)
        torch.cuda.synchronize()
        decode_runs.append(1e3 * (time.perf_counter() - t0) / ticks)
    decode_ms = statistics.median(decode_runs)
    out = {"prefill_ms": prefill_ms, "prefill_ms_runs": times,
           "prefill_tokens_per_s": batch * length / (prefill_ms / 1e3),
           "decode_ms_per_tick": decode_ms,
           "decode_ms_per_tick_runs": decode_runs,
           "decode_tokens_per_s": batch / (decode_ms / 1e3),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[timing] {label}: {json.dumps(out)}")
    if profile:
        out["profile"] = {
            "prefill": split_profile(
                lambda: prefill_step(params, {"tokens": prompt}),
                f"{label} prefill"),
            "decode_tick": split_profile(
                lambda: serve_step(params, cache0, tok0, length),
                f"{label} decode tick")}
    return out


def decode_tick_bytes(params, cfg) -> float:
    """Bytes a decode tick must read in the port's formulation: every
    weight once (the head, or the tied embedding, whole; an untied
    embedding and learned positions only a row each, left out), but each
    MoE layer's expert matrices once per top-k pass (moe_block runs every
    expert in each of its top_k passes, dropless). Caches are left out."""
    total = 0.0
    for key, v in params.items():
        if key in ("encoder", "pos_emb") or (key == "embed"
                                             and not cfg.tie_embeddings):
            continue
        if key != "blocks":
            total += sum(t.nbytes for t in tree_leaves({key: v}))
            continue
        for layer in v.values():
            for name, sub in layer.items():
                if name == "moe":
                    total += sum(t.nbytes * (1 if k == "router"
                                             else cfg.moe.top_k)
                                 for k, t in sub.items())
                else:
                    total += sum(t.nbytes for t in tree_leaves(sub))
    return total


def lm_serving_phase(dev) -> tuple[dict, dict, dict]:
    """Phase 9: paths E (jamba), F (qwen2.5-3b behind Server), G
    (whisper-tiny) and the full-width sweep, fp32, TF32 off. Returns the
    report, the launch counts by path and, for the kernel table,
    selective_scan's gate (a) errors [max rel, max abs, max rel vs fp32
    plain] and its timing row at the jamba layer shape."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs as pt_cfgs
    from repro_torch.kernels import selective_scan as ks
    from repro_torch.launch import serve as pt_serve
    from repro_torch.launch import steps as pt_steps
    from repro_torch.models import audio
    from repro_torch.models import transformer as pt_tf

    report: dict = {"resident_gb_at_start":
                    torch.cuda.memory_allocated() / 1e9}
    log(f"[lm-serve] {report['resident_gb_at_start']:.2f} GB allocated on "
        f"the card before phase 9")
    counts_by_path: dict = {}

    def counted(label, fn, expected):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        counts_by_path[label] = counts
        if counts != {k: expected.get(k, 0) for k in KERNELS}:
            raise AssertionError(f"{label}: launches "
                                 f"{ {k: v for k, v in counts.items() if v} }"
                                 f", expected {expected}")
        return out

    def timed(fn, runs: int = 3):
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times), out

    def gate(label, errs, tol):
        if max(errs) > tol:
            raise AssertionError(f"{label}: {max(errs):.3e} > {tol}")
        log(f"[lm-serve] {label}: rel err by position "
            f"{[f'{e:.2e}' for e in errs]} (tol {tol})")
        return errs

    # ---- path E: jamba-v0.1-52b, one period at full width ------------------
    cfg = dataclasses.replace(pt_cfgs.get_config(JAMBA_ARCH),
                              n_layers=JAMBA_LAYERS)
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    n_moe = sum(map(cfg.layer_is_moe, range(cfg.n_layers)))
    n_mamba = kinds.count("mamba")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = pt_tf.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, torch.float32, device=dev)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    e = {"n_layers": cfg.n_layers, "reduced": "n_layers 32 -> 8",
         "n_params": sum(t.numel() for t in leaves),
         "params_gb": sum(t.nbytes for t in leaves) / 1e9,
         "init_s": time.perf_counter() - t0,
         "layers": {"attn": kinds.count("attn"), "mamba": n_mamba,
                    "moe": n_moe, "mlp": cfg.n_layers - n_moe}}
    del leaves
    log(f"[lm-serve] path E {cfg.name} fp32 on the card: {json.dumps(e)}")
    if e["layers"] != {"attn": 1, "mamba": 7, "moe": 4, "mlp": 4} or \
            {"selective_scan": n_mamba} != EXPECTED_JAMBA_PREFILL:
        raise AssertionError(f"path E: layer kinds {e['layers']}")
    prompt = lm_tokens((JAMBA_BATCH, JAMBA_PROMPT), cfg.vocab, 1, dev)
    max_len = JAMBA_PROMPT + JAMBA_TICKS
    prefill_step = pt_steps.make_prefill_step(cfg, max_len)
    serve_step = pt_steps.make_serve_step(cfg)
    # the main path: the bulk prefill, then greedy ticks
    logits, fed, counts = lm_generate(prefill_step, serve_step, params,
                                      prompt, JAMBA_TICKS, "path E jamba",
                                      EXPECTED_JAMBA_PREFILL)
    counts_by_path.update(counts)
    # gate (a): every Mamba layer's scan against its plain version
    record: dict = {}
    logits_a, scan = lm_gate_scan(prefill_step, params, prompt, n_mamba,
                                  "path E jamba", record)
    if not torch.equal(logits_a, logits[:, 0]):
        raise AssertionError("path E: two prefills of the same prompt "
                             "differ")
    e["gate_a_scan_rel_err"] = scan[0]
    # gate (b): the prefill logits against the model on the plain versions
    with plain_kernels():
        logits_b, _ = prefill_step(params, {"tokens": prompt})
    torch.cuda.synchronize()
    e["gate_b_plain_rel_err"] = rel_err(logits[:, 0], logits_b)
    log(f"[lm-serve] path E gate (b): prefill logits against the plain "
        f"versions {e['gate_b_plain_rel_err']:.3e} (tol {TOL_LM_PLAIN})")
    if e["gate_b_plain_rel_err"] > TOL_LM_PLAIN:
        raise AssertionError("path E: prefill disagrees with the "
                             "plain-kernel model")
    del logits_a, logits_b
    # gate (c): the serving prefill (dropless) + teacher-forced ticks on the
    # greedy tokens against forward_logits on all the tokens
    full = pt_tf.forward_logits(params, torch.cat([prompt, fed], 1), cfg)
    lg, cache = pt_tf.prefill(params, prompt, cfg, max_len)
    steps_c, _ = decode_run(serve_step, params, cache, None, JAMBA_PROMPT,
                            JAMBA_TICKS, feed=fed)
    e["gate_c_invariant_rel_err"] = gate(
        f"path E gate (c): prefill({JAMBA_PROMPT}, dropless) + "
        f"{JAMBA_TICKS} teacher-forced ticks against forward_logits on "
        f"{JAMBA_PROMPT + JAMBA_TICKS} tokens",
        by_position([lg] + steps_c, full, JAMBA_PROMPT - 1),
        TOL_LM_INVARIANT)
    # the main path's prefill routed capacity-bounded: its argmax against
    # the dropless forward's, reported
    e["argmax_agreement_bulk_vs_dropless"] = int(
        (full[:, JAMBA_PROMPT - 1:].argmax(-1) == logits.argmax(-1)).sum())
    del full, lg, cache, steps_c
    # timings and a profile of one prefill and one tick; the tick's bound:
    # the bytes it reads (the experts once per top-k pass) at PEAK_BYTES
    e.update(time_lm(prefill_step, serve_step, params, prompt, JAMBA_TICKS,
                     "path E jamba"))
    e["decode_tick_gb"] = decode_tick_bytes(params, cfg) / 1e9
    e["decode_tick_bound_ms"] = e["decode_tick_gb"] * 1e9 / PEAK_BYTES * 1e3
    e["decode_share_of_bound"] = e["decode_tick_bound_ms"] / \
        e["decode_ms_per_tick"]
    e["tokens"] = fed.tolist()
    # selective_scan at the jamba layer shape: layer 0's recorded inputs
    args = record["scan"]
    b, length, d = args[0].shape
    n = args[4].shape[1]
    bound, by = scan_bound(b, length, d, n, args[0].element_size(),
                           args[2].element_size())
    scan_row = dict(shape=[b, length, d, n],
                    blocking=ks.scan_blocking(b, d, n),
                    launches_per_prefill=n_mamba,
                    ms=cuda_ms(lambda: ks.selective_scan(*args), 20),
                    device_ms=graph_ms(lambda: ks.selective_scan(*args), 5, 5),
                    plain_ms=cuda_ms(lambda: ks.selective_scan_plain(
                        *args, chunk=cfg.ssm.scan_chunk), 2, warmup=1),
                    bound_ms=bound, bound_by=by, library_ms=None,
                    library_device_ms=None, path="E (jamba layer 0)")
    log(f"[timing] path E {json.dumps({k: v for k, v in e.items() if k not in ('tokens', 'profile')})}")
    log(f"[timing] selective_scan at the jamba layer shape: "
        f"{json.dumps(scan_row)}")
    report["path_e"] = e
    del params, record, args, logits
    torch.cuda.empty_cache()

    # ---- path F: qwen2.5-3b behind launch/serve.Server ---------------------
    cfg = pt_cfgs.get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params = pt_tf.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, torch.float32, device=dev)
    f = {"n_params": sum(t.numel() for t in tree_leaves(params)),
         "n_layers": cfg.n_layers}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=(SERVE_PROMPT,))
               for _ in range(SERVE_REQUESTS)]

    def served(max_batch, which):
        srv = pt_serve.Server(cfg, params, max_batch=max_batch,
                              max_len=SERVE_MAX_LEN, device=dev)
        reqs = [pt_serve.Request(rid=i, prompt=prompts[i],
                                 max_new=SERVE_MAX_NEW) for i in which]
        t0 = time.perf_counter()
        done, ticks = srv.run(reqs)
        return done, ticks, time.perf_counter() - t0, srv

    done, ticks, wall, srv = counted(
        f"path F {SERVE_ARCH} Server", lambda: served(
            SERVE_MAX_BATCH, range(SERVE_REQUESTS)), {})
    n_tok = sum(len(r.out) for r in done)
    steps_run = ticks + SERVE_REQUESTS * SERVE_PROMPT
    f.update({"requests": len(done), "tokens": n_tok, "ticks": ticks,
              "prefill_steps": SERVE_REQUESTS * SERVE_PROMPT, "wall_s": wall,
              "tokens_per_s": n_tok / wall,
              "ms_per_step": 1e3 * wall / steps_run})
    if len(done) != SERVE_REQUESTS or any(
            len(r.out) != SERVE_MAX_NEW for r in done):
        raise AssertionError(f"path F: {len(done)} requests completed")
    # the gate: a one-slot server's tokens for request 0 are greedy decoding
    # through prefill + decode_step (the server's first tick feeds the
    # prompt's last token again, at position len(prompt)), whose logits
    # are forward_logits'
    # one step of the 4-slot server (what every prefill token and tick
    # runs), profiled, beside the bytes it must read
    f["profile_step"] = split_profile(
        lambda: srv._step(np.zeros((SERVE_MAX_BATCH, 1), np.int64),
                          SERVE_PROMPT + SERVE_MAX_NEW),
        f"path F {SERVE_ARCH} server step")
    f["step_gb"] = decode_tick_bytes(params, cfg) / 1e9
    f["step_bound_ms"] = f["step_gb"] * 1e9 / PEAK_BYTES * 1e3
    del srv
    (one,), one_ticks, _, _ = served(1, [0])
    p0 = torch.as_tensor(prompts[0], device=dev).long()[None]
    _, cache = pt_tf.prefill(params, p0, cfg, SERVE_MAX_LEN)
    steps, fed = decode_run(pt_steps.make_serve_step(cfg), params, cache,
                            p0[:, -1:], SERVE_PROMPT, SERVE_MAX_NEW)
    greedy = [int(s.argmax(-1)) for s in steps]
    if one.out != greedy:
        raise AssertionError(f"path F: the one-slot server's tokens "
                             f"{one.out} differ from greedy decoding "
                             f"{greedy}")
    full = pt_tf.forward_logits(params, torch.cat([p0, fed], 1), cfg)
    f["gate_rel_err"] = gate(
        f"path F: the one-slot server's {one_ticks} ticks (greedy through "
        f"prefill + decode_step) against forward_logits",
        by_position(steps, full, SERVE_PROMPT), TOL_LM_SERVE)
    batched0 = next(r for r in done if r.rid == 0)
    f["request0_batched_equals_one_slot"] = batched0.out == one.out
    f["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[timing] path F {json.dumps(f)}")
    report["path_f"] = f
    del params, cache, full
    torch.cuda.empty_cache()

    # ---- path G: whisper-tiny, stem -> encoder -> decoder ------------------
    cfg = pt_cfgs.get_config("whisper_tiny")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = pt_tf.init_params(gen, cfg, torch.float32, device=dev)
    sp = audio.init_stem(gen, cfg, n_mels=STEM_MELS, device=dev)
    mel = torch.randn(WHISPER_BATCH, STEM_FRAMES, STEM_MELS, generator=gen,
                      device=dev)
    prompt = lm_tokens((WHISPER_BATCH, WHISPER_PROMPT), cfg.vocab, 3, dev)
    max_len = WHISPER_PROMPT + WHISPER_TICKS
    frames = counted("path G whisper stem", lambda: audio.stem(sp, mel), {})
    if frames.shape != (WHISPER_BATCH, cfg.encoder.n_ctx, cfg.d_model):
        raise AssertionError(f"path G: frames {tuple(frames.shape)}")
    serve_step = pt_steps.make_serve_step(cfg)
    lg, cache = counted("path G whisper prefill", lambda: pt_tf.prefill(
        params, prompt, cfg, max_len, frames=frames), {})
    steps, fed = counted(
        f"path G whisper {WHISPER_TICKS} decode ticks",
        lambda: decode_run(serve_step, params, cache,
                           lg.argmax(-1, keepdim=True), WHISPER_PROMPT,
                           WHISPER_TICKS), {})
    full = pt_tf.forward_logits(params, torch.cat([prompt, fed], 1), cfg,
                                frames=frames)
    g = {"frames": list(frames.shape)}
    g["gate_rel_err"] = gate(
        f"path G: prefill({WHISPER_PROMPT}, frames) + {WHISPER_TICKS} ticks "
        f"against forward_logits(frames=)",
        by_position([lg] + steps, full, WHISPER_PROMPT - 1), TOL_LM_SERVE)
    g["stem_ms"], _ = timed(lambda: audio.stem(sp, mel))
    g["prefill_ms"], _ = timed(lambda: pt_tf.prefill(
        params, prompt, cfg, max_len, frames=frames))
    tick_ms, _ = timed(lambda: decode_run(
        serve_step, params, cache, fed[:, :1], WHISPER_PROMPT,
        WHISPER_TICKS))
    g["decode_ms_per_tick"] = tick_ms / WHISPER_TICKS
    g["tokens"] = fed.tolist()
    log(f"[timing] path G {json.dumps(g)}")
    report["path_g"] = g
    del params, sp, mel, frames, cache, full

    # ---- the other six architectures at full width ------------------------
    sweep_rows = {}
    for arch, n_layers in ARCH_SWEEP:
        cfg = pt_cfgs.get_config(arch)
        reduced = None
        if n_layers is not None:
            reduced = f"n_layers {cfg.n_layers} -> {n_layers}"
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = pt_tf.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, torch.float32,
            device=dev)
        row = {"n_layers": cfg.n_layers, "reduced": reduced,
               "params_gb": sum(t.nbytes for t in tree_leaves(params)) / 1e9}
        seq = lm_tokens((ARCH_BATCH, ARCH_PROMPT + ARCH_TICKS), cfg.vocab,
                        4, dev)
        max_len = ARCH_PROMPT + ARCH_TICKS
        serve_step = pt_steps.make_serve_step(cfg)

        def run():
            lg, cache = pt_tf.prefill(params, seq[:, :ARCH_PROMPT], cfg,
                                      max_len)
            steps, _ = decode_run(serve_step, params, cache, None,
                                  ARCH_PROMPT, ARCH_TICKS,
                                  feed=seq[:, ARCH_PROMPT:])
            return [lg] + steps

        steps = counted(f"{arch} full width", run, {})
        full = pt_tf.forward_logits(params, seq, cfg)
        row["gate_rel_err"] = gate(
            f"{arch} at full width ({cfg.n_layers} layers): prefill("
            f"{ARCH_PROMPT}) + {ARCH_TICKS} ticks against forward_logits",
            by_position(steps, full, ARCH_PROMPT - 1), TOL_LM_SERVE)
        del steps, full
        row.update(time_lm(pt_steps.make_prefill_step(cfg, max_len),
                           serve_step, params, seq[:, :ARCH_PROMPT],
                           ARCH_TICKS, f"{arch} full width", profile=False))
        row["decode_tick_gb"] = decode_tick_bytes(params, cfg) / 1e9
        row["decode_tick_bound_ms"] = row["decode_tick_gb"] * 1e9 / \
            PEAK_BYTES * 1e3
        sweep_rows[arch] = row
        del params
    report["arch_sweep"] = sweep_rows
    torch.cuda.empty_cache()
    return report, counts_by_path, {"scan": scan, "scan_row": scan_row}


# ---------------------------------------------------------------------------
# phase 10: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "falcon_mamba_7b"
#: Gate (a): falcon-mamba-7b at full width (d_model 4096, d_inner 8192, N
#: 16, vocab 65024), n_layers 64 -> 1, one SyntheticLM batch of 2 x 512
#: tokens: the loss and every gradient leaf of the fp32 path (the scan
#: kernel's forward, TF32 off) against the same weights and batch in
#: float64 through the plain versions (float64_model).
GRAD_LAYERS, GRAD_BATCH, GRAD_SEQ = 1, 2, 512
#: Gate (a)'s limit on the loss's relative error and on each gradient
#: leaf's relative Frobenius error against float64. The CPU's fp32 port
#: reads 1e-6 to 8e-6 per leaf from the JAX package's fp32 gradients on
#: the smoke configs (tests/test_torch_train.py); at full width the sums
#: run over 8192 channels and 1024 tokens, and the kernel's ex2.approx
#: decays read 3.5e-6 from float64 (TOL_SCAN).
TOL_TRAIN_GRAD = 1e-4
#: Path H: falcon-mamba-7b at full width, n_layers 64 -> 8 (1.375 B
#: params: 8 x 105.3 M a layer and 532.7 M of untied embedding and head;
#: 5.50 GB at fp32, 22.0 GB with gradients and two AdamW moments), 4
#: SyntheticLM batches of 4 x 2048 tokens (path C's prefill shape), one
#: AdamW step each.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 4, 2048, 4
#: Launches per step: each Mamba layer's scan in the forward and again in
#: its unit's checkpoint recompute; the scan's backward is the plain
#: chunked scan, as the reference's.
EXPECTED_TRAIN_STEP = {"selective_scan": 2 * TRAIN_LAYERS}
#: accum_steps=2 against accum_steps=1 on the same batch and weights: the
#: mean of the two microbatches' losses (equal token counts) against the
#: loss over the batch, fp32 sums in another order (the CPU reads 1e-7).
TOL_TRAIN_ACCUM = 1e-5
#: Path I: whisper-tiny, the full config (39 M params, encoder-decoder),
#: through launch/train.train: 4 x 128 tokens with 1500 x 384 frames, 8
#: steps with a checkpoint every 4; then a fresh train() in a directory
#: holding only that run's step_4 resumes there.
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 4, 128
WHISPER_TRAIN_STEPS, WHISPER_TRAIN_EVERY = 8, 4
#: The resumed run's losses against the uninterrupted run's, relative:
#: the same fp32 weights, AdamW state and batches, restored bit for bit;
#: the steps agree up to atomics' order in the embeddings' backward.
TOL_TRAIN_RESTART = 1e-5


@contextlib.contextmanager
def float64_model():
    """The LM in float64, the training gate's oracle: every kernel replaced
    by its plain version (plain_kernels), the `.float()` casts of the
    plain versions and layers made no-ops (double_plain), and the fp32
    dtype the model modules cast to (`_F32` of models/mamba.py and
    models/transformer.py) set to float64. Params and batch in float64
    then run the same arithmetic in double precision."""
    import torch
    from repro_torch.models import mamba, transformer
    saved = {m: m._F32 for m in (mamba, transformer)}
    with plain_kernels(), double_plain():
        for m in saved:
            m._F32 = torch.float64
        try:
            yield
        finally:
            for m, dtype in saved.items():
                m._F32 = dtype


@contextlib.contextmanager
def train_ranges():
    """record_function ranges, for split_profile, around the scan's
    backward (the plain chunked recompute and its backward, in autograd's
    thread) and the AdamW update."""
    import torch
    from repro_torch.models import mamba
    from repro_torch.optim import adamw
    backward, update = mamba._SelectiveScan.backward, adamw.apply_updates

    def ranged_backward(ctx, *cotangents):
        with torch.profiler.record_function("scan backward"):
            return backward(ctx, *cotangents)

    def ranged_update(*args, **kwargs):
        with torch.profiler.record_function("optimizer"):
            return update(*args, **kwargs)

    mamba._SelectiveScan.backward = staticmethod(ranged_backward)
    adamw.apply_updates = ranged_update
    try:
        yield
    finally:
        mamba._SelectiveScan.backward = staticmethod(backward)
        adamw.apply_updates = update


def training_phase(dev) -> tuple[dict, dict]:
    """Phase 10: gate (a) (falcon's gradients at full width against
    float64), path H (falcon training at full width, 8 layers) and path I
    (whisper-tiny's train driver, checkpoint and restart), fp32, TF32 off.
    Returns the report and the launch counts by path."""
    import dataclasses
    import os
    import tempfile

    import torch
    from repro_torch import configs as pt_cfgs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import steps as pt_steps
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as pt_tf
    from repro_torch.optim import adamw
    from repro_torch import tree as pt_tree

    report: dict = {"resident_gb_at_start":
                    torch.cuda.memory_allocated() / 1e9}
    log(f"[train] {report['resident_gb_at_start']:.2f} GB allocated on the "
        f"card before phase 10")
    counts_by_path: dict = {}

    def counted(label, fn, expected):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        counts_by_path[label] = counts
        if counts != {k: expected.get(k, 0) for k in KERNELS}:
            raise AssertionError(f"{label}: launches "
                                 f"{ {k: v for k, v in counts.items() if v} }"
                                 f", expected {expected}")
        return out

    def on_card(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def falcon(n_layers):
        cfg = dataclasses.replace(pt_cfgs.get_config(TRAIN_ARCH),
                                  n_layers=n_layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return cfg, pt_tf.init_params(
            torch.Generator(device=dev).manual_seed(0), cfg, torch.float32,
            device=dev)

    # ---- (a) the gradient gate: one layer at full width against float64 --
    cfg, params = falcon(GRAD_LAYERS)
    batch = on_card(SyntheticLM(cfg, GRAD_BATCH, GRAD_SEQ).batch_at(0))
    loss_and_grads = pt_steps.make_loss_and_grads(cfg)
    loss, grads = counted("gate (a) fp32 loss and gradients",
                          lambda: loss_and_grads(params, batch),
                          {"selective_scan": 2 * GRAD_LAYERS})
    params64 = pt_tree.tree_map(torch.Tensor.double, params)
    del params
    with float64_model():
        loss64, grads64 = loss_and_grads(params64, batch)
    del params64
    g64 = dict(pt_tree.tree_flatten_with_path(grads64))
    errs = {k: float((g.double() - g64[k]).norm()
                     / g64[k].norm().clamp_min(1e-300))
            for k, g in pt_tree.tree_flatten_with_path(grads)}
    worst = max(errs, key=errs.get)
    a = {"n_layers": GRAD_LAYERS, "reduced": f"n_layers 64 -> {GRAD_LAYERS}",
         "batch": [GRAD_BATCH, GRAD_SEQ], "loss": float(loss),
         "loss_float64": float(loss64),
         "loss_rel_err": abs(float(loss) - float(loss64)) / abs(float(loss64)),
         "worst_leaf": worst, "worst_leaf_rel_frob_err": errs[worst],
         "leaf_rel_frob_err": errs, "tol": TOL_TRAIN_GRAD}
    log(f"[train] gate (a): falcon-mamba-7b 1 layer, {GRAD_BATCH} x "
        f"{GRAD_SEQ}, fp32 kernel path against float64 plain: loss "
        f"{a['loss']:.6f} vs {a['loss_float64']:.6f} (rel err "
        f"{a['loss_rel_err']:.3e}), worst gradient leaf {worst} "
        f"{errs[worst]:.3e} (tol {TOL_TRAIN_GRAD}); {json.dumps(errs)}")
    if a["loss_rel_err"] > TOL_TRAIN_GRAD or errs[worst] > TOL_TRAIN_GRAD:
        raise AssertionError("gate (a): the fp32 gradients disagree with "
                             "float64")
    report["gate_a"] = a
    del grads, grads64, g64, loss_and_grads

    # ---- path H: falcon-mamba-7b training at full width, 8 layers ---------
    cfg, params = falcon(TRAIN_LAYERS)
    n_params = sum(t.numel() for t in pt_tree.tree_leaves(params))
    h = {"n_layers": TRAIN_LAYERS,
         "reduced": f"n_layers 64 -> {TRAIN_LAYERS}",
         "batch": [TRAIN_BATCH, TRAIN_SEQ], "n_params": n_params,
         "params_gb": 4 * n_params / 1e9,
         "params_grads_adamw_gb": 16 * n_params / 1e9}
    opt_cfg = adamw.AdamWConfig(total_steps=TRAIN_STEPS,
                                warmup_steps=max(TRAIN_STEPS // 20, 5))
    step_fn = pt_steps.make_train_step(cfg, opt_cfg)
    pipeline = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ)
    batches = [on_card(pipeline.batch_at(i)) for i in range(TRAIN_STEPS)]
    state = adamw.init_state(params, opt_cfg)
    times, losses, metrics = [], [], []

    def timed_step(i, params, state):
        t0 = time.perf_counter()
        out = counted(f"path H falcon train step {i}",
                      lambda: step_fn(params, state, batches[i]),
                      EXPECTED_TRAIN_STEP)
        times.append(1e3 * (time.perf_counter() - t0))
        m = {k: float(v) for k, v in out[2].items()}
        metrics.append(m)
        losses.append(m["loss"])
        return out[0], out[1]

    # accumulation: the first step with its batch in two microbatches, from
    # the same weights and state (its new trees dropped at once: the peak
    # holds one step's old and new trees, not two steps')
    m_acc = counted(
        "path H falcon accum_steps=2",
        lambda: pt_steps.make_train_step(cfg, opt_cfg, accum_steps=2)(
            params, state, batches[0])[2],
        {"selective_scan": 4 * TRAIN_LAYERS})
    h["accum2_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        params, state = timed_step(i, params, state)
    h["accum2_loss"] = float(m_acc["loss"])
    h["accum2_rel_err"] = abs(h["accum2_loss"] - losses[0]) / abs(losses[0])
    log(f"[train] path H: accum_steps=2 loss {h['accum2_loss']:.6f} against "
        f"accum_steps=1 {losses[0]:.6f}, rel err {h['accum2_rel_err']:.3e} "
        f"(tol {TOL_TRAIN_ACCUM})")
    if h["accum2_rel_err"] > TOL_TRAIN_ACCUM:
        raise AssertionError("path H: accumulation moved the loss")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"path H: losses {losses}")
    h.update({"losses": losses, "metrics": metrics, "step_ms_runs": times,
              "step_ms": statistics.median(times),
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
              / (statistics.median(times) / 1e3),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches_per_step": EXPECTED_TRAIN_STEP})
    log(f"[timing] path H "
        f"{json.dumps({k: v for k, v in h.items() if k != 'metrics'})}")
    with train_ranges():
        h["profile_step"] = split_profile(
            lambda: step_fn(params, state, batches[0]),
            "path H falcon train step", ranges=("scan backward",
                                                "optimizer"))
    # one step at bf16: the same weights, the reference's fp32 leaves kept
    params = cast_like_init(params, torch.bfloat16)
    del state
    torch.cuda.empty_cache()
    loss_and_grads = pt_steps.make_loss_and_grads(cfg)
    t0 = time.perf_counter()
    loss, grads = counted("path H falcon bf16 loss and gradients",
                          lambda: loss_and_grads(params, batches[0]),
                          EXPECTED_TRAIN_STEP)
    new_params, _ = adamw.apply_updates(params, grads,
                                        adamw.init_state(params, opt_cfg),
                                        opt_cfg)
    torch.cuda.synchronize()
    bad = [k for (k, g), p in zip(pt_tree.tree_flatten_with_path(grads),
                                  pt_tree.tree_leaves(params))
           if g.dtype != p.dtype or not torch.isfinite(g).all()]
    bad += [k for k, p in pt_tree.tree_flatten_with_path(new_params)
            if not torch.isfinite(p.float()).all()]
    h["bf16"] = {"loss": float(loss), "ms": 1e3 * (time.perf_counter() - t0),
                 "grad_dtypes": sorted({str(g.dtype) for g in
                                        pt_tree.tree_leaves(grads)})}
    log(f"[train] path H bf16 step: {json.dumps(h['bf16'])}")
    if bad or not math.isfinite(float(loss)):
        raise AssertionError(f"path H bf16: bad gradient or update leaves "
                             f"{bad}")
    report["path_h"] = h
    del params, grads, new_params, batches, loss_and_grads
    torch.cuda.empty_cache()

    # ---- path I: whisper-tiny through the train driver, with a restart ----
    kw = dict(steps=WHISPER_TRAIN_STEPS, batch=WHISPER_TRAIN_BATCH,
              seq=WHISPER_TRAIN_SEQ, smoke=False,
              ckpt_every=WHISPER_TRAIN_EVERY, device=dev,
              log_every=WHISPER_TRAIN_EVERY)
    k = WHISPER_TRAIN_EVERY
    with tempfile.TemporaryDirectory() as tmp:
        whole, resumed = os.path.join(tmp, "whole"), os.path.join(tmp,
                                                                  "resumed")
        t0 = time.perf_counter()
        (p_whole, _), h_whole = counted(
            "path I whisper train", lambda: train("whisper_tiny",
                                                  ckpt_dir=whole, **kw), {})
        whole_s = time.perf_counter() - t0
        steps_saved = CheckpointManager(whole).steps()
        shutil.copytree(os.path.join(whole, f"step_{k}"),
                        os.path.join(resumed, f"step_{k}"))
        t0 = time.perf_counter()
        (p_res, _), h_res = counted(
            "path I whisper train resumed", lambda: train(
                "whisper_tiny", ckpt_dir=resumed, **kw), {})
        resumed_s = time.perf_counter() - t0
        cfg_w = pt_cfgs.get_config("whisper_tiny")
        like = pt_tf.abstract_params(cfg_w, torch.float32)
        like = {"params": like,
                "opt": adamw.init_state(like, adamw.AdamWConfig())}
        restored = CheckpointManager(resumed).restore(k, like)
        devices = sorted({t.device.type
                          for t in pt_tree.tree_leaves(restored)})
        ckpt_mb = sum(os.path.getsize(os.path.join(whole, f"step_{k}", f))
                      for f in os.listdir(os.path.join(whole, f"step_{k}"))
                      ) / 1e6
    errs = [abs(a - b) / abs(b) for a, b in zip(h_res, h_whole[k:])]
    final = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(pt_tree.tree_leaves(p_res),
                                pt_tree.tree_leaves(p_whole)))
    i_rep = {"n_params": sum(t.numel()
                             for t in pt_tree.tree_leaves(p_whole)),
             "batch": [WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ],
             "steps": WHISPER_TRAIN_STEPS, "ckpt_every": k,
             "checkpoints": steps_saved, "checkpoint_mb": ckpt_mb,
             "losses": h_whole, "resumed_losses": h_res,
             "resumed_rel_err": errs, "final_params_rel_err": final,
             "restored_devices": devices, "whole_s": whole_s,
             "resumed_s": resumed_s}
    log(f"[train] path I whisper-tiny: {json.dumps(i_rep)}")
    if len(h_res) != WHISPER_TRAIN_STEPS - k or max(errs) > \
            TOL_TRAIN_RESTART or devices != [dev.type] or \
            steps_saved != [k, WHISPER_TRAIN_STEPS] or \
            not all(map(math.isfinite, h_whole)):
        raise AssertionError("path I: the resumed run differs from the "
                             "uninterrupted one")
    report["path_i"] = i_rep
    del p_whole, p_res, restored
    torch.cuda.empty_cache()
    return report, counts_by_path


# ---------------------------------------------------------------------------
# phase 11: the LM's meshes
# ---------------------------------------------------------------------------

#: Path (a): falcon-mamba-7b at full width, n_layers 64 -> 8 (path H's
#: weights, drawn again from its seed, and its first 4 x 2048 batch),
#: placed by param_shardings on make_host_mesh(2, devices=[card] * 4), a
#: (2, 2) mesh on one card; MESH_STEPS AdamW steps of the sharded step,
#: tensor-parallel over the model axis.
MESH_STEPS = 2
#: Launches per sharded step: each Mamba layer's scan in the forward and
#: in its unit's checkpoint recompute, once per model position (2) of each
#: data group (2), each on its position's d_in / 2 = 4096 channels.
EXPECTED_MESH_STEP = {"selective_scan": 2 * TRAIN_LAYERS * 2 * 2}
#: The sharded step against the unsharded one on the same weights and
#: batch: the loss (relative), each gathered gradient leaf (relative
#: Frobenius) and the AdamW update on the same gradients (relative
#: max-abs per leaf). The same fp32 arithmetic with the batch's sums split
#: by data group and the norm summed by piece (the CPU reads <= 1.5e-7,
#: <= 5.5e-7 and <= 1e-7 at the smoke configs,
#: tests/test_torch_train_mesh.py).
TOL_MESH_LOSS, TOL_MESH_GRAD, TOL_MESH_UPDATE = 1e-6, 1e-5, 1e-6


@contextlib.contextmanager
def sharding_ranges():
    """record_function ranges, for split_profile, around the gathers of
    placed leaves (Placed.region, which Placed.gather and a model
    position's compute view read through: the copies onto the computing
    device, in the forward and in the checkpoint recompute), the model
    axis's collectives (context.all_reduce / all_gather / reduce_scatter:
    "collective") and the scatter of the gradients onto the pieces (the
    gradient tree built from the pieces' gradients: the per-unit stacking
    and the copies to replicas)."""
    import torch
    from repro_torch.distributed import context
    from repro_torch.distributed.sharding import Placed
    from repro_torch.launch import steps
    region, grad_view = Placed.region, steps._grad_view
    colls = {name: getattr(context, name)
             for name in ("all_reduce", "all_gather", "reduce_scatter")}

    def ranged_region(self, sel, device):
        with torch.profiler.record_function("gather"):
            return region(self, sel, device)

    def ranged_collective(fn):
        def run(*args, **kw):
            with torch.profiler.record_function("collective"):
                return fn(*args, **kw)
        return run

    def ranged_view(params, positions=None):
        leaves, tree, grads_of = grad_view(params, positions)

        def ranged(grads):
            with torch.profiler.record_function("scatter"):
                return grads_of(grads)
        return leaves, tree, ranged

    Placed.region, steps._grad_view = ranged_region, ranged_view
    for name, fn in colls.items():
        setattr(context, name, ranged_collective(fn))
    try:
        yield
    finally:
        Placed.region, steps._grad_view = region, grad_view
        for name, fn in colls.items():
            setattr(context, name, fn)


def replica_pairs(tree) -> int:
    """The pieces that replicate another piece of their leaf on another
    device, each checked bitwise equal to the first; their number."""
    import torch
    from repro_torch.distributed.sharding import Placed
    from repro_torch.tree import tree_leaves as leaves_of_tree
    n = 0
    for leaf in leaves_of_tree(tree):
        if not isinstance(leaf, Placed):
            continue
        first = leaf.primaries()
        for (index, _), t in leaf.pieces.items():
            if t is not first[index]:
                if not torch.equal(t.to(first[index].device), first[index]):
                    raise AssertionError(f"replicas of {leaf} differ")
                n += 1
    return n


def mesh_phase(dev, path_h_ms: float | None = None,
               path_f_ms: float | None = None) -> tuple[dict, dict]:
    """Phase 11: (a) falcon's sharded train step on a (2, 2) mesh on one
    card against the unsharded step, (b) whisper-tiny's train() on
    (4, 1) restored elastically onto (2, 2), (c) qwen2.5-3b's Server on
    params placed on (2, 2) against the mesh-less server; fp32, TF32 off.
    The cost of a mesh on one card, not a scaling. Returns the report and
    the launch counts by path."""
    import dataclasses
    import gc
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch import configs as pt_cfgs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import serve as pt_serve
    from repro_torch.launch import steps as pt_steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import transformer as pt_tf
    from repro_torch.optim import adamw
    from repro_torch import tree as pt_tree

    report: dict = {"resident_gb_at_start":
                    torch.cuda.memory_allocated() / 1e9}
    counts_by_path: dict = {}

    def counted(label, fn, expected):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        counts_by_path[label] = counts
        if counts != {k: expected.get(k, 0) for k in KERNELS}:
            raise AssertionError(f"{label}: launches "
                                 f"{ {k: v for k, v in counts.items() if v} }"
                                 f", expected {expected}")
        return out

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    mesh22 = make_host_mesh(2, devices=[dev] * 4)
    mesh41 = make_host_mesh(1, devices=[dev] * 4)

    # ---- (a) falcon-mamba-7b: the sharded step against the unsharded ------
    cfg = dataclasses.replace(pt_cfgs.get_config(TRAIN_ARCH),
                              n_layers=TRAIN_LAYERS)
    torch.cuda.empty_cache()
    params = pt_tf.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, torch.float32, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ).batch_at(0).items()}
    opt_cfg = adamw.AdamWConfig(total_steps=TRAIN_STEPS,
                                warmup_steps=max(TRAIN_STEPS // 20, 5))
    shardings = shd.param_shardings(params, cfg, mesh22)
    placed = shd.device_put(params, shardings)
    sharded = pt_steps.make_sharded_loss_and_grads(cfg, mesh22)

    def peaked(fn):
        """fn's result and the peak it allocated above what was resident
        (GB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        out = fn()
        return out, (torch.cuda.max_memory_allocated() - resident) / 1e9

    # the sharded loss and gradients first, profiled (it also warms the
    # path up), then the unsharded ones timed
    out = []
    with sharding_ranges():
        profile, peak_s = peaked(lambda: split_profile(
            lambda: out.append(counted(
                "mesh (a) falcon sharded loss and gradients (profiled)",
                lambda: sharded(placed, batch), EXPECTED_MESH_STEP)),
            "mesh (a) falcon sharded loss and gradients",
            ranges=("gather", "collective", "scatter"), warm=False))
    loss_s, grads_s = out[0]
    del out
    ((loss_u, grads_u), lg_ms), peak_u = peaked(lambda: timed(
        lambda: counted("mesh (a) falcon unsharded loss and gradients",
                        lambda: pt_steps.make_loss_and_grads(cfg)(params,
                                                                  batch),
                        {"selective_scan": 2 * TRAIN_LAYERS})))
    a = {"mesh": list(mesh22.axis_sizes), "n_layers": TRAIN_LAYERS,
         "batch": [TRAIN_BATCH, TRAIN_SEQ],
         "pieces": sum(len(t.pieces) for t in pt_tree.tree_leaves(placed)),
         "loss_unsharded": float(loss_u), "loss_sharded": float(loss_s),
         "loss_rel_err": abs(float(loss_s) - float(loss_u))
         / abs(float(loss_u)), "unsharded_loss_and_grads_ms": lg_ms,
         "loss_and_grads_peak_over_resident_gb": {"sharded": peak_s,
                                                  "unsharded": peak_u},
         "profile_sharded_loss_and_grads": profile}
    g_u = dict(pt_tree.tree_flatten_with_path(grads_u))
    errs = {k: float((g.gather(dev) - g_u[k]).norm()
                     / g_u[k].norm().clamp_min(1e-30))
            for k, g in pt_tree.tree_flatten_with_path(grads_s)}
    worst = max(errs, key=errs.get)
    a.update({"worst_grad_leaf": worst, "worst_grad_rel_frob_err":
              errs[worst], "grad_rel_frob_err": errs})
    del grads_s
    # the update on the same gradients, unsharded and on the pieces
    # (the new states are dropped at once: they must not stay resident
    # through the steps measured below)
    new_u, upd_ms = timed(lambda: adamw.apply_updates(
        params, grads_u, adamw.init_state(params, opt_cfg), opt_cfg)[0])
    new_s = adamw.apply_updates(
        placed, shd.device_put(grads_u, shardings),
        adamw.init_state(placed, opt_cfg), opt_cfg)[0]
    n_u = dict(pt_tree.tree_flatten_with_path(new_u))
    upd = max(float((p.gather(dev) - n_u[k]).abs().max()
                    / n_u[k].abs().max().clamp_min(1e-30))
              for k, p in pt_tree.tree_flatten_with_path(new_s))
    # the unsharded times run with the placed copy and the sharded
    # gradients resident, so the allocator may stall them: path H is the
    # step to compare with
    a.update({"update_rel_err": upd, "unsharded_update_ms": upd_ms})
    del new_u, new_s, n_u, grads_u, g_u, params
    # the unsharded loss_and_grads leaves its gradient tree in reference
    # cycles (through its checkpoint frames) that only the collector
    # frees; free them before the steps are measured
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    step_fn = pt_steps.make_train_step(cfg, opt_cfg, mesh=mesh22)
    state = adamw.init_state(placed, opt_cfg)
    a["resident_gb_before_steps"] = torch.cuda.memory_allocated() / 1e9
    times, losses = [], []
    for i in range(MESH_STEPS):
        (placed, state, metrics), ms = timed(lambda: counted(
            f"mesh (a) falcon sharded train step {i}",
            lambda: step_fn(placed, state, batch), EXPECTED_MESH_STEP))
        times.append(ms)
        losses.append(float(metrics["loss"]))
    a.update({"step_ms_runs": times, "step_ms": statistics.median(times),
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
              / (statistics.median(times) / 1e3), "losses": losses,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "replica_pairs_checked": replica_pairs((placed, state.m,
                                                      state.v)),
              "path_h_step_ms": path_h_ms,
              "launches_per_step": EXPECTED_MESH_STEP, "tol": {
                  "loss": TOL_MESH_LOSS, "grad": TOL_MESH_GRAD,
                  "update": TOL_MESH_UPDATE}})
    ranges = profile.get("ranges_ms", {})
    a["copy_share_of_device"] = (
        (ranges.get("gather", 0.0) + ranges.get("collective", 0.0)
         + ranges.get("scatter", 0.0))
        / profile["device_ms"] if profile["device_ms"] else None)
    # one scan at the width a model position runs (d_in / 2 channels of
    # one data group's rows) against its plain version in float64
    from repro_torch.kernels import selective_scan as ks
    d_half = cfg.ssm.expand * cfg.d_model // mesh22.shape["model"]
    rows = TRAIN_BATCH // mesh22.shape["data"]
    args = scan_inputs(rows, TRAIN_SEQ, d_half, cfg.ssm.d_state,
                       torch.float32, torch.float32,
                       torch.Generator(device=dev).manual_seed(3), dev)
    scan_err, scan_abs, scan_err32, plain_err = scan_errors(
        "mesh (a) half-width selective_scan",
        ks.selective_scan(*args), args)
    a["half_width_scan"] = {"shape": [rows, TRAIN_SEQ, d_half,
                                      cfg.ssm.d_state],
                            "rel_err_f64": scan_err, "abs_err": scan_abs,
                            "rel_err_fp32_plain": scan_err32,
                            "plain_fp32_rel_err_f64": plain_err,
                            "tol": TOL_SCAN}
    del args
    if path_h_ms:
        a["step_over_path_h"] = a["step_ms"] / path_h_ms
    log(f"[timing] mesh (a) "
        f"{json.dumps({k: v for k, v in a.items() if k not in ('grad_rel_frob_err', 'profile_sharded_loss_and_grads')})}")
    if a["loss_rel_err"] > TOL_MESH_LOSS or errs[worst] > TOL_MESH_GRAD or \
            upd > TOL_MESH_UPDATE or not all(map(math.isfinite, losses)):
        raise AssertionError("mesh (a): the sharded step disagrees with the "
                             "unsharded one")
    report["a"] = a
    del placed, state, metrics, step_fn, batch
    torch.cuda.empty_cache()

    # ---- (b) whisper-tiny's train(): (4, 1), then resumed on (2, 2) -------
    kw = dict(steps=WHISPER_TRAIN_STEPS, batch=WHISPER_TRAIN_BATCH,
              seq=WHISPER_TRAIN_SEQ, smoke=False,
              ckpt_every=WHISPER_TRAIN_EVERY, log_every=WHISPER_TRAIN_EVERY)
    k = WHISPER_TRAIN_EVERY
    with tempfile.TemporaryDirectory() as tmp:
        whole, resumed = (os.path.join(tmp, "whole"),
                          os.path.join(tmp, "resumed"))
        (_, h_whole), whole_ms = timed(lambda: counted(
            "mesh (b) whisper train (4, 1)", lambda: train(
                "whisper_tiny", ckpt_dir=whole, mesh=mesh41, **kw), {}))
        shutil.copytree(os.path.join(whole, f"step_{k}"),
                        os.path.join(resumed, f"step_{k}"))
        (_, h_res), res_ms = timed(lambda: counted(
            "mesh (b) whisper train resumed on (2, 2)", lambda: train(
                "whisper_tiny", ckpt_dir=resumed, mesh=mesh22, **kw), {}))
        cfg_w = pt_cfgs.get_config("whisper_tiny")
        like = pt_tf.abstract_params(cfg_w, torch.float32)
        p_shard = shd.param_shardings(like, cfg_w, mesh22)
        restored = CheckpointManager(resumed).restore(
            k, {"params": like}, {"params": p_shard})["params"]
    misplaced = []
    card = mesh22.devices[0]
    for key, t in pt_tree.tree_flatten_with_path(restored):
        counts = t.sharding.counts(t.ndim)
        want = tuple(s // c for s, c in zip(t.shape, counts))
        misplaced += [key for (_, d), piece in t.pieces.items()
                      if d != card or piece.device != card
                      or tuple(piece.shape) != want]
    errs_b = [abs(x - y) / abs(y) for x, y in zip(h_res, h_whole[k:])]
    b = {"meshes": [list(mesh41.axis_sizes), list(mesh22.axis_sizes)],
         "batch": [WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ],
         "losses": h_whole, "resumed_losses": h_res,
         "resumed_rel_err": errs_b, "misplaced_pieces": misplaced,
         "pieces": sum(len(t.pieces) for t in pt_tree.tree_leaves(restored)),
         "whole_ms": whole_ms, "resumed_ms": res_ms}
    log(f"[train] mesh (b) whisper-tiny: {json.dumps(b)}")
    if len(h_res) != WHISPER_TRAIN_STEPS - k or max(errs_b) > \
            TOL_TRAIN_RESTART or misplaced or \
            not all(map(math.isfinite, h_whole)):
        raise AssertionError("mesh (b): the elastic restart differs")
    report["b"] = b
    del restored

    # ---- (c) qwen2.5-3b behind Server(mesh=) on placed params --------------
    cfg = pt_cfgs.get_config(SERVE_ARCH)
    params = pt_tf.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, torch.float32, device=dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=(SERVE_PROMPT,))
               for _ in range(SERVE_REQUESTS)]

    def served(p, **where):
        srv = pt_serve.Server(cfg, p, max_batch=SERVE_MAX_BATCH,
                              max_len=SERVE_MAX_LEN, **where)
        (done, ticks), ms = timed(lambda: srv.run([
            pt_serve.Request(rid=i, prompt=prompts[i], max_new=SERVE_MAX_NEW)
            for i in range(SERVE_REQUESTS)]))
        steps_run = ticks + SERVE_REQUESTS * SERVE_PROMPT
        return {r.rid: r.out for r in done}, ms / steps_run

    want, plain_ms = counted("mesh (c) qwen Server", lambda: served(
        params, device=dev), {})
    placed = shd.device_put(params, shd.param_shardings(params, cfg, mesh22))
    del params
    torch.cuda.empty_cache()
    got, mesh_ms = counted("mesh (c) qwen Server(mesh=) placed on (2, 2)",
                           lambda: served(placed, mesh=mesh22), {})
    c = {"mesh": list(mesh22.axis_sizes), "requests": SERVE_REQUESTS,
         "tokens_equal": got == want, "ms_per_step": mesh_ms,
         "meshless_ms_per_step": plain_ms, "path_f_ms_per_step": path_f_ms,
         "over_meshless": mesh_ms / plain_ms}
    log(f"[timing] mesh (c) {json.dumps(c)}")
    if got != want or len(got) != SERVE_REQUESTS:
        raise AssertionError(f"mesh (c): Server(mesh=) tokens {got} differ "
                             f"from the mesh-less server's {want}")
    report["c"] = c
    del placed
    torch.cuda.empty_cache()
    return report, counts_by_path


#: Phase 12's gates: the dry run of path H against one real path H step,
#: fp32 with TF32 off: the matmul FLOPs (relative to FlopCounterMode's;
#: both count the same aten products of the same program) and the peak,
#: argument + temp, relative to the step's measured one (the CUDA caching
#: allocator rounds each block up and keeps cuBLAS workspaces the dry run
#: does not model).
TOL_DRYRUN_FLOPS, TOL_DRYRUN_PEAK = 1e-3, 0.2


def tensor_bytes(tree) -> int:
    """Bytes of the tensors of a tree (dicts, lists, tuples)."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def dryrun_phase(dev, path_h_ms: float | None = None,
                 mesh_report: dict | None = None) -> tuple[dict, dict]:
    """Phase 12: path H's configuration dry-run on "meta" tensors
    (launch/dryrun.trace_step) against one real path H step on the card:
    the launches, the matmul FLOPs and the peak gated; the roofline time
    beside path H's measured ms (`path_h_ms`, phase 10's; the step here
    runs under FlopCounterMode, whose time is reported apart), and phase
    11 (a)'s (2, 2) step, dry-run on one device, beside `mesh_report`'s
    measured peak. Returns the report and the launch counts of the real
    step."""
    import dataclasses
    import gc

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import configs as pt_cfgs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as pt_steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as pt_tf
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(pt_cfgs.get_config(TRAIN_ARCH),
                              n_layers=TRAIN_LAYERS)
    opt_cfg = adamw.AdamWConfig(total_steps=TRAIN_STEPS,
                                warmup_steps=max(TRAIN_STEPS // 20, 5))
    t0 = time.perf_counter()
    traced = dryrun.trace_step(cfg, "train", TRAIN_SEQ, TRAIN_BATCH,
                               dtype=torch.float32, opt_cfg=opt_cfg)
    pred = dryrun.record_of(traced, 1, arch=TRAIN_ARCH, kind="train",
                            seq=TRAIN_SEQ, batch=TRAIN_BATCH)
    dry_s = time.perf_counter() - t0
    pred_mm = pred["roofline"]["flops_by_unit"].get("fp32", 0.0)

    torch.cuda.empty_cache()
    params = pt_tf.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, torch.float32, device=dev)
    state = adamw.init_state(params, opt_cfg)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ).batch_at(0).items()}
    step = pt_steps.make_train_step(cfg, opt_cfg)
    argument = tensor_bytes((params, tuple(state), batch))

    # one step under FlopCounterMode, from the resident params and moments
    # after gc.collect() and reset_peak_memory_stats(): its launches, its
    # matmul FLOPs and its peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as counter:
        out = step(params, state, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = read_counts()
    growth = torch.cuda.max_memory_allocated() - before
    flops = float(counter.get_total_flops())
    loss = float(out[2]["loss"])
    del out, params, state, batch
    gc.collect()
    torch.cuda.empty_cache()

    mem = pred["memory"]
    measured_peak = argument + growth
    launches_ok = all(pred["launches"].get(k, 0) == v
                      for k, v in counts.items()) and \
        set(pred["launches"]) <= {k for k, v in counts.items() if v}
    a = {"arch": TRAIN_ARCH, "n_layers": TRAIN_LAYERS,
         "batch": [TRAIN_BATCH, TRAIN_SEQ], "dry_run_s": dry_s,
         "launches_predicted": pred["launches"],
         "launches_measured": {k: v for k, v in counts.items() if v},
         "matmul_flops_predicted": pred_mm, "matmul_flops_measured": flops,
         "matmul_flops_rel_err": abs(pred_mm - flops) / max(flops, 1.0),
         "argument_gb_predicted": mem["argument_size_in_bytes"] / 1e9,
         "argument_gb_measured": argument / 1e9,
         "temp_gb_predicted": mem["temp_size_in_bytes"] / 1e9,
         "growth_gb_measured": growth / 1e9,
         "peak_gb_predicted": mem["peak_bytes"] / 1e9,
         "peak_gb_measured": measured_peak / 1e9,
         "peak_rel_err": abs(mem["peak_bytes"] - measured_peak)
         / measured_peak, "temp_peak_at": mem["temp_peak_at"],
         "roofline_ms": 1e3 * pred["roofline"]["t_roofline_s"],
         "t_compute_ms": 1e3 * pred["roofline"]["t_compute_s"],
         "t_memory_ms": 1e3 * pred["roofline"]["t_memory_s"],
         "bottleneck": pred["roofline"]["bottleneck"],
         "hbm_bytes_predicted": pred["roofline"]["hbm_bytes_per_dev"],
         "step_ms_measured": path_h_ms,
         "step_ms_under_flop_counter": ms, "loss": loss,
         "tol": {"flops": TOL_DRYRUN_FLOPS, "peak": TOL_DRYRUN_PEAK}}
    log(f"[dryrun] (a) path H: {json.dumps(a)}")

    # phase 11 (a)'s step: the whole sharded step on one device
    mesh22 = make_host_mesh(2, devices=["meta"] * 4)
    whole = dryrun.record_of(dryrun.trace_step(
        cfg, "train", TRAIN_SEQ, TRAIN_BATCH, mesh=mesh22,
        dtype=torch.float32, opt_cfg=opt_cfg, one_device=True), 1)
    b = {"mesh": list(mesh22.axis_sizes),
         "peak_gb_predicted": whole["memory"]["peak_bytes"] / 1e9,
         "launches_predicted": whole["launches"],
         "launches_measured": EXPECTED_MESH_STEP,
         "roofline_ms": 1e3 * whole["roofline"]["t_roofline_s"],
         "t_compute_ms": 1e3 * whole["roofline"]["t_compute_s"],
         "t_memory_ms": 1e3 * whole["roofline"]["t_memory_s"]}
    ma = (mesh_report or {}).get("a")
    if ma:
        # phase 11's peak over its steps, less what was resident besides
        # the placed params and moments
        b["peak_gb_measured"] = (ma["peak_memory_gb"]
                                 - ma["resident_gb_before_steps"]
                                 + whole["memory"]["argument_size_in_bytes"]
                                 / 1e9)
        b["step_ms_measured"] = ma["step_ms"]
    log(f"[dryrun] (b) mesh (2, 2) on one device: {json.dumps(b)}")
    if not launches_ok or a["matmul_flops_rel_err"] > TOL_DRYRUN_FLOPS or \
            a["peak_rel_err"] > TOL_DRYRUN_PEAK or not math.isfinite(loss):
        raise AssertionError(f"dry run (a): the prediction misses path H: "
                             f"{json.dumps(a)}")
    if whole["launches"] != EXPECTED_MESH_STEP:
        raise AssertionError(f"dry run (b): the tensor-parallel step's "
                             f"launches {whole['launches']}, phase 11 (a) "
                             f"measures {EXPECTED_MESH_STEP} a step")
    return {"a": a, "b": b}, {"dryrun (a) path H step": counts}


# ---------------------------------------------------------------------------
# phase 13: the example scripts
# ---------------------------------------------------------------------------

#: Phase 13: each script of examples/torch/ through its main(argv), on the
#: card, at its defaults but these arguments, and the kernels its counted
#: run must launch at least once.
EXAMPLES = (
    ("quickstart", (), ("winograd_streamed",)),
    ("cnn_inference", (), ("winograd_streamed", "winograd_strided_streamed")),
    ("serve_conv", (), ("separable_streamed", "depthwise_strided_streamed",
                        "matmul")),
    ("mamba_cook_toom", (), ("conv1d_ct_fused", "selective_scan")),
    ("train_lm", ("--steps", "20"), ()),
    ("serve_batched", (), ()),
)
#: Each conv path of quickstart and mamba_cook_toom against its direct
#: oracle (max abs error over max abs output, fp32, TF32 off; a wrong conv
#: reads O(1), the fp32 paths ~1e-6).
TOL_EXAMPLE_CONV = 1e-4


def example_script(name: str):
    """examples/torch/<name>.py of this checkout as a module."""
    import importlib.util
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def result_numbers(tree, where: str = "") -> tuple[int, list[str], Any]:
    """(how many numbers a script's result holds, the places of those that
    are not finite, the result with each tensor or array replaced by its
    shape and dtype for the log)."""
    import numpy as np
    import torch
    if isinstance(tree, bool) or isinstance(tree, str) or tree is None:
        return 0, [], tree
    if isinstance(tree, (int, float)):
        return 1, ([] if math.isfinite(tree) else [where]), tree
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        t = torch.as_tensor(tree)
        ok = bool(torch.isfinite(t).all()) if t.numel() else True
        return t.numel(), ([] if ok else [where]), \
            f"{tuple(t.shape)} {str(t.dtype).removeprefix('torch.')}"
    if isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        raise TypeError(f"{where}: unexpected {type(tree).__name__}")
    n, bad, shown = 0, [], {}
    for k, v in items:
        m, b, s = result_numbers(v, f"{where}/{k}")
        n, bad, shown[str(k)] = n + m, bad + b, s
    return n, bad, (list(shown.values())
                    if isinstance(tree, (list, tuple)) else shown)


def device_ms_raw(fn) -> tuple[float | None, int, float]:
    """(device ms, device events, host wall ms) of one fn() call: a
    torch.profiler trace of the card's activity alone, its raw events'
    durations summed (kernels, copies and fills; None when the trace holds
    none). Reading the raw events takes seconds where profile_device's
    event tree took minutes for train_lm's 20 steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    on_card = [e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    if not on_card:
        log("[profile] the trace holds no device events: device time not "
            "measured")
    return (sum(on_card) / 1e6 if on_card else None), len(on_card), wall_ms


def examples_phase() -> tuple[dict, dict]:
    """Phase 13 (module docstring): each example script's main() twice, on
    the card, its default device. The first run is counted (every counter
    set to 0 just before it and read just after) and timed on the host
    clock; the second, its output suppressed, under torch.profiler for the
    device time (device_ms_raw). Gates: the kernels EXAMPLES names each
    launched, every number the first run returns finite, the conv paths
    within TOL_EXAMPLE_CONV of their direct oracles, the quickstart
    artifact's round trip bitwise; each script's own checks raise.
    train_lm writes its checkpoints in a temporary directory, a fresh one
    per run. Returns the report and the counted runs' launches."""
    import io
    import tempfile

    import torch
    report, counts_by = {}, {}
    t_phase = time.perf_counter()
    for name, extra, kernels in EXAMPLES:
        mod = example_script(name)
        with tempfile.TemporaryDirectory() as tmp:
            def argv(run: str) -> list[str]:
                if name != "train_lm":
                    return list(extra)
                return list(extra) + ["--ckpt-dir", str(Path(tmp) / run)]

            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            out = mod.main(argv("counted"))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = read_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                device_ms, device_events, prof_wall_ms = device_ms_raw(
                    lambda: mod.main(argv("profiled")))
            profile_s = time.perf_counter() - t0
        n, bad, shown = result_numbers(out)
        row = {"argv": argv("counted"), "wall_s": wall_s,
               "device_ms": device_ms, "profiled_wall_s": prof_wall_ms / 1e3,
               # the profiled run with the trace's set-up and reading
               "profile_s": profile_s, "device_events": device_events,
               "launches": {k: v for k, v in counts.items() if v},
               "numbers": n, "result": shown}
        report[name] = row
        counts_by[f"examples {name}"] = counts
        log(f"[examples] {name}: {json.dumps(row)}")
        missing = [k for k in kernels if not counts[k]]
        conv_errs = {}
        if name == "quickstart":
            conv_errs = out["rel_err"]
            if not out["roundtrip_bitwise"]:
                bad.append("/roundtrip_bitwise")
        elif name == "mamba_cook_toom":
            conv_errs = out["rel_err"]
        over = {k: e for k, e in conv_errs.items() if not
                e <= TOL_EXAMPLE_CONV}
        if missing or bad or not n or over:
            raise AssertionError(
                f"examples: {name} launched none of {missing}, or returned "
                f"non-finite / no numbers at {bad} ({n} numbers), or its "
                f"convs missed {TOL_EXAMPLE_CONV}: {over}")
    report["phase_s"] = time.perf_counter() - t_phase
    return report, counts_by


#: The layers `--sweep` times under every blocking its kernel takes: the
#: worst of each kernel's main-path layers (PERF.md), and the 5x5 layers at
#: F(2, 5) of GoogleNet and Inception-v3 (the shallowest and the widest).
#: (label, kernel, NHWC input shape at batch MAIN_BATCH, output channels,
#: activations, filter size).
SWEEP_LAYERS = (
    ("mobilenet_v1.sep14", "separable_streamed", (7, 7, 1024), 1024,
     ("relu", "relu"), 3),
    ("mobilenet_v2.ir8", "separable_streamed", (14, 14, 384), 64,
     ("relu6", "none"), 3),
    ("vgg16.conv3_1", "winograd_streamed", (56, 56, 256), 256, ("relu",), 3),
    ("vgg16.conv5_1", "winograd_streamed", (14, 14, 512), 512, ("relu",), 3),
    ("googlenet.i3a_5x5", "winograd_streamed", (28, 28, 16), 32, ("relu",),
     5),
    ("googlenet.i4e_5x5", "winograd_streamed", (14, 14, 32), 128, ("relu",),
     5),
    ("inception_v3.m1_5x5", "winograd_streamed", (35, 35, 48), 64,
     ("relu",), 5),
)
#: The VGG-16 convs `--sweep winograd_streamed` times on the warp-
#: specialised body (csrc/winograd_ws.cuh) under every blocking of its
#: menu, at the batches the benchmark's cells run (offline 32, served
#: buckets 1-8), for the refit of its time model (core/winograd.py:
#: WS_COST): (label, (batch, H, W, C), output channels).
SWEEP_WS = tuple(
    (f"vgg16.{name} b{batch}", (batch, res, res, c), m)
    for batch in (32, 8, 1)
    for name, res, c, m in (("conv1_1", 224, 64, 64), ("conv2_1", 112, 128, 128),
                            ("conv3_1", 56, 256, 256), ("conv4_0", 28, 256, 512),
                            ("conv4_1", 28, 512, 512), ("conv5_1", 14, 512, 512)))
#: The GEMMs `--sweep` times `matmul` on under every tile of its menu:
#: (label, (M, K, N) at batch MAIN_BATCH, B's dtype). The deep M = 196
#: layers, the long shallow ones and MobileNet-v2's narrow N.
SWEEP_MATMUL = (
    ("mobilenet_v1.sep13", (196, 512, 1024), "float32"),
    ("mobilenet_v1.sep14 bf16", (196, 1024, 1024), "bfloat16"),
    ("mobilenet_v1.sep7", (784, 256, 512), "float32"),
    ("mobilenet_v1.sep5", (3136, 128, 256), "float32"),
    ("mobilenet_v1.sep2 bf16", (50176, 32, 64), "bfloat16"),
    ("mobilenet_v2.ir1 bf16", (50176, 32, 16), "bfloat16"),
    ("mobilenet_v2.ir2", (12544, 96, 24), "float32"),
    ("mobilenet_v2.ir4", (3136, 144, 32), "float32"),
    ("mobilenet_v2.ir12 int8", (784, 576, 96), "int8"),
)
#: The stride-2 layers `--sweep` times `winograd_strided_streamed` on
#: under every blocking its launcher takes: the MobileNet stem at each of
#: its tiles, the 7x7 stems of GoogleNet and SqueezeNet (F(4, 4), T = 7 on
#: the T = 8 body), Inception-v3's VALID 3x3 stem and its first reduction
#: (label, NHWC input at batch MAIN_BATCH, output channels, output tile or
#: None for the planner's, compute dtype, activation, filter size,
#: padding).
SWEEP_STRIDED = (
    ("mobilenet stem F(4,2)", (224, 224, 3), 32, 4, "float32", "relu", 3,
     "SAME"),
    ("mobilenet stem F(2,2) bf16", (224, 224, 3), 32, 2, "bfloat16",
     "relu6", 3, "SAME"),
    ("googlenet.conv1 7x7", (224, 224, 3), 64, None, "float32", "relu", 7,
     "SAME"),
    ("squeezenet.conv1 7x7", (224, 224, 3), 96, None, "float32", "relu", 7,
     "SAME"),
    ("inception_v3.conv1 VALID", (299, 299, 3), 32, None, "float32", "relu",
     3, "VALID"),
    ("inception_v3.rA_3 VALID", (35, 35, 288), 384, None, "float32", "relu",
     3, "VALID"),
)


#: The depthwise layers `--sweep depthwise_streamed` times at bf16 and
#: int8 under every blocking its launcher takes: every distinct stride-1
#: depthwise conv of MobileNet-v1 and v2 at 224 (label, (H, W, C) at batch
#: MAIN_BATCH, the layers of that shape).
SWEEP_DEPTHWISE = (
    ("112x112x32", (112, 112, 32), "v1 sep2, v2 ir1"),
    ("56x56x128", (56, 56, 128), "v1 sep4"),
    ("28x28x256", (28, 28, 256), "v1 sep6"),
    ("14x14x512", (14, 14, 512), "v1 sep8-12"),
    ("7x7x1024", (7, 7, 1024), "v1 sep14"),
    ("56x56x144", (56, 56, 144), "v2 ir3"),
    ("28x28x192", (28, 28, 192), "v2 ir5, ir6"),
    ("14x14x384", (14, 14, 384), "v2 ir8-11"),
    ("14x14x576", (14, 14, 576), "v2 ir12, ir13"),
    ("7x7x960", (7, 7, 960), "v2 ir15-17"),
)
#: The stride-2 depthwise layers `--sweep depthwise_strided_streamed`
#: times at fp32, bf16 and int8 under every blocking its launcher takes:
#: every stride-2 depthwise conv of MobileNet-v1 and v2 at 224 (label,
#: (H, W, C) input at batch MAIN_BATCH).
SWEEP_DW_STRIDED = (
    ("mobilenet_v1.sep3", (112, 112, 64)),
    ("mobilenet_v1.sep5", (56, 56, 128)),
    ("mobilenet_v1.sep7", (28, 28, 256)),
    ("mobilenet_v1.sep13", (14, 14, 512)),
    ("mobilenet_v2.ir2", (112, 112, 96)),
    ("mobilenet_v2.ir4", (56, 56, 144)),
    ("mobilenet_v2.ir7", (28, 28, 192)),
    ("mobilenet_v2.ir14", (14, 14, 576)),
)
#: Sources whose every instantiation's registers and spills the build
#: phase prints, one line each.
REGISTER_REPORT = ("selective_scan.cu", "depthwise_strided_streamed.cu",
                   "separable_streamed.cu")


def log_build(build_logs: dict, tag: str) -> None:
    """Per source, nvcc's registers and spill stores of its kernels (in
    ptxas's order); for REGISTER_REPORT's sources also one line per
    instantiation."""
    for source, text in build_logs.items():
        funcs, name = [], None
        for line in text.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "spill stores" in line and name is not None:
                spill = int(line.split("bytes spill stores")[0]
                            .split(",")[-1])
                funcs.append([name, None, spill])
            elif "registers" in line and funcs and funcs[-1][1] is None:
                funcs[-1][1] = int(line.split("Used ")[1].split()[0])
        log(f"[{tag}] {source}: {len(funcs)} kernels, registers "
            f"{[f[1] for f in funcs]}, spill stores "
            f"{sorted({f[2] for f in funcs})}")
        if source in REGISTER_REPORT:
            names = [f[0] for f in funcs]
            if shutil.which("c++filt"):
                names = subprocess.run(
                    ["c++filt"], input="\n".join(names), capture_output=True,
                    text=True, check=True).stdout.split("\n")
            for fname, (_, regs, spill) in zip(names, funcs):
                log(f"[{tag}] {source} {fname.replace('(anonymous namespace)::', '')}"
                    f": {regs} registers, {spill} bytes spill stores")


def vgg16_layers() -> list:
    """(name, (H, W, C), M) of VGG-16's 13 3x3 convs at 224."""
    from repro_torch.models import cnn
    out, res, c = [], 224, 3
    for spec in cnn.vgg16():
        if isinstance(spec, cnn.Conv):
            out.append((spec.name, (res, res, c), spec.c_out))
            c = spec.c_out
        elif isinstance(spec, cnn.Pool):
            res //= spec.stride
    return out


def fit_cost(rows: list, keys: tuple, cost: dict,
             extra_keys: tuple = ()) -> dict:
    """The rms relative error of a chooser's time model (its `terms`,
    `waves`, `bps` per row, weights `cost`, plus the row's `extra` terms
    outside the waves) against the rows' device times, and a refit:
    non-negative least squares of the relative error for each share of a
    co-resident block in 0, 0.1, ..., 1, the best kept."""
    import numpy as np
    from scipy.optimize import nnls

    from repro_torch.core.winograd import model_time
    t = np.array([1e6 * r["device_ms"] for r in rows])      # ns

    def rms(pred):
        return float(np.sqrt(np.mean(((pred - t) / t) ** 2)))

    now = rms(np.array([
        model_time(r["terms"], r["waves"], r["bps"], cost)
        + sum(cost[k] * r["extra"][k] for k in extra_keys) for r in rows]))
    best = None
    for share in np.round(np.arange(0, 1.01, 0.1), 1):
        a = np.array([[r["waves"] * r["terms"][k]
                       * (1 + share * (r["bps"] - 1)) for k in keys]
                      + [r["extra"][k] for k in extra_keys] for r in rows])
        w, _ = nnls(a / t[:, None], np.ones(len(rows)))
        err = rms(a @ w)
        if best is None or err < best[0]:
            best = (err, {**dict(zip(keys + extra_keys, map(float, w))),
                          "share": float(share)})
    return {"rows": len(rows), "rms_now": now, "rms_refit": best[0],
            "refit": best[1]}


def sweep(only=None) -> int:
    """`python3 chip_smoke.py --sweep [kernel ...]`: time `winograd_streamed`
    and `separable_streamed` on SWEEP_LAYERS under every (bh, bw, block_c,
    block_m) their launchers accept, `matmul` on SWEEP_MATMUL under every
    tile of its menu, `winograd_strided_streamed` on SWEEP_STRIDED,
    `winograd_fused` on VGG-16's 13 layers, `depthwise_streamed` on
    SWEEP_DEPTHWISE and `depthwise_strided_streamed` on SWEEP_DW_STRIDED
    under every blocking, on the device (CUDA-graph replays), each
    compared with its plain version in fp32 and, but for the depthwise
    kernels (fp32 arithmetic, gated in fp32), in float64 (the error gated
    at TOL_KERNEL, as compare does); prints one JSON line per layer with
    the planner's own choice marked, and for those past the first two the
    rms error of their choosers' time models and a refit (fit_cost). Then
    `selective_scan` at path C's layer shape under every blocking its
    launcher takes (sweep_scan).
    `only` names the kernels to sweep (all by default). The two older
    kernels' keywords are read from their signatures, so that part also
    drives an older checkout's kernels when the script is copied to that
    checkout's root."""
    import inspect
    import itertools

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke --sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import plan as pt_plan
    from repro_torch.kernels import build
    kd, _, kw, _, _ = kernel_modules()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build_all()
    log(f"[sweep] built in {time.perf_counter() - t0:.2f} s")
    log_build(build.BUILD_LOGS, "sweep")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    failed = []
    for label, kernel, (h, w, c), m, acts, k in SWEEP_LAYERS:
        if only and kernel not in only:
            continue
        x = randn(MAIN_BATCH, h, w, c)
        sep = kernel == "separable_streamed"
        if sep:
            plan = pt_plan.plan_separable_block(
                x.shape, randn(3, 3, 1, c, scale=1 / 3),
                randn(1, 1, c, m, scale=c ** -0.5),
                algorithm="pallas_winograd", device=dev)
            ops_ = (plan.u_dw[:, :c].contiguous(),
                    plan.u_pw[:c, :m].contiguous(),
                    randn(c, scale=0.1), randn(m, scale=0.1))
            fn, plain = kd.separable_streamed, kd.separable_streamed_plain
            act_kw = dict(inner_activation=acts[0], activation=acts[1])
        else:
            plan = pt_plan.plan_conv2d(
                x.shape, randn(k, k, c, m, scale=(k * k * c) ** -0.5),
                algorithm="pallas_winograd", device=dev)
            ops_ = (plan.u[:, :c, :m].contiguous(), randn(m, scale=0.1))
            fn, plain = kw.winograd_streamed, kw.winograd_streamed_plain
            act_kw = dict(activation=acts[0])
        s, g = plan.spec.stream, plan.spec.geometry
        ct_h, ct_w = plan.spec.ct_h, plan.spec.ct_w
        takes = inspect.signature(fn).parameters
        chosen = (s.bh, s.bw, s.block_c, s.block_m)
        rows = []
        for bh, bw, bc, bm in itertools.product(
                (1, 2, 4, 8, 16), (1, 2, 4, 8, 16), (8, 16, 32, 64, 128),
                (16, 32, 64, 128, 256)):
            # the separable kernel takes whole C steps; the dense one pads
            # C to the step, as its plans do (bc <= C but for 8)
            if (c % bc if sep else bc > max(c, 8)) or m % bm or (
                    "block_c" not in takes and bc != 8):
                continue
            n_hb, n_wb = -(-g.n_h // bh), -(-g.n_w // bw)
            if (bh > 1 and n_hb * bh > 2 * g.n_h) or \
                    (bw > 1 and n_wb * bw > 2 * g.n_w):
                continue                  # more padding than tiles
            c_pad = -(-c // bc) * bc
            xp = F.pad(x, (0, c_pad - c, g.lo_w,
                           g.hi_w + (n_wb * bw - g.n_w) * ct_w.m,
                           g.lo_h, g.hi_h + (n_hb * bh - g.n_h) * ct_h.m))
            ops_b = ops_ if sep else (
                F.pad(ops_[0], (0, 0, 0, c_pad - c)).contiguous(), ops_[1])
            kwargs = dict(ct_h=ct_h, ct_w=ct_w, bh=bh, bw=bw, block_m=bm,
                          **act_kw)
            if "block_c" in takes:
                kwargs["block_c"] = bc
            call = lambda: fn(xp, *ops_b, **kwargs)         # noqa: E731
            try:
                got = call()
                torch.cuda.synchronize()
            except RuntimeError as exc:
                if "blocking" not in str(exc):
                    raise
                continue
            want = plain(xp, *ops_b, **{k: v for k, v in kwargs.items()
                                       if not k.startswith("block_")})
            err = rel_err(got, want)
            with double_plain():
                exact = plain(xp.double(), *(t.double() for t in ops_b),
                              **{k: v for k, v in kwargs.items()
                                 if not k.startswith("block_")})
            if rel_err(got.double(), exact) > TOL_KERNEL:
                failed.append(f"{label} {(bh, bw, bc, bm)}: "
                              f"{rel_err(got.double(), exact):.3e} > "
                              f"{TOL_KERNEL}")
            rows.append({"bh": bh, "bw": bw, "block_c": bc, "block_m": bm,
                         "blocks": MAIN_BATCH * n_hb * n_wb * (m // bm),
                         "device_ms": graph_ms(call, reps=10, iters=5),
                         "rel_err": err,
                         "kernel_err_f64": rel_err(got.double(), exact),
                         "plain_err_f64": rel_err(want.double(), exact),
                         "chosen": (bh, bw, bc, bm) == chosen})
        sweep_report(kernel, label, rows, chosen,
                     {"shape": [MAIN_BATCH, h, w, c], "m": m,
                      "tile": list(plan.spec.output_tile)})
    if not only or "winograd_streamed" in only:
        failed += sweep_ws(randn)
    if not only or "matmul" in only:
        failed += sweep_matmul(randn)
    if not only or "winograd_strided_streamed" in only:
        failed += sweep_strided(randn)
    if not only or "winograd_fused" in only:
        failed += sweep_fused(randn)
    if not only or "depthwise_streamed" in only:
        failed += sweep_depthwise(randn)
    if not only or "depthwise_strided_streamed" in only:
        failed += sweep_depthwise_strided(randn)
    if not only or "selective_scan" in only:
        failed += sweep_scan()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    for line in failed:
        log(f"[sweep] kernel disagrees with its plain version: {line}")
    return 1 if failed else 0


def sweep_ws(randn) -> list[str]:
    """`winograd_streamed` on SWEEP_WS under every blocking of the warp-
    specialised body's menu (stream_ws_blocking_fits, strips of at most
    twice the tile grid), fp32: each row's device time beside its
    ws_block_terms, the error against the fp32 plain version (gated at
    TOL_KERNEL x 5: the fp32 plain version itself reads up to 1.9e-5 from
    float64 at C = 512), one JSON line per layer with the planner's choice
    and chosen_over_best, then the rms error of the time model with
    WS_COST and an NNLS refit over every row (fit_cost)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import plan as pt_plan
    from repro_torch.core import winograd as wg
    _, _, kw, _, _ = kernel_modules()
    failed, all_rows = [], []
    for label, (batch, h, w, c), m in SWEEP_WS:
        x = randn(batch, h, w, c)
        plan = pt_plan.plan_conv2d(x.shape, randn(3, 3, c, m, scale=(9 * c) ** -0.5),
                                   algorithm="pallas_winograd",
                                   device=torch.device("cuda"))
        s, g, sp = plan.spec.stream, plan.spec.geometry, plan.spec
        ct_h, ct_w = sp.ct_h, sp.ct_w
        chosen = (s.bh, s.bw, s.block_c, s.block_m)
        t = wg.winograd_ws_tile(ct_h.t, ct_w.t)
        rows = []
        for kmt, knt in wg.WINOGRAD_WS_CONFIGS[t]:
            br, bm = 16 * kmt, 8 * knt
            for bh in (1, 2, 4, 8, 16, 32):
                bw = br // bh
                if bh > br or m % bm or not wg.stream_ws_blocking_fits(
                        ct_h, ct_w, bh, bw, 8, bm):
                    continue
                n_hb, n_wb = -(-g.n_h // bh), -(-g.n_w // bw)
                if (bh > 1 and n_hb * bh > 2 * g.n_h) or \
                        (bw > 1 and n_wb * bw > 2 * g.n_w):
                    continue              # more padding than tiles
                c_pad = -(-c // 8) * 8
                xp = F.pad(x, (0, c_pad - c, g.lo_w,
                               g.hi_w + (n_wb * bw - g.n_w) * ct_w.m,
                               g.lo_h, g.hi_h + (n_hb * bh - g.n_h) * ct_h.m))
                u = plan.u[:, :c_pad, :m].contiguous()
                kwargs = dict(ct_h=ct_h, ct_w=ct_w, bh=bh, bw=bw,
                              activation="relu")
                call = lambda: kw.winograd_streamed(   # noqa: E731
                    xp, u, None, block_c=8, block_m=bm, **kwargs)
                got = call()
                want = kw.winograd_streamed_plain(xp, u, None, **kwargs)
                err = rel_err(got, want)
                if err > 5 * TOL_KERNEL:
                    failed.append(f"{label} {(bh, bw, 8, bm)}: {err:.3e}")
                del got, want
                terms, waves, bps = wg.ws_block_terms(
                    ct_h, ct_w, c, m, bh, bw, bm, n_h=g.n_h, n_w=g.n_w,
                    batch=batch)
                rows.append({"bh": bh, "bw": bw, "block_c": 8, "block_m": bm,
                             "device_ms": graph_ms(call, reps=10, iters=5),
                             "rel_err": err, "terms": terms, "waves": waves,
                             "bps": bps,
                             "model_ms": wg.model_time(terms, waves, bps,
                                                       wg.WS_COST) / 1e6,
                             "chosen": (bh, bw, 8, bm) == chosen})
        all_rows += rows
        sweep_report("winograd_streamed", label, rows, chosen,
                     {"shape": [batch, h, w, c], "m": m, "body": "ws"})
    log(json.dumps({"sweep": "winograd_streamed ws model", "fit": fit_cost(
        all_rows, ("step", "load", "mma", "xform", "tail", "block"),
        wg.WS_COST)}))
    return failed


def sweep_timed(label, call, plain, exact) -> tuple[dict, str | None]:
    """One sweep row: the kernel's device time and its errors against the
    plain version in fp32 and in float64 (`exact`); the second item names
    a float64 error past TOL_KERNEL."""
    import torch
    got = call()
    torch.cuda.synchronize()
    want, ref = plain(), exact()
    e64 = rel_err(got.double(), ref)
    row = {"device_ms": graph_ms(call, reps=10, iters=5),
           "rel_err": rel_err(got, want), "kernel_err_f64": e64,
           "plain_err_f64": rel_err(want.double(), ref)}
    return row, (f"{label}: {e64:.3e} > {TOL_KERNEL}" if e64 > TOL_KERNEL
                 else None)


def sweep_report(kernel: str, label: str, rows: list, chosen, info: dict
                 ) -> None:
    rows.sort(key=lambda r: r["device_ms"])
    pick = [r for r in rows if r["chosen"]]
    log(json.dumps({"sweep": label, "kernel": kernel, **info,
                    "chosen": chosen,
                    "chosen_over_best": (pick[0]["device_ms"]
                                         / rows[0]["device_ms"]
                                         if pick else None),
                    "rows": rows}))


def sweep_matmul(randn) -> list[str]:
    """`matmul` on SWEEP_MATMUL under every tile of MATMUL_TILES and every
    K split of MATMUL_SPLITS that fits, B padded by the plan's rule for
    each; the chooser's model (matmul_block_terms, MATMUL_COST) beside each
    time, then fit_cost over all rows."""
    import itertools

    import torch
    from repro_torch.core import im2col
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ops
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}
    failed, fit_rows = [], []
    for label, (m, k, n), dtype in SWEEP_MATMUL:
        u_size = torch.tensor([], dtype=dtypes[dtype]).element_size()
        a = randn(m, k)
        b = randn(k, n, scale=k ** -0.5)
        scale = None
        if dtype == "int8":
            b = torch.clamp(torch.round(b * 40 * k ** 0.5), -127, 127)
        b = b.to(dtypes[dtype])
        bias = randn(n, scale=0.1)
        chosen = im2col.matmul_blocks(m, k, n, u_size=u_size)
        rows = []
        for (bm, bn), splits in itertools.product(im2col.MATMUL_TILES,
                                                  im2col.MATMUL_SPLITS):
            if not im2col.matmul_split_fits(k, splits):
                continue
            bp = ops.pad_im2col_filter(b, bn)
            if dtype == "int8":
                scale = randn(1, bp.shape[1]).abs()
            args = (a, bp, bias, scale)
            kwargs = dict(n_out=n, activation="relu")
            ops64 = [None if t is None else t.double() for t in args]

            def exact():
                with double_plain():
                    return km.matmul_plain(*ops64, **kwargs)
            row, bad = sweep_timed(
                f"{label} {(bm, bn, splits)}",
                lambda: km.matmul(*args, block_m=bm, block_n=bn,
                                  splits=splits, **kwargs),
                lambda: km.matmul_plain(*args, **kwargs), exact)
            terms, waves, bps, extra = im2col.matmul_block_terms(
                m, k, n, bm, bn, u_size, splits=splits)
            row.update(block_m=bm, block_n=bn, splits=splits, terms=terms,
                       waves=waves, bps=bps, extra=extra,
                       chosen=(bm, bn, splits) == (chosen[0], chosen[2],
                                                   chosen[3]),
                       model_ms=im2col.matmul_model_time(
                           m, k, n, bm, bn, u_size, splits=splits) / 1e6)
            rows.append(row)
            fit_rows.append(row)
            if bad:
                failed.append(bad)
        library = lambda: torch.addmm(bias, a, b[:k, :n].float())  # noqa
        sweep_report("matmul", label, rows, chosen,
                     {"mkn": [m, k, n], "dtype": dtype,
                      "addmm_device_ms": graph_ms(library, reps=10,
                                                  iters=5)})
    log(json.dumps({"fit": "matmul", "cost": "core/im2col.py:MATMUL_COST",
                    **fit_cost(fit_rows, ("step", "mma", "load", "store",
                                          "block"), im2col.MATMUL_COST,
                               ("launch", "reduce"))}))
    return failed


def sweep_strided(randn) -> list[str]:
    """`winograd_strided_streamed` on SWEEP_STRIDED under every (bh, bw,
    block_c, block_m) the tensor-core body takes for the tile; the
    chooser's model (tc_block_terms with phases=4, TC_COST) beside each
    time, then fit_cost over all rows."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.core import plan as pt_plan
    from repro_torch.core import winograd as wg
    from repro_torch.kernels import winograd as kw
    failed, fit_rows = [], []
    for label, (h, w, c), m, tile, cd, act, k, padding in SWEEP_STRIDED:
        x = randn(MAIN_BATCH, h, w, c)
        plan = pt_plan.plan_conv2d(x.shape, randn(k, k, c, m,
                                                  scale=(k * k * c) ** -0.5),
                                   stride=2, padding=padding,
                                   algorithm="pallas_winograd",
                                   output_tile=tile, compute_dtype=cd,
                                   device=x.device)
        sp, s = plan.spec, plan.spec.stream
        g, ct_h, ct_w = sp.geometry, sp.ct_h, sp.ct_w
        u_size = plan.u.element_size()
        u = plan.u[:, :c, :m]
        scale = None if plan.scale is None else plan.scale[:, :m]
        bias = randn(m, scale=0.1)
        chosen = (s.bh, s.bw, s.block_c, s.block_m)
        rows = []
        for bh, bw, bc, bm in itertools.product(
                (1, 2, 4, 8, 16, 32), (1, 2, 4, 8, 16, 32),
                wg.WINOGRAD_TC_BLOCK_C, (8, 16, 32, 64)):
            if m % bm or not wg.stream_tc_blocking_fits(ct_h, ct_w, bh, bw,
                                                        bc, bm, u_size):
                continue
            n_hb, n_wb = -(-g.n_h // bh), -(-g.n_w // bw)
            c_pad, m_pad = -(-c // bc) * bc, m
            xp = F.pad(x, (0, c_pad - c, g.lo_w,
                           g.hi_w + 2 * (n_wb * bw - g.n_w) * ct_w.m,
                           g.lo_h, g.hi_h + 2 * (n_hb * bh - g.n_h) * ct_h.m))
            ub = F.pad(u, (0, m_pad - m, 0, c_pad - c)).contiguous()
            kwargs = dict(ct_h=ct_h, ct_w=ct_w, bh=bh, bw=bw, activation=act)
            ops64 = [None if t is None else t.double()
                     for t in (xp, ub, bias, scale)]

            def exact():
                with double_plain():
                    return kw.winograd_strided_streamed_plain(*ops64,
                                                              **kwargs)
            row, bad = sweep_timed(
                f"{label} {(bh, bw, bc, bm)}",
                lambda: kw.winograd_strided_streamed(
                    xp, ub, bias, scale, block_c=bc, block_m=bm, **kwargs),
                lambda: kw.winograd_strided_streamed_plain(
                    xp, ub, bias, scale, **kwargs), exact)
            terms, waves, bps = wg.tc_block_terms(
                ct_h, ct_w, c, m, bh, bw, bc, bm, n_h=g.n_h, n_w=g.n_w,
                batch=MAIN_BATCH, u_size=u_size, phases=4)
            row.update(bh=bh, bw=bw, block_c=bc, block_m=bm, terms=terms,
                       waves=waves, bps=bps,
                       chosen=(bh, bw, bc, bm) == chosen,
                       model_ms=wg.model_time(terms, waves, bps,
                                              wg.TC_COST) / 1e6)
            rows.append(row)
            fit_rows.append(row)
            if bad:
                failed.append(bad)
        sweep_report("winograd_strided_streamed", label, rows, chosen,
                     {"shape": [MAIN_BATCH, h, w, c], "m": m,
                      "tile": list(sp.output_tile), "dtype": cd})
    log(json.dumps({"fit": "winograd_strided_streamed",
                    "cost": "core/winograd.py:TC_COST (phases=4)",
                    **fit_cost(fit_rows, ("step", "load", "mma", "xform",
                                          "tail", "block"),
                               wg.TC_COST)}))
    return failed


def sweep_fused(randn) -> list[str]:
    """`winograd_fused` on VGG-16's 13 layers (F(4x4, 3x3) fp32, the tiles
    of batch MAIN_BATCH) under every (block_r, block_c, block_m) that
    fused_blocking_fits takes; the chooser's model (fused_block_terms,
    TC_COST) beside each time, cuDNN's F.conv2d on the layer per layer,
    then fit_cost over all rows and the picks' sum against the best."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.core import plan as pt_plan
    from repro_torch.core import winograd as wg
    from repro_torch.kernels import ops
    from repro_torch.kernels import winograd as kw
    failed, fit_rows, picks, bests = [], [], 0.0, 0.0
    for name, (h, w, c), m in vgg16_layers():
        x = randn(MAIN_BATCH, h, w, c)
        wt = randn(3, 3, c, m, scale=(9 * c) ** -0.5)
        plan = pt_plan.plan_conv2d(x.shape, wt,
                                   algorithm="pallas_winograd_materialized",
                                   device=x.device)
        sp = plan.spec
        ct_h, ct_w, g = sp.ct_h, sp.ct_w, sp.geometry
        r_tot = MAIN_BATCH * g.n_h * g.n_w
        u = plan.u[:, :c, :m]
        chosen = tuple(sp.blocks)
        t = wg.winograd_tc_tile(ct_h.t, ct_w.t)
        rows = []
        for (kmt, knt), bc in itertools.product(wg.FUSED_TC_CONFIGS[t],
                                                wg.WINOGRAD_TC_BLOCK_C):
            br, bm = 16 * kmt, 8 * knt
            if m % bm or (bc > 8 and bc > c) or \
                    not wg.fused_blocking_fits(ct_h, ct_w, br, bc, bm):
                continue
            tiles = ops.extract_tiles(x, ct_h=ct_h, ct_w=ct_w, geometry=g,
                                      blocks=(br, bc, bm))
            ub = F.pad(u, (0, 0, 0, tiles.shape[3] - c)).contiguous()
            kwargs = dict(ct_h=ct_h, ct_w=ct_w)
            ops64 = (tiles.double(), ub.double())

            def exact():
                with double_plain():
                    return kw.winograd_fused_plain(*ops64, **kwargs)
            row, bad = sweep_timed(
                f"{name} {(br, bc, bm)}",
                lambda: kw.winograd_fused(tiles, ub, block_r=br, block_c=bc,
                                          block_m=bm, **kwargs),
                lambda: kw.winograd_fused_plain(tiles, ub, **kwargs), exact)
            terms, waves, bps = wg.fused_block_terms(ct_h, ct_w, r_tot, c, m,
                                                     br, bc, bm)
            row.update(block_r=br, block_c=bc, block_m=bm, terms=terms,
                       waves=waves, bps=bps, chosen=(br, bc, bm) == chosen,
                       model_ms=wg.model_time(terms, waves, bps,
                                              wg.TC_COST) / 1e6)
            rows.append(row)
            fit_rows.append(row)
            if bad:
                failed.append(bad)
            del tiles, ub, ops64
        xc = x.permute(0, 3, 1, 2)
        w_lib = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        library = graph_ms(lambda: F.conv2d(xc, w_lib, padding=1), reps=10,
                           iters=5)
        sweep_report("winograd_fused", f"vgg16.{name}", rows, chosen,
                     {"shape": [MAIN_BATCH, h, w, c], "m": m,
                      "cudnn_device_ms": library})
        pick = [r["device_ms"] for r in rows if r["chosen"]]
        picks += pick[0] if pick else float("nan")
        bests += min(r["device_ms"] for r in rows)
    log(json.dumps({"fit": "winograd_fused",
                    "cost": "core/winograd.py:TC_COST (fused_block_terms)",
                    "picks_ms": picks, "best_ms": bests,
                    "picks_over_best": picks / bests,
                    **fit_cost(fit_rows, ("step", "load", "mma", "xform",
                                          "tail", "block"), wg.TC_COST)}))
    return failed


def sweep_depthwise(randn) -> list[str]:
    """`depthwise_streamed` on SWEEP_DEPTHWISE (F(2x2, 3x3), the reduced
    path's tile) at bf16 and int8 under every (bh, bw, block_c) with bh,
    bw in 1..16 that depthwise_blocking_fits takes, against the plain
    version in fp32 (both run fp32 arithmetic on the same widened taps);
    the chooser's model (depthwise_block_terms, DEPTHWISE_COST) beside
    each time, cuDNN's depthwise F.conv2d (fp32 filter, + bias + act) per
    layer, then fit_cost over all rows and the picks' sum against the
    best."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.core import plan as pt_plan
    from repro_torch.core import winograd as wg
    from repro_torch.kernels import depthwise as kd
    from repro_torch.kernels.runtime import apply_activation
    failed, fit_rows, picks, bests = [], [], 0.0, 0.0
    for (label, (h, w, c), layers), cd in itertools.product(
            SWEEP_DEPTHWISE, REDUCED):
        x = randn(MAIN_BATCH, h, w, c)
        wt = randn(3, 3, 1, c, scale=1 / 3)
        bias = randn(c, scale=0.1)
        plan = pt_plan.plan_conv2d(x.shape, wt, groups=c,
                                   algorithm="pallas_winograd",
                                   compute_dtype=cd, device=x.device)
        sp, s = plan.spec, plan.spec.stream
        ct_h, ct_w, g = sp.ct_h, sp.ct_w, sp.geometry
        u = plan.u[:, :c]
        scale = None if plan.scale is None else plan.scale[:, :c]
        chosen = (s.bh, s.bw, s.block_c)
        rows = []
        for bh, bw, bc in itertools.product((1, 2, 4, 8, 16), (1, 2, 4, 8, 16),
                                            wg.DEPTHWISE_BLOCK_C):
            n_hb, n_wb = -(-g.n_h // bh), -(-g.n_w // bw)
            if (bc > 8 and bc > -(-c // 8) * 8) or \
                    (bh > 1 and n_hb * bh > 2 * g.n_h) or \
                    (bw > 1 and n_wb * bw > 2 * g.n_w) or \
                    not wg.depthwise_blocking_fits(ct_h, ct_w, bh, bw, bc):
                continue
            c_pad = -(-c // bc) * bc
            xp = F.pad(x, (0, c_pad - c, g.lo_w,
                           g.hi_w + (n_wb * bw - g.n_w) * ct_w.m, g.lo_h,
                           g.hi_h + (n_hb * bh - g.n_h) * ct_h.m))
            ub = F.pad(u, (0, 0, 0, c_pad - c)).contiguous()
            sb = None if scale is None else F.pad(
                scale, (0, c_pad - c), value=1.0).contiguous()
            kwargs = dict(ct_h=ct_h, ct_w=ct_w, bh=bh, bw=bw,
                          activation="relu6")
            call = lambda: kd.depthwise_streamed(  # noqa: E731
                xp, ub, bias, sb, block_c=bc, **kwargs)
            got = call()
            torch.cuda.synchronize()
            want = kd.depthwise_streamed_plain(xp, ub, bias, sb, **kwargs)
            err = rel_err(got, want)
            if err > TOL_KERNEL:
                failed.append(f"{label} {cd} {(bh, bw, bc)}: {err:.3e} > "
                              f"{TOL_KERNEL}")
            terms, waves, bps = wg.depthwise_block_terms(
                ct_h, ct_w, c, bh, bw, bc, n_h=g.n_h, n_w=g.n_w,
                batch=MAIN_BATCH)
            row = {"bh": bh, "bw": bw, "block_c": bc,
                   "device_ms": graph_ms(call, reps=10, iters=5),
                   "rel_err": err, "terms": terms, "waves": waves,
                   "bps": bps, "chosen": (bh, bw, bc) == chosen,
                   "model_ms": wg.model_time(terms, waves, bps,
                                             wg.DEPTHWISE_COST) / 1e6}
            rows.append(row)
            fit_rows.append(row)
            del xp, ub, sb, got, want
        xc = x.permute(0, 3, 1, 2)
        w_lib = wt.permute(3, 2, 0, 1).contiguous()
        library = graph_ms(lambda: apply_activation(F.conv2d(
            xc, w_lib, bias, padding=1, groups=c), "relu6"), reps=10,
            iters=5)
        sweep_report("depthwise_streamed", f"{label} {cd}", rows, chosen,
                     {"shape": [MAIN_BATCH, h, w, c], "layers": layers,
                      "dtype": cd, "cudnn_device_ms": library})
        pick = [r["device_ms"] for r in rows if r["chosen"]]
        picks += pick[0] if pick else float("nan")
        bests += min(r["device_ms"] for r in rows)
    log(json.dumps({"fit": "depthwise_streamed",
                    "cost": "core/winograd.py:DEPTHWISE_COST",
                    "picks_ms": picks, "best_ms": bests,
                    "picks_over_best": picks / bests,
                    **fit_cost(fit_rows, ("load", "store", "item", "block"),
                               wg.DEPTHWISE_COST)}))
    return failed


def sweep_depthwise_strided(randn) -> list[str]:
    """`depthwise_strided_streamed` on SWEEP_DW_STRIDED at fp32, bf16 and
    int8 (each dtype's plan: its tile, taps and scale) under every (bh, bw,
    block_c) with bh, bw in 1..16 that depthwise_strided_blocking_fits
    takes, against the plain version in fp32 (both run fp32 arithmetic on
    the same widened taps); the chooser's model
    (depthwise_strided_block_terms, DEPTHWISE_STRIDED_COST) beside each
    time, cuDNN's depthwise stride-2 F.conv2d (asymmetric SAME pads, fp32
    filter, + bias + act) per layer, then fit_cost over all rows and the
    picks' sum against the best."""
    import itertools

    import torch
    import torch.nn.functional as F
    from repro_torch.core import im2col
    from repro_torch.core import plan as pt_plan
    from repro_torch.core import winograd as wg
    from repro_torch.kernels import depthwise as kd
    from repro_torch.kernels.runtime import apply_activation
    failed, fit_rows, picks, bests = [], [], {}, {}
    for (label, (h, w, c)), cd in itertools.product(
            SWEEP_DW_STRIDED, ("float32",) + REDUCED):
        x = randn(MAIN_BATCH, h, w, c)
        wt = randn(3, 3, 1, c, scale=1 / 3)
        bias = randn(c, scale=0.1)
        plan = pt_plan.plan_conv2d(x.shape, wt, stride=2, groups=c,
                                   algorithm="pallas_winograd",
                                   compute_dtype=cd, device=x.device)
        sp, s = plan.spec, plan.spec.stream
        ct_h, ct_w, g = sp.ct_h, sp.ct_w, sp.geometry
        u = plan.u[:, :c]
        scale = None if plan.scale is None else plan.scale[:, :c]
        chosen = (s.bh, s.bw, s.block_c)
        rows = []
        for bh, bw, bc in itertools.product((1, 2, 4, 8, 16), (1, 2, 4, 8, 16),
                                            wg.DEPTHWISE_BLOCK_C):
            n_hb, n_wb = -(-g.n_h // bh), -(-g.n_w // bw)
            if (bc > 8 and bc > -(-c // 8) * 8) or \
                    (bh > 1 and n_hb * bh > 2 * g.n_h) or \
                    (bw > 1 and n_wb * bw > 2 * g.n_w) or \
                    not wg.depthwise_strided_blocking_fits(ct_h, ct_w, bh, bw,
                                                           bc):
                continue
            c_pad = -(-c // bc) * bc
            xp = F.pad(x, (0, c_pad - c, g.lo_w,
                           g.hi_w + 2 * (n_wb * bw - g.n_w) * ct_w.m, g.lo_h,
                           g.hi_h + 2 * (n_hb * bh - g.n_h) * ct_h.m))
            ub = F.pad(u, (0, c_pad - c)).contiguous()
            sb = None if scale is None else F.pad(
                scale, (0, c_pad - c), value=1.0).contiguous()
            kwargs = dict(ct_h=ct_h, ct_w=ct_w, bh=bh, bw=bw,
                          activation="relu6")
            call = lambda: kd.depthwise_strided_streamed(  # noqa: E731
                xp, ub, bias, sb, block_c=bc, **kwargs)
            got = call()
            torch.cuda.synchronize()
            want = kd.depthwise_strided_streamed_plain(xp, ub, bias, sb,
                                                       **kwargs)
            err = rel_err(got, want)
            if err > TOL_KERNEL:
                failed.append(f"{label} {cd} {(bh, bw, bc)}: {err:.3e} > "
                              f"{TOL_KERNEL}")
            terms, waves, bps = wg.depthwise_strided_block_terms(
                ct_h, ct_w, c, bh, bw, bc, n_h=g.n_h, n_w=g.n_w,
                batch=MAIN_BATCH)
            cost = wg.DEPTHWISE_STRIDED_COST
            row = {"bh": bh, "bw": bw, "block_c": bc,
                   "device_ms": graph_ms(call, reps=10, iters=5),
                   "rel_err": err, "terms": terms, "waves": waves,
                   "bps": bps, "extra": {"launch": 1},
                   "chosen": (bh, bw, bc) == chosen,
                   "model_ms": (wg.model_time(terms, waves, bps, cost)
                                + cost["launch"]) / 1e6}
            rows.append(row)
            fit_rows.append(row)
            del xp, ub, sb, got, want
        gi = im2col.im2row_geometry(h, w, 3, 3, (2, 2), "SAME")
        xin, pad = pad_for_conv(x.permute(0, 3, 1, 2), gi.ph, gi.pw)
        w_lib = wt.permute(3, 2, 0, 1).contiguous()
        library = graph_ms(lambda: apply_activation(F.conv2d(
            xin, w_lib, bias, stride=2, padding=pad, groups=c), "relu6"),
            reps=10, iters=5)
        sweep_report("depthwise_strided_streamed", f"{label} {cd}", rows,
                     chosen, {"shape": [MAIN_BATCH, h, w, c], "dtype": cd,
                              "tile": list(sp.output_tile),
                              "cudnn_device_ms": library})
        pick = [r["device_ms"] for r in rows if r["chosen"]]
        picks[cd] = picks.get(cd, 0.0) + (pick[0] if pick else float("nan"))
        bests[cd] = bests.get(cd, 0.0) + min(r["device_ms"] for r in rows)
    log(json.dumps({"fit": "depthwise_strided_streamed",
                    "cost": "core/winograd.py:DEPTHWISE_STRIDED_COST",
                    "picks_ms": picks, "best_ms": bests,
                    "picks_over_best": {k: picks[k] / bests[k]
                                        for k in picks},
                    **fit_cost(fit_rows, ("load", "pix", "store", "item",
                                          "block"),
                               wg.DEPTHWISE_STRIDED_COST, ("launch",))}))
    return failed


def sweep_scan() -> list[str]:
    """`selective_scan` at path C's layer shape (LM_BATCH, LM_PROMPT, 8192,
    16) with fp32 and with bf16 dt / xs (B and C fp32, as the model widens
    them) under every (lanes, channels, chunk) that scan_blocking_fits
    takes: each launched twice, the two results bitwise equal and within
    TOL_SCAN of the plain version in float64 (scan_exact; the fp32 plain
    version's error reported), timed on the device; scan_blocking's pick
    marked, the bound (scan_bound) beside it."""
    import itertools

    import torch
    from repro_torch.kernels import selective_scan as ks
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    b, length, d, n = LM_BATCH, LM_PROMPT, 8192, 16
    failed = []
    for xdt in (torch.float32, torch.bfloat16):
        args = scan_inputs(b, length, d, n, xdt, torch.float32, gen, dev)
        want, exact = ks.selective_scan_plain(*args), scan_exact(args)
        plain_err = max(rel_err(w.double(), e) for w, e in zip(want, exact))
        x_size = args[0].element_size()
        chosen = ks.scan_blocking(b, d, n)
        rows = []
        for blk in itertools.product(ks.SCAN_LANES, ks.SCAN_CHANNELS,
                                     ks.SCAN_CHUNKS):
            if not ks.scan_blocking_fits(*blk, n, x_size, 4):
                continue
            call = lambda: ks.selective_scan(*args, blocking=blk)  # noqa
            got, again = call(), call()
            torch.cuda.synchronize()
            err = max(rel_err(g.double(), e) for g, e in zip(got, exact))
            err32 = max(rel_err(g, w) for g, w in zip(got, want))
            same = all(torch.equal(p, q) for p, q in zip(got, again))
            if err > TOL_SCAN or not same:
                failed.append(f"selective_scan {xdt} {blk}: rel err "
                              f"{err:.3e} (tol {TOL_SCAN}), reruns "
                              f"{'equal' if same else 'differ'}")
            rows.append({"lanes": blk[0], "channels": blk[1],
                         "chunk": blk[2],
                         "smem": ks.scan_smem_bytes(blk[1], blk[2], n,
                                                    x_size, 4),
                         "device_ms": graph_ms(call, reps=5, iters=5),
                         "rel_err_f64": err, "rel_err": err32,
                         "bitwise_rerun": same,
                         "chosen": blk == chosen})
            del got, again
        bound, by = scan_bound(b, length, d, n, x_size, 4)
        sweep_report("selective_scan", f"layer dt/xs {xdt}", rows, chosen,
                     {"shape": [b, length, d, n], "bound_ms": bound,
                      "bound_by": by, "plain_fp32_rel_err_f64": plain_err})
        del args, want, exact
    return failed


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only "
              "on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import compile as pt_compile
    from repro_torch.core import plan as pt_plan
    from repro_torch.core.transforms import DEFAULT_OUTPUT_TILE
    from repro_torch.kernels import build, ops
    from repro_torch.models import cnn

    dev = torch.device("cuda")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s")
    if set(Path(src).name for src, _ in KERNELS.values()) != set(built):
        raise AssertionError(f"built {sorted(built)}, expected the sources "
                             f"of {sorted(KERNELS)}")
    log_build(build.BUILD_LOGS, "build")

    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(dev)

    errs = {name: [0.0, 0.0] for name in KERNELS}   # max rel, max abs
    # vs the fp32 plain version, where the oracle is the float64 one
    errs_fp32 = {name: 0.0 for name in TF32X3 + ("selective_scan",)}

    def check(label, kernel, calls):
        err, abs_err, err_fp32 = compare(label, calls)
        errs[kernel][0] = max(errs[kernel][0], err)
        errs[kernel][1] = max(errs[kernel][1], abs_err)
        if err_fp32 is not None:
            errs_fp32[kernel] = max(errs_fp32[kernel], err_fp32)
        return err, abs_err

    # ---- 2. kernel vs plain version ----------------------------------------
    nets = {name: cnn.NETWORKS[name][0]() for name in FIRST + ZOO}
    res = {name: cnn.NETWORKS[name][1] for name in nets}
    params = {name: cnn.init_cnn(torch.Generator().manual_seed(0), specs, 3,
                                 res=res[name], device=dev)
              for name, specs in nets.items()}
    n_checks = 0
    checked = ([(name, "pallas_winograd", cd) for cd in ("float32",) + REDUCED
                for name in nets]
               + [(name, "pallas_winograd_materialized", "float32")
                  for name in EXPECTED_MATERIALIZED])
    for name, algorithm, cd in checked:
        net = pt_compile.compile(params[name], nets[name], res=res[name],
                                 batch=CHECK_BATCH, algorithm=algorithm,
                                 compute_dtype=cd, device=dev)
        for leaf in network_leaves(net):
            x = randn(CHECK_BATCH, *leaf.plan.spec.x_shape[1:])
            label = f"{name}[{algorithm} {cd}].{leaf.layer} {leaf.kernel}"
            err, _ = check(label, leaf.kernel, leaf_calls(leaf, x, randn))
            n_checks += 1
            log(f"[kernels] {label} {tuple(x.shape)}: max_rel_err "
                f"{err:.3e}")
        del net

    def conv_leaf(x_shape, wt, kernel, act="relu",
                  algorithm="pallas_winograd", **kw):
        plan = pt_plan.plan_conv2d(x_shape, wt, algorithm=algorithm,
                                   device=dev, **kw)
        if plan.spec.algorithm != {v: k for k, v in
                                   _EXECUTOR_KERNEL.items()}[kernel]:
            raise AssertionError(f"{kernel}: planned {plan.spec.algorithm}")
        return Leaf(kernel, "odd", plan, (act,))

    odd = []   # (label, leaf, x_shape)
    for k in sorted(DEFAULT_OUTPUT_TILE):
        shape = (2, 37, 29, 19)
        odd.append((f"k{k} 37x29x19->40", conv_leaf(
            shape, randn(k, k, 19, 40, scale=(k * k * 19) ** -0.5),
            "winograd_streamed"), shape))
    for cd in ("bfloat16", "int8"):
        shape = (2, 56, 56, 256)
        odd.append((f"conv3_1 56x56x256->256 {cd}", conv_leaf(
            shape, randn(3, 3, 256, 256, scale=(9 * 256) ** -0.5),
            "winograd_streamed", compute_dtype=cd), shape))
    # the tensor-core kernel's ragged edges: C 19 (a partial last C step of
    # any size), M 45 (not a multiple of 8), edge strips, P = 16, 25, 36,
    # 49, 64, each filter dtype
    for k, tile in ((3, 2), (2, None), (3, None), (4, None), (7, None)):
        for cd in ("float32", "bfloat16", "int8"):
            shape = (2, 37, 29, 19)
            leaf = conv_leaf(shape, randn(k, k, 19, 45,
                                          scale=(k * k * 19) ** -0.5),
                             "winograd_streamed", "relu6", output_tile=tile,
                             compute_dtype=cd)
            p = leaf.plan.spec.ct_h.t * leaf.plan.spec.ct_w.t
            odd.append((f"k{k} P{p} 37x29x19->45 {cd}", leaf, shape))
    # VALID padding (Inception-v3's conv1, conv2, conv5 and reductions), at
    # stride 1 and 2, beside the SAME shapes: no left pad, ragged last strip
    for k in (3, 5):
        for cd in ("float32", "bfloat16", "int8"):
            shape = (2, 37, 29, 19)
            odd.append((f"k{k} VALID 37x29x19->45 {cd}", conv_leaf(
                shape, randn(k, k, 19, 45, scale=(k * k * 19) ** -0.5),
                "winograd_streamed", padding="VALID", compute_dtype=cd),
                shape))
    for tile, cd in ((2, "float32"), (4, "float32"), (2, "int8")):
        shape = (2, 37, 26, 5)
        odd.append((f"stride-2 k3 F({tile},2) VALID 37x26x5->40 {cd}",
                    conv_leaf(shape, randn(3, 3, 5, 40, scale=(45) ** -0.5),
                              "winograd_strided_streamed", stride=2,
                              padding="VALID", output_tile=tile,
                              compute_dtype=cd), shape))
    # the 7x7 stride-2 stems at full width (GoogleNet 224x224x3 -> 64 at
    # T = 7 on the T = 8 body), bf16 at F(2, 4)
    for cd in ("float32", "bfloat16"):
        shape = (2, 224, 224, 3)
        odd.append((f"stride-2 k7 stem 224x224x3->64 {cd}", conv_leaf(
            shape, randn(7, 7, 3, 64, scale=147 ** -0.5),
            "winograd_strided_streamed", stride=2, compute_dtype=cd),
            shape))
    for k in (3, 5, 7):
        for tile in (2, 4):
            for cd in ("float32", "bfloat16", "int8"):
                if cd != "float32" and (k, tile) != (3, 4):
                    continue
                shape = (2, 37, 26, 5)
                odd.append((f"stride-2 k{k} F({tile},{(k + 1) // 2}) "
                            f"37x26x5->40 {cd}", conv_leaf(
                                shape, randn(k, k, 5, 40,
                                             scale=(k * k * 5) ** -0.5),
                                "winograd_strided_streamed", "relu6",
                                stride=2, output_tile=tile,
                                compute_dtype=cd), shape))
                shape = (2, 29, 34, 44)
                odd.append((f"stride-2 dw k{k} F({tile},{(k + 1) // 2}) "
                            f"29x34x44 {cd}", conv_leaf(
                                shape, randn(k, k, 1, 44, scale=1 / k),
                                "depthwise_strided_streamed", "gelu",
                                stride=2, groups=44, output_tile=tile,
                                compute_dtype=cd), shape))
    for k, (h, w, c), m in ((3, (23, 19, 37), 70), (5, (23, 19, 37), 70),
                            (7, (23, 19, 37), 70), (3, (23, 19, 37), 200),
                            (3, (15, 13, 19), 12), (5, (9, 30, 70), 136)):
        shape = (2, h, w, c)
        plan = pt_plan.plan_separable_block(
            shape, randn(k, k, 1, c, scale=1 / k),
            randn(1, 1, c, m, scale=c ** -0.5),
            algorithm="pallas_winograd", device=dev)
        odd.append((f"separable k{k} {h}x{w}x{c}->{m}",
                    Leaf("separable_streamed", "odd", plan,
                         ("relu6", "none")), shape))
    for k in (3, 5, 7):
        for tile in ((2, 4) if k < 7 else (2,)):
            for mult, cd in ((1, "float32"), (2, "float32"), (1, "bfloat16"),
                             (2, "int8")):
                shape = (2, 23, 19, 37)
                odd.append((f"dw k{k} F({tile},{k}) 23x19x37 x{mult} {cd}",
                            conv_leaf(shape, randn(k, k, 1, 37 * mult,
                                                   scale=1 / k),
                                      "depthwise_streamed", "relu6",
                                      groups=37, output_tile=tile,
                                      compute_dtype=cd), shape))
    for k in sorted(DEFAULT_OUTPUT_TILE):
        shape = (2, 37, 29, 19)
        odd.append((f"tiles k{k} 37x29x19->40", conv_leaf(
            shape, randn(k, k, 19, 40, scale=(k * k * 19) ** -0.5),
            "winograd_fused", algorithm="pallas_winograd_materialized"),
            shape))
    for cd in ("float32", "bfloat16", "int8"):
        shape = (3, 17, 11, 45)
        odd.append((f"matmul 561x45->70 {cd}", conv_leaf(
            shape, randn(1, 1, 45, 70, scale=45 ** -0.5), "matmul",
            algorithm="pallas_im2col", compute_dtype=cd), shape))
    for label, leaf, shape in odd:
        err, _ = check(label, leaf.kernel,
                       leaf_calls(leaf, randn(*shape), randn))
        n_checks += 1
        log(f"[kernels] {label} ({leaf.kernel}): max_rel_err {err:.3e}")
    # the sequence kernels: selective_scan at the falcon-mamba-7b layer
    # shape and odd ones (L 1, 37, 2064; D off the 128-channel block; N 4,
    # 8, 12; bf16 operands), conv1d_ct_fused at the short-conv tile shape
    # and odd ones (r 2..4, F(2, r) and F(4, r), C 200, L 2045, bf16 tiles)
    kd_, km_, kw_, kc, ks = kernel_modules()
    errs_bf16 = {"conv1d_ct_fused": [0.0, 0.0]}
    sgen = torch.Generator(device=dev).manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    short = {f32: "fp32", bf16: "bf16"}
    for b, length, d, n, xdt, bcdt in (
            (LM_BATCH, LM_PROMPT, 8192, 16, f32, f32),
            (LM_BATCH, LM_PROMPT + LM_TICKS, 8192, 16, f32, f32),
            (LM_BATCH, 1, 8192, 16, f32, f32), (2, 37, 8200, 16, f32, f32),
            (2, 300, 1000, 4, f32, f32), (2, 300, 1000, 8, f32, f32),
            (1, 129, 200, 12, f32, f32),
            (LM_BATCH, LM_PROMPT, 8192, 16, bf16, f32),
            (2, 256, 1000, 16, bf16, bf16)):
        args = scan_inputs(b, length, d, n, xdt, bcdt, sgen, dev)
        got = ks.selective_scan(*args)
        again = ks.selective_scan(*args)
        torch.cuda.synchronize()
        label = (f"selective_scan ({b}, {length}, {d}, {n}) dt/xs "
                 f"{short[xdt]} B/C {short[bcdt]}")
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            raise AssertionError(f"{label}: two launches differ")
        err, abs_err, err32, plain_err = scan_errors(label, got, args)
        errs["selective_scan"][0] = max(errs["selective_scan"][0], err)
        errs["selective_scan"][1] = max(errs["selective_scan"][1], abs_err)
        errs_fp32["selective_scan"] = max(errs_fp32["selective_scan"],
                                          err32)
        n_checks += 1
        log(f"[kernels] {label} blocking {ks.scan_blocking(b, d, n)}: "
            f"max_rel_err {err:.3e} against the plain version in float64 "
            f"(y, h_last; tol {TOL_SCAN}), {err32:.3e} against it in fp32 "
            f"(which reads {plain_err:.3e} from float64); two launches "
            f"bitwise equal")
        del args, got, again
    for r, tile, c, length, dtype in (
            [(4, 4, 8192, LM_PROMPT, f32), (4, 4, 8192, LM_PROMPT, bf16)]
            + [(r, tile, 200, 2045, f32) for r in (2, 3, 4)
               for tile in (2, 4)]
            + [(r, 4, 200, 2045, bf16) for r in (2, 3, 4)]):
        b = LM_BATCH if c == 8192 else 2
        x = torch.randn(b, length, c, generator=sgen, device=dev).to(dtype)
        w = (torch.randn(r, c, generator=sgen, device=dev) / r).to(dtype)
        plan = pt_plan.plan_depthwise_conv1d(x.shape, w, output_tile=tile,
                                             backend="pallas", device=dev)
        sp = plan.spec
        tiles = ops.conv1d_tiles(x, ct=sp.ct, n_tiles=sp.n_tiles,
                                 pad_hi=sp.pad_hi, c_pad=plan.u.shape[1])
        got = kc.conv1d_ct_fused(tiles, plan.u, ct=sp.ct,
                                 block_s=sp.blocks[0], block_c=sp.blocks[1])
        torch.cuda.synchronize()
        tol = TOL_KERNEL if dtype == f32 else TOL_BF16_OUT
        label = (f"conv1d_ct_fused F({tile},{r}) ({b}, {length}, {c}) "
                 f"{short[dtype]}")
        err, abs_err = compare_outputs(
            label, (got,), (kc.conv1d_ct_fused_plain(tiles, plan.u,
                                                     ct=sp.ct),), tol)
        table = errs if dtype == f32 else errs_bf16
        table["conv1d_ct_fused"][0] = max(table["conv1d_ct_fused"][0], err)
        table["conv1d_ct_fused"][1] = max(table["conv1d_ct_fused"][1],
                                          abs_err)
        n_checks += 1
        log(f"[kernels] {label}: max_rel_err {err:.3e} (tol {tol})")
        del x, tiles, got
    log(f"[kernels] {n_checks} kernel-vs-plain checks passed (tol "
        f"{TOL_KERNEL}; selective_scan {TOL_SCAN}; bf16 outputs "
        f"{TOL_BF16_OUT})")

    # ---- 3. the slices: each path at 224 through compile() -> apply -------
    launches = {name: 0 for name in KERNELS}
    launches_by_path = {}

    def drive(label, net, x, expected, record=None):
        """Two forwards of `net` on x, every launch counter set to 0 just
        before them and read just after, each plan's launches counted
        around its own apply. Fails unless the counts are `expected` per
        forward, each plan launching its own kernels twice, the logits are
        finite (batch, 1000) and the two forwards bitwise equal. Returns
        the logits and the counts per plan; `record`, a dict, receives each
        plan's (args, kwargs, output) of the first forward."""
        per_plan = {nid: {k: 0 for k in KERNELS} for nid in net.plans}

        def counted(nid, apply):
            def run(*args, **kwargs):
                before = read_counts()
                y = apply(*args, **kwargs)
                for k, v in read_counts().items():
                    per_plan[nid][k] += v - before[k]
                if record is not None and nid not in record:
                    record[nid] = (args, kwargs, y)
                return y
            return run

        for nid in per_plan:
            net.plans[nid].apply = counted(nid, net.plans[nid].apply)
        reset_counts()
        y1 = net.apply(x)
        y2 = net.apply(x)
        torch.cuda.synchronize()
        counts = read_counts()
        for nid in per_plan:
            del net.plans[nid].apply
        want = {k: 2 * expected.get(k, 0) for k in KERNELS}
        leaf_kernels = {}
        for leaf in network_leaves(net):
            leaf_kernels.setdefault(leaf.layer.split(".")[0], []).append(
                leaf.kernel)
        plan_ok = all(
            per_plan[nid] == {k: 2 * leaf_kernels.get(nid, []).count(k)
                              for k in KERNELS} for nid in per_plan)
        log(f"[slice] {label}: 2 forwards, launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
        if counts != want or not plan_ok or any(
                sum(c[k] for c in per_plan.values()) != counts[k]
                for k in KERNELS):
            raise AssertionError(f"{label}: expected {want} launches over 2 "
                                 f"forwards, each plan launching its own "
                                 f"kernels twice; got {counts}, {per_plan}")
        for k, v in counts.items():
            launches[k] += v
        launches_by_path[label] = {k: v for k, v in counts.items() if v}
        if y1.shape != (x.shape[0], 1000) or not torch.isfinite(y1).all():
            raise AssertionError(f"{label}: bad logits, shape "
                                 f"{tuple(y1.shape)}")
        if not torch.equal(y1, y2):
            raise AssertionError(f"{label}: two forwards of the same input "
                                 f"differ")
        return y1, per_plan

    def top1(a, b):
        return f"{int((a.argmax(1) == b.argmax(1)).sum())}/{a.shape[0]}"

    def compiled(name, batch, algorithm="pallas_winograd", cd="float32"):
        t0 = time.perf_counter()
        net = pt_compile.compile(params[name], nets[name], res=res[name],
                                 batch=batch, algorithm=algorithm,
                                 compute_dtype=cd, device=dev)
        torch.cuda.synchronize()
        log(f"[slice] compiled {name} {algorithm} {cd} batch {batch} at "
            f"{res[name]} in {time.perf_counter() - t0:.2f} s")
        return net

    def image(name, batch):
        return randn(batch, res[name], res[name], 3)

    def held(name, label, x, y, want, want_label):
        """The logits y against `want` (TOL_NET_PLAIN) and against the
        direct F.conv2d network on the same input (TOL_NET_DIRECT)."""
        y_direct = direct_forward(params[name], nets[name], x)
        torch.cuda.synchronize()
        e_want, e_direct = rel_err(y, want), rel_err(y, y_direct)
        log(f"[slice] {label} logits rel err vs {want_label} {e_want:.3e} "
            f"(tol {TOL_NET_PLAIN}), vs direct F.conv2d network "
            f"{e_direct:.3e} (tol {TOL_NET_DIRECT}); top-1 agreement "
            f"{top1(y, y_direct)}")
        if e_want > TOL_NET_PLAIN or e_direct > TOL_NET_DIRECT:
            raise AssertionError(f"{label}: logits disagree with the oracles")
        return e_want, e_direct

    # fp32 pallas_winograd, batch 4; the rest of the zoo also at batch 1
    # (the earlier networks' batch-1 fp32 plans are timed only)
    mains, logit_errs, fp32_b1 = {}, {}, {}
    inception_record: dict = {}
    for name in nets:
        net = compiled(name, MAIN_BATCH)
        log(net.describe())
        x = image(name, MAIN_BATCH)
        y1, per_plan = drive(
            f"{name} float32 batch {MAIN_BATCH}", net, x, EXPECTED[name],
            inception_record if name == "inception_v3" else None)
        plain_net = compiled(name, MAIN_BATCH, "winograd")
        e_plain, e_direct = held(name, name, x, y1, plain_net.apply(x),
                                 "plain-executor network")
        logit_errs[name] = {"vs_plain": e_plain, "vs_direct": e_direct}
        del plain_net
        mains[name] = (net, per_plan, x, y1)
        fp32_b1[name] = compiled(name, 1)
        if name in ZOO:
            drive(f"{name} float32 batch 1", fp32_b1[name], image(name, 1),
                  EXPECTED[name])

    # path A: pallas_winograd at bfloat16 / int8, batch 4 (the earlier
    # networks also at batch 1); the fp32 network at the same batch is the
    # ungated comparison there
    reduced = {}                        # (name, cd, batch) -> (net, per_plan)
    for name in nets:
        for cd in REDUCED:
            for batch in ((MAIN_BATCH, 1) if name in FIRST
                          else (MAIN_BATCH,)):
                net = compiled(name, batch, cd=cd)
                if batch == MAIN_BATCH:
                    log(net.describe())
                label = f"{name} {cd} batch {batch}"
                x = mains[name][2] if batch == MAIN_BATCH else image(name, 1)
                record = {}
                y, per_plan = drive(label, net, x, EXPECTED_REDUCED[name],
                                    record)
                before = read_counts()
                if set(record) != set(net.plans):
                    raise AssertionError(f"{label}: a plan was not recorded")
                with plain_kernels():
                    y_plain = net.apply(x)
                    # each plan on its own recorded input
                    e_layer = max(rel_err(out, net.plans[nid].apply(
                        *args, **kwargs))
                        for nid, (args, kwargs, out) in record.items())
                torch.cuda.synchronize()
                if read_counts() != before:
                    raise AssertionError(f"{label}: the plain run launched")
                del record
                y32 = mains[name][3] if batch == MAIN_BATCH else \
                    fp32_b1[name].apply(x)
                e_plain, e32 = rel_err(y, y_plain), rel_err(y, y32)
                logit_errs[label] = {"per_plan_vs_plain_kernels": e_layer,
                                     "tol": TOL_NET_PLAIN,
                                     "vs_plain_kernels": e_plain,
                                     "vs_float32_network": e32,
                                     "top1_vs_float32": top1(y, y32)}
                log(f"[slice] {label} rel err vs the plain versions, "
                    f"largest per plan on its recorded input {e_layer:.3e} "
                    f"(tol {TOL_NET_PLAIN}); logits vs the same plan on the "
                    f"plain versions {e_plain:.3e}, vs the fp32 network "
                    f"{e32:.3e}, top-1 agreement {top1(y, y32)} (not gated)")
                if e_layer > TOL_NET_PLAIN:
                    raise AssertionError(f"{label}: a plan disagrees with "
                                         f"its plain versions")
                reduced[(name, cd, batch)] = (net, per_plan)

    # path B: pallas_winograd_materialized, VGG-16 and Inception-v3 (5x5
    # and VALID layers on the tiles-domain kernel), batch 4, against the
    # streamed network
    mats = {}
    for name, expected in EXPECTED_MATERIALIZED.items():
        mat = compiled(name, MAIN_BATCH, "pallas_winograd_materialized")
        log(mat.describe())
        x = mains[name][2]
        y_mat, mat_per_plan = drive(f"{name} materialized batch {MAIN_BATCH}",
                                    mat, x, expected)
        e_stream, e_direct = held(name, f"{name} materialized", x, y_mat,
                                  mains[name][3], "the streamed network")
        logit_errs[f"{name} materialized"] = {"vs_streamed": e_stream,
                                              "vs_direct": e_direct}
        mats[name] = (mat, mat_per_plan)

    # ---- path C: falcon-mamba-7b, init -> prefill -> greedy decode ---------
    import torch.nn.functional as F
    from repro_torch import configs as pt_cfgs
    from repro_torch.launch import steps as pt_steps
    from repro_torch.models import transformer as pt_tf
    lm: dict[str, Any] = {}
    cfg = pt_cfgs.get_config(LM_ARCH)
    t0 = time.perf_counter()
    params32 = pt_tf.init_params(torch.Generator(device=dev).manual_seed(0),
                                 cfg, torch.float32, device=dev)
    torch.cuda.synchronize()
    leaves = tree_leaves(params32)
    lm["n_params"] = sum(t.numel() for t in leaves)
    lm["init_s"] = time.perf_counter() - t0
    log(f"[lm] init_params {cfg.name} fp32 on the card: "
        f"{lm['n_params'] / 1e9:.3f} B params, "
        f"{sum(t.nbytes for t in leaves) / 1e9:.2f} GB, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, in "
        f"{lm['init_s']:.2f} s")
    del leaves
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    prefill_step = pt_steps.make_prefill_step(cfg, LM_PROMPT + LM_TICKS)
    serve_step = pt_steps.make_serve_step(cfg)

    def generate(params, label):
        """The main path (lm_generate); its launches join the rows."""
        logits, tokens, counts = lm_generate(
            prefill_step, serve_step, params, prompt, LM_TICKS, label,
            EXPECTED_PREFILL)
        for path, c in counts.items():
            for k in KERNELS:
                launches[k] += c[k]
            launches_by_path[path] = {k: v for k, v in c.items() if v}
        return logits, tokens

    def gate_scan(params, label, record=None):
        """Gate (a) (lm_gate_scan), its errors joining the kernel row."""
        logits, worst = lm_gate_scan(prefill_step, params, prompt,
                                     EXPECTED_PREFILL["selective_scan"],
                                     label, record)
        errs["selective_scan"][0] = max(errs["selective_scan"][0], worst[0])
        errs["selective_scan"][1] = max(errs["selective_scan"][1], worst[1])
        errs_fp32["selective_scan"] = max(errs_fp32["selective_scan"],
                                          worst[2])
        return logits, worst[0]

    def timed_lm(params, label):
        return time_lm(prefill_step, serve_step, params, prompt, LM_TICKS,
                       label)

    # fp32: the main path, then gates (a), (b), (c)
    y32, toks32 = generate(params32, "falcon-mamba-7b float32")
    rec: dict = {}
    with conv_recorded(rec):
        logits_a, err_a = gate_scan(params32, "falcon-mamba-7b float32",
                                    record=rec)
    if not torch.equal(logits_a, y32[:, 0]):
        raise AssertionError("fp32 prefill: two runs of the same prompt "
                             "differ")
    with plain_kernels():
        logits_plain, _ = prefill_step(params32, {"tokens": prompt})
    torch.cuda.synchronize()
    err_b = rel_err(y32[:, 0], logits_plain)
    log(f"[lm] falcon-mamba-7b float32 gate (b): prefill logits against "
        f"the same model on the plain versions {err_b:.3e} (tol "
        f"{TOL_LM_PLAIN}); top-1 agreement "
        f"{top1(y32[:, 0], logits_plain)}")
    if err_b > TOL_LM_PLAIN:
        raise AssertionError("falcon-mamba-7b: prefill logits disagree with "
                             "the plain-kernel model")
    full = pt_tf.forward_logits(params32, torch.cat([prompt, toks32], 1), cfg)
    want = full[:, LM_PROMPT - 1:]
    del full
    per_pos = [rel_err(y32[:, j], want[:, j]) for j in range(1 + LM_TICKS)]
    err_c = max(per_pos)
    log(f"[lm] falcon-mamba-7b float32 gate (c): prefill({LM_PROMPT}) + "
        f"{LM_TICKS} teacher-forced decode steps against forward_logits "
        f"on {LM_PROMPT + LM_TICKS} tokens, rel err by position "
        f"{[f'{e:.2e}' for e in per_pos]} (tol {TOL_LM_INVARIANT}); "
        f"argmax agreement {int((y32.argmax(-1) == want.argmax(-1)).sum())}"
        f"/{LM_BATCH * (1 + LM_TICKS)}")
    if err_c > TOL_LM_INVARIANT:
        raise AssertionError("falcon-mamba-7b: prefill-then-decode "
                             "disagrees with forward_logits")
    del want
    lm["float32"] = {"gate_a_scan_rel_err": err_a,
                     "gate_b_plain_rel_err": err_b,
                     "gate_c_invariant_rel_err": per_pos,
                     "tokens": toks32.tolist()}
    lm["float32"].update(timed_lm(params32, "falcon-mamba-7b float32"))

    # bf16: the same weights cast, the main path, gate (a); its logits and
    # tokens against fp32, not gated
    w_conv0 = params32["blocks"]["layer_0"]["mamba"]["conv_w"][0].clone()
    params16 = cast_like_init(params32, torch.bfloat16)
    del params32, logits_a, logits_plain
    torch.cuda.empty_cache()
    y16, toks16 = generate(params16, "falcon-mamba-7b bfloat16")
    _, err_a16 = gate_scan(params16, "falcon-mamba-7b bfloat16")
    e16 = rel_err(y16[:, 0], y32[:, 0])
    same = int((toks16 == toks32).sum())
    log(f"[lm] falcon-mamba-7b bfloat16 prefill logits against fp32 "
        f"{e16:.3e}, top-1 agreement {top1(y16[:, 0], y32[:, 0])}, decoded "
        f"tokens equal to fp32's {same}/{toks32.numel()} (not gated)")
    lm["bfloat16"] = {"gate_a_scan_rel_err": err_a16,
                      "prefill_logits_vs_float32": e16,
                      "tokens_equal_to_float32": same,
                      "tokens": toks16.tolist()}
    lm["bfloat16"].update(timed_lm(params16, "falcon-mamba-7b bfloat16"))
    del params16
    torch.cuda.empty_cache()

    # ---- path D: the planned short conv on the conv1d kernel ---------------
    r_conv, c_conv = w_conv0.shape
    path_d = []
    for source, x in (("layer 0 input", rec["conv"]),
                      ("random", torch.randn(rec["conv"].shape,
                                             generator=sgen, device=dev))):
        for dtype in (f32, bf16):
            xd, wd = x.to(dtype), w_conv0.to(dtype)
            plan_p = pt_plan.plan_depthwise_conv1d(xd.shape, wd,
                                                   backend="pallas",
                                                   device=dev)
            reset_counts()
            y = plan_p.apply(xd)
            torch.cuda.synchronize()
            counts = read_counts()
            if counts != {k: int(k == "conv1d_ct_fused") for k in KERNELS}:
                raise AssertionError(f"path D: {counts} launches per apply")
            launches["conv1d_ct_fused"] += counts["conv1d_ct_fused"]
            y_jnp = pt_plan.plan_depthwise_conv1d(
                xd.shape, wd, backend="jnp", device=dev).apply(xd)
            y_dir = F.conv1d(xd.float().transpose(1, 2),
                             wd.float().t()[:, None, :], padding=r_conv - 1,
                             groups=c_conv)[..., :xd.shape[1]].transpose(1, 2)
            e_jnp, e_dir = rel_err(y.float(), y_jnp.float()), \
                rel_err(y.float(), y_dir)
            tol_dir = TOL_KERNEL if dtype == f32 else TOL_CONV1D_BF16_DIRECT
            row = {"input": source, "dtype": short[dtype],
                   "shape": list(xd.shape), "tile": plan_p.spec.output_tile,
                   "blocks": list(plan_p.spec.blocks),
                   "launches": counts["conv1d_ct_fused"],
                   "vs_jnp_plan": e_jnp, "vs_direct_conv1d": e_dir,
                   "tol_direct": tol_dir}
            path_d.append(row)
            log(f"[path D] {source} {short[dtype]} {tuple(xd.shape)}: "
                f"pallas plan against the jnp plan {e_jnp:.3e}, against "
                f"a direct F.conv1d {e_dir:.3e} (tol {tol_dir}), "
                f"{counts['conv1d_ct_fused']} launch")
            if e_dir > tol_dir or (dtype == f32 and e_jnp > TOL_KERNEL):
                raise AssertionError(f"path D {source} {short[dtype]}: the "
                                     f"planned conv disagrees")
            del xd, y, y_jnp, y_dir
    launches_by_path[f"path D ({len(path_d)} applies)"] = {
        "conv1d_ct_fused": sum(row["launches"] for row in path_d)}
    lm["path_d"] = path_d

    # ---- 4. timings ---------------------------------------------------------
    rows = {name: [] for name in KERNELS}
    # the rest of the zoo's fp32 layers under their own path label, so that
    # the kernel rows sum the earlier networks' layers as before
    timed = [(name, "float32" if name in FIRST else "float32 zoo", net,
              per_plan, None)
             for name, (net, per_plan, _, _) in mains.items()]
    timed += [(name, cd, *reduced[(name, cd, MAIN_BATCH)],
               ("depthwise_streamed", "depthwise_strided_streamed", "matmul",
                "winograd_strided_streamed"))
              for name in ("mobilenet_v1", "mobilenet_v2") for cd in REDUCED]
    timed.append(("vgg16", "materialized", *mats["vgg16"], None))
    for name, path, net, per_plan, only in timed:
        for leaf in network_leaves(net):
            if only is not None and leaf.kernel not in only:
                continue
            x = randn(MAIN_BATCH, *leaf.plan.spec.x_shape[1:])
            calls = leaf_calls(leaf, x, randn)
            # the main path's own plan and shapes, against the plain version
            err, abs_err = check(f"{name}[{path}].{leaf.layer} batch "
                                 f"{MAIN_BATCH}", leaf.kernel, calls)
            ms = cuda_ms(calls[0], 20)
            plain_ms = cuda_ms(calls[1], 3, warmup=1)
            lib_ms = cuda_ms(calls[2], 20)
            device_ms = graph_ms(calls[0])
            lib_device_ms = graph_ms(calls[2])
            bound = leaf_bound(leaf, MAIN_BATCH)
            s = leaf.plan.spec
            blocks = ([s.stream.bh, s.stream.bw, s.stream.block_c,
                       s.stream.block_m] if s.stream is not None
                      else list(s.blocks))
            rows[leaf.kernel].append(dict(
                net=name, path=path, layer=leaf.layer,
                shape=[MAIN_BATCH, *s.x_shape[1:]],
                tile=list(s.output_tile) if s.output_tile else None,
                blocks=blocks,
                launches=per_plan[leaf.layer.split(".")[0]][leaf.kernel],
                max_rel_err=err, max_abs_err=abs_err, ms=ms,
                device_ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_device_ms, **bound))
            log(f"[timing] {name}[{path}].{leaf.layer} {leaf.kernel} "
                f"{tuple(x.shape)} blocks {blocks}: kernel {ms:.4f} ms per "
                f"call, {device_ms:.4f} ms on the device "
                f"({bound['gflop'] / device_ms:.2f} TFLOP/s, "
                f"{bound['mbytes'] / device_ms:.0f} GB/s), plain "
                f"{plain_ms:.3f} ms, library {lib_ms:.4f} / "
                f"{lib_device_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                f"({bound['bound_by']}; fp32 reckoning "
                f"{bound['bound_fp32_ms']:.4f}), max_rel_err {err:.2e}")
    for kernel, layer_rows in rows.items():
        for path in sorted({r["path"] for r in layer_rows}):
            sel = [r for r in layer_rows if r["path"] == path]
            log(f"[timing] {kernel} [{path}] over {len(sel)} layers: "
                + ", ".join(f"{key} {sum(r[key] for r in sel):.4f}"
                            for key in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_fp32_ms",
                                        "library_ms", "library_device_ms")))

    # the depthwise kernels per layer and path, cuDNN's beside them
    for kernel in ("depthwise_streamed", "depthwise_strided_streamed"):
        per_layer: dict = {}
        for r in rows[kernel]:
            per_layer.setdefault(f"{r['net']}.{r['layer']}", {})[
                r["path"]] = [r["device_ms"], r["library_device_ms"],
                              r["blocks"]]
        log(f"[timing] {kernel} per layer, device ms [kernel, cuDNN, "
            f"blocking]: {json.dumps(per_layer)}")

    # path B against the streamed path, layer by layer: the whole ConvPlan
    # apply (materialized: pad, tile extraction, kernel, un-tiling,
    # bias + relu; streamed: pad, kernel with its fused epilogue, crop).
    # Each plan is held against itself on its plain versions run in
    # float64, as its TF32x3 kernel is (compare); their difference is
    # reported.
    ab = []
    streamed_net = mains["vgg16"][0]
    for nid, mplan in mats["vgg16"][0].plans.items():
        splan = streamed_net.plans[nid]
        x = randn(MAIN_BATCH, *mplan.spec.x_shape[1:])
        b = randn(mplan.spec.w_shape[3], scale=0.1)
        m_apply = lambda: mplan.apply(x, bias=b, activation="relu")  # noqa
        s_apply = lambda: splan.apply(x, bias=b, activation="relu")  # noqa
        y_m, y_s = m_apply(), s_apply()
        with plain_kernels(), double_plain():
            m_exact = mplan.apply(x.double(), bias=b.double(),
                                  activation="relu")
            s_exact = splan.apply(x.double(), bias=b.double(),
                                  activation="relu")
        e_m = rel_err(y_m.double(), m_exact)
        e_s = rel_err(y_s.double(), s_exact)
        err = rel_err(y_m, y_s)
        row = {"layer": nid, "shape": [MAIN_BATCH, *mplan.spec.x_shape[1:]],
               "c_out": mplan.spec.w_shape[3],
               "materialized_ms": cuda_ms(m_apply, 10),
               "materialized_device_ms": graph_ms(m_apply, reps=5),
               "streamed_ms": cuda_ms(s_apply, 10),
               "streamed_device_ms": graph_ms(s_apply, reps=5),
               "rel_err": err, "materialized_vs_plain_float64": e_m,
               "streamed_vs_plain_float64": e_s}
        if e_m > TOL_KERNEL or e_s > TOL_KERNEL:
            raise AssertionError(f"A/B {nid}: a plan disagrees with its "
                                 f"plain versions ({e_m:.3e}, {e_s:.3e})")
        ab.append(row)
        log(f"[ab] vgg16.{nid} {tuple(x.shape)}->{row['c_out']}: "
            f"materialized {row['materialized_device_ms']:.4f} ms on the "
            f"device ({row['materialized_ms']:.4f} per call), streamed "
            f"{row['streamed_device_ms']:.4f} ({row['streamed_ms']:.4f}); "
            f"rel err vs plain in float64 {e_m:.1e} / {e_s:.1e}, between "
            f"the two {err:.1e}")
    log("[ab] sum over the 13 layers: " + ", ".join(
        f"{key} {sum(r[key] for r in ab):.4f}"
        for key in ("materialized_ms", "materialized_device_ms",
                    "streamed_ms", "streamed_device_ms")))

    forward = {}

    def time_forward(key, net, batch, specs=None, params_=None):
        xb = randn(batch, *net.input_shape[1:])
        port = lambda: net.apply(xb)                         # noqa: E731
        forward[f"{key}_ms"] = cuda_ms(port, 10)
        forward[f"{key}_device_ms"] = graph_ms(port, reps=3)
        if specs is not None:
            cudnn = lambda: direct_forward(params_, specs, xb)  # noqa: E731
            forward[f"{key}_cudnn_ms"] = cuda_ms(cudnn, 10)
            forward[f"{key}_cudnn_device_ms"] = graph_ms(cudnn, reps=3)

    for name, specs in nets.items():
        for batch, net in ((1, fp32_b1[name]), (MAIN_BATCH, mains[name][0])):
            time_forward(f"{name}_batch{batch}", net, batch, specs,
                         params[name])
        for cd in REDUCED:
            for batch in ((1, MAIN_BATCH) if name in FIRST
                          else (MAIN_BATCH,)):
                time_forward(f"{name}_{cd}_batch{batch}",
                             reduced[(name, cd, batch)][0], batch)
    for name, (mat, _) in mats.items():
        time_forward(f"{name}_materialized_batch{MAIN_BATCH}", mat,
                     MAIN_BATCH)
    log(f"[timing] whole forward: {json.dumps(forward)}")
    forward["mobilenet_v1_profile_batch4"] = profile_forward(
        mains["mobilenet_v1"][0], image("mobilenet_v1", MAIN_BATCH))
    forward["mobilenet_v1_bfloat16_profile_batch4"] = profile_forward(
        reduced[("mobilenet_v1", "bfloat16", MAIN_BATCH)][0],
        image("mobilenet_v1", MAIN_BATCH))
    inception = mains["inception_v3"][0]
    one_d = [nid for nid, p in inception.plans.items()
             if p.algorithm == "winograd_1d"]
    forward["inception_v3_profile_batch4"] = profile_forward(
        inception, mains["inception_v3"][2], ranges={"winograd_1d": one_d})
    forward["inception_v3_winograd_1d"] = winograd_1d_family(
        inception, one_d, inception_record, params["inception_v3"])
    del inception_record


    # the sequence kernels at the main paths' shapes: selective_scan on
    # layer 0's recorded scan inputs (path C, fp32), conv1d_ct_fused on
    # layer 0's recorded short-conv input (path D, fp32 and bf16)
    seq_rows = {}
    args = rec["scan"]
    b, length, d = args[0].shape
    n = args[4].shape[1]
    calls = (lambda: ks.selective_scan(*args),
             lambda: ks.selective_scan_plain(*args, chunk=cfg.ssm.scan_chunk))
    err, abs_err, err32, _ = scan_errors("selective_scan layer 0",
                                         calls[0](), args,
                                         cfg.ssm.scan_chunk)
    bound, by = scan_bound(b, length, d, n, args[0].element_size(),
                           args[2].element_size())
    row = dict(shape=[b, length, d, n], blocking=ks.scan_blocking(b, d, n),
               launches_per_prefill=cfg.n_layers,
               max_rel_err=err, max_abs_err=abs_err,
               max_rel_err_vs_fp32_plain=err32,
               ms=cuda_ms(calls[0], 20), device_ms=graph_ms(calls[0], 5, 5),
               plain_ms=cuda_ms(calls[1], 2, warmup=1), bound_ms=bound,
               bound_by=by, library_ms=None, library_device_ms=None)
    seq_rows["selective_scan"] = [row]
    log(f"[timing] selective_scan {tuple(row['shape'])} fp32: "
        f"{row['ms']:.4f} ms per call, {row['device_ms']:.4f} on the "
        f"device, plain {row['plain_ms']:.2f}, bound {bound:.4f} ({by}); "
        f"{cfg.n_layers} per prefill: "
        f"{cfg.n_layers * row['device_ms']:.2f} ms")
    seq_rows["conv1d_ct_fused"] = []
    for dtype in (f32, bf16):
        xd, wd = rec["conv"].to(dtype), w_conv0.to(dtype)
        plan_p = pt_plan.plan_depthwise_conv1d(xd.shape, wd, backend="pallas",
                                               device=dev)
        plan_j = pt_plan.plan_depthwise_conv1d(xd.shape, wd, backend="jnp",
                                               device=dev)
        sp = plan_p.spec
        tiles = ops.conv1d_tiles(xd, ct=sp.ct, n_tiles=sp.n_tiles,
                                 pad_hi=sp.pad_hi, c_pad=plan_p.u.shape[1])
        xc = xd.transpose(1, 2).contiguous()
        wl = wd.t()[:, None, :].contiguous()
        calls = (lambda: kc.conv1d_ct_fused(tiles, plan_p.u, ct=sp.ct,
                                            block_s=sp.blocks[0],
                                            block_c=sp.blocks[1]),
                 lambda: kc.conv1d_ct_fused_plain(tiles, plan_p.u, ct=sp.ct),
                 lambda: F.conv1d(xc, wl, padding=r_conv - 1,
                                  groups=c_conv))
        err, abs_err = compare_outputs(
            f"conv1d_ct_fused path D {short[dtype]}", (calls[0](),),
            (calls[1](),), TOL_KERNEL if dtype == f32 else TOL_BF16_OUT)
        bound, by = conv1d_bound(xd.shape[0], sp.n_tiles, c_conv, sp.ct,
                                 xd.element_size(), plan_p.u.element_size())
        row = dict(dtype=short[dtype], shape=list(tiles.shape),
                   launches_per_apply=1, max_rel_err=err,
                   max_abs_err=abs_err, ms=cuda_ms(calls[0], 20),
                   device_ms=graph_ms(calls[0]),
                   plain_ms=cuda_ms(calls[1], 5, warmup=1),
                   bound_ms=bound, bound_by=by,
                   library_ms=cuda_ms(calls[2], 20),
                   library_device_ms=graph_ms(calls[2]),
                   pallas_plan_apply_ms=cuda_ms(lambda: plan_p.apply(xd), 20),
                   pallas_plan_apply_device_ms=graph_ms(
                       lambda: plan_p.apply(xd)),
                   # per call only, as the reference runs this path
                   jnp_plan_apply_ms=cuda_ms(lambda: plan_j.apply(xd), 20))
        seq_rows["conv1d_ct_fused"].append(row)
        log(f"[timing] conv1d_ct_fused {tuple(tiles.shape)} "
            f"{short[dtype]}: {json.dumps(row)}")
        del xd, tiles, xc

    # ---- 5. serve: the serving runtime on MobileNet-v2, Inception-v3 and
    # GoogleNet int8 (serve_phase); its runs' launches join the paths'
    serve_report, serve_counts = serve_phase(
        dev, params, nets, res, {n: m[0] for n, m in mains.items()})
    for path, counts in serve_counts.items():
        for k, v in counts.items():
            launches[k] += v
        launches_by_path[path] = {k: v for k, v in counts.items() if v}
    log(json.dumps({"serve": serve_report}))

    # ---- 6. the measured auto_tuned planner (autotune_phase): VGG-16 and
    # GoogleNet raced layer by layer, compute_dtype="auto", the spec cache,
    # an artifact warm start, ResNeXt's grouped conv and the device times
    autotune_report, autotune_counts, auto_nets = autotune_phase(
        dev, params, nets, res, {n: m[0] for n, m in mains.items()}, randn)
    for path, counts in autotune_counts.items():
        launches_by_path[path] = {k: v for k, v in counts.items() if v}
    log(json.dumps({"autotune": autotune_report}))

    # ---- 7. the per-call API and the 1-D path: the Whisper stem, the
    # spec-walk cnn_forward, the per-call wrappers (their launches join the
    # kernels' rows), the tuning database and the profiler's overhead
    per_call_report, per_call_counts, per_call_errs = per_call_phase(
        dev, params, nets, {n: (m[0], m[2], m[3]) for n, m in mains.items()},
        randn)
    for path, counts in per_call_counts.items():
        for k, v in counts.items():
            launches[k] += v
        launches_by_path[path] = {k: v for k, v in counts.items() if v}
    for name, (err, abs_err) in per_call_errs.items():
        errs[name][0] = max(errs[name][0], err)
        errs[name][1] = max(errs[name][1], abs_err)
    per_call_report["tuning_db"] = tuningdb_phase(
        dev, params, nets, res, auto_nets, autotune_report)
    del auto_nets
    per_call_report["observe"] = observe_phase(dev, params, nets, res)
    log(json.dumps({"per_call": per_call_report}))

    # ---- 8. partitioned plans on a mesh that repeats the card: VGG-16 and
    # GoogleNet spatial, MobileNet-v2 data, its sharded serving buckets and
    # the partitioned artifact's warm start (their launches join the rows)
    partition_report, partition_counts = partition_phase(
        dev, params, nets, res,
        {n: (m[0], m[2], m[3]) for n, m in mains.items()},
        serve_report["traffic"], check, randn)
    for path, counts in partition_counts.items():
        for k, v in counts.items():
            launches[k] += v
        launches_by_path[path] = {k: v for k, v in counts.items() if v}
    log(json.dumps({"partition": partition_report}))

    # ---- 9. the rest of the LM stack served: jamba's period at full width
    # (path E, its prefill's launches join selective_scan's row), qwen2.5-3b
    # behind launch/serve.Server (path F), whisper-tiny's encoder-decoder
    # (path G) and the other six architectures at full width
    lm_serve_report, lm_serve_counts, lm_scan = lm_serving_phase(dev)
    for path, counts in lm_serve_counts.items():
        for k, v in counts.items():
            launches[k] += v
        launches_by_path[path] = {k: v for k, v in counts.items() if v}
    errs["selective_scan"][0] = max(errs["selective_scan"][0],
                                    lm_scan["scan"][0])
    errs["selective_scan"][1] = max(errs["selective_scan"][1],
                                    lm_scan["scan"][1])
    errs_fp32["selective_scan"] = max(errs_fp32["selective_scan"],
                                      lm_scan["scan"][2])
    seq_rows["selective_scan"].append(lm_scan["scan_row"])
    log(json.dumps({"lm_serving": lm_serve_report}))

    # ---- 10. training: falcon's gradients at full width against float64,
    # falcon training at full width (path H, its steps' launches join
    # selective_scan's row) and whisper-tiny's train driver with a restart
    # (path I)
    train_report, train_counts = training_phase(dev)
    for path, counts in train_counts.items():
        for k, v in counts.items():
            launches[k] += v
        launches_by_path[path] = {k: v for k, v in counts.items() if v}
    log(json.dumps({"training": train_report}))

    # ---- 11. the LM's meshes on a mesh that repeats the card: falcon's
    # sharded train step on (2, 2) (its launches join selective_scan's
    # row), whisper-tiny's elastic restart, qwen2.5-3b's Server(mesh=)
    mesh_report, mesh_counts = mesh_phase(
        dev, train_report["path_h"]["step_ms"],
        lm_serve_report["path_f"]["ms_per_step"])
    for path, counts in mesh_counts.items():
        for k, v in counts.items():
            launches[k] += v
        launches_by_path[path] = {k: v for k, v in counts.items() if v}
    log(json.dumps({"mesh": mesh_report}))

    # ---- 12. the dry run: path H's configuration on "meta" tensors against
    # one real path H step (its launches are not the main path's: they
    # join launches_by_path only), phase 11 (a)'s step beside its peak
    dry_report, dry_counts = dryrun_phase(
        dev, train_report["path_h"]["step_ms"], mesh_report)
    for path, counts in dry_counts.items():
        launches_by_path[path] = {k: v for k, v in counts.items() if v}
    log(json.dumps({"dryrun": dry_report}))

    # ---- 13. the example scripts: each examples/torch/ script's main() as
    # a user first runs it (their counted runs' launches join the rows)
    examples_report, examples_counts = examples_phase()
    for path, counts in examples_counts.items():
        for k, v in counts.items():
            launches[k] += v
        launches_by_path[path] = {k: v for k, v in counts.items() if v}
    log(json.dumps({"examples": examples_report}))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if name in seq_rows:
            main = seq_rows[name][0]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name][1], "max_rel_err": errs[name][0],
                **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                        "bound_ms", "library_ms",
                                        "library_device_ms")},
                # operations on the special-function unit are operations
                "bound_by": ("bytes" if main["bound_by"] == "bytes"
                             else "operations"),
                "bound_unit": {"sfu": "special-function unit (exp2)",
                               "operations": "fp32 CUDA cores",
                               "bytes": "memory"}[main["bound_by"]],
                "oracle": ("the plain version in float64"
                           if name == "selective_scan"
                           else "the plain version"),
                "max_rel_err_vs_fp32_plain": errs_fp32.get(name),
                "library": LIBRARY[name],
                "shapes": ("path C's layer shape, layer 0's recorded scan "
                           "inputs, fp32 (row 0); path E's (jamba) the same"
                           if name == "selective_scan" else
                           "path D's tile shape, layer 0's recorded "
                           "short-conv input, fp32 (row 0) and bf16"),
                "max_rel_err_bf16_outputs": errs_bf16.get(name, [None])[0],
                "layers": seq_rows[name]})
            continue
        # a kernel of the fp32 path is summed over that path's layers (its
        # reduced-precision layers are in by_path); the others over all
        by_path = {path: {key: sum(r[key] for r in rows[name]
                                   if r["path"] == path)
                          for key in ("ms", "device_ms", "plain_ms",
                                      "bound_ms", "library_ms",
                                      "library_device_ms")}
                   for path in sorted({r["path"] for r in rows[name]})}
        layer_rows = [r for r in rows[name] if r["path"] == "float32"] or \
            rows[name]
        total = lambda key: sum(r[key] for r in layer_rows)  # noqa: E731
        bound_ops = sum(r["bound_ms"] for r in layer_rows
                        if r["bound_by"] == "operations")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name][1], "max_rel_err": errs[name][0],
            "oracle": ("the plain version in float64" if name in TF32X3
                       else "the plain version"),
            "max_rel_err_vs_fp32_plain": errs_fp32.get(name),
            "ms": total("ms"), "device_ms": total("device_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_fp32_ms": total("bound_fp32_ms"),
            "bound_by": ("operations" if bound_ops >= total("bound_ms") / 2
                         else "bytes"),
            "library_ms": total("library_ms"),
            "library_device_ms": total("library_device_ms"),
            "library": LIBRARY[name],
            "shapes": (f"every layer of "
                       f"{sorted({(r['net'], r['path']) for r in layer_rows})}"
                       f" that launches it, at 224, batch {MAIN_BATCH}; "
                       f"times summed"),
            "by_path": by_path,
            "layers": rows[name]})
    log(json.dumps({"lm": lm}))
    log(json.dumps({"forward": forward, "logits": logit_errs,
                    "launches_by_path": launches_by_path, "ab": ab}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def lm_decode(src: str | None) -> int:
    """Path C's main path and time_lm alone, at fp32 and bf16, with
    repro_torch imported from `src` (a package tree such as another
    commit's `src`; default this checkout's): one JSON line of its prefill
    and decode times. Two trees compare when both run in one machine
    session, alternated (A, B, B, A)."""
    if src is not None:
        sys.path.insert(0, str(Path(src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch import configs as pt_cfgs
    from repro_torch.launch import steps as pt_steps
    from repro_torch.models import transformer as pt_tf
    dev = torch.device("cuda")
    cfg = pt_cfgs.get_config(LM_ARCH)
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    prefill_step = pt_steps.make_prefill_step(cfg, LM_PROMPT + LM_TICKS)
    serve_step = pt_steps.make_serve_step(cfg)
    params = pt_tf.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, torch.float32, device=dev)
    out = {"package": str(Path(repro_torch.__file__).parent)}
    for dtype in (torch.float32, torch.bfloat16):
        if dtype != torch.float32:
            params = cast_like_init(params, dtype)
            torch.cuda.empty_cache()
        label = f"falcon-mamba-7b {str(dtype).removeprefix('torch.')}"
        _, tokens, _ = lm_generate(prefill_step, serve_step, params, prompt,
                                   LM_TICKS, label, EXPECTED_PREFILL)
        out[label] = time_lm(prefill_step, serve_step, params, prompt,
                             LM_TICKS, label, profile=False)
        out[label]["tokens"] = tokens.tolist()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    out["card"] = smi.stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


def mesh_only() -> int:
    """Phase 11 alone (mesh_phase), after nothing but an import: the scan
    kernel builds at its first launch."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    build.load("selective_scan.cu")        # not inside the timed steps
    report, counts = mesh_phase(torch.device("cuda"))
    log(json.dumps({"mesh": report, "launches_by_path": counts}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    return 0


def dryrun_only() -> int:
    """Phase 12 alone (dryrun_phase), after nothing but an import: the scan
    kernel builds at its first launch, before the measured step."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    build.load("selective_scan.cu")        # not inside the measured steps
    report, counts = dryrun_phase(torch.device("cuda"))
    log(json.dumps({"dryrun": report, "launches_by_path": counts}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    return 0


def examples_only() -> int:
    """Phase 13 alone (examples_phase), after the build: no script's time
    holds a kernel's compile."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    report, counts = examples_phase()
    log(json.dumps({"examples": report, "launches_by_path": {
        path: {k: v for k, v in c.items() if v}
        for path, c in counts.items()}}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    return 0


def training_only() -> int:
    """Phase 10 alone (training_phase), after nothing but an import: the
    scan kernel builds at its first launch."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report, counts = training_phase(torch.device("cuda"))
    log(json.dumps({"training": report, "launches_by_path": counts}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--training"]:
        sys.exit(training_only())
    if sys.argv[1:2] == ["--mesh"]:
        sys.exit(mesh_only())
    if sys.argv[1:2] == ["--dryrun"]:
        sys.exit(dryrun_only())
    if sys.argv[1:2] == ["--examples"]:
        sys.exit(examples_only())
    if sys.argv[1:2] == ["--sweep"]:
        sys.exit(sweep(set(sys.argv[2:])))
    if sys.argv[1:2] == ["--lm-decode"]:
        sys.exit(lm_decode(sys.argv[2] if len(sys.argv) > 2 else None))
    sys.exit(main())
