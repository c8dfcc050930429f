// Halo-streaming region-wise Winograd / Cook-Toom convolution for Hopper.
//
// Replaces repro/kernels/winograd.py:winograd_streamed (the Pallas TPU
// kernel). Same function on the same operands: the padded NHWC fp32 input
// xp (N, Hp, Wp, Cp), the Winograd-domain filter u (P, Cp, Mp) in fp32,
// bf16 or int8, an optional bias (at most Mp entries) and an optional int8
// dequantization scale row (Mp) -> the NHWC output
// (N, nHb*bh*mh, nWb*bw*mw, Mp). One kernel fuses the strip gather, the
// input transform B^T d B, the P point-GEMMs with fp32 accumulation, the
// inverse transform A^T y A and the epilogue (x scale, + bias, activation).
// Nothing but the input and the output lives in device memory: the
// transformed input and the accumulators stay in shared memory and
// registers.
//
// What bounds it: fp32 FMA throughput on the CUDA cores. At F(4x4, 3x3) the
// point-GEMMs of VGG-16 at 224 are ~13.7 GFLOP per image against tens of
// MB of activations, far above the card's ~20 FLOP/byte fp32 balance
// point. The design spends its registers on the GEMM: each thread keeps a
// 2-region x 4-channel register tile for up to 9 Winograd points (72 fp32
// accumulators), fed by one float2 and one float4 shared-memory load per 8
// FMAs. Tensor cores (TF32 / bf16 wgmma), TMA and warp specialisation are
// later work.
//
// How the TPU design translates:
//  * The Pallas grid ran the C reduction innermost and sequentially,
//    carrying the accumulator across grid steps. Blocks here run in
//    parallel, so each block loops over all of C itself, kBlockC channels
//    per step, with the accumulators in registers.
//  * The Pallas kernel transformed each input strip once and reused it
//    across the M sweep (its v_ref cache). Parallel M blocks cannot share
//    that cache, so every M block recomputes the input transform of its
//    strip: O(t) work per Winograd point against the GEMM's O(bM).
//  * Blocking is generic over every tile the planner can ask for (t <= 8
//    per axis); B^T and A^T arrive as kernel parameters, zero-padded to
//    8 x 8, as in the reference where they are kernel operands.
//  * The filter is widened to fp32 as it is staged into shared memory; the
//    int8 scale multiplies in the epilogue, before the bias.
//  * Edge blocks: the caller pads the input to whole tile blocks and crops
//    the surplus outputs afterwards, as the reference does.
//
// The kernel body lives in winograd_common.cuh, shared with the stride-2
// kernel (winograd_strided_streamed.cu); this file instantiates it at
// stride 1.

#include "winograd_common.cuh"

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or one of the
// negative validation codes of winograd_common.cuh; winograd_streamed_error
// names each. `mats` is a host array of 4 x 64 floats: B_h^T, B_w^T,
// A_h^T, A_w^T, row-major, each zero-padded to 8 x 8.
int winograd_streamed_launch(const float* xp, const void* u, int u_type,
                             const float* bias, int n_bias, const float* scale,
                             float* y, int n, int hp, int wp, int cp, int mp,
                             int th, int tw, int mh, int mw, int bh, int bw,
                             int bm, int activation, const float* mats,
                             void* stream) {
  return launch_streamed<1>(xp, u, u_type, bias, n_bias, scale, y, n, hp, wp,
                            cp, mp, th, tw, mh, mw, bh, bw, bm, activation,
                            mats, stream);
}

const char* winograd_streamed_error(int code) { return streamed_error(code); }

}  // extern "C"
