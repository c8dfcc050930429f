// Stride-2 halo-streaming Winograd / Cook-Toom convolution for Hopper, by
// transform-domain phase decomposition.
//
// Replaces repro/kernels/winograd.py:winograd_strided_streamed (the Pallas
// TPU kernel). Same function on the same operands: the full-resolution
// padded NHWC fp32 input xp (N, Hp, Wp, Cp), the phase-major
// Winograd-domain filter u (4P, Cp, Mp) in fp32, bf16 or int8, an optional
// bias (at most Mp entries) and an optional int8 dequantization scale row
// (Mp) -> the stride-2 NHWC output (N, nHb*bh*mh, nWb*bw*mw, Mp). A stride-2
// conv is four stride-1 sub-convolutions over the input phases
// x[p::2, q::2] with the phase sub-filters of the filter zero-padded to even
// size; every phase shares one F(m, (k+1)/2) transform set, so the four
// GEMM banks sum into ONE set of P accumulators in registers and one
// inverse transform and epilogue follow.
//
// What bounds it: on MobileNet's stem (224x224x3 -> 112x112x32, F(4x4,
// 2x2), t = 5) the work is ~15 MFLOP of point-GEMMs per image against
// ~2.2 MB of input and output, about 7 FLOP per byte: below the card's ~20
// FLOP/byte fp32 balance point, so the stem is bound by bytes, and the
// padding of C = 3 to the 8-channel step wastes 5/8 of its input transform
// and GEMM. Deeper dense stride-2 layers (large C) are bound by fp32 FMAs,
// as the stride-1 kernel is. The design is the stride-1 kernel's
// (winograd_common.cuh): register accumulators fed from shared memory, the
// reduction swept inside each block, here over 4 phases x C/8 steps.
//
// How the TPU design translates:
//  * The phase gather (repro/kernels/winograd.py:phase_gather_tiles): the
//    thread that transforms column b of a tile reads its t inputs at
//    full-resolution rows 2*(y0 + a) + ph, column 2*(x0 + b) + qh, straight
//    from device memory (the strip stays in L1/L2); the strips are twice
//    as large per axis as stride 1's.
//  * The Pallas kernel stacked the four transformed phases into a (4P, bR,
//    bC) cache reused across its M sweep; parallel M blocks cannot share
//    it, so each block transforms its strip's phases itself, one phase and
//    channel step at a time, into the same shared buffers the stride-1
//    kernel uses. Registers and shared memory per step are the stride-1
//    kernel's, so its blocking rule (core/winograd.py:stream_geometry,
//    phases=4) applies unchanged.
//  * Edge blocks: the caller pads the input to whole tile blocks, 2x the
//    stride-1 surplus per axis, and crops afterwards, as the reference.

#include "winograd_common.cuh"

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or one of the
// negative validation codes of winograd_common.cuh;
// winograd_strided_streamed_error names each. `mats` is a host array of
// 4 x 64 floats: B_h^T, B_w^T, A_h^T, A_w^T, row-major, each zero-padded
// to 8 x 8.
int winograd_strided_streamed_launch(const float* xp, const void* u,
                                     int u_type, const float* bias,
                                     int n_bias, const float* scale, float* y,
                                     int n, int hp, int wp, int cp, int mp,
                                     int th, int tw, int mh, int mw, int bh,
                                     int bw, int bm, int activation,
                                     const float* mats, void* stream) {
  return launch_streamed<2>(xp, u, u_type, bias, n_bias, scale, y, n, hp, wp,
                            cp, mp, th, tw, mh, mw, bh, bw, bm, activation,
                            mats, stream);
}

const char* winograd_strided_streamed_error(int code) {
  return streamed_error(code);
}

}  // extern "C"
