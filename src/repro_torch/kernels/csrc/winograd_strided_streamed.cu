// Stride-2 halo-streaming Winograd / Cook-Toom convolution for Hopper, by
// transform-domain phase decomposition, with the point-GEMMs on the tensor
// cores (TF32x3).
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
// GEMM banks sum into ONE set of P accumulators and one inverse transform
// and epilogue follow.
//
// What bounds it: on MobileNet's stem (224x224x3 -> 112x112x32, F(4x4,
// 2x2), t = 5) the work is ~15 MFLOP of point-GEMMs per image against
// ~2.2 MB of input and output: bytes, at the card's balance point. The
// padding of C = 3 to the 8-channel step wastes 5/8 of each step's input
// transform and GEMM. Deeper dense stride-2 layers (large C) are bound by
// the point-GEMMs, as the stride-1 kernel is.
//
// The design is the stride-1 tensor-core kernel's body (winograd_tc.cuh,
// notes in winograd_streamed.cu) instantiated with kPhases = 4: a phase
// loop around its C sweep. The unit of a step is (phase, C chunk), 4 Cp/bC
// steps per block; each stages by cp.async that phase's strip, whose pixel
// (a, b) sits at full-resolution (2 (y0 + a) + ph, 2 (x0 + b) + qh), and
// the chunk u[ph P : (ph + 1) P, c0 : c0 + bC, m-block] of its filter bank.
// A phase strip's bC channels are contiguous, so 16-byte copies apply, and
// the four phases read disjoint quarters of the input: no byte is read
// twice. Registers and shared memory per step are the stride-1 kernel's,
// and each step's products go into a zeroed fragment added in fp32, as
// there.
//
// How the TPU design translates: the Pallas kernel stacked the four
// transformed phases into a (4P, bR, bC) cache reused across its M sweep;
// parallel M blocks cannot share it, so each block transforms its strip's
// phases itself, one phase and C chunk per step. Blocking:
// core/winograd.py:stream_geometry_tf32x3 with phases=4, whose time model
// counts four times the C steps. Edge blocks: the caller pads the input to
// whole tile blocks, 2x the stride-1 surplus per axis, and crops
// afterwards, as the reference does.

#include "winograd_tc.cuh"

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or a negative
// validation code; winograd_strided_streamed_error names each. `mats` is a
// host array of 4 x 64 floats: B_h^T, B_w^T, A_h^T, A_w^T, row-major, each
// zero-padded to 8 x 8. The input is padded so that hp = 2*(n_hb*bh*mh +
// th - mh), and likewise wp; cp is a multiple of bc in {8, 16, 32}, mp of
// bm; xp and u are 16-byte aligned.
int winograd_strided_streamed_launch(const float* xp, const void* u,
                                     int u_type, const float* bias,
                                     int n_bias, const float* scale, float* y,
                                     int n, int hp, int wp, int cp, int mp,
                                     int th, int tw, int mh, int mw, int bh,
                                     int bw, int bc, int bm, int activation,
                                     const float* mats, void* stream) {
  return launch_tc<4>(xp, u, u_type, bias, n_bias, scale, y, n, hp, wp, cp, mp, th, tw, mh,
                      mw, bh, bw, bc, bm, activation, mats, stream);
}

const char* winograd_strided_streamed_error(int code) { return tc_error(code); }

}  // extern "C"
