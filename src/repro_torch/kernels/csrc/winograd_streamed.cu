// Halo-streaming region-wise Winograd / Cook-Toom convolution at stride 1,
// for Hopper, with the point-GEMMs on the tensor cores (TF32x3).
//
// Replaces repro/kernels/winograd.py:winograd_streamed (the Pallas TPU
// kernel). Same function on the same operands: the padded NHWC fp32 input
// xp (N, Hp, Wp, Cp), the Winograd-domain filter u (P, Cp, Mp) in fp32,
// bf16 or int8, an optional bias (at most Mp entries) and an optional int8
// dequantization scale row (Mp) -> the NHWC output
// (N, nHb*bh*mh, nWb*bw*mw, Mp). One kernel fuses the strip load, the
// input transform B^T d B, the P point-GEMMs with fp32 accumulation, the
// inverse transform A^T y A and the epilogue (x scale, + bias, activation,
// in that order). Nothing but the input, the filter and the output lives
// in device memory.
//
// What bounds it: the point-GEMMs' operations (VGG-16's F(4x4, 3x3)
// layers do ~8 GFLOP of them per image), the input transform that every M
// block repeats, and the filter chunks every block streams from L2
// ((P, bC, bM) per C step). Measured on an H100 (PERF.md), the kernel is
// bound by instruction issue per C step with 8 warps per SM: the tensor
// cores, the staging and L2 are not the limit. The design:
//  * runs the GEMMs on mma.sync m16n8k8 in TF32x3 (mma_tf32x3.cuh), two
//    products instead of three where the filter was widened from bf16 or
//    int8 (exact in TF32): fp32-level error at up to 165 TFLOP/s;
//  * stages, per C step of bC = 8..32 channels, the block's whole strip
//    ((bh*mh + th - mh) x (bw*mw + tw - mw) x bC, so neighbouring tiles
//    share their halo) and the raw (P, bC, bM) filter chunk by cp.async,
//    double-buffered: step s+1's loads run under step s's transform and
//    GEMMs, behind two barriers per step;
//  * transforms in one pass, one (tile, channel) per thread, in registers
//    from the staged strip, into V (P, bR, bC) in shared memory;
//  * gives each warp whole Winograd points (p = warp + 8q): warp w alone
//    reads V[p] and the filter chunk's point p, so each operand is split
//    into its TF32 halves once, as its fragment is loaded, and each warp
//    keeps its points' bR x bM accumulators in registers;
//  * widens a bf16 / int8 filter as its fragment is read from shared
//    memory (cp.async moves the raw bytes), and applies the int8 scale in
//    the epilogue, before the bias;
//  * keeps the per-step instruction count down: index arithmetic by
//    shifts, guard-free transforms for the 3 x 3 tiles (kR), fragment
//    offsets computed once.
//
// How the TPU design translates: the Pallas grid ran the C reduction
// innermost and sequentially, carrying the accumulator across grid steps;
// here every block loops over all of C itself, in a fixed order (no
// atomics), with the accumulators in registers. The Pallas kernel reused
// each transformed strip across its sequential M sweep; parallel M blocks
// cannot share it, so each recomputes the transform of its strip, O(t)
// work per point against the GEMM's O(bM). Edge blocks: the caller pads
// the input to whole tile blocks and crops the surplus outputs afterwards,
// as the reference does.
//
// Blocking (core/winograd.py:stream_geometry_tf32x3): a block holds
// bR = 16*kMT tiles (bh x bw) and bM = 8*kNT output channels; T, the
// larger of th and tw (at least 3, 7 rounded up to 8), sizes the
// transform's registers (core/winograd.py:winograd_tc_tile). The (T, kMT,
// kNT) menu (winograd_tc.cuh:dispatch) is the chooser's
// WINOGRAD_TC_CONFIGS. The body lives in winograd_tc.cuh, which the
// stride-2 kernel (winograd_strided_streamed.cu) instantiates with a phase
// loop around the same C sweep.

#include "winograd_tc.cuh"

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or a negative
// validation code; winograd_streamed_error names each. `mats` is a host
// array of 4 x 64 floats: B_h^T, B_w^T, A_h^T, A_w^T, row-major, each
// zero-padded to 8 x 8. The input is padded so that hp = n_hb*bh*mh +
// th - mh, and likewise wp; cp is a multiple of bc in {8, 16, 32}, mp of
// bm; xp and u are 16-byte aligned.
int winograd_streamed_launch(const float* xp, const void* u, int u_type,
                             const float* bias, int n_bias, const float* scale,
                             float* y, int n, int hp, int wp, int cp, int mp,
                             int th, int tw, int mh, int mw, int bh, int bw,
                             int bc, int bm, int activation, const float* mats,
                             void* stream) {
  return launch_tc<1>(xp, u, u_type, bias, n_bias, scale, y, n, hp, wp, cp, mp, th, tw, mh,
                      mw, bh, bw, bc, bm, activation, mats, stream);
}

const char* winograd_streamed_error(int code) { return tc_error(code); }

}  // extern "C"
