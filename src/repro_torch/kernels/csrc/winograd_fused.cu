// Winograd / Cook-Toom convolution over pre-extracted tiles for Hopper: the
// A/B baseline of the halo-streaming kernel.
//
// Replaces repro/kernels/winograd.py:winograd_fused (the Pallas TPU
// kernel). Same function on the same operands: the overlapping input tiles
// (R, th, tw, Cp) fp32 that the caller extracted in device memory
// (kernels/ops.py:winograd_conv2d_planned_materialized) and the
// Winograd-domain filter u (P, Cp, Mp) fp32 -> the output tiles
// (R, mh, mw, Mp) fp32: input transform B^T d B, the P point-GEMMs over C
// with fp32 accumulation, inverse transform A^T y A. No epilogue: the
// caller un-tiles the output and adds bias and activation in later passes.
//
// What bounds it: the point-GEMMs' fp32 FMAs on the CUDA cores, plus
// bytes the streamed kernel does not move: the tile tensor
// holds (t/m)^2 times the input (2.25x at F(4x4, 3x3)) and is written by
// the extraction before this kernel reads it. Those passes are the point of
// the baseline; nothing here removes them.
//
// How the TPU design translates:
//  * The Pallas grid (R/bR, M/bM, C/bC) ran C innermost and sequentially,
//    carrying the (P, bR, bM) accumulator in VMEM scratch across grid
//    steps. Blocks here run in parallel, so each block of bR tiles x bM
//    output channels sweeps all of C itself, 8 channels per step: it
//    transforms its bR tiles into shared memory as (P, 8, bR), stages the
//    (P, 8, bM) filter slice beside them and accumulates the P point-GEMMs
//    in registers (2 tiles x 4 channels of up to 9 points per thread).
//  * After the sweep one inverse transform per (tile, channel) stores the
//    (mh, mw) outputs, output channels fastest.
//  * The body is winograd_common.cuh's CUDA-core kernel; the blocking
//    (core/winograd.py:winograd_blocks) obeys its register and
//    shared-memory rules (core/winograd.py:stream_blocking_fits).

#include "winograd_common.cuh"

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or one of the
// negative validation codes of winograd_common.cuh; winograd_fused_error
// names each. `mats` is a host array of 4 x 64 floats: B_h^T, B_w^T,
// A_h^T, A_w^T, row-major, each zero-padded to 8 x 8. r must be a multiple
// of br, cp of 8 and mp of bm.
int winograd_fused_launch(const float* tiles, const float* u, float* y, int r,
                          int th, int tw, int mh, int mw, int cp, int mp,
                          int br, int bm, const float* mats, void* stream) {
  Params prm{};
  const long smem = fill_blocking(prm, cp, mp, th, tw, mh, mw, br, bm, mats);
  if (smem < 0) return (int)smem;
  if (r < br || r % br != 0) return kErrBadShape;
  prm.x = tiles;
  prm.u = u;
  prm.y = y;
  return launch(prm, r / br, smem, static_cast<cudaStream_t>(stream));
}

const char* winograd_fused_error(int code) { return streamed_error(code); }

}  // extern "C"
