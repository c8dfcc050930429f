// Winograd / Cook-Toom convolution over pre-extracted tiles for Hopper, the
// point-GEMMs on the tensor cores (TF32x3): the A/B baseline of the
// halo-streaming kernel.
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
// What bounds it: the point-GEMMs' operations (VGG-16's F(4x4, 3x3)
// layers: ~8 GFLOP per image), as in the streamed kernel, plus bytes the
// streamed kernel does not move: the tile tensor holds (t/m)^2 times the
// input (2.25x at F(4x4, 3x3)) and is written by the extraction before
// this kernel reads it. Those passes are the point of the baseline;
// nothing here removes them.
//
// The design is the streamed kernel's tensor-core body (winograd_tc.cuh,
// notes in winograd_streamed.cu) with its source switched to the tiles
// (kTiles): a block owns bR = 16*kMT consecutive tiles and bM = 8*kNT
// output channels; each C step of bC = 8..32 channels stages by cp.async,
// double-buffered, the block's (bR, P, bC) tiles (16-byte copies: the
// tiles are contiguous, so no index arithmetic beyond one offset) and the
// raw (P, bC, bM) filter chunk, transforms one (tile, channel) per thread
// into V, and runs the P point-GEMMs on mma.sync m16n8k8 in TF32x3, each
// step's products summed into a zeroed fragment added in fp32; after the
// sweep one inverse transform per (tile, channel) stores the (mh, mw)
// outputs, channels fastest. F(2x2, 3x3) and F(4x4, 3x3) take the
// guard-free instantiations.
//
// How the TPU design translates: the Pallas grid (R/bR, M/bM, C/bC) ran C
// innermost and sequentially, carrying the (P, bR, bM) accumulator in VMEM
// scratch across grid steps. Blocks here run in parallel, so each block
// sweeps all of C itself, in a fixed order (no atomics), with the
// accumulators in registers. Blocking: core/winograd.py:winograd_blocks,
// (bR, bC, bM) from WINOGRAD_TC_CONFIGS, scored by the tensor-core cost
// model with the tile stage in place of the strip.

#include "winograd_tc.cuh"

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or a negative
// validation code; winograd_fused_error names each. `mats` is a host array
// of 4 x 64 floats: B_h^T, B_w^T, A_h^T, A_w^T, row-major, each
// zero-padded to 8 x 8. r must be a multiple of br (16 or 32), cp of bc
// (8, 16 or 32) and mp of bm; tiles and u are 16-byte aligned.
int winograd_fused_launch(const float* tiles, const float* u, float* y, int r,
                          int th, int tw, int mh, int mw, int cp, int mp,
                          int br, int bc, int bm, const float* mats,
                          void* stream) {
  if (r < 1 || th < 2 || tw < 2 || th > kMaxT || tw > kMaxT || mh < 1 || mw < 1 ||
      mh >= th || mw >= tw)
    return kErrBadShape;
  if ((bc != 8 && bc != 16 && bc != 32) || cp < bc || cp % bc != 0 || br < 16 ||
      r % br != 0 || bm < 8 || mp % bm != 0)
    return kErrBadBlocking;
  if (reinterpret_cast<uintptr_t>(tiles) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(u) % 16 != 0)
    return kErrBadAlign;

  Params prm{};
  prm.x = tiles;
  prm.u = u;
  prm.y = y;
  prm.cp = cp;
  prm.mp = mp;
  prm.th = th;
  prm.tw = tw;
  prm.mh = mh;
  prm.mw = mw;
  prm.p = th * tw;
  prm.bh = prm.bw = 1;
  prm.bc = bc;
  prm.n_hb = prm.n_wb = 1;
  prm.lbc = bc == 8 ? 3 : bc == 16 ? 4 : 5;
  prm.ldc = bc + 4;
  prm.act = kNone;
  for (int i = 0; i < kMaxT * kMaxT; ++i) {
    prm.bt_h[i] = mats[i];
    prm.bt_w[i] = mats[64 + i];
    prm.at_h[i] = mats[128 + i];
    prm.at_w[i] = mats[192 + i];
  }
  const int tmax = th > tw ? th : tw;
  const int t = tmax <= 3 ? 3 : tmax <= 6 ? tmax : 8;
  return dispatch<float, 1, true>(prm, r / br, t, br, bm,
                                  static_cast<cudaStream_t>(stream));
}

const char* winograd_fused_error(int code) { return tc_error(code); }

}  // extern "C"
