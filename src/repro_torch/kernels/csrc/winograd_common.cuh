// The tiles-domain Winograd / Cook-Toom kernel on the CUDA cores, the body
// of winograd_fused.cu (the materialized A/B baseline). The streamed
// kernels have a tensor-core body of their own (winograd_tc.cuh).
//
// Block x owns tiles [x*bR, (x+1)*bR) of an (R, th, tw, Cp) tile tensor
// and bM output channels. It sweeps the reduction in steps of kBlockC
// channels: for each channel step it stages the filter chunk, reads
// element (a, b) of tile r at ((r*th + a)*tw + b)*Cp and transforms it
// (B^T d B, two passes through shared memory), and runs the P point-GEMMs
// into register accumulators. After the sweep one inverse transform
// A^T y A per (tile, channel) stores the tile to (R, mh, mw, Mp), with no
// epilogue (no scale, no bias, activation none).

#pragma once

#include "common.cuh"

namespace {

// These must agree with repro_torch/core/winograd.py (STREAM_*).
constexpr int kThreads = 256;
constexpr int kBlockC = 8;
constexpr int kPointsPerThread = 9;
constexpr int kMaxT = 8;
constexpr int kMaxM = 7;  // m = t - k + 1 with k >= 2

struct Params {
  const float* x;
  const float* u;
  float* y;
  int cp, mp;
  int th, tw, mh, mw, p;
  int br, bm;
  int slab, pg;  // threads per point group, point groups
  float bt_h[kMaxT * kMaxT];  // row-major, zero-padded to 8 x 8
  float bt_w[kMaxT * kMaxT];
  float at_h[kMaxT * kMaxT];
  float at_w[kMaxT * kMaxT];
};

__global__ void __launch_bounds__(kThreads, 2)
    winograd_tiles_kernel(const __grid_constant__ Params prm) {
  extern __shared__ __align__(16) float smem[];
  const int P = prm.p, br = prm.br, bm = prm.bm;
  const int th = prm.th, tw = prm.tw, mh = prm.mh, mw = prm.mw;
  float* s_u = smem;                       // (P, kBlockC, bM) filter chunk
  float* s_v = s_u + P * kBlockC * bm;     // (P, kBlockC, bR) transformed input
  float* s_t = s_v + P * kBlockC * br;     // (th, tw, kBlockC, bR) half-transformed
  float* s_y = smem;                       // (P, bR, bM) after the C sweep

  const int tid = threadIdx.x;
  const int m_base = blockIdx.y * bm;

  // GEMM slot of this thread: point group, 2 regions, 4 output channels.
  const int pgi = tid / prm.slab;
  const int s = tid % prm.slab;
  const int mq = bm / 4;
  const int m0 = (s % mq) * 4;
  const int r0 = (s / mq) * 2;

  float acc[kPointsPerThread][2][4];
#pragma unroll
  for (int q = 0; q < kPointsPerThread; ++q)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[q][a][b] = 0.f;

  for (int c0 = 0; c0 < prm.cp; c0 += kBlockC) {
    __syncthreads();  // the previous step's GEMM is done with s_u / s_v

    // Stage the filter chunk (m fastest: coalesced).
    for (int i = tid; i < P * kBlockC * bm; i += kThreads) {
      const int m = i % bm;
      const int pc_ = i / bm;
      const int c = pc_ % kBlockC;
      const int p = pc_ / kBlockC;
      s_u[i] = prm.u[((size_t)p * prm.cp + c0 + c) * prm.mp + m_base + m];
    }

    // Input transform, pass 1: each tile column b through B_h^T.
    for (int i = tid; i < tw * kBlockC * br; i += kThreads) {
      const int c = i % kBlockC;
      const int rb = i / kBlockC;
      const int r = rb % br;
      const int b = rb / br;
      const float* src =
          prm.x + ((size_t)(blockIdx.x * br + r) * th * tw + b) * prm.cp + c0 + c;
      const size_t a_step = (size_t)tw * prm.cp;
      float d[kMaxT];
#pragma unroll
      for (int a = 0; a < kMaxT; ++a) d[a] = a < th ? src[(size_t)a * a_step] : 0.f;
#pragma unroll
      for (int ii = 0; ii < kMaxT; ++ii) {
        if (ii < th) {
          float v = 0.f;
#pragma unroll
          for (int a = 0; a < kMaxT; ++a) v += prm.bt_h[ii * kMaxT + a] * d[a];
          s_t[((ii * tw + b) * kBlockC + c) * br + r] = v;
        }
      }
    }
    __syncthreads();

    // Pass 2: each tile row ii through B_w^T, scattered to (P, kBlockC, bR).
    for (int i = tid; i < th * kBlockC * br; i += kThreads) {
      const int r = i % br;
      const int ic = i / br;
      const int c = ic % kBlockC;
      const int ii = ic / kBlockC;
      float t[kMaxT];
#pragma unroll
      for (int b = 0; b < kMaxT; ++b)
        t[b] = b < tw ? s_t[((ii * tw + b) * kBlockC + c) * br + r] : 0.f;
#pragma unroll
      for (int j = 0; j < kMaxT; ++j) {
        if (j < tw) {
          float v = 0.f;
#pragma unroll
          for (int b = 0; b < kMaxT; ++b) v += prm.bt_w[j * kMaxT + b] * t[b];
          s_v[((ii * tw + j) * kBlockC + c) * br + r] = v;
        }
      }
    }
    __syncthreads();

    // The P point-GEMMs (P, bR, kBlockC) x (P, kBlockC, bM), fp32 FMA.
#pragma unroll
    for (int q = 0; q < kPointsPerThread; ++q) {
      const int p = pgi + q * prm.pg;
      if (p < P) {
        const float* vp = s_v + p * kBlockC * br + r0;
        const float* up = s_u + p * kBlockC * bm + m0;
#pragma unroll
        for (int c = 0; c < kBlockC; ++c) {
          const float2 v = *reinterpret_cast<const float2*>(vp + c * br);
          const float4 w = *reinterpret_cast<const float4*>(up + c * bm);
          acc[q][0][0] += v.x * w.x;
          acc[q][0][1] += v.x * w.y;
          acc[q][0][2] += v.x * w.z;
          acc[q][0][3] += v.x * w.w;
          acc[q][1][0] += v.y * w.x;
          acc[q][1][1] += v.y * w.y;
          acc[q][1][2] += v.y * w.z;
          acc[q][1][3] += v.y * w.w;
        }
      }
    }
  }
  __syncthreads();

  // Spill the accumulators to (P, bR, bM) for the inverse transform.
#pragma unroll
  for (int q = 0; q < kPointsPerThread; ++q) {
    const int p = pgi + q * prm.pg;
    if (p < P) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
        *reinterpret_cast<float4*>(s_y + (p * br + r0 + a) * bm + m0) =
            make_float4(acc[q][a][0], acc[q][a][1], acc[q][a][2], acc[q][a][3]);
    }
  }
  __syncthreads();

  // Inverse transform A_h^T y A_w, tile store (m fastest).
  for (int i = tid; i < br * bm; i += kThreads) {
    const int m = i % bm;
    const int r = i / bm;
    float o[kMaxM][kMaxM];
#pragma unroll
    for (int ii = 0; ii < kMaxM; ++ii)
#pragma unroll
      for (int j = 0; j < kMaxM; ++j) o[ii][j] = 0.f;
#pragma unroll
    for (int a = 0; a < kMaxT; ++a) {
      if (a < th) {
        float row[kMaxM];
#pragma unroll
        for (int j = 0; j < kMaxM; ++j) row[j] = 0.f;
#pragma unroll
        for (int b = 0; b < kMaxT; ++b) {
          if (b < tw) {
            const float yv = s_y[((a * tw + b) * br + r) * bm + m];
#pragma unroll
            for (int j = 0; j < kMaxM; ++j) row[j] += prm.at_w[j * kMaxT + b] * yv;
          }
        }
#pragma unroll
        for (int ii = 0; ii < kMaxM; ++ii)
#pragma unroll
          for (int j = 0; j < kMaxM; ++j) o[ii][j] += prm.at_h[ii * kMaxT + a] * row[j];
      }
    }
    float* dst = prm.y + (size_t)(blockIdx.x * br + r) * mh * mw * prm.mp + m_base + m;
#pragma unroll
    for (int ii = 0; ii < kMaxM; ++ii) {
      if (ii < mh) {
#pragma unroll
        for (int j = 0; j < kMaxM; ++j) {
          if (j < mw) dst[((size_t)ii * mw + j) * prm.mp] = o[ii][j];
        }
      }
    }
  }
}

// Validation failures the launcher reports before touching the device.
constexpr int kErrBadShape = -1;
constexpr int kErrBadBlocking = -2;

inline cudaError_t launch(const Params& prm, int n_blocks, size_t smem, cudaStream_t stream) {
  // Raise the kernel's shared-memory cap only when a launch needs more
  // than granted so far: a warmed-up launch then makes no driver call but
  // the launch itself (and can be captured in a CUDA graph).
  static size_t granted = 0;
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        winograd_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  dim3 grid(n_blocks, prm.mp / prm.bm);
  winograd_tiles_kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

// Check the tile and the GEMM blocking and fill their fields of `prm` and
// the transforms (`mats`: a host array of 4 x 64 floats, B_h^T, B_w^T,
// A_h^T, A_w^T, row-major, each zero-padded to 8 x 8). Returns the dynamic shared
// memory a block needs, or a negative validation code.
inline long fill_blocking(Params& prm, int cp, int mp, int th, int tw, int mh,
                          int mw, int br, int bm, const float* mats) {
  if (th < 2 || tw < 2 || th > kMaxT || tw > kMaxT || mh < 1 || mw < 1 ||
      mh > kMaxM || mw > kMaxM || mh >= th || mw >= tw || cp % kBlockC != 0)
    return kErrBadShape;
  if (br < 2 || br % 2 != 0 || bm % 4 != 0 || bm < 4 || mp % bm != 0)
    return kErrBadBlocking;
  const int slab = (br / 2) * (bm / 4);
  if (slab > kThreads || kThreads % slab != 0) return kErrBadBlocking;
  const int pg = kThreads / slab;
  const int p = th * tw;
  if ((p + pg - 1) / pg > kPointsPerThread) return kErrBadBlocking;
  const size_t stage = sizeof(float) * ((size_t)p * kBlockC * bm + 2 * (size_t)p * kBlockC * br);
  const size_t spill = sizeof(float) * (size_t)p * br * bm;
  const size_t smem = stage > spill ? stage : spill;
  if (smem > 227 * 1024) return kErrBadBlocking;

  prm.cp = cp;
  prm.mp = mp;
  prm.th = th;
  prm.tw = tw;
  prm.mh = mh;
  prm.mw = mw;
  prm.p = p;
  prm.br = br;
  prm.bm = bm;
  prm.slab = slab;
  prm.pg = pg;
  for (int i = 0; i < kMaxT * kMaxT; ++i) {
    prm.bt_h[i] = mats[i];
    prm.bt_w[i] = mats[64 + i];
    prm.at_h[i] = mats[128 + i];
    prm.at_w[i] = mats[192 + i];
  }
  return (long)smem;
}

const char* streamed_error(int code) {
  switch (code) {
    case kErrBadShape:
      return "operand shapes do not match the tile geometry";
    case kErrBadBlocking:
      return "blocking does not fit the kernel's thread layout or shared memory";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // namespace
