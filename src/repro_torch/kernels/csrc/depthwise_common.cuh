// Device code shared by the depthwise kernels: the block shape of
// depthwise_streamed.cu and depthwise_strided_streamed.cu, their vector
// accesses and tap widening, and the per-(tile, channel) step of
// separable_streamed.cu.
//
// A depthwise conv has no reduction over channels: the dense scheme's
// point-GEMM degenerates to a Hadamard product, so one thread computes one
// output tile of one channel entirely in registers. depthwise_tile
// gathers the T x T input tile (channels are contiguous in NHWC, so the
// threads of a warp, on neighbouring channels, read neighbouring
// addresses), transforms it (B_h^T d B_w), multiplies it pointwise by the
// taps and applies the inverse transform A_h^T acc A_w. The matrices
// arrive zero-padded to 8 x 8, so a tile of th x tw <= T x T runs through
// the same T-sized loops: the padded rows and columns add zeros. T is a
// template parameter so the arrays stay in registers.

#pragma once

#include "common.cuh"

namespace {

// These must agree with repro_torch/core/winograd.py (DEPTHWISE_*).
constexpr int kThreads = 256;
constexpr int kMaxT = 8;

// K = 1 or 2 adjacent floats, one (vector) access.
template <int K>
__device__ __forceinline__ void ld(float (&v)[K], const float* p) {
  if constexpr (K == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int K>
__device__ __forceinline__ void st(float* p, const float (&v)[K]) {
  if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// Tap i of a filter of UType `type`, widened to fp32.
__device__ __forceinline__ float load_tap(const void* u, int type, size_t i) {
  switch (type) {
    case kBF16:
      return widen(static_cast<const __nv_bfloat16*>(u)[i]);
    case kI8:
      return widen(static_cast<const int8_t*>(u)[i]);
    default:
      return static_cast<const float*>(u)[i];
  }
}

struct Transforms {
  float bt_h[kMaxT * kMaxT];  // row-major, zero-padded to 8 x 8
  float bt_w[kMaxT * kMaxT];
  float at_h[kMaxT * kMaxT];
  float at_w[kMaxT * kMaxT];
};

inline void fill_transforms(Transforms& tf, const float* mats) {
  for (int i = 0; i < kMaxT * kMaxT; ++i) {
    tf.bt_h[i] = mats[i];
    tf.bt_w[i] = mats[64 + i];
    tf.at_h[i] = mats[128 + i];
    tf.at_w[i] = mats[192 + i];
  }
}

// One output tile of one channel. `x` points at the channel in the
// padded NHWC image (element (row, col) at x[(row*wp + col)*cp]); (y0, x0)
// is the tile's origin. `u` points at the channel's fp32 taps: point p at
// u[p*u_step]. Writes the inverse-transformed T x T block to o (the first
// mh x mw entries hold the outputs). kExact states th == tw == T and
// mh == mw == T - 2 (a 3-tap filter), which drops the guards and the
// inverse transform's unused rows.
template <int T, bool kExact = false>
__device__ __forceinline__ void depthwise_tile(const Transforms& tf,
                                               const float* x, int wp, int cp,
                                               int y0, int x0, const float* u,
                                               int u_step, int th, int tw,
                                               float o[T][T]) {
  if constexpr (kExact) th = tw = T;
  float acc[T][T];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j) acc[i][j] = 0.f;

  {
    // t1 = B_h^T d, one input column at a time.
    float t1[T][T];
#pragma unroll
    for (int b = 0; b < T; ++b) {
      float d[T];
#pragma unroll
      for (int a = 0; a < T; ++a)
        d[a] = (kExact || (a < th && b < tw)) ? x[((size_t)(y0 + a) * wp + x0 + b) * cp] : 0.f;
#pragma unroll
      for (int i = 0; i < T; ++i) {
        float v = 0.f;
#pragma unroll
        for (int a = 0; a < T; ++a) v += tf.bt_h[i * kMaxT + a] * d[a];
        t1[i][b] = v;
      }
    }
    // v = t1 B_w, then the Hadamard product with the taps.
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if (kExact || (i < th && j < tw)) {
          float v = 0.f;
#pragma unroll
          for (int b = 0; b < T; ++b) v += t1[i][b] * tf.bt_w[j * kMaxT + b];
          acc[i][j] += v * u[(size_t)(i * tw + j) * u_step];
        }
      }
    }
  }

  // o = A_h^T acc A_w (its first kM rows and columns: the rest of A^T is
  // zero padding).
  constexpr int kM = kExact ? T - 2 : T;
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j) o[i][j] = 0.f;
#pragma unroll
  for (int a = 0; a < T; ++a) {
    float row[kM];
#pragma unroll
    for (int j = 0; j < kM; ++j) {
      float v = 0.f;
#pragma unroll
      for (int b = 0; b < T; ++b) v += acc[a][b] * tf.at_w[j * kMaxT + b];
      row[j] = v;
    }
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int j = 0; j < kM; ++j) o[i][j] += tf.at_h[i * kMaxT + a] * row[j];
  }
}

}  // namespace
