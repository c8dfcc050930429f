// The halo-streaming Winograd / Cook-Toom kernel on the CUDA cores, shared
// by winograd_strided_streamed.cu (stride 2, transform-domain phase
// decomposition) and winograd_fused.cu (the same body at stride 1 over
// pre-extracted tiles). Each source includes this header once and exports
// its own C entry point; the libraries share no state. The stride-1
// streamed kernel has a tensor-core body of its own (winograd_streamed.cu).
//
// One thread block computes a (bh, bw) block of output tiles for bM output
// channels. It sweeps the reduction in steps of kBlockC channels: for each
// of the kStride^2 input phases and each channel step it stages the widened
// filter chunk, gathers and transforms its strip (B^T d B, two passes
// through shared memory) and runs the P point-GEMMs into register
// accumulators. Stride 2 sums its four phase GEMM banks into the same P
// accumulators, so the phase sum happens in the transform domain and ONE
// inverse transform A^T y A with the fused epilogue (x scale, + bias,
// activation) follows, as in the stride-1 kernel.
//
// Phase (pr, pc) element (a, b) of the tile at phase-grid origin (y0, x0)
// sits at full-resolution (kStride*(y0 + a) + pr, kStride*(x0 + b) + pc).
//
// With kTiles the same body runs over pre-extracted tiles instead of a
// strip (winograd_fused.cu): block x owns tiles [x*bR, (x+1)*bR) of an
// (R, th, tw, Cp) tensor, reads element (a, b) of tile r at
// ((r*th + a)*tw + b)*Cp, and stores the inverse-transformed tile to
// (R, mh, mw, Mp) with no epilogue (no scale, no bias, activation none).

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
  const void* u;
  const float* bias;
  const float* scale;
  float* y;
  int n_bias;
  int hp, wp, cp, mp;
  int th, tw, mh, mw, p;
  int bh, bw, br, bm, n_hb, n_wb;
  int slab, pg;  // threads per point group, point groups
  int act;
  float bt_h[kMaxT * kMaxT];  // row-major, zero-padded to 8 x 8
  float bt_w[kMaxT * kMaxT];
  float at_h[kMaxT * kMaxT];
  float at_w[kMaxT * kMaxT];
};

template <typename U, int kStride, bool kTiles>
__global__ void __launch_bounds__(kThreads, 2)
    winograd_streamed_kernel(const __grid_constant__ Params prm) {
  extern __shared__ __align__(16) float smem[];
  const int P = prm.p, br = prm.br, bm = prm.bm;
  const int th = prm.th, tw = prm.tw, mh = prm.mh, mw = prm.mw;
  float* s_u = smem;                       // (P, kBlockC, bM) widened filter
  float* s_v = s_u + P * kBlockC * bm;     // (P, kBlockC, bR) transformed input
  float* s_t = s_v + P * kBlockC * br;     // (th, tw, kBlockC, bR) half-transformed
  float* s_y = smem;                       // (P, bR, bM) after the C sweep

  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int wb = blk % prm.n_wb;
  blk /= prm.n_wb;
  const int hb = blk % prm.n_hb;
  const int img = blk / prm.n_hb;
  const int m_base = blockIdx.y * bm;
  const int row0 = hb * prm.bh * mh;  // first output row of this block
  const int col0 = wb * prm.bw * mw;

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

  const float* x_img = prm.x + (size_t)img * prm.hp * prm.wp * prm.cp;
  const U* u = static_cast<const U*>(prm.u);
  const size_t row_step = (size_t)kStride * prm.wp * prm.cp;

  for (int ph = 0; ph < kStride * kStride; ++ph) {
    const int pr = ph / kStride, pc = ph % kStride;
    const U* u_ph = u + (size_t)ph * P * prm.cp * prm.mp;
    for (int c0 = 0; c0 < prm.cp; c0 += kBlockC) {
      __syncthreads();  // the previous step's GEMM is done with s_u / s_v

      // Stage the filter chunk, widened to fp32 (m fastest: coalesced).
      for (int i = tid; i < P * kBlockC * bm; i += kThreads) {
        const int m = i % bm;
        const int pc_ = i / bm;
        const int c = pc_ % kBlockC;
        const int p = pc_ / kBlockC;
        s_u[i] = widen(u_ph[((size_t)p * prm.cp + c0 + c) * prm.mp + m_base + m]);
      }

      // Input transform, pass 1: each tile column b through B_h^T.
      for (int i = tid; i < tw * kBlockC * br; i += kThreads) {
        const int c = i % kBlockC;
        const int rb = i / kBlockC;
        const int r = rb % br;
        const int b = rb / br;
        const float* src;
        size_t a_step;
        if constexpr (kTiles) {
          src = prm.x + ((size_t)(blockIdx.x * br + r) * th * tw + b) * prm.cp + c0 + c;
          a_step = (size_t)tw * prm.cp;
        } else {
          const int y0 = row0 + (r / prm.bw) * mh;  // phase-grid tile origin
          const int x0 = col0 + (r % prm.bw) * mw + b;
          src = x_img + ((size_t)(kStride * y0 + pr) * prm.wp + kStride * x0 + pc) * prm.cp +
                c0 + c;
          a_step = row_step;
        }
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

      // The P point-GEMMs (P, bR, kBlockC) x (P, kBlockC, bM), fp32 FMA,
      // every phase into the same accumulators.
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

  // Inverse transform A_h^T y A_w, epilogue, NHWC store (m fastest).
  const int h_out = prm.n_hb * prm.bh * mh;
  const int w_out = prm.n_wb * prm.bw * mw;
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
    const int mg = m_base + m;
    const float sc = prm.scale != nullptr ? prm.scale[mg] : 1.f;
    const float bi = (prm.bias != nullptr && mg < prm.n_bias) ? prm.bias[mg] : 0.f;
    float* dst;
    int ii_step;  // output pixels between two rows of the tile
    if constexpr (kTiles) {
      dst = prm.y + (size_t)(blockIdx.x * br + r) * mh * mw * prm.mp + mg;
      ii_step = mw;
    } else {
      const int oy = row0 + (r / prm.bw) * mh;
      const int ox = col0 + (r % prm.bw) * mw;
      dst = prm.y + (((size_t)img * h_out + oy) * w_out + ox) * prm.mp + mg;
      ii_step = w_out;
    }
#pragma unroll
    for (int ii = 0; ii < kMaxM; ++ii) {
      if (ii < mh) {
#pragma unroll
        for (int j = 0; j < kMaxM; ++j) {
          if (j < mw) {
            dst[((size_t)ii * ii_step + j) * prm.mp] = activate(o[ii][j] * sc + bi, prm.act);
          }
        }
      }
    }
  }
}

// Validation failures the launcher reports before touching the device.
constexpr int kErrBadShape = -1;
constexpr int kErrBadBlocking = -2;
constexpr int kErrBadType = -3;

template <typename U, int kStride, bool kTiles = false>
cudaError_t launch(const Params& prm, int n_img, size_t smem,
                   cudaStream_t stream) {
  auto kernel = winograd_streamed_kernel<U, kStride, kTiles>;
  // Raise the kernel's shared-memory cap only when a launch needs more
  // than granted so far: a warmed-up launch then makes no driver call but
  // the launch itself (and can be captured in a CUDA graph).
  static size_t granted = 0;
  if (smem > granted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  dim3 grid(n_img * prm.n_hb * prm.n_wb, prm.mp / prm.bm);
  kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

// Validate, fill the parameters and launch on `stream`. Returns 0, a CUDA
// error code (> 0), or one of the negative validation codes above.
// `mats` is a host array of 4 x 64 floats: B_h^T, B_w^T, A_h^T, A_w^T,
// row-major, each zero-padded to 8 x 8. The input is padded so that
// hp = kStride * (n_hb*bh*mh + th - mh), and likewise wp; u holds
// kStride^2 phase banks of (P, cp, mp), phase-major.
// Check the tile and the GEMM blocking shared by every launcher and fill
// their fields of `prm` and the transforms. Returns the dynamic shared
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

template <int kStride>
int launch_streamed(const float* xp, const void* u, int u_type,
                    const float* bias, int n_bias, const float* scale,
                    float* y, int n, int hp, int wp, int cp, int mp, int th,
                    int tw, int mh, int mw, int bh, int bw, int bm,
                    int activation, const float* mats, void* stream) {
  if (n < 1 || activation < kNone || activation > kGelu || bh < 1 || bw < 1 ||
      mh < 1 || mw < 1)
    return kErrBadShape;
  const int sh = bh * mh, sw = bw * mw;
  const int halo_h = kStride * (th - mh), halo_w = kStride * (tw - mw);
  if ((hp - halo_h) % (kStride * sh) != 0 || (wp - halo_w) % (kStride * sw) != 0 ||
      hp <= halo_h || wp <= halo_w)
    return kErrBadShape;

  Params prm{};
  const long smem = fill_blocking(prm, cp, mp, th, tw, mh, mw, bh * bw, bm, mats);
  if (smem < 0) return (int)smem;
  prm.x = xp;
  prm.u = u;
  prm.bias = bias;
  prm.scale = scale;
  prm.y = y;
  prm.n_bias = n_bias;
  prm.hp = hp;
  prm.wp = wp;
  prm.bh = bh;
  prm.bw = bw;
  prm.n_hb = (hp - halo_h) / (kStride * sh);
  prm.n_wb = (wp - halo_w) / (kStride * sw);
  prm.act = activation;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (u_type) {
    case kF32:
      return launch<float, kStride>(prm, n, smem, s);
    case kBF16:
      return launch<__nv_bfloat16, kStride>(prm, n, smem, s);
    case kI8:
      return launch<int8_t, kStride>(prm, n, smem, s);
    default:
      return kErrBadType;
  }
}

const char* streamed_error(int code) {
  switch (code) {
    case kErrBadShape:
      return "operand shapes do not match the tile geometry";
    case kErrBadBlocking:
      return "blocking does not fit the kernel's thread layout or shared memory";
    case kErrBadType:
      return "unsupported filter dtype";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // namespace
