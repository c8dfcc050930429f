// The Winograd / Cook-Toom body on the tensor cores (TF32x3), shared by
// winograd_streamed.cu (stride 1), winograd_strided_streamed.cu (stride 2,
// transform-domain phase decomposition) and winograd_fused.cu (over
// pre-extracted tiles, kTiles). Each source includes this header once and
// exports its own C entry point (launch_tc<kPhases>, or dispatch<float, 1,
// true> for the tiles); the libraries share no state. The design notes are
// in winograd_streamed.cu; the stride-2 phase loop and the tiles source are
// described at winograd_tc_kernel and in their sources.

#pragma once

#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 8;
constexpr size_t kSmemMax = 227 * 1024;

struct Params {
  const float* x;
  const void* u;
  const float* bias;
  const float* scale;
  float* y;
  int n_bias;
  int hp, wp, cp, mp;
  int th, tw, mh, mw, p;
  int bh, bw, bc, n_hb, n_wb;
  int sh, sw;         // strip extent, pixels: bh*mh + th - mh, bw*mw + tw - mw
  unsigned sw_magic;  // ceil(2^32 / sw): pixel / sw as one __umulhi
  int lbc, lbw;       // log2 of bc and bw (both powers of two)
  int ldc;            // floats between two pixels of a strip / rows of V: bc + 4
  int ldu;            // filter elements between two rows of a staged chunk
  int strip_floats;   // one strip stage
  int u_elems;        // one filter stage
  int act;
  float bt_h[kMaxT * kMaxT];  // row-major, zero-padded to 8 x 8
  float bt_w[kMaxT * kMaxT];
  float at_h[kMaxT * kMaxT];
  float at_w[kMaxT * kMaxT];
};

template <typename U, int T, int kMT, int kNT>
struct Config {
  static constexpr int kPts = (T * T + kWarps - 1) / kWarps;
  static constexpr int kAcc = kPts * kMT * kNT * 4;
  static constexpr int kBR = 16 * kMT, kBM = 8 * kNT;
  static constexpr bool kBLo = sizeof(U) == 4;  // fp32 filter: split B too
  // Two blocks per SM (128 registers a thread) where the accumulators and
  // the transform's T x T arrays leave room.
  static constexpr int kMinBlocks = kAcc <= 64 && T <= 6 ? 2 : 1;
};

// kR > 0: th == tw == T and mh == mw == T - kR + 1 (a kR x kR filter, or
// phase sub-filter), so the transforms run without guards and the inverse
// skips A^T's zero padding; kR = 0 takes any tile up to T with guards.
// kPhases 4: the stride-2 kernel. Its C sweep runs once per input phase
// (pr, pc) = (ph / 2, ph % 2), over the phase's strip, whose pixel (a, b)
// sits at full-resolution (2 (row0 + a) + pr, 2 (col0 + b) + pc), against
// the phase's filter bank u[ph P : (ph + 1) P]; every phase sums into the
// same accumulators, so one inverse transform and epilogue follow.
// kTiles: the source is the (R, th, tw, Cp) tile tensor and block b owns
// tiles [b bR, (b + 1) bR). Each C step stages its (bR, P, ldc) tiles,
// tile r's pixel (a, b) at (r P + a tw + b) ldc, and the store writes the
// (R, mh, mw, Mp) output tiles with no epilogue.
template <typename U, int T, int kMT, int kNT, int kR, int kPhases, bool kTiles = false>
__global__ void __launch_bounds__(kThreads, Config<U, T, kMT, kNT>::kMinBlocks)
    winograd_tc_kernel(const __grid_constant__ Params prm) {
  using C = Config<U, T, kMT, kNT>;
  constexpr int bR = C::kBR, bM = C::kBM;
  constexpr bool kExact = kR > 0;
  constexpr int kM = kExact ? T - kR + 1 : T;  // rows of A^T the inverse needs
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = kExact ? T * T : prm.p, bc = prm.bc, ldc = prm.ldc, ldu = prm.ldu;
  const int th = kExact ? T : prm.th, tw = kExact ? T : prm.tw;
  const int mh = kExact ? kM : prm.mh, mw = kExact ? kM : prm.mw;
  float* s_strip = reinterpret_cast<float*>(smem);       // 2 x (sh, sw, ldc) or (bR, P, ldc)
  U* s_u = reinterpret_cast<U*>(s_strip + 2 * prm.strip_floats);  // 2 x (P, bc, ldu)
  float* s_v = reinterpret_cast<float*>(s_u + 2 * prm.u_elems);   // (P, bR, ldc)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int blk = blockIdx.x;
  const int wb = blk % prm.n_wb;
  blk /= prm.n_wb;
  const int hb = blk % prm.n_hb;
  const int img = blk / prm.n_hb;
  const int m_base = blockIdx.y * bM;
  const int row0 = hb * prm.bh * mh;  // first output row (= phase strip row) of this block
  const int col0 = wb * prm.bw * mw;
  constexpr int kS = kPhases == 4 ? 2 : 1;  // the input stride
  const float* x_img = prm.x + (size_t)img * prm.hp * prm.wp * prm.cp;
  const U* u = static_cast<const U*>(prm.u);

  // cp.async step s's strip and raw filter chunk (phase ph, channels
  // [c0, c0 + bc)) into stage `buf`, as one commit group.
  // (Index arithmetic by shifts and one __umulhi: a runtime division costs
  // ~20 instructions, and these loops run every C step.)
  const int n_c = prm.cp >> prm.lbc;  // C steps per phase
  auto stage = [&](int s, int buf) {
    int ph = 0, c0 = s << prm.lbc;
    if constexpr (kPhases > 1) {
      ph = s / n_c;
      c0 = (s - ph * n_c) << prm.lbc;
    }
    const float* x_ph = x_img + ((ph >> 1) * prm.wp + (ph & 1)) * prm.cp + c0;
    float* ds = s_strip + buf * prm.strip_floats;
    const int lq4 = prm.lbc - 2;
    if constexpr (kTiles) {
      // the block's tiles are bR * P consecutive pixels of Cp channels
      const float* src = prm.x + (size_t)blockIdx.x * bR * P * prm.cp + c0;
      for (int i = tid; i < (bR * P) << lq4; i += kThreads) {
        const int q = i & ((1 << lq4) - 1), pix = i >> lq4;
        cp_async16(ds + pix * ldc + 4 * q, src + (size_t)pix * prm.cp + 4 * q);
      }
    } else {
      for (int i = tid; i < (prm.sh * prm.sw) << lq4; i += kThreads) {
        const int q = i & ((1 << lq4) - 1), pix = i >> lq4;
        const int yy = __umulhi(pix, prm.sw_magic), xx = pix - yy * prm.sw;
        cp_async16(ds + pix * ldc + 4 * q,
                   x_ph + ((size_t)kS * (row0 + yy) * prm.wp + kS * (col0 + xx)) * prm.cp + 4 * q);
      }
    }
    U* du = s_u + buf * prm.u_elems;
    const U* u_ph = u + ((size_t)ph * P * prm.cp + c0) * prm.mp + m_base;
    constexpr int kPer = 16 / sizeof(U);
    constexpr int qm = bM / kPer;  // a power of two
    for (int i = tid; i < P * bc * qm; i += kThreads) {
      const int q = i % qm, pc = i / qm;
      const int c = pc & (bc - 1), p = pc >> prm.lbc;
      cp_async16(du + pc * ldu + kPer * q, u_ph + ((size_t)p * prm.cp + c) * prm.mp + kPer * q);
    }
    cp_async_commit();
  };

  float acc[C::kPts][kMT][kNT][4];
#pragma unroll
  for (int q = 0; q < C::kPts; ++q)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][i][j][e] = 0.f;

  const int n_steps = kPhases * n_c;
  stage(0, 0);
  for (int s = 0; s < n_steps; ++s) {
    const int buf = s & 1;
    cp_async_wait_all();
    __syncthreads();  // stage s has landed; step s-1's GEMMs are done with V
    if (s + 1 < n_steps) stage(s + 1, buf ^ 1);

    // Input transform B_h^T d B_w, one (tile, channel) per thread, channels
    // fastest (the strip reads are contiguous), into V (P, bR, bc).
    const float* strip = s_strip + buf * prm.strip_floats;
    for (int i = tid; i < bR * bc; i += kThreads) {
      const int c = i & (bc - 1), r = i >> prm.lbc;
      const float* src =
          strip + ((r >> prm.lbw) * mh * prm.sw + (r & (prm.bw - 1)) * mw) * ldc + c;
      const float* tile = strip + r * P * ldc + c;  // kTiles: tile r's pixel (0, 0)
      float* dst = s_v + r * ldc + c;
      float t1[T][T];  // B_h^T d, column by column
#pragma unroll
      for (int b = 0; b < T; ++b) {
        float d[T];
#pragma unroll
        for (int a = 0; a < T; ++a)
          if constexpr (kTiles)
            d[a] = (kExact || (a < th && b < tw)) ? tile[(a * tw + b) * ldc] : 0.f;
          else
            d[a] = (kExact || (a < th && b < tw)) ? src[(a * prm.sw + b) * ldc] : 0.f;
#pragma unroll
        for (int ii = 0; ii < T; ++ii) {
          float v = 0.f;
#pragma unroll
          for (int a = 0; a < T; ++a) v += prm.bt_h[ii * kMaxT + a] * d[a];
          t1[ii][b] = v;
        }
      }
#pragma unroll
      for (int ii = 0; ii < T; ++ii) {
        if (kExact || ii < th) {
#pragma unroll
          for (int j = 0; j < T; ++j) {
            if (kExact || j < tw) {
              float v = 0.f;
#pragma unroll
              for (int b = 0; b < T; ++b) v += t1[ii][b] * prm.bt_w[j * kMaxT + b];
              dst[(ii * tw + j) * bR * ldc] = v;
            }
          }
        }
      }
    }
    __syncthreads();  // V is complete

    // The point-GEMMs V[p] (bR x bc) x U[p] (bc x bM), warp w on points
    // w, w + 8, ..., TF32x3. The tensor cores round their fp32 sums toward
    // zero, so each 16-row tile's C step sums into a zeroed fragment that
    // joins the running accumulator with an fp32 add (round to nearest):
    // the biased rounding spans bc channels, not all of C.
    const U* us = s_u + buf * prm.u_elems + ((lane & 3) * ldu + (lane >> 2));
    const float* vs = s_v + (lane >> 2) * ldc + (lane & 3);
#pragma unroll
    for (int q = 0; q < C::kPts; ++q) {
      const int p = warp + kWarps * q;
      if (p < P) {
        const float* vp = vs + p * bR * ldc;
        const U* up = us + p * bc * ldu;
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          float part[kNT][4] = {};
          for (int k0 = 0; k0 < bc; k0 += 8) {
            FragA a;
            load_a(a, vp + i * 16 * ldc + k0, ldc);
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              FragB b;
              load_b<C::kBLo>(b, up + k0 * ldu + j * 8, ldu);
              mma_tf32x3<C::kBLo>(part[j], a, b);
            }
          }
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][i][j][e] += part[j][e];
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the staged operands

  // Spill the accumulators to Y (P, bR, bM + 4) for the inverse transform.
  constexpr int ldy = bM + 4;
  float* s_y = reinterpret_cast<float*>(smem);
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int q = 0; q < C::kPts; ++q) {
      const int p = warp + kWarps * q;
      if (p < P) {
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            float* dst = s_y + (p * bR + i * 16 + g) * ldy + j * 8 + 2 * t;
            *reinterpret_cast<float2*>(dst) = make_float2(acc[q][i][j][0], acc[q][i][j][1]);
            *reinterpret_cast<float2*>(dst + 8 * ldy) =
                make_float2(acc[q][i][j][2], acc[q][i][j][3]);
          }
      }
    }
  }
  __syncthreads();

  // Inverse transform A_h^T y A_w, epilogue, NHWC store (m fastest).
  const int h_out = prm.n_hb * prm.bh * mh;
  const int w_out = prm.n_wb * prm.bw * mw;
  for (int i = tid; i < bR * bM; i += kThreads) {
    const int m = i % bM, r = i / bM;
    const float* src = s_y + r * ldy + m;
    float o[T][T];
#pragma unroll
    for (int ii = 0; ii < T; ++ii)
#pragma unroll
      for (int j = 0; j < T; ++j) o[ii][j] = 0.f;
#pragma unroll
    for (int a = 0; a < T; ++a) {
      if (kExact || a < th) {
        float row[kM];
#pragma unroll
        for (int j = 0; j < kM; ++j) row[j] = 0.f;
#pragma unroll
        for (int b = 0; b < T; ++b) {
          if (kExact || b < tw) {
            const float yv = src[(a * tw + b) * bR * ldy];
#pragma unroll
            for (int j = 0; j < kM; ++j) row[j] += prm.at_w[j * kMaxT + b] * yv;
          }
        }
#pragma unroll
        for (int ii = 0; ii < kM; ++ii)
#pragma unroll
          for (int j = 0; j < kM; ++j) o[ii][j] += prm.at_h[ii * kMaxT + a] * row[j];
      }
    }
    const int mg = m_base + m;
    if constexpr (kTiles) {
      float* dst = prm.y + (size_t)(blockIdx.x * bR + r) * mh * mw * prm.mp + mg;
#pragma unroll
      for (int ii = 0; ii < kM; ++ii) {
        if (ii < mh) {
#pragma unroll
          for (int j = 0; j < kM; ++j) {
            if (j < mw) dst[(ii * mw + j) * prm.mp] = o[ii][j];
          }
        }
      }
      continue;
    }
    const float sc = prm.scale != nullptr ? prm.scale[mg] : 1.f;
    const float bi = (prm.bias != nullptr && mg < prm.n_bias) ? prm.bias[mg] : 0.f;
    const int oy = row0 + (r >> prm.lbw) * mh;
    const int ox = col0 + (r & (prm.bw - 1)) * mw;
    float* dst = prm.y + (((size_t)img * h_out + oy) * w_out + ox) * prm.mp + mg;
#pragma unroll
    for (int ii = 0; ii < kM; ++ii) {
      if (ii < mh) {
#pragma unroll
        for (int j = 0; j < kM; ++j) {
          if (j < mw) dst[((size_t)ii * w_out + j) * prm.mp] = activate(o[ii][j] * sc + bi, prm.act);
        }
      }
    }
  }
}

// Validation failures the launcher reports before touching the device.
constexpr int kErrBadShape = -1;
constexpr int kErrBadBlocking = -2;
constexpr int kErrBadType = -3;
constexpr int kErrBadAlign = -4;

// Dynamic shared memory of one block: two strip (or tile) stages, two
// filter stages and V during the C sweep; the (P, bR, bM + 4) accumulator
// spill after it reuses the same space. Must agree with core/winograd.py:
// stream_tc_smem_bytes (fused_smem_bytes for the tiles).
inline size_t smem_bytes(const Params& prm, int br, int bm, int usize) {
  const size_t stage = 4 * (2 * (size_t)prm.strip_floats + (size_t)prm.p * br * prm.ldc) +
                       2 * (size_t)prm.u_elems * usize;
  const size_t spill = 4 * (size_t)prm.p * br * (bm + 4);
  return stage > spill ? stage : spill;
}

// The filter size of the guard-free instantiations, 0 where a transform
// size has none: the main path's tiles, F(2, 3) and F(4, 3) at stride 1
// (T = 4, 6), the stride-2 phase sub-filters of a 3 x 3 at F(2, 2) and
// F(4, 2) (T = 3, 5, the MobileNet stems).
template <int T, int kPhases>
constexpr int exact_r() {
  if constexpr (kPhases == 1) return T == 4 || T == 6 ? 3 : 0;
  return T == 3 || T == 5 ? 2 : 0;
}

// n_img: images (kTiles: tile blocks R / bR, with n_hb = n_wb = 1).
template <typename U, int T, int kMT, int kNT, int kPhases, bool kTiles>
int launch(Params prm, int n_img, cudaStream_t stream) {
  constexpr int kR = exact_r<T, kPhases>();
  const bool exact = kR > 0 && prm.th == T && prm.tw == T && prm.mh == T - kR + 1 &&
                     prm.mw == T - kR + 1;
  auto kernel = exact ? winograd_tc_kernel<U, T, kMT, kNT, kR, kPhases, kTiles>
                      : winograd_tc_kernel<U, T, kMT, kNT, 0, kPhases, kTiles>;
  if constexpr (kTiles) prm.strip_floats = 16 * kMT * prm.p * prm.ldc;
  prm.ldu = u_row_bytes(8 * kNT, sizeof(U)) / sizeof(U);
  prm.u_elems = prm.p * prm.bc * prm.ldu;
  const size_t smem = smem_bytes(prm, 16 * kMT, 8 * kNT, sizeof(U));
  if (smem > kSmemMax) return kErrBadBlocking;
  // Raise the kernel's shared-memory cap only when a launch needs more
  // than granted so far: a warmed-up launch then makes no CUDA API call but
  // the launch itself (and can be captured in a CUDA graph).
  static size_t granted[2] = {0, 0};
  if (smem > granted[exact]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted[exact] = smem;
  }
  dim3 grid(n_img * prm.n_hb * prm.n_wb, prm.mp / (8 * kNT));
  kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <typename U, int kPhases, bool kTiles = false>
int dispatch(const Params& prm, int n_img, int t, int br, int bm, cudaStream_t s) {
  const int mt = br / 16, nt = bm / 8;
  if (br % 16 != 0 || bm % 8 != 0) return kErrBadBlocking;
#define REPRO_CASE(T_, MT_, NT_) \
  if (t == T_ && mt == MT_ && nt == NT_) \
    return launch<U, T_, MT_, NT_, kPhases, kTiles>(prm, n_img, s);
  // The menu: must agree with core/winograd.py:WINOGRAD_TC_CONFIGS.
  REPRO_CASE(3, 1, 4) REPRO_CASE(3, 1, 8) REPRO_CASE(3, 2, 4)
  REPRO_CASE(4, 1, 4) REPRO_CASE(4, 1, 8) REPRO_CASE(4, 2, 4)
  REPRO_CASE(5, 1, 2) REPRO_CASE(5, 1, 4) REPRO_CASE(5, 2, 2)
  REPRO_CASE(6, 1, 2) REPRO_CASE(6, 1, 4) REPRO_CASE(6, 2, 2)
  REPRO_CASE(8, 1, 2)
  // the tiles' own entry (core/winograd.py:FUSED_TC_CONFIGS): at T = 8 the
  // (1, 2) blocking's two tile stages leave no room in 227 KB
  if constexpr (kTiles) {
    REPRO_CASE(8, 1, 1)
  }
#undef REPRO_CASE
  return kErrBadBlocking;
}

}  // namespace


namespace {

// Validate, fill the parameters and launch on `stream` (see the C entry
// points). The input is padded so that hp = S (n_hb*bh*mh + th - mh) at
// input stride S (1 or 2 for kPhases 1 or 4), and likewise wp; cp is a
// multiple of bc in {8, 16, 32}, mp of bm; xp and u are 16-byte aligned;
// u holds kPhases banks of (P, cp, mp), phase-major.
template <int kPhases>
int launch_tc(const float* xp, const void* u, int u_type, const float* bias, int n_bias,
              const float* scale, float* y, int n, int hp, int wp, int cp, int mp, int th,
              int tw, int mh, int mw, int bh, int bw, int bc, int bm, int activation,
              const float* mats, void* stream) {
  constexpr int kS = kPhases == 4 ? 2 : 1;
  if (n < 1 || activation < kNone || activation > kGelu || bh < 1 || bw < 1 ||
      th < 2 || tw < 2 || th > kMaxT || tw > kMaxT || mh < 1 || mw < 1 ||
      mh >= th || mw >= tw)
    return kErrBadShape;
  const int sh = bh * mh, sw = bw * mw;
  const int halo_h = kS * (th - mh), halo_w = kS * (tw - mw);
  if (hp <= halo_h || wp <= halo_w || (hp - halo_h) % (kS * sh) != 0 ||
      (wp - halo_w) % (kS * sw) != 0)
    return kErrBadShape;
  if ((bc != 8 && bc != 16 && bc != 32) || cp < bc || cp % bc != 0 || bm < 8 ||
      mp % bm != 0 || (bw & (bw - 1)) != 0)
    return kErrBadBlocking;
  if (reinterpret_cast<uintptr_t>(xp) % 16 != 0 || reinterpret_cast<uintptr_t>(u) % 16 != 0)
    return kErrBadAlign;

  Params prm{};
  prm.x = xp;
  prm.u = u;
  prm.bias = bias;
  prm.scale = scale;
  prm.y = y;
  prm.n_bias = n_bias;
  prm.hp = hp;
  prm.wp = wp;
  prm.cp = cp;
  prm.mp = mp;
  prm.th = th;
  prm.tw = tw;
  prm.mh = mh;
  prm.mw = mw;
  prm.p = th * tw;
  prm.bh = bh;
  prm.bw = bw;
  prm.bc = bc;
  prm.n_hb = (hp - halo_h) / (kS * sh);
  prm.n_wb = (wp - halo_w) / (kS * sw);
  prm.sh = sh + th - mh;
  prm.sw = sw + tw - mw;
  prm.sw_magic = (unsigned)((0x100000000ull + prm.sw - 1) / prm.sw);
  prm.lbc = bc == 8 ? 3 : bc == 16 ? 4 : 5;
  while ((1 << prm.lbw) < bw) ++prm.lbw;
  prm.ldc = bc + 4;
  prm.strip_floats = prm.sh * prm.sw * prm.ldc;
  prm.act = activation;
  for (int i = 0; i < kMaxT * kMaxT; ++i) {
    prm.bt_h[i] = mats[i];
    prm.bt_w[i] = mats[64 + i];
    prm.at_h[i] = mats[128 + i];
    prm.at_w[i] = mats[192 + i];
  }
  const int tmax = th > tw ? th : tw;
  const int t = tmax <= 3 ? 3 : tmax <= 6 ? tmax : 8;
  const int br = bh * bw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (u_type) {
    case kF32:
      return dispatch<float, kPhases>(prm, n, t, br, bm, s);
    case kBF16:
      return dispatch<__nv_bfloat16, kPhases>(prm, n, t, br, bm, s);
    case kI8:
      return dispatch<int8_t, kPhases>(prm, n, t, br, bm, s);
    default:
      return kErrBadType;
  }
}

const char* tc_error(int code) {
  switch (code) {
    case kErrBadShape:
      return "operand shapes do not match the tile geometry";
    case kErrBadBlocking:
      return "blocking does not fit the kernel's tile menu or shared memory";
    case kErrBadType:
      return "unsupported filter dtype";
    case kErrBadAlign:
      return "xp and u must be 16-byte aligned";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // namespace
