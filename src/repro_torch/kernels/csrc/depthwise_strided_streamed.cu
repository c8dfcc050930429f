// Stride-2 depthwise Winograd / Cook-Toom convolution for Hopper, by
// transform-domain phase decomposition.
//
// Replaces repro/kernels/depthwise.py:depthwise_strided_streamed (the
// Pallas TPU kernel). Same function on the same operands: the
// full-resolution padded NHWC fp32 input xp (N, Hp, Wp, Cp), the
// phase-major Winograd-domain taps u (4P, Cp) in fp32, bf16 or int8
// (channel multiplier 1), an optional bias (at most Cp entries) and an
// optional int8 dequantization scale row (Cp) -> the stride-2 NHWC output
// (N, nHb*bh*mh, nWb*bw*mw, Cp). Four phase Hadamard products sum in the
// transform domain; one inverse transform and the fused epilogue (x scale,
// + bias, activation) follow.
//
// What bounds it: bytes. There is no reduction: per output pixel and
// channel a few dozen FLOPs (4 phase transforms of a t x t tile, t = 3 or 5
// on MobileNets, shared by m^2 outputs) against 16 input bytes read (each
// output covers a 2 x 2 input window) and 4 written, under the card's
// ~20 FLOP/byte fp32 balance point. The design spends its effort on moving
// each byte once and on the instructions per byte, as the stride-1 kernel
// (depthwise_streamed.cu) does:
//  * one block per (bh x bw) strip of output tiles x bc channels stages
//    the strip's full-resolution window with its halo,
//    (2*(bh*mh + th - mh)) x (2*(bw*mw + tw - mw)) x bc, in shared memory
//    by 16-byte cp.async copies of 4 channels: each input element leaves
//    L2 once per block, where one thread per tile reread the (t/m)^2
//    overlap of its four phase tiles from L1;
//  * the block's (4P, bc) taps, widened to fp32 once, and its scale and
//    bias rows sit beside the strip, so the inner loop is the same at
//    fp32, bf16 and int8: no sub-word loads, no widening per use;
//  * the main path's two phase tiles, F(2, 2) (t = 3) and F(4, 2) (t = 5),
//    run guard-free bodies with B^T and A^T as compile-time constants
//    (their zero products drop out, their +-1 products become adds),
//    taken only where the plan's matrices equal the tables bitwise
//    (checked on the host); every other tile up to 8 x 8 runs the generic
//    guarded body with the runtime matrices;
//  * 256 threads loop over the block's (tile, channel group) items, a warp
//    on one tile's bc channels (32 / bc tiles for bc < 32), bc / 32 (at
//    most 2) adjacent channels per thread with float2 shared loads and
//    global stores on the t = 3 body; 3 blocks (24 warps) per SM for t <= 4
//    (__launch_bounds__), 2 at t = 5, 6 and 1 above.
//
// How the TPU design translates: the Pallas kernel gathered four phase
// tile tensors from one VMEM halo strip (phase_gather_tiles) and
// vectorized the transform over the strip. Here the strip lives in shared
// memory and each thread reads its tile's phase elements at
// full-resolution (2*(y0 + a) + ph, 2*(x0 + b) + qh) from it. Its grid
// (N, nHb, nWb, C/bC) becomes blocks of (bh x bw tiles) x bc channels
// (core/winograd.py:stream_geometry_depthwise, stride=2); edge blocks are
// padded by the caller to whole strips, 2x the stride-1 surplus per axis,
// and cropped after.

#include <cstring>

#include "depthwise_common.cuh"
#include "mma_tf32x3.cuh"  // cp.async

namespace {

constexpr size_t kSmemMax = 227 * 1024;

struct DwParams {
  float bt_h[kMaxT * kMaxT];  // row-major, zero-padded to 8 x 8
  float bt_w[kMaxT * kMaxT];
  float at_h[kMaxT * kMaxT];
  float at_w[kMaxT * kMaxT];
  const float* x;
  const void* u;
  const float* bias;
  const float* scale;
  float* y;
  int u_type, n_bias;
  int hp, wp, cp;
  int th, tw, mh, mw, p;  // p = th * tw points per phase
  int bh, bw, bc, n_hb, n_wb;
  int sh, sw;         // strip extent, full-resolution pixels
  unsigned sw_magic;  // ceil(2^32 / sw): pixel / sw as one __umulhi
  int lbw, lg;        // log2 of bw and of the channel groups bc / cpt
  int act;
};

// F(2, 2) and F(4, 2) per phase as core/transforms.py:cook_toom(m, 2)
// builds them, in float32: the guard-free bodies' constants.
__host__ __device__ constexpr float f22_bt(int i, int a) {
  switch (i * 3 + a) {
    case 0: case 4: case 8: return 1.f;
    case 1: case 7: return -1.f;
    default: return 0.f;
  }
}
__host__ __device__ constexpr float f22_at(int i, int a) {
  switch (i * 3 + a) {
    case 0: case 1: case 4: case 5: return 1.f;
    default: return 0.f;
  }
}
__host__ __device__ constexpr float f42_bt(int i, int a) {
  switch (i * 5 + a) {
    case 0: case 6: case 24: return 1.f;
    case 1: case 8: return -.5f;
    case 2: case 22: return -1.f;
    case 3: case 7: case 12: return .5f;
    case 11: return -0.3333333432674408f;
    case 13: case 16: return -0.1666666716337204f;
    case 18: return 0.1666666716337204f;
    case 21: return 2.f;
    case 23: return -2.f;
    default: return 0.f;
  }
}
__host__ __device__ constexpr float f42_at(int i, int a) {
  switch (i * 5 + a) {
    case 0: case 1: case 2: case 3: case 6: case 11: case 12: case 16: case 19: return 1.f;
    case 7: case 17: return -1.f;
    case 8: return 2.f;
    case 13: return 4.f;
    case 18: return 8.f;
    default: return 0.f;
  }
}

// Transform entries: the exact bodies' constants (t = 3: F(2, 2), t = 5:
// F(4, 2)), else the launch's matrix `m` (8 x 8, row-major).
template <int T, bool kExact>
__device__ __forceinline__ float bt_at(const float* m, int i, int a) {
  if constexpr (kExact) return T == 3 ? f22_bt(i, a) : f42_bt(i, a);
  return m[i * kMaxT + a];
}
template <int T, bool kExact>
__device__ __forceinline__ float at_at(const float* m, int i, int a) {
  if constexpr (kExact) return T == 3 ? f22_at(i, a) : f42_at(i, a);
  return m[i * kMaxT + a];
}

// acc + w * x; a constant zero w (the exact bodies) drops the term.
template <bool kExact>
__device__ __forceinline__ float madd(float w, float x, float acc) {
  if (kExact && w == 0.f) return acc;
  return fmaf(w, x, acc);
}

// One output tile of K adjacent channels. `src` points at the tile's
// full-resolution origin and first channel in the strip (pixel (y, x) at
// src[(y*sw + x)*bc]), `taps` at phase 0, point 0 of the channels' taps
// (phase ph, point p at taps[(ph*P + p)*bc]). For each phase (pr, pc), the
// tile's elements (2a + pr, 2b + pc) go through B_h^T d B_w, one input
// column at a time, and multiply that phase's taps into the transform-domain
// sum; then o = A_h^T acc A_w, one transform row at a time (o[ii][jj] for
// ii < mh, jj < mw). The exact bodies (th = tw = T, m = T - 1) start their
// sums at -0, which x + -0 = x lets the compiler fold into the first term.
template <int T, bool kExact, int K>
__device__ __forceinline__ void strided_tile(const DwParams& prm, const float* src,
                                             const float* taps, float (&o)[T - 1][T - 1][K]) {
  const int th = kExact ? T : prm.th, tw = kExact ? T : prm.tw;
  const int sw = prm.sw, bc = prm.bc, p = kExact ? T * T : prm.p;
  const float z0 = kExact ? -0.f : 0.f;
  float acc[T][T][K];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k) acc[i][j][k] = z0;

#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    const float* sp = src + ((ph >> 1) * sw + (ph & 1)) * bc;
    const float* tp = taps + ph * p * bc;
    float t1[T][T][K];  // B_h^T d
#pragma unroll
    for (int b = 0; b < T; ++b) {
      float d[T][K];
#pragma unroll
      for (int a = 0; a < T; ++a) {
        if (kExact || (a < th && b < tw)) {
          ld(d[a], sp + (2 * a * sw + 2 * b) * bc);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) d[a][k] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float v = z0;
#pragma unroll
          for (int a = 0; a < T; ++a) v = madd<kExact>(bt_at<T, kExact>(prm.bt_h, i, a), d[a][k], v);
          t1[i][b][k] = v;
        }
    }
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if (kExact || (i < th && j < tw)) {
          float u[K];
          ld(u, tp + (i * tw + j) * bc);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float v = z0;
#pragma unroll
            for (int b = 0; b < T; ++b)
              v = madd<kExact>(bt_at<T, kExact>(prm.bt_w, j, b), t1[i][b][k], v);
            acc[i][j][k] = fmaf(v, u[k], acc[i][j][k]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < T - 1; ++ii)
#pragma unroll
    for (int jj = 0; jj < T - 1; ++jj)
#pragma unroll
      for (int k = 0; k < K; ++k) o[ii][jj][k] = z0;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    if (kExact || i < th) {
      float z[T - 1][K];  // row i of acc A_w
#pragma unroll
      for (int jj = 0; jj < T - 1; ++jj)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float v = z0;
#pragma unroll
          for (int j = 0; j < T; ++j)
            if (kExact || j < tw) v = madd<kExact>(at_at<T, kExact>(prm.at_w, jj, j), acc[i][j][k], v);
          z[jj][k] = v;
        }
#pragma unroll
      for (int ii = 0; ii < T - 1; ++ii)
#pragma unroll
        for (int jj = 0; jj < T - 1; ++jj)
#pragma unroll
          for (int k = 0; k < K; ++k)
            o[ii][jj][k] = madd<kExact>(at_at<T, kExact>(prm.at_h, ii, i), z[jj][k], o[ii][jj][k]);
    }
  }
}

// The epilogue of K adjacent channels of one tile: x scale, + bias,
// activation, stored at dst (output (ii, jj) at dst[(ii*w_out + jj)*cp]).
template <int T, bool kExact, int K>
__device__ __forceinline__ void store_tile(const DwParams& prm, float* dst, int w_out,
                                           const float (&o)[T - 1][T - 1][K],
                                           const float (&sc)[K], const float (&bi)[K]) {
  const int mh = kExact ? T - 1 : prm.mh, mw = kExact ? T - 1 : prm.mw;
#pragma unroll
  for (int ii = 0; ii < T - 1; ++ii) {
    if (ii < mh) {
#pragma unroll
      for (int jj = 0; jj < T - 1; ++jj) {
        if (jj < mw) {
          float v[K];
#pragma unroll
          for (int k = 0; k < K; ++k) v[k] = activate(o[ii][jj][k] * sc[k] + bi[k], prm.act);
          st(dst + ((size_t)ii * w_out + jj) * prm.cp, v);
        }
      }
    }
  }
}

// kExact: the F(2, 2) (T = 3) or F(4, 2) (T = 5) body; else the generic
// body for tiles up to T x T. kCpt adjacent channels per item, side by side
// on the T = 3 body, one after another on the others (their registers).
template <int T, bool kExact, int kCpt>
__global__ void __launch_bounds__(kThreads, T <= 4 ? 3 : T <= 6 ? 2 : 1)
    depthwise_strided_kernel(const __grid_constant__ DwParams prm) {
  constexpr int kK = (kExact && T == 3) ? kCpt : 1;  // channels side by side
  extern __shared__ __align__(16) float smem[];
  const int bc = prm.bc, sw = prm.sw;
  const int mh = kExact ? T - 1 : prm.mh, mw = kExact ? T - 1 : prm.mw;
  const int p4 = 4 * (kExact ? T * T : prm.p);
  float* s_x = smem;                   // (sh, sw, bc)
  float* s_u = s_x + prm.sh * sw * bc;  // (4P, bc)
  float* s_scale = s_u + p4 * bc;      // (bc)
  float* s_bias = s_scale + bc;        // (bc)

  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int wb = blk % prm.n_wb;
  blk /= prm.n_wb;
  const int hb = blk % prm.n_hb;
  const int img = blk / prm.n_hb;
  const int c0 = blockIdx.y * bc;
  const int row0 = hb * prm.bh * mh, col0 = wb * prm.bw * mw;  // output = phase-grid origin

  // The full-resolution halo strip, 16-byte copies of 4 channels, in flight
  // while the taps and epilogue rows are widened into shared memory.
  {
    const float* x = prm.x + ((size_t)img * prm.hp * prm.wp) * prm.cp + c0;
    const int lq = __ffs(bc) - 3;  // log2(bc / 4)
    for (int i = tid; i < (prm.sh * sw) << lq; i += kThreads) {
      const int q = i & ((1 << lq) - 1), pix = i >> lq;
      const int yy = __umulhi(pix, prm.sw_magic), xx = pix - yy * sw;
      cp_async16(s_x + pix * bc + 4 * q,
                 x + ((size_t)(2 * row0 + yy) * prm.wp + 2 * col0 + xx) * prm.cp + 4 * q);
    }
    cp_async_commit();
  }
  for (int i = tid; i < p4 * bc; i += kThreads) {
    const int c = i % bc, pt = i / bc;
    s_u[i] = load_tap(prm.u, prm.u_type, (size_t)pt * prm.cp + c0 + c);
  }
  for (int i = tid; i < bc; i += kThreads) {
    s_scale[i] = prm.scale != nullptr ? prm.scale[c0 + i] : 1.f;
    s_bias[i] = (prm.bias != nullptr && c0 + i < prm.n_bias) ? prm.bias[c0 + i] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int h_out = prm.n_hb * prm.bh * mh;
  const int w_out = prm.n_wb * prm.bw * mw;
  const int groups = 1 << prm.lg;  // bc / kCpt
  for (int i = tid; i < (prm.bh << prm.lbw) << prm.lg; i += kThreads) {
    const int g = i & (groups - 1), r = i >> prm.lg;
    const int ty = r >> prm.lbw, tx = r & (prm.bw - 1);
    const int c = g * kCpt;  // first channel of the item, in the block
    const float* src = s_x + ((2 * ty * mh) * sw + 2 * tx * mw) * bc + c;
    const int oy = row0 + ty * mh, ox = col0 + tx * mw;
    float* dst = prm.y + (((size_t)img * h_out + oy) * w_out + ox) * prm.cp + c0 + c;
#pragma unroll 1
    for (int k = 0; k < kCpt; k += kK) {
      float o[T - 1][T - 1][kK], sc[kK], bi[kK];
      strided_tile<T, kExact, kK>(prm, src + k, s_u + c + k, o);
      ld(sc, s_scale + c + k);
      ld(bi, s_bias + c + k);
      store_tile<T, kExact, kK>(prm, dst + k, w_out, o, sc, bi);
    }
  }
}

constexpr int kErrBadShape = -1;
constexpr int kErrBadBlocking = -2;
constexpr int kErrBadType = -3;
constexpr int kErrBadAlign = -4;

// Dynamic shared memory of one block; must agree with core/winograd.py:
// depthwise_strided_smem_bytes.
inline size_t smem_bytes(const DwParams& prm) {
  return 4 * ((size_t)prm.sh * prm.sw * prm.bc + (size_t)(4 * prm.p + 2) * prm.bc);
}

template <int T, bool kExact, int kCpt>
int launch(const DwParams& prm, int n_img, cudaStream_t stream) {
  auto kernel = depthwise_strided_kernel<T, kExact, kCpt>;
  const size_t smem = smem_bytes(prm);
  if (smem > kSmemMax) return kErrBadBlocking;
  // Raise the cap only when a launch needs more than granted so far: a
  // warm launch makes no CUDA API call but the launch itself (capturable).
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  dim3 grid(n_img * prm.n_hb * prm.n_wb, prm.cp / prm.bc);
  kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <int kCpt>
int launch_cpt(const DwParams& prm, int n_img, int exact, int t, cudaStream_t s) {
  if (exact == 3) return launch<3, true, kCpt>(prm, n_img, s);
  if (exact == 5) return launch<5, true, kCpt>(prm, n_img, s);
  switch (t) {
    case 2: return launch<2, false, kCpt>(prm, n_img, s);
    case 3: return launch<3, false, kCpt>(prm, n_img, s);
    case 4: return launch<4, false, kCpt>(prm, n_img, s);
    case 5: return launch<5, false, kCpt>(prm, n_img, s);
    case 6: return launch<6, false, kCpt>(prm, n_img, s);
    case 7: return launch<7, false, kCpt>(prm, n_img, s);
    case 8: return launch<8, false, kCpt>(prm, n_img, s);
    default: return kErrBadShape;
  }
}

// The exact body the operand takes: 3 for F(2, 2), 5 for F(4, 2) on both
// axes (th = tw = t, mh = mw = t - 1 and `mats` (B_h^T, B_w^T, A_h^T, A_w^T,
// each 8 x 8) the body's constants zero-padded, bit for bit), else 0.
int exact_body(const float* mats, int th, int tw, int mh, int mw) {
  if (th != tw || mh != mw || mh != th - 1 || (th != 3 && th != 5)) return 0;
  float want[4 * kMaxT * kMaxT] = {};
  for (int m = 0; m < 4; ++m)
    for (int i = 0; i < th; ++i)
      for (int a = 0; a < th; ++a) {
        const bool inv = m >= 2;
        if (inv && i >= mh) continue;
        want[m * 64 + i * kMaxT + a] =
            th == 3 ? (inv ? f22_at(i, a) : f22_bt(i, a)) : (inv ? f42_at(i, a) : f42_bt(i, a));
      }
  return std::memcmp(want, mats, sizeof(want)) == 0 ? th : 0;
}

}  // namespace

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or a negative
// validation code; depthwise_strided_streamed_error names each. `mats` is a
// host array of 4 x 64 floats: B_h^T, B_w^T, A_h^T, A_w^T, row-major, each
// zero-padded to 8 x 8. The input is padded so that hp = 2*(n_hb*bh*mh +
// th - mh), and likewise wp; cp is a multiple of bc (8, 16, 32 or 64), bw a
// power of two; xp is 16-byte aligned.
int depthwise_strided_streamed_launch(const float* xp, const void* u,
                                      int u_type, const float* bias,
                                      int n_bias, const float* scale,
                                      float* y, int n, int hp, int wp,
                                      int cp, int th, int tw, int mh, int mw,
                                      int bh, int bw, int bc, int activation,
                                      const float* mats, void* stream) {
  if (th < 2 || tw < 2 || th > kMaxT || tw > kMaxT || mh < 1 || mw < 1 ||
      mh >= th || mw >= tw || n < 1 || activation < kNone || activation > kGelu)
    return kErrBadShape;
  const int sh = bh * mh, sw = bw * mw;
  const int halo_h = 2 * (th - mh), halo_w = 2 * (tw - mw);
  if (bh < 1 || bw < 1 || hp <= halo_h || wp <= halo_w ||
      (hp - halo_h) % (2 * sh) != 0 || (wp - halo_w) % (2 * sw) != 0)
    return kErrBadShape;
  if ((bc != 8 && bc != 16 && bc != 32 && bc != 64) || cp % bc != 0 ||
      (bw & (bw - 1)) != 0)
    return kErrBadBlocking;
  if (u_type != kF32 && u_type != kBF16 && u_type != kI8) return kErrBadType;
  if (reinterpret_cast<uintptr_t>(xp) % 16 != 0) return kErrBadAlign;

  DwParams prm{};
  for (int i = 0; i < kMaxT * kMaxT; ++i) {
    prm.bt_h[i] = mats[i];
    prm.bt_w[i] = mats[64 + i];
    prm.at_h[i] = mats[128 + i];
    prm.at_w[i] = mats[192 + i];
  }
  prm.x = xp;
  prm.u = u;
  prm.bias = bias;
  prm.scale = scale;
  prm.y = y;
  prm.u_type = u_type;
  prm.n_bias = n_bias;
  prm.hp = hp;
  prm.wp = wp;
  prm.cp = cp;
  prm.th = th;
  prm.tw = tw;
  prm.mh = mh;
  prm.mw = mw;
  prm.p = th * tw;
  prm.bh = bh;
  prm.bw = bw;
  prm.bc = bc;
  prm.n_hb = (hp - halo_h) / (2 * sh);
  prm.n_wb = (wp - halo_w) / (2 * sw);
  prm.sh = 2 * sh + halo_h;
  prm.sw = 2 * sw + halo_w;
  prm.sw_magic = (unsigned)((0x100000000ull + prm.sw - 1) / prm.sw);
  while ((1 << prm.lbw) < bw) ++prm.lbw;
  const int cpt = bc == 64 ? 2 : 1;  // core/winograd.py:depthwise_cpt
  while ((1 << prm.lg) < bc / cpt) ++prm.lg;
  prm.act = activation;

  const int exact = exact_body(mats, th, tw, mh, mw);
  const int t = th > tw ? th : tw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cpt == 2 ? launch_cpt<2>(prm, n, exact, t, s) : launch_cpt<1>(prm, n, exact, t, s);
}

const char* depthwise_strided_streamed_error(int code) {
  switch (code) {
    case kErrBadShape:
      return "operand shapes do not match the tile geometry";
    case kErrBadBlocking:
      return "blocking does not fit the kernel's C steps or shared memory";
    case kErrBadType:
      return "unsupported filter dtype";
    case kErrBadAlign:
      return "xp must be 16-byte aligned";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
