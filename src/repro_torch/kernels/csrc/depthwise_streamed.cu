// Stride-1 depthwise Winograd / Cook-Toom convolution for Hopper, with a
// channel multiplier.
//
// Replaces repro/kernels/depthwise.py:depthwise_streamed (the Pallas TPU
// kernel). Same function on the same operands: the halo-padded NHWC fp32
// input xp (N, Hp, Wp, Cp), the Winograd-domain taps u (P, Cp, mult) in
// fp32, bf16 or int8, an optional bias (at most Cp*mult entries) and an
// optional int8 dequantization scale row (Cp*mult) -> the NHWC output
// (N, nHb*bh*mh, nWb*bw*mw, Cp*mult), output channel o = c*mult + j (the
// grouped-conv order). Per tile and channel: input transform B^T d B,
// Hadamard product with the taps (widened to fp32), inverse transform
// A^T y A, then the epilogue in the reference's order: x scale, + bias,
// activation, scale and bias indexed by o.
//
// What bounds it: bytes. There is no reduction: per output pixel and
// channel a few dozen FLOPs (one t x t tile transform shared by m^2
// outputs; t = 4 at F(2x2, 3x3), the reduced-precision path's only tile)
// against 4 bytes read and 4 written, under the card's ~20 FLOP/byte fp32
// balance point. The design spends its effort on moving each byte once
// and on the instructions per byte:
//  * one block per (bh x bw) strip of tiles x bc channels stages the
//    strip with its halo, (bh*mh + th - mh) x (bw*mw + tw - mw) x bc, in
//    shared memory by 16-byte cp.async copies of 4 channels: each input
//    element leaves L2 once per block, where one thread per tile reread
//    the (t/m)^2 overlap;
//  * the block's (mult, P, bc) taps, widened to fp32 once, and its scale
//    and bias rows sit beside the strip, so the inner loop is the same at
//    fp32, bf16 and int8: no sub-word loads, no widening per use;
//  * F(2x2, 3x3) runs a guard-free body with B^T and A^T as compile-time
//    constants (their 0 and +-1 products drop out), taken only where the
//    plan's matrices equal the table bitwise; every other tile up to 8 x 8
//    runs the generic guarded body, one transform row at a time;
//  * a warp covers one tile's bc channels, bc / 32 (at most 2) adjacent
//    ones per thread with float2 shared loads and global stores (a
//    bc < 32 block puts 32 / bc tiles on a warp; 4 channels a thread
//    spilled at the 80-register cap and lost on every layer swept,
//    PERF.md); 256 threads loop over the block's (tile, channel group)
//    items, at 3 blocks (24 warps) per SM for T <= 4 (__launch_bounds__),
//    2 at T = 5, 6 and 1 above, where the generic body needs more
//    registers.
//
// How the TPU design translates: the Pallas kernel gathered a (bh, bw)
// strip of tiles from a VMEM halo strip and transformed them as one
// tensor, its (P, bC, mult) taps broadcast over the multiplier axis; here
// the strip and taps live in shared memory and each thread transforms its
// items in registers, the mult outputs of a channel one after another
// (the transform is recomputed per j; mult = 1 on every MobileNet layer).
// Its grid (N, nHb, nWb, C/bC) becomes blocks of (bh x bw tiles) x bc
// channels (core/winograd.py:stream_geometry_depthwise); edge blocks are
// padded by the caller to whole strips and cropped after.

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
  int hp, wp, cp, mult;
  int th, tw, mh, mw, p;
  int bh, bw, bc, n_hb, n_wb;
  int sh, sw;         // strip extent, pixels
  unsigned sw_magic;  // ceil(2^32 / sw): pixel / sw as one __umulhi
  int lbw, lg;        // log2 of bw and of the channel groups bc / cpt
  int act;
};

// F(2x2, 3x3) as core/transforms.py:cook_toom(2, 3) builds it, zero-padded
// to 8 x 8 like the launcher's operand: the exact body's constants.
constexpr float kF23Bt[4][4] = {
    {1.f, 0.f, -1.f, 0.f}, {0.f, .5f, .5f, 0.f}, {0.f, -.5f, .5f, 0.f}, {0.f, -1.f, 0.f, 1.f}};
constexpr float kF23At[2][4] = {{1.f, 1.f, 1.f, 0.f}, {0.f, 1.f, -1.f, 1.f}};

// One F(2x2, 3x3) tile of N adjacent channels: `src` points at the tile's
// first pixel and channel in the strip (pixel (a, b) at src[(a*sw + b)*bc]),
// `taps` at point 0 of the channels' tap set (point p at taps[p*bc]).
// Transform rows run in order 0..3, each from two input rows (B^T's two
// non-zeros per row), so at most two rows of the tile are live.
template <int N>
__device__ __forceinline__ void f23_tile(const float* src, int sw, int bc, const float* taps,
                                         float (&o)[2][2][N]) {
  float d0[4][N], d1[4][N], d2[4][N], d3[4][N];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < N; ++k) o[i][j][k] = 0.f;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    ld(d0[b], src + b * bc);
    ld(d2[b], src + (2 * sw + b) * bc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i == 1) {
#pragma unroll
      for (int b = 0; b < 4; ++b) ld(d1[b], src + (sw + b) * bc);
    }
    if (i == 3) {
#pragma unroll
      for (int b = 0; b < 4; ++b) ld(d3[b], src + (3 * sw + b) * bc);
    }
    float t[4][N];  // row i of B^T d
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int k = 0; k < N; ++k)
        t[b][k] = i == 0   ? d0[b][k] - d2[b][k]
                  : i == 1 ? .5f * (d1[b][k] + d2[b][k])
                  : i == 2 ? .5f * (d2[b][k] - d1[b][k])
                           : d3[b][k] - d1[b][k];
    float z0[N], z1[N];  // (row i of V x taps) A
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float u[N];
      ld(u, taps + (i * 4 + j) * bc);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float v = j == 0   ? t[0][k] - t[2][k]
                        : j == 1 ? .5f * (t[1][k] + t[2][k])
                        : j == 2 ? .5f * (t[2][k] - t[1][k])
                                 : t[3][k] - t[1][k];
        const float y = v * u[k];
        if (j == 0) z0[k] = y;
        if (j == 1) z0[k] += y, z1[k] = y;
        if (j == 2) z0[k] += y, z1[k] -= y;
        if (j == 3) z1[k] += y;
      }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (i <= 2) o[0][0][k] += z0[k], o[0][1][k] += z1[k];
      if (i == 1 || i == 3) o[1][0][k] += z0[k], o[1][1][k] += z1[k];
      if (i == 2) o[1][0][k] -= z0[k], o[1][1][k] -= z1[k];
    }
  }
}

// One tile of one channel, any th x tw <= T x T with mh x mw outputs: the
// generic guarded body with the runtime matrices. Transform row i of
// B_h^T d comes from the strip, multiplies the taps, goes through A_w and
// adds into the outputs by A_h^T's column i; o[ii][jj] for ii < mh,
// jj < mw.
template <int T>
__device__ __forceinline__ void generic_tile(const DwParams& prm, const float* src,
                                             const float* taps, float (&o)[T - 1][T - 1]) {
  const int th = prm.th, tw = prm.tw, sw = prm.sw, bc = prm.bc;
#pragma unroll
  for (int i = 0; i < T - 1; ++i)
#pragma unroll
    for (int j = 0; j < T - 1; ++j) o[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    if (i >= th) break;
    float t[T];
#pragma unroll
    for (int b = 0; b < T; ++b) t[b] = 0.f;
#pragma unroll
    for (int a = 0; a < T; ++a) {
      if (a < th) {
        const float w = prm.bt_h[i * kMaxT + a];
#pragma unroll
        for (int b = 0; b < T; ++b)
          if (b < tw) t[b] += w * src[(a * sw + b) * bc];
      }
    }
    float z[T - 1];
#pragma unroll
    for (int jj = 0; jj < T - 1; ++jj) z[jj] = 0.f;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      if (j < tw) {
        float v = 0.f;
#pragma unroll
        for (int b = 0; b < T; ++b) v += t[b] * prm.bt_w[j * kMaxT + b];
        const float y = v * taps[(i * tw + j) * bc];
#pragma unroll
        for (int jj = 0; jj < T - 1; ++jj) z[jj] += prm.at_w[jj * kMaxT + j] * y;
      }
    }
#pragma unroll
    for (int ii = 0; ii < T - 1; ++ii)
#pragma unroll
      for (int jj = 0; jj < T - 1; ++jj) o[ii][jj] += prm.at_h[ii * kMaxT + i] * z[jj];
  }
}

// kExact: the F(2x2, 3x3) body (T = 4); else the generic body for tiles up
// to T x T. kCpt adjacent channels per item.
template <int T, bool kExact, int kCpt>
__global__ void __launch_bounds__(kThreads, T <= 4 ? 3 : T <= 6 ? 2 : 1)
    depthwise_kernel(const __grid_constant__ DwParams prm) {
  extern __shared__ __align__(16) float smem[];
  const int bc = prm.bc, mult = prm.mult, sw = prm.sw;
  const int mh = kExact ? 2 : prm.mh, mw = kExact ? 2 : prm.mw;
  float* s_x = smem;                          // (sh, sw, bc)
  float* s_u = s_x + prm.sh * sw * bc;        // (mult, P, bc)
  float* s_scale = s_u + mult * prm.p * bc;   // (mult, bc)
  float* s_bias = s_scale + mult * bc;        // (mult, bc)

  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int wb = blk % prm.n_wb;
  blk /= prm.n_wb;
  const int hb = blk % prm.n_hb;
  const int img = blk / prm.n_hb;
  const int c0 = blockIdx.y * bc;
  const int row0 = hb * prm.bh * mh, col0 = wb * prm.bw * mw;

  // The halo strip, 16-byte copies of 4 channels, in flight while the taps
  // and epilogue rows are widened into shared memory.
  {
    const float* x = prm.x + ((size_t)img * prm.hp * prm.wp) * prm.cp + c0;
    const int lq = __ffs(bc) - 3;  // log2(bc / 4)
    for (int i = tid; i < (prm.sh * sw) << lq; i += kThreads) {
      const int q = i & ((1 << lq) - 1), pix = i >> lq;
      const int yy = __umulhi(pix, prm.sw_magic), xx = pix - yy * sw;
      cp_async16(s_x + pix * bc + 4 * q,
                 x + ((size_t)(row0 + yy) * prm.wp + col0 + xx) * prm.cp + 4 * q);
    }
    cp_async_commit();
  }
  for (int i = tid; i < mult * prm.p * bc; i += kThreads) {
    const int c = i % bc, jp = i / bc, p = jp % prm.p, j = jp / prm.p;
    s_u[i] = load_tap(prm.u, prm.u_type, ((size_t)p * prm.cp + c0 + c) * mult + j);
  }
  for (int i = tid; i < mult * bc; i += kThreads) {
    const int c = i % bc, j = i / bc, o = (c0 + c) * mult + j;
    s_scale[i] = prm.scale != nullptr ? prm.scale[o] : 1.f;
    s_bias[i] = (prm.bias != nullptr && o < prm.n_bias) ? prm.bias[o] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int h_out = prm.n_hb * prm.bh * mh;
  const int w_out = prm.n_wb * prm.bw * mw;
  const int mo = prm.cp * mult;
  const int groups = 1 << prm.lg;  // bc / kCpt
  for (int i = tid; i < (prm.bh << prm.lbw) << prm.lg; i += kThreads) {
    const int g = i & (groups - 1), r = i >> prm.lg;
    const int ty = r >> prm.lbw, tx = r & (prm.bw - 1);
    const int c = g * kCpt;  // first channel of the item, in the block
    const float* src = s_x + ((ty * mh) * sw + tx * mw) * bc + c;
    const int oy = row0 + ty * mh, ox = col0 + tx * mw;
    float* dst = prm.y + (((size_t)img * h_out + oy) * w_out + ox) * mo;
    for (int j = 0; j < mult; ++j) {
      const float* taps = s_u + j * prm.p * bc + c;
      if constexpr (kExact) {
        float sc[kCpt], bi[kCpt];
        ld(sc, s_scale + j * bc + c);
        ld(bi, s_bias + j * bc + c);
        float o[2][2][kCpt];
        f23_tile<kCpt>(src, sw, bc, taps, o);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            float v[kCpt];
#pragma unroll
            for (int k = 0; k < kCpt; ++k) v[k] = activate(o[ii][jj][k] * sc[k] + bi[k], prm.act);
            float* out = dst + ((size_t)ii * w_out + jj) * mo;
            if (mult == 1) {
              st(out + c0 + c, v);
            } else {
#pragma unroll
              for (int k = 0; k < kCpt; ++k) out[(c0 + c + k) * mult + j] = v[k];
            }
          }
      } else {
#pragma unroll 1
        for (int k = 0; k < kCpt; ++k) {
          float o[T - 1][T - 1];
          generic_tile<T>(prm, src + k, taps + k, o);
          const int oc = (c0 + c + k) * mult + j;
          const float sc = s_scale[j * bc + c + k], bi = s_bias[j * bc + c + k];
#pragma unroll
          for (int ii = 0; ii < T - 1; ++ii) {
            if (ii < mh) {
#pragma unroll
              for (int jj = 0; jj < T - 1; ++jj) {
                if (jj < mw)
                  dst[((size_t)ii * w_out + jj) * mo + oc] =
                      activate(o[ii][jj] * sc + bi, prm.act);
              }
            }
          }
        }
      }
    }
  }
}

constexpr int kErrBadShape = -1;
constexpr int kErrBadBlocking = -2;
constexpr int kErrBadType = -3;
constexpr int kErrBadAlign = -4;

// Dynamic shared memory of one block; must agree with core/winograd.py:
// depthwise_smem_bytes.
inline size_t smem_bytes(const DwParams& prm) {
  return 4 * ((size_t)prm.sh * prm.sw * prm.bc + (size_t)(prm.p + 2) * prm.mult * prm.bc);
}

template <int T, bool kExact, int kCpt>
int launch(const DwParams& prm, int n_img, cudaStream_t stream) {
  auto kernel = depthwise_kernel<T, kExact, kCpt>;
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
int launch_cpt(const DwParams& prm, int n_img, bool exact, int t, cudaStream_t s) {
  if (exact) return launch<4, true, kCpt>(prm, n_img, s);
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

// Whether the operand is F(2x2, 3x3) bit for bit: th = tw = 4, mh = mw = 2
// and `mats` (B_h^T, B_w^T, A_h^T, A_w^T, each 8 x 8) the exact body's
// constants zero-padded.
bool is_f23(const float* mats, int th, int tw, int mh, int mw) {
  if (th != 4 || tw != 4 || mh != 2 || mw != 2) return false;
  float want[4 * kMaxT * kMaxT] = {};
  for (int m = 0; m < 2; ++m)
    for (int i = 0; i < 4; ++i)
      for (int a = 0; a < 4; ++a) want[m * 64 + i * kMaxT + a] = kF23Bt[i][a];
  for (int m = 2; m < 4; ++m)
    for (int i = 0; i < 2; ++i)
      for (int a = 0; a < 4; ++a) want[m * 64 + i * kMaxT + a] = kF23At[i][a];
  return std::memcmp(want, mats, sizeof(want)) == 0;
}

}  // namespace

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or a negative
// validation code; depthwise_streamed_error names each. `mats` is a host
// array of 4 x 64 floats: B_h^T, B_w^T, A_h^T, A_w^T, row-major, each
// zero-padded to 8 x 8. The input is padded so that hp = n_hb*bh*mh +
// th - mh, and likewise wp; cp is a multiple of bc (8, 16, 32 or 64),
// bw a power of two; xp is 16-byte aligned.
int depthwise_streamed_launch(const float* xp, const void* u, int u_type,
                              const float* bias, int n_bias,
                              const float* scale, float* y, int n, int hp,
                              int wp, int cp, int mult, int th, int tw,
                              int mh, int mw, int bh, int bw, int bc,
                              int activation, const float* mats,
                              void* stream) {
  if (th < 2 || tw < 2 || th > kMaxT || tw > kMaxT || mh < 1 || mw < 1 ||
      mh >= th || mw >= tw || n < 1 || mult < 1 || activation < kNone ||
      activation > kGelu)
    return kErrBadShape;
  const int sh = bh * mh, sw = bw * mw;
  const int halo_h = th - mh, halo_w = tw - mw;
  if (bh < 1 || bw < 1 || hp <= halo_h || wp <= halo_w || (hp - halo_h) % sh != 0 ||
      (wp - halo_w) % sw != 0)
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
  prm.mult = mult;
  prm.th = th;
  prm.tw = tw;
  prm.mh = mh;
  prm.mw = mw;
  prm.p = th * tw;
  prm.bh = bh;
  prm.bw = bw;
  prm.bc = bc;
  prm.n_hb = (hp - halo_h) / sh;
  prm.n_wb = (wp - halo_w) / sw;
  prm.sh = sh + halo_h;
  prm.sw = sw + halo_w;
  prm.sw_magic = (unsigned)((0x100000000ull + prm.sw - 1) / prm.sw);
  while ((1 << prm.lbw) < bw) ++prm.lbw;
  const int cpt = bc == 64 ? 2 : 1;  // core/winograd.py:depthwise_cpt
  while ((1 << prm.lg) < bc / cpt) ++prm.lg;
  prm.act = activation;

  const bool exact = is_f23(mats, th, tw, mh, mw);
  const int t = th > tw ? th : tw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cpt == 2 ? launch_cpt<2>(prm, n, exact, t, s) : launch_cpt<1>(prm, n, exact, t, s);
}

const char* depthwise_streamed_error(int code) {
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
