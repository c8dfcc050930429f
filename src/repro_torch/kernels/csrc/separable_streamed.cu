// Fused separable block for Hopper: depthwise k x k Winograd / Cook-Toom ->
// bias + activation -> pointwise 1x1 GEMM on the tensor cores (TF32x3) ->
// bias + activation, in one kernel.
//
// Replaces repro/kernels/depthwise.py:separable_streamed (the Pallas TPU
// kernel). Same function on the same operands: the padded NHWC fp32 input
// xp (N, Hp, Wp, Cp), the Winograd-domain depthwise taps u_dw (P, Cp), the
// pointwise matrix u_pw (Cp, Mp), optional biases (at most Cp and Mp
// entries) -> the NHWC output (N, nHb*bh*mh, nWb*bw*mw, Mp). fp32 only, no
// scale operand, as the TPU kernel. The depthwise output z never goes to
// device memory: that round trip (write, then a re-read per pointwise
// block, then separate epilogue passes) is what the unfused pair pays.
//
// What bounds it: bytes on the early, wide-strip blocks (MBv2's ir1: C =
// 32, M = 16) and the pointwise GEMM's operations on the deep ones (2*C*M
// FLOPs per pixel), with the depthwise stage beside them: it is recomputed
// once per M block, since parallel M blocks cannot share it. Measured on
// an H100 (PERF.md), the time follows the number of C steps (a fixed cost
// of instruction issue and barriers per step) more than the M/bM
// depthwise passes. The design:
//  * covers bM >= min(M, 64) output channels per block, and the whole of M
//    where M <= 128, so the depthwise stage runs at most twice per (strip,
//    channel) there; it fills the card with smaller strips (S = 16..64
//    pixels) instead of narrower M blocks, and takes C steps of up to 128
//    channels (core/winograd.py:separable_geometry);
//  * runs the (S, bC) x (bC, bM) pointwise GEMM on mma.sync m16n8k8 in
//    TF32x3 (mma_tf32x3.cuh), warps over (16-pixel, 8-channel) output
//    tiles with fp32 accumulators in registers; the depthwise thread that
//    writes a z value also splits it into its TF32 halves, once, since
//    every warp on that pixel row reads it;
//  * stages, per C step, the strip (with its halo), the (P, bC) taps and
//    the (bC, bM) pointwise chunk by cp.async into a second stage while
//    the current step's depthwise and GEMM run: the depthwise reads shared
//    memory, not device memory;
//  * keeps the per-step instruction count down: index arithmetic by
//    shifts and __umulhi, a guard-free depthwise step for 3 x 3 filters
//    (kExact) that computes only the m x m outputs of the inverse;
//  * sums C in a fixed order (no atomics).
//
// How the TPU design translates: the Pallas grid ran (M blocks, C blocks)
// sequentially per strip and cached the depthwise output across the M
// sweep (its z-cache); parallel M blocks cannot share it, so the design
// trades strip size for M width to keep the recompute small. The
// depthwise step is depthwise_common.cuh's, over the staged strip; edge
// strips are padded by the caller and cropped after, as the reference
// does.

#include "depthwise_common.cuh"
#include "mma_tf32x3.cuh"

namespace {

constexpr size_t kSmemMax = 227 * 1024;

struct SepParams {
  Transforms tf;
  const float* x;
  const float* u_dw;
  const float* u_pw;
  const float* bias_dw;
  const float* bias_pw;
  float* y;
  int n_bias_dw, n_bias_pw;
  int hp, wp, cp, mp;
  int th, tw, mh, mw, p;
  int bh, bw, bc, bm, n_hb, n_wb;
  int sh, sw;        // strip extent, pixels: bh*mh + th - mh, bw*mw + tw - mw
  unsigned sw_magic, qm_magic;  // ceil(2^32 / sw), ceil(2^32 / (bm / 4))
  int lbc, lbw;      // log2 of bc and bw (both powers of two)
  int ldc;           // floats between two strip pixels / z rows: bc + 4
  int ldw;           // floats between two rows of the pointwise chunk
  int strip_floats, taps_floats, w_floats, z_words;  // one stage of each
  int inner_act, act;
};

// kExact: th == tw == T and mh == mw == T - 2, so the depthwise step and
// the z stores run without guards.
template <int T, int kPairs, bool kExact>
__global__ void __launch_bounds__(kThreads, (T <= 6 && kPairs <= 4) ? 2 : 1)
    separable_kernel(const __grid_constant__ SepParams prm) {
  extern __shared__ __align__(16) float smem[];
  const int bc = prm.bc, bm = prm.bm;
  const int mh = kExact ? T - 2 : prm.mh, mw = kExact ? T - 2 : prm.mw;
  const int ldc = prm.ldc, ldw = prm.ldw;
  const int so_w = prm.bw * mw;             // output pixels per strip row
  const int S = prm.bh * mh * so_w;         // output pixels of this strip
  const int n_nt = bm / 8, pairs = (S / 16) * n_nt;
  float* s_strip = smem;                                   // 2 x (sh, sw, ldc)
  float* s_taps = s_strip + 2 * prm.strip_floats;          // 2 x (P, bc)
  float* s_w = s_taps + 2 * prm.taps_floats;               // 2 x (bc, ldw)
  uint32_t* z_hi = reinterpret_cast<uint32_t*>(s_w + 2 * prm.w_floats);  // (S, ldc)
  uint32_t* z_lo = z_hi + prm.z_words;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int blk = blockIdx.x;
  const int wb = blk % prm.n_wb;
  blk /= prm.n_wb;
  const int hb = blk % prm.n_hb;
  const int img = blk / prm.n_hb;
  const int m_base = blockIdx.y * bm;
  const int row0 = hb * prm.bh * mh;
  const int col0 = wb * so_w;
  const float* x_img = prm.x + (size_t)img * prm.hp * prm.wp * prm.cp;

  // cp.async the strip, the taps and the pointwise chunk of channels
  // [c0, c0 + bc) into stage `buf`, as one commit group.
  // (Index arithmetic by shifts and __umulhi: a runtime division costs ~20
  // instructions, and these loops run every C step.)
  auto stage = [&](int c0, int buf) {
    const int lq4 = prm.lbc - 2, q4 = 1 << lq4;
    float* ds = s_strip + buf * prm.strip_floats;
    for (int i = tid; i < (prm.sh * prm.sw) << lq4; i += kThreads) {
      const int q = i & (q4 - 1), pix = i >> lq4;
      const int yy = __umulhi(pix, prm.sw_magic), xx = pix - yy * prm.sw;
      cp_async16(ds + pix * ldc + 4 * q,
                 x_img + ((size_t)(row0 + yy) * prm.wp + col0 + xx) * prm.cp + c0 + 4 * q);
    }
    float* dt = s_taps + buf * prm.taps_floats;
    for (int i = tid; i < prm.p << lq4; i += kThreads) {
      const int q = i & (q4 - 1), p = i >> lq4;
      cp_async16(dt + p * bc + 4 * q, prm.u_dw + (size_t)p * prm.cp + c0 + 4 * q);
    }
    float* dw = s_w + buf * prm.w_floats;
    const int qm = bm / 4;
    for (int i = tid; i < bc * qm; i += kThreads) {
      const int c = __umulhi(i, prm.qm_magic), q = i - c * qm;
      cp_async16(dw + c * ldw + 4 * q, prm.u_pw + (size_t)(c0 + c) * prm.mp + m_base + 4 * q);
    }
    cp_async_commit();
  };

  float acc[kPairs][4];
#pragma unroll
  for (int i = 0; i < kPairs; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int n_steps = prm.cp / bc;
  stage(0, 0);
  for (int s = 0; s < n_steps; ++s) {
    const int buf = s & 1, c0 = s * bc;
    cp_async_wait_all();
    __syncthreads();  // stage s has landed; step s-1's GEMM is done with z
    if (s + 1 < n_steps) stage(c0 + bc, buf ^ 1);

    // Depthwise stage: one (tile, channel) per thread, channels fastest,
    // from the staged strip and taps; + bias, inner activation, split into
    // the TF32 halves of z (S, bc).
    const float* strip = s_strip + buf * prm.strip_floats;
    const float* taps = s_taps + buf * prm.taps_floats;
    for (int i = tid; i < (prm.bh * prm.bw) << prm.lbc; i += kThreads) {
      const int c = i & (bc - 1), r = i >> prm.lbc;
      const int ty = r >> prm.lbw, tx = r & (prm.bw - 1);
      float o[T][T];
      depthwise_tile<T, kExact>(prm.tf, strip + c, prm.sw, ldc, ty * mh, tx * mw,
                                          taps + c, bc, prm.th, prm.tw, o);
      const int cg = c0 + c;
      const float bi = (prm.bias_dw != nullptr && cg < prm.n_bias_dw) ? prm.bias_dw[cg] : 0.f;
#pragma unroll
      for (int a = 0; a < T; ++a) {
        if (a < mh) {
#pragma unroll
          for (int b = 0; b < T; ++b) {
            if (b < mw) {
              const int px = ((ty * mh + a) * so_w + tx * mw + b) * ldc + c;
              split_tf32(activate(o[a][b] + bi, prm.inner_act), z_hi[px], z_lo[px]);
            }
          }
        }
      }
    }
    __syncthreads();  // z is complete

    // Pointwise GEMM z (S x bc) x W (bc x bM): warp w owns the output tiles
    // (16 pixels x 8 channels) w*kPairs .. w*kPairs + kPairs - 1. Each C
    // step sums into a zeroed fragment that joins the accumulator with an
    // fp32 add: the tensor cores round their sums toward zero, and this
    // keeps that biased rounding within one step (mma_tf32x3.cuh).
    const float* w = s_w + buf * prm.w_floats + (lane & 3) * ldw + (lane >> 2);
    const int a_off = (lane >> 2) * ldc + (lane & 3);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int g = warp * kPairs + i;
      if (g < pairs) {
        const int mt = g / n_nt, nt = g - mt * n_nt;
        const int ao = a_off + mt * 16 * ldc;
        float part[4] = {};
        for (int k0 = 0; k0 < bc; k0 += 8) {
          FragA a;
          load_a_split(a, z_hi + ao + k0, z_lo + ao + k0, ldc);
          FragB b;
          load_b<true>(b, w + k0 * ldw + nt * 8, ldw);
          mma_tf32x3<true>(part, a, b);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += part[e];
      }
    }
  }

  // Epilogue from the fragments: + bias, activation, NHWC store.
  const int h_out = prm.n_hb * prm.bh * mh;
  const int w_out = prm.n_wb * so_w;
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int g = warp * kPairs + i;
    if (g < pairs) {
      const int mt = g / n_nt, nt = g % n_nt;
      const int mg = m_base + nt * 8 + 2 * t;
      const float b0 = (prm.bias_pw != nullptr && mg < prm.n_bias_pw) ? prm.bias_pw[mg] : 0.f;
      const float b1 =
          (prm.bias_pw != nullptr && mg + 1 < prm.n_bias_pw) ? prm.bias_pw[mg + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = mt * 16 + gq + 8 * h;
        const int oy = row0 + s / so_w, ox = col0 + s % so_w;
        float* dst = prm.y + (((size_t)img * h_out + oy) * w_out + ox) * prm.mp + mg;
        *reinterpret_cast<float2*>(dst) =
            make_float2(activate(acc[i][2 * h] + b0, prm.act),
                        activate(acc[i][2 * h + 1] + b1, prm.act));
      }
    }
  }
}

constexpr int kErrBadShape = -1;
constexpr int kErrBadBlocking = -2;
constexpr int kErrBadAlign = -4;

// Floats between two rows of the staged pointwise chunk: bm + 8 or bm + 24
// (a row is then 32 or 96 bytes mod 128, so a B fragment's four k rows
// fall on distinct banks). Must agree with core/winograd.py.
inline int w_row_floats(int bm) { return bm % 16 == 8 ? bm : bm + 8; }

template <int T, int kPairs>
int launch(const SepParams& prm, int n_img, size_t smem, cudaStream_t stream) {
  const bool exact = prm.th == T && prm.tw == T && prm.mh == T - 2 && prm.mw == T - 2;
  auto kernel = exact ? separable_kernel<T, kPairs, true> : separable_kernel<T, kPairs, false>;
  // Raise the shared-memory cap only when a launch needs more than granted
  // so far (a warm launch is then capturable in a CUDA graph).
  static size_t granted[2] = {0, 0};
  if (smem > granted[exact]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted[exact] = smem;
  }
  dim3 grid(n_img * prm.n_hb * prm.n_wb, prm.mp / prm.bm);
  kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <int T>
int dispatch(const SepParams& prm, int n_img, int pairs, size_t smem, cudaStream_t s) {
  // The menu: must agree with core/winograd.py:SEPARABLE_PAIRS.
  if (pairs <= 8) return launch<T, 1>(prm, n_img, smem, s);
  if (pairs <= 16) return launch<T, 2>(prm, n_img, smem, s);
  if (pairs <= 32) return launch<T, 4>(prm, n_img, smem, s);
  if (pairs <= 64) return launch<T, 8>(prm, n_img, smem, s);
  if (pairs <= 128) return launch<T, 16>(prm, n_img, smem, s);
  return kErrBadBlocking;
}

}  // namespace

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or a negative
// validation code; separable_streamed_error names each. `mats` is a host
// array of 4 x 64 floats: B_h^T, B_w^T, A_h^T, A_w^T, row-major, each
// zero-padded to 8 x 8. The input is padded so that hp = n_hb*bh*mh + th -
// mh, and likewise wp; cp is a multiple of bc in {8, 16, 32, 64, 128}, mp of
// bm (a multiple of 8); xp, u_dw and u_pw are 16-byte aligned.
int separable_streamed_launch(const float* xp, const float* u_dw,
                              const float* u_pw, const float* bias_dw,
                              int n_bias_dw, const float* bias_pw,
                              int n_bias_pw, float* y, int n, int hp, int wp,
                              int cp, int mp, int th, int tw, int mh, int mw,
                              int bh, int bw, int bc, int bm,
                              int inner_activation, int activation,
                              const float* mats, void* stream) {
  if (th < 2 || tw < 2 || th > kMaxT || tw > kMaxT || mh < 1 || mw < 1 ||
      mh >= th || mw >= tw || n < 1 || activation < kNone || activation > kGelu ||
      inner_activation < kNone || inner_activation > kGelu)
    return kErrBadShape;
  const int sh = bh * mh, sw = bw * mw;
  if (bh < 1 || bw < 1 || hp <= th - mh || wp <= tw - mw ||
      (hp - (th - mh)) % sh != 0 || (wp - (tw - mw)) % sw != 0)
    return kErrBadShape;
  const int S = sh * sw;
  if (bc < 8 || bc > 128 || (bc & (bc - 1)) != 0 || cp < bc || cp % bc != 0 ||
      bm < 8 || bm % 8 != 0 || mp % bm != 0 || S % 16 != 0 || (bw & (bw - 1)) != 0)
    return kErrBadBlocking;
  const int pairs = (S / 16) * (bm / 8);
  if (reinterpret_cast<uintptr_t>(xp) % 16 != 0 || reinterpret_cast<uintptr_t>(u_dw) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(u_pw) % 16 != 0)
    return kErrBadAlign;

  SepParams prm{};
  fill_transforms(prm.tf, mats);
  prm.x = xp;
  prm.u_dw = u_dw;
  prm.u_pw = u_pw;
  prm.bias_dw = bias_dw;
  prm.bias_pw = bias_pw;
  prm.y = y;
  prm.n_bias_dw = n_bias_dw;
  prm.n_bias_pw = n_bias_pw;
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
  prm.bm = bm;
  prm.n_hb = (hp - (th - mh)) / sh;
  prm.n_wb = (wp - (tw - mw)) / sw;
  prm.sh = sh + th - mh;
  prm.sw = sw + tw - mw;
  prm.sw_magic = (unsigned)((0x100000000ull + prm.sw - 1) / prm.sw);
  prm.qm_magic = (unsigned)((0x100000000ull + bm / 4 - 1) / (bm / 4));
  while ((1 << prm.lbc) < bc) ++prm.lbc;
  while ((1 << prm.lbw) < bw) ++prm.lbw;
  prm.ldc = bc + 4;
  prm.ldw = w_row_floats(bm);
  prm.strip_floats = prm.sh * prm.sw * prm.ldc;
  prm.taps_floats = prm.p * bc;
  prm.w_floats = bc * prm.ldw;
  prm.z_words = S * prm.ldc;
  prm.inner_act = inner_activation;
  prm.act = activation;
  // Must agree with core/winograd.py:separable_smem_bytes.
  const size_t smem = 4 * (2 * (size_t)(prm.strip_floats + prm.taps_floats + prm.w_floats) +
                           2 * (size_t)prm.z_words);
  if (smem > kSmemMax) return kErrBadBlocking;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tmax = th > tw ? th : tw;
  if (tmax <= 4) return dispatch<4>(prm, n, pairs, smem, s);
  if (tmax <= 6) return dispatch<6>(prm, n, pairs, smem, s);
  return dispatch<8>(prm, n, pairs, smem, s);
}

const char* separable_streamed_error(int code) {
  switch (code) {
    case kErrBadShape:
      return "operand shapes do not match the tile geometry";
    case kErrBadBlocking:
      return "blocking does not fit the kernel's thread layout or shared memory";
    case kErrBadAlign:
      return "xp, u_dw and u_pw must be 16-byte aligned";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
