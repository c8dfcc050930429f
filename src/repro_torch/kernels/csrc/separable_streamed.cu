// Fused separable block for Hopper: depthwise k x k Winograd / Cook-Toom ->
// bias + activation -> pointwise 1x1 GEMM -> bias + activation, in one
// kernel.
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
// What bounds it: the pointwise GEMM's fp32 FMAs on most MobileNet blocks
// (2*C*M FLOPs per pixel against 4*(C + M) bytes in and out: ~100 FLOP/byte
// at C = M = 512, above the card's ~20 FLOP/byte balance point), bytes on
// the narrow early blocks (MBv2's ir1: C = 32, M = 16). The design runs the
// GEMM from shared memory into register accumulators, 4 pixels x 4
// channels per thread, fed by 8 float4 loads per 64 FMAs.
//
// How the TPU design translates:
//  * The Pallas grid ran (M blocks, C blocks) sequentially per strip and
//    cached the post-epilogue depthwise output across the M sweep (its
//    z-cache). Parallel M blocks cannot share it, so each block recomputes
//    the depthwise stage of its strip for each C step, into shared memory,
//    and sweeps all of C itself with the accumulators in registers. The
//    recompute costs O(t^2 (t + m) / m^2) FLOPs per pixel and channel for
//    every bM output channels, against 2 * bM of GEMM.
//  * The depthwise stage runs one thread per (tile, channel), channels
//    fastest, so its loads are contiguous NHWC runs (depthwise_common.cuh);
//    z is stored pixel-major, (S, bC), so those stores are conflict-free
//    and the GEMM reads 4 channels of a pixel as one float4.
//  * Blocking (core/winograd.py:separable_geometry) is budgeted to the
//    thread layout (S * bM / 16 <= 256) and shared memory (z plus the
//    (bC, bM) filter chunk); edge strips are padded by the caller and
//    cropped after, as the reference does.

#include "depthwise_common.cuh"

namespace {

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
  int th, tw, mh, mw;
  int bh, bw, bc, bm, n_hb, n_wb;
  int inner_act, act;
};

template <int T>
__global__ void __launch_bounds__(kThreads, T <= 6 ? 2 : 1)
    separable_kernel(const __grid_constant__ SepParams prm) {
  extern __shared__ __align__(16) float smem[];
  const int bc = prm.bc, bm = prm.bm, mh = prm.mh, mw = prm.mw;
  const int sw = prm.bw * mw;
  const int S = prm.bh * mh * sw;  // pixels of this block's strip
  float* s_z = smem;               // (S, bC) depthwise output, post-epilogue
  float* s_u = smem + S * bc;      // (bC, bM) pointwise filter chunk

  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const int wb = blk % prm.n_wb;
  blk /= prm.n_wb;
  const int hb = blk % prm.n_hb;
  const int img = blk / prm.n_hb;
  const int m_base = blockIdx.y * bm;
  const int row0 = hb * prm.bh * mh;
  const int col0 = wb * sw;

  // GEMM slot of this thread: 4 pixels x 4 output channels.
  const int mq = bm / 4;
  const int m0 = (tid % mq) * 4;
  const int s0 = (tid / mq) * 4;
  const bool gemm = s0 < S;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const float* x_img = prm.x + (size_t)img * prm.hp * prm.wp * prm.cp;
  for (int c0 = 0; c0 < prm.cp; c0 += bc) {
    __syncthreads();  // the previous step's GEMM is done with s_z / s_u

    // Stage the pointwise filter chunk (m fastest: coalesced).
    for (int i = tid; i < bc * bm; i += kThreads) {
      const int m = i % bm;
      const int c = i / bm;
      s_u[i] = prm.u_pw[(size_t)(c0 + c) * prm.mp + m_base + m];
    }

    // Depthwise stage: one (tile, channel) per thread, channels fastest.
    for (int i = tid; i < prm.bh * prm.bw * bc; i += kThreads) {
      const int c = i % bc;
      const int r = i / bc;
      const int ty = r / prm.bw, tx = r % prm.bw;
      float o[T][T];
      depthwise_tile<float, T, 1>(prm.tf, x_img + c0 + c, prm.wp, prm.cp,
                                  row0 + ty * mh, col0 + tx * mw,
                                  prm.u_dw + c0 + c, prm.cp, prm.th, prm.tw, o);
      const int cg = c0 + c;
      const float bi = (prm.bias_dw != nullptr && cg < prm.n_bias_dw) ? prm.bias_dw[cg] : 0.f;
#pragma unroll
      for (int a = 0; a < T; ++a) {
        if (a < mh) {
#pragma unroll
          for (int b = 0; b < T; ++b) {
            if (b < mw)
              s_z[((ty * mh + a) * sw + tx * mw + b) * bc + c] =
                  activate(o[a][b] + bi, prm.inner_act);
          }
        }
      }
    }
    __syncthreads();

    // Pointwise GEMM (S, bC) x (bC, bM), fp32 FMA into registers.
    if (gemm) {
      for (int c = 0; c < bc; c += 4) {
        float4 z[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          z[i] = *reinterpret_cast<const float4*>(s_z + (s0 + i) * bc + c);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = *reinterpret_cast<const float4*>(s_u + (c + k) * bm + m0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float zk[4] = {z[i].x, z[i].y, z[i].z, z[i].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[i][0] += zk[k] * w[k].x;
            acc[i][1] += zk[k] * w[k].y;
            acc[i][2] += zk[k] * w[k].z;
            acc[i][3] += zk[k] * w[k].w;
          }
        }
      }
    }
  }

  if (!gemm) return;
  const int h_out = prm.n_hb * prm.bh * mh;
  const int w_out = prm.n_wb * sw;
  float bi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int mg = m_base + m0 + j;
    bi[j] = (prm.bias_pw != nullptr && mg < prm.n_bias_pw) ? prm.bias_pw[mg] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + i;
    const int oy = row0 + s / sw, ox = col0 + s % sw;
    float* dst = prm.y + (((size_t)img * h_out + oy) * w_out + ox) * prm.mp + m_base + m0;
    *reinterpret_cast<float4*>(dst) = make_float4(
        activate(acc[i][0] + bi[0], prm.act), activate(acc[i][1] + bi[1], prm.act),
        activate(acc[i][2] + bi[2], prm.act), activate(acc[i][3] + bi[3], prm.act));
  }
}

constexpr int kErrBadShape = -1;
constexpr int kErrBadBlocking = -2;

template <int T>
cudaError_t launch(const SepParams& prm, int n_img, size_t smem, cudaStream_t stream) {
  auto kernel = separable_kernel<T>;
  // Raise the shared-memory cap only when a launch needs more than granted
  // so far (see winograd_common.cuh).
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

}  // namespace

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or a negative
// validation code; separable_streamed_error names each. `mats` is a host
// array of 4 x 64 floats: B_h^T, B_w^T, A_h^T, A_w^T, row-major, each
// zero-padded to 8 x 8. The input is padded so that hp = n_hb*bh*mh + th -
// mh, and likewise wp.
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
  if (bc < 4 || bc % 4 != 0 || cp % bc != 0 || bm < 4 || bm % 4 != 0 ||
      mp % bm != 0 || S % 4 != 0 || (S / 4) * (bm / 4) > kThreads)
    return kErrBadBlocking;
  const size_t smem = sizeof(float) * (size_t)bc * (S + bm);
  if (smem > 227 * 1024) return kErrBadBlocking;

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
  prm.bh = bh;
  prm.bw = bw;
  prm.bc = bc;
  prm.bm = bm;
  prm.n_hb = (hp - (th - mh)) / sh;
  prm.n_wb = (wp - (tw - mw)) / sw;
  prm.inner_act = inner_activation;
  prm.act = activation;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (th > tw ? th : tw) {
    case 2: return launch<2>(prm, n, smem, s);
    case 3: return launch<3>(prm, n, smem, s);
    case 4: return launch<4>(prm, n, smem, s);
    case 5: return launch<5>(prm, n, smem, s);
    case 6: return launch<6>(prm, n, smem, s);
    case 7: return launch<7>(prm, n, smem, s);
    case 8: return launch<8>(prm, n, smem, s);
    default: return kErrBadShape;
  }
}

const char* separable_streamed_error(int code) {
  switch (code) {
    case kErrBadShape:
      return "operand shapes do not match the tile geometry";
    case kErrBadBlocking:
      return "blocking does not fit the kernel's thread layout or shared memory";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
