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
// outputs, t = 4 at F(2x2, 3x3), 6 at F(4x4, 3x3)) against 4 bytes read and
// 4 written, under the card's ~20 FLOP/byte fp32 balance point. As in
// depthwise_strided_streamed.cu, the design spends nothing on reuse in
// shared memory and all on access patterns: one thread per (output tile,
// channel), channels fastest, so a warp's loads and stores are contiguous
// NHWC runs; the halos of neighbouring tiles in a block's strip are served
// from L1. The whole step stays in registers (depthwise_common.cuh; the
// tile size is a template parameter).
//
// How the TPU design translates:
//  * The Pallas kernel gathered a (bh, bw) strip of tiles from a VMEM halo
//    strip and transformed them as one tensor. Here each thread reads its
//    own tile.
//  * Its (P, bC, mult) taps broadcast the transformed tile over the
//    multiplier axis. Here the thread produces its channel's mult outputs
//    one after another, each from the per-(tile, channel) step with the
//    j-th tap set, so registers do not grow with mult (the transform is
//    recomputed per j; mult = 1 on every MobileNet layer).
//  * Its grid (N, nHb, nWb, C/bC) becomes blocks of (bh x bw tiles) x bC
//    channels with bh*bw*bC = 256 threads (core/winograd.py:
//    stream_geometry_depthwise); edge blocks are padded by the caller to
//    whole strips and cropped after.

#include "depthwise_common.cuh"

namespace {

struct DwParams {
  Transforms tf;
  const float* x;
  const void* u;
  const float* bias;
  const float* scale;
  float* y;
  int n_bias;
  int hp, wp, cp, mult;
  int th, tw, mh, mw;
  int bh, bw, bc, n_hb, n_wb;
  int act;
};

template <typename U, int T>
__global__ void __launch_bounds__(kThreads)
    depthwise_kernel(const __grid_constant__ DwParams prm) {
  const int tid = threadIdx.x;
  const int c = blockIdx.y * prm.bc + tid % prm.bc;
  const int r = tid / prm.bc;  // tile of this thread in the (bh, bw) strip
  int blk = blockIdx.x;
  const int wb = blk % prm.n_wb;
  blk /= prm.n_wb;
  const int hb = blk % prm.n_hb;
  const int img = blk / prm.n_hb;
  const int mh = prm.mh, mw = prm.mw, mult = prm.mult;
  const int y0 = (hb * prm.bh + r / prm.bw) * mh;  // output = input origin
  const int x0 = (wb * prm.bw + r % prm.bw) * mw;
  const int h_out = prm.n_hb * prm.bh * mh;
  const int w_out = prm.n_wb * prm.bw * mw;
  const int mo = prm.cp * mult;  // output channels
  const float* x = prm.x + (size_t)img * prm.hp * prm.wp * prm.cp + c;
  float* dst = prm.y + (((size_t)img * h_out + y0) * w_out + x0) * mo;

  for (int j = 0; j < mult; ++j) {
    const int oc = c * mult + j;
    float o[T][T];
    depthwise_tile<U, T, 1>(prm.tf, x, prm.wp, prm.cp, y0, x0,
                            static_cast<const U*>(prm.u) + oc, mo, prm.th,
                            prm.tw, o);
    const float sc = prm.scale != nullptr ? prm.scale[oc] : 1.f;
    const float bi = (prm.bias != nullptr && oc < prm.n_bias) ? prm.bias[oc] : 0.f;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      if (i < mh) {
#pragma unroll
        for (int jj = 0; jj < T; ++jj) {
          if (jj < mw) dst[((size_t)i * w_out + jj) * mo + oc] = activate(o[i][jj] * sc + bi, prm.act);
        }
      }
    }
  }
}

constexpr int kErrBadShape = -1;
constexpr int kErrBadBlocking = -2;
constexpr int kErrBadType = -3;

template <typename U, int T>
cudaError_t launch(const DwParams& prm, int n_img, cudaStream_t stream) {
  dim3 grid(n_img * prm.n_hb * prm.n_wb, prm.cp / prm.bc);
  depthwise_kernel<U, T><<<grid, kThreads, 0, stream>>>(prm);
  return cudaGetLastError();
}

template <typename U>
int launch_tile(const DwParams& prm, int n_img, int t, cudaStream_t stream) {
  switch (t) {
    case 2: return launch<U, 2>(prm, n_img, stream);
    case 3: return launch<U, 3>(prm, n_img, stream);
    case 4: return launch<U, 4>(prm, n_img, stream);
    case 5: return launch<U, 5>(prm, n_img, stream);
    case 6: return launch<U, 6>(prm, n_img, stream);
    case 7: return launch<U, 7>(prm, n_img, stream);
    case 8: return launch<U, 8>(prm, n_img, stream);
    default: return kErrBadShape;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or a negative
// validation code; depthwise_streamed_error names each. `mats` is a host
// array of 4 x 64 floats: B_h^T, B_w^T, A_h^T, A_w^T, row-major, each
// zero-padded to 8 x 8. The input is padded so that hp = n_hb*bh*mh +
// th - mh, and likewise wp.
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
  if (bc < 1 || bh * bw * bc != kThreads || cp % bc != 0) return kErrBadBlocking;

  DwParams prm{};
  fill_transforms(prm.tf, mats);
  prm.x = xp;
  prm.u = u;
  prm.bias = bias;
  prm.scale = scale;
  prm.y = y;
  prm.n_bias = n_bias;
  prm.hp = hp;
  prm.wp = wp;
  prm.cp = cp;
  prm.mult = mult;
  prm.th = th;
  prm.tw = tw;
  prm.mh = mh;
  prm.mw = mw;
  prm.bh = bh;
  prm.bw = bw;
  prm.bc = bc;
  prm.n_hb = (hp - halo_h) / sh;
  prm.n_wb = (wp - halo_w) / sw;
  prm.act = activation;

  const int t = th > tw ? th : tw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (u_type) {
    case kF32:
      return launch_tile<float>(prm, n, t, s);
    case kBF16:
      return launch_tile<__nv_bfloat16>(prm, n, t, s);
    case kI8:
      return launch_tile<int8_t>(prm, n, t, s);
    default:
      return kErrBadType;
  }
}

const char* depthwise_streamed_error(int code) {
  switch (code) {
    case kErrBadShape:
      return "operand shapes do not match the tile geometry";
    case kErrBadBlocking:
      return "blocking does not fit the kernel's thread layout";
    case kErrBadType:
      return "unsupported filter dtype";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
