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
// What bounds it: bytes. There is no reduction and no GEMM: per output
// pixel and channel it does a few dozen FLOPs (4 phase transforms of a
// t x t tile, t = 3 or 5 on MobileNets, shared by m^2 outputs) against at
// least 4 input bytes read (each output covers a 2 x 2 input window) and 4
// bytes written, under the card's ~20 FLOP/byte fp32 balance point. The
// design therefore spends nothing on data reuse in shared memory and all
// on access patterns: one thread per (output tile, channel) with channels
// fastest, so every load and store of a warp is one contiguous NHWC run
// (32 channels = 128 bytes at the default 32-channel block); the
// overlapping halos of neighbouring tiles, which sit in the same block's
// strip, are served from L1. Each thread keeps its tile, the phase sums
// and the inverse in registers (T <= 8 per axis, a template parameter).
//
// How the TPU design translates:
//  * The Pallas kernel gathered four phase tile tensors from one VMEM halo
//    strip (phase_gather_tiles) and vectorized the transform over the
//    strip. Here each thread reads its tile's phase elements at
//    full-resolution (2*(y0 + a) + ph, 2*(x0 + b) + qh) itself.
//  * Its grid (N, nHb, nWb, C/bC) becomes blocks of (bh x bw tiles) x bC
//    channels with bh*bw*bC = 256 threads (core/winograd.py:
//    stream_geometry_depthwise); edge blocks are padded by the caller to
//    whole strips, 2x the stride-1 surplus per axis, and cropped after.

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
  int hp, wp, cp;
  int th, tw, mh, mw;
  int bh, bw, bc, n_hb, n_wb;
  int act;
};

template <typename U, int T>
__global__ void __launch_bounds__(kThreads)
    depthwise_strided_kernel(const __grid_constant__ DwParams prm) {
  const int tid = threadIdx.x;
  const int c = blockIdx.y * prm.bc + tid % prm.bc;
  const int r = tid / prm.bc;  // tile of this thread in the (bh, bw) strip
  int blk = blockIdx.x;
  const int wb = blk % prm.n_wb;
  blk /= prm.n_wb;
  const int hb = blk % prm.n_hb;
  const int img = blk / prm.n_hb;
  const int mh = prm.mh, mw = prm.mw;
  const int y0 = (hb * prm.bh + r / prm.bw) * mh;  // output = phase-grid origin
  const int x0 = (wb * prm.bw + r % prm.bw) * mw;

  float o[T][T];
  depthwise_tile<U, T, 2>(prm.tf, prm.x + (size_t)img * prm.hp * prm.wp * prm.cp + c,
                          prm.wp, prm.cp, y0, x0, static_cast<const U*>(prm.u) + c,
                          prm.cp, prm.th, prm.tw, o);

  const float sc = prm.scale != nullptr ? prm.scale[c] : 1.f;
  const float bi = (prm.bias != nullptr && c < prm.n_bias) ? prm.bias[c] : 0.f;
  const int h_out = prm.n_hb * prm.bh * mh;
  const int w_out = prm.n_wb * prm.bw * mw;
  float* dst = prm.y + (((size_t)img * h_out + y0) * w_out + x0) * prm.cp + c;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    if (i < mh) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if (j < mw) dst[((size_t)i * w_out + j) * prm.cp] = activate(o[i][j] * sc + bi, prm.act);
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
  depthwise_strided_kernel<U, T><<<grid, kThreads, 0, stream>>>(prm);
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
// validation code; depthwise_strided_streamed_error names each. `mats` is a
// host array of 4 x 64 floats: B_h^T, B_w^T, A_h^T, A_w^T, row-major, each
// zero-padded to 8 x 8. The input is padded so that hp = 2*(n_hb*bh*mh +
// th - mh), and likewise wp.
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
  prm.th = th;
  prm.tw = tw;
  prm.mh = mh;
  prm.mw = mw;
  prm.bh = bh;
  prm.bw = bw;
  prm.bc = bc;
  prm.n_hb = (hp - halo_h) / (2 * sh);
  prm.n_wb = (wp - halo_w) / (2 * sw);
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

const char* depthwise_strided_streamed_error(int code) {
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
