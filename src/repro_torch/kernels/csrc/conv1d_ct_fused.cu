// Depthwise causal Cook-Toom conv1d (the Mamba short conv) over
// pre-extracted tiles, for Hopper.
//
// Replaces repro/kernels/conv1d_ct.py:conv1d_ct_fused (the Pallas TPU
// kernel). Same function on the same operands: the causal tiles
// (B, S, t, Cp) in fp32 or bf16 and the Cook-Toom-domain taps u (t, Cp) in
// fp32 or bf16 -> the output tiles (B, S, m, Cp) in the tiles' dtype. Per
// tile and channel: v = B^T d (t x t), the Hadamard product v * u[:, c],
// y = A^T v (m x t), all in fp32, then one rounding to the output dtype.
//
// What bounds it: bytes. Per output a few FLOPs (F(4, 4): 49 + 7 + 28
// multiply-adds for 4 outputs) against t/m input values read and one
// written; at (4, 512 tiles, 8192) the tiles and outputs are 0.74 GB in
// fp32, 0.22 ms at 3.35 TB/s, while the FLOPs take 0.01 ms at 67 TFLOP/s.
// The design spends nothing on reuse and all on access patterns: one
// thread per (b, s, c), neighbouring threads on neighbouring channels, so
// each of a warp's t loads and m stores is one contiguous 128-byte run;
// the whole step lives in registers (t is a template parameter).
//
// How the TPU design translates:
//  * The Pallas grid (B, S/bS, C/bC) held a (bS, t, bC) VMEM block and ran
//    the transforms as tensordots over it; here a block of 256 threads
//    covers block_s tiles x block_c channels, and each thread does its own
//    tile's t x t and m x t products in registers.
//  * The reference padded S to whole blocks; here the last block masks
//    the ragged S edge itself, so the caller pads only C (to the taps'
//    Cp, a multiple of block_c).
//  * B^T and A^T arrive from the wrapper as one host array (the 2D
//    kernels' convention) and ride in the kernel's parameter space.

#include "common.cuh"

namespace {

constexpr int kMaxT = 8;
constexpr int kThreads = 256;  // block_s tiles x block_c channels

struct Params {
  float bt[kMaxT * kMaxT];  // B^T, row-major, zero-padded to 8 x 8
  float at[kMaxT * kMaxT];  // A^T (m rows), zero-padded to 8 x 8
  const void* tiles;
  const void* u;
  void* out;
  int s, m, cp, bs, bc;
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename X, typename U, int T>
__global__ void __launch_bounds__(kThreads)
    conv1d_ct_kernel(const __grid_constant__ Params prm) {
  const int tid = threadIdx.x;
  const int c = blockIdx.y * prm.bc + tid % prm.bc;
  const int s = blockIdx.x * prm.bs + tid / prm.bc;
  if (s >= prm.s) return;  // the ragged S edge
  const size_t tile = (size_t)blockIdx.z * prm.s + s;
  const X* x = static_cast<const X*>(prm.tiles) + tile * T * prm.cp + c;
  const U* u = static_cast<const U*>(prm.u) + c;
  X* y = static_cast<X*>(prm.out) + tile * prm.m * prm.cp + c;

  float d[T];
#pragma unroll
  for (int j = 0; j < T; ++j) d[j] = widen(x[(size_t)j * prm.cp]);
  float v[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < T; ++j) acc = fmaf(prm.bt[i * kMaxT + j], d[j], acc);
    v[i] = acc * widen(u[(size_t)i * prm.cp]);
  }
#pragma unroll
  for (int o = 0; o < T - 1; ++o) {
    if (o < prm.m) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < T; ++i) acc = fmaf(prm.at[o * kMaxT + i], v[i], acc);
      store(y + (size_t)o * prm.cp, acc);
    }
  }
}

constexpr int kErrBadShape = -1;
constexpr int kErrBadBlocking = -2;
constexpr int kErrBadType = -3;

template <typename X, typename U, int T>
cudaError_t launch(const Params& prm, int b, cudaStream_t stream) {
  dim3 grid((prm.s + prm.bs - 1) / prm.bs, prm.cp / prm.bc, b);
  conv1d_ct_kernel<X, U, T><<<grid, kThreads, 0, stream>>>(prm);
  return cudaGetLastError();
}

template <typename X, typename U>
int launch_tile(const Params& prm, int b, int t, cudaStream_t stream) {
  switch (t) {
    case 3: return launch<X, U, 3>(prm, b, stream);
    case 4: return launch<X, U, 4>(prm, b, stream);
    case 5: return launch<X, U, 5>(prm, b, stream);
    case 6: return launch<X, U, 6>(prm, b, stream);
    case 7: return launch<X, U, 7>(prm, b, stream);
    case 8: return launch<X, U, 8>(prm, b, stream);
    default: return kErrBadShape;
  }
}

template <typename X>
int launch_taps(const Params& prm, int u_type, int b, int t,
                cudaStream_t stream) {
  switch (u_type) {
    case kF32: return launch_tile<X, float>(prm, b, t, stream);
    case kBF16: return launch_tile<X, __nv_bfloat16>(prm, b, t, stream);
    default: return kErrBadType;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or a negative
// validation code; conv1d_ct_fused_error names each. `mats` is a host
// array of 2 x 64 floats: B^T (t x t) and A^T (m x t), row-major, each
// zero-padded to 8 x 8. `tiles` is (b, s, t, cp), `u` (t, cp), `out`
// (b, s, m, cp); types are UType codes (fp32 or bf16).
int conv1d_ct_fused_launch(const void* tiles, int tile_type, const void* u,
                           int u_type, void* out, int b, int s, int t, int m,
                           int cp, int bs, int bc, const float* mats,
                           void* stream) {
  if (t < 3 || t > kMaxT || m < 1 || m >= t || b < 1 || s < 1 || b > 65535)
    return kErrBadShape;
  if (bs < 1 || bc < 1 || bs * bc != kThreads || cp % bc != 0)
    return kErrBadBlocking;
  Params prm{};
  for (int i = 0; i < kMaxT * kMaxT; ++i) {
    prm.bt[i] = mats[i];
    prm.at[i] = mats[kMaxT * kMaxT + i];
  }
  prm.tiles = tiles;
  prm.u = u;
  prm.out = out;
  prm.s = s;
  prm.m = m;
  prm.cp = cp;
  prm.bs = bs;
  prm.bc = bc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile_type) {
    case kF32: return launch_taps<float>(prm, u_type, b, t, st);
    case kBF16: return launch_taps<__nv_bfloat16>(prm, u_type, b, t, st);
    default: return kErrBadType;
  }
}

const char* conv1d_ct_fused_error(int code) {
  switch (code) {
    case kErrBadShape:
      return "operand shapes do not match the tile geometry";
    case kErrBadBlocking:
      return "blocking does not fit the kernel's thread layout";
    case kErrBadType:
      return "unsupported tile or tap dtype";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
