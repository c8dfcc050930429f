// Tiled fp32 GEMM with a fused epilogue for Hopper:
// C = act(scale * (A @ B) + bias).
//
// Replaces repro/kernels/matmul.py:matmul (the Pallas TPU kernel), the GEMM
// behind the pallas_im2col executor: on MobileNets the 1x1 pointwise conv
// after each stride-2 depthwise conv, A = (N*oh*ow, C) activations. Operands:
// A (M, K) fp32 row-major, unpadded; B (Kp, Np) in fp32, bf16 or int8,
// padded at plan time to the block grid (Kp >= K, Np >= N); an optional
// bias (at most N entries) and an optional int8 dequantization scale row
// (Np) -> C (M, N) fp32, written directly at its logical width.
//
// What bounds it: fp32 FMAs on the CUDA cores at the path's shapes (2*K
// FLOPs per output against 4*(K + N) bytes per row of A: ~20-100 FLOP/byte
// for K = 64..512), near the card's ~20 FLOP/byte balance point on the
// shallow layers. The design is the classic shared-memory SGEMM: a 64 x 64
// block tile, K swept inside the block in steps of 16 (the Pallas K grid
// axis becomes this loop, the accumulator stays in registers), each thread
// holding a 4 x 4 register tile fed by two float4 shared-memory loads per 16
// FMAs. B is widened to fp32 as it is staged. No TF32, no tensor cores yet.
//
// How the TPU design translates:
//  * Pallas needed every dimension padded to its blocks; here the ragged M
//    and K edges of A are masked in the loads (no padded copy of the
//    activations per call) and the ragged N edge in the store. B keeps its
//    plan-time padding, as ops.py:pad_im2col_filter gives it.
//  * The int8 scale multiplies in the epilogue, before the bias, as in the
//    TPU kernel's store step.

#include "common.cuh"

namespace {

// These must agree with repro_torch/kernels/ops.py (MATMUL_BLOCKS).
constexpr int kThreads = 256;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;

struct MmParams {
  const float* a;
  const void* b;
  const float* bias;
  const float* scale;
  float* c;
  int n_bias;
  int m, n, k, ldb;
  int act;
};

template <typename U>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const __grid_constant__ MmParams prm) {
  __shared__ __align__(16) float s_a[kBK][kBM];  // A tile, transposed
  __shared__ __align__(16) float s_b[kBK][kBN];
  const int tid = threadIdx.x;
  const int m_base = blockIdx.x * kBM;
  const int n_base = blockIdx.y * kBN;
  const int tx = tid % 16, ty = tid / 16;  // output columns tx*4, rows ty*4
  const U* b = static_cast<const U*>(prm.b);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // Staging slots: A row tid/4, columns (tid%4)*4..+3; B row tid/16,
  // columns (tid%16)*4..+3.
  const int a_row = tid / 4, a_col = (tid % 4) * 4;
  const int b_row = tid / 16, b_col = (tid % 16) * 4;
  const int am = m_base + a_row;
  for (int k0 = 0; k0 < prm.k; k0 += kBK) {
    __syncthreads();  // the previous step is done with s_a / s_b
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ak = k0 + a_col + j;
      s_a[a_col + j][a_row] =
          (am < prm.m && ak < prm.k) ? prm.a[(size_t)am * prm.k + ak] : 0.f;
    }
    const U* brow = b + (size_t)(k0 + b_row) * prm.ldb + n_base + b_col;
#pragma unroll
    for (int j = 0; j < 4; ++j) s_b[b_row][b_col + j] = widen(brow[j]);
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&s_a[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&s_b[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] += ar[i] * bv.x;
        acc[i][1] += ar[i] * bv.y;
        acc[i][2] += ar[i] * bv.z;
        acc[i][3] += ar[i] * bv.w;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n_base + tx * 4 + j;
    if (n >= prm.n) continue;
    const float sc = prm.scale != nullptr ? prm.scale[n] : 1.f;
    const float bi = (prm.bias != nullptr && n < prm.n_bias) ? prm.bias[n] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m_base + ty * 4 + i;
      if (m < prm.m) prm.c[(size_t)m * prm.n + n] = activate(acc[i][j] * sc + bi, prm.act);
    }
  }
}

constexpr int kErrBadShape = -1;
constexpr int kErrBadType = -3;

template <typename U>
cudaError_t launch(const MmParams& prm, cudaStream_t stream) {
  dim3 grid((prm.m + kBM - 1) / kBM, (prm.n + kBN - 1) / kBN);
  matmul_kernel<U><<<grid, kThreads, 0, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`: C (m, n) = act(scale * (A (m, k) @ B[:k, :n]) + bias).
// B is (kp, ldb) with kp a multiple of 16 at least k and ldb a multiple of
// 64 at least n. Returns 0, a CUDA error code (> 0), or a negative
// validation code; matmul_error names each.
int matmul_launch(const float* a, const void* b, int b_type, const float* bias,
                  int n_bias, const float* scale, float* c, int m, int n,
                  int k, int kp, int ldb, int activation, void* stream) {
  if (m < 1 || n < 1 || k < 1 || kp < k || kp % kBK != 0 || ldb < n ||
      ldb % kBN != 0 || activation < kNone || activation > kGelu)
    return kErrBadShape;
  MmParams prm{};
  prm.a = a;
  prm.b = b;
  prm.bias = bias;
  prm.scale = scale;
  prm.c = c;
  prm.n_bias = n_bias;
  prm.m = m;
  prm.n = n;
  prm.k = k;
  prm.ldb = ldb;
  prm.act = activation;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b_type) {
    case kF32:
      return launch<float>(prm, s);
    case kBF16:
      return launch<__nv_bfloat16>(prm, s);
    case kI8:
      return launch<int8_t>(prm, s);
    default:
      return kErrBadType;
  }
}

const char* matmul_error(int code) {
  switch (code) {
    case kErrBadShape:
      return "operand shapes do not match the kernel's block grid";
    case kErrBadType:
      return "unsupported B dtype";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
