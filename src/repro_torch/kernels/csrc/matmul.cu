// Tiled GEMM with a fused epilogue for Hopper, on the tensor cores in
// TF32x3: C = act(scale * (A @ B) + bias).
//
// Replaces repro/kernels/matmul.py:matmul (the Pallas TPU kernel), the GEMM
// behind the pallas_im2col executor: on MobileNets the 1x1 pointwise convs
// after each stride-2 depthwise conv (and, under a bf16 / int8
// compute_dtype, after every depthwise conv), A = (N*oh*ow, C)
// activations. Operands: A (M, K) fp32 row-major, unpadded; B (Kp, Np) in
// fp32, bf16 or int8, padded at plan time (core/im2col.py:matmul_b_shape:
// Kp = K rounded up to kBK, Np = N rounded up to the block's columns); an
// optional bias (at most N entries) and an optional int8 dequantization
// scale row (Np) -> C (M, N) fp32, written at its logical width.
//
// What bounds it: on the shallow layers (K = 32..144 against M up to
// 50176) bytes: A read once and C written once move ~4 (K + N) bytes per
// row for 2 K N operations. On the deep ones (M = 196, K and N up to
// 1024) the products, and the few blocks a 196-row grid gives. The design:
//  * the products run on mma.sync m16n8k8 in TF32x3 (mma_tf32x3.cuh):
//    three products per multiply-add for an fp32 B, two for a B widened
//    from bf16 or int8 (exact in TF32), at up to 165 TFLOP/s;
//  * A and B are staged per K step of kBK = 32 by cp.async, kStages = 3
//    deep, so two steps' loads run under one step's products (a fourth
//    stage gained nothing in the sweep). A's rows are
//    16-byte aligned only when K % 4 == 0 (and A's base is): then 16-byte
//    copies, else 4-byte ones; both zero-fill past the M and K edges, so
//    no guard reaches the products. B is copied raw and widened as its
//    fragment is read from shared memory;
//  * each K step's products go into a zeroed fragment that joins the
//    running sum with an fp32 add: the tensor cores round their sums toward
//    zero, and this keeps that rounding to 32 terms (mma_tf32x3.cuh);
//  * a menu of block tiles (rows x columns, 128 or 256 threads): 128 x 64
//    for the long shallow layers, narrow 16- and 32-column tiles for
//    MobileNet-v2's N of 16..32, 32-row tiles so that M = 196 gives 7
//    row blocks. core/im2col.py:matmul_blocks picks one at plan time;
//  * split-K for the deep layers whose grid is small (MobileNet-v2 ir14:
//    (196, 576, 160) makes 35 blocks of 32 x 32): grid z splits the K
//    steps, each split writes its raw partial sums to a workspace the
//    wrapper allocates, and a second kernel adds the splits in order z =
//    0, 1, ... and applies the epilogue. No float atomics: two runs give
//    equal bits;
//  * the epilogue (x scale, + bias, activation, in that order, as the TPU
//    kernel's store step) runs on the accumulator fragments and stores
//    two adjacent columns per lane as one float2, masked at the M and N
//    edges.
//
// How the TPU design translates: the Pallas grid's sequential K axis
// becomes the pipelined loop inside each block (the accumulator stays in
// registers); its padding of every dimension to whole blocks becomes
// zero-filled copies at A's ragged M and K edges and the masked store at
// C's, so the activations are never copied into a padded buffer. Blocks
// sum K in one fixed order: two runs give equal bits.

#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace {

// These must agree with repro_torch/core/im2col.py (MATMUL_BK,
// MATMUL_TILES).
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kLdA = kBK + 4;  // floats between two rows of a staged A tile

struct MmParams {
  const float* a;
  const void* b;
  const float* bias;
  const float* scale;
  float* c;
  int n_bias;
  int m, n, k, ldb;
  int vec_a;  // A's rows are 16-byte aligned
  int act;
  int splits, steps;  // K splits (grid z), K steps per split
  float* work;        // (splits, m, n) partial sums when splits > 1
};

// A block of kBM x kBN outputs, kWM x kWN warps, each warp kMT x kNT
// fragments of 16 x 8.
template <typename U, int kBM, int kBN, int kWM, int kWN>
struct Tile {
  static constexpr int kThreads = 32 * kWM * kWN;
  static constexpr int kMT = kBM / (16 * kWM), kNT = kBN / (8 * kWN);
  static constexpr bool kBLo = sizeof(U) == 4;  // fp32 B: split it too
  static constexpr int kLdB = u_row_bytes(kBN, sizeof(U)) / sizeof(U);
  static constexpr int kStageA = kBM * kLdA;  // floats
  static constexpr int kStageB = kBK * kLdB;  // elements of U
  static constexpr size_t kSmem = kStages * (4 * (size_t)kStageA + sizeof(U) * (size_t)kStageB);
  static_assert(kMT * 16 * kWM == kBM && kNT * 8 * kWN == kBN, "tile");
  static_assert(kBN * sizeof(U) % 16 == 0, "B rows in 16-byte copies");
};

template <typename U, int kBM, int kBN, int kWM, int kWN>
__global__ void __launch_bounds__(32 * kWM * kWN)
    matmul_kernel(const __grid_constant__ MmParams prm) {
  using T = Tile<U, kBM, kBN, kWM, kWN>;
  constexpr int kMT = T::kMT, kNT = T::kNT, kLdB = T::kLdB;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem);               // kStages x (kBM, kLdA)
  U* s_b = reinterpret_cast<U*>(s_a + kStages * T::kStageA);  // kStages x (kBK, kLdB)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / kWN, wn = warp % kWN;
  const int m_base = blockIdx.x * kBM, n_base = blockIdx.y * kBN;
  const U* b = static_cast<const U*>(prm.b);

  // cp.async K step kt of A and B into stage `buf`, as one commit group.
  auto stage = [&](int kt, int buf) {
    const int k0 = kt * kBK;
    float* da = s_a + buf * T::kStageA;
    if (prm.vec_a) {
      constexpr int kQ = kBK / 4;  // 16-byte pieces per row
      for (int i = tid; i < kBM * kQ; i += T::kThreads) {
        const int r = i / kQ, q = i % kQ;
        const int m = m_base + r, k = k0 + 4 * q;
        const bool ok = m < prm.m && k < prm.k;  // K % 4 == 0: the piece is whole
        cp_async16_zfill(da + r * kLdA + 4 * q,
                         ok ? prm.a + (size_t)m * prm.k + k : prm.a, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kBM * kBK; i += T::kThreads) {
        const int r = i / kBK, kk = i % kBK;
        const int m = m_base + r, k = k0 + kk;
        const bool ok = m < prm.m && k < prm.k;
        cp_async4_zfill(da + r * kLdA + kk, ok ? prm.a + (size_t)m * prm.k + k : prm.a,
                        ok ? 4 : 0);
      }
    }
    U* db = s_b + buf * T::kStageB;
    constexpr int kPer = 16 / sizeof(U), kQ = kBN / kPer;
    for (int i = tid; i < kBK * kQ; i += T::kThreads) {
      const int r = i / kQ, q = i % kQ;
      cp_async16(db + r * kLdB + kPer * q, b + (size_t)(k0 + r) * prm.ldb + n_base + kPer * q);
    }
    cp_async_commit();
  };

  // This block's K steps: [kt0, kt0 + n_k) of split blockIdx.z.
  const int kt0 = blockIdx.z * prm.steps;
  const int n_all = (prm.k + kBK - 1) / kBK;
  const int n_k = min(prm.steps, n_all - kt0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k)
      stage(kt0 + s, s);
    else
      cp_async_commit();  // an empty group keeps the wait counts uniform
  }

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // The lane's element of its first fragment in stage 0.
  const float* a_lane = s_a + (wm * kMT * 16 + (lane >> 2)) * kLdA + (lane & 3);
  const U* b_lane = s_b + (lane & 3) * kLdB + wn * kNT * 8 + (lane >> 2);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step kt has landed; every warp is done with step kt-1's stage
    if (kt + kStages - 1 < n_k)
      stage(kt0 + kt + kStages - 1, (kt + kStages - 1) % kStages);
    else
      cp_async_commit();
    const int buf = kt % kStages;
    const float* as = a_lane + buf * T::kStageA;
    const U* bs = b_lane + buf * T::kStageB;
    float part[kMT][kNT][4] = {};
#pragma unroll
    for (int k8 = 0; k8 < kBK; k8 += 8) {
      FragA fa[kMT];
      FragB fb[kNT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) load_a(fa[i], as + i * 16 * kLdA + k8, kLdA);
#pragma unroll
      for (int j = 0; j < kNT; ++j) load_b<T::kBLo>(fb[j], bs + k8 * kLdB + j * 8, kLdB);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32x3<T::kBLo>(part[i][j], fa[i], fb[j]);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait_all();  // no copy may land after the block exits

  // Epilogue from the C fragments: c0/c1 at (g, 2t), (g, 2t + 1), c2/c3
  // eight rows below. A split stores its raw partial sums instead.
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (prm.n & 1) == 0;  // float2 stores stay 8-byte aligned
  const bool raw = prm.splits > 1;
  float* out = raw ? prm.work + (size_t)blockIdx.z * prm.m * prm.n : prm.c;
  const int act = raw ? kNone : prm.act;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = n_base + (wn * kNT + j) * 8 + 2 * t;
    if (n >= prm.n) continue;
    const bool two = n + 1 < prm.n;
    float sc[2] = {1.f, 1.f}, bi[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (raw || (e == 1 && !two)) break;
      if (prm.scale != nullptr) sc[e] = prm.scale[n + e];
      if (prm.bias != nullptr && n + e < prm.n_bias) bi[e] = prm.bias[n + e];
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m_base + (wm * kMT + i) * 16 + g + 8 * h;
        if (m >= prm.m) continue;
        const float v0 = activate(acc[i][j][2 * h] * sc[0] + bi[0], act);
        const float v1 = activate(acc[i][j][2 * h + 1] * sc[1] + bi[1], act);
        float* dst = out + (size_t)m * prm.n + n;
        if (two && pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (two) dst[1] = v1;
        }
      }
    }
  }
}

// The splits' sum, in order z = 0, 1, ..., and the epilogue: C (m, n).
__global__ void __launch_bounds__(256) matmul_reduce_kernel(const __grid_constant__ MmParams prm) {
  const size_t mn = (size_t)prm.m * prm.n;
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < mn; i += (size_t)gridDim.x * 256) {
    float v = prm.work[i];
    for (int z = 1; z < prm.splits; ++z) v += prm.work[z * mn + i];
    const int n = (int)(i % prm.n);
    const float sc = prm.scale != nullptr ? prm.scale[n] : 1.f;
    const float bi = (prm.bias != nullptr && n < prm.n_bias) ? prm.bias[n] : 0.f;
    prm.c[i] = activate(v * sc + bi, prm.act);
  }
}

constexpr int kErrBadShape = -1;
constexpr int kErrBadBlocking = -2;
constexpr int kErrBadType = -3;
constexpr int kErrBadAlign = -4;

template <typename U, int kBM, int kBN, int kWM, int kWN>
int launch(const MmParams& prm, cudaStream_t stream) {
  using T = Tile<U, kBM, kBN, kWM, kWN>;
  auto kernel = matmul_kernel<U, kBM, kBN, kWM, kWN>;
  // Raise the shared-memory cap once per instantiation: a warmed-up launch
  // then makes no CUDA API call but the launch (capturable in a CUDA graph).
  static bool granted = false;
  if (!granted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (err != cudaSuccess) return err;
    granted = true;
  }
  dim3 grid((prm.m + kBM - 1) / kBM, prm.n / kBN + (prm.n % kBN != 0), prm.splits);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(prm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || prm.splits == 1) return err;
  const size_t mn = (size_t)prm.m * prm.n;
  const int blocks = (int)(mn / 256 + 1 < 1056 ? mn / 256 + 1 : 1056);  // 8 per SM at most
  matmul_reduce_kernel<<<blocks, 256, 0, stream>>>(prm);
  return cudaGetLastError();
}

template <typename U>
int dispatch(const MmParams& prm, int bm, int bn, cudaStream_t s) {
#define REPRO_CASE(BM_, BN_, WM_, WN_) \
  if (bm == BM_ && bn == BN_) return launch<U, BM_, BN_, WM_, WN_>(prm, s);
  // The menu: must agree with core/im2col.py:MATMUL_TILES.
  REPRO_CASE(128, 64, 4, 2) REPRO_CASE(64, 64, 2, 2) REPRO_CASE(128, 32, 4, 1)
  REPRO_CASE(64, 32, 2, 2) REPRO_CASE(128, 16, 4, 1) REPRO_CASE(64, 16, 4, 1)
  REPRO_CASE(32, 64, 1, 4) REPRO_CASE(32, 32, 2, 2)
#undef REPRO_CASE
  return kErrBadBlocking;
}

}  // namespace

extern "C" {

// Launch on `stream`: C (m, n) = act(scale * (A (m, k) @ B[:k, :n]) + bias)
// with a (bm, bn) block tile of the menu and the K steps in `splits` parts
// (core/im2col.py:matmul_split_fits), their partial sums in `work`, (splits,
// m, n) fp32, when splits > 1. B is (kp, ldb): kp = k rounded up to 32,
// ldb = n rounded up to bn (core/im2col.py:matmul_b_shape), 16-byte
// aligned. Returns 0, a CUDA error code (> 0), or a negative validation
// code; matmul_error names each.
int matmul_launch(const float* a, const void* b, int b_type, const float* bias,
                  int n_bias, const float* scale, float* c, int m, int n,
                  int k, int kp, int ldb, int bm, int bn, int splits,
                  float* work, int activation, void* stream) {
  if (m < 1 || n < 1 || k < 1 || bn < 1 || kp != (k + kBK - 1) / kBK * kBK ||
      ldb != (n + bn - 1) / bn * bn || activation < kNone || activation > kGelu)
    return kErrBadShape;
  const int n_k = kp / kBK;
  const int steps = splits < 1 ? 0 : (n_k + splits - 1) / splits;
  if (splits < 1 || splits > n_k || (n_k + steps - 1) / steps != splits ||
      (splits > 1 && work == nullptr))
    return kErrBadBlocking;
  if (reinterpret_cast<uintptr_t>(b) % 16 != 0) return kErrBadAlign;
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
  prm.vec_a = k % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  prm.act = activation;
  prm.splits = splits;
  prm.steps = steps;
  prm.work = work;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b_type) {
    case kF32:
      return dispatch<float>(prm, bm, bn, s);
    case kBF16:
      return dispatch<__nv_bfloat16>(prm, bm, bn, s);
    case kI8:
      return dispatch<int8_t>(prm, bm, bn, s);
    default:
      return kErrBadType;
  }
}

const char* matmul_error(int code) {
  switch (code) {
    case kErrBadShape:
      return "operand shapes do not match the kernel's padding rule";
    case kErrBadBlocking:
      return "block tile is not on the kernel's menu, or the K split does not fit";
    case kErrBadType:
      return "unsupported B dtype";
    case kErrBadAlign:
      return "B must be 16-byte aligned";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
