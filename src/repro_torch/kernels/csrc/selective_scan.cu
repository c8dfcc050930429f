// Mamba-1 selective scan for Hopper.
//
// Replaces repro/kernels/selective_scan.py:selective_scan (the Pallas TPU
// kernel). Same function on the same operands: dt and xs (B, L, D) in fp32
// or bf16, bmat and cmat (B, L, N) in fp32 or bf16, a_mat (D, N) fp32 ->
// y (B, L, D) fp32 and h_last (B, D, N) fp32, with
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,   y_t = C_t . h_t,   h_0 = 0.
//
// What bounds it. Each state update takes one exponential, and the card
// computes those on its special-function unit (MUFU.EX2), 16 a clock per
// SM against 128 fp32 FMAs: at the falcon-mamba-7b prefill shape
// (4, 2048, 8192, 16), B*L*D*N = 1.07e9 updates take 0.257 ms there. The
// bytes (dt, xs, y fp32 (B, L, D) each, ~0.81 GB) take 0.24 ms at
// 3.35 TB/s, and the issue slots of the ~7 instructions an update needs
// about as long. So the design keeps all three streams busy at once: many
// warps in flight, few instructions per update, the loads ahead of use.
//
// Design.
//  * A group of kL lanes (1, 2 or 4) owns one (b, d) channel; each lane
//    keeps kS = N / kL of its fp32 states in registers and walks L in
//    order, so the state never leaves the SM. With 4 lanes the layer shape
//    runs 31 warps per SM, where one lane per channel ran 8.
//  * The decay is exp2: A is scaled by log2(e) once, and each update is one
//    FMUL and one ex2.approx.ftz.f32 (a single MUFU.EX2), where expf was a
//    range reduction of ~10 instructions around it. ex2.approx's relative
//    error is at most 2^-22 (PTX ISA) and the scaled product rounds once
//    more, both far inside the 1e-5 the reference holds its kernel to; a
//    decay that would be subnormal flushes to 0, which moves h by less
//    than 2^-126 of a state.
//  * y_t is C_t . h_t summed over the group. The lanes exchange partial
//    sums of kL consecutive steps by __shfl_xor_sync and each lane ends
//    with one step's total (a reduce-scatter: kL - 1 shuffles per kL
//    steps, not log2(kL) per step), which it stores; a warp's store covers
//    32 / kL channels of kL steps, whole 32-byte sectors.
//  * A block of `ch` channels (ch * kL threads) stages `chunk` steps of
//    dt, xs, B and C in shared memory by 16-byte cp.async copies (zero
//    filled past L), double-buffered: the next chunk is in flight while
//    the block scans this one. dt and xs are then broadcast reads (the
//    lanes of a group read one address) and a lane's kS values of B_t and
//    C_t are one vector read each. Shapes whose rows are not 16-byte
//    aligned (D * size or N * size not a multiple of 16, or the block past
//    D) stage by plain loads instead.
//  * The blocking (kL, ch, chunk) is chosen in Python
//    (kernels/selective_scan.py:scan_blocking) from `chip_smoke.py --sweep
//    selective_scan`. N is padded to a template size (4, 8 or 16) with zero
//    A, B and C, which leaves the padded states at 0. Sums run in a fixed
//    order: two launches give the same bits.
//
// How the TPU design translates:
//  * The Pallas grid (B, D/bD, L/chunk) ran L innermost and sequential,
//    carrying a (bD, N) VMEM state across grid steps, and ran an
//    associative scan inside each chunk to fill the VPU. Here the blocks
//    run in parallel and each lane group's loop over L replaces the
//    sequential grid axis; its chunks of staged operands are the grid's
//    L blocks. The recurrence is the parallelism-free inner loop, with kS
//    independent FMA chains per lane and many warps per SM giving the
//    overlap the associative scan gave the TPU. No chunk or block_d
//    constraint on the shape: any L and D.

#include "common.cuh"
#include "mma_tf32x3.cuh"  // cp.async

namespace {

// These must agree with repro_torch/kernels/selective_scan.py
// (SCAN_MAX_THREADS) and repro_torch/core/winograd.py (TC_SMEM_MAX).
constexpr int kMaxThreads = 512;
constexpr size_t kSmemMax = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* dt;
  const void* xs;
  const void* bmat;
  const void* cmat;
  const float* a;
  float* y;
  float* h_last;
  int l, d, n;
  int ch, chunk;  // channels per block, steps per staged chunk
  int lch;        // log2(ch)
};

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// K consecutive staged values from shared memory, widened: one vector read
// where K * size is 4 to 16 bytes, 16-byte reads beyond.
template <int K>
__device__ __forceinline__ void load_states(float (&v)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x, v[i + 1] = t.y, v[i + 2] = t.z, v[i + 3] = t.w;
    }
  } else if constexpr (K == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <int K>
__device__ __forceinline__ void load_states(float (&v)[K], const __nv_bfloat16* p) {
  if constexpr (K >= 8) {
#pragma unroll
    for (int i = 0; i < K; i += 8) {
      const uint4 t = *reinterpret_cast<const uint4*>(p + i);
      const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i + 2 * j] = bf16_lo(w[j]), v[i + 2 * j + 1] = bf16_hi(w[j]);
    }
  } else if constexpr (K == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_lo(t.x), v[1] = bf16_hi(t.x), v[2] = bf16_lo(t.y), v[3] = bf16_hi(t.y);
  } else if constexpr (K == 2) {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
    v[0] = bf16_lo(t), v[1] = bf16_hi(t);
  } else {
    v[0] = widen(p[0]);
  }
}

// Partial sums p[0..kL) of kL consecutive steps, one set per lane of a
// group of kL lanes: after log2(kL) halving rounds, lane `sub` of the group
// returns step sub's total. In each round a lane keeps the half of its
// steps that its bit selects and adds its partner's partials of that half.
template <int kL>
__device__ __forceinline__ float reduce_scatter(float* p, int sub) {
#pragma unroll
  for (int w = kL / 2; w >= 1; w /= 2) {
    const bool upper = sub & w;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float send = upper ? p[i] : p[i + w];
      const float keep = upper ? p[i + w] : p[i];
      p[i] = keep + __shfl_xor_sync(kFull, send, w);
    }
  }
  return p[0];
}

// Stage `chunk` rows of `cols` values into dst (row-major, `cols` a row),
// row s from src + s * stride: rows at or past `rows` and columns at or
// past `col_lim` are zeros. vec: 16-byte cp.async copies (every row and
// src 16-byte aligned, col_lim >= cols); else plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, size_t stride, int chunk,
                                      int lcols, int rows, int col_lim, bool vec, int tid,
                                      int nthreads) {
  const int cols = 1 << lcols;
  if (vec) {
    constexpr int kV = 16 / sizeof(T);  // values per copy
    const int lq = lcols - (sizeof(T) == 4 ? 2 : 3);
    for (int i = tid; i < chunk << lq; i += nthreads) {
      const int s = i >> lq, q = i & ((1 << lq) - 1);
      const bool in = s < rows;
      cp_async16_zfill(dst + s * cols + q * kV, src + (in ? (size_t)s * stride + q * kV : 0),
                       in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < chunk << lcols; i += nthreads) {
      const int s = i >> lcols, c = i & (cols - 1);
      dst[i] = (s < rows && c < col_lim) ? src[(size_t)s * stride + c] : zero_of<T>();
    }
  }
}

template <typename X, typename Y, int N, int kL>
__global__ void __launch_bounds__(kMaxThreads)
    scan_kernel(const __grid_constant__ Params prm) {
  constexpr int kS = N / kL;            // states per lane
  constexpr int kU = kL > 4 ? kL : 4;   // steps per unrolled group
  constexpr int kLN = N == 4 ? 2 : N == 8 ? 3 : 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ch = prm.ch, chunk = prm.chunk, L = prm.l, D = prm.d, n_real = prm.n;
  const int tid = threadIdx.x, nthreads = ch * kL;
  const int sub = tid & (kL - 1);
  const int c = tid / kL;
  const int d0 = blockIdx.x * ch;
  const int d = d0 + c;
  const int b = blockIdx.y;
  const bool live = d < D;

  // one stage: dt (chunk, ch), xs (chunk, ch), B (chunk, N), C (chunk, N)
  const size_t x_bytes = (size_t)chunk * ch * sizeof(X);
  const size_t y_bytes = (size_t)chunk * N * sizeof(Y);
  const size_t stage_bytes = 2 * x_bytes + 2 * y_bytes;

  float a2[kS], h[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const int n = sub * kS + i;
    a2[i] = (live && n < n_real) ? prm.a[(size_t)d * n_real + n] * 1.4426950408889634f : 0.f;
    h[i] = 0.f;
  }

  const size_t row = (size_t)b * L;
  const X* __restrict__ dtg = static_cast<const X*>(prm.dt) + row * D + d0;
  const X* __restrict__ xsg = static_cast<const X*>(prm.xs) + row * D + d0;
  const Y* __restrict__ bg = static_cast<const Y*>(prm.bmat) + row * n_real;
  const Y* __restrict__ cg = static_cast<const Y*>(prm.cmat) + row * n_real;
  float* __restrict__ yp = prm.y + row * D + d;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec_x = (D * sizeof(X)) % 16 == 0 && d0 + ch <= D && aligned(prm.dt) &&
                     aligned(prm.xs);
  const bool vec_y = n_real == N && (N * sizeof(Y)) % 16 == 0 && aligned(prm.bmat) &&
                     aligned(prm.cmat);

  auto fill = [&](int st, int l0) {
    unsigned char* base = smem + st * stage_bytes;
    const int rows = min(chunk, L - l0);
    stage(reinterpret_cast<X*>(base), dtg + (size_t)l0 * D, D, chunk, prm.lch, rows, D - d0,
          vec_x, tid, nthreads);
    stage(reinterpret_cast<X*>(base + x_bytes), xsg + (size_t)l0 * D, D, chunk, prm.lch, rows,
          D - d0, vec_x, tid, nthreads);
    stage(reinterpret_cast<Y*>(base + 2 * x_bytes), bg + (size_t)l0 * n_real, n_real, chunk,
          kLN, rows, n_real, vec_y, tid, nthreads);
    stage(reinterpret_cast<Y*>(base + 2 * x_bytes + y_bytes), cg + (size_t)l0 * n_real,
          n_real, chunk, kLN, rows, n_real, vec_y, tid, nthreads);
  };

  fill(0, 0);
  cp_async_commit();
  int st = 0;
  for (int l0 = 0; l0 < L; l0 += chunk) {
    if (l0 + chunk < L) fill(st ^ 1, l0 + chunk);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's copies have landed
    __syncthreads();
    const unsigned char* base = smem + st * stage_bytes;
    const X* sdt = reinterpret_cast<const X*>(base) + c;
    const X* sxs = reinterpret_cast<const X*>(base + x_bytes) + c;
    const Y* sb = reinterpret_cast<const Y*>(base + 2 * x_bytes) + sub * kS;
    const Y* sc = reinterpret_cast<const Y*>(base + 2 * x_bytes + y_bytes) + sub * kS;
    const int steps = min(chunk, L - l0);
    // steps past L read zeros: dt = 0 leaves h as it is
    for (int s0 = 0; s0 < steps; s0 += kU) {
      float p[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int s = s0 + u;
        const float dtv = widen(sdt[s * ch]);
        const float dx = dtv * widen(sxs[s * ch]);
        float bv[kS], cv[kS];
        load_states(bv, sb + s * N);
        load_states(cv, sc + s * N);
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          h[i] = fmaf(ex2(dtv * a2[i]), h[i], dx * bv[i]);
          acc = fmaf(cv[i], h[i], acc);
        }
        p[u] = acc;
      }
#pragma unroll
      for (int g = 0; g < kU; g += kL) {
        const float yv = reduce_scatter<kL>(p + g, sub);
        const int s = s0 + g + sub;
        if (live && s < steps) yp[(size_t)(l0 + s) * D] = yv;
      }
    }
    __syncthreads();  // every read of this stage is done before it refills
    st ^= 1;
  }
  if (live) {
    float* hp = prm.h_last + ((size_t)b * D + d) * n_real;
#pragma unroll
    for (int i = 0; i < kS; ++i)
      if (sub * kS + i < n_real) hp[sub * kS + i] = h[i];
  }
}

constexpr int kErrBadShape = -1;
constexpr int kErrBadBlocking = -2;
constexpr int kErrBadType = -3;

int padded_states(int n) { return n <= 4 ? 4 : n <= 8 ? 8 : 16; }

// Dynamic shared memory of one block; must agree with
// kernels/selective_scan.py:scan_smem_bytes.
size_t smem_bytes(int ch, int chunk, int n, int x_size, int y_size) {
  return 2 * (size_t)chunk * (2 * (size_t)ch * x_size + 2 * (size_t)padded_states(n) * y_size);
}

template <typename X, typename Y, int N, int kL>
int launch(const Params& prm, int b, cudaStream_t stream) {
  auto kernel = scan_kernel<X, Y, N, kL>;
  const size_t smem = smem_bytes(prm.ch, prm.chunk, prm.n, sizeof(X), sizeof(Y));
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
  dim3 grid((prm.d + prm.ch - 1) / prm.ch, b);
  kernel<<<grid, prm.ch * kL, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <typename X, typename Y, int N>
int launch_lanes(const Params& prm, int lanes, int b, cudaStream_t stream) {
  switch (lanes) {
    case 1: return launch<X, Y, N, 1>(prm, b, stream);
    case 2: return launch<X, Y, N, 2>(prm, b, stream);
    case 4: return launch<X, Y, N, 4>(prm, b, stream);
    default: return kErrBadBlocking;
  }
}

template <typename X, typename Y>
int launch_states(const Params& prm, int lanes, int b, cudaStream_t stream) {
  switch (padded_states(prm.n)) {
    case 4: return launch_lanes<X, Y, 4>(prm, lanes, b, stream);
    case 8: return launch_lanes<X, Y, 8>(prm, lanes, b, stream);
    default: return launch_lanes<X, Y, 16>(prm, lanes, b, stream);
  }
}

template <typename X>
int launch_bc(const Params& prm, int bc_type, int lanes, int b, cudaStream_t stream) {
  switch (bc_type) {
    case kF32: return launch_states<X, float>(prm, lanes, b, stream);
    case kBF16: return launch_states<X, __nv_bfloat16>(prm, lanes, b, stream);
    default: return kErrBadType;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or a negative
// validation code; selective_scan_error names each. dt, xs: (b, l, d) of
// type x_type; bmat, cmat: (b, l, n) of type bc_type (UType codes, fp32 or
// bf16); a: (d, n) fp32; y: (b, l, d) fp32; h_last: (b, d, n) fp32. The
// blocking: `lanes` (1, 2 or 4) lanes per channel, `channels` (32 to 256, a power of two, channels * lanes <= 512)
// channels per block, `chunk` (16 to 128, a power of two) steps per staged
// chunk.
int selective_scan_launch(const void* dt, const void* xs, int x_type,
                          const void* bmat, const void* cmat, int bc_type,
                          const float* a, float* y, float* h_last, int b,
                          int l, int d, int n, int lanes, int channels,
                          int chunk, void* stream) {
  if (b < 1 || b > 65535 || l < 1 || d < 1 || n < 1 || n > 16)
    return kErrBadShape;
  if ((lanes != 1 && lanes != 2 && lanes != 4) || channels < 32 || channels > 256 || (channels & (channels - 1)) != 0 ||
      channels * lanes > kMaxThreads || chunk < 16 || chunk > 128 ||
      (chunk & (chunk - 1)) != 0)
    return kErrBadBlocking;
  Params prm{dt, xs, bmat, cmat, a, y, h_last, l, d, n, channels, chunk, 0};
  while ((1 << prm.lch) < channels) ++prm.lch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_type) {
    case kF32: return launch_bc<float>(prm, bc_type, lanes, b, st);
    case kBF16: return launch_bc<__nv_bfloat16>(prm, bc_type, lanes, b, st);
    default: return kErrBadType;
  }
}

const char* selective_scan_error(int code) {
  switch (code) {
    case kErrBadShape:
      return "operand shapes are out of the kernel's range";
    case kErrBadBlocking:
      return "blocking does not fit the kernel (lanes, channels, chunk or "
             "shared memory)";
    case kErrBadType:
      return "unsupported dtype";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
