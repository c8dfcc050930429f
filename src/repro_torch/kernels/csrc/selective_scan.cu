// Mamba-1 selective scan for Hopper.
//
// Replaces repro/kernels/selective_scan.py:selective_scan (the Pallas TPU
// kernel). Same function on the same operands: dt and xs (B, L, D) in fp32
// or bf16, bmat and cmat (B, L, N) in fp32 or bf16, a_mat (D, N) fp32 ->
// y (B, L, D) fp32 and h_last (B, D, N) fp32, with
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,   y_t = C_t . h_t,   h_0 = 0.
//
// What bounds it. Bytes: dt, xs and y are (B, L, D) fp32 each, so at the
// falcon-mamba-7b prefill shape (4, 2048, 8192, 16) a call moves ~0.81 GB,
// 0.24 ms at 3.35 TB/s. Operations: B*L*D*N = 1.07e9 state updates, each
// one expf and about six FLOPs, ~0.11 ms at 67 TFLOP/s counting the expf
// as one. So bytes bound it on paper; in practice the full-precision expf
// (a range reduction around the MUFU ex2, ~10 instructions) makes the
// instruction issue the likely limit.
//
// Design. One thread per (b, d) keeps the N fp32 states in registers and
// walks L in order, so the state never leaves the SM and nothing but the
// operands and y touches device memory. Neighbouring threads hold
// neighbouring channels: each step's dt, xs loads and y store are one
// contiguous run per warp. B_t and C_t (N values per step, shared by every
// channel) are staged per 64-step chunk in shared memory and read as
// broadcasts. dt and xs are loaded 8 steps ahead of use into registers, so
// each thread keeps 16 loads in flight. N is padded to a template size
// (4, 8 or 16) with zero A, B and C, which leaves the padded states at 0.
//
// How the TPU design translates:
//  * The Pallas grid (B, D/bD, L/chunk) ran L innermost and sequential,
//    carrying a (bD, N) VMEM state across grid steps, and ran an
//    associative scan inside each chunk to fill the VPU. Here the blocks
//    (128 channels of one batch row) run in parallel and each thread's
//    loop over L replaces the sequential grid axis; the recurrence itself
//    is the parallelism-free inner loop, with N independent FMA chains
//    giving the instruction-level parallelism the associative scan gave
//    the TPU. No chunk or block_d constraint: any L and D.
//  * Full-precision expf (no fast-math): the reference holds its kernel to
//    1e-5 relative.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 64;     // steps of B_t / C_t staged per pass
constexpr int kAhead = 8;      // steps of dt / xs loaded ahead of use

struct Params {
  const void* dt;
  const void* xs;
  const void* bmat;
  const void* cmat;
  const float* a;
  float* y;
  float* h_last;
  int l, d, n;
};

template <typename X, typename Y, int N>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const __grid_constant__ Params prm) {
  __shared__ float sb[kChunk][N];
  __shared__ float sc[kChunk][N];
  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const int b = blockIdx.y;
  const int L = prm.l, D = prm.d, n_real = prm.n;
  const bool live = d < D;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = (live && n < n_real) ? prm.a[(size_t)d * n_real + n] : 0.f;
    h[n] = 0.f;
  }
  for (int i = tid; i < kChunk * N; i += kThreads) {
    (&sb[0][0])[i] = 0.f;  // padded states read B = C = 0 forever
    (&sc[0][0])[i] = 0.f;
  }
  const size_t row = (size_t)b * L;
  const X* __restrict__ dtp = static_cast<const X*>(prm.dt) + row * D + d;
  const X* __restrict__ xsp = static_cast<const X*>(prm.xs) + row * D + d;
  const Y* __restrict__ bp = static_cast<const Y*>(prm.bmat) + row * n_real;
  const Y* __restrict__ cp = static_cast<const Y*>(prm.cmat) + row * n_real;
  float* __restrict__ yp = prm.y + row * D + d;

  for (int l0 = 0; l0 < L; l0 += kChunk) {
    const int steps = min(kChunk, L - l0);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < steps * n_real; i += kThreads) {
      const size_t src = (size_t)l0 * n_real + i;
      sb[i / n_real][i % n_real] = widen(bp[src]);
      sc[i / n_real][i % n_real] = widen(cp[src]);
    }
    __syncthreads();
    if (!live) continue;
    for (int s0 = 0; s0 < steps; s0 += kAhead) {
      float dtr[kAhead], xr[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const size_t off = (size_t)(l0 + s0 + u) * D;
        const bool in = s0 + u < steps;
        dtr[u] = in ? widen(dtp[off]) : 0.f;
        xr[u] = in ? widen(xsp[off]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (s0 + u < steps) {
          const int s = s0 + u;
          const float dx = dtr[u] * xr[u];
          float acc = 0.f;
#pragma unroll
          for (int n = 0; n < N; ++n) {
            h[n] = fmaf(expf(dtr[u] * a[n]), h[n], dx * sb[s][n]);
            acc = fmaf(sc[s][n], h[n], acc);
          }
          yp[(size_t)(l0 + s) * D] = acc;
        }
      }
    }
  }
  if (live) {
    float* hp = prm.h_last + ((size_t)b * D + d) * n_real;
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (n < n_real) hp[n] = h[n];
  }
}

constexpr int kErrBadShape = -1;
constexpr int kErrBadType = -3;

template <typename X, typename Y, int N>
cudaError_t launch(const Params& prm, int b, cudaStream_t stream) {
  dim3 grid((prm.d + kThreads - 1) / kThreads, b);
  scan_kernel<X, Y, N><<<grid, kThreads, 0, stream>>>(prm);
  return cudaGetLastError();
}

template <typename X, typename Y>
int launch_states(const Params& prm, int b, cudaStream_t stream) {
  if (prm.n <= 4) return launch<X, Y, 4>(prm, b, stream);
  if (prm.n <= 8) return launch<X, Y, 8>(prm, b, stream);
  return launch<X, Y, 16>(prm, b, stream);
}

template <typename X>
int launch_bc(const Params& prm, int bc_type, int b, cudaStream_t stream) {
  switch (bc_type) {
    case kF32: return launch_states<X, float>(prm, b, stream);
    case kBF16: return launch_states<X, __nv_bfloat16>(prm, b, stream);
    default: return kErrBadType;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or a negative
// validation code; selective_scan_error names each. dt, xs: (b, l, d) of
// type x_type; bmat, cmat: (b, l, n) of type bc_type (UType codes, fp32 or
// bf16); a: (d, n) fp32; y: (b, l, d) fp32; h_last: (b, d, n) fp32.
int selective_scan_launch(const void* dt, const void* xs, int x_type,
                          const void* bmat, const void* cmat, int bc_type,
                          const float* a, float* y, float* h_last, int b,
                          int l, int d, int n, void* stream) {
  if (b < 1 || b > 65535 || l < 1 || d < 1 || n < 1 || n > 16)
    return kErrBadShape;
  Params prm{dt, xs, bmat, cmat, a, y, h_last, l, d, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_type) {
    case kF32: return launch_bc<float>(prm, bc_type, b, st);
    case kBF16: return launch_bc<__nv_bfloat16>(prm, bc_type, b, st);
    default: return kErrBadType;
  }
}

const char* selective_scan_error(int code) {
  switch (code) {
    case kErrBadShape:
      return "operand shapes are out of the kernel's range";
    case kErrBadType:
      return "unsupported dtype";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
