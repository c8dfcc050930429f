// The warp-specialised stride-1 Winograd / Cook-Toom body on the tensor
// cores (TF32x3), for winograd_streamed.cu: a producer warpgroup stages and
// transforms, two consumer warpgroups run the point-GEMMs, and an mbarrier
// ring joins them. The design notes are in winograd_streamed.cu. It shares
// only mma_tf32x3.cuh and common.cuh with the other bodies; everything here
// lives in namespace ws.

#pragma once

#include "common.cuh"
#include "mma_tf32x3.cuh"

namespace {
namespace ws {

constexpr int kConsumerWarps = 8;                  // warpgroups 0 and 1
constexpr int kConsumers = 32 * kConsumerWarps;    // 256 threads
constexpr int kProducers = 128;                    // warpgroup 2
constexpr int kThreads = kConsumers + kProducers;  // 384
constexpr int kMaxT = 8;       // the transform matrices' padded size
constexpr int kBC = 8;         // channels per C step: one k-step of m16n8k8
// setmaxnreg: 128 x 72 + 256 x 216 = 64,512 = 384 x 168, the registers the
// launch bounds give the block.
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kBarBytes = 64;  // full[2], empty[2], ahead of the ring
// Named barriers (0 is __syncthreads).
constexpr int kBarProducers = 1, kBarConsumers = 2;

// A blocking the body does not take, as winograd_tc.cuh numbers it
// (tc_error names it).
constexpr int kErrBadBlocking = -2;

struct Params {
  const float* x;
  const void* u;
  const float* bias;
  const float* scale;
  float* y;
  int n_bias;
  int hp, wp, cp, mp;
  int th, tw, mh, mw, p;
  int bh, bw, n_hb, n_wb;
  int sh, sw;         // strip extent, pixels: bh*mh + th - mh, bw*mw + tw - mw
  unsigned sw_magic;  // ceil(2^32 / sw): pixel / sw as one __umulhi
  int lbw;            // log2 of bw (a power of two)
  int ldu;            // bytes between two rows of a staged filter chunk
  int strip_floats;   // one strip slot: (sh, sw, 8)
  int v_floats;       // one V slot: (P, bR, 8)
  int u_bytes;        // one filter slot: (P, 8) rows of ldu bytes
  int act;
  float bt_h[kMaxT * kMaxT];  // row-major, zero-padded to 8 x 8
  float bt_w[kMaxT * kMaxT];
  float at_h[kMaxT * kMaxT];
  float at_w[kMaxT * kMaxT];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// An arrival on `bar` once every cp.async this thread issued so far has
// landed (counted among the barrier's expected arrivals).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}
template <int kId, int kCount>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kId), "n"(kCount) : "memory");
}

// V (P, bR, 8) holds row r's channel c at column c ^ (r & 4): the producer's
// stores (8 channels x 4 tiles a warp) and the consumers' A fragments (rows
// g and g + 8, columns t and t + 4) each touch 32 distinct banks.
__device__ __forceinline__ int v_col(int r, int c) { return c ^ (r & 4); }

template <typename U, int T, int kMT, int kNT>
struct Config {
  static constexpr int kPts = (T * T + kConsumerWarps - 1) / kConsumerWarps;
  static constexpr int kBR = 16 * kMT, kBM = 8 * kNT;
  static constexpr bool kBLo = sizeof(U) == 4;  // fp32 filter: split B too
};

// kR 3: th == tw == T and mh == mw == T - 2 (a 3 x 3 filter: F(2, 3) at
// T = 4, F(4, 3) at T = 6), so the transforms run without guards and the
// inverse skips A^T's zero padding; kR 0 takes any tile up to T with
// guards.
template <typename U, int T, int kMT, int kNT, int kR>
__global__ void __launch_bounds__(kThreads, 1)
    winograd_ws_kernel(const __grid_constant__ Params prm) {
  using C = Config<U, T, kMT, kNT>;
  constexpr int bR = C::kBR, bM = C::kBM;
  constexpr bool kExact = kR > 0;
  constexpr int kM = kExact ? T - kR + 1 : T;  // rows of A^T the inverse needs
  extern __shared__ __align__(128) unsigned char ws_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ws_smem);  // V slot b ready
  uint64_t* empty = full + 2;                          // V and filter slot b free
  float* s_strip = reinterpret_cast<float*>(ws_smem + kBarBytes);  // 2 x (sh, sw, 8)
  float* s_v = s_strip + 2 * prm.strip_floats;                  // 2 x (P, bR, 8)
  unsigned char* s_u = reinterpret_cast<unsigned char*>(s_v + 2 * prm.v_floats);
  const int P = kExact ? T * T : prm.p;
  const int th = kExact ? T : prm.th, tw = kExact ? T : prm.tw;
  const int mh = kExact ? kM : prm.mh, mw = kExact ? kM : prm.mw;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int blk = blockIdx.x;
  const int wb = blk % prm.n_wb;
  blk /= prm.n_wb;
  const int hb = blk % prm.n_hb;
  const int img = blk / prm.n_hb;
  const int m_base = blockIdx.y * bM;
  const int row0 = hb * prm.bh * mh;
  const int col0 = wb * prm.bw * mw;
  const int n_steps = prm.cp / kBC;

  if (tid == 0) {
    mbar_init(&full[0], 2 * kProducers);  // the transforms + the filter copies
    mbar_init(&full[1], 2 * kProducers);
    mbar_init(&empty[0], kConsumers);
    mbar_init(&empty[1], kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer warpgroup: staging and the input transform ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int ptid = tid - kConsumers;
    const float* x_img = prm.x + (size_t)img * prm.hp * prm.wp * prm.cp;
    const unsigned char* u = static_cast<const unsigned char*>(prm.u);
    constexpr int kRowBytes = bM * (int)sizeof(U);

    // cp.async step s's strip (channels [8s, 8s + 8)) into strip slot
    // `slot` (the caller commits the group).
    auto stage_strip = [&](int s, int slot) {
      const float* xs = x_img + s * kBC;
      float* ds = s_strip + slot * prm.strip_floats;
      for (int i = ptid; i < (prm.sh * prm.sw) << 1; i += kProducers) {
        const int q = i & 1, pix = i >> 1;
        const int yy = __umulhi(pix, prm.sw_magic), xx = pix - yy * prm.sw;
        cp_async16(ds + pix * kBC + 4 * q,
                   xs + ((size_t)(row0 + yy) * prm.wp + col0 + xx) * prm.cp + 4 * q);
      }
    };
    // cp.async the raw filter chunk of step s, (P, 8) rows of bM values,
    // into filter slot `slot`, as one commit group; each producer thread's
    // copies count as one arrival on full[slot] once they land.
    auto stage_filter = [&](int s, int slot) {
      constexpr int kQ = kRowBytes / 16;  // 16-byte pieces a row
      unsigned char* du = s_u + slot * prm.u_bytes;
      for (int i = ptid; i < P * kBC * kQ; i += kProducers) {
        const int q = i % kQ, row = i / kQ;
        const int p = row >> 3, k = row & 7;
        const size_t src = ((size_t)p * prm.cp + s * kBC + k) * prm.mp + m_base;
        cp_async16(du + row * prm.ldu + 16 * q, u + src * sizeof(U) + 16 * q);
      }
      cp_async_commit();
      mbar_arrive_cp_async(&full[slot]);
    };

    // Commit groups in flight at the top of step s: strip s, then filter s.
    stage_strip(0, 0);
    cp_async_commit();
    stage_filter(0, 0);
    for (int s = 0; s < n_steps; ++s) {
      const int b = s & 1;
      cp_async_wait<1>();                        // strip s landed
      named_sync<kBarProducers, kProducers>();  // all of it; transform s-1 done
      if (s + 1 < n_steps) stage_strip(s + 1, b ^ 1);
      cp_async_commit();
      if (s >= 2) mbar_wait(&empty[b], ((s >> 1) - 1) & 1);  // GEMMs s-2 done with V[b]

      // Input transform B_h^T d B_w, one (tile, channel) per thread, channels
      // fastest, into V[b] (P, bR, 8).
      const float* strip = s_strip + b * prm.strip_floats;
      float* vb = s_v + b * prm.v_floats;
#pragma unroll 1
      for (int it = ptid; it < bR * kBC; it += kProducers) {
        const int c = it & 7, r = it >> 3;
        const float* src =
            strip + ((r >> prm.lbw) * mh * prm.sw + (r & (prm.bw - 1)) * mw) * kBC + c;
        float* dst = vb + r * kBC + v_col(r, c);
        float t1[T][T];  // B_h^T d, column by column
#pragma unroll
        for (int bb = 0; bb < T; ++bb) {
          float d[T];
#pragma unroll
          for (int a = 0; a < T; ++a)
            d[a] = (kExact || (a < th && bb < tw)) ? src[(a * prm.sw + bb) * kBC] : 0.f;
#pragma unroll
          for (int ii = 0; ii < T; ++ii) {
            float v = 0.f;
#pragma unroll
            for (int a = 0; a < T; ++a) v += prm.bt_h[ii * kMaxT + a] * d[a];
            t1[ii][bb] = v;
          }
        }
#pragma unroll
        for (int ii = 0; ii < T; ++ii) {
          if (kExact || ii < th) {
#pragma unroll
            for (int j = 0; j < T; ++j) {
              if (kExact || j < tw) {
                float v = 0.f;
#pragma unroll
                for (int bb = 0; bb < T; ++bb) v += t1[ii][bb] * prm.bt_w[j * kMaxT + bb];
                dst[(ii * tw + j) * bR * kBC] = v;
              }
            }
          }
        }
      }
      mbar_arrive(&full[b]);
      if (s + 1 < n_steps) {
        if (s >= 1) mbar_wait(&empty[b ^ 1], ((s - 1) >> 1) & 1);  // GEMMs s-1 done
        stage_filter(s + 1, b ^ 1);
      }
    }
    cp_async_wait_all();  // the last filter chunk's copies, before exiting
  } else {
    // ---- consumer warpgroups: the point-GEMMs, then the inverse ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int g = lane >> 2, t = lane & 3;
    const int xo = g & 4;  // v_col of rows g and g + 8
    const int a_lo = g * kBC + t + xo, a_hi = g * kBC + t + 4 - xo;
    const int ldu = prm.ldu / (int)sizeof(U);  // filter row, in elements
    const int b_off = t * ldu + g;

    float acc[C::kPts][kMT][kNT][4];
#pragma unroll
    for (int q = 0; q < C::kPts; ++q)
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[q][i][j][e] = 0.f;

    // The point-GEMMs V[p] (bR x 8) x U[p] (8 x bM), warp w on points w,
    // w + 8, ..., TF32x3. The tensor cores round their fp32 sums toward
    // zero, so each C step's products sum into a zeroed fragment that joins
    // the running accumulator with an fp32 add (round to nearest): the
    // biased rounding spans 8 channels, not all of C.
    for (int s = 0; s < n_steps; ++s) {
      const int b = s & 1;
      mbar_wait(&full[b], (s >> 1) & 1);
      const float* vb = s_v + b * prm.v_floats;
      const U* ub = reinterpret_cast<const U*>(s_u + b * prm.u_bytes) + b_off;
#pragma unroll
      for (int q = 0; q < C::kPts; ++q) {
        const int p = warp + kConsumerWarps * q;
        if (p < P) {
          const float* vp = vb + p * bR * kBC;
          FragA a[kMT];
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            split_tf32(vp[i * 16 * kBC + a_lo], a[i].hi[0], a[i].lo[0]);
            split_tf32(vp[i * 16 * kBC + 8 * kBC + a_lo], a[i].hi[1], a[i].lo[1]);
            split_tf32(vp[i * 16 * kBC + a_hi], a[i].hi[2], a[i].lo[2]);
            split_tf32(vp[i * 16 * kBC + 8 * kBC + a_hi], a[i].hi[3], a[i].lo[3]);
          }
          const U* up = ub + p * kBC * ldu;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            FragB bf;
            load_b<C::kBLo>(bf, up + j * 8, ldu);
#pragma unroll
            for (int i = 0; i < kMT; ++i) {
              float part[4] = {0.f, 0.f, 0.f, 0.f};
              mma_tf32x3<C::kBLo>(part, a[i], bf);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[q][i][j][e] += part[e];
            }
          }
        }
      }
      mbar_arrive(&empty[b]);
    }
    // Every consumer is done with the ring; the producer finished with it
    // before the last full[] phase completed.
    named_sync<kBarConsumers, kConsumers>();

    // Spill the accumulators to Y (P, bR, bM + 4) for the inverse transform.
    constexpr int ldy = bM + 4;
    float* s_y = reinterpret_cast<float*>(ws_smem + kBarBytes);
#pragma unroll
    for (int q = 0; q < C::kPts; ++q) {
      const int p = warp + kConsumerWarps * q;
      if (p < P) {
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            float* dst = s_y + (p * bR + i * 16 + g) * ldy + j * 8 + 2 * t;
            *reinterpret_cast<float2*>(dst) = make_float2(acc[q][i][j][0], acc[q][i][j][1]);
            *reinterpret_cast<float2*>(dst + 8 * ldy) =
                make_float2(acc[q][i][j][2], acc[q][i][j][3]);
          }
      }
    }
    named_sync<kBarConsumers, kConsumers>();

    // Inverse transform A_h^T y A_w, epilogue (x scale, + bias,
    // activation), NHWC store (m fastest).
    const int h_out = prm.n_hb * prm.bh * mh;
    const int w_out = prm.n_wb * prm.bw * mw;
    for (int i = tid; i < bR * bM; i += kConsumers) {
      const int m = i % bM, r = i / bM;
      const float* src = s_y + r * ldy + m;
      float o[kM][kM];
#pragma unroll
      for (int ii = 0; ii < kM; ++ii)
#pragma unroll
        for (int j = 0; j < kM; ++j) o[ii][j] = 0.f;
#pragma unroll
      for (int a = 0; a < T; ++a) {
        if (kExact || a < th) {
          float row[kM];
#pragma unroll
          for (int j = 0; j < kM; ++j) row[j] = 0.f;
#pragma unroll
          for (int bb = 0; bb < T; ++bb) {
            if (kExact || bb < tw) {
              const float yv = src[(a * tw + bb) * bR * ldy];
#pragma unroll
              for (int j = 0; j < kM; ++j) row[j] += prm.at_w[j * kMaxT + bb] * yv;
            }
          }
#pragma unroll
          for (int ii = 0; ii < kM; ++ii)
#pragma unroll
            for (int j = 0; j < kM; ++j) o[ii][j] += prm.at_h[ii * kMaxT + a] * row[j];
        }
      }
      const int mg = m_base + m;
      const float sc = prm.scale != nullptr ? prm.scale[mg] : 1.f;
      const float bi = (prm.bias != nullptr && mg < prm.n_bias) ? prm.bias[mg] : 0.f;
      const int oy = row0 + (r >> prm.lbw) * mh;
      const int ox = col0 + (r & (prm.bw - 1)) * mw;
      float* dst = prm.y + (((size_t)img * h_out + oy) * w_out + ox) * prm.mp + mg;
#pragma unroll
      for (int ii = 0; ii < kM; ++ii) {
        if (ii < mh) {
#pragma unroll
          for (int j = 0; j < kM; ++j) {
            if (j < mw) dst[((size_t)ii * w_out + j) * prm.mp] = activate(o[ii][j] * sc + bi, prm.act);
          }
        }
      }
    }
  }
}

// Dynamic shared memory of one block: the mbarriers, then two strip slots,
// two V slots and two filter slots during the C sweep; the (P, bR, bM + 4)
// accumulator spill after it reuses the ring. Must agree with
// core/winograd.py:stream_ws_smem_bytes.
inline size_t smem_bytes(const Params& prm, int br, int bm) {
  const size_t ring = 4 * (2 * (size_t)prm.strip_floats + 2 * (size_t)prm.v_floats) +
                      2 * (size_t)prm.u_bytes;
  const size_t spill = 4 * (size_t)prm.p * br * (bm + 4);
  return kBarBytes + (ring > spill ? ring : spill);
}

// n_img: images.
template <typename U, int T, int kMT, int kNT>
int launch(Params prm, int n_img, cudaStream_t stream) {
  constexpr int bR = 16 * kMT, bM = 8 * kNT;
  const bool exact = prm.th == T && prm.tw == T && prm.mh == T - 2 && prm.mw == T - 2;
  auto kernel = exact ? winograd_ws_kernel<U, T, kMT, kNT, 3>
                      : winograd_ws_kernel<U, T, kMT, kNT, 0>;
  prm.ldu = u_row_bytes(bM, sizeof(U));
  prm.v_floats = prm.p * bR * kBC;
  prm.u_bytes = prm.p * kBC * prm.ldu;
  const size_t smem = smem_bytes(prm, bR, bM);
  if (smem > kSmemMax) return kErrBadBlocking;
  // Raise the kernel's shared-memory cap only when a launch needs more
  // than granted so far: a warmed-up launch then makes no CUDA API call but
  // the launch itself (and can be captured in a CUDA graph).
  static size_t granted[2] = {0, 0};
  if (smem > granted[exact]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted[exact] = smem;
  }
  dim3 grid(n_img * prm.n_hb * prm.n_wb, prm.mp / bM);
  kernel<<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

// t: the transform size (4 or 6, core/winograd.py:winograd_ws_tile).
template <typename U>
int dispatch(const Params& prm, int n_img, int t, int br, int bm, cudaStream_t s) {
  const int mt = br / 16, nt = bm / 8;
  if (br % 16 != 0 || bm % 8 != 0) return kErrBadBlocking;
#define REPRO_WS_CASE(T_, MT_, NT_) \
  if (t == T_ && mt == MT_ && nt == NT_) return launch<U, T_, MT_, NT_>(prm, n_img, s);
  // The menu: must agree with core/winograd.py:WINOGRAD_WS_CONFIGS.
  REPRO_WS_CASE(4, 1, 4) REPRO_WS_CASE(4, 1, 8) REPRO_WS_CASE(4, 2, 4) REPRO_WS_CASE(4, 2, 8)
  REPRO_WS_CASE(6, 1, 2) REPRO_WS_CASE(6, 1, 4) REPRO_WS_CASE(6, 1, 8) REPRO_WS_CASE(6, 2, 4)
#undef REPRO_WS_CASE
  return kErrBadBlocking;
}

}  // namespace ws
}  // namespace
