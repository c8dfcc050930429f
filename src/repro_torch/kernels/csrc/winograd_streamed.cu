// Halo-streaming region-wise Winograd / Cook-Toom convolution at stride 1,
// for Hopper, with the point-GEMMs on the tensor cores (TF32x3).
//
// Replaces repro/kernels/winograd.py:winograd_streamed (the Pallas TPU
// kernel). Same function on the same operands: the padded NHWC fp32 input
// xp (N, Hp, Wp, Cp), the Winograd-domain filter u (P, Cp, Mp) in fp32,
// bf16 or int8, an optional bias (at most Mp entries) and an optional int8
// dequantization scale row (Mp) -> the NHWC output
// (N, nHb*bh*mh, nWb*bw*mw, Mp). One kernel fuses the strip load, the
// input transform B^T d B, the P point-GEMMs with fp32 accumulation, the
// inverse transform A^T y A and the epilogue (x scale, + bias, activation,
// in that order). Nothing but the input, the filter and the output lives
// in device memory.
//
// What bounds it: the point-GEMMs' operations (VGG-16's F(4x4, 3x3)
// layers do ~8 GFLOP of them per image), the input transform that every M
// block repeats (3 / bM of the direct convolution's multiply-adds per
// output), and the filter chunks every block streams from L2 ((P, 8, bM)
// per C step). The shared body (winograd_tc.cuh) ran the transform and the
// GEMMs on the same warps, one after the other: its T x T transform arrays
// and its accumulators shared a thread's registers, which held bM to 16 at
// two blocks an SM, and the tensor cores waited while the transform ran.
// Measured on an H100 (PERF.md), a C step of this body costs about 1.2 us
// plus its staged bytes and its busiest consumer warp's products
// (core/winograd.py:WS_COST); the producer's transform hides under them,
// and the staging alone streams filter chunks from L2 at ~5.5 TB/s
// across the card. The design
// (winograd_ws.cuh), one 384-thread block an SM:
//  * roles: a producer warpgroup (warps 8-11) cp.asyncs each C step's
//    strip ((bh*mh + th - mh) x (bw*mw + tw - mw) pixels of 8 channels, so
//    neighbouring tiles share their halo) and raw (P, 8, bM) filter chunk,
//    and runs the input transform, one (tile, channel) a thread, from the
//    staged strip into V (P, bR, 8); two consumer warpgroups (warps 0-7)
//    own whole Winograd points (p = warp + 8q) and run V[p] x U[p] on
//    mma.sync m16n8k8 in TF32x3 (mma_tf32x3.cuh), two products instead of
//    three where the filter was widened from bf16 or int8 (exact in TF32);
//  * the ring: two strip slots (the producer's own, behind a named
//    barrier), two V slots and two filter slots, each V / filter pair with
//    a "full" mbarrier (128 transform arrivals and 128 arrivals that the
//    producer's filter cp.asyncs trigger as they land) and an "empty" one
//    (256 consumer arrivals). The producer transforms step s + 1 while the
//    consumers multiply step s - 1, and loads the filter of step s + 1 while
//    they multiply step s; no __syncthreads in the C sweep;
//  * registers: setmaxnreg gives the producer 72 a thread and the
//    consumers 216 (128 x 72 + 256 x 216 = 384 x 168, the launch bounds'),
//    so a consumer holds ceil(T^2 / 8) * kMT * kNT * 4 accumulators and no
//    transform arrays: bM 64 (kNT 8, 160 accumulators) at T = 6, where the
//    shared body stopped at 16, and bR 32 at bM 32;
//  * each C step's products sum into a zeroed fragment that joins the
//    running accumulator with an fp32 add (the tensor cores round toward
//    zero): the shared body's rounding, with C steps of 8 channels;
//  * after the C sweep the consumers spill the accumulators to shared
//    memory (reusing the ring) and run the inverse transform and the
//    epilogue; a bf16 / int8 filter is widened as its fragment is read and
//    the int8 scale applied in the epilogue, before the bias.
//
// How the TPU design translates: the Pallas grid ran the C reduction
// innermost and sequentially, carrying the accumulator across grid steps;
// here every block loops over all of C itself, in a fixed order (no
// atomics), with the accumulators in registers. The Pallas kernel reused
// each transformed strip across its sequential M sweep; parallel M blocks
// cannot share it, so each recomputes the transform of its strip, O(t)
// work per point against the GEMM's O(bM): the wider M block divides it.
// Edge blocks: the caller pads the input to whole tile blocks and crops
// the surplus outputs afterwards, as the reference does.
//
// Blocking (core/winograd.py:stream_geometry_tf32x3): a block holds
// bR = 16*kMT tiles (bh x bw) and bM = 8*kNT output channels. Tiles up to
// 6 x 6 run this body (T 4 or 6; F(2, 3) and F(4, 3) guard-free), its
// (T, kMT, kNT) menu WINOGRAD_WS_CONFIGS; 7 x 7 and 8 x 8 tiles, whose
// T x T arrays leave the producer's register share no room, run the
// shared body at T = 8 (winograd_tc.cuh, its (1, 2) blocking), which the
// stride-2 kernel (winograd_strided_streamed.cu) and the tiles-domain one
// (winograd_fused.cu) also run. core/winograd.py:stream_body is the rule.

#include "winograd_tc.cuh"
#include "winograd_ws.cuh"

namespace {

// The fields both stride-1 bodies' Params share, from the entry point's
// operands (already validated).
template <typename Prm>
void fill_common(Prm& prm, const float* xp, const void* u, const float* bias, int n_bias,
                 const float* scale, float* y, int hp, int wp, int cp, int mp, int th,
                 int tw, int mh, int mw, int bh, int bw, int activation, const float* mats) {
  prm.x = xp;
  prm.u = u;
  prm.bias = bias;
  prm.scale = scale;
  prm.y = y;
  prm.n_bias = n_bias;
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
  prm.n_hb = (hp - (th - mh)) / (bh * mh);
  prm.n_wb = (wp - (tw - mw)) / (bw * mw);
  prm.sh = bh * mh + th - mh;
  prm.sw = bw * mw + tw - mw;
  prm.sw_magic = (unsigned)((0x100000000ull + prm.sw - 1) / prm.sw);
  prm.lbw = 0;
  while ((1 << prm.lbw) < bw) ++prm.lbw;
  prm.act = activation;
  for (int i = 0; i < kMaxT * kMaxT; ++i) {
    prm.bt_h[i] = mats[i];
    prm.bt_w[i] = mats[64 + i];
    prm.at_h[i] = mats[128 + i];
    prm.at_w[i] = mats[192 + i];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. Returns 0, a CUDA error code (> 0), or a negative
// validation code; winograd_streamed_error names each. `mats` is a host
// array of 4 x 64 floats: B_h^T, B_w^T, A_h^T, A_w^T, row-major, each
// zero-padded to 8 x 8. The input is padded so that hp = n_hb*bh*mh +
// th - mh, and likewise wp; cp is a multiple of bc, mp of bm; xp and u are
// 16-byte aligned. Tiles up to 6 x 6 run the warp-specialised body
// (winograd_ws.cuh: bc 8), larger ones winograd_tc.cuh's at T = 8 (its
// (1, 2) blocking, bc 8, 16 or 32): core/winograd.py:stream_body.
int winograd_streamed_launch(const float* xp, const void* u, int u_type,
                             const float* bias, int n_bias, const float* scale,
                             float* y, int n, int hp, int wp, int cp, int mp,
                             int th, int tw, int mh, int mw, int bh, int bw,
                             int bc, int bm, int activation, const float* mats,
                             void* stream) {
  if (n < 1 || activation < kNone || activation > kGelu || bh < 1 || bw < 1 ||
      th < 2 || tw < 2 || th > kMaxT || tw > kMaxT || mh < 1 || mw < 1 ||
      mh >= th || mw >= tw)
    return kErrBadShape;
  const int halo_h = th - mh, halo_w = tw - mw;
  if (hp <= halo_h || wp <= halo_w || (hp - halo_h) % (bh * mh) != 0 ||
      (wp - halo_w) % (bw * mw) != 0)
    return kErrBadShape;
  if ((bc != 8 && bc != 16 && bc != 32) || cp < bc || cp % bc != 0 || bm < 8 ||
      mp % bm != 0 || (bw & (bw - 1)) != 0)
    return kErrBadBlocking;
  if (reinterpret_cast<uintptr_t>(xp) % 16 != 0 || reinterpret_cast<uintptr_t>(u) % 16 != 0)
    return kErrBadAlign;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tmax = th > tw ? th : tw;
  if (tmax <= 6) {
    if (bc != ws::kBC) return kErrBadBlocking;
    ws::Params prm{};
    fill_common(prm, xp, u, bias, n_bias, scale, y, hp, wp, cp, mp, th, tw, mh, mw, bh,
                bw, activation, mats);
    prm.strip_floats = prm.sh * prm.sw * ws::kBC;
    const int t = tmax <= 4 ? 4 : 6;
    switch (u_type) {
      case kF32:
        return ws::dispatch<float>(prm, n, t, bh * bw, bm, s);
      case kBF16:
        return ws::dispatch<__nv_bfloat16>(prm, n, t, bh * bw, bm, s);
      case kI8:
        return ws::dispatch<int8_t>(prm, n, t, bh * bw, bm, s);
      default:
        return kErrBadType;
    }
  }
  // 7 x 7 and 8 x 8 tiles: the shared body at T = 8
  if (bh * bw != 16 || bm != 16) return kErrBadBlocking;
  Params prm{};
  fill_common(prm, xp, u, bias, n_bias, scale, y, hp, wp, cp, mp, th, tw, mh, mw, bh, bw,
              activation, mats);
  prm.bc = bc;
  prm.lbc = bc == 8 ? 3 : bc == 16 ? 4 : 5;
  prm.ldc = bc + 4;
  prm.strip_floats = prm.sh * prm.sw * prm.ldc;
  switch (u_type) {
    case kF32:
      return launch<float, 8, 1, 2, 1, false>(prm, n, s);
    case kBF16:
      return launch<__nv_bfloat16, 8, 1, 2, 1, false>(prm, n, s);
    case kI8:
      return launch<int8_t, 8, 1, 2, 1, false>(prm, n, s);
    default:
      return kErrBadType;
  }
}

const char* winograd_streamed_error(int code) { return tc_error(code); }

}  // extern "C"
