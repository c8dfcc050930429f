// Device helpers shared by every kernel under csrc/: the filter widening
// and the fused epilogue's activations. Each source includes what it needs
// and exports its own C entry points; the libraries share no state.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// These must agree with repro_torch/kernels/runtime.py:ACTIVATIONS and the
// wrappers' dtype tables.
enum Activation { kNone = 0, kRelu = 1, kRelu6 = 2, kGelu = 3 };
enum UType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(v, 0.f);
    case kRelu6:
      return fminf(fmaxf(v, 0.f), 6.f);
    case kGelu: {
      // tanh form, as jax.nn.gelu and F.gelu(approximate="tanh")
      const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(k0 * (v + 0.044715f * v * v * v)));
    }
    default:
      return v;
  }
}

}  // namespace
