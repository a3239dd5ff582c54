// Helpers shared by the port's CUDA sources (K1-K6).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace pht {

typedef __nv_bfloat16 bf16;

// the opt-in shared-memory ceiling of one CTA on Hopper (227 KB)
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to T and back (the kernels' rounding points)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

enum PadMode { kZeros = 0, kReflect = 1, kReplicate = 2 };

// Map a tap coordinate into the frame; false for a zero-padding tap.
__device__ __forceinline__ bool pad_index(int& p, int n, int mode) {
  if (p >= 0 && p < n) return true;
  if (mode == kZeros) return false;
  if (mode == kReflect) p = p < 0 ? -p : 2 * n - 2 - p;
  else p = p < 0 ? 0 : n - 1;
  return true;
}

}  // namespace pht
