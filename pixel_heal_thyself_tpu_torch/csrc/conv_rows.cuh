// One thread's walk down the rows of a causal depthwise conv window, N
// channels at a time: the row loop of K10's vec body and of the vec bodies
// of K9 (conv_silu.cu) and of K7's prologue (ssd_chain.cuh).
//
// A thread owns N consecutive channels (N * sizeof(T) bytes of a row: 8 of
// bf16 or 16 of f32 at N = 4) and walks rows [t0, t1) of one sequence. Row t
// of its channels sits at src + t * ld. The rows reach it through its own
// slots of a cp.async ring in shared memory (R slots, `stride` Raw words
// apart; a thread reads back only what it copied, so no barrier is needed),
// R - 1 rows ahead of the row it computes. The k - 1 raw rows before the
// current one stay in registers: the loop runs in rounds of K rows, so the
// register slot of each is known at compile time (slot (t - t0) % K holds
// row t) and nothing is moved from slot to slot.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "sm90_gemm.cuh"  // cp.async

namespace pht {
namespace rows {

// The CTA of a vec body: whole warps, at most 8, that leave the fewest of
// the channel groups' threads idle (the most warps among equals; 96 threads
// for the 288 groups of width 1152).
inline int cta_threads(int groups) {
  int best = 256, idle = -1;
  for (int nt = 256; nt >= 64; nt -= 32) {
    const int waste = (groups + nt - 1) / nt * nt - groups;
    if (idle < 0 || waste < idle) {
      best = nt;
      idle = waste;
    }
  }
  return best;
}

// N values of T as they sit in memory, as floats, and back (rounded to
// nearest even)
template <typename T, int N>
struct Vec {
  static constexpr int kBytes = N * sizeof(T);
  using Raw = std::conditional_t<kBytes == 16, uint4,
                                 std::conditional_t<kBytes == 8, uint2, uint32_t>>;
  __device__ static void get(const Raw& w, float (&f)[N]) {
    const T* v = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(v[i]);
  }
  __device__ static Raw put(const float (&f)[N]) {
    Raw w;
    T* v = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = from_f32<T>(f[i]);
    return w;
  }
  // an asynchronous copy of one row's N values into a ring slot (zeros
  // unless `valid`)
  __device__ static void copy(Raw* dst, const void* src, bool valid) {
    if constexpr (kBytes == 16) {
      sm90::cp_async16(sm90::smem_u32(dst), src, valid);
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(sm90::smem_u32(dst)),
                   "l"(src), "n"(kBytes), "r"(valid ? kBytes : 0)
                   : "memory");
    }
  }
};

// N taps of each of K rows of a [K, C] f32 tensor and the N biases of b [C]
// at channel ch (16-byte aligned rows: C and ch multiples of 4 at N = 4)
template <int N, int K>
__device__ __forceinline__ void load_taps(const float* w, const float* b, long C, int ch,
                                          float (&taps)[K][N], float (&bias)[N]) {
#pragma unroll
  for (int j = 0; j <= K; ++j)
#pragma unroll
    for (int c = 0; c < N; c += 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>((j < K ? w + j * C : b) + ch + c));
      float* dst = j < K ? taps[j] : bias;
      dst[c] = v.x;
      dst[c + 1] = v.y;
    }
}

// Calls row(t, xr, win) for t = t0 .. t1 - 1 in order: xr[c] the raw value
// of row t, win[j][c] that of row t - (K - 1) + j (zero before row 0).
template <typename T, int N, int K, int R, typename F>
__device__ __forceinline__ void walk(const T* src, long ld, int t0, int t1,
                                     typename Vec<T, N>::Raw* ring, int stride, F&& row) {
  using V = Vec<T, N>;
  using Raw = typename V::Raw;
  auto issue = [&](int t) {  // row t into its slot; zeros past t1
    const bool in = t < t1;
    V::copy(ring + (size_t)((unsigned)(t - t0) % R) * stride, src + (long)(in ? t : t0) * ld, in);
  };
#pragma unroll
  for (int i = 0; i < R - 1; ++i) {
    issue(t0 + i);
    sm90::cp_async_commit();
  }
  // raw[s]: the raw row in register slot s; rows t0 - K + 1 .. t0 - 1 sit in
  // slots 1 .. K - 1
  float raw[K][N];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int t = t0 - K + s;
    float f[N] = {};
    if (s > 0 && t >= 0) V::get(*reinterpret_cast<const Raw*>(src + (long)t * ld), f);
#pragma unroll
    for (int c = 0; c < N; ++c) raw[s][c] = f[c];
  }
  for (int tr = t0; tr < t1; tr += K) {
#pragma unroll
    for (int ph = 0; ph < K; ++ph) {  // row t, register slot ph
      const int t = tr + ph;
      if (t >= t1) break;
      issue(t + R - 1);
      sm90::cp_async_commit();
      sm90::cp_async_wait<R - 1>();
      float xr[N], win[K][N];  // win[K - 1] unused (K = 1 needs no empty array)
      V::get(ring[(size_t)((unsigned)(t - t0) % R) * stride], xr);
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int c = 0; c < N; ++c) win[j][c] = raw[(ph + 1 + j) % K][c];
      row(t, xr, win);
#pragma unroll
      for (int c = 0; c < N; ++c) raw[ph][c] = xr[c];
    }
  }
  sm90::cp_async_wait<0>();
}

}  // namespace rows
}  // namespace pht
