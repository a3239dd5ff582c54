// The float32 body of the block-halo attention kernels K1 (attention_fwd.cu,
// `attention_fwd_f32_kernel`) and K4 (attention_bwd.cu,
// `attention_bwd_f32_kernel`): every window product in true f32 FMAs, as the
// TPU kernels take float32 at HIGHEST precision
// (pixel_heal_thyself_tpu/ops/attention_pallas.py:251); no tensor cores.
//
// What bounds it: a (window, head) at the prod shape (64 queries, 196 keys,
// head_ch 64) is 2 (K1) or 5 (K4) products of 64 x 196 x 64 multiply-adds,
// 0.39 / 0.98 ms of the H100's 67 TFLOP/s f32 rate over the 8,192 items of a
// call, against 0.14 ms for its bytes. So the FMA pipe should set the pace,
// which it does only if the operands reach it: an SM issues 4 warp-FMAs a
// clock but serves one 128-byte wavefront of shared memory a clock, and a
// warp's 16-byte load takes four, whatever its lanes share. So a lane must
// do at least 16 FMAs per 16-byte shared load, and the SM needs work to
// hide each phase's latency: at one CTA an SM, staging, the softmax and the
// reductions of a window stand alone (measured: K1 spent 1.0 of 2.9 ms
// there, PERF.md).
//
// The design. Warps of 16 query rows; a lane = 8 lr + lk holds the rows r,
// r + 4, r + 8, r + 12 (r = 16 g + lr of row group g) and the key slots lk
// + 8t (t < T) of its chunk of keys: 4 x T logits. Staged rows are f32 with
// a stride of 68 words (4 mod 32), so the 8 keys a warp reads at once sit
// on distinct banks and the 4 rows of a quarter-warp are one broadcast.
//   - q . k_eff^T and do . v^T (over the channels): per 4 channels a lane
//     loads its 4 q rows and T key rows as float4 and does 16 T FMAs (T =
//     13: 208 FMAs per 17 loads).
//   - the softmax: row max and sum over the lane's slots, then over the 8
//     lanes (shuffles) and, in K4, the two warps that split a row's keys
//     (through shared memory, in a fixed order); online over chunks.
//   - dl . k_eff (over the keys, which a row's lanes split): per pass of 8
//     channels each lane sums its slots' products (32 FMAs per two float4
//     loads) and the 8 lanes reduce-scatter them (shuffles xor 4, 2, 1),
//     leaving lane lk the full sum of channel 8 p + lk of its 4 rows, kept
//     in registers across chunks. K1's P . v instead sums each value in key
//     order (attention_fwd.cu says why): P goes to shared memory as
//     [key][row] and a thread takes 4 rows x 8 channels (32 FMAs per three
//     float4 loads a key).
//   - K4's dl^T . q and P^T . do (over the queries): P and dl go to shared
//     memory as [row][slot] (P over v's rows), and each thread takes one
//     tile of 8 keys x 8 channels of both (128 FMAs per eight float4 loads
//     a row), writing the f32 window partials the gather then sums.
// Staging walks the window's keys without a division a key; K4's values
// arrive while its logits and statistics are computed.
// K1 takes 4 warps (block 8) and chunks of up to 104 keys (the prod window:
// two, both held in registers; 74 KB of shared memory, three CTAs an SM).
// K4 takes 8 warps, two a row
// group each with half of a chunk of up to 208 keys (the prod window: one
// chunk, so one pass; 218 KB of shared memory, one CTA an SM); windows of
// more keys take three passes over their chunks (the statistics, D, the
// gradients). The slot count is a compile-time constant where a window's
// chunks hold 13 slots a lane (the prod shape), a runtime bound elsewhere.
// In fp32 nothing is rounded (round_T is the identity), so this is the plain
// function with only the f32 summation order changed; the forward divides
// P . v by the row sum at the end instead of P before it.
//
// PHT_F32_DIAG (bench_attention_f32.py's variants only; wrong results but
// for 0 and 4): 1 skips the products that contract over the keys (K1's P.v,
// K4's dl.k_eff) and K4's dl^T.q and P^T.do tiles; 2 skips the products
// that contract over the channels (q.k_eff^T, do.v^T); 3 skips both; 4
// launches the runtime-slot kernel where the compile-time one would run.
// PHT_F32_FWD_CTAS: the CTAs an SM that K1's register budget is set for
// (__launch_bounds__; 3 by default, which its 74 KB at the prod shape admit).
#pragma once

#ifndef PHT_F32_DIAG
#define PHT_F32_DIAG 0
#endif
#ifndef PHT_F32_FWD_CTAS
#define PHT_F32_FWD_CTAS 3
#endif

#include "attention_tc.cuh"  // attn::Win, win_geom, query_pixel, key_offset
#include "common.cuh"
#include "sm90_gemm.cuh"     // cp.async with zero fill, smem_u32

namespace pht {
namespace f32a {

constexpr int kLd = 68;        // floats a staged row: head_ch <= 64, plus 4
constexpr int kMaxHead = 64;
constexpr int kRows = 4;       // query rows a lane holds
constexpr int kLanes = 8;      // lanes of a row group, which split the keys
constexpr int kMaxSlots = 13;  // key slots a lane holds
constexpr int kFastSlots = 13; // the slot count compiled as a constant
constexpr int kPass = 8;       // channels of one pass over the keys
constexpr unsigned kFull = 0xffffffffu;

// a window's key chunks and the slots a lane holds, for K1 (halves 1: a
// row's 8 lanes hold a chunk) and K4 (halves 2: two warps do)
__host__ __device__ inline int chunks(int nk, int halves) {
  const int cap = kLanes * kMaxSlots * halves;
  return (nk + cap - 1) / cap;
}
__host__ __device__ inline int slots(int nk, int halves) {
  const int c = chunks(nk, halves), per = (nk + c - 1) / c;
  return (per + kLanes * halves - 1) / (kLanes * halves);
}

inline int window_keys(int bs, int halo) { return (bs + 2 * halo) * (bs + 2 * halo); }

// dynamic shared memory of one CTA. K1: q, k_eff, v rows. K4: q, do, k_eff
// and v rows, the [row][slot] dl (P takes v's rows), dq's exchange rows and
// the row statistics' [half][3][row] exchange.
inline size_t fwd_smem(int bs, int halo) {
  const size_t nq = (size_t)bs * bs, ck = kLanes * (size_t)slots(window_keys(bs, halo), 1);
  return sizeof(float) * kLd * (nq + 2 * ck);
}
inline size_t bwd_smem(int bs, int halo) {
  const size_t nq = (size_t)bs * bs, ck = 2 * kLanes * (size_t)slots(window_keys(bs, halo), 2);
  return sizeof(float) * (kLd * (3 * nq + 2 * ck) + nq * ck + 6 * nq);
}

// the shapes the body takes (the wrapper's gate states the same rule)
inline bool admits(int bs, int halo, int hd, int C) {
  return hd % 4 == 0 && hd <= kMaxHead && C % 4 == 0 && (bs == 4 || bs == 8) && halo >= 1 &&
         halo <= bs;
}

__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 4));
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v + __shfl_xor_sync(kFull, v, 4);
}

// dst[i * kLd + d] = src at query i, channels c0 + d (cp.async, not committed)
__device__ __forceinline__ void stage_queries(const attn::Win& g, const float* src, float* dst) {
  const int cpr = g.hd / 4;
  for (int idx = threadIdx.x; idx < g.nq * cpr; idx += blockDim.x) {
    const int i = idx / cpr, d = (idx - i * cpr) * 4;
    sm90::cp_async16(sm90::smem_u32(dst + i * kLd + d),
                     src + attn::query_pixel(g, i) * g.C + g.c0 + d, true);
  }
}

// the window position (wy, wx) of key j, walked forward by a fixed number of
// keys a step without a division a step
struct KeyWalk {
  int wy, wx, dy, dx;
  __device__ __forceinline__ KeyWalk(const attn::Win& g, int j, int step) {
    wy = j / g.window;
    wx = j - wy * g.window;
    dy = step / g.window;
    dx = step - dy * g.window;
  }
  __device__ __forceinline__ void next(const attn::Win& g) {
    wy += dy;
    wx += dx;
    if (wx >= g.window) {
      wx -= g.window;
      ++wy;
    }
  }
};

// keys j0 .. j0 + ck - 1 of the window into rows [ck][kLd] (cp.async, not
// committed): zero where the key lies outside the frame or past nk. Where
// the CTA's threads cover whole rows, each thread keeps one float4 column
// and walks the keys.
__device__ __forceinline__ void stage_keys(const attn::Win& g, const float* src, int j0, int ck,
                                           float* dst) {
  const int cpr = g.hd / 4;
  if (blockDim.x % cpr == 0) {
    const int step = blockDim.x / cpr, d = (threadIdx.x % cpr) * 4;
    const int y0 = g.by * g.bs - g.halo, x0 = g.bx * g.bs - g.halo;
    const float* base = src + (int64_t)g.b * g.H * g.W * g.C + g.c0 + d;
    int jj = threadIdx.x / cpr;
    for (KeyWalk w(g, j0 + jj, step); jj < ck; jj += step, w.next(g)) {
      const int y = y0 + w.wy, x = x0 + w.wx;
      const bool inside = j0 + jj < g.nk && y >= 0 && y < g.H && x >= 0 && x < g.W;
      sm90::cp_async16(sm90::smem_u32(dst + jj * kLd + d),
                       inside ? base + ((int64_t)y * g.W + x) * g.C : src, inside);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ck * cpr; idx += blockDim.x) {
    const int jj = idx / cpr, d = (idx - jj * cpr) * 4;
    int64_t off;
    const bool inside = attn::key_offset(g, j0 + jj, d, off);
    sm90::cp_async16(sm90::smem_u32(dst + jj * kLd + d), src + off, inside);
  }
}

// k_eff = k + bias in place for the staged keys j0 + jj < nk (the rel_h row
// on the first half of the channels, the rel_w column on the second); the
// bias as float4 where each half's channels come in fours
__device__ __forceinline__ void add_bias(const attn::Win& g, const float* rel_h,
                                         const float* rel_w, int j0, int ck, float* kd) {
  const int n = min(ck, g.nk - j0), cpr = g.hd / 4;
  if (blockDim.x % cpr == 0 && g.half % 4 == 0) {
    const int step = blockDim.x / cpr, d = (threadIdx.x % cpr) * 4;
    const bool first = d < g.half;
    const float* bias = first ? rel_h + d : rel_w + d - g.half;
    int jj = threadIdx.x / cpr;
    for (KeyWalk w(g, j0 + jj, step); jj < n; jj += step, w.next(g)) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(bias + (first ? w.wy : w.wx) * g.half));
      float4* p = reinterpret_cast<float4*>(kd + jj * kLd + d);
      float4 kv = *p;
      kv.x += b.x;
      kv.y += b.y;
      kv.z += b.z;
      kv.w += b.w;
      *p = kv;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < n * cpr; idx += blockDim.x) {
    const int jj = idx / cpr, d = (idx - jj * cpr) * 4;
    const int j = j0 + jj, wy = j / g.window, wx = j - wy * g.window;
    float b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      b[e] = d + e < g.half ? __ldg(rel_h + wy * g.half + d + e)
                            : __ldg(rel_w + wx * g.half + d + e - g.half);
    float4* p = reinterpret_cast<float4*>(kd + jj * kLd + d);
    float4 kv = *p;
    kv.x += b[0];
    kv.y += b[1];
    kv.z += b[2];
    kv.w += b[3];
    *p = kv;
  }
}

// the slots t < T a loop runs: TC when the kernel has it as a constant
template <int TC>
__device__ __forceinline__ bool live(int t, int T) {
  return TC > 0 ? t < TC : t < T;
}

// s[i][OFF + t] = (a_{r + 4i} . b_t) * mul for the lane's slots t (b_t the
// row 8t of b, which the caller points at the lane's first slot), over the hd
// channels of a [rows][kLd] and a [slots][kLd] array: one FMA chain a logit,
// channels in order from 0 (the order of a plain f32 matrix product)
template <int TC, int OFF = 0, int N>
__device__ __forceinline__ void dots(const float* a, const float* b, int r, int T, int hd,
                                     float mul, float (&s)[kRows][N]) {
  static_assert(OFF + kMaxSlots <= N, "slots past the array");
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int t = 0; t < kMaxSlots; ++t) s[i][OFF + t] = 0.f;
#if PHT_F32_DIAG == 2 || PHT_F32_DIAG == 3
  s[0][OFF] = a[r * kLd] * b[0] * mul;
  return;
#endif
  const float* ar = a + r * kLd;
#pragma unroll 2
  for (int d = 0; d < hd; d += 4) {
    float4 x[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) x[i] = *reinterpret_cast<const float4*>(ar + 4 * i * kLd + d);
#pragma unroll
    for (int t = 0; t < kMaxSlots; ++t) {
      if (live<TC>(t, T)) {
        const float4 y = *reinterpret_cast<const float4*>(b + 8 * t * kLd + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float& acc = s[i][OFF + t];
          acc = fmaf(x[i].x, y.x, acc);
          acc = fmaf(x[i].y, y.y, acc);
          acc = fmaf(x[i].z, y.z, acc);
          acc = fmaf(x[i].w, y.w, acc);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int t = 0; t < kMaxSlots; ++t) s[i][OFF + t] *= mul;
}

// the logits s[.][OFF + t] of the lane's slots lk + 8t past the chunk's
// first n, and of slots t >= T, to -inf
template <int TC, int OFF = 0, int N>
__device__ __forceinline__ void mask_slots(int lk, int T, int n, float (&s)[kRows][N]) {
#pragma unroll
  for (int t = 0; t < kMaxSlots; ++t)
    if (!live<TC>(t, T) || lk + 8 * t >= n)
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i][OFF + t] = -INFINITY;
}

// the largest logit of each row over the lane's slots and its 8 lanes
template <int TC>
__device__ __forceinline__ void row_max(const float (&s)[kRows][kMaxSlots], int T,
                                        float (&out)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float v = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxSlots; ++t)
      if (live<TC>(t, T)) v = fmaxf(v, s[i][t]);
    out[i] = group_max(v);
  }
}

// s = exp(s - m) in place for the lane's slots, and out the sum of that per
// row over the lane's slots and its 8 lanes
template <int TC>
__device__ __forceinline__ void exp_rows(float (&s)[kRows][kMaxSlots], int T,
                                         const float (&m)[kRows], float (&out)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float v = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxSlots; ++t) {
      if (live<TC>(t, T)) {
        s[i][t] = expf(s[i][t] - m[i]);
        v += s[i][t];
      }
    }
    out[i] = group_sum(v);
  }
}

// acc[i][e] = sum over the lane's slots t of p[i][t] * b_t[d0 + e], e < 8 (b_t
// the row 8t of b, pointed at the lane's first slot; channels >= hd stay 0)
template <int TC>
__device__ __forceinline__ void times_keys(const float (&p)[kRows][kMaxSlots], const float* b,
                                           int T, int d0, int hd, float (&acc)[kRows][kPass]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int e = 0; e < kPass; ++e) acc[i][e] = 0.f;
#if PHT_F32_DIAG == 1 || PHT_F32_DIAG == 3
  acc[0][0] = p[0][0] * b[d0];
  return;
#endif
  const bool two = d0 + 4 < hd;  // the pass's second float4 of channels
#pragma unroll
  for (int t = 0; t < kMaxSlots; ++t) {
    if (live<TC>(t, T)) {
      const float* row = b + 8 * t * kLd + d0;
      const float4 y0 = *reinterpret_cast<const float4*>(row);
      const float4 y1 = two ? *reinterpret_cast<const float4*>(row + 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      const float y[kPass] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int e = 0; e < kPass; ++e) acc[i][e] = fmaf(p[i][t], y[e], acc[i][e]);
    }
  }
}

// the sums of acc over the 8 lanes of the row group (lanes xor 4, 2, 1),
// scattered: lane lk gets channel lk of the pass of each row in out[i]
__device__ __forceinline__ void reduce_scatter(float (&acc)[kRows][kPass], int lk,
                                               float (&out)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int level = 0; level < 3; ++level) {
      const int w = 4 >> level;  // the width kept, and the partner lane's distance
      const bool upper = lk & w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < w) {
          const float keep = upper ? acc[i][w + e] : acc[i][e];
          const float send = upper ? acc[i][e] : acc[i][w + e];
          acc[i][e] = keep + __shfl_xor_sync(kFull, send, w);
        }
      }
    }
    out[i] = acc[i][0];
  }
}

}  // namespace f32a
}  // namespace pht
