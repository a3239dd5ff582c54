// Tensor-core pieces of the block-halo attention kernels K1
// (attention_fwd.cu) and K4 (attention_bwd.cu): bf16 mma.sync m16n8k16 with
// f32 accumulators, operands fed by ldmatrix from row-skewed shared memory.
//
// One CTA serves one (window, head): nq = bs^2 queries (64 at block 8) in
// warps of 16 query rows, and the window's nk keys padded to nt 16-key tiles
// (196 -> 208 at halo 3). Padded keys hold zero k_eff and v rows and a -inf
// logit, so they never enter the softmax and add nothing to any product.
// q, do and v arrive by cp.async (zero fill outside the frame and for the
// padded keys); k_eff = round(k + bias), the bias added in f32, either
// through registers on the way to shared memory (K4) or by cp.async and a
// pass over the staged keys in place (K1): each measured the faster for its
// kernel (PERF.md).
//
// Shared layout: bf16 rows of head_ch (hd) values skewed by 8 elements (16
// bytes), so a row stride is hd/2 + 4 words (4 mod 8 for hd a multiple of
// 16): the eight 16-byte row pieces an ldmatrix phase reads fall on distinct
// banks, and so do the 32-bit fragment stores. dl and round(P) sub-chunks
// (K4) are [nq][kSub * 16 + 8] rows of the same kind.
//
// Fragments (PTX ISA, mma.m16n8k16 .bf16; g = lane / 4, c = lane % 4):
//   A (16 x 16, row): a[0] (g, 2c..2c+1), a[1] (g + 8, 2c..), a[2] (g, 2c + 8..),
//                     a[3] (g + 8, 2c + 8..)
//   B (16 x 8, col):  b0 (k 2c..2c+1, n g), b1 (k 2c + 8.., n g)
//   D (16 x 8):       d0, d1 (g, 2c..2c+1), d2, d3 (g + 8, 2c..)
// A logits tile of 16 rows x 16 keys is two D tiles, s[0..3] keys 0-7 and
// s[4..7] keys 8-15; rounded to bf16 and packed in pairs it is the A
// fragment of the next product over those keys (P.v, dl.k_eff) as it stands.
// The values of s[] on row g are s[0, 1, 4, 5], on row g + 8 s[2, 3, 6, 7].
//
// PHT_ATTN_DIAG (bench_attention_tc.py's variants only): 1 puts every
// key-tile count on the pass plan; 2 skips the mma.sync (wrong results); 3
// swaps each kernel's way of staging k_eff; 4 drops the null test of K4's
// staging loop. PHT_ATTN_FWD_CTAS: the CTAs an SM that K1's register budget
// is set for (__launch_bounds__; 3 by default, which its 69 KB of shared
// memory at halo 3 admits).
#pragma once

#include "common.cuh"
#include "sm90_gemm.cuh"  // cp.async with zero fill, smem_u32

#ifndef PHT_ATTN_DIAG
#define PHT_ATTN_DIAG 0
#endif
#ifndef PHT_ATTN_FWD_CTAS
#define PHT_ATTN_FWD_CTAS 3
#endif

namespace pht {
namespace attn {

constexpr int kSkew = 8;      // bf16 elements appended to every shared row
constexpr int kMaxHead = 64;  // the largest head_ch of the tensor-core body
constexpr int kSub = 4;       // key tiles of dl and round(P) staged at once (K4)

// key tiles whose logits (K1) or probabilities (K4) a warp keeps in
// registers; other counts take two (K1) or three (K4) passes over the keys
__host__ __device__ constexpr bool resident_tiles(int nt) {
  return PHT_ATTN_DIAG != 1 &&
         (nt == 3 || nt == 4 || nt == 7 || nt == 9 || nt == 13 || nt == 16);
}

__host__ __device__ inline int key_tiles(int bs, int halo) {
  const int w = bs + 2 * halo;
  return (w * w + 15) / 16;
}

// dynamic shared memory of one CTA: K1 q, k_eff, v; K4 also do and the dl /
// round(P) sub-chunks
inline size_t fwd_smem(int bs, int halo, int hd) {
  const size_t nq = (size_t)bs * bs, np = 16 * (size_t)key_tiles(bs, halo);
  return 2 * (size_t)(hd + kSkew) * (nq + 2 * np);
}
inline size_t bwd_smem(int bs, int halo, int hd) {
  const size_t nq = (size_t)bs * bs, np = 16 * (size_t)key_tiles(bs, halo);
  return 2 * (size_t)(hd + kSkew) * (2 * nq + 2 * np) + 2 * 2 * nq * (kSub * 16 + kSkew);
}

// the shapes the body takes (the wrapper's gate states the same rule)
inline bool admits(int bs, int hd, int C) {
  return hd % 16 == 0 && hd <= kMaxHead && C % 8 == 0 && bs * bs % 16 == 0 && bs * bs <= 64;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_u32(p)));
}

// d += a . b
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
#if PHT_ATTN_DIAG == 2
  asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  return;
#endif
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// one window of the image for one head
struct Win {
  int H, W, C, bs, halo, hd, half, window, nq, nk, nt, ld;
  int b, by, bx, c0, win;
};

__device__ __forceinline__ Win win_geom(int H, int W, int C, int bs, int halo, int heads) {
  Win g;
  g.H = H; g.W = W; g.C = C; g.bs = bs; g.halo = halo;
  g.hd = C / heads;
  g.half = g.hd / 2;
  g.window = bs + 2 * halo;
  g.nq = bs * bs;
  g.nk = g.window * g.window;
  g.nt = (g.nk + 15) / 16;
  g.ld = g.hd + kSkew;
  const int wb = W / bs, hb = H / bs;
  g.win = blockIdx.x;  // (b * hb + by) * wb + bx
  g.bx = g.win % wb;
  g.by = (g.win / wb) % hb;
  g.b = g.win / (wb * hb);
  g.c0 = blockIdx.y * g.hd;
  return g;
}

__device__ __forceinline__ int64_t query_pixel(const Win& g, int i) {
  const int y = g.by * g.bs + i / g.bs, x = g.bx * g.bs + i % g.bs;
  return ((int64_t)g.b * g.H + y) * g.W + x;
}

// dst[i * ld + d] = src at query i, channel c0 + d (cp.async, not committed)
__device__ __forceinline__ void stage_queries(const Win& g, const bf16* src, bf16* dst) {
  const int cpr = g.hd / 8;
  for (int idx = threadIdx.x; idx < g.nq * cpr; idx += blockDim.x) {
    const int i = idx / cpr, d = (idx - i * cpr) * 8;
    sm90::cp_async16(sm90::smem_u32(dst + (size_t)i * g.ld + d),
                     src + query_pixel(g, i) * g.C + g.c0 + d, true);
  }
}

// Keys j < 16 nt of the window into [key][ld] rows (not committed): v by
// cp.async, k_eff = round(k + bias) through registers (the bias added in
// f32) for j < nk; zero rows where the key is outside the frame (k_eff: the
// bias alone) or padded. K4's staging.
__device__ __forceinline__ void stage_keys(const Win& g, const bf16* k, const bf16* v,
                                           const float* rel_h, const float* rel_w, bf16* kd,
                                           bf16* vd) {
  const int cpr = g.hd / 8;
  for (int idx = threadIdx.x; idx < 16 * g.nt * cpr; idx += blockDim.x) {
    const int j = idx / cpr, d = (idx - j * cpr) * 8;
    int64_t off = 0;
    bool inside = false;
    int wy = 0, wx = 0;
    if (j < g.nk) {
      wy = j / g.window;
      wx = j - wy * g.window;
      const int y = g.by * g.bs - g.halo + wy, x = g.bx * g.bs - g.halo + wx;
      inside = y >= 0 && y < g.H && x >= 0 && x < g.W;
      if (inside) off = (((int64_t)g.b * g.H + y) * g.W + x) * g.C + g.c0 + d;
    }
    // vd is never null here; with the test, nvcc emits a smaller K4
    // kernel that runs faster (PERF.md; PHT_ATTN_DIAG 4 drops the test)
#if PHT_ATTN_DIAG == 4
    sm90::cp_async16(sm90::smem_u32(vd + (size_t)j * g.ld + d), v + off, inside);
#else
    if (vd != nullptr) sm90::cp_async16(sm90::smem_u32(vd + (size_t)j * g.ld + d), v + off, inside);
#endif
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (j < g.nk) {
      const uint4 raw = inside ? __ldg(reinterpret_cast<const uint4*>(k + off))
                               : make_uint4(0u, 0u, 0u, 0u);
      const float* bias = d < g.half ? rel_h + wy * g.half + d : rel_w + wx * g.half + d - g.half;
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias) + 1);
      const bf16* kv = reinterpret_cast<const bf16*>(&raw);
      out.x = pack(__bfloat162float(kv[0]) + b0.x, __bfloat162float(kv[1]) + b0.y);
      out.y = pack(__bfloat162float(kv[2]) + b0.z, __bfloat162float(kv[3]) + b0.w);
      out.z = pack(__bfloat162float(kv[4]) + b1.x, __bfloat162float(kv[5]) + b1.y);
      out.w = pack(__bfloat162float(kv[6]) + b1.z, __bfloat162float(kv[7]) + b1.w);
    }
    *reinterpret_cast<uint4*>(kd + (size_t)j * g.ld + d) = out;
  }
}

// the pixel offset of key j's channel d (false: outside the frame or padded)
__device__ __forceinline__ bool key_offset(const Win& g, int j, int d, int64_t& off) {
  off = 0;
  if (j >= g.nk) return false;
  const int wy = j / g.window, wx = j - wy * g.window;
  const int y = g.by * g.bs - g.halo + wy, x = g.bx * g.bs - g.halo + wx;
  if (y < 0 || y >= g.H || x < 0 || x >= g.W) return false;
  off = (((int64_t)g.b * g.H + y) * g.W + x) * g.C + g.c0 + d;
  return true;
}

// K1's staging: as `stage_keys`, but k arrives by cp.async too, and after the
// caller's wait and barrier `add_bias` makes it k_eff in place
__device__ __forceinline__ void stage_keys_async(const Win& g, const bf16* k, const bf16* v,
                                                 bf16* kd, bf16* vd) {
  const int cpr = g.hd / 8;
  for (int idx = threadIdx.x; idx < 16 * g.nt * cpr; idx += blockDim.x) {
    const int j = idx / cpr, d = (idx - j * cpr) * 8;
    int64_t off;
    const bool inside = key_offset(g, j, d, off);
    sm90::cp_async16(sm90::smem_u32(vd + (size_t)j * g.ld + d), v + off, inside);
    sm90::cp_async16(sm90::smem_u32(kd + (size_t)j * g.ld + d), k + off, inside);
  }
}

// k_eff = round(k + bias) in place for the keys j < nk staged by
// `stage_keys_async`, the bias added in f32
__device__ __forceinline__ void add_bias(const Win& g, const float* rel_h, const float* rel_w,
                                         bf16* kd) {
  const int cpr = g.hd / 8;
  for (int idx = threadIdx.x; idx < g.nk * cpr; idx += blockDim.x) {
    const int j = idx / cpr, d = (idx - j * cpr) * 8;
    const int wy = j / g.window, wx = j - wy * g.window;
    const float* bias = d < g.half ? rel_h + wy * g.half + d : rel_w + wx * g.half + d - g.half;
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias) + 1);
    uint4* p = reinterpret_cast<uint4*>(kd + (size_t)j * g.ld + d);
    uint4 v = *p;
    const float2 k0 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
    const float2 k1 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
    const float2 k2 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.z));
    const float2 k3 = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.w));
    *p = make_uint4(pack(k0.x + b0.x, k0.y + b0.y), pack(k1.x + b0.z, k1.y + b0.w),
                    pack(k2.x + b1.x, k2.y + b1.y), pack(k3.x + b1.z, k3.y + b1.w));
  }
}

// the warp's A fragments of rows r0..r0+15 of a [rows][ld] array, over the
// hk = hd / 16 k16 steps of the head
__device__ __forceinline__ void load_rows(uint32_t (&a)[kMaxHead / 16][4], const bf16* s, int ld,
                                          int r0, int hk) {
  const int lane = threadIdx.x & 31;
  const bf16* p = s + (size_t)(r0 + (lane & 15)) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kMaxHead / 16; ++kk)
    if (kk < hk) ldsm_x4(a[kk], p + kk * 16);
}

// out[0..7] = the 16 x 16 tile (the warp's rows) x (keys 16t..16t+15) of
// a . b^T, b a [key][ld] array: q . k_eff^T (logits) or do . v^T (dattn)
__device__ __forceinline__ void rows_dot_keys(const uint32_t (&a)[kMaxHead / 16][4],
                                              const bf16* b, int ld, int t, int hk,
                                              float (&out)[8]) {
  const int lane = threadIdx.x & 31;
  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
  const bf16* p = b + (size_t)(16 * t + (lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kMaxHead / 16; ++kk) {
    if (kk < hk) {
      uint32_t r[4];
      ldsm_x4(r, p + kk * 16);
      mma(c0, a[kk], r[0], r[1]);
      mma(c1, a[kk], r[2], r[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = c0[i];
    out[4 + i] = c1[i];
  }
}

// the logits tile: (q . k_eff^T) * scale, -inf for the padded keys
__device__ __forceinline__ void logits(const uint32_t (&qa)[kMaxHead / 16][4], const bf16* sk,
                                       const Win& g, int t, float scale, float (&s)[8]) {
  rows_dot_keys(qa, sk, g.ld, t, g.hd / 16, s);
  const int key = 16 * t + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    s[i] = key + (i >> 2) * 8 + (i & 1) < g.nk ? s[i] * scale : -INFINITY;
}

// acc[n] += p . b over the 16 rows 16t.. of b, a [row][ld] array whose
// columns are the head's channels (P . v, dl . k_eff, dl^T . q, round(P)^T .
// do); p is the packed A fragment of the warp's 16 rows x those 16 rows, hk
// = hd / 16
__device__ __forceinline__ void times_rows(const uint32_t (&p)[4], const bf16* b, int ld, int t,
                                           int hk, float (&acc)[kMaxHead / 8][4]) {
  const int lane = threadIdx.x & 31;
  const bf16* s = b + (size_t)(16 * t + (lane & 15)) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < kMaxHead / 16; ++np) {
    if (np < hk) {
      uint32_t r[4];
      ldsm_x4_t(r, s + np * 16);
      mma(acc[2 * np], p, r[0], r[1]);
      mma(acc[2 * np + 1], p, r[2], r[3]);
    }
  }
}

// the 16 x 16 tile p (D layout) rounded to bf16 and packed as an A fragment
__device__ __forceinline__ void pack_tile(const float (&p)[8], uint32_t (&a)[4]) {
  a[0] = pack(p[0], p[1]);
  a[1] = pack(p[2], p[3]);
  a[2] = pack(p[4], p[5]);
  a[3] = pack(p[6], p[7]);
}

// The warp's 16 rows of acc * mul, rounded to bf16, written to the query
// pixels through the warp's own rows of `stage` (a [nq][ld] array nothing
// reads any more) in 16-byte stores; with `res`, round(res + that).
__device__ __forceinline__ void store_rows(const Win& g, const float (&acc)[kMaxHead / 8][4],
                                           float mul, bf16* stage, const bf16* res, bf16* out) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kMaxHead / 8; ++n) {
    if (n < g.hd / 8) {
      bf16* o = stage + (size_t)(r0 + (lane >> 2)) * g.ld + 8 * n + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(o) = pack(acc[n][0] * mul, acc[n][1] * mul);
      *reinterpret_cast<uint32_t*>(o + (size_t)8 * g.ld) = pack(acc[n][2] * mul, acc[n][3] * mul);
    }
  }
  __syncwarp();
  const int cpr = g.hd / 8;
  for (int idx = lane; idx < 16 * cpr; idx += 32) {
    const int i = r0 + idx / cpr, d = (idx % cpr) * 8;
    uint4 o = *reinterpret_cast<const uint4*>(stage + (size_t)i * g.ld + d);
    const int64_t off = query_pixel(g, i) * g.C + g.c0 + d;
    if (res != nullptr) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(res + off));
      const __nv_bfloat162* rv = reinterpret_cast<const __nv_bfloat162*>(&r);
      __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(rv[e]), b = __bfloat1622float2(ov[e]);
        ov[e] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
      }
    }
    *reinterpret_cast<uint4*>(out + off) = o;
  }
}

}  // namespace attn
}  // namespace pht
