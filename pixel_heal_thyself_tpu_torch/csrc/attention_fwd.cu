// Block-halo attention forward (kernel K1 of the PyTorch port).
//
// Replaces the TPU kernel `_fwd_kernel` in
// pixel_heal_thyself_tpu/ops/attention_pallas.py:217 (launched by
// `_attention_fwd`, :325, pallas_call :347) and the attention stage
// `_attention_block_row` that the whole-block kernel
// pixel_heal_thyself_tpu/ops/block_mega.py:285 embeds verbatim.
//
// What it computes, per (batch, block-row, block-col, head): the bs x bs
// query block attends to the (bs + 2 halo)^2 key/value window centred on it.
//   k_eff = round_T(k + bias)    bias = rel_h[row] on the first half of the
//                                head's channels, rel_w[col] on the second,
//                                added in f32
//   logits = (q . k_eff) * head_ch^-0.5      f32
//   p = round_T(softmax(logits))             f32 softmax
//   out = round_T(p . v)                     f32 accumulation
//   out = round_T(residual + out)            when a residual is given
// A key or value outside the frame is a ZERO vector that still gets the
// rel bias and takes part in the softmax; nothing is masked. T is bf16 or
// f32; every product is exact in f32 and summed in f32 (no TF32).
//
// Layout: q, k, v, residual, out are unpadded NHWC [B, H, W, C], head h
// owning channels [h*hd, (h+1)*hd). The TPU kernel's W-halo-padded layout
// existed only for sublane alignment and is not needed here.
//
// Three bodies. The tensor-core body (`attention_fwd_tc_kernel`, bf16, head_ch
// a multiple of 16 up to 64, block 4 or 8; the prod shape) is what the
// H100 runs. At the prod shape a (window, head) does 2 x 64 x 196 x 64
// multiply-adds against 58 KB of bf16 operands, most of them re-read from
// L2 by the neighbouring windows: 0.03 ms of the card's bf16 tensor-core
// rate over 8,192 items, under the 0.08 ms that the call's bytes take. What
// bounds it is latency: each CTA stages its window, then runs a chain of
// dependent mma.sync, shuffles, exps and divisions, with only the other
// CTAs on its SM to hide either. The design keeps that chain short and the
// SM full: one CTA per (window, head), 4 warps of 16 query rows; q, k and v
// arrive by cp.async into row-skewed shared memory (69 KB at halo 3) and
// one pass adds the bias to k in place (faster than loading k through
// registers, PERF.md); q.k_eff^T runs on mma.sync m16n8k16 into
// registers (16 x 208 f32, 104 a thread at halo 3), the softmax on those
// registers with quad shuffles, and the rounded probabilities are packed in
// place into the A fragments of P.v; the output leaves through the warp's
// own shared rows in 16-byte stores, the residual added there. Registers
// are budgeted for three CTAs an SM (168; 255 for two ran 35% slower, no
// spills either way). Key-tile counts other than 3, 4, 7, 9, 13 and 16
// (halo >= 5 at block 8) take the same body in two passes over the key
// tiles: the exact row max and sum (online over tiles), then the logits
// again, the probabilities rounded from the final statistics, and P.v. (An
// online rescale of rounded probabilities would not be the same function.)
//
// The float32 body (`attention_fwd_f32_kernel`: fp32, head_ch a multiple of
// 4 up to 64, block 4 or 8, every halo; the prod fp32 shape) runs both
// products in true f32 FMAs, register-tiled (`attention_f32.cuh` says what
// bounds it and how), in the plain version's own order on the card, so its
// outputs are the plain version's: each logit one FMA chain over the
// channels, the row max, exp(s - max) summed as PyTorch's warp softmax sums
// a row (lane L the keys j = L mod 32 in order, then a butterfly 16..1),
// P = that / sum, and P . v one FMA chain a value over the keys in order, as
// cuBLAS sums it. (The fp32 training step amplifies any other order: the
// critic's near-zero gradients flip sign under Adam's first step, which
// moved the step's G gradients by 4.6e-3 where the bound is 1e-3, PERF.md.)
// 4 warps of 16 query rows; a lane's 4 rows x 13 key slots of a chunk of up
// to 104 keys, the two chunks of the prod window both in registers (74 KB of
// shared memory: three CTAs an SM); P goes to shared memory as [key][row],
// and each thread sums 4 rows x 8 channels of P . v over the keys; more
// keys take three passes (the max, the sums, P . v), recomputing the logits.
// (A 3xTF32 tensor-core fp32 body ran no faster and moved the fp32 training
// step past its bound too: PERF.md.)
//
// The general body (the two scalar-FMA kernels below: shapes neither other
// body takes) stages the key window transposed and the
// f32 logits (64 x 196 = 50 KB) in shared memory and runs both products as
// scalar FMAs register-blocked over 8 query rows. Windows whose one-stage
// plan exceeds 227 KB (bf16 halo >= 7 or fp32 halo >= 5 at head_ch 64)
// take its key-chunked two-pass kernel: pass 1 walks the key chunks for the
// row max and sum (online), pass 2 recomputes each chunk's logits,
// normalises and rounds the probabilities as above and accumulates p . v
// in f32 in shared memory. Only f32 summation order differs between the
// plans and the bodies.

#include "attention_f32.cuh"
#include "attention_tc.cuh"
#include "common.cuh"

namespace {

using namespace pht;

constexpr int kThreads = 256;
constexpr int kRows = 8;  // query rows per work item (register blocking)

size_t smem_bytes(int bs, int halo, int hd, size_t elem) {
  const size_t nq = (size_t)bs * bs;
  const size_t nk = (size_t)(bs + 2 * halo) * (bs + 2 * halo);
  return nq * nk * sizeof(float) + (nq * hd + 2 * nk * hd) * elem;
}

// chunked plan: q [nq][hd] T, acc [nq][hd] f32, row max/sum [2][nq] f32,
// then per key of a chunk: k and v columns (T) and one f32 logit per row
size_t chunk_fixed_bytes(int nq, int hd, size_t elem) {
  return (size_t)nq * hd * (elem + sizeof(float)) + 2 * nq * sizeof(float);
}
size_t chunk_key_bytes(int nq, int hd, size_t elem) {
  return 2 * (size_t)hd * elem + (size_t)nq * sizeof(float);
}

struct Geom {
  int H, W, C, bs, halo, heads, hd, half, window, nq, nk, wb, hb;
  int b, by, bx, c0;
};

__device__ __forceinline__ Geom geom(int H, int W, int C, int bs, int halo, int heads) {
  Geom g;
  g.H = H; g.W = W; g.C = C; g.bs = bs; g.halo = halo; g.heads = heads;
  g.hd = C / heads;
  g.half = g.hd / 2;
  g.window = bs + 2 * halo;
  g.nq = bs * bs;
  g.nk = g.window * g.window;
  g.wb = W / bs;
  g.hb = H / bs;
  int t = blockIdx.x;  // (b * hb + by) * wb + bx
  g.bx = t % g.wb;
  t /= g.wb;
  g.by = t % g.hb;
  g.b = t / g.hb;
  g.c0 = blockIdx.y * g.hd;
  return g;
}

__device__ __forceinline__ int64_t query_off(const Geom& g, int i, int d) {
  const int y = g.by * g.bs + i / g.bs, x = g.bx * g.bs + i % g.bs;
  return (((int64_t)g.b * g.H + y) * g.W + x) * g.C + g.c0 + d;
}

// Stage keys [j0, j0 + n) of the window: kt[d * ld + jj] = round(k + bias)
// (transposed) and, when v_dst is given, v_dst[jj * hd + d] = v.
template <typename T>
__device__ void stage_keys(const Geom& g, const T* k, const T* v, const float* rel_h,
                           const float* rel_w, int j0, int n, int ld, T* kt, T* v_dst) {
  for (int idx = threadIdx.x; idx < n * g.hd; idx += kThreads) {
    const int jj = idx / g.hd, d = idx - jj * g.hd;
    const int j = j0 + jj;
    const int wy = j / g.window, wx = j - wy * g.window;
    const int y = g.by * g.bs - g.halo + wy, x = g.bx * g.bs - g.halo + wx;
    const bool inside = y >= 0 && y < g.H && x >= 0 && x < g.W;
    const int64_t off = (((int64_t)g.b * g.H + y) * g.W + x) * g.C + g.c0 + d;
    const float kval = inside ? to_f32(k[off]) : 0.f;
    const float bias = d < g.half ? rel_h[wy * g.half + d] : rel_w[wx * g.half + d - g.half];
    kt[d * ld + jj] = from_f32<T>(kval + bias);
    if (v_dst) v_dst[jj * g.hd + d] = inside ? v[off] : from_f32<T>(0.f);
  }
}

// s_p[i * ld + jj] = (q_i . kt[:, jj]) * scale for jj < n
template <typename T>
__device__ void logits(const Geom& g, const T* s_q, const T* s_kt, int n, int ld,
                       float scale, float* s_p) {
  const int ngroups = (g.nq + kRows - 1) / kRows;
  for (int item = threadIdx.x; item < ngroups * n; item += kThreads) {
    const int grp = item / n, j = item - grp * n;
    const int i0 = grp * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int d = 0; d < g.hd; ++d) {
      const float kv = to_f32(s_kt[d * ld + j]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = min(i0 + r, g.nq - 1);  // clamped rows are discarded
        acc[r] = fmaf(to_f32(s_q[i * g.hd + d]), kv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (i0 + r < g.nq) s_p[(i0 + r) * ld + j] = acc[r] * scale;
  }
}

// acc_r = sum_{jj < n} s_p[i * ld + jj] * s_v[jj * hd + d] for 8 rows
template <typename T>
__device__ __forceinline__ void pv_rows(const Geom& g, const float* s_p, const T* s_v,
                                        int n, int ld, int i0, int d, float (&acc)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float vv = to_f32(s_v[j * g.hd + d]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = min(i0 + r, g.nq - 1);
      acc[r] = fmaf(s_p[i * ld + j], vv, acc[r]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_out(const Geom& g, const T* res, T* out, int i, int d,
                                          float acc) {
  const int64_t off = query_off(g, i, d);
  T o = from_f32<T>(acc);
  if (res != nullptr) o = from_f32<T>(to_f32(res[off]) + to_f32(o));
  out[off] = o;
}

template <typename T>
__device__ void stage_queries(const Geom& g, const T* q, T* s_q) {
  for (int idx = threadIdx.x; idx < g.nq * g.hd; idx += kThreads) {
    const int i = idx / g.hd, d = idx - (idx / g.hd) * g.hd;
    s_q[idx] = q[query_off(g, i, d)];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w,
    const T* __restrict__ res, T* __restrict__ out,
    int H, int W, int C, int bs, int halo, int heads, float scale) {
  const Geom g = geom(H, W, C, bs, halo, heads);
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_p = reinterpret_cast<float*>(smem);                // [nq][nk] logits, probs
  T* s_q = reinterpret_cast<T*>(s_p + (size_t)g.nq * g.nk);  // [nq][hd]
  T* s_kt = s_q + (size_t)g.nq * g.hd;                        // [hd][nk]
  T* s_v = s_kt + (size_t)g.hd * g.nk;                        // [nk][hd]

  stage_queries(g, q, s_q);
  stage_keys(g, k, v, rel_h, rel_w, 0, g.nk, g.nk, s_kt, s_v);
  __syncthreads();
  logits(g, s_q, s_kt, g.nk, g.nk, scale, s_p);
  __syncthreads();

  // ---- softmax per query row (one warp per row), probs rounded to T ----
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < g.nq; i += kThreads / 32) {
    float* row = s_p + (size_t)i * g.nk;
    float m = -INFINITY;
    for (int j = lane; j < g.nk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < g.nk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < g.nk; j += 32) row[j] = round_to<T>(row[j] / s);
  }
  __syncthreads();

  // ---- out = p . v (+ residual) ----------------------------------------
  const int ngroups = (g.nq + kRows - 1) / kRows;
  for (int item = tid; item < ngroups * g.hd; item += kThreads) {
    const int grp = item / g.hd, d = item - grp * g.hd;
    const int i0 = grp * kRows;
    float acc[kRows];
    pv_rows(g, s_p, s_v, g.nk, g.nk, i0, d, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (i0 + r < g.nq) store_out(g, res, out, i0 + r, d, acc[r]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_fwd_chunked_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w,
    const T* __restrict__ res, T* __restrict__ out,
    int H, int W, int C, int bs, int halo, int heads, float scale, int kc) {
  const Geom g = geom(H, W, C, bs, halo, heads);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_p = reinterpret_cast<float*>(smem);      // [nq][kc] logits, probs
  float* s_acc = s_p + (size_t)g.nq * kc;            // [nq][hd] f32 p . v
  float* s_m = s_acc + (size_t)g.nq * g.hd;          // [nq] row max
  float* s_l = s_m + g.nq;                           // [nq] row sum
  T* s_q = reinterpret_cast<T*>(s_l + g.nq);         // [nq][hd]
  T* s_kt = s_q + (size_t)g.nq * g.hd;               // [hd][kc]
  T* s_v = s_kt + (size_t)g.hd * kc;                 // [kc][hd]

  stage_queries(g, q, s_q);
  for (int idx = tid; idx < g.nq * g.hd; idx += kThreads) s_acc[idx] = 0.f;
  for (int i = tid; i < g.nq; i += kThreads) {
    s_m[i] = -INFINITY;
    s_l[i] = 0.f;
  }

  // ---- pass 1: row max and sum over the key chunks (online) ------------
  for (int j0 = 0; j0 < g.nk; j0 += kc) {
    const int n = min(kc, g.nk - j0);
    __syncthreads();  // the previous chunk's readers are done
    stage_keys(g, k, v, rel_h, rel_w, j0, n, kc, s_kt, (T*)nullptr);
    __syncthreads();
    logits(g, s_q, s_kt, n, kc, scale, s_p);
    __syncthreads();
    for (int i = warp; i < g.nq; i += kThreads / 32) {
      const float* row = s_p + (size_t)i * kc;
      float cm = -INFINITY;
      for (int j = lane; j < n; j += 32) cm = fmaxf(cm, row[j]);
      cm = warp_max(cm);
      const float m_new = fmaxf(s_m[i], cm);
      float s = 0.f;
      for (int j = lane; j < n; j += 32) s += expf(row[j] - m_new);
      s = warp_sum(s);
      if (lane == 0) {
        s_l[i] = s_l[i] * expf(s_m[i] - m_new) + s;
        s_m[i] = m_new;
      }
    }
  }

  // ---- pass 2: probabilities rounded to T, acc += p . v -----------------
  const int ngroups = (g.nq + kRows - 1) / kRows;
  for (int j0 = 0; j0 < g.nk; j0 += kc) {
    const int n = min(kc, g.nk - j0);
    __syncthreads();
    stage_keys(g, k, v, rel_h, rel_w, j0, n, kc, s_kt, s_v);
    __syncthreads();
    logits(g, s_q, s_kt, n, kc, scale, s_p);
    __syncthreads();
    for (int idx = tid; idx < g.nq * n; idx += kThreads) {
      const int i = idx / n, j = idx - i * n;
      float* p = s_p + (size_t)i * kc + j;
      *p = round_to<T>(expf(*p - s_m[i]) / s_l[i]);
    }
    __syncthreads();
    for (int item = tid; item < ngroups * g.hd; item += kThreads) {
      const int grp = item / g.hd, d = item - grp * g.hd;
      const int i0 = grp * kRows;
      float acc[kRows];
      pv_rows(g, s_p, s_v, n, kc, i0, d, acc);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (i0 + r < g.nq) s_acc[(i0 + r) * g.hd + d] += acc[r];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g.nq * g.hd; idx += kThreads) {
    const int i = idx / g.hd, d = idx - i * g.hd;
    store_out(g, res, out, i, d, s_acc[idx]);
  }
}


// ---- the tensor-core body -------------------------------------------------

// NT > 0: the window's NT key tiles, their logits held in registers;
// NT == 0: any count, two passes over the key tiles
template <int NT>
__global__ void __launch_bounds__(128, PHT_ATTN_FWD_CTAS) attention_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w,
    const bf16* __restrict__ res, bf16* __restrict__ out, int H, int W, int C, int bs,
    int halo, int heads, float scale) {
  const attn::Win g = attn::win_geom(H, W, C, bs, halo, heads);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);        // [nq][ld]
  bf16* s_k = s_q + (size_t)g.nq * g.ld;             // [16 nt][ld] k, then k_eff
  bf16* s_v = s_k + (size_t)16 * g.nt * g.ld;        // [16 nt][ld]
  attn::stage_queries(g, q, s_q);
#if PHT_ATTN_DIAG != 3  // k by cp.async and a pass in place: the faster for K1
  attn::stage_keys_async(g, k, v, s_k, s_v);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
  attn::add_bias(g, rel_h, rel_w, s_k);
#else
  attn::stage_keys(g, k, v, rel_h, rel_w, s_k, s_v);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
#endif
  __syncthreads();

  uint32_t qa[attn::kMaxHead / 16][4];
  const int hk = g.hd / 16;
  attn::load_rows(qa, s_q, g.ld, (threadIdx.x >> 5) * 16, hk);
  float acc[attn::kMaxHead / 8][4];
#pragma unroll
  for (int n = 0; n < attn::kMaxHead / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  // row statistics of rows g (index 0) and g + 8 (index 1), quad-reduced
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if constexpr (NT > 0) {
    float s[NT][8];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      attn::logits(qa, s_k, g, t, scale, s[t]);
#pragma unroll
      for (int i = 0; i < 8; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[t][i]);
    }
    m[0] = attn::quad_max(m[0]);
    m[1] = attn::quad_max(m[1]);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[t][i] = expf(s[t][i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[t][i];
      }
    l[0] = attn::quad_sum(l[0]);
    l[1] = attn::quad_sum(l[1]);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int i = 0; i < 8; ++i) s[t][i] /= l[(i >> 1) & 1];
      uint32_t pa[4];
      attn::pack_tile(s[t], pa);
      attn::times_rows(pa, s_v, g.ld, t, hk, acc);
    }
  } else {
#pragma unroll 1
    for (int t = 0; t < g.nt; ++t) {
      float s[8];
      attn::logits(qa, s_k, g, t, scale, s);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mt = fmaxf(fmaxf(s[2 * r], s[2 * r + 1]), fmaxf(s[4 + 2 * r], s[5 + 2 * r]));
        const float mn = fmaxf(m[r], mt);
        l[r] = l[r] * expf(m[r] - mn) + expf(s[2 * r] - mn) + expf(s[2 * r + 1] - mn) +
               expf(s[4 + 2 * r] - mn) + expf(s[5 + 2 * r] - mn);
        m[r] = mn;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mq = attn::quad_max(m[r]);
      l[r] = attn::quad_sum(l[r] * expf(m[r] - mq));
      m[r] = mq;
    }
#pragma unroll 1
    for (int t = 0; t < g.nt; ++t) {
      float s[8];
      attn::logits(qa, s_k, g, t, scale, s);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = expf(s[i] - m[(i >> 1) & 1]) / l[(i >> 1) & 1];
      uint32_t pa[4];
      attn::pack_tile(s, pa);
      attn::times_rows(pa, s_v, g.ld, t, hk, acc);
    }
  }
  attn::store_rows(g, acc, 1.f, s_q, res, out);
}

template <int NT>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, const float* rel_h,
              const float* rel_w, const bf16* res, bf16* out, int B, int H, int W, int C,
              int bs, int halo, int heads, float scale, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_tc_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * (H / bs) * (W / bs)), (unsigned)heads);
  attention_fwd_tc_kernel<NT><<<grid, 2 * bs * bs, smem, stream>>>(
      q, k, v, rel_h, rel_w, res, out, H, W, C, bs, halo, heads, scale);
  return (int)cudaGetLastError();
}

// ---- the float32 body ------------------------------------------------------

// the row sums of the softmax in the plain version's order on the card (a
// warp a row, lane L summing the keys j = L mod 32 in order, then a
// butterfly over lanes 16, 8, 4, 2, 1): each lane keeps the four "lanes"
// L = lk + 8a of its slots (key 8u + lk has a = u mod 4) in p[a], whose
// first two butterfly steps stay in the lane
__device__ __forceinline__ float torch_row_sum(const float (&p)[4]) {
  float v = (p[0] + p[2]) + (p[1] + p[3]);
  v += __shfl_xor_sync(f32a::kFull, v, 4);
  v += __shfl_xor_sync(f32a::kFull, v, 2);
  return v + __shfl_xor_sync(f32a::kFull, v, 1);
}

// TC > 0: TC key slots a lane (the prod shape); TC == 0: any count up to
// f32a::kMaxSlots. Same arithmetic as the plain version on the card: each
// logit one FMA chain over the channels, the row max, exp(s - max) summed in
// the softmax's order (`torch_row_sum`), P = that / sum, and P . v one FMA
// chain a value over the keys in order; so the outputs are those of the
// plain version.
template <int TC>
__global__ void __launch_bounds__(128, PHT_F32_FWD_CTAS) attention_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w,
    const float* __restrict__ res, float* __restrict__ out, int H, int W, int C, int bs,
    int halo, int heads, float scale) {
  using f32a::kLd;
  using f32a::kMaxSlots;
  using f32a::kRows;
  constexpr int kRes = 2 * kMaxSlots;  // the slots of two chunks, held in registers
  const attn::Win g = attn::win_geom(H, W, C, bs, halo, heads);
  const int T = TC > 0 ? TC : f32a::slots(g.nk, 1), ck = 8 * T, nc = f32a::chunks(g.nk, 1);
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);  // [nq][kLd]
  float* s_a = s_q + g.nq * kLd;                // [ck][kLd] k_eff, v, or P as [slot][row]
  float* s_b = s_a + ck * kLd;                  // [ck][kLd] the same
  const int lane = threadIdx.x & 31, lk = lane & 7;
  const int r = 16 * (threadIdx.x >> 5) + (lane >> 3);  // rows r, r + 4, r + 8, r + 12
  // P . v: this thread's 4 rows x 8 channels (4 cg.. and 32 + 4 cg..)
  const int rg = 4 * (threadIdx.x >> 3), cg = 4 * (threadIdx.x & 7);
  const bool c_lo = cg < g.hd, c_hi = 32 + cg < g.hd;

  // chunk c's k_eff into dst (after the wait, a barrier and the bias)
  auto stage_k = [&](int c, float* dst) { f32a::stage_keys(g, k, c * ck, ck, dst); };
  auto bias_k = [&](int c, float* dst) { f32a::add_bias(g, rel_h, rel_w, c * ck, ck, dst); };
  float acc[4][8];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int f = 0; f < 8; ++f) acc[e][f] = 0.f;
  // acc += P . v over chunk c's keys in order, P as [slot][row] in pp, v in pv
  auto times_v = [&](int c, const float* pp, const float* pv) {
    const int n = min(ck, g.nk - c * ck);
#if PHT_F32_DIAG == 1 || PHT_F32_DIAG == 3
    acc[0][0] += pp[rg] * pv[cg];
    return;
#endif
    if (!c_lo) return;
#pragma unroll 4
    for (int jj = 0; jj < n; ++jj) {
      const float4 pw = *reinterpret_cast<const float4*>(pp + jj * kLd + rg);
      const float4 v0 = *reinterpret_cast<const float4*>(pv + jj * kLd + cg);
      const float4 v1 = c_hi ? *reinterpret_cast<const float4*>(pv + jj * kLd + 32 + cg)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      const float pr[4] = {pw.x, pw.y, pw.z, pw.w};
      const float vc[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int f = 0; f < 8; ++f) acc[e][f] = fmaf(pr[e], vc[f], acc[e][f]);
    }
  };
  // the lane's P of one chunk into dst as [slot][row]
  auto put_p = [&](const float (&p)[kRows][kRes], int off, float* dst) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int t = 0; t < kMaxSlots; ++t)
        if (f32a::live<TC>(t, T)) dst[(lk + 8 * t) * kLd + r + 4 * i] = p[i][off + t];
  };

  f32a::stage_queries(g, q, s_q);
  float s[kRows][kRes], m[kRows], part[kRows][4], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a) part[i][a] = 0.f;
  }
  // e = exp(s - m) of slot t of chunk c into part[.][a], a = (c T + t) mod 4
  auto add_exp = [&](int i, int c, int t, float e) {
    const int a = (c * T + t) & 3;
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) part[i][q4] += q4 == a ? e : 0.f;
  };

  if (nc <= 2) {
    // ---- the logits of the window's (one or two) chunks in registers ----
    stage_k(0, s_a);
    if (nc > 1) stage_k(1, s_b);
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    __syncthreads();
    bias_k(0, s_a);
    if (nc > 1) bias_k(1, s_b);
    __syncthreads();
    f32a::dots<TC, 0>(s_q, s_a + lk * kLd, r, T, g.hd, scale, s);
    f32a::mask_slots<TC, 0>(lk, T, min(ck, g.nk), s);
    if (nc > 1) {
      f32a::dots<TC, kMaxSlots>(s_q, s_b + lk * kLd, r, T, g.hd, scale, s);
      f32a::mask_slots<TC, kMaxSlots>(lk, T, g.nk - ck, s);
    } else {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int t = 0; t < kMaxSlots; ++t) s[i][kMaxSlots + t] = -INFINITY;
    }
    __syncthreads();  // every warp's logits are done: v's first chunk goes to s_a
    f32a::stage_keys(g, v, 0, ck, s_a);
    sm90::cp_async_commit();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int t = 0; t < kRes; ++t) m[i] = fmaxf(m[i], s[i][t]);
      m[i] = f32a::group_max(m[i]);
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int t = 0; t < kMaxSlots; ++t) {
          float& x = s[i][c * kMaxSlots + t];
          x = expf(x - m[i]);
          if (c < nc && f32a::live<TC>(t, T)) add_exp(i, c, t, x);
        }
      l[i] = torch_row_sum(part[i]);
#pragma unroll
      for (int t = 0; t < kRes; ++t) s[i][t] = s[i][t] / l[i];
    }
    put_p(s, 0, s_b);
    sm90::cp_async_wait<0>();
    __syncthreads();
    times_v(0, s_b, s_a);
    if (nc > 1) {
      __syncthreads();  // chunk 0's P and v are read
      f32a::stage_keys(g, v, ck, ck, s_a);
      sm90::cp_async_commit();
      put_p(s, kMaxSlots, s_b);
      sm90::cp_async_wait<0>();
      __syncthreads();
      times_v(1, s_b, s_a);
    }
  } else {
    // ---- more chunks: the max, the sums, then P and P . v, one pass each --
    for (int pass = 0; pass < 3; ++pass) {
      for (int c = 0; c < nc; ++c) {
        __syncthreads();  // the last chunk's readers are done
        stage_k(c, s_a);
        if (pass == 2) f32a::stage_keys(g, v, c * ck, ck, s_b);
        sm90::cp_async_commit();
        sm90::cp_async_wait<0>();
        __syncthreads();
        bias_k(c, s_a);
        __syncthreads();
        f32a::dots<TC, 0>(s_q, s_a + lk * kLd, r, T, g.hd, scale, s);
        f32a::mask_slots<TC, 0>(lk, T, g.nk - c * ck, s);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int t = 0; t < kMaxSlots; ++t) {
            if (pass == 0) {
              m[i] = fmaxf(m[i], s[i][t]);
            } else {
              s[i][t] = expf(s[i][t] - m[i]);
              if (pass == 1 && f32a::live<TC>(t, T)) add_exp(i, c, t, s[i][t]);
              if (pass == 2) s[i][t] = s[i][t] / l[i];
            }
          }
        }
        if (pass < 2) continue;
        __syncthreads();  // every warp's logits are done: P takes k_eff's rows
        put_p(s, 0, s_a);
        __syncthreads();
        times_v(c, s_a, s_b);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (pass == 0) m[i] = f32a::group_max(m[i]);
        if (pass == 1) l[i] = torch_row_sum(part[i]);
      }
    }
  }
  if (!c_lo) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int64_t row = attn::query_pixel(g, rg + e) * g.C + g.c0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !c_hi) continue;
      const int d = 32 * h + cg;
      float4 o = make_float4(acc[e][4 * h], acc[e][4 * h + 1], acc[e][4 * h + 2],
                             acc[e][4 * h + 3]);
      if (res != nullptr) {
        const float4 rv = __ldg(reinterpret_cast<const float4*>(res + row + d));
        o = make_float4(rv.x + o.x, rv.y + o.y, rv.z + o.z, rv.w + o.w);
      }
      *reinterpret_cast<float4*>(out + row + d) = o;
    }
  }
}

template <int TC>
int launch_f32(const float* q, const float* k, const float* v, const float* rel_h,
               const float* rel_w, const float* res, float* out, int B, int H, int W, int C,
               int bs, int halo, int heads, float scale, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_f32_kernel<TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * (H / bs) * (W / bs)), (unsigned)heads);
  attention_fwd_f32_kernel<TC><<<grid, 2 * bs * bs, smem, stream>>>(
      q, k, v, rel_h, rel_w, res, out, H, W, C, bs, halo, heads, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* rel_h,
           const float* rel_w, const void* res, void* out, int B, int H, int W,
           int C, int bs, int halo, int heads, float scale, cudaStream_t stream) {
  const int hd = C / heads;
  const int nq = bs * bs, nk = (bs + 2 * halo) * (bs + 2 * halo);
  const dim3 grid((unsigned)(B * (H / bs) * (W / bs)), (unsigned)heads);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  size_t smem = smem_bytes(bs, halo, hd, sizeof(T));
  cudaError_t err;
  if (smem <= kMaxSmem) {
    err = cudaFuncSetAttribute(attention_fwd_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, rel_h, rel_w, rt, ot, H, W, C, bs, halo, heads, scale);
    return (int)cudaGetLastError();
  }
  const size_t fixed = chunk_fixed_bytes(nq, hd, sizeof(T));
  const size_t per_key = chunk_key_bytes(nq, hd, sizeof(T));
  if (fixed + per_key > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int kc = (int)std::min<size_t>((size_t)nk, (kMaxSmem - fixed) / per_key);
  smem = fixed + per_key * kc;
  err = cudaFuncSetAttribute(attention_fwd_chunked_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_chunked_kernel<T><<<grid, kThreads, smem, stream>>>(
      qt, kt, vt, rel_h, rel_w, rt, ot, H, W, C, bs, halo, heads, scale, kc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pht_attention_fwd(const void* q, const void* k, const void* v, const void* rel_h,
                      const void* rel_w, const void* res, void* out, int B, int H,
                      int W, int C, int bs, int halo, int heads, int is_bf16,
                      float scale, void* stream) {
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(q, k, v, rh, rw, res, out, B, H, W, C, bs, halo, heads, scale, s);
  return launch<float>(q, k, v, rh, rw, res, out, B, H, W, C, bs, halo, heads, scale, s);
}

// The tensor-core body (bf16 only): the same arguments as pht_attention_fwd.
// Refuses (cudaErrorInvalidValue, before any launch) a dtype, shape,
// alignment or shared memory the body does not take.
int pht_attention_fwd_tc(const void* q, const void* k, const void* v, const void* rel_h,
                         const void* rel_w, const void* res, void* out, int B, int H, int W,
                         int C, int bs, int halo, int heads, int is_bf16, float scale,
                         void* stream) {
  const int hd = C / heads;
  if (!is_bf16 || !attn::admits(bs, hd, C)) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, rel_h, rel_w, res, static_cast<const void*>(out)})
    if (p != nullptr && !aligned16(p)) return (int)cudaErrorInvalidValue;
  const size_t smem = attn::fwd_smem(bs, halo, hd);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  const bf16* rt = static_cast<const bf16*>(res);
  bf16* ot = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PHT_FWD_TC(NT) \
  launch_tc<NT>(qt, kt, vt, rh, rw, rt, ot, B, H, W, C, bs, halo, heads, scale, smem, s)
  const int nt = attn::key_tiles(bs, halo);
  switch (attn::resident_tiles(nt) ? nt : 0) {
    case 3: return PHT_FWD_TC(3);
    case 4: return PHT_FWD_TC(4);
    case 7: return PHT_FWD_TC(7);
    case 9: return PHT_FWD_TC(9);
    case 13: return PHT_FWD_TC(13);
    case 16: return PHT_FWD_TC(16);
    default: return PHT_FWD_TC(0);
  }
#undef PHT_FWD_TC
}

// The float32 body: the same arguments as pht_attention_fwd. Refuses
// (cudaErrorInvalidValue, before any launch) a dtype, shape, alignment or
// shared memory the body does not take.
int pht_attention_fwd_f32(const void* q, const void* k, const void* v, const void* rel_h,
                          const void* rel_w, const void* res, void* out, int B, int H, int W,
                          int C, int bs, int halo, int heads, int is_bf16, float scale,
                          void* stream) {
  if (is_bf16 || !f32a::admits(bs, halo, C / heads, C)) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, rel_h, rel_w, res, static_cast<const void*>(out)})
    if (p != nullptr && !aligned16(p)) return (int)cudaErrorInvalidValue;
  const size_t smem = f32a::fwd_smem(bs, halo);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  const float* rt = static_cast<const float*>(res);
  float* ot = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fast = f32a::slots(f32a::window_keys(bs, halo), 1) == f32a::kFastSlots &&
                    PHT_F32_DIAG != 4;
  if (fast)
    return launch_f32<f32a::kFastSlots>(qt, kt, vt, rh, rw, rt, ot, B, H, W, C, bs, halo, heads,
                                        scale, smem, s);
  return launch_f32<0>(qt, kt, vt, rh, rw, rt, ot, B, H, W, C, bs, halo, heads, scale, smem, s);
}

// dynamic shared memory of one CTA of the float32 body: K1 (which 0) or K4's
// main kernel (which 1)
int pht_attention_f32_smem(int which, int bs, int halo) {
  return (int)(which ? f32a::bwd_smem(bs, halo) : f32a::fwd_smem(bs, halo));
}

// dynamic shared memory of one CTA of the tensor-core body: K1 (which 0) or
// K4's main kernel (which 1)
int pht_attention_tc_smem(int which, int bs, int halo, int hd) {
  return (int)(which ? attn::bwd_smem(bs, halo, hd) : attn::fwd_smem(bs, halo, hd));
}

const char* pht_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
