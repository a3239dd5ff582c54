// Device code shared by the fused Mamba2-chain forward K7 (ssd_fwd.cu) and
// backward K8 (ssd_bwd.cu): K7's prologue (launch 1) and chunk output
// (launch 4), which K8 runs again to recompute the forward, the prologue in
// two bodies (the vec body and the general one), each chunk output in two
// (the tensor-core body and the general scalar-FMA body); and the
// tensor-core product of every head's [n, p] block that is
// K7's chunk state and K8's dstate local. Their design is in ssd_fwd.cu's
// header.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "conv_rows.cuh"
#include "sm90_gemm.cuh"
#include "tf32x3.cuh"

namespace {

using namespace pht;

constexpr int kThreads = 256;
constexpr int kMaxConv = 9;  // d_conv <= 9, as the TPU kernel's gate
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));  // jax.nn.softplus
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

struct Dims {
  int B, L, di, n, h, p, k, q, nc, dc, W;
};

// The dims of zxbcdt [B, L, 2 di + 2 n + h] in chunks of q tokens
inline Dims chain_dims(int B, int L, int di, int n, int h, int k, int q) {
  Dims d;
  d.B = B; d.L = L; d.di = di; d.n = n; d.h = h; d.p = di / h; d.k = k; d.q = q;
  d.nc = L / q; d.dc = di + 2 * n; d.W = 2 * di + 2 * n + h;
  return d;
}

// ---- the tensor-core ("tc") body: its shapes, staging and warp tiling -------
constexpr int kWarps = kThreads / 32;
// the tensor-core chunk output runs 16 warps, to hide the latency of its
// fragment loads and mma.sync chains: one CTA fills an SM's shared memory
constexpr int kTcThreads = 512;
constexpr int kTcWarps = kTcThreads / 32;

// Shapes the tc body takes: chunk q a multiple of 32 up to 128, headdim p 16,
// 32 or 64, d_state n a multiple of 16 up to 64. Every tc kernel's staging
// then fits one CTA's shared memory (the largest, K8's fused intra/head
// rest at q 128, n p 64: 225,856 bytes of 232,448) and its register tiles
// their compile-time bounds. Other shapes take the general body.
__host__ __device__ inline bool tc_body(int q, int n, int p) {
  return q % 32 == 0 && q <= 128 && (p == 16 || p == 32 || p == 64) && n % 16 == 0 &&
         n >= 16 && n <= 64;
}

// 16-byte cp.async copies of a [rows][cols] block of E (cols * sizeof(E) a
// multiple of 16) from rows `lds` elements apart into rows `ldd` apart
template <typename E>
__device__ __forceinline__ void stage(E* dst, int ldd, const E* src, long lds, int rows,
                                      int cols) {
  constexpr int per = 16 / sizeof(E);
  const int chunks = cols / per;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks, ch = idx - r * chunks;
    sm90::cp_async16(sm90::smem_u32(dst + (size_t)r * ldd + ch * per), src + r * lds + ch * per,
                     true);
  }
}

// Tile u of the 16 x 8 tiles on or below the diagonal of a [q, q] causal
// matrix, row tile by row tile (row tile mt holds 2 mt + 2 of them):
// (row of its first element, column of its first element).
__device__ __forceinline__ int2 tri_tile(int u) {
  int mt = 0;
  while ((mt + 1) * (mt + 2) <= u) ++mt;
  return make_int2(16 * mt, 8 * (u - mt * (mt + 1)));
}

// Offset of element (t, j), j <= t + 15 - t % 16, of a causal [q, q] matrix
// stored as those tiles, packed, each 16 x 8 tile row-major with its columns
// swizzled (column c of row r at c ^ (r & 4)), so that an A fragment's
// loads (rows g, g + 8; columns c, c + 4) hit 32 banks.
__device__ __forceinline__ int tri_sw(int t, int j) {
  const int mt = t >> 4, r = t & 15;
  return (mt * (mt + 1) + (j >> 3)) * 128 + r * 8 + ((j & 7) ^ (r & 4));
}

// ---- 1. prologue (K7 launch 1) ---------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_prologue_kernel(
    const T* __restrict__ zx, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ dt_bias,
    const float* __restrict__ A, float* __restrict__ xbc, float* __restrict__ dt,
    float* __restrict__ cum, Dims d) {
  const int c = blockIdx.x, b = blockIdx.y;
  const long row0 = (long)b * d.L + (long)c * d.q;  // the chunk's first token
  if (blockIdx.z + 1 < gridDim.z) {
    const int ch = blockIdx.z * kThreads + threadIdx.x;
    if (ch >= d.dc) return;
    const T* src = zx + d.di + ch;
    float w[kMaxConv], win[kMaxConv - 1];
#pragma unroll
    for (int j = 0; j < kMaxConv; ++j) w[j] = j < d.k ? conv_w[(long)j * d.dc + ch] : 0.f;
    const float bias = conv_b[ch];
    // win[j] = raw x[t - (k - 1) + j] for the next t
#pragma unroll
    for (int j = 0; j < kMaxConv - 1; ++j) {
      const int t = c * d.q - (d.k - 1) + j;
      win[j] = (j < d.k - 1 && t >= 0) ? to_f32(src[((long)b * d.L + t) * d.W]) : 0.f;
    }
#pragma unroll 4
    for (int t = 0; t < d.q; ++t) {
      const float xr = to_f32(src[(row0 + t) * d.W]);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxConv; ++j)
        if (j == d.k - 1) acc = xr * w[j];
#pragma unroll
      for (int j = 0; j < kMaxConv - 1; ++j)
        if (j < d.k - 1) acc = fmaf(win[j], w[j], acc);
      xbc[(row0 + t) * d.dc + ch] = silu(acc + bias);
#pragma unroll
      for (int j = 0; j < kMaxConv - 1; ++j) {
        if (j < d.k - 2) win[j] = win[j + 1];
        else if (j == d.k - 2) win[j] = xr;
      }
    }
    return;
  }
  // the chunk's dt and in-chunk cumsum of dt * A, one thread per head
  for (int hh = threadIdx.x; hh < d.h; hh += kThreads) {
    const float bias = dt_bias[hh], a = A[hh];
    const T* src = zx + d.di + d.dc + hh;
    float run = 0.f;
    for (int t = 0; t < d.q; ++t) {
      const float v = softplus(to_f32(src[(row0 + t) * d.W]) + bias);
      run += v * a;
      dt[(row0 + t) * d.h + hh] = v;
      cum[(row0 + t) * d.h + hh] = run;
    }
  }
}

// ---- 1. prologue, vec body (K7 launch 1) ----------------------------------------
// The general body above walks one channel a thread in 256-thread slabs (the
// fifth slab of the 1,152 channels half idle), stores xbc 4 bytes at a time,
// keeps its run-time k's taps behind a predicate on every one of kMaxConv
// steps, and leaves the chunk's dt and cum to 16 of a slab's threads, each
// walking the chunk's rows alone. The vec body takes windows whose offset
// (d_inner), row stride and width (dc) are multiples of 16 bytes and
// 16-byte aligned tensors (`prologue_vec_body`; the prod window: 2,048,
// 4,384 and 2,304 bytes in bf16), k a template argument:
//   - the conv + SiLU CTAs walk a chunk's rows as conv_rows.cuh walks them,
//     4 channels a thread: 8 (bf16) or 16 (f32) bytes of the window a row
//     through a cp.async ring, the f32 xbc stored 16 bytes at a time, in
//     CTAs that leave no lane idle at dc 1,152 (96 threads, 3 a chunk);
//   - one more CTA a chunk forms dt for every (row, head) with all its
//     threads, then carries each head's running sum of dt * A down the rows.
// The arithmetic is the general body's, operation by operation: acc =
// x_t w[k-1], then fmaf(x_{t-(k-1)+j}, w[j], acc) for j = 0 .. k-2, then
// silu(acc + b); cum one running sum in row order. So xbc, dt and cum are
// the same bits, and K8's conv backward, which recomputes the
// pre-activation in this order, still matches it.
#ifndef PHT_PROLOGUE_RING
#define PHT_PROLOGUE_RING 8  // rows of the window in flight per thread
#endif
#ifndef PHT_PROLOGUE_DT_SERIAL  // 1: bench_scan.py's variant, the general body's dt walk
#define PHT_PROLOGUE_DT_SERIAL 0
#endif
constexpr int kProRing = PHT_PROLOGUE_RING;
constexpr int kProCh = 4;  // channels a thread

__host__ __device__ inline bool prologue_vec_body(int W, int di, int dc, int esize) {
  return esize > 0 && di % (16 / esize) == 0 && W % (16 / esize) == 0 && dc % (16 / esize) == 0;
}

// dt = softplus(dt_raw + dt_bias) [q, h] of the chunk at row0 and cum, the
// running sum of dt * A down its rows, through two buffers of `buf` floats
// of shared memory: all threads form dt for a tile of rows and heads
// (coalesced stores), then thread i carries head i's sum down the tile.
template <typename T>
__device__ __forceinline__ void prologue_dt_cum(const T* __restrict__ zx,
                                                const float* __restrict__ dt_bias,
                                                const float* __restrict__ A,
                                                float* __restrict__ dt, float* __restrict__ cum,
                                                long row0, float* s_v, float* s_run, int buf,
                                                const Dims& d) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* src = zx + d.di + d.dc;
#if PHT_PROLOGUE_DT_SERIAL
  for (int hh = tid; hh < d.h; hh += nt) {
    const float bias = dt_bias[hh], a = A[hh];
    float run = 0.f;
    for (int t = 0; t < d.q; ++t) {
      const float v = softplus(to_f32(src[(row0 + t) * d.W + hh]) + bias);
      run += v * a;
      dt[(row0 + t) * d.h + hh] = v;
      cum[(row0 + t) * d.h + hh] = run;
    }
  }
  return;
#endif
  for (int h0 = 0; h0 < d.h; h0 += buf) {
    const int hn = min(buf, d.h - h0), rt = min(d.q, max(1, buf / hn));
    for (int i = tid; i < hn; i += nt) s_run[i] = 0.f;
    for (int r0 = 0; r0 < d.q; r0 += rt) {
      const int rn = min(rt, d.q - r0);
      __syncthreads();  // the previous tile's sums have read s_v
      for (int idx = tid; idx < rn * hn; idx += nt) {
        const int r = idx / hn, hh = h0 + idx - r * hn;
        const long row = row0 + r0 + r;
        const float v = softplus(to_f32(src[row * d.W + hh]) + dt_bias[hh]);
        dt[row * d.h + hh] = v;
        s_v[idx] = v;
      }
      __syncthreads();
      for (int i = tid; i < hn; i += nt) {  // s_run[i]: only this thread's
        const int hh = h0 + i;
        const float a = A[hh];
        float run = s_run[i];
        for (int r = 0; r < rn; ++r) {
          run += s_v[r * hn + i] * a;
          cum[(row0 + r0 + r) * d.h + hh] = run;
        }
        s_run[i] = run;
      }
    }
  }
}

// CTA x of (slabs + 1) * nc * B: chunk-major, the slabs of a chunk and then
// its dt/cum CTA. Dynamic shared memory: the ring, [kProRing][blockDim]
// words (the dt/cum CTA reuses it as its two buffers).
template <typename T, int K>
__global__ void __launch_bounds__(256) ssd_prologue_vec_kernel(
    const T* __restrict__ zx, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ dt_bias,
    const float* __restrict__ A, float* __restrict__ xbc, float* __restrict__ dt,
    float* __restrict__ cum, int slabs, Dims d) {
  constexpr int N = kProCh;
  using Raw = typename rows::Vec<T, N>::Raw;
  extern __shared__ __align__(16) unsigned char pro_smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int slab = blockIdx.x % (slabs + 1), cb = blockIdx.x / (slabs + 1);
  const int c = cb % d.nc, b = cb / d.nc;
  if (slab == slabs) {
    const int buf = kProRing * nt * (int)sizeof(Raw) / 8;
    float* s_v = reinterpret_cast<float*>(pro_smem);
    prologue_dt_cum<T>(zx, dt_bias, A, dt, cum, (long)b * d.L + (long)c * d.q, s_v, s_v + buf,
                       buf, d);
    return;
  }
  const int grp = slab * nt + tid;
  if (grp >= d.dc / N) return;
  const int ch = grp * N;
  float w[K][N], bias[N];
  rows::load_taps<N, K>(conv_w, conv_b, d.dc, ch, w, bias);
  float* out = xbc + (long)b * d.L * d.dc + ch;
  rows::walk<T, N, K, kProRing>(
      zx + (long)b * d.L * d.W + d.di + ch, d.W, c * d.q, (c + 1) * d.q,
      reinterpret_cast<Raw*>(pro_smem) + tid, nt,
      [&](int t, const float (&xr)[N], const float (&win)[K][N]) {
        float o[N];
#pragma unroll
        for (int cc = 0; cc < N; ++cc) {
          float acc = __fmul_rn(xr[cc], w[K - 1][cc]);
#pragma unroll
          for (int j = 0; j < K - 1; ++j) acc = fmaf(win[j][cc], w[j][cc], acc);
          o[cc] = silu(acc + bias[cc]);
        }
        st4(out + (long)t * d.dc, o[0], o[1], o[2], o[3]);
      });
}

template <typename T, int K>
int launch_prologue_vec(const T* zx, const float* conv_w, const float* conv_b,
                        const float* dt_bias, const float* A, float* xbc, float* dt, float* cum,
                        const Dims& d, cudaStream_t s) {
  const int groups = d.dc / kProCh, nt = rows::cta_threads(groups);
  const int slabs = (groups + nt - 1) / nt;
  const size_t smem = (size_t)kProRing * nt * sizeof(typename rows::Vec<T, kProCh>::Raw);
  cudaError_t err = cudaFuncSetAttribute(ssd_prologue_vec_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long ctas = (long)(slabs + 1) * d.nc * d.B;
  ssd_prologue_vec_kernel<T, K><<<(unsigned)ctas, nt, smem, s>>>(zx, conv_w, conv_b, dt_bias, A,
                                                                  xbc, dt, cum, slabs, d);
  return (int)cudaGetLastError();
}

// The vec body refuses what it does not take: a window off the 16-byte rule
// or a tensor it reads or writes 16 bytes at a time that is not aligned
inline bool prologue_vec_refused(const void* zx, const void* conv_w, const void* conv_b,
                                 const void* xbc, const Dims& d, int esize) {
  return !prologue_vec_body(d.W, d.di, d.dc, esize) || !aligned16(zx) || !aligned16(conv_w) ||
         !aligned16(conv_b) || !aligned16(xbc);
}

// K7's launch 1 on the named body: vec (the caller has checked
// prologue_vec_refused) or the general ssd_prologue_kernel
template <typename T>
int launch_prologue(const T* zx, const float* conv_w, const float* conv_b, const float* dt_bias,
                    const float* A, float* xbc, float* dt, float* cum, const Dims& d, int vec,
                    cudaStream_t s) {
  if (!vec) {
    const int slabs = (d.dc + kThreads - 1) / kThreads;
    ssd_prologue_kernel<T><<<dim3(d.nc, d.B, slabs + 1), kThreads, 0, s>>>(
        zx, conv_w, conv_b, dt_bias, A, xbc, dt, cum, d);
    return (int)cudaGetLastError();
  }
  switch (d.k) {
#define PHT_PROLOGUE_K(K) \
    case K: return launch_prologue_vec<T, K>(zx, conv_w, conv_b, dt_bias, A, xbc, dt, cum, d, s);
    PHT_PROLOGUE_K(1) PHT_PROLOGUE_K(2) PHT_PROLOGUE_K(3) PHT_PROLOGUE_K(4) PHT_PROLOGUE_K(5)
    PHT_PROLOGUE_K(6) PHT_PROLOGUE_K(7) PHT_PROLOGUE_K(8) PHT_PROLOGUE_K(9)
#undef PHT_PROLOGUE_K
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- 4. chunk output, general body (K7 launch 4) ----------------------------
__host__ __device__ inline size_t output_smem_floats(int q, int n, int p) {
  const size_t ct = (size_t)n * (q + 4);
  return ct + (ct > (size_t)n * p ? ct : (size_t)n * p) + (size_t)q * q + (size_t)q * p + 2 * q;
}

// S: the type of the entering states (f32 in K7; the emitted copy in the
// input dtype when K8 recomputes the output).
template <typename S>
__global__ void __launch_bounds__(kThreads) ssd_chunk_output_kernel(
    const float* __restrict__ xbc, const float* __restrict__ dt,
    const float* __restrict__ cum, const S* __restrict__ states,
    const float* __restrict__ Dp, float* __restrict__ y, Dims d) {
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int q = d.q, n = d.n, p = d.p, ldq = q + 4;
  const long row0 = (long)b * d.L + (long)c * q;
  extern __shared__ __align__(16) float smem[];
  float* s_ct = smem;                                   // [n][q+4]  C^T
  float* s_bt = s_ct + (size_t)n * ldq;                 // [n][q+4]  B^T, then st [n][p]
  const size_t bt = (size_t)n * ldq > (size_t)n * p ? (size_t)n * ldq : (size_t)n * p;
  float* s_wt = s_bt + bt;                              // [q(j)][q(t)]  W^T
  float* s_x = s_wt + (size_t)q * q;                    // [q][p]
  float* s_cum = s_x + (size_t)q * p;                   // [q]
  float* s_dt = s_cum + q;                              // [q]

  for (int j = tid; j < q; j += kThreads) {
    s_cum[j] = cum[(row0 + j) * d.h + hh];
    s_dt[j] = dt[(row0 + j) * d.h + hh];
  }
  for (int idx = tid; idx < q * p; idx += kThreads) {
    const int j = idx / p, e = idx - j * p;
    s_x[idx] = xbc[(row0 + j) * d.dc + hh * p + e];
  }
  // B^T and C^T: a thread reads 4 tokens of one channel, stores 16 bytes
  for (int idx = tid; idx < 2 * n * (q / 4); idx += kThreads) {
    const int which = idx / (n * (q / 4)), rest = idx - which * n * (q / 4);
    const int i = rest % n, t0 = (rest / n) * 4;
    const float* src = xbc + (row0 + t0) * d.dc + d.di + which * n + i;
    st4((which ? s_ct : s_bt) + i * ldq + t0, src[0], src[d.dc], src[2 * d.dc], src[3 * d.dc]);
  }
  __syncthreads();

  // W^T[j][t] = (C_t . B_j) exp(cum_t - cum_j) dt_j for j <= t, else 0;
  // consecutive threads take consecutive row tiles t, so the stores are
  // conflict-free and B^T is a broadcast
  const int tq = q / 4;
  for (int tile = tid; tile < tq * tq; tile += kThreads) {
    const int t0 = (tile % tq) * 4, j0 = (tile / tq) * 4;
    float acc[4][4] = {};
    if (j0 <= t0 + 3)
      for (int k = 0; k < n; ++k) fma4x4(acc, ld4(s_ct + k * ldq + t0), ld4(s_bt + k * ldq + j0));
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + s;
      float o[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + r;
        o[r] = j <= t ? acc[r][s] * expf(s_cum[t] - s_cum[j]) * s_dt[j] : 0.f;
      }
      st4(s_wt + j * q + t0, o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();
  // the state entering this chunk replaces B^T
  const S* st_src = states + (((long)b * d.nc + c) * d.h + hh) * n * p;
  if constexpr (std::is_same<S, float>::value) {
    for (int idx = tid; idx < n * p / 4; idx += kThreads)
      reinterpret_cast<float4*>(s_bt)[idx] = reinterpret_cast<const float4*>(st_src)[idx];
  } else {
    for (int idx = tid; idx < n * p; idx += kThreads) s_bt[idx] = to_f32(st_src[idx]);
  }
  __syncthreads();

  const float Dh = Dp[hh];
  const int pc = p / 4;
  for (int tile = tid; tile < tq * pc; tile += kThreads) {
    const int t0 = (tile / pc) * 4, e0 = (tile % pc) * 4;
    float acc[4][4] = {};
    for (int k = 0; k < n; ++k) fma4x4(acc, ld4(s_ct + k * ldq + t0), ld4(s_bt + k * p + e0));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = expf(s_cum[t0 + r]);
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] *= e;
    }
    const int jend = min(q, t0 + 4);
    for (int j = 0; j < jend; ++j) fma4x4(acc, ld4(s_wt + j * q + t0), ld4(s_x + j * p + e0));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 xv = ld4(s_x + (t0 + r) * p + e0);
      st4(y + (row0 + t0 + r) * d.di + hh * p + e0, fmaf(xv.x, Dh, acc[r][0]),
          fmaf(xv.y, Dh, acc[r][1]), fmaf(xv.z, Dh, acc[r][2]), fmaf(xv.w, Dh, acc[r][3]));
    }
  }
}

// ---- 4. chunk output, tensor-core body (K7 launch 4) --------------------------
// One CTA of 16 warps per (chunk, batch) walks the heads: the scores C.B^T,
// shared by every head (ngroups 1), are computed once; per head, all threads
// form W = scores exp(cum_t - cum_j) dt_j (0 above the diagonal) once, and
// the warps compute y = W x + exp(cum) (C . st) + D x on tensor cores. The
// next head's x and entering state are copied by cp.async, and its cum and
// dt loaded into registers, while the current head computes. Layout
// (floats): scores, packed causal tiles (tri_sw) [tri][128] | W of the
// head, the same, B [q][n+4] before the scores are formed | C [q][n+4] |
// 2 x x [q][p+8] | 2 x the entering state [n][p+8] (S) | 2 x (cum, dt)
// [2q]. 221,184 bytes at q 128, n p 64. Warp w takes the row tiles
// {w % 4, 7 - w % 4} (q <= 128: at most 8; a short causal row tile paired
// with a long one, as every tensor-core kernel here pairs them) and the
// 8-column tiles w / 4 and w / 4 + 4 of the head's p columns.
__host__ __device__ inline size_t output_tc_floats(int q, int n, int p) {
  const size_t tri = (size_t)(q / 16) * (q / 16 + 1) * 128, bs = (size_t)q * (n + 4);
  return tri + (tri > bs ? tri : bs) + bs + 2 * (size_t)q * (p + 8) + 2 * (size_t)n * (p + 8) +
         4 * (size_t)q;
}

template <typename S>
__global__ void __launch_bounds__(kTcThreads, 1) ssd_chunk_output_tc_kernel(
    const float* __restrict__ xbc, const float* __restrict__ dt,
    const float* __restrict__ cum, const S* __restrict__ states,
    const float* __restrict__ Dp, float* __restrict__ y, Dims d) {
  using namespace tf32;
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = d.q, n = d.n, p = d.p, ldn = n + 4, ldp = p + 8;
  const int mts = q / 16, tri = mts * (mts + 1);
  const long row0 = (long)b * d.L + (long)c * q;
  extern __shared__ __align__(16) float smem[];
  const size_t tris = (size_t)tri * 128, bs = (size_t)q * ldn, xs = (size_t)q * ldp;
  float* s_g = smem;                          // scores, packed causal tiles
  float* s_w = s_g + tris;                    // W of the head, the same; first B [q][n+4]
  float* s_c = s_w + (tris > bs ? tris : bs); // [q][n+4]  C
  float* s_x = s_c + bs;                      // 2 x [q][p+8]  x of the head
  float* s_st = s_x + 2 * xs;                 // 2 x [n][p+8]  entering state (S)
  float* s_vec = s_st + 2 * (size_t)n * ldp;  // 2 x ([q] cum, [q] dt)
  const long st0 = ((long)b * d.nc + c) * d.h * n * p;

  auto stage_head = [&](int hh, int k) {
    stage<float>(s_x + k * xs, ldp, xbc + row0 * d.dc + hh * p, d.dc, q, p);
    stage<S>(reinterpret_cast<S*>(s_st + (size_t)k * n * ldp), ldp, states + st0 + (long)hh * n * p,
             p, n, p);
  };
  float next_cum = 0.f, next_dt = 0.f;  // threads t < q: the next head's cum_t, dt_t
  auto load_vec = [&](int hh) {
    if (tid < q) {
      next_cum = cum[(row0 + tid) * d.h + hh];
      next_dt = dt[(row0 + tid) * d.h + hh];
    }
  };
  auto store_vec = [&](int k) {
    if (tid < q) {
      s_vec[2 * k * q + tid] = next_cum;
      s_vec[2 * k * q + q + tid] = next_dt;
    }
  };
  stage<float>(s_c, ldn, xbc + row0 * d.dc + d.di + n, d.dc, q, n);
  stage<float>(s_w, ldn, xbc + row0 * d.dc + d.di, d.dc, q, n);  // B
  stage_head(0, 0);
  sm90::cp_async_commit();
  load_vec(0);
  store_vec(0);
  sm90::cp_async_wait<0>();
  __syncthreads();

  // scores[t][j] = C_t . B_j, once for all heads
  for (int u = warp; u < tri; u += kTcWarps) {
    const int2 at = tri_tile(u);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < n; k0 += 8) {
      const FragA a = load_a([&](int t, int i) { return s_c[t * ldn + i]; }, at.x, k0);
      const FragB bb = load_b([&](int i, int j) { return s_w[j * ldn + i]; }, k0, at.y);
      mma3(acc, a, bb);
    }
#pragma unroll
    for (int i = 0; i < 4; i += 2)
      *reinterpret_cast<float2*>(s_g + tri_sw(acc_row(at.x, i), acc_col(at.y, i))) =
          make_float2(acc[i], acc[i + 1]);
  }
  __syncthreads();  // B is dead: the region takes W

  const int rg = warp & 3, cg = warp >> 2, nt8 = p / 8;
  // this lane's A-fragment offsets in a packed tile (tri_sw): rows g, g + 8
  // (64 further), columns c (sw0) and c + 4 (sw2)
  const int g = lane >> 2, sw0 = g * 8 + ((lane & 3) ^ (g & 4)),
            sw2 = g * 8 + (((lane & 3) + 4) ^ (g & 4));
  for (int hh = 0; hh < d.h; ++hh) {
    const int k = hh & 1;
    if (hh + 1 < d.h) {
      stage_head(hh + 1, k ^ 1);
      load_vec(hh + 1);
    }
    sm90::cp_async_commit();
    const float* s_xk = s_x + k * xs;
    const S* s_s = reinterpret_cast<const S*>(s_st + (size_t)k * n * ldp);
    const float* s_cum = s_vec + 2 * k * q;
    const float* s_dt = s_cum + q;
    // W of this head, one tile a warp at a time, 4 elements a lane
    for (int u = warp; u < tri; u += kTcWarps) {
      const int2 at = tri_tile(u);
      const int r = lane >> 1, t = at.x + r, j0 = at.y + (((lane & 1) * 4) ^ (r & 4));
      const float4 g = *reinterpret_cast<const float4*>(s_g + u * 128 + lane * 4);
      const float gv[4] = {g.x, g.y, g.z, g.w}, ct = s_cum[t];
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + e;
        w[e] = j <= t ? gv[e] * expf(ct - s_cum[j]) * s_dt[j] : 0.f;
      }
      *reinterpret_cast<float4*>(s_w + u * 128 + lane * 4) = make_float4(w[0], w[1], w[2], w[3]);
    }
    // the readout of the entering state, C . st, while W is formed
    float acc[2][2][4] = {};
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      const int mt = sl ? 7 - rg : rg, r0 = 16 * mt;
      if (mt >= mts) continue;
      for (int k0 = 0; k0 < n; k0 += 8) {
        const FragA a = load_a([&](int t, int i) { return s_c[t * ldn + i]; }, r0, k0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int nt = cg + 4 * i;
          if (nt >= nt8) break;
          const FragB bb =
              load_b([&](int ii, int e) { return to_f32(s_s[ii * ldp + e]); }, k0, 8 * nt);
          mma3(acc[sl][i], a, bb);
        }
      }
      const float e0 = expf(s_cum[acc_row(r0, 0)]), e1 = expf(s_cum[acc_row(r0, 2)]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[sl][i][e] *= e < 2 ? e0 : e1;
    }
    __syncthreads();  // W is formed
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      const int mt = sl ? 7 - rg : rg, r0 = 16 * mt;
      if (mt >= mts) continue;
      const float* wt = s_w + mt * (mt + 1) * 128;  // row tile mt's first tile
      for (int k0 = 0; k0 < r0 + 16; k0 += 8, wt += 128) {  // W x, causal
        const FragA a = load_a_at(wt, sw0, sw0 + 64, sw2, sw2 + 64);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int nt = cg + 4 * i;
          if (nt >= nt8) break;
          const FragB bb = load_b([&](int j, int e) { return s_xk[j * ldp + e]; }, k0, 8 * nt);
          mma3(acc[sl][i], a, bb);
        }
      }
      const float Dh = Dp[hh];
      float* yh = y + row0 * d.di + hh * p;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int nt = cg + 4 * i;
        if (nt >= nt8) break;
#pragma unroll
        for (int e2 = 0; e2 < 4; e2 += 2) {
          const int t = acc_row(r0, e2), e = acc_col(8 * nt, e2);
          const float2 xv = *reinterpret_cast<const float2*>(s_xk + t * ldp + e);
          *reinterpret_cast<float2*>(yh + (long)t * d.di + e) =
              make_float2(fmaf(xv.x, Dh, acc[sl][i][e2]), fmaf(xv.y, Dh, acc[sl][i][e2 + 1]));
        }
      }
    }
    if (hh + 1 < d.h) store_vec(k ^ 1);
    sm90::cp_async_wait<0>();
    __syncthreads();
  }
}

// either body of the chunk output, as a kernel pointer
template <typename S>
using OutputKernel = void (*)(const float*, const float*, const float*, const S*, const float*,
                              float*, Dims);

// ---- the [n, p] block of every head, tensor-core body --------------------------
//   out_h[i][e] = sum_t M[t][i] v_h[t] X_h[t][e]
// K7's chunk state (launch 2): M = B, v = dt exp(cum_last - cum), X = x ->
// the states from a zero state. K8's dstate local (launch 4): M = C, v =
// exp(cum), X = dy_ssd -> the chunk's own term of the gradient of the state
// entering it. One CTA of 8 warps per (chunk, batch) stages M once and
// walks the heads, X double-buffered by cp.async, the next head's v loaded
// into registers; each warp takes up to 4 of the output's 16 x 8 tiles.
// (16 warps, each half of them summing half the tokens, ran slower.)
// Layout (floats): M [q][n+8] | 2 x X [q][p+8] | 2 x v [q].
enum HeadProduct { kChunkState = 0, kDstateLocal = 1 };

__host__ __device__ inline size_t head_state_tc_floats(int q, int n, int p) {
  return (size_t)q * (n + 8) + 2 * (size_t)q * (p + 8) + 2 * (size_t)q;
}

template <int Mode>
__device__ __forceinline__ void head_state_tc(const float* __restrict__ xbc,
                                              const float* __restrict__ dt,
                                              const float* __restrict__ cum,
                                              const float* __restrict__ dys,
                                              float* __restrict__ out, const Dims& d) {
  using namespace tf32;
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5;
  const int q = d.q, n = d.n, p = d.p, ldm = n + 8, ldp = p + 8;
  const long row0 = (long)b * d.L + (long)c * q;
  extern __shared__ __align__(16) float smem[];
  float* s_m = smem;                       // [q][n+8]  B or C
  float* s_x = s_m + (size_t)q * ldm;      // 2 x [q][p+8]  x or dy_ssd of a head
  float* s_v = s_x + 2 * (size_t)q * ldp;  // 2 x [q]
  const float* xsrc = Mode == kChunkState ? xbc + row0 * d.dc : dys + row0 * d.di;
  const long ldx = Mode == kChunkState ? d.dc : d.di;

  // threads t < q: the next head's cum_t (and dt_t, cum_last), loaded while
  // the current head computes; v_t = dt_t exp(cum_last - cum_t) or exp(cum_t)
  float next_cum = 0.f, next_dt = 0.f, next_last = 0.f;
  auto load_v = [&](int hh) {
    if (tid < q) {
      next_cum = cum[(row0 + tid) * d.h + hh];
      if (Mode == kChunkState) {
        next_dt = dt[(row0 + tid) * d.h + hh];
        next_last = cum[(row0 + q - 1) * d.h + hh];
      }
    }
  };
  auto store_v = [&](int k) {
    if (tid < q)
      s_v[k * q + tid] =
          Mode == kChunkState ? next_dt * expf(next_last - next_cum) : expf(next_cum);
  };
  stage<float>(s_m, ldm, xbc + row0 * d.dc + d.di + (Mode == kChunkState ? 0 : n), d.dc, q, n);
  stage<float>(s_x, ldp, xsrc, ldx, q, p);
  sm90::cp_async_commit();
  load_v(0);
  store_v(0);
  sm90::cp_async_wait<0>();
  __syncthreads();

  // the [n, p] output's 16 x 8 tiles, `per` consecutive ones a warp (<= 4)
  const int nt8 = p / 8, tiles = (n / 16) * nt8, per = (tiles + kWarps - 1) / kWarps;
  for (int hh = 0; hh < d.h; ++hh) {
    const int k = hh & 1;
    if (hh + 1 < d.h) {
      stage<float>(s_x + (size_t)(k ^ 1) * q * ldp, ldp, xsrc + (hh + 1) * p, ldx, q, p);
      load_v(hh + 1);
    }
    sm90::cp_async_commit();
    const float* X = s_x + (size_t)k * q * ldp;
    const float* v = s_v + k * q;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < q; k0 += 8) {
      int amt = -1;
      FragA a;
#pragma unroll
      for (int sl = 0; sl < 4; ++sl) {
        const int u = warp * per + sl;
        if (sl >= per || u >= tiles) break;
        const int mt = u / nt8;
        if (mt != amt) {
          a = load_a([&](int i, int t) { return s_m[t * ldm + i]; }, 16 * mt, k0);
          amt = mt;
        }
        const FragB bb = load_b([&](int t, int e) { return X[t * ldp + e] * v[t]; }, k0,
                                8 * (u - mt * nt8));
        mma3(acc[sl], a, bb);
      }
    }
    float* o = out + (((long)b * d.nc + c) * d.h + hh) * n * p;
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
      const int u = warp * per + sl;
      if (sl >= per || u >= tiles) break;
      const int mt = u / nt8, n0 = 8 * (u - mt * nt8);
#pragma unroll
      for (int i = 0; i < 4; i += 2)
        *reinterpret_cast<float2*>(o + acc_row(16 * mt, i) * p + acc_col(n0, i)) =
            make_float2(acc[sl][i], acc[sl][i + 1]);
    }
    if (hh + 1 < d.h) store_v(k ^ 1);
    sm90::cp_async_wait<0>();
    __syncthreads();
  }
}

// K7 launch 2 and K8 launch 4 (named apart for the profiles)
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_state_tc_kernel(
    const float* __restrict__ xbc, const float* __restrict__ dt, const float* __restrict__ cum,
    float* __restrict__ states, Dims d) {
  head_state_tc<kChunkState>(xbc, dt, cum, nullptr, states, d);
}

__global__ void __launch_bounds__(kThreads, 1) ssd_dstate_local_tc_kernel(
    const float* __restrict__ xbc, const float* __restrict__ cum, const float* __restrict__ dys,
    float* __restrict__ dstate, Dims d) {
  head_state_tc<kDstateLocal>(xbc, nullptr, cum, dys, dstate, d);
}

}  // namespace
