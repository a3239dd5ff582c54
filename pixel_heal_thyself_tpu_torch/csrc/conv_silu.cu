// Fused causal depthwise conv1d + bias + SiLU over a column window of the
// Mamba2 in-projection output: forward (kernel K9) and backward (kernel K10)
// of the PyTorch port.
//
// Replaces the TPU kernels in pixel_heal_thyself_tpu/ops/conv_pallas.py:
// `_fwd_kernel` (:147, launched by `_fwd` :219, `pallas_call` :229) and
// `_bwd_kernel` (:158, `_bwd` :260, `pallas_call` :270). From zxbcdt
// [B, L, W] (bf16 or f32), the column window x = zxbcdt[..., off:off + C],
// f32 taps w [k, C] and bias b [C] (packed as wb [k + 1, C]):
//   K9:  pre[t] = w[k-1] x[t] + sum_{j < k-1} w[j] x[t - (k-1) + j] + b
//        (rows before t = 0 read as zero);  y[t] = round_T(silu(pre[t]))
//   K10: dpre[t] = dy[t] silu'(pre[t])  (dy in T; pre recomputed, not saved)
//        dx[t] = round_T(w[k-1] dpre[t] + sum_{j < k-1} w[j] dpre[t + k-1-j])
//        (rows past L read as zero), and the f32 sums over batch and rows
//        dw[j] = sum dpre[t] x[t - (k-1) + j], db = sum dpre[t].
// Each product and sum is rounded in f32 in the order of the plain versions
// (ops/conv_fused.py), with no FMA contraction, and silu(p) = p * (1 / (1 +
// exp(-p))) as PyTorch's sigmoid computes it, so y and dx are the plain
// versions' values on the card; only the order of the dw/db sums differs.
// K7's prologue (ssd_chain.cuh) computes the same conv with FMAs into f32.
// The general bodies walk one channel a thread down the rows with the k - 1
// previous raw rows in registers (k a template argument).
//
// Design. The TPU kernels walk the row tiles of a sequence in a sequential
// grid, DMA an 8-row context beside each tile and accumulate dw/db per batch
// element across the tiles. Here a CTA owns `rows` rows of one batch element
// and a slab of 128 channels, and reads the window straight out of zxbcdt
// (row stride W, no sliced copy) with its neighbours' context rows: K9 the
// k - 1 rows before the tile, K10 also the k - 1 rows after it, whose dpre it
// recomputes for the anti-causal taps. K10 writes per-(batch, tile) f32 tap
// and bias partials; a second launch adds them in a fixed order. No float
// atomics: both are deterministic.
//
// What bounds them on the H100: memory. At the prod shape (B 8, L 16,384,
// C 1152 of W 2192, k 4, bf16) K9 reads the window and writes y (604 MB:
// 0.18 ms at 3.35 TB/s) and K10 reads the window and dy and writes dx
// (906 MB: 0.27 ms), against 0.15 and 0.3 GFLOP. In K9 and K10's general
// body a warp reads 32 consecutive channels of a row (64 bytes in bf16),
// one 2-byte load a thread and row, from rows 4,384 bytes apart.
//
// Both have a second body, "vec", for windows whose offset, row stride and
// width are multiples of 16 bytes (`vec_body`; the prod window: 2,048,
// 4,384 and 2,304 bytes): a thread takes 4 channels (8 bytes of bf16, 16
// of f32), reads the window row (and K10 dy) and writes y (dx) that many
// bytes at a time, and keeps rows of its window (and dy) in flight through
// its own slots of a cp.async ring in shared memory (a thread reads back
// only what it copied, so no barrier is needed; K9's walk is
// conv_rows.cuh's). The CTAs are the whole warps that leave the fewest
// lanes idle (96 threads at width 1152). Their arithmetic is the general
// bodies', channel by channel, in the same order, so y and dx are the same
// bits. 8 bf16 channels a thread (16-byte rows) took K10 181 registers and
// ran twice as slow (PERF.md): the vec bodies are held back by their
// instructions (K10 about 45 a channel and row, K9 about 25, with the
// sigmoid's exp and division) more than by their bytes.

#include "common.cuh"
#include "conv_rows.cuh"
#include "sm90_gemm.cuh"  // cp.async

namespace {

using namespace pht;

constexpr int kThreads = 128;  // channels per CTA
constexpr int kMaxK = 9;       // d_conv <= 9, the TPU kernel's gate (k <= _CTX + 1)

struct ConvDims {
  int B, L, W, off, C, k, rows, tiles;
};

__device__ __forceinline__ float sigmoid_rn(float p) { return 1.f / (1.f + expf(-p)); }

// The kernels take k as a template argument: with a run-time k the
// compiler folds the masked tap loops into indexed loads and keeps the tap
// arrays in local memory.

// The pre-activation of a row from its raw value xr and the K - 1 raw rows
// before it (win[0] the oldest), in the plain version's order and rounding.
template <int K>
__device__ __forceinline__ float conv_pre(const float (&w)[K], const float (&win)[K], float xr,
                                          float bias) {
  float acc = __fmul_rn(xr, w[K - 1]);
#pragma unroll
  for (int j = 0; j < K - 1; ++j) acc = __fadd_rn(acc, __fmul_rn(win[j], w[j]));
  return __fadd_rn(acc, bias);
}

// Slide the raw-row window by one row: drop the oldest, append xr.
template <int K>
__device__ __forceinline__ void push(float (&win)[K], float xr) {
#pragma unroll
  for (int j = 0; j + 1 < K - 1; ++j) win[j] = win[j + 1];
  if constexpr (K > 1) win[K - 2] = xr;
}

// The taps, the bias and the raw rows before row t0 of one channel (win
// has K entries so that K = 1 needs no empty array; the last is unused).
template <typename T, int K>
__device__ __forceinline__ float load_channel(const T* src, const float* wb, int ch, int t0,
                                              const ConvDims& d, float (&w)[K],
                                              float (&win)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) w[j] = wb[(long)j * d.C + ch];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int t = t0 - (K - 1) + j;
    win[j] = (j < K - 1 && t >= 0) ? to_f32(src[(long)t * d.W]) : 0.f;
  }
  return wb[(long)K * d.C + ch];
}

// ---- K9: forward ---------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kThreads) conv_silu_fwd_kernel(
    const T* __restrict__ zx, const float* __restrict__ wb, T* __restrict__ y, ConvDims d) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= d.C) return;
  const int b = blockIdx.z, t0 = blockIdx.y * d.rows, t1 = min(d.L, t0 + d.rows);
  const T* src = zx + (long)b * d.L * d.W + d.off + ch;
  T* out = y + (long)b * d.L * d.C + ch;
  float w[K], win[K];
  const float bias = load_channel<T, K>(src, wb, ch, t0, d, w, win);
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    const float xr = to_f32(src[(long)t * d.W]);
    const float pre = conv_pre<K>(w, win, xr, bias);
    out[(long)t * d.C] = from_f32<T>(__fmul_rn(pre, sigmoid_rn(pre)));
    push<K>(win, xr);
  }
}

// ---- K10: backward -------------------------------------------------------------
template <typename T, int K>
__global__ void __launch_bounds__(kThreads) conv_silu_bwd_kernel(
    const T* __restrict__ zx, const float* __restrict__ wb, const T* __restrict__ dy,
    T* __restrict__ dx, float* __restrict__ part, ConvDims d) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= d.C) return;
  const int tile = blockIdx.y, b = blockIdx.z;
  const int t0 = tile * d.rows, t1 = min(d.L, t0 + d.rows);
  const T* src = zx + (long)b * d.L * d.W + d.off + ch;
  const T* g = dy + (long)b * d.L * d.C + ch;
  T* out = dx + (long)b * d.L * d.C + ch;
  float w[K], win[K];
  const float bias = load_channel<T, K>(src, wb, ch, t0, d, w, win);
  // rv[i] = dpre of the row i rows back; dw/db: this tile's f32 sums
  float rv[K], dw[K];
#pragma unroll
  for (int i = 0; i < K; ++i) rv[i] = dw[i] = 0.f;
  float db = 0.f;
  // dx of rows [t0, t1) reads dpre up to row t1 + K - 2
  for (int t = t0; t < t1 + K - 1; ++t) {
    const bool in = t < d.L;
    const float xr = in ? to_f32(src[(long)t * d.W]) : 0.f;
    float dp = 0.f;
    if (in) {
      const float pre = conv_pre<K>(w, win, xr, bias);
      const float s = sigmoid_rn(pre);
      const float ds = __fmul_rn(s, __fadd_rn(1.f, __fmul_rn(pre, __fsub_rn(1.f, s))));
      dp = __fmul_rn(to_f32(g[(long)t * d.C]), ds);
    }
    if (t < t1) {
#pragma unroll
      for (int j = 0; j < K - 1; ++j) dw[j] = fmaf(dp, win[j], dw[j]);
      dw[K - 1] = fmaf(dp, xr, dw[K - 1]);
      db += dp;
    }
#pragma unroll
    for (int i = K - 1; i > 0; --i) rv[i] = rv[i - 1];
    rv[0] = dp;
    if (t >= t0 + K - 1) {  // dx of row t - (K - 1): w[K-1] dpre there, then the taps
      float acc = __fmul_rn(rv[K - 1], w[K - 1]);
#pragma unroll
      for (int j = 0; j < K - 1; ++j) acc = __fadd_rn(acc, __fmul_rn(rv[j], w[j]));
      out[(long)(t - (K - 1)) * d.C] = from_f32<T>(acc);
    }
    push<K>(win, xr);
  }
  float* p = part + ((long)b * d.tiles + tile) * (K + 1) * d.C + ch;
#pragma unroll
  for (int j = 0; j < K; ++j) p[(long)j * d.C] = dw[j];
  p[(long)K * d.C] = db;
}

// ---- K10, the vec body -----------------------------------------------------------
constexpr int kVecRing = 8;  // rows of the window and dy in flight per thread
// channels a thread: 4 (8 bytes of bf16, 16 of f32), or 2 (bench_scan.py's
// variant)
#ifndef PHT_CONV_VEC_CH
#define PHT_CONV_VEC_CH 4
#endif
constexpr int kVecCh = PHT_CONV_VEC_CH;

// Windows the vec body takes: offset, row stride and width multiples of 16
// bytes (with 16-byte aligned tensors, which the C entry checks)
__host__ __device__ inline bool vec_body(int W, int off, int C, int esize) {
  return esize > 0 && off % (16 / esize) == 0 && W % (16 / esize) == 0 && C % (16 / esize) == 0;
}

// kVecCh values of T as they sit in memory, as floats, and back
template <typename T>
using VecOf = rows::Vec<T, kVecCh>;

// One thread: kVecCh channels of one (batch, row tile); the CTA's threads
// take consecutive channel groups. The ring holds, per stage, the window
// row and the dy row of every thread: [kVecRing][2][blockDim] words of
// dynamic shared memory. The row loop runs in rounds of K rows, so that
// the last K raw rows and dpre values sit in circular registers whose
// slots are known at compile time: slot (t - t0) % K holds row t.
template <typename T, int K>
__global__ void __launch_bounds__(256) conv_silu_bwd_vec_kernel(
    const T* __restrict__ zx, const float* __restrict__ wb, const T* __restrict__ dy,
    T* __restrict__ dx, float* __restrict__ part, ConvDims d) {
  using V = VecOf<T>;
  using Raw = typename V::Raw;
  constexpr int N = kVecCh;
  extern __shared__ __align__(16) unsigned char ring_raw[];
  Raw* ring = reinterpret_cast<Raw*>(ring_raw);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int grp = blockIdx.x * nt + tid;
  if (grp >= d.C / N) return;
  const int ch = grp * N, tile = blockIdx.y, b = blockIdx.z;
  const int t0 = tile * d.rows, t1 = min(d.L, t0 + d.rows), tend = min(d.L, t1 + K - 1);
  const int tstop = t1 + K - 1;  // dx of rows [t0, t1) reads dpre up to row t1 + K - 2
  const T* src = zx + (long)b * d.L * d.W + d.off + ch;
  const T* g = dy + (long)b * d.L * d.C + ch;
  T* out = dx + (long)b * d.L * d.C + ch;
  // row t's window and dy into its ring slot (zeros past the rows the tile reads)
  auto issue = [&](int t) {
    const int s = (t - t0) % kVecRing;
    const bool in = t < tend;
    const long r = in ? t : t0;
    V::copy(ring + (2 * s) * nt + tid, src + r * d.W, in);
    V::copy(ring + (2 * s + 1) * nt + tid, g + r * d.C, in);
  };
  for (int i = 0; i < kVecRing - 1; ++i) {
    issue(t0 + i);
    sm90::cp_async_commit();
  }
  float w[K][N], bias[N];
  rows::load_taps<N, K>(wb, wb + (long)K * d.C, d.C, ch, w, bias);
  // raw[s]: the raw row in slot s; rows t0 - K + 1 .. t0 - 1 sit in slots 1 .. K - 1
  float raw[K][N], dpre[K][N], dw[K][N], db[N];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int t = t0 - K + s;
    float f[N] = {};
    if (s > 0 && t >= 0) V::get(*reinterpret_cast<const Raw*>(src + (long)t * d.W), f);
#pragma unroll
    for (int c = 0; c < N; ++c) {
      raw[s][c] = f[c];
      dpre[s][c] = dw[s][c] = 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < N; ++c) db[c] = 0.f;
  for (int tr = t0; tr < tstop; tr += K) {
#pragma unroll
    for (int ph = 0; ph < K; ++ph) {  // row t, slot ph
      const int t = tr + ph;
      if (t >= tstop) break;
      issue(t + kVecRing - 1);
      sm90::cp_async_commit();
      sm90::cp_async_wait<kVecRing - 1>();
      const int s = (t - t0) % kVecRing;
      float xr[N], gv[N], o[N];
      V::get(ring[(2 * s) * nt + tid], xr);
      V::get(ring[(2 * s + 1) * nt + tid], gv);
      const bool in = t < d.L;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        // the window: raw rows t - K + 1 + j in slots (ph + 1 + j) % K
        float dp = 0.f;
        if (in) {
          float acc = __fmul_rn(xr[c], w[K - 1][c]);
#pragma unroll
          for (int j = 0; j < K - 1; ++j)
            acc = __fadd_rn(acc, __fmul_rn(raw[(ph + 1 + j) % K][c], w[j][c]));
          const float pre = __fadd_rn(acc, bias[c]);
          const float sg = sigmoid_rn(pre);
          const float ds = __fmul_rn(sg, __fadd_rn(1.f, __fmul_rn(pre, __fsub_rn(1.f, sg))));
          dp = __fmul_rn(gv[c], ds);
        }
        if (t < t1) {
#pragma unroll
          for (int j = 0; j < K - 1; ++j) dw[j][c] = fmaf(dp, raw[(ph + 1 + j) % K][c], dw[j][c]);
          dw[K - 1][c] = fmaf(dp, xr[c], dw[K - 1][c]);
          db[c] += dp;
        }
        raw[ph][c] = xr[c];
        dpre[ph][c] = dp;
        // dx of row t - (K - 1): w[K-1] dpre there, then tap j on the
        // dpre of row t - j (slot (ph - j) % K)
        float acc = __fmul_rn(dpre[(ph + 1) % K][c], w[K - 1][c]);
#pragma unroll
        for (int j = 0; j < K - 1; ++j)
          acc = __fadd_rn(acc, __fmul_rn(dpre[(ph - j + K) % K][c], w[j][c]));
        o[c] = acc;
      }
      if (t >= t0 + K - 1) *reinterpret_cast<Raw*>(out + (long)(t - (K - 1)) * d.C) = V::put(o);
    }
  }
  sm90::cp_async_wait<0>();
  float* pp = part + ((long)b * d.tiles + tile) * (K + 1) * d.C + ch;
#pragma unroll
  for (int j = 0; j <= K; ++j)
#pragma unroll
    for (int c = 0; c < N; c += 2)
      *reinterpret_cast<float2*>(pp + (long)j * d.C + c) =
          make_float2(j < K ? dw[j][c] : db[c], j < K ? dw[j][c + 1] : db[c + 1]);
}

// ---- K9, the vec body -------------------------------------------------------------
// rows of the window in flight per thread (bench_scan.py's variants change it)
#ifndef PHT_CONV_FWD_RING
#define PHT_CONV_FWD_RING 8
#endif
constexpr int kFwdRing = PHT_CONV_FWD_RING;

// One thread: 4 channels of one (batch, row tile), walked as rows::walk
// walks them; the CTA's threads take consecutive channel groups; the ring
// is [kFwdRing][blockDim] words of dynamic shared memory. The arithmetic is
// the general body's (conv_pre, then y = pre * sigmoid(pre)), channel by
// channel, and y leaves 8 (bf16) or 16 (f32) bytes at a time.
template <typename T, int K>
__global__ void __launch_bounds__(256) conv_silu_fwd_vec_kernel(
    const T* __restrict__ zx, const float* __restrict__ wb, T* __restrict__ y, ConvDims d) {
  constexpr int N = 4;
  using V = rows::Vec<T, N>;
  using Raw = typename V::Raw;
  extern __shared__ __align__(16) unsigned char ring_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int grp = blockIdx.x * nt + tid;
  if (grp >= d.C / N) return;
  const int ch = grp * N, b = blockIdx.z;
  const int t0 = blockIdx.y * d.rows, t1 = min(d.L, t0 + d.rows);
  T* out = y + (long)b * d.L * d.C + ch;
  float w[K][N], bias[N];
  rows::load_taps<N, K>(wb, wb + (long)K * d.C, d.C, ch, w, bias);
  rows::walk<T, N, K, kFwdRing>(
      zx + (long)b * d.L * d.W + d.off + ch, d.W, t0, t1, reinterpret_cast<Raw*>(ring_raw) + tid,
      nt, [&](int t, const float (&xr)[N], const float (&win)[K][N]) {
        float o[N];
#pragma unroll
        for (int c = 0; c < N; ++c) {
          float wc[K], winc[K];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            wc[j] = w[j][c];
            winc[j] = win[j][c];
          }
          const float pre = conv_pre<K>(wc, winc, xr[c], bias[c]);
          o[c] = __fmul_rn(pre, sigmoid_rn(pre));
        }
        *reinterpret_cast<Raw*>(out + (long)t * d.C) = V::put(o);
      });
}

// out[i] = sum_s part[s * len + i] in a fixed order: warp v of 8 adds the
// splits s = v, v + 8, ... in turn, then the 8 sums are added in warp order.
__global__ void __launch_bounds__(256) sum_tiles_kernel(const float* __restrict__ part,
                                                        float* __restrict__ out, int len,
                                                        int splits) {
  __shared__ float s_sum[8][32];
  const int lane = threadIdx.x & 31, v = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < len)
    for (int k = v; k < splits; k += 8) s += part[(long)k * len + i];
  s_sum[v][lane] = s;
  __syncthreads();
  if (v == 0 && i < len) {
    float t = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) t += s_sum[u][lane];
    out[i] = t;
  }
}

bool valid(const ConvDims& d) {
  return d.B > 0 && d.L > 0 && d.C > 0 && d.k >= 1 && d.k <= kMaxK && d.off >= 0 &&
         d.off + d.C <= d.W && d.rows > 0 && d.tiles <= 65535 && d.B <= 65535;
}

ConvDims dims(int B, int L, int W, int off, int C, int k, int rows) {
  ConvDims d;
  d.B = B; d.L = L; d.W = W; d.off = off; d.C = C; d.k = k; d.rows = rows;
  d.tiles = rows > 0 ? (L + rows - 1) / rows : 0;
  return d;
}


template <typename T, int K>
int launch_fwd(const void* zx, const void* wb, void* y, ConvDims d, int vec, cudaStream_t s) {
  if (vec) {
    const int groups = d.C / 4, nt = rows::cta_threads(groups);
    const size_t smem = (size_t)kFwdRing * nt * sizeof(typename rows::Vec<T, 4>::Raw);
    const dim3 grid((groups + nt - 1) / nt, d.tiles, d.B);
    cudaError_t err = cudaFuncSetAttribute(conv_silu_fwd_vec_kernel<T, K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    conv_silu_fwd_vec_kernel<T, K><<<grid, nt, smem, s>>>(
        static_cast<const T*>(zx), static_cast<const float*>(wb), static_cast<T*>(y), d);
  } else {
    const dim3 grid((d.C + kThreads - 1) / kThreads, d.tiles, d.B);
    conv_silu_fwd_kernel<T, K><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(zx), static_cast<const float*>(wb), static_cast<T*>(y), d);
  }
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_bwd(const void* zx, const void* wb, const void* dy, void* dx, void* part, void* dwb,
               ConvDims d, int vec, cudaStream_t s) {
  if (vec) {
    const int groups = d.C / kVecCh, nt = rows::cta_threads(groups);
    const size_t smem = (size_t)kVecRing * 2 * nt * sizeof(typename VecOf<T>::Raw);
    const dim3 grid((groups + nt - 1) / nt, d.tiles, d.B);
    cudaError_t err = cudaFuncSetAttribute(conv_silu_bwd_vec_kernel<T, K>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    conv_silu_bwd_vec_kernel<T, K><<<grid, nt, smem, s>>>(
        static_cast<const T*>(zx), static_cast<const float*>(wb), static_cast<const T*>(dy),
        static_cast<T*>(dx), static_cast<float*>(part), d);
  } else {
    const dim3 grid((d.C + kThreads - 1) / kThreads, d.tiles, d.B);
    conv_silu_bwd_kernel<T, K><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(zx), static_cast<const float*>(wb), static_cast<const T*>(dy),
        static_cast<T*>(dx), static_cast<float*>(part), d);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = (K + 1) * d.C;
  sum_tiles_kernel<<<(len + 31) / 32, 256, 0, s>>>(static_cast<const float*>(part),
                                                   static_cast<float*>(dwb), len,
                                                   d.B * d.tiles);
  return (int)cudaGetLastError();
}

// The launch for d.k in [1, kMaxK]: f<T, k>(args...).
#define PHT_CONV_DISPATCH(F, T, ...)                         \
  switch (d.k) {                                             \
    case 1: return F<T, 1>(__VA_ARGS__);                     \
    case 2: return F<T, 2>(__VA_ARGS__);                     \
    case 3: return F<T, 3>(__VA_ARGS__);                     \
    case 4: return F<T, 4>(__VA_ARGS__);                     \
    case 5: return F<T, 5>(__VA_ARGS__);                     \
    case 6: return F<T, 6>(__VA_ARGS__);                     \
    case 7: return F<T, 7>(__VA_ARGS__);                     \
    case 8: return F<T, 8>(__VA_ARGS__);                     \
    case 9: return F<T, 9>(__VA_ARGS__);                     \
    default: return (int)cudaErrorInvalidValue;             \
  }

template <typename T>
int fwd(const void* zx, const void* wb, void* y, ConvDims d, int vec, cudaStream_t s) {
  PHT_CONV_DISPATCH(launch_fwd, T, zx, wb, y, d, vec, s)
}

template <typename T>
int bwd(const void* zx, const void* wb, const void* dy, void* dx, void* part, void* dwb,
        ConvDims d, int vec, cudaStream_t s) {
  PHT_CONV_DISPATCH(launch_bwd, T, zx, wb, dy, dx, part, dwb, d, vec, s)
}

}  // namespace

extern "C" {

// 1: K9's vec body takes this window (row stride W, offset, width) in this
// dtype; 0: the general body. The same rule as K10's.
int pht_conv_silu_fwd_body(int W, int off, int C, int is_bf16) {
  return vec_body(W, off, C, is_bf16 ? 2 : 4) ? 1 : 0;
}

// zxbcdt [B, L, W] (bf16 or f32); wb [k + 1, C] f32 (taps, then the bias);
// y [B, L, C] in zxbcdt's dtype. A CTA takes `rows` rows. vec: the body
// (pht_conv_silu_fwd_body); a window or tensor the vec body does not take
// is refused before anything launches.
int pht_conv_silu_fwd(const void* zx, const void* wb, void* y, int B, int L, int W, int off,
                      int C, int k, int rows, int is_bf16, int vec, void* stream) {
  const ConvDims d = dims(B, L, W, off, C, k, rows);
  if (!valid(d) || (vec && (!pht_conv_silu_fwd_body(W, off, C, is_bf16) || !aligned16(zx) ||
                            !aligned16(wb) || !aligned16(y))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd<bf16>(zx, wb, y, d, vec, s) : fwd<float>(zx, wb, y, d, vec, s);
}

// 1: K10's vec body takes this window (row stride W, offset, width) in
// this dtype; 0: the general body
int pht_conv_silu_bwd_body(int W, int off, int C, int is_bf16) {
  return vec_body(W, off, C, is_bf16 ? 2 : 4) ? 1 : 0;
}

// As the forward, with dy and dx [B, L, C] in zxbcdt's dtype, f32 scratch
// part [B * ceil(L / rows), k + 1, C] and the f32 output dwb [k + 1, C].
// vec: the body (pht_conv_silu_bwd_body); a window or tensor the vec body
// does not take is refused before anything launches.
int pht_conv_silu_bwd(const void* zx, const void* wb, const void* dy, void* dx, void* part,
                      void* dwb, int B, int L, int W, int off, int C, int k, int rows,
                      int is_bf16, int vec, void* stream) {
  const ConvDims d = dims(B, L, W, off, C, k, rows);
  if (!valid(d) || (vec && (!pht_conv_silu_bwd_body(W, off, C, is_bf16) || !aligned16(zx) ||
                            !aligned16(wb) || !aligned16(dy) || !aligned16(dx) ||
                            !aligned16(part))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd<bf16>(zx, wb, dy, dx, part, dwb, d, vec, s)
                 : bwd<float>(zx, wb, dy, dx, part, dwb, d, vec, s);
}

}  // extern "C"
