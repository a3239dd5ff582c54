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
// K7's prologue (ssd_chain.cuh) computes the same conv with FMAs into f32;
// these kernels keep its design: one thread walks one channel down the rows
// with the k - 1 previous raw rows in registers (k a template argument).
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
// (906 MB: 0.27 ms), against 0.15 and 0.3 GFLOP. A warp reads 32
// consecutive channels of a row (64 bytes in bf16); wider loads per thread
// and staging through shared memory are later work.

#include "common.cuh"

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
int launch_fwd(const void* zx, const void* wb, void* y, ConvDims d, cudaStream_t s) {
  const dim3 grid((d.C + kThreads - 1) / kThreads, d.tiles, d.B);
  conv_silu_fwd_kernel<T, K><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(zx), static_cast<const float*>(wb), static_cast<T*>(y), d);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_bwd(const void* zx, const void* wb, const void* dy, void* dx, void* part, void* dwb,
               ConvDims d, cudaStream_t s) {
  const dim3 grid((d.C + kThreads - 1) / kThreads, d.tiles, d.B);
  conv_silu_bwd_kernel<T, K><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(zx), static_cast<const float*>(wb), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(part), d);
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
int fwd(const void* zx, const void* wb, void* y, ConvDims d, cudaStream_t s) {
  PHT_CONV_DISPATCH(launch_fwd, T, zx, wb, y, d, s)
}

template <typename T>
int bwd(const void* zx, const void* wb, const void* dy, void* dx, void* part, void* dwb,
        ConvDims d, cudaStream_t s) {
  PHT_CONV_DISPATCH(launch_bwd, T, zx, wb, dy, dx, part, dwb, d, s)
}

}  // namespace

extern "C" {

// zxbcdt [B, L, W] (bf16 or f32); wb [k + 1, C] f32 (taps, then the bias);
// y [B, L, C] in zxbcdt's dtype. A CTA takes `rows` rows.
int pht_conv_silu_fwd(const void* zx, const void* wb, void* y, int B, int L, int W, int off,
                      int C, int k, int rows, int is_bf16, void* stream) {
  const ConvDims d = dims(B, L, W, off, C, k, rows);
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd<bf16>(zx, wb, y, d, s) : fwd<float>(zx, wb, y, d, s);
}

// As the forward, with dy and dx [B, L, C] in zxbcdt's dtype, f32 scratch
// part [B * ceil(L / rows), k + 1, C] and the f32 output dwb [k + 1, C].
int pht_conv_silu_bwd(const void* zx, const void* wb, const void* dy, void* dx, void* part,
                      void* dwb, int B, int L, int W, int off, int C, int k, int rows,
                      int is_bf16, void* stream) {
  const ConvDims d = dims(B, L, W, off, C, k, rows);
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd<bf16>(zx, wb, dy, dx, part, dwb, d, s)
                 : bwd<float>(zx, wb, dy, dx, part, dwb, d, s);
}

}  // extern "C"
