// Block-halo attention forward (kernel K1 of the PyTorch port).
//
// Replaces the TPU kernel `_fwd_kernel` in
// pixel_heal_thyself_tpu/ops/attention_pallas.py:217 (launched by
// `_attention_fwd`, :325) and the attention stage `_attention_block_row`
// that the whole-block kernel pixel_heal_thyself_tpu/ops/block_mega.py:285
// embeds verbatim.
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
// f32; every product is a true f32 FMA (no TF32).
//
// Layout: q, k, v, residual, out are unpadded NHWC [B, H, W, C], head h
// owning channels [h*hd, (h+1)*hd). The TPU kernel's W-halo-padded layout
// existed only for sublane alignment and is not needed here.
//
// What bounds it on the H100: shared-memory bandwidth. Each CTA stages its
// q block, its key window (transposed, bias folded in) and its value
// window in shared memory (bf16 at prod: 8 + 25 + 25 KB) plus the f32
// logits (64 x 196 = 50 KB), 106 KB in all, so two CTAs fit an SM. Global
// traffic is small: a window is re-read by its neighbours from L2. The two
// products run as scalar FMAs from shared memory, register-blocked over 8
// query rows so each key/value element read from shared memory feeds 8
// FMAs. Tensor cores (mma.sync / wgmma) are left for a later optimisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kRows = 8;  // query rows per work item (register blocking)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int bs, int halo, int hd, size_t elem) {
  const size_t nq = (size_t)bs * bs;
  const size_t nk = (size_t)(bs + 2 * halo) * (bs + 2 * halo);
  return nq * nk * sizeof(float) + (nq * hd + 2 * nk * hd) * elem;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w,
    const T* __restrict__ res, T* __restrict__ out,
    int H, int W, int C, int bs, int halo, int heads, float scale) {
  const int hd = C / heads;
  const int half = hd / 2;
  const int window = bs + 2 * halo;
  const int nq = bs * bs;
  const int nk = window * window;
  const int wb = W / bs;
  const int hb = H / bs;
  const int head = blockIdx.y;
  int t = blockIdx.x;  // (b * hb + by) * wb + bx
  const int bx = t % wb;
  t /= wb;
  const int by = t % hb;
  const int b = t / hb;
  const int c0 = head * hd;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_p = reinterpret_cast<float*>(smem);  // [nq][nk] logits, then probs
  T* s_q = reinterpret_cast<T*>(s_p + (size_t)nq * nk);  // [nq][hd]
  T* s_kt = s_q + (size_t)nq * hd;                        // [hd][nk]
  T* s_v = s_kt + (size_t)hd * nk;                        // [nk][hd]

  const int64_t plane = (int64_t)H * W;
  // ---- stage q, k + rel bias (transposed), v --------------------------
  for (int idx = tid; idx < nq * hd; idx += kThreads) {
    const int i = idx / hd, d = idx - (idx / hd) * hd;
    const int y = by * bs + i / bs, x = bx * bs + i % bs;
    s_q[idx] = q[((b * plane) + (int64_t)y * W + x) * C + c0 + d];
  }
  for (int idx = tid; idx < nk * hd; idx += kThreads) {
    const int j = idx / hd, d = idx - (idx / hd) * hd;
    const int wy = j / window, wx = j - (j / window) * window;
    const int y = by * bs - halo + wy, x = bx * bs - halo + wx;
    const bool inside = y >= 0 && y < H && x >= 0 && x < W;
    float kval = 0.f;
    T vval = from_f32<T>(0.f);
    if (inside) {
      const int64_t off = ((b * plane) + (int64_t)y * W + x) * C + c0 + d;
      kval = to_f32(k[off]);
      vval = v[off];
    }
    const float bias = d < half ? rel_h[wy * half + d] : rel_w[wx * half + d - half];
    s_kt[d * nk + j] = from_f32<T>(kval + bias);
    s_v[j * hd + d] = vval;
  }
  __syncthreads();

  // ---- logits = q . k_eff * scale --------------------------------------
  const int ngroups = (nq + kRows - 1) / kRows;
  for (int item = tid; item < ngroups * nk; item += kThreads) {
    const int g = item / nk, j = item - (item / nk) * nk;
    const int i0 = g * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float kv = to_f32(s_kt[d * nk + j]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = min(i0 + r, nq - 1);  // clamped rows are discarded
        acc[r] = fmaf(to_f32(s_q[i * hd + d]), kv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (i0 + r < nq) s_p[(i0 + r) * nk + j] = acc[r] * scale;
  }
  __syncthreads();

  // ---- softmax per query row (one warp per row), probs rounded to T ----
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < nq; i += kThreads / 32) {
    float* row = s_p + (size_t)i * nk;
    float m = -INFINITY;
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < nk; j += 32) row[j] = to_f32(from_f32<T>(row[j] / s));
  }
  __syncthreads();

  // ---- out = p . v (+ residual) ----------------------------------------
  for (int item = tid; item < ngroups * hd; item += kThreads) {
    const int g = item / hd, d = item - (item / hd) * hd;
    const int i0 = g * kRows;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int j = 0; j < nk; ++j) {
      const float vv = to_f32(s_v[j * hd + d]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = min(i0 + r, nq - 1);
        acc[r] = fmaf(s_p[i * nk + j], vv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i >= nq) break;
      const int y = by * bs + i / bs, x = bx * bs + i % bs;
      const int64_t off = ((b * plane) + (int64_t)y * W + x) * C + c0 + d;
      T o = from_f32<T>(acc[r]);
      if (res != nullptr) o = from_f32<T>(to_f32(res[off]) + to_f32(o));
      out[off] = o;
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* rel_h,
           const float* rel_w, const void* res, void* out, int B, int H, int W,
           int C, int bs, int halo, int heads, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(bs, halo, C / heads, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * (H / bs) * (W / bs)), (unsigned)heads);
  attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      rel_h, rel_w, static_cast<const T*>(res), static_cast<T*>(out), H, W, C, bs,
      halo, heads, scale);
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

const char* pht_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
