// Device code shared by the fused Mamba2-chain forward K7 (ssd_fwd.cu) and
// backward K8 (ssd_bwd.cu): K7's prologue (launch 1) and chunk output
// (launch 4), which K8 runs again to recompute the forward. Their design is
// in ssd_fwd.cu's header.
#pragma once

#include <type_traits>

#include "common.cuh"

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

// ---- 4. chunk output (K7 launch 4) ------------------------------------------
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

}  // namespace
