// Fused Mamba2 layer interior, forward (kernel K7 of the PyTorch port).
//
// Replaces the TPU kernel `_fwd_kernel_infer` in
// pixel_heal_thyself_tpu/ops/ssd_mega.py:256 (body `_fwd_body` :210,
// launched by `_fwd` :424, `pallas_call` :463): everything of a Mamba2
// layer between in_proj and out_proj.
//
// What it computes, from zxbcdt [B, L, 2*di + 2*n + h] (bf16 or f32; z |
// xBC | dt, ngroups 1), with every intermediate in f32:
//   xBC  = silu(causal depthwise conv_k(xBC) + conv_b)   (zeros before t = 0)
//   x | B | C = xBC                     x [L, di] as h heads of p = di / h
//   dt   = softplus(dt + dt_bias)       [L, h]
//   cum  = in-chunk inclusive cumsum of dt * A   (chunks of q tokens)
//   per chunk and head, with the state st [n, p] carried from chunk to chunk:
//     y  = sum_{j <= t} (C_t . B_j) exp(cum_t - cum_j) dt_j x_j
//          + exp(cum_t) C_t . st + D * x_t
//     st = exp(cum_{q-1}) st + sum_j B_j^T (dt_j exp(cum_{q-1} - cum_j) x_j)
//   out  = round_T(g * rsqrt(mean(g^2) + 1e-5) * norm_w),  g = y * silu(z)
// One rounding, at the output, as the TPU kernel. Every product is a true
// f32 FMA (no TF32, no tensor cores).
//
// Design. The TPU kernel walks the chunks of one sequence in a sequential
// grid, holding all heads and an f32 state [n, di] (256 KB at prod) in
// VMEM. That is more than one Hopper CTA's 227 KB, and a (batch) grid
// would run 8 CTAs on 132 SMs. The SSD is independent per head (B and C
// are shared, ngroups 1), so this kernel takes mamba_ssm's chunked design
// instead of a per-(batch, head) walker: the walker has 128 work items at
// prod, one CTA per SM with nothing to hide its latency, while the chunked
// design has B * nc * h = 16,384 independent (batch, chunk, head) items
// and leaves only a short elementwise pass sequential. The gated RMSNorm
// reduces over all di channels of a token, across heads, so it is a launch
// of its own. Five launches:
//   1. prologue  (chunk, batch, channel slab): conv + SiLU of xBC -> f32
//      xbc [B, L, di + 2n]; one extra slab per chunk computes dt and cum
//      [B, L, h]. A chunk reads its k - 1 previous raw rows straight from
//      device memory, so no conv tail is carried.
//   2. chunk state (head, chunk, batch): S = B^T (dt decay x) [n, p] from a
//      zero state -> f32 states [B, nc, h, n, p].
//   3. state pass (element, head, batch): walks the chunks in order and
//      overwrites each S with the state entering its chunk.
//   4. chunk output (head, chunk, batch): the intra-chunk product, the
//      readout of the entering state and the D skip -> f32 y [B, L, di].
//   5. gated RMSNorm (token): gate, mean square, norm weight, rounding.
//
// What bounds it on the H100. The function itself reads zxbcdt once and
// writes the output once (843 MB at the prod serving shape B 8, L 16,384,
// di 1024, n 64, h 16, bf16: 0.252 ms at 3.35 TB/s), against ~71 GFLOP
// (0.072 ms at the bf16 tensor-core peak): memory. This plan moves its f32
// intermediates through device memory (xbc, states twice, y: ~4.8 GB at
// prod, >= 1.4 ms) and runs ~37 GFMA on scalar f32 FMAs (>= 1.1 ms at the
// 67 TFLOP/s f32 peak). Launches 2 and 4 stage their chunk in shared memory
// (4 at prod: 163 KB, one CTA per SM) and register-block 4 x 4 outputs per
// thread so that two 16-byte shared loads feed 16 FMAs. Fusing the norm
// (clusters with DSMEM) and tensor-core products are later work.

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

// ---- 1. prologue ------------------------------------------------------------
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

// ---- 2. chunk state ----------------------------------------------------------
__host__ __device__ inline size_t state_smem_floats(int q, int n, int p) {
  return (size_t)q * n + (size_t)q * p + q;
}

__global__ void __launch_bounds__(kThreads) ssd_chunk_state_kernel(
    const float* __restrict__ xbc, const float* __restrict__ dt,
    const float* __restrict__ cum, float* __restrict__ states, Dims d) {
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int q = d.q, n = d.n, p = d.p;
  const long row0 = (long)b * d.L + (long)c * q;
  extern __shared__ __align__(16) float smem[];
  float* s_b = smem;               // [q][n]  B_j * dt_j * exp(cum_last - cum_j)
  float* s_x = s_b + q * n;        // [q][p]  x_j of this head
  float* s_scale = s_x + q * p;    // [q]
  const float last = cum[(row0 + q - 1) * d.h + hh];
  for (int j = tid; j < q; j += kThreads)
    s_scale[j] = dt[(row0 + j) * d.h + hh] * expf(last - cum[(row0 + j) * d.h + hh]);
  for (int idx = tid; idx < q * p; idx += kThreads) {
    const int j = idx / p, e = idx - j * p;
    s_x[idx] = xbc[(row0 + j) * d.dc + hh * p + e];
  }
  __syncthreads();
  for (int idx = tid; idx < q * n; idx += kThreads) {
    const int j = idx / n, i = idx - j * n;
    s_b[idx] = xbc[(row0 + j) * d.dc + d.di + i] * s_scale[j];
  }
  __syncthreads();
  float* out = states + (((long)b * d.nc + c) * d.h + hh) * n * p;
  const int pc = p / 4;
  for (int tile = tid; tile < (n / 4) * pc; tile += kThreads) {
    const int i0 = (tile / pc) * 4, e0 = (tile % pc) * 4;
    float acc[4][4] = {};
    for (int j = 0; j < q; ++j) fma4x4(acc, ld4(s_b + j * n + i0), ld4(s_x + j * p + e0));
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st4(out + (i0 + r) * p + e0, acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// ---- 3. state pass -----------------------------------------------------------
__global__ void __launch_bounds__(kThreads) ssd_state_pass_kernel(
    float* __restrict__ states, const float* __restrict__ cum, Dims d) {
  const int np = d.n * d.p;
  const int e = blockIdx.x * kThreads + threadIdx.x, hh = blockIdx.y, b = blockIdx.z;
  if (e >= np) return;
  float st = 0.f;
  float* s = states + ((long)b * d.nc * d.h + hh) * np + e;
  const float* last = cum + ((long)b * d.L + d.q - 1) * d.h + hh;
  const long cs = (long)d.h * np, cl = (long)d.q * d.h;
  // loads of kBatch chunks first, then their stores: the chain's only
  // dependency is st, so a batch's loads are in flight together
  constexpr int kBatch = 8;
  for (int c0 = 0; c0 < d.nc; c0 += kBatch) {
    float inc[kBatch], a[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool in = c0 + i < d.nc;
      inc[i] = in ? s[(c0 + i) * cs] : 0.f;
      a[i] = in ? expf(last[(c0 + i) * cl]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < d.nc) s[(c0 + i) * cs] = st;  // the state entering chunk c0 + i
      st = fmaf(a[i], st, inc[i]);
    }
  }
}

// ---- 4. chunk output ----------------------------------------------------------
__host__ __device__ inline size_t output_smem_floats(int q, int n, int p) {
  const size_t ct = (size_t)n * (q + 4);
  return ct + (ct > (size_t)n * p ? ct : (size_t)n * p) + (size_t)q * q + (size_t)q * p + 2 * q;
}

__global__ void __launch_bounds__(kThreads) ssd_chunk_output_kernel(
    const float* __restrict__ xbc, const float* __restrict__ dt,
    const float* __restrict__ cum, const float* __restrict__ states,
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
  const float4* st_src = reinterpret_cast<const float4*>(
      states + (((long)b * d.nc + c) * d.h + hh) * n * p);
  for (int idx = tid; idx < n * p / 4; idx += kThreads)
    reinterpret_cast<float4*>(s_bt)[idx] = st_src[idx];
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

// ---- 5. gated RMSNorm ---------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) gated_rmsnorm_kernel(
    const float* __restrict__ y, const T* __restrict__ zx, const float* __restrict__ norm_w,
    T* __restrict__ out, Dims d) {
  const long row = blockIdx.x;
  const float* yr = y + row * d.di;
  const T* zr = zx + row * d.W;
  __shared__ float s_part[kThreads / 32];
  float ss = 0.f;
  for (int e = threadIdx.x; e < d.di; e += kThreads) {
    const float g = yr[e] * silu(to_f32(zr[e]));
    ss = fmaf(g, g, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += s_part[w];
  const float rstd = rsqrtf(total / d.di + kEps);
  for (int e = threadIdx.x; e < d.di; e += kThreads) {
    const float g = yr[e] * silu(to_f32(zr[e]));
    out[row * d.di + e] = from_f32<T>(g * rstd * norm_w[e]);
  }
}

template <typename T>
int launch(const void* zx, const float* conv_w, const float* conv_b, const float* dt_bias,
           const float* A, const float* D, const float* norm_w, float* xbc, float* dt,
           float* cum, float* states, float* y, void* out, Dims d, cudaStream_t s) {
  const size_t state_smem = state_smem_floats(d.q, d.n, d.p) * sizeof(float);
  const size_t out_smem = output_smem_floats(d.q, d.n, d.p) * sizeof(float);
  if (state_smem > kMaxSmem || out_smem > kMaxSmem || d.k > kMaxConv || d.k < 1 ||
      d.q % 8 || d.n % 4 || d.p % 4)
    return (int)cudaErrorInvalidValue;
  const T* zt = static_cast<const T*>(zx);
  cudaError_t err;

  const int slabs = (d.dc + kThreads - 1) / kThreads;
  ssd_prologue_kernel<T><<<dim3(d.nc, d.B, slabs + 1), kThreads, 0, s>>>(
      zt, conv_w, conv_b, dt_bias, A, xbc, dt, cum, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(ssd_chunk_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)state_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_state_kernel<<<dim3(d.h, d.nc, d.B), kThreads, state_smem, s>>>(
      xbc, dt, cum, states, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ssd_state_pass_kernel<<<dim3((d.n * d.p + kThreads - 1) / kThreads, d.h, d.B), kThreads, 0,
                          s>>>(states, cum, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(ssd_chunk_output_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)out_smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_output_kernel<<<dim3(d.h, d.nc, d.B), kThreads, out_smem, s>>>(
      xbc, dt, cum, states, D, y, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  gated_rmsnorm_kernel<T><<<(unsigned)((long)d.B * d.L), kThreads, 0, s>>>(
      y, zt, norm_w, static_cast<T*>(out), d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// zxbcdt [B, L, 2 di + 2 n + h] (bf16 or f32); f32 conv_w [k, di + 2n],
// conv_b [di + 2n], dt_bias, A, D [h], norm_w [di]; f32 scratch xbc
// [B, L, di + 2n], dt and cum [B, L, h], states [B, L/q, h, n, di/h],
// y [B, L, di]; out [B, L, di] in zxbcdt's dtype.
int pht_ssd_chain_fwd(const void* zx, const void* conv_w, const void* conv_b,
                      const void* dt_bias, const void* A, const void* D, const void* norm_w,
                      void* xbc, void* dt, void* cum, void* states, void* y, void* out, int B,
                      int L, int di, int n, int h, int k, int q, int is_bf16, void* stream) {
  Dims d;
  d.B = B; d.L = L; d.di = di; d.n = n; d.h = h; d.p = di / h; d.k = k; d.q = q;
  d.nc = L / q; d.dc = di + 2 * n; d.W = 2 * di + 2 * n + h;
  const float* f[7] = {static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
                       static_cast<const float*>(dt_bias), static_cast<const float*>(A),
                       static_cast<const float*>(D), static_cast<const float*>(norm_w), nullptr};
  float* xb = static_cast<float*>(xbc);
  float* dtp = static_cast<float*>(dt);
  float* cp = static_cast<float*>(cum);
  float* sp = static_cast<float*>(states);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(zx, f[0], f[1], f[2], f[3], f[4], f[5], xb, dtp, cp, sp, yp, out, d, s);
  return launch<float>(zx, f[0], f[1], f[2], f[3], f[4], f[5], xb, dtp, cp, sp, yp, out, d, s);
}

}  // extern "C"
