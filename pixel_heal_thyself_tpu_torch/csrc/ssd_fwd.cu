// Fused Mamba2 layer interior, forward (kernel K7 of the PyTorch port).
//
// Replaces the TPU kernel `_fwd_kernel_infer` in
// pixel_heal_thyself_tpu/ops/ssd_mega.py:256 (body `_fwd_body` :210,
// launched by `_fwd` :424, `pallas_call` :463): everything of a Mamba2
// layer between in_proj and out_proj; and, given a `states_emit` buffer,
// its training variant `_fwd_kernel_train` (:252, `pallas_call` :475),
// which also stores the state entering each chunk rounded to the input
// dtype (the residual of the backward K8, ssd_bwd.cu). The TPU variant's
// conv tails need no counterpart: K8 reads the raw rows from zxbcdt.
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
// One rounding, at the output, as the TPU kernel. Every product is f32-
// accurate: scalar f32 FMAs in the general body, tensor-core 3xTF32 in the
// tensor-core body (tf32x3.cuh).
//
// Design. The TPU kernel walks the chunks of one sequence in a sequential
// grid, holding all heads and an f32 state [n, di] (256 KB at prod) in
// VMEM. That is more than one Hopper CTA's 227 KB, and a (batch) grid
// would run 8 CTAs on 132 SMs. The SSD is independent per head (B and C
// are shared, ngroups 1), so this kernel takes mamba_ssm's chunked design:
// B * nc independent chunks (1,024 at prod) and only a short elementwise
// pass sequential. The gated RMSNorm reduces over all di channels of a
// token, across heads, so it is a launch of its own. Five launches:
//   1. prologue  (chunk, batch, channel slab): conv + SiLU of xBC -> f32
//      xbc [B, L, di + 2n]; one extra CTA per chunk computes dt and cum
//      [B, L, h]. A chunk reads its k - 1 previous raw rows straight from
//      device memory, so no conv tail is carried. Two bodies, named by the
//      wrappers (`pht_ssd_prologue_body`): the vec body for 16-byte aligned
//      windows (the prod shape: 4 channels a thread, a cp.async ring of
//      rows, k a template argument; ssd_chain.cuh) and the general one.
//   2. chunk state: S = B^T (dt decay x) [n, p] per head from a zero state
//      -> f32 states [B, nc, h, n, p].
//   3. state pass (element, head, batch): walks the chunks in order and
//      overwrites each S with the state entering its chunk (and, emitting,
//      writes that state rounded to the input dtype beside it).
//   4. chunk output: the intra-chunk product, the readout of the entering
//      state and the D skip -> f32 y [B, L, di].
//   5. gated RMSNorm (token): gate, mean square, norm weight, rounding.
// Launches 2 and 4 have two bodies, chosen here by tc_body (ssd_chain.cuh;
// `pht_ssd_chain_body` tells the wrappers):
//   - the tensor-core body (chunk 32..128 by 32, headdim 16/32/64, d_state
//     16..64 by 16; the prod shape): one CTA per (chunk, batch) walks the
//     heads. The chunk output computes the scores C.B^T once for all 16
//     heads, forms W = scores decay dt per head in shared memory, and runs
//     C.st and W.x (its causal half only) on mma.sync at 3xTF32, 16 warps,
//     221,184 bytes of shared memory; the chunk state runs B^T.(v x) the
//     same way, 8 warps, 111,616 bytes. Each head's operands are copied by
//     cp.async while the previous head computes. ssd_chain.cuh has both.
//   - the general body (other shapes): one CTA per (head, chunk, batch),
//     4 x 4 register tiles of scalar f32 FMAs (163 KB at prod).
//
// What bounds it on the H100. The function itself reads zxbcdt once and
// writes the output once (843 MB at the prod serving shape B 8, L 16,384,
// di 1024, n 64, h 16, bf16: 0.252 ms at 3.35 TB/s), against ~71 GFLOP
// (0.072 ms at the bf16 tensor-core peak): memory. This plan moves its f32
// intermediates through device memory (xbc, states twice, y: ~4.8 GB at
// prod, >= 1.4 ms). On the tensor-core body the chunk output and chunk
// state are held back by their fragment work (shared-memory loads, the
// 3xTF32 splits, W's exps), not by the tensor cores or by bytes
// (bench_ssd_tc.py; PERF.md, PR 8). ptxas (sm_90a): the chunk output 110
// registers, the chunk state 75, no spills.
// Launches 1 and 4 live in ssd_chain.cuh, shared with K8.

#include "ssd_chain.cuh"

namespace {

// ---- 2. chunk state, general body ----------------------------------------------
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
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_state_pass_kernel(
    float* __restrict__ states, T* __restrict__ emit, const float* __restrict__ cum, Dims d) {
  const int np = d.n * d.p;
  const int e = blockIdx.x * kThreads + threadIdx.x, hh = blockIdx.y, b = blockIdx.z;
  if (e >= np) return;
  float st = 0.f;
  const long off = ((long)b * d.nc * d.h + hh) * np + e;
  float* s = states + off;
  T* em = emit == nullptr ? nullptr : emit + off;
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
      if (c0 + i < d.nc) {
        s[(c0 + i) * cs] = st;  // the state entering chunk c0 + i
        if (em != nullptr) em[(c0 + i) * cs] = from_f32<T>(st);
      }
      st = fmaf(a[i], st, inc[i]);
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
           float* cum, float* states, float* y, void* out, void* emit, Dims d, int pro_vec,
           cudaStream_t s) {
  const bool tc = tc_body(d.q, d.n, d.p);
  const size_t state_smem =
      (tc ? head_state_tc_floats(d.q, d.n, d.p) : state_smem_floats(d.q, d.n, d.p)) * sizeof(float);
  const size_t out_smem =
      (tc ? output_tc_floats(d.q, d.n, d.p) : output_smem_floats(d.q, d.n, d.p)) * sizeof(float);
  if (state_smem > kMaxSmem || out_smem > kMaxSmem || d.k > kMaxConv || d.k < 1 ||
      d.q % 8 || d.n % 4 || d.p % 4 ||
      (pro_vec && prologue_vec_refused(zx, conv_w, conv_b, xbc, d, sizeof(T))))
    return (int)cudaErrorInvalidValue;
  const T* zt = static_cast<const T*>(zx);
  const dim3 chunks(d.nc, d.B), heads(d.h, d.nc, d.B);
  cudaError_t err;

  const int pro = launch_prologue<T>(zt, conv_w, conv_b, dt_bias, A, xbc, dt, cum, d, pro_vec, s);
  if (pro != 0) return pro;

  if (tc) {
    err = cudaFuncSetAttribute(ssd_chunk_state_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)state_smem);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_state_tc_kernel<<<chunks, kThreads, state_smem, s>>>(xbc, dt, cum, states, d);
  } else {
    err = cudaFuncSetAttribute(ssd_chunk_state_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)state_smem);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_state_kernel<<<heads, kThreads, state_smem, s>>>(xbc, dt, cum, states, d);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ssd_state_pass_kernel<T><<<dim3((d.n * d.p + kThreads - 1) / kThreads, d.h, d.B), kThreads,
                             0, s>>>(states, static_cast<T*>(emit), cum, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  OutputKernel<float> out_kern =
      tc ? ssd_chunk_output_tc_kernel<float> : ssd_chunk_output_kernel<float>;
  err = cudaFuncSetAttribute(out_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)out_smem);
  if (err != cudaSuccess) return (int)err;
  out_kern<<<tc ? chunks : heads, tc ? kTcThreads : kThreads, out_smem, s>>>(xbc, dt, cum, states, D, y, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  gated_rmsnorm_kernel<T><<<(unsigned)((long)d.B * d.L), kThreads, 0, s>>>(
      y, zt, norm_w, static_cast<T*>(out), d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The body that K7 and K8 take for chunk q, d_state n and headdim p: 1 the
// tensor-core body, 0 the general one (ssd_chain.cuh's tc_body). The C
// entries choose by it; the wrappers ask it to count launches by body and
// to size K8's scratch.
int pht_ssd_chain_body(int q, int n, int p) { return tc_body(q, n, p) ? 1 : 0; }

// 1: the prologue's vec body takes the xBC window of zxbcdt [B, L, 2 di +
// 2 n + h] (offset di, width di + 2n, row stride W) in this dtype; 0: its
// general body (ssd_chain.cuh's prologue_vec_body; the C entries also
// refuse tensors that are not 16-byte aligned)
int pht_ssd_prologue_body(int W, int di, int dc, int is_bf16) {
  return prologue_vec_body(W, di, dc, is_bf16 ? 2 : 4) ? 1 : 0;
}

// K7's prologue alone on the named body (vec 1, general 0): from zxbcdt
// and f32 conv_w [k, di + 2n], conv_b [di + 2n], dt_bias, A [h], the f32
// xbc [B, L, di + 2n], dt and cum [B, L, h]. For comparisons of the bodies;
// K7 and K8 launch it themselves.
int pht_ssd_prologue(const void* zx, const void* conv_w, const void* conv_b,
                     const void* dt_bias, const void* A, void* xbc, void* dt, void* cum, int B,
                     int L, int di, int n, int h, int k, int q, int is_bf16, int vec,
                     void* stream) {
  if (q <= 0 || h <= 0 || L % q || k > kMaxConv || k < 1) return (int)cudaErrorInvalidValue;
  const Dims d = chain_dims(B, L, di, n, h, k, q);
  if (vec && prologue_vec_refused(zx, conv_w, conv_b, xbc, d, is_bf16 ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  const float* f[4] = {static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
                       static_cast<const float*>(dt_bias), static_cast<const float*>(A)};
  float* o[3] = {static_cast<float*>(xbc), static_cast<float*>(dt), static_cast<float*>(cum)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_prologue<bf16>(static_cast<const bf16*>(zx), f[0], f[1], f[2], f[3], o[0],
                                 o[1], o[2], d, vec, s);
  return launch_prologue<float>(static_cast<const float*>(zx), f[0], f[1], f[2], f[3], o[0],
                                o[1], o[2], d, vec, s);
}

// zxbcdt [B, L, 2 di + 2 n + h] (bf16 or f32); f32 conv_w [k, di + 2n],
// conv_b [di + 2n], dt_bias, A, D [h], norm_w [di]; f32 scratch xbc
// [B, L, di + 2n], dt and cum [B, L, h], states [B, L/q, h, n, di/h],
// y [B, L, di]; out [B, L, di] in zxbcdt's dtype; states_emit (nullable)
// [B, L/q, h, n, di/h] in zxbcdt's dtype. pro_vec: the prologue's body
// (pht_ssd_prologue_body); a window or tensor its vec body does not take
// is refused before anything launches.
int pht_ssd_chain_fwd(const void* zx, const void* conv_w, const void* conv_b,
                      const void* dt_bias, const void* A, const void* D, const void* norm_w,
                      void* xbc, void* dt, void* cum, void* states, void* y, void* out,
                      void* states_emit, int B, int L, int di, int n, int h, int k, int q,
                      int is_bf16, int pro_vec, void* stream) {
  const Dims d = chain_dims(B, L, di, n, h, k, q);
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
    return launch<bf16>(zx, f[0], f[1], f[2], f[3], f[4], f[5], xb, dtp, cp, sp, yp, out,
                        states_emit, d, pro_vec, s);
  return launch<float>(zx, f[0], f[1], f[2], f[3], f[4], f[5], xb, dtp, cp, sp, yp, out,
                       states_emit, d, pro_vec, s);
}

}  // extern "C"
