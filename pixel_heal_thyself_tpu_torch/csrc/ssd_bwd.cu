// Fused Mamba2 layer interior, backward (kernel K8 of the PyTorch port).
//
// Replaces the TPU kernel `_bwd_kernel` in
// pixel_heal_thyself_tpu/ops/ssd_mega.py:260 (launched by `_bwd` :503,
// `pallas_call` :523): the VJP of K7's function (ssd_fwd.cu) at the state
// entering each chunk that K7's emit variant saved, rounded to the input
// dtype. From zxbcdt, the parameters, those states and the output gradient
// dy [B, L, di] it computes
//   dzx [B, L, W] = [dz | dxBC_raw | ddt_raw] in zxbcdt's dtype, and the f32
//   parameter gradients dwb [k + 1, dc] (conv taps, bias), dpv [3, h]
//   (dt_bias, A, D) and dnw [di] (norm weight),
// with every intermediate in f32 and one rounding at dzx, as the TPU kernel.
// The plain version is `ops/ssd_mega.fused_mamba_chain_bwd_torch`, whose
// stages the launches below follow.
//
// Design. The TPU kernel walks the chunks of a sequence in reverse in a
// sequential (batch, chunk) grid, holding all heads and an f32 dstate
// [n, di] (256 KB at prod) in VMEM: more than one CTA's 227 KB, and only 8
// programs on 132 SMs. K8 takes K7's chunked design in reverse: chunk work
// items, a short elementwise pass that carries dstate from the last chunk
// back, and launches of their own for what reduces across heads (the norm,
// dB and dC, which all 16 heads share). Two bodies, chosen by tc_body
// (ssd_chain.cuh), as K7's. The tensor-core body, ten launches:
//   1. prologue and 2. chunk output: K7's own (ssd_chain.cuh), recomputing
//      xbc, dt, cum and y_ssd, the chunk output (tensor-core body, states
//      in the input dtype) reading the saved states.
//   3. norm backward (chunk, batch): per token, the gated RMSNorm's VJP ->
//      dy_ssd (f32, over y_ssd in place) and dz; per-chunk dnw partials.
//   4. dstate local (chunk, batch; ssd_chain.cuh's per-head [n, p] product):
//      C^T (dy_ssd exp(cum)), the chunk's own term of the gradient of the
//      state entering it.
//   5. reverse state pass (element, head, batch): walks the chunks from the
//      last back and leaves in each the gradient of the state leaving it.
//   6'. intra and head rest (chunk, batch): the scores C.B^T once, then per
//      head dW = dy_ssd . xdt^T, W (in shared memory only), the dcum row and
//      column sums of dW * W, the readout C.st, dxdt = W^T dy_ssd + (B.dst)
//      decay, the reverse in-chunk cumsum to ddA, the D skip, softplus ->
//      dx (post-SiLU), ddt_raw, per-chunk dt_bias/A/D partials; and the sum
//      over heads of dS = dW * decay, in head order, to device memory.
//   8'. dB, dC (chunk, batch): dC = (sum dS) B + sum_h dr_h st_h^T, dB =
//      (sum dS)^T C + sum_h xdt_s,h dst_h^T.
//   9. conv backward (chunk, batch, channel slab): recomputes the conv's
//      pre-activation, dpre = dxBC * silu'(pre) (f32, in place), per-chunk
//      tap and bias partials.
//  10. conv transpose (chunk, batch, channel slab): dxBC_raw[t] = sum_j
//      w[j] dpre[t + k - 1 - j], reading the next chunk's first rows.
//  11. three fixed-order sums of the per-chunk partials.
// Every chunk product of 2, 4, 6' and 8' runs on mma.sync at 3xTF32
// (tf32x3.cuh); 6' and 8' run 8 warps in 225,856 and 217,088 bytes of
// shared memory at prod. The general body (other shapes) runs 4 and 6-8 per
// (head, chunk, batch) on scalar f32 FMAs: 6 writes W and dS per head to
// device memory, 7 (head rest) reads W back, 8 sums dS over heads.
// No float atomics anywhere: every cross-CTA sum goes through per-chunk
// partials and a fixed-order pass, and 6' sums dS over heads in order, so
// K8 is deterministic.
//
// What bounds it on the H100. The function reads zxbcdt, the states and dy
// once and writes dzx once (1.55 GB at the prod training shape B 8,
// L 16,384, di 1024, n 64, h 16, bf16: 0.46 ms at 3.35 TB/s) against
// ~210 GFLOP (0.21 ms at the bf16 tensor-core peak): memory. This plan moves
// ~7 GB of f32 intermediates through device memory (2.1 GB of scratch at
// prod; the general body's per-head W and dS, 1.07 GB each, stay on chip
// in 6'), so it is far from that bound; the tensor-core launches are held
// back by their fragment work, as K7's (PERF.md, PR 8). ptxas (sm_90a): 6'
// 186 registers (bf16: 187), 8' 142 (147), no spills.

#include "ssd_chain.cuh"

namespace {

constexpr int kMaxBcTiles = 4;  // launch 8: 4 x 4 output tiles per thread

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float dsilu(float x) {
  const float s = sigmoid(x);
  return s * (1.f + x * (1.f - s));
}

// acc[r][s] += sum_{k0 <= kk < k1} A(r0 + r, kk) * M(kk, s0 + s), with A at
// a[row * ars + kk * aks] (any strides: the threads of a warp share r0 or
// two of them, so its loads are broadcasts) and M at m[kk * ldm + col]
// (16-byte rows, read as float4).
__device__ __forceinline__ void mm4x4(float (&acc)[4][4], const float* __restrict__ a, int ars,
                                      int aks, const float* __restrict__ m, int ldm, int r0,
                                      int s0, int k0, int k1) {
  for (int kk = k0; kk < k1; ++kk) {
    const float* ap = a + (long)r0 * ars + (long)kk * aks;
    const float av[4] = {ap[0], ap[ars], ap[2 * ars], ap[3 * ars]};
    const float4 mv = ld4(m + (long)kk * ldm + s0);
    const float bv[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
  }
}

// The sums of a and b over the CTA, to every thread, in a fixed order.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* s_red) {
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // s_red may still be read from a previous call
  if ((threadIdx.x & 31) == 0) {
    s_red[threadIdx.x >> 5] = a;
    s_red[kThreads / 32 + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    t.x += s_red[w];
    t.y += s_red[kThreads / 32 + w];
  }
  return t;
}

// B^T and C^T of chunk row0 as [n][q + 4] (a thread reads 4 tokens of one
// channel and stores 16 bytes), as K7's chunk output stages them.
__device__ __forceinline__ void stage_bc_t(const float* __restrict__ xbc, long row0, float* s_bt,
                                           float* s_ct, const Dims& d) {
  const int q = d.q, n = d.n, ldq = q + 4;
  for (int idx = threadIdx.x; idx < 2 * n * (q / 4); idx += kThreads) {
    const int which = idx / (n * (q / 4)), rest = idx - which * n * (q / 4);
    const int i = rest % n, t0 = (rest / n) * 4;
    const float* src = xbc + (row0 + t0) * d.dc + d.di + which * n + i;
    st4((which ? s_ct : s_bt) + i * ldq + t0, src[0], src[d.dc], src[2 * d.dc], src[3 * d.dc]);
  }
}

// ---- 3. norm backward ---------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_norm_bwd_kernel(
    float* __restrict__ y, const T* __restrict__ zx, const T* __restrict__ dy,
    const float* __restrict__ norm_w, T* __restrict__ dzx, float* __restrict__ nw_part, Dims d) {
  const int c = blockIdx.x, b = blockIdx.y;
  const long row0 = (long)b * d.L + (long)c * d.q;
  extern __shared__ __align__(16) float smem[];
  float* s_dnw = smem;  // [di], each channel owned by one thread
  __shared__ float s_red[2 * kThreads / 32];
  for (int e = threadIdx.x; e < d.di; e += kThreads) s_dnw[e] = 0.f;
  for (int t = 0; t < d.q; ++t) {
    const long row = row0 + t;
    float* yr = y + row * d.di;
    const T* zr = zx + row * d.W;
    const T* dr = dy + row * d.di;
    float ss = 0.f, sd = 0.f;
    for (int e = threadIdx.x; e < d.di; e += kThreads) {
      const float g = yr[e] * silu(to_f32(zr[e]));
      ss = fmaf(g, g, ss);
      sd = fmaf(to_f32(dr[e]) * norm_w[e], g, sd);
    }
    const float2 tot = block_sum2(ss, sd, s_red);
    const float rstd = rsqrtf(tot.x / d.di + kEps);
    const float coef = rstd * rstd * rstd / d.di * tot.y;
    for (int e = threadIdx.x; e < d.di; e += kThreads) {
      const float z = to_f32(zr[e]), sz = silu(z), yv = yr[e], g = yv * sz;
      const float dyv = to_f32(dr[e]);
      const float du = rstd * (dyv * norm_w[e]) - g * coef;
      s_dnw[e] = fmaf(dyv * g, rstd, s_dnw[e]);
      yr[e] = du * sz;
      dzx[row * d.W + e] = from_f32<T>(du * yv * dsilu(z));
    }
  }
  float* part = nw_part + ((long)b * d.nc + c) * d.di;
  for (int e = threadIdx.x; e < d.di; e += kThreads) part[e] = s_dnw[e];
}

// ---- 4. dstate local, general body ---------------------------------------------
__host__ __device__ inline size_t dlocal_smem_floats(int q, int n, int p) {
  return (size_t)q * n + (size_t)q * p;
}

__global__ void __launch_bounds__(kThreads) ssd_dstate_local_kernel(
    const float* __restrict__ xbc, const float* __restrict__ cum,
    const float* __restrict__ dys, float* __restrict__ dstate, Dims d) {
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int q = d.q, n = d.n, p = d.p;
  const long row0 = (long)b * d.L + (long)c * q;
  extern __shared__ __align__(16) float smem[];
  float* s_c = smem;         // [q][n]  C_t exp(cum_t)
  float* s_dy = s_c + q * n; // [q][p]  dy_ssd of this head
  for (int idx = tid; idx < q * n; idx += kThreads) {
    const int t = idx / n, i = idx - t * n;
    s_c[idx] = xbc[(row0 + t) * d.dc + d.di + n + i] * expf(cum[(row0 + t) * d.h + hh]);
  }
  for (int idx = tid; idx < q * p; idx += kThreads) {
    const int t = idx / p, e = idx - t * p;
    s_dy[idx] = dys[(row0 + t) * d.di + hh * p + e];
  }
  __syncthreads();
  float* out = dstate + (((long)b * d.nc + c) * d.h + hh) * n * p;
  const int pc = p / 4;
  for (int tile = tid; tile < (n / 4) * pc; tile += kThreads) {
    const int i0 = (tile / pc) * 4, e0 = (tile % pc) * 4;
    float acc[4][4] = {};
    mm4x4(acc, s_c, 1, n, s_dy, p, i0, e0, 0, q);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st4(out + (i0 + r) * p + e0, acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// ---- 5. reverse state pass --------------------------------------------------------
__global__ void __launch_bounds__(kThreads) ssd_dstate_reverse_kernel(
    float* __restrict__ dstate, const float* __restrict__ cum, Dims d) {
  const int np = d.n * d.p;
  const int e = blockIdx.x * kThreads + threadIdx.x, hh = blockIdx.y, b = blockIdx.z;
  if (e >= np) return;
  float st = 0.f;
  float* s = dstate + ((long)b * d.nc * d.h + hh) * np + e;
  const float* last = cum + ((long)b * d.L + d.q - 1) * d.h + hh;
  const long cs = (long)d.h * np, cl = (long)d.q * d.h;
  // K7's state pass mirrored: a batch of chunks' loads, then their stores
  constexpr int kBatch = 8;
  for (int c0 = d.nc - 1; c0 >= 0; c0 -= kBatch) {
    float inc[kBatch], a[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool in = c0 - i >= 0;
      inc[i] = in ? s[(c0 - i) * cs] : 0.f;
      a[i] = in ? expf(last[(c0 - i) * cl]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 - i >= 0) s[(c0 - i) * cs] = st;  // the gradient of the state leaving c0 - i
      st = fmaf(a[i], st, inc[i]);
    }
  }
}

// ---- 6. intra, general body --------------------------------------------------------
__host__ __device__ inline size_t intra_smem_floats(int q, int n, int p) {
  return 2 * (size_t)n * (q + 4) + (size_t)q * p + (size_t)p * (q + 4) + q +
         2 * (size_t)q * (q / 4);
}

__global__ void __launch_bounds__(kThreads) ssd_intra_bwd_kernel(
    const float* __restrict__ xbc, const float* __restrict__ dt, const float* __restrict__ cum,
    const float* __restrict__ dys, float* __restrict__ gW, float* __restrict__ gdS,
    float* __restrict__ gdcum, Dims d) {
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int q = d.q, n = d.n, p = d.p, ldq = q + 4, tq = q / 4;
  const long row0 = (long)b * d.L + (long)c * q;
  extern __shared__ __align__(16) float smem[];
  float* s_bt = smem;                      // [n][q+4]  B^T
  float* s_ct = s_bt + n * ldq;            // [n][q+4]  C^T
  float* s_dy = s_ct + n * ldq;            // [q][p]    dy_ssd of this head
  float* s_xt = s_dy + q * p;              // [p][q+4]  (x dt)^T of this head
  float* s_cum = s_xt + p * ldq;           // [q]
  float* s_rp = s_cum + q;                 // [q][q/4]  row sums of dW*W per column tile
  float* s_cp = s_rp + q * tq;             // [q][q/4]  column sums per row tile

  for (int j = tid; j < q; j += kThreads) s_cum[j] = cum[(row0 + j) * d.h + hh];
  for (int idx = tid; idx < q * p; idx += kThreads) {
    const int t = idx / p, e = idx - t * p;
    s_dy[idx] = dys[(row0 + t) * d.di + hh * p + e];
  }
  stage_bc_t(xbc, row0, s_bt, s_ct, d);
  for (int idx = tid; idx < p * tq; idx += kThreads) {
    const int e = idx % p, t0 = (idx / p) * 4;
    const float* src = xbc + (row0 + t0) * d.dc + hh * p + e;
    const float* dtp = dt + (row0 + t0) * d.h + hh;
    st4(s_xt + e * ldq + t0, src[0] * dtp[0], src[d.dc] * dtp[d.h],
        src[2 * d.dc] * dtp[2 * d.h], src[3 * d.dc] * dtp[3 * d.h]);
  }
  __syncthreads();

  const long base = (((long)b * d.nc + c) * d.h + hh) * q * q;
  for (int tile = tid; tile < tq * tq; tile += kThreads) {
    const int t0 = (tile / tq) * 4, j0 = (tile % tq) * 4;
    float S[4][4] = {}, dW[4][4] = {};
    if (j0 <= t0 + 3) {
      mm4x4(S, s_ct, 1, ldq, s_bt, ldq, t0, j0, 0, n);  // C_t . B_j
      mm4x4(dW, s_dy, p, 1, s_xt, ldq, t0, j0, 0, p);   // dy_t . xdt_j
    }
    float rs[4] = {}, cs[4] = {};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t0 + r;
      float w[4], ds[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int j = j0 + s;
        w[s] = ds[s] = 0.f;
        if (j <= t) {
          const float lm = expf(s_cum[t] - s_cum[j]);
          w[s] = S[r][s] * lm;
          ds[s] = dW[r][s] * lm;
          const float dd = dW[r][s] * w[s];
          rs[r] += dd;
          cs[s] += dd;
        }
      }
      st4(gW + base + (long)t * q + j0, w[0], w[1], w[2], w[3]);
      st4(gdS + base + (long)t * q + j0, ds[0], ds[1], ds[2], ds[3]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) s_rp[(t0 + r) * tq + j0 / 4] = rs[r];
#pragma unroll
    for (int s = 0; s < 4; ++s) s_cp[(j0 + s) * tq + t0 / 4] = cs[s];
  }
  __syncthreads();
  // dcum[i] = sum_j dW*W[i, j] - sum_t dW*W[t, i]
  for (int i = tid; i < q; i += kThreads) {
    float rsum = 0.f, csum = 0.f;
    for (int m = 0; m < tq; ++m) {
      rsum += s_rp[i * tq + m];
      csum += s_cp[i * tq + m];
    }
    gdcum[(row0 + i) * d.h + hh] = rsum - csum;
  }
}

// ---- 7. head rest, general body ----------------------------------------------------
__host__ __device__ inline size_t rest_smem_floats(int q, int n, int p) {
  return (size_t)q * q + (size_t)q * p + 2 * (size_t)n * (q + 4) + 2 * (size_t)n * p + 8 * q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_head_bwd_kernel(
    const T* __restrict__ zx, const float* __restrict__ xbc, const float* __restrict__ dt,
    const float* __restrict__ cum, const float* __restrict__ dys, const T* __restrict__ states,
    const float* __restrict__ dstate, const float* __restrict__ gW,
    const float* __restrict__ gdcum, const float* __restrict__ dt_bias,
    const float* __restrict__ A, const float* __restrict__ Dp, float* __restrict__ dxbc,
    T* __restrict__ dzx, float* __restrict__ pv_part, Dims d) {
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int q = d.q, n = d.n, p = d.p, ldq = q + 4, pc4 = p / 4;
  const long row0 = (long)b * d.L + (long)c * q;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                 // [q(t)][q(j)]  W of this head
  float* s_dy = s_w + q * q;         // [q][p]        dy_ssd of this head
  float* s_bt = s_dy + q * p;        // [n][q+4]      B^T
  float* s_ct = s_bt + n * ldq;      // [n][q+4]      C^T
  float* s_st = s_ct + n * ldq;      // [n][p]        the entering state
  float* s_dst = s_st + n * p;       // [n][p]        the leaving state's gradient
  float* s_cum = s_dst + n * p;      // [q]
  float* s_dt = s_cum + q;           // [q]
  float* s_pc = s_dt + q;            // [q]  readout dcum: sum_e dy y2
  float* s_pd = s_pc + q;            // [q]  state-decay dcum: sum_e dxdt_s xdt_s
  float* s_px = s_pd + q;            // [q]  sum_e dxdt x
  float* s_dA = s_px + q;            // [q]  dcum, then ddA
  float* s_t1 = s_dA + q;            // [q]  ddA dt
  float* s_t2 = s_t1 + q;            // [q]  ddt_raw
  __shared__ float s_red[2 * kThreads / 32];

  const long hq = (((long)b * d.nc + c) * d.h + hh);
  {
    const float4* src = reinterpret_cast<const float4*>(gW + hq * q * q);
    for (int idx = tid; idx < q * q / 4; idx += kThreads)
      reinterpret_cast<float4*>(s_w)[idx] = src[idx];
  }
  for (int idx = tid; idx < q * p; idx += kThreads) {
    const int t = idx / p, e = idx - t * p;
    s_dy[idx] = dys[(row0 + t) * d.di + hh * p + e];
  }
  stage_bc_t(xbc, row0, s_bt, s_ct, d);
  for (int idx = tid; idx < n * p; idx += kThreads) {
    s_st[idx] = to_f32(states[hq * n * p + idx]);
    s_dst[idx] = dstate[hq * n * p + idx];
  }
  for (int j = tid; j < q; j += kThreads) {
    s_cum[j] = cum[(row0 + j) * d.h + hh];
    s_dt[j] = dt[(row0 + j) * d.h + hh];
  }
  __syncthreads();

  const float last = s_cum[q - 1], Dh = Dp[hh];
  float dD = 0.f;
  const int tiles = (q / 4) * pc4;
  for (int tile0 = 0; tile0 < tiles; tile0 += kThreads) {  // uniform: the shuffles below
    const int tile = tile0 + tid;
    const bool valid = tile < tiles;
    const int i0 = valid ? (tile / pc4) * 4 : 0, e0 = (tile % pc4) * 4;
    float pc[4] = {}, pd[4] = {}, px[4] = {};
    if (valid) {
      float ax[4][4] = {}, ac[4][4] = {}, ab[4][4] = {};
      mm4x4(ax, s_w, 1, q, s_dy, p, i0, e0, i0, q);    // dxdt_intra[j] = sum_t W[t, j] dy_t
      mm4x4(ac, s_ct, 1, ldq, s_st, p, i0, e0, 0, n);  // C_t . st
      mm4x4(ab, s_bt, 1, ldq, s_dst, p, i0, e0, 0, n); // dxdt_s[j] = B_j . dst
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        const float ci = s_cum[i], dti = s_dt[i], ei = expf(ci), d2 = expf(last - ci);
        const float4 x4 = ld4(xbc + (row0 + i) * d.dc + hh * p + e0);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        float dx[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float dyv = s_dy[i * p + e0 + s];
          const float xdt_s = xv[s] * dti * d2, dxs = ab[r][s];
          pc[r] = fmaf(dyv, ei * ac[r][s], pc[r]);
          pd[r] = fmaf(dxs, xdt_s, pd[r]);
          const float dxdt = fmaf(dxs, d2, ax[r][s]);
          px[r] = fmaf(dxdt, xv[s], px[r]);
          dD = fmaf(dyv, xv[s], dD);
          dx[s] = fmaf(dxdt, dti, dyv * Dh);
        }
        st4(dxbc + (row0 + i) * d.dc + hh * p + e0, dx[0], dx[1], dx[2], dx[3]);
      }
    }
    // the pc4 lanes of one row tile are consecutive and aligned in the warp
    for (int o = 1; o < pc4; o <<= 1) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pc[r] += __shfl_xor_sync(0xffffffffu, pc[r], o);
        pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], o);
        px[r] += __shfl_xor_sync(0xffffffffu, px[r], o);
      }
    }
    if (valid && tile % pc4 == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s_pc[i0 + r] = pc[r];
        s_pd[i0 + r] = pd[r];
        s_px[i0 + r] = px[r];
      }
    }
  }
  float sst = 0.f;
  for (int idx = tid; idx < n * p; idx += kThreads) sst = fmaf(s_dst[idx], s_st[idx], sst);
  const float2 tot = block_sum2(sst, dD, s_red);  // its barriers publish s_pc/s_pd/s_px
  for (int i = tid; i < q; i += kThreads)
    s_dA[i] = gdcum[(row0 + i) * d.h + hh] + s_pc[i] - s_pd[i];
  __syncthreads();
  if (tid == 0) {
    // dcum_last, then ddA[j] = sum_{t >= j} dcum[t] + dcum_last
    float dlast = expf(last) * tot.x;
    for (int i = 0; i < q; ++i) dlast += s_pd[i];
    float run = 0.f;
    for (int i = q - 1; i >= 0; --i) {
      run += s_dA[i];
      s_dA[i] = run + dlast;
    }
  }
  __syncthreads();
  const float Ah = A[hh], bias = dt_bias[hh];
  for (int i = tid; i < q; i += kThreads) {
    const long row = row0 + i;
    const float ddA = s_dA[i];
    const float ddt = fmaf(ddA, Ah, s_px[i]);
    const float ddtr = ddt * sigmoid(to_f32(zx[row * d.W + d.di + d.dc + hh]) + bias);
    dzx[row * d.W + d.di + d.dc + hh] = from_f32<T>(ddtr);
    s_t1[i] = ddA * s_dt[i];
    s_t2[i] = ddtr;
  }
  __syncthreads();
  if (tid == 0) {
    float sb = 0.f, sa = 0.f;
    for (int i = 0; i < q; ++i) {
      sb += s_t2[i];
      sa += s_t1[i];
    }
    float* part = pv_part + ((long)b * d.nc + c) * 3 * d.h;
    part[hh] = sb;             // dt_bias
    part[d.h + hh] = sa;       // A
    part[2 * d.h + hh] = tot.y;  // D
  }
}

// ---- 8. dB, dC, general body -------------------------------------------------------
__host__ __device__ inline size_t bc_smem_floats(int q, int n, int p) {
  const size_t one = (size_t)q * (q + 4) + 2 * (size_t)q * n;
  const size_t two = 2 * (size_t)q * (p + 4) + 2 * (size_t)p * (n + 4);
  return one > two ? one : two;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bc_bwd_kernel(
    const float* __restrict__ xbc, const float* __restrict__ dt, const float* __restrict__ cum,
    const float* __restrict__ dys, const T* __restrict__ states,
    const float* __restrict__ dstate, const float* __restrict__ gdS, float* __restrict__ dxbc,
    Dims d) {
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int q = d.q, n = d.n, p = d.p, ldd = q + 4, ldp = p + 4, ldn = n + 4;
  const long row0 = (long)b * d.L + (long)c * q;
  extern __shared__ __align__(16) float smem[];
  // phase 1
  float* s_ds = smem;               // [q(t)][q+4]  sum over heads of dS
  float* s_b = s_ds + q * ldd;      // [q][n]  B rows
  float* s_c = s_b + q * n;         // [q][n]  C rows
  // phase 2, per head (over phase 1)
  float* s_dr = smem;               // [q][p+4]  dy_ssd exp(cum)
  float* s_xs = s_dr + q * ldp;     // [q][p+4]  x dt exp(cum_last - cum)
  float* s_stt = s_xs + q * ldp;    // [p][n+4]  st^T
  float* s_dstt = s_stt + p * ldn;  // [p][n+4]  dst^T

  const long bc = (long)b * d.nc + c;
  for (int idx = tid; idx < q * q; idx += kThreads) {
    const int t = idx / q, j = idx - t * q;
    const float* src = gdS + bc * d.h * q * q + idx;
    float s = 0.f;
    for (int hh = 0; hh < d.h; ++hh) s += src[(long)hh * q * q];
    s_ds[t * ldd + j] = s;
  }
  for (int idx = tid; idx < q * n; idx += kThreads) {
    const int t = idx / n, i = idx - t * n;
    s_b[idx] = xbc[(row0 + t) * d.dc + d.di + i];
    s_c[idx] = xbc[(row0 + t) * d.dc + d.di + n + i];
  }
  __syncthreads();

  // tiles u < T1: dC [t][i]; T1 <= u < 2 T1: dB [j][i]
  const int nt = n / 4, T1 = (q / 4) * nt;
  float acc[kMaxBcTiles][4][4] = {};
#pragma unroll
  for (int m = 0; m < kMaxBcTiles; ++m) {
    const int u = tid + m * kThreads;
    if (u >= 2 * T1) continue;
    const int rem = u % T1, r0 = (rem / nt) * 4, s0 = (rem % nt) * 4;
    if (u < T1)  // dC[t] = sum_{j <= t} dS[t, j] B_j
      mm4x4(acc[m], s_ds, ldd, 1, s_b, n, r0, s0, 0, min(q, r0 + 4));
    else         // dB[j] = sum_{t >= j} dS[t, j] C_t
      mm4x4(acc[m], s_ds, 1, ldd, s_c, n, r0, s0, r0, q);
  }
  for (int hh = 0; hh < d.h; ++hh) {
    __syncthreads();
    const float last = cum[(row0 + q - 1) * d.h + hh];
    for (int idx = tid; idx < q * p; idx += kThreads) {
      const int t = idx / p, e = idx - t * p;
      const long row = row0 + t;
      const float ct = cum[row * d.h + hh];
      s_dr[t * ldp + e] = dys[row * d.di + hh * p + e] * expf(ct);
      s_xs[t * ldp + e] = xbc[row * d.dc + hh * p + e] * dt[row * d.h + hh] * expf(last - ct);
    }
    const long so = (bc * d.h + hh) * n * p;
    for (int idx = tid; idx < n * p; idx += kThreads) {
      const int i = idx / p, e = idx - i * p;
      s_stt[e * ldn + i] = to_f32(states[so + idx]);
      s_dstt[e * ldn + i] = dstate[so + idx];
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kMaxBcTiles; ++m) {
      const int u = tid + m * kThreads;
      if (u >= 2 * T1) continue;
      const int rem = u % T1, r0 = (rem / nt) * 4, s0 = (rem % nt) * 4;
      if (u < T1)  // dC[t] += dr_t . st^T
        mm4x4(acc[m], s_dr, ldp, 1, s_stt, ldn, r0, s0, 0, p);
      else         // dB[j] += xdt_s_j . dst^T
        mm4x4(acc[m], s_xs, ldp, 1, s_dstt, ldn, r0, s0, 0, p);
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxBcTiles; ++m) {
    const int u = tid + m * kThreads;
    if (u >= 2 * T1) continue;
    const int rem = u % T1, r0 = (rem / nt) * 4, s0 = (rem % nt) * 4;
    const int ch = d.di + (u < T1 ? n : 0) + s0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st4(dxbc + (row0 + r0 + r) * d.dc + ch, acc[m][r][0], acc[m][r][1], acc[m][r][2],
          acc[m][r][3]);
  }
}

// ---- 6'. intra and head rest, tensor-core body ----------------------------------
// Launches 6 and 7 fused, with W kept on chip: one CTA per (chunk, batch)
// computes the scores C.B^T of its 16 x 8 tiles on or below the diagonal
// once into registers (warp w takes tiles w, w + 8, ...), then walks the
// heads in order. Per head: dW = dy_ssd . xdt^T on those tiles, W = scores
// decay into shared memory (packed tiles), dS = dW decay summed over the
// heads in registers (fixed head order), the dcum row and column sums of
// dW * W per warp; then per 16-row tile (warp w: {w % 4, 7 - w % 4}, of the
// column half w / 4) the readout C.st, dxdt_s = B.dst and W^T.dy_ssd on
// tensor cores and the head rest of launch 7. The sum over heads of dS [tri][16][8] is the only q x q value
// that leaves the chip. W and the sum of dS are packed 16 x 8 tiles in
// tri_tile's order, row-major and unswizzled: their A fragments are read
// transposed here (and as stored in 8'), conflict-free without a swizzle.
// Layout (floats): W [tri][16][8] | B [q][n+4] | C
// [q][n+4] | dy_ssd [q][p+4] | x [q][p+4] | st [n][p+8] (T) | dst [n][p+8] |
// cum, dt [2q] | dd row and column sums [2][kWarps][q] | pc, pd, px per
// column half [3][2][q] | dcum [q] | 16 reduction slots.
constexpr int kMaxTri = 9;  // causal tiles a warp holds: ceil(8 * 9 / kWarps) at q = 128

__host__ __device__ inline size_t intra_rest_tc_floats(int q, int n, int p) {
  const size_t mts = q / 16;
  return mts * (mts + 1) * 128 + 2 * (size_t)q * (n + 4) + 2 * (size_t)q * (p + 4) +
         2 * (size_t)n * (p + 8) + (2 + 2 * kWarps + 6 + 1) * (size_t)q + 16;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_intra_rest_tc_kernel(
    const T* __restrict__ zx, const float* __restrict__ xbc, const float* __restrict__ dt,
    const float* __restrict__ cum, const float* __restrict__ dys, const T* __restrict__ states,
    const float* __restrict__ dstate, const float* __restrict__ dt_bias,
    const float* __restrict__ A, const float* __restrict__ Dp, float* __restrict__ dxbc,
    T* __restrict__ dzx, float* __restrict__ ds_sum, float* __restrict__ pv_part, Dims d) {
  using namespace tf32;
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g8 = lane >> 2, c4 = lane & 3;
  const int q = d.q, n = d.n, p = d.p, ldn = n + 4, ldq = p + 4, lds = p + 8;
  const int mts = q / 16, tri = mts * (mts + 1);
  const long row0 = (long)b * d.L + (long)c * q;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                      // [tri][16][8]  W of the head
  float* s_b = s_w + (size_t)tri * 128;   // [q][n+4]  B
  float* s_c = s_b + (size_t)q * ldn;     // [q][n+4]  C
  float* s_dy = s_c + (size_t)q * ldn;    // [q][p+4]  dy_ssd of the head
  float* s_x = s_dy + (size_t)q * ldq;    // [q][p+4]  x of the head
  float* s_st = s_x + (size_t)q * ldq;    // [n][p+8]  the entering state (T)
  float* s_dst = s_st + (size_t)n * lds;  // [n][p+8]  the leaving state's gradient
  float* s_cum = s_dst + (size_t)n * lds; // [q]
  float* s_dt = s_cum + q;                // [q]
  float* s_rs = s_dt + q;                 // [kWarps][q]  row sums of dW * W
  float* s_cs = s_rs + kWarps * q;        // [kWarps][q]  column sums of dW * W
  float* s_pc = s_cs + kWarps * q;        // [2][q]  readout dcum: sum_e dy exp(cum) C.st
  float* s_pd = s_pc + 2 * q;             // [2][q]  state-decay dcum: sum_e dxdt_s xdt_s
  float* s_px = s_pd + 2 * q;             // [2][q]  sum_e dxdt x
  float* s_da = s_px + 2 * q;             // [q]  dcum, then ddA
  float* s_red = s_da + q;                // [16]
  const T* s_s = reinterpret_cast<const T*>(s_st);

  stage<float>(s_b, ldn, xbc + row0 * d.dc + d.di, d.dc, q, n);
  stage<float>(s_c, ldn, xbc + row0 * d.dc + d.di + n, d.dc, q, n);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
  float sg[kMaxTri][4], sds[kMaxTri][4];  // the scores and the sum over heads of dS
#pragma unroll
  for (int s = 0; s < kMaxTri; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sg[s][i] = sds[s][i] = 0.f;
    const int u = warp + kWarps * s;
    if (u >= tri) continue;
    const int2 at = tri_tile(u);
    for (int k0 = 0; k0 < n; k0 += 8) {
      const FragA a = load_a([&](int t, int i) { return s_c[t * ldn + i]; }, at.x, k0);
      const FragB bb = load_b([&](int i, int j) { return s_b[j * ldn + i]; }, k0, at.y);
      mma3(sg[s], a, bb);
    }
  }

  const long st0 = ((long)b * d.nc + c) * d.h * n * p;
  const int rg = warp & 3, half = warp >> 2, nts = p / 16, c0 = half * (p / 2);
  const int trn = c4 * 8 + g8;  // this lane's offset of a transposed packed-tile A fragment
  for (int hh = 0; hh < d.h; ++hh) {
    stage<float>(s_dy, ldq, dys + row0 * d.di + hh * p, d.di, q, p);
    stage<float>(s_x, ldq, xbc + row0 * d.dc + hh * p, d.dc, q, p);
    stage<T>(reinterpret_cast<T*>(s_st), lds, states + st0 + (long)hh * n * p, p, n, p);
    stage<float>(s_dst, lds, dstate + st0 + (long)hh * n * p, p, n, p);
    sm90::cp_async_commit();
    for (int t = tid; t < q; t += kThreads) {
      s_cum[t] = cum[(row0 + t) * d.h + hh];
      s_dt[t] = dt[(row0 + t) * d.h + hh];
    }
    for (int i = tid; i < 2 * kWarps * q; i += kThreads) s_rs[i] = 0.f;  // s_rs, s_cs
    sm90::cp_async_wait<0>();
    __syncthreads();

    // the causal tiles: dW, W, dS, the dcum sums
    float* rs = s_rs + warp * q;
    float* cs = s_cs + warp * q;
#pragma unroll
    for (int s = 0; s < kMaxTri; ++s) {
      const int u = warp + kWarps * s;
      if (u >= tri) break;
      const int2 at = tri_tile(u);
      float dw[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < p; k0 += 8) {  // dW[t][j] = dy_t . x_j dt_j
        const FragA a = load_a([&](int t, int e) { return s_dy[t * ldq + e]; }, at.x, k0);
        const FragB bb =
            load_b([&](int e, int j) { return s_x[j * ldq + e] * s_dt[j]; }, k0, at.y);
        mma3(dw, a, bb);
      }
      float w[4], dd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = acc_row(at.x, i), j = acc_col(at.y, i);
        const float lm = j <= t ? expf(s_cum[t] - s_cum[j]) : 0.f;
        w[i] = sg[s][i] * lm;
        sds[s][i] += dw[i] * lm;
        dd[i] = dw[i] * w[i];
      }
      float* wt = s_w + u * 128;
      *reinterpret_cast<float2*>(wt + g8 * 8 + 2 * c4) = make_float2(w[0], w[1]);
      *reinterpret_cast<float2*>(wt + (g8 + 8) * 8 + 2 * c4) = make_float2(w[2], w[3]);
      // rows g8, g8 + 8 over the tile's 8 columns (the 4 lanes of a row);
      // columns 2 c4, 2 c4 + 1 over its 16 rows (the 8 lanes of a column)
      float r0s = dd[0] + dd[1], r1s = dd[2] + dd[3], c0s = dd[0] + dd[2], c1s = dd[1] + dd[3];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        r0s += __shfl_xor_sync(0xffffffffu, r0s, o);
        r1s += __shfl_xor_sync(0xffffffffu, r1s, o);
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        c0s += __shfl_xor_sync(0xffffffffu, c0s, o);
        c1s += __shfl_xor_sync(0xffffffffu, c1s, o);
      }
      if (c4 == 0) {  // one lane per row and column: no two lanes add to one entry
        rs[at.x + g8] += r0s;
        rs[at.x + g8 + 8] += r1s;
      }
      if (g8 == 0) {
        cs[at.y + 2 * c4] += c0s;
        cs[at.y + 2 * c4 + 1] += c1s;
      }
    }
    __syncthreads();

    // per 16-row tile: the readout, dxdt = W^T dy + (B.dst) d2, the D skip
    const float last = s_cum[q - 1], Dh = Dp[hh];
    float dD = 0.f;
    for (int sl = 0; sl < 2; ++sl) {
      const int mt = sl ? 7 - rg : rg;
      if (mt >= mts) continue;
      const int r0 = 16 * mt, ra = r0 + g8, rb = ra + 8;
      float acc[4][4] = {}, ab[4][4] = {};
      for (int k0 = 0; k0 < n; k0 += 8) {  // C_t . st and B_j . dst
        const FragA ac = load_a([&](int t, int i) { return s_c[t * ldn + i]; }, r0, k0);
        const FragA abm = load_a([&](int j, int i) { return s_b[j * ldn + i]; }, r0, k0);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          if (jn >= nts) break;
          const FragB bs =
              load_b([&](int i, int e) { return to_f32(s_s[i * lds + e]); }, k0, c0 + 8 * jn);
          const FragB bd = load_b([&](int i, int e) { return s_dst[i * lds + e]; }, k0, c0 + 8 * jn);
          mma3(acc[jn], ac, bs);
          mma3(ab[jn], abm, bd);
        }
      }
      const float ea = expf(s_cum[ra]), eb = expf(s_cum[rb]);
      float pca = 0.f, pcb = 0.f;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        if (jn >= nts) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = acc_row(r0, i), e = acc_col(c0 + 8 * jn, i);
          const float v = s_dy[t * ldq + e] * (i < 2 ? ea : eb) * acc[jn][i];
          if (i < 2) pca += v;
          else pcb += v;
          acc[jn][i] = 0.f;
        }
      }
      for (int k0 = r0; k0 < q; k0 += 8) {  // dxdt_intra[j] = sum_{t >= j} W[t][j] dy_t
        const int mk = k0 >> 4;
        const FragA a = load_a_at(s_w + (mk * (mk + 1) + (r0 >> 3)) * 128 + (k0 & 15) * 8, trn,
                                  trn + 128, trn + 32, trn + 160);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          if (jn >= nts) break;
          const FragB bb = load_b([&](int t, int e) { return s_dy[t * ldq + e]; }, k0, c0 + 8 * jn);
          mma3(acc[jn], a, bb);
        }
      }
      const float dta = s_dt[ra], dtb = s_dt[rb];
      const float d2a = expf(last - s_cum[ra]), d2b = expf(last - s_cum[rb]);
      float pda = 0.f, pdb = 0.f, pxa = 0.f, pxb = 0.f;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        if (jn >= nts) break;
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          const int j = acc_row(r0, i), e = acc_col(c0 + 8 * jn, i);
          const float dti = i < 2 ? dta : dtb, d2 = i < 2 ? d2a : d2b;
          float dx[2], pd = 0.f, px = 0.f;
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float x = s_x[j * ldq + e + h2], dyv = s_dy[j * ldq + e + h2];
            const float xdt_s = x * dti * d2, dxs = ab[jn][i + h2];
            pd = fmaf(dxs, xdt_s, pd);
            const float dxdt = fmaf(dxs, d2, acc[jn][i + h2]);
            px = fmaf(dxdt, x, px);
            dD = fmaf(dyv, x, dD);
            dx[h2] = fmaf(dxdt, dti, dyv * Dh);
          }
          *reinterpret_cast<float2*>(dxbc + (row0 + j) * d.dc + hh * p + e) =
              make_float2(dx[0], dx[1]);
          if (i < 2) {
            pda += pd;
            pxa += px;
          } else {
            pdb += pd;
            pxb += px;
          }
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        pca += __shfl_xor_sync(0xffffffffu, pca, o);
        pcb += __shfl_xor_sync(0xffffffffu, pcb, o);
        pda += __shfl_xor_sync(0xffffffffu, pda, o);
        pdb += __shfl_xor_sync(0xffffffffu, pdb, o);
        pxa += __shfl_xor_sync(0xffffffffu, pxa, o);
        pxb += __shfl_xor_sync(0xffffffffu, pxb, o);
      }
      if (c4 == 0) {
        s_pc[half * q + ra] = pca;
        s_pc[half * q + rb] = pcb;
        s_pd[half * q + ra] = pda;
        s_pd[half * q + rb] = pdb;
        s_px[half * q + ra] = pxa;
        s_px[half * q + rb] = pxb;
      }
    }
    float sst = 0.f;
    for (int idx = tid; idx < n * p; idx += kThreads) {
      const int i = idx / p, e = idx - i * p;
      sst = fmaf(s_dst[i * lds + e], to_f32(s_s[i * lds + e]), sst);
    }
    const float2 tot = block_sum2(sst, dD, s_red);  // its barriers publish the row sums
    for (int i = tid; i < q; i += kThreads) {
      float rsum = 0.f, csum = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        rsum += s_rs[w * q + i];
        csum += s_cs[w * q + i];
      }
      s_da[i] = (rsum - csum) + (s_pc[i] + s_pc[q + i]) - (s_pd[i] + s_pd[q + i]);
    }
    __syncthreads();
    if (warp == 0) {
      // dcum_last = exp(cum_last) sum(dst st) + sum_j pd[j]; then ddA[j] =
      // sum_{t >= j} dcum[t] + dcum_last, 32 rows at a time from the last
      float pds = 0.f;
      for (int i = lane; i < q; i += 32) pds += s_pd[i] + s_pd[q + i];
      const float dlast = fmaf(expf(last), tot.x, warp_sum(pds));
      float carry = 0.f;
      for (int base = q - 32; base >= 0; base -= 32) {
        float v = s_da[base + lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float up = __shfl_down_sync(0xffffffffu, v, o);
          if (lane + o < 32) v += up;
        }
        s_da[base + lane] = v + carry + dlast;
        carry += __shfl_sync(0xffffffffu, v, 0);
      }
    }
    __syncthreads();
    const float Ah = A[hh], bias = dt_bias[hh];
    float sb = 0.f, sa = 0.f;
    for (int i = tid; i < q; i += kThreads) {
      const long row = row0 + i;
      const float ddA = s_da[i];
      const float ddt = fmaf(ddA, Ah, s_px[i] + s_px[q + i]);
      const float ddtr = ddt * sigmoid(to_f32(zx[row * d.W + d.di + d.dc + hh]) + bias);
      dzx[row * d.W + d.di + d.dc + hh] = from_f32<T>(ddtr);
      sa += ddA * s_dt[i];
      sb += ddtr;
    }
    const float2 sums = block_sum2(sb, sa, s_red);
    if (tid == 0) {
      float* part = pv_part + ((long)b * d.nc + c) * 3 * d.h;
      part[hh] = sums.x;            // dt_bias
      part[d.h + hh] = sums.y;      // A
      part[2 * d.h + hh] = tot.y;   // D
    }
    __syncthreads();
  }
  float* o = ds_sum + ((long)b * d.nc + c) * tri * 128;
#pragma unroll
  for (int s = 0; s < kMaxTri; ++s) {
    const int u = warp + kWarps * s;
    if (u >= tri) break;
    *reinterpret_cast<float2*>(o + u * 128 + g8 * 8 + 2 * c4) = make_float2(sds[s][0], sds[s][1]);
    *reinterpret_cast<float2*>(o + u * 128 + (g8 + 8) * 8 + 2 * c4) =
        make_float2(sds[s][2], sds[s][3]);
  }
}

// ---- 8'. dB, dC, tensor-core body --------------------------------------------------
// One CTA per (chunk, batch); warps 0-3 compute dC, warps 4-7 dB, each warp
// the row tiles {w % 4, 7 - w % 4} and every column, accumulating in
// registers: first the sum over heads of dS (from launch 6') against B and
// C, then per head dr . st^T and xdt_s . dst^T, heads double-buffered by
// cp.async. Layout (floats): region 0 = sum dS [tri][16][8] | B [q][n+8] |
// C [q][n+8], then the buffer of odd heads; region 1 = the buffer of even
// heads: dy_ssd [q][p+4] | x [q][p+4] | st [n][p+8] (T) | dst [n][p+4] |
// exp(cum), dt exp(cum_last - cum) [2q].
__host__ __device__ inline size_t bc_tc_head_floats(int q, int n, int p) {
  return 2 * (size_t)q * (p + 4) + (size_t)n * (p + 8) + (size_t)n * (p + 4) + 2 * (size_t)q;
}

__host__ __device__ inline size_t bc_tc_floats(int q, int n, int p) {
  const size_t mts = q / 16, one = mts * (mts + 1) * 128 + 2 * (size_t)q * (n + 8);
  const size_t head = bc_tc_head_floats(q, n, p);
  return (one > head ? one : head) + head;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bc_tc_kernel(
    const float* __restrict__ xbc, const float* __restrict__ dt, const float* __restrict__ cum,
    const float* __restrict__ dys, const T* __restrict__ states,
    const float* __restrict__ dstate, const float* __restrict__ ds_sum,
    float* __restrict__ dxbc, Dims d) {
  using namespace tf32;
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5;
  const int q = d.q, n = d.n, p = d.p, ldn = n + 8, ldq = p + 4, ldd = p + 4;
  const int ldst = sizeof(T) == 4 ? p + 4 : p + 8;  // in T: conflict-free B loads either way
  const int mts = q / 16, tri = mts * (mts + 1), nn = n / 8;
  const long row0 = (long)b * d.L + (long)c * q, bc = (long)b * d.nc + c;
  const size_t one = (size_t)tri * 128 + 2 * (size_t)q * ldn, head = bc_tc_head_floats(q, n, p);
  extern __shared__ __align__(16) float smem[];
  float* s_ds = smem;                      // [tri][16][8]  sum over heads of dS
  float* s_b = s_ds + (size_t)tri * 128;   // [q][n+8]  B
  float* s_c = s_b + (size_t)q * ldn;      // [q][n+8]  C
  float* region1 = smem + (one > head ? one : head);
  const long st0 = bc * d.h * n * p;

  auto stage_head = [&](int hh, float* buf) {
    stage<float>(buf, ldq, dys + row0 * d.di + hh * p, d.di, q, p);
    stage<float>(buf + (size_t)q * ldq, ldq, xbc + row0 * d.dc + hh * p, d.dc, q, p);
    float* st = buf + 2 * (size_t)q * ldq;
    stage<T>(reinterpret_cast<T*>(st), ldst, states + st0 + (long)hh * n * p, p, n, p);
    stage<float>(st + (size_t)n * (p + 8), ldd, dstate + st0 + (long)hh * n * p, p, n, p);
  };
  // threads t < q: the next head's cum_t, dt_t and cum_last, loaded while
  // the current head computes, stored as exp(cum_t), dt_t exp(cum_last - cum_t)
  float next_cum = 0.f, next_dt = 0.f, next_last = 0.f;
  auto load_vec = [&](int hh) {
    if (tid < q) {
      next_cum = cum[(row0 + tid) * d.h + hh];
      next_dt = dt[(row0 + tid) * d.h + hh];
      next_last = cum[(row0 + q - 1) * d.h + hh];
    }
  };
  auto store_vec = [&](float* buf) {
    float* ecum = buf + 2 * (size_t)q * ldq + (size_t)n * (p + 8) + (size_t)n * ldd;
    if (tid < q) {
      ecum[tid] = expf(next_cum);
      ecum[q + tid] = next_dt * expf(next_last - next_cum);
    }
  };
  stage<float>(s_ds, 128, ds_sum + bc * tri * 128, 128, tri, 128);
  stage<float>(s_b, ldn, xbc + row0 * d.dc + d.di, d.dc, q, n);
  stage<float>(s_c, ldn, xbc + row0 * d.dc + d.di + n, d.dc, q, n);
  sm90::cp_async_commit();
  stage_head(0, region1);
  sm90::cp_async_commit();
  load_vec(0);
  store_vec(region1);
  sm90::cp_async_wait<1>();
  __syncthreads();

  const int rg = warp & 3;
  const bool is_dc = warp < 4;
  // this lane's offsets of a packed-tile A fragment, as stored and transposed
  const int nrm = ((tid & 31) >> 2) * 8 + (tid & 3), trn = (tid & 3) * 8 + ((tid & 31) >> 2);
  float acc[2][8][4] = {};
  // dC[t] = sum_{j <= t} dS[t][j] B_j;  dB[j] = sum_{t >= j} dS[t][j] C_t
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int mt = s ? 7 - rg : rg, r0 = 16 * mt;
    if (mt >= mts) continue;
    if (is_dc) {
      const float* ds_row = s_ds + mt * (mt + 1) * 128;  // row tile mt's first tile
      for (int k0 = 0; k0 < r0 + 16; k0 += 8, ds_row += 128) {
        const FragA a = load_a_at(ds_row, nrm, nrm + 64, nrm + 4, nrm + 68);
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          if (jn >= nn) break;
          const FragB bb = load_b([&](int j, int i) { return s_b[j * ldn + i]; }, k0, 8 * jn);
          mma3(acc[s][jn], a, bb);
        }
      }
    } else {
      for (int k0 = r0; k0 < q; k0 += 8) {
        const int mk = k0 >> 4;
        const FragA a = load_a_at(s_ds + (mk * (mk + 1) + (r0 >> 3)) * 128 + (k0 & 15) * 8, trn,
                                  trn + 128, trn + 32, trn + 160);
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          if (jn >= nn) break;
          const FragB bb = load_b([&](int t, int i) { return s_c[t * ldn + i]; }, k0, 8 * jn);
          mma3(acc[s][jn], a, bb);
        }
      }
    }
  }
  __syncthreads();  // region 0 is free for the odd heads

  // dC[t] += (dy_ssd_t exp(cum_t)) . st^T;  dB[j] += (x_j dt_j exp(cum_last - cum_j)) . dst^T
  for (int hh = 0; hh < d.h; ++hh) {
    float* cur = (hh & 1) ? smem : region1;
    float* next = (hh & 1) ? region1 : smem;
    if (hh + 1 < d.h) {
      stage_head(hh + 1, next);
      load_vec(hh + 1);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
    const float* s_dy = cur;
    const float* s_x = cur + (size_t)q * ldq;
    const T* s_st = reinterpret_cast<const T*>(cur + 2 * (size_t)q * ldq);
    const float* s_dst = cur + 2 * (size_t)q * ldq + (size_t)n * (p + 8);
    const float* s_e = s_dst + (size_t)n * ldd;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int mt = s ? 7 - rg : rg, r0 = 16 * mt;
      if (mt >= mts) continue;
      for (int k0 = 0; k0 < p; k0 += 8) {
        if (is_dc) {
          const FragA a =
              load_a([&](int t, int e) { return s_dy[t * ldq + e] * s_e[t]; }, r0, k0);
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) {
            if (jn >= nn) break;
            const FragB bb =
                load_b([&](int e, int i) { return to_f32(s_st[i * ldst + e]); }, k0, 8 * jn);
            mma3(acc[s][jn], a, bb);
          }
        } else {
          const FragA a =
              load_a([&](int j, int e) { return s_x[j * ldq + e] * s_e[q + j]; }, r0, k0);
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) {
            if (jn >= nn) break;
            const FragB bb = load_b([&](int e, int i) { return s_dst[i * ldd + e]; }, k0, 8 * jn);
            mma3(acc[s][jn], a, bb);
          }
        }
      }
    }
    if (hh + 1 < d.h) store_vec(next);
    __syncthreads();
  }
  const int ch = d.di + (is_dc ? n : 0);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int mt = s ? 7 - rg : rg, r0 = 16 * mt;
    if (mt >= mts) continue;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      if (jn >= nn) break;
#pragma unroll
      for (int i = 0; i < 4; i += 2)
        *reinterpret_cast<float2*>(dxbc + (row0 + acc_row(r0, i)) * d.dc + ch +
                                   acc_col(8 * jn, i)) = make_float2(acc[s][jn][i], acc[s][jn][i + 1]);
    }
  }
}

// ---- 9. conv backward ---------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_conv_bwd_kernel(
    const T* __restrict__ zx, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, float* __restrict__ dxbc, float* __restrict__ wb_part,
    Dims d) {
  const int c = blockIdx.x, b = blockIdx.y;
  const int ch = blockIdx.z * kThreads + threadIdx.x;
  if (ch >= d.dc) return;
  const long row0 = (long)b * d.L + (long)c * d.q;
  const T* src = zx + d.di + ch;
  float w[kMaxConv], win[kMaxConv - 1], dw[kMaxConv];
#pragma unroll
  for (int j = 0; j < kMaxConv; ++j) {
    w[j] = j < d.k ? conv_w[(long)j * d.dc + ch] : 0.f;
    dw[j] = 0.f;
  }
  const float bias = conv_b[ch];
  float db = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxConv - 1; ++j) {
    const int t = c * d.q - (d.k - 1) + j;
    win[j] = (j < d.k - 1 && t >= 0) ? to_f32(src[((long)b * d.L + t) * d.W]) : 0.f;
  }
  for (int t = 0; t < d.q; ++t) {
    const float xr = to_f32(src[(row0 + t) * d.W]);
    float acc = 0.f;  // the prologue's pre-activation, in its order
#pragma unroll
    for (int j = 0; j < kMaxConv; ++j)
      if (j == d.k - 1) acc = xr * w[j];
#pragma unroll
    for (int j = 0; j < kMaxConv - 1; ++j)
      if (j < d.k - 1) acc = fmaf(win[j], w[j], acc);
    float* g = dxbc + (row0 + t) * d.dc + ch;
    const float dp = *g * dsilu(acc + bias);
    *g = dp;
#pragma unroll
    for (int j = 0; j < kMaxConv - 1; ++j)
      if (j < d.k - 1) dw[j] = fmaf(dp, win[j], dw[j]);
#pragma unroll
    for (int j = 0; j < kMaxConv; ++j)
      if (j == d.k - 1) dw[j] = fmaf(dp, xr, dw[j]);
    db += dp;
#pragma unroll
    for (int j = 0; j < kMaxConv - 1; ++j) {
      if (j < d.k - 2) win[j] = win[j + 1];
      else if (j == d.k - 2) win[j] = xr;
    }
  }
  float* part = wb_part + ((long)b * d.nc + c) * (d.k + 1) * d.dc + ch;
#pragma unroll
  for (int j = 0; j < kMaxConv; ++j)
    if (j < d.k) part[(long)j * d.dc] = dw[j];
  part[(long)d.k * d.dc] = db;
}

// ---- 10. conv transpose ---------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_conv_transpose_kernel(
    const float* __restrict__ dpre, const float* __restrict__ conv_w, T* __restrict__ dzx,
    Dims d) {
  const int c = blockIdx.x, b = blockIdx.y;
  const int ch = blockIdx.z * kThreads + threadIdx.x;
  if (ch >= d.dc) return;
  const long row0 = (long)b * d.L + (long)c * d.q;
  float w[kMaxConv];
#pragma unroll
  for (int j = 0; j < kMaxConv; ++j) w[j] = j < d.k ? conv_w[(long)j * d.dc + ch] : 0.f;
  for (int t = 0; t < d.q; ++t) {
    const long row = row0 + t;
    const int pos = c * d.q + t;  // in the sequence: rows past its end are zeros
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxConv; ++j)
      if (j == d.k - 1) acc = dpre[row * d.dc + ch] * w[j];
#pragma unroll
    for (int j = 0; j < kMaxConv - 1; ++j) {
      const int s = d.k - 1 - j;
      if (j < d.k - 1 && pos + s < d.L) acc = fmaf(dpre[(row + s) * d.dc + ch], w[j], acc);
    }
    dzx[row * d.W + d.di + ch] = from_f32<T>(acc);
  }
}

// ---- 11. fixed-order sums of per-chunk partials -----------------------------------------
__global__ void __launch_bounds__(kThreads) ssd_sum_parts_kernel(
    const float* __restrict__ part, float* __restrict__ out, int len, int splits) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < splits; ++k) s += part[(long)k * len + i];
  out[i] = s;
}

struct Bufs {
  float *xbc, *dt, *cum, *y, *dstate, *W, *dS, *dcum, *dxbc, *wb_part, *nw_part, *pv_part;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_bwd(const T* zx, const float* conv_w, const float* conv_b, const float* dt_bias,
               const float* A, const float* D, const float* norm_w, const T* states,
               const T* dy, const Bufs& w, T* dzx, float* dwb, float* dpv, float* dnw, Dims d,
               int pro_vec, cudaStream_t s) {
  const bool tc = tc_body(d.q, d.n, d.p);
  const size_t f = sizeof(float);
  const size_t out_smem = (tc ? output_tc_floats(d.q, d.n, d.p) : output_smem_floats(d.q, d.n, d.p)) * f;
  const size_t norm_smem = (size_t)d.di * f;
  const size_t local_smem =
      (tc ? head_state_tc_floats(d.q, d.n, d.p) : dlocal_smem_floats(d.q, d.n, d.p)) * f;
  const size_t intra_smem =
      (tc ? intra_rest_tc_floats(d.q, d.n, d.p) : intra_smem_floats(d.q, d.n, d.p)) * f;
  const size_t rest_smem = tc ? 0 : rest_smem_floats(d.q, d.n, d.p) * f;
  const size_t bc_smem = (tc ? bc_tc_floats(d.q, d.n, d.p) : bc_smem_floats(d.q, d.n, d.p)) * f;
  const int pc4 = d.p / 4;
  if (out_smem > kMaxSmem || norm_smem > 48 * 1024 || local_smem > kMaxSmem ||
      intra_smem > kMaxSmem || rest_smem > kMaxSmem || bc_smem > kMaxSmem ||
      d.k > kMaxConv || d.k < 1 || d.q % 8 || d.n % 4 || d.p % 4 || pc4 > 32 ||
      (pc4 & (pc4 - 1)) || 2 * (d.q / 4) * (d.n / 4) > kMaxBcTiles * kThreads ||
      (pro_vec && prologue_vec_refused(zx, conv_w, conv_b, w.xbc, d, sizeof(T))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const dim3 heads(d.h, d.nc, d.B), chunks(d.nc, d.B);
  const int slabs = (d.dc + kThreads - 1) / kThreads;
  const dim3 slabbed(d.nc, d.B, slabs);

  // 1, 2: the forward's xbc, dt, cum and y_ssd at the saved states
  const int pro = launch_prologue<T>(zx, conv_w, conv_b, dt_bias, A, w.xbc, w.dt, w.cum, d,
                                     pro_vec, s);
  if (pro != 0) return pro;
  OutputKernel<T> out_kern = tc ? ssd_chunk_output_tc_kernel<T> : ssd_chunk_output_kernel<T>;
  if ((err = set_smem(out_kern, out_smem)) != cudaSuccess) return (int)err;
  out_kern<<<tc ? chunks : heads, tc ? kTcThreads : kThreads, out_smem, s>>>(
      w.xbc, w.dt, w.cum, states, D, w.y, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 3
  ssd_norm_bwd_kernel<T><<<chunks, kThreads, norm_smem, s>>>(w.y, zx, dy, norm_w, dzx,
                                                             w.nw_part, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 4, 5
  if (tc) {
    if ((err = set_smem(ssd_dstate_local_tc_kernel, local_smem)) != cudaSuccess) return (int)err;
    ssd_dstate_local_tc_kernel<<<chunks, kThreads, local_smem, s>>>(w.xbc, w.cum, w.y, w.dstate,
                                                                    d);
  } else {
    if ((err = set_smem(ssd_dstate_local_kernel, local_smem)) != cudaSuccess) return (int)err;
    ssd_dstate_local_kernel<<<heads, kThreads, local_smem, s>>>(w.xbc, w.cum, w.y, w.dstate, d);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_dstate_reverse_kernel<<<dim3((d.n * d.p + kThreads - 1) / kThreads, d.h, d.B), kThreads,
                              0, s>>>(w.dstate, w.cum, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 6, 7, 8 (tc: 6' and 8', with the sum over heads of dS in w.dS)
  if (tc) {
    if ((err = set_smem(ssd_intra_rest_tc_kernel<T>, intra_smem)) != cudaSuccess) return (int)err;
    ssd_intra_rest_tc_kernel<T><<<chunks, kThreads, intra_smem, s>>>(
        zx, w.xbc, w.dt, w.cum, w.y, states, w.dstate, dt_bias, A, D, w.dxbc, dzx, w.dS,
        w.pv_part, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = set_smem(ssd_bc_tc_kernel<T>, bc_smem)) != cudaSuccess) return (int)err;
    ssd_bc_tc_kernel<T><<<chunks, kThreads, bc_smem, s>>>(w.xbc, w.dt, w.cum, w.y, states,
                                                          w.dstate, w.dS, w.dxbc, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  } else {
    if ((err = set_smem(ssd_intra_bwd_kernel, intra_smem)) != cudaSuccess) return (int)err;
    ssd_intra_bwd_kernel<<<heads, kThreads, intra_smem, s>>>(w.xbc, w.dt, w.cum, w.y, w.W, w.dS,
                                                             w.dcum, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = set_smem(ssd_head_bwd_kernel<T>, rest_smem)) != cudaSuccess) return (int)err;
    ssd_head_bwd_kernel<T><<<heads, kThreads, rest_smem, s>>>(
        zx, w.xbc, w.dt, w.cum, w.y, states, w.dstate, w.W, w.dcum, dt_bias, A, D, w.dxbc, dzx,
        w.pv_part, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = set_smem(ssd_bc_bwd_kernel<T>, bc_smem)) != cudaSuccess) return (int)err;
    ssd_bc_bwd_kernel<T><<<chunks, kThreads, bc_smem, s>>>(w.xbc, w.dt, w.cum, w.y, states,
                                                           w.dstate, w.dS, w.dxbc, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // 9, 10
  ssd_conv_bwd_kernel<T><<<slabbed, kThreads, 0, s>>>(zx, conv_w, conv_b, w.dxbc, w.wb_part, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_conv_transpose_kernel<T><<<slabbed, kThreads, 0, s>>>(w.dxbc, conv_w, dzx, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 11
  const int splits = d.B * d.nc;
  const int lens[3] = {(d.k + 1) * d.dc, 3 * d.h, d.di};
  const float* parts[3] = {w.wb_part, w.pv_part, w.nw_part};
  float* outs[3] = {dwb, dpv, dnw};
  for (int i = 0; i < 3; ++i) {
    ssd_sum_parts_kernel<<<(lens[i] + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        parts[i], outs[i], lens[i], splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) of one CTA of a tensor-core kernel of K7
// and K8 at chunk q, d_state n, headdim p: kernel 0 the chunk output, 1 the
// chunk state / dstate local, 2 K8's fused intra and head rest, 3 K8's
// dB/dC. (ops/ssd_mega_cuda.ssd_tc_smem states the same sums; a card test
// holds them equal.)
int pht_ssd_chain_tc_smem(int q, int n, int p, int kernel) {
  const size_t floats[4] = {output_tc_floats(q, n, p), head_state_tc_floats(q, n, p),
                            intra_rest_tc_floats(q, n, p), bc_tc_floats(q, n, p)};
  return kernel < 0 || kernel > 3 ? -1 : (int)(floats[kernel] * sizeof(float));
}

// zxbcdt [B, L, 2 di + 2 n + h] (bf16 or f32); f32 conv_w [k, di + 2n],
// conv_b [di + 2n], dt_bias, A, D [h], norm_w [di]; states [B, L/q, h, n,
// di/h] and dy [B, L, di] in zxbcdt's dtype. f32 scratch: xbc [B, L, dc],
// dt, cum [B, L, h], y [B, L, di], dstate [B, L/q, h, n, di/h], dxbc [B, L,
// dc], wb_part [B L/q, k + 1, dc], nw_part [B L/q, di], pv_part [B L/q, 3,
// h]; and by body (pht_ssd_chain_body): the general body's W and dS [B, L/q,
// h, q, q] and dcum [B, L, h]; the tensor-core body's dS, the sum over heads
// [B L/q, (q/16)(q/16 + 1), 16, 8], with W and dcum null. Outputs: dzx like
// zxbcdt, f32 dwb [k + 1, dc], dpv [3, h], dnw [di].
int pht_ssd_chain_bwd(const void* zx, const void* conv_w, const void* conv_b,
                      const void* dt_bias, const void* A, const void* D, const void* norm_w,
                      const void* states, const void* dy, void* xbc, void* dt, void* cum, void* y,
                      void* dstate, void* W, void* dS, void* dcum, void* dxbc, void* wb_part,
                      void* nw_part, void* pv_part, void* dzx, void* dwb, void* dpv, void* dnw,
                      int B, int L, int di, int n, int h, int k, int q, int is_bf16,
                      int pro_vec, void* stream) {
  const Dims d = chain_dims(B, L, di, n, h, k, q);
  Bufs w;
  w.xbc = static_cast<float*>(xbc); w.dt = static_cast<float*>(dt);
  w.cum = static_cast<float*>(cum); w.y = static_cast<float*>(y);
  w.dstate = static_cast<float*>(dstate); w.W = static_cast<float*>(W);
  w.dS = static_cast<float*>(dS); w.dcum = static_cast<float*>(dcum);
  w.dxbc = static_cast<float*>(dxbc); w.wb_part = static_cast<float*>(wb_part);
  w.nw_part = static_cast<float*>(nw_part); w.pv_part = static_cast<float*>(pv_part);
  const float* cw = static_cast<const float*>(conv_w);
  const float* cb = static_cast<const float*>(conv_b);
  const float* tb = static_cast<const float*>(dt_bias);
  const float* a = static_cast<const float*>(A);
  const float* dd = static_cast<const float*>(D);
  const float* nw = static_cast<const float*>(norm_w);
  float* o1 = static_cast<float*>(dwb);
  float* o2 = static_cast<float*>(dpv);
  float* o3 = static_cast<float*>(dnw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<bf16>(static_cast<const bf16*>(zx), cw, cb, tb, a, dd, nw,
                            static_cast<const bf16*>(states), static_cast<const bf16*>(dy), w,
                            static_cast<bf16*>(dzx), o1, o2, o3, d, pro_vec, s);
  return launch_bwd<float>(static_cast<const float*>(zx), cw, cb, tb, a, dd, nw,
                           static_cast<const float*>(states), static_cast<const float*>(dy), w,
                           static_cast<float*>(dzx), o1, o2, o3, d, pro_vec, s);
}

}  // extern "C"
