// Chunked SSD scan, forward (kernel K11 of the PyTorch port).
//
// Replaces the TPU kernel `_ssd_fwd_kernel` in
// pixel_heal_thyself_tpu/ops/ssd.py:324 (launched by `ssd_pallas` :393,
// `pallas_call` :426), with the XLA work around that call (the dt·A cumsum,
// x·dt, the D skip). From x [B, L, h, p], dt [B, L, h] and A [h] (passed
// in f32), B, C [B, L, 1, n] and D [h] (nullable; rounded to T, passed in
// f32), in T = x's dtype (bf16 or f32), with chunks of q tokens:
//   cum = in-chunk inclusive cumsum of dA (f32), dA = dt·A, rounded to bf16
//         when both dt and A are bf16 (the product is then formed in bf16)
//   xdt = round_T(x · round_T(dt))
//   per chunk and head, with the state st [n, p] carried in T:
//     y  = round_T( sum_{j<=t} round_T(round_T(C_t·B_j) · round_T(exp(cum_t − cum_j))) xdt_j
//                   + exp(cum_t) · (C_t · st) )
//     st = round_T( exp(cum_{q−1}) · st
//                   + sum_j B_j ⊗ round_T(xdt_j · round_T(exp(cum_{q−1} − cum_j))) )
//   out = y, or round_T(y + round_T(x · D)) with D.
// The products accumulate in f32, as the TPU kernel's (preferred_element_type
// f32); every rounding point above is the TPU kernel's, the carried state's
// included. The plain version is `ops/ssd.ssd_pallas_torch`.
//
// Design. The TPU kernel walks the chunks of one sequence in a sequential
// (batch, chunk group) grid with the state in VMEM, which would give 8 CTAs
// on 132 SMs at the prod shape. K11 takes K7's chunked plan (ssd_fwd.cu)
// with the TPU kernel's rounding points instead: (batch, chunk, head) work
// items and a short elementwise pass that carries the state, rounded to T
// after every chunk, from chunk to chunk. Four launches:
//   1. cum (chunk, batch): one thread per head.
//   2. chunk state (head, chunk, batch): S = sum_j B_j ⊗ v_j [n, p] from a
//      zero state -> f32 states [B, nc, h, n, p].
//   3. state pass (element, head, batch): overwrites each S with the state
//      entering its chunk.
//   4. chunk output (head, chunk, batch): the intra-chunk product, the
//      readout of the entering state and the D skip -> y in T.
// Launches 2 and 4 stage their chunk in shared memory (4 at prod: 163 KB,
// one CTA per SM) and register-block 4 x 4 outputs per thread, as K7's.
//
// What bounds it on the H100: at the prod shape (B 8, L 16,384, h 16, p 64,
// n 64, q 128, bf16) the function reads x, dt, B, C and writes y (575 MB:
// 0.17 ms at 3.35 TB/s) against ~71 GFLOP (0.07 ms at the bf16 tensor-core
// peak): memory. This plan runs its products as scalar f32 FMAs (~1 ms at
// the 67 TFLOP/s f32 peak), recomputes C·B^T per head and moves the f32
// states twice; tensor cores are later work.

#include "ssd_chain.cuh"

namespace {

struct ScanDims {
  int B, L, h, p, n, q, nc;
};

// ---- 1. cum -----------------------------------------------------------------------
__global__ void __launch_bounds__(32) scan_cum_kernel(const float* __restrict__ dt,
                                                      const float* __restrict__ A,
                                                      float* __restrict__ cum, ScanDims d,
                                                      int round_dA) {
  const long row0 = (long)blockIdx.y * d.L + (long)blockIdx.x * d.q;
  for (int hh = threadIdx.x; hh < d.h; hh += blockDim.x) {
    const float a = A[hh];
    float run = 0.f;
    for (int t = 0; t < d.q; ++t) {
      float v = __fmul_rn(dt[(row0 + t) * d.h + hh], a);
      if (round_dA) v = round_to<bf16>(v);
      run = __fadd_rn(run, v);
      cum[(row0 + t) * d.h + hh] = run;
    }
  }
}

// ---- 2. chunk state ---------------------------------------------------------------
size_t scan_state_smem_floats(int q, int n, int p) {
  return (size_t)q * n + (size_t)q * p + 2 * (size_t)q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_chunk_state_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Bm,
    const float* __restrict__ cum, float* __restrict__ states, ScanDims d) {
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int q = d.q, n = d.n, p = d.p;
  const long row0 = (long)b * d.L + (long)c * q;
  extern __shared__ __align__(16) float smem[];
  float* s_b = smem;            // [q][n]  B_j
  float* s_v = s_b + q * n;     // [q][p]  round_T(xdt_j · round_T(exp(cum_last − cum_j)))
  float* s_dte = s_v + q * p;   // [q]     round_T(exp(cum_last − cum_j))
  float* s_dt = s_dte + q;      // [q]     round_T(dt_j)
  const float last = cum[(row0 + q - 1) * d.h + hh];
  for (int j = tid; j < q; j += kThreads) {
    s_dte[j] = round_to<T>(expf(__fsub_rn(last, cum[(row0 + j) * d.h + hh])));
    s_dt[j] = round_to<T>(dt[(row0 + j) * d.h + hh]);
  }
  for (int idx = tid; idx < q * n; idx += kThreads) s_b[idx] = to_f32(Bm[row0 * n + idx]);
  __syncthreads();
  for (int idx = tid; idx < q * p; idx += kThreads) {
    const int j = idx / p, e = idx - j * p;
    const float xv = to_f32(x[((row0 + j) * d.h + hh) * p + e]);
    const float xdt = round_to<T>(__fmul_rn(xv, s_dt[j]));
    s_v[idx] = round_to<T>(__fmul_rn(xdt, s_dte[j]));
  }
  __syncthreads();
  float* out = states + (((long)b * d.nc + c) * d.h + hh) * n * p;
  const int pc = p / 4;
  for (int tile = tid; tile < (n / 4) * pc; tile += kThreads) {
    const int i0 = (tile / pc) * 4, e0 = (tile % pc) * 4;
    float acc[4][4] = {};
    for (int j = 0; j < q; ++j) fma4x4(acc, ld4(s_b + j * n + i0), ld4(s_v + j * p + e0));
#pragma unroll
    for (int r = 0; r < 4; ++r)
      st4(out + (i0 + r) * p + e0, acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// ---- 3. state pass ----------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) scan_state_pass_kernel(
    float* __restrict__ states, const float* __restrict__ cum, ScanDims d) {
  const int np = d.n * d.p;
  const int e = blockIdx.x * kThreads + threadIdx.x, hh = blockIdx.y, b = blockIdx.z;
  if (e >= np) return;
  float* s = states + ((long)b * d.nc * d.h + hh) * np + e;
  const float* last = cum + ((long)b * d.L + d.q - 1) * d.h + hh;
  const long cs = (long)d.h * np, cl = (long)d.q * d.h;
  float st = 0.f;
  // loads of kBatch chunks first, then the chain: only st is carried
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
      st = round_to<T>(__fadd_rn(__fmul_rn(a[i], st), inc[i]));
    }
  }
}

// ---- 4. chunk output --------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) scan_chunk_output_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ cum, const float* __restrict__ states,
    const float* __restrict__ Dr, T* __restrict__ y, ScanDims d) {
  const int hh = blockIdx.x, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int q = d.q, n = d.n, p = d.p, ldq = q + 4;
  const long row0 = (long)b * d.L + (long)c * q;
  extern __shared__ __align__(16) float smem[];
  float* s_ct = smem;                                   // [n][q+4]  C^T
  float* s_bt = s_ct + (size_t)n * ldq;                 // [n][q+4]  B^T, then st [n][p]
  const size_t bt = (size_t)n * ldq > (size_t)n * p ? (size_t)n * ldq : (size_t)n * p;
  float* s_mt = s_bt + bt;                              // [q(j)][q(t)]  M^T
  float* s_x = s_mt + (size_t)q * q;                    // [q][p]  xdt
  float* s_cum = s_x + (size_t)q * p;                   // [q]
  float* s_dt = s_cum + q;                              // [q]  round_T(dt)

  for (int j = tid; j < q; j += kThreads) {
    s_cum[j] = cum[(row0 + j) * d.h + hh];
    s_dt[j] = round_to<T>(dt[(row0 + j) * d.h + hh]);
  }
  // B^T and C^T: a thread reads 4 tokens of one channel, stores 16 bytes
  for (int idx = tid; idx < 2 * n * (q / 4); idx += kThreads) {
    const int which = idx / (n * (q / 4)), rest = idx - which * n * (q / 4);
    const int i = rest % n, t0 = (rest / n) * 4;
    const T* src = (which ? Cm : Bm) + (row0 + t0) * n + i;
    st4((which ? s_ct : s_bt) + i * ldq + t0, to_f32(src[0]), to_f32(src[n]),
        to_f32(src[2 * n]), to_f32(src[3 * n]));
  }
  __syncthreads();
  for (int idx = tid; idx < q * p; idx += kThreads) {
    const int j = idx / p, e = idx - j * p;
    s_x[idx] = round_to<T>(__fmul_rn(to_f32(x[((row0 + j) * d.h + hh) * p + e]), s_dt[j]));
  }

  // M^T[j][t] = round_T(round_T(C_t . B_j) round_T(exp(cum_t − cum_j))) for
  // j <= t, else 0; consecutive threads take consecutive row tiles t
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
        o[r] = j <= t ? round_to<T>(__fmul_rn(round_to<T>(acc[r][s]),
                                              round_to<T>(expf(__fsub_rn(s_cum[t], s_cum[j])))))
                      : 0.f;
      }
      st4(s_mt + j * q + t0, o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();
  // the state entering this chunk replaces B^T
  const float* st_src = states + (((long)b * d.nc + c) * d.h + hh) * n * p;
  for (int idx = tid; idx < n * p / 4; idx += kThreads)
    reinterpret_cast<float4*>(s_bt)[idx] = reinterpret_cast<const float4*>(st_src)[idx];
  __syncthreads();

  const float Dh = Dr == nullptr ? 0.f : Dr[hh];
  const int pc = p / 4;
  for (int tile = tid; tile < tq * pc; tile += kThreads) {
    const int t0 = (tile / pc) * 4, e0 = (tile % pc) * 4;
    float intra[4][4] = {}, rd[4][4] = {};
    for (int k = 0; k < n; ++k) fma4x4(rd, ld4(s_ct + k * ldq + t0), ld4(s_bt + k * p + e0));
    const int jend = min(q, t0 + 4);
    for (int j = 0; j < jend; ++j) fma4x4(intra, ld4(s_mt + j * q + t0), ld4(s_x + j * p + e0));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float decay = expf(s_cum[t0 + r]);
      const long off = ((row0 + t0 + r) * d.h + hh) * p + e0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float v = round_to<T>(__fadd_rn(intra[r][s], __fmul_rn(decay, rd[r][s])));
        if (Dr != nullptr)
          v = round_to<T>(__fadd_rn(v, round_to<T>(__fmul_rn(to_f32(x[off + s]), Dh))));
        y[off + s] = from_f32<T>(v);
      }
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* Dr, float* cum, float* states, void* y, ScanDims d, int round_dA,
           cudaStream_t s) {
  const size_t state_smem = scan_state_smem_floats(d.q, d.n, d.p) * sizeof(float);
  const size_t out_smem = output_smem_floats(d.q, d.n, d.p) * sizeof(float);
  if (state_smem > kMaxSmem || out_smem > kMaxSmem || d.B <= 0 || d.nc <= 0 || d.q % 4 ||
      d.n % 4 || d.p % 4 || d.nc > 65535 || d.B > 65535)
    return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  cudaError_t err;

  scan_cum_kernel<<<dim3(d.nc, d.B), 32, 0, s>>>(dt, A, cum, d, round_dA);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = set_smem(scan_chunk_state_kernel<T>, state_smem)) != cudaSuccess) return (int)err;
  scan_chunk_state_kernel<T><<<dim3(d.h, d.nc, d.B), kThreads, state_smem, s>>>(
      xt, dt, bt, cum, states, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  scan_state_pass_kernel<T><<<dim3((d.n * d.p + kThreads - 1) / kThreads, d.h, d.B), kThreads,
                              0, s>>>(states, cum, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = set_smem(scan_chunk_output_kernel<T>, out_smem)) != cudaSuccess) return (int)err;
  scan_chunk_output_kernel<T><<<dim3(d.h, d.nc, d.B), kThreads, out_smem, s>>>(
      xt, dt, bt, static_cast<const T*>(Cm), cum, states, Dr, static_cast<T*>(y), d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, L, h, p] (bf16 or f32), B, C [B, L, 1, n] in x's dtype; f32 dt
// [B, L, h], A [h] and D [h] (nullable); f32 scratch cum [B, L, h] and
// states [B, L/q, h, n, p]; y [B, L, h, p] in x's dtype. round_dA: dt·A is
// formed in bf16.
int pht_ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                     const void* Cm, const void* D, void* cum, void* states, void* y, int B,
                     int L, int h, int p, int n, int q, int round_dA, int is_bf16,
                     void* stream) {
  if (q <= 0 || L % q) return (int)cudaErrorInvalidValue;
  ScanDims d;
  d.B = B; d.L = L; d.h = h; d.p = p; d.n = n; d.q = q; d.nc = L / q;
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  const float* Dp = static_cast<const float*>(D);
  float* cp = static_cast<float*>(cum);
  float* sp = static_cast<float*>(states);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(x, dtp, Ap, Bm, Cm, Dp, cp, sp, y, d, round_dA, s);
  return launch<float>(x, dtp, Ap, Bm, Cm, Dp, cp, sp, y, d, round_dA, s);
}

}  // extern "C"
