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
// Two bodies. The TPU kernel walks the chunks of one sequence in a
// sequential (batch, chunk group) grid with the state in VMEM, which would
// give 8 CTAs on 132 SMs at the prod shape.
//
// The tensor-core body ("tc": bf16, `scan_tc_body` shapes; the prod shape
// B 8, L 16,384, h 16, p 64, n 64, q 128). In bf16 every operand of the
// products above is a bf16 value (C, B, the rounded scores, M, xdt, v and
// the carried state), so mma.sync m16n8k16 bf16 with f32 sums computes each
// product exactly, with the f32 sums in another order. Three launches:
//   1. cum (chunk, batch): a thread per head runs the sequential f32 adds;
//      writes cum, round_T(dt) and round_T(exp(cum_{q-1} − cum)) chunk-major
//      [B, nc, h, 3q] (25 MB at the prod shape).
//   2. chunk states and their carry (head, batch; 16 warps): one CTA walks
//      the chunks of one sequence and head, x and B arriving through a
//      5-stage cp.async ring; S = B^T·v on tensor cores, a state tile a
//      warp, the state in registers: it writes the bf16 state entering each
//      chunk, then st ← round_T(a·st + S). The f32 chunk sums never leave
//      the SM, and the old state pass is gone.
//   3. chunk outputs (chunk, batch; 8 warps, two CTAs an SM): one CTA
//      computes the scores C·B^T once, rounds them to bf16, keeps them in
//      A-fragment order and walks the heads (x, the entering state, cum and
//      dt of the next head double-buffered by cp.async); per head all
//      threads form xdt, then each warp forms M for its 16 rows in
//      registers and runs y = M·xdt + exp(cum)·(C·st) on tensor cores, the
//      D skip from the staged x.
// The chunk sums S, which feed the carried state, add each k-step of 16
// from zero with f32 adds (round to nearest; the tensor cores' own sums
// round toward zero, csrc/tf32x3.cuh); the chunk output chains its k-steps
// in the tensor cores' sums (at most 8, rounded to bf16 at once), which
// ran 7% faster within the same bound (PERF.md).
//
// The general body (fp32, other shapes): K7's chunked plan (ssd_fwd.cu)
// with the TPU kernel's rounding points: (batch, chunk, head) work items,
// scalar f32 FMAs register-blocked 4 x 4, and an elementwise pass that
// carries the state. Four launches: cum; chunk state (head, chunk, batch)
// -> f32 states [B, nc, h, n, p]; state pass (element, head, batch), which
// overwrites each S with the state entering its chunk; chunk output (head,
// chunk, batch), 163 KB of shared memory at the prod shape.
//
// What bounds K11 on the H100: at the prod shape the function reads x, dt,
// B, C and writes y (575 MB: 0.17 ms at 3.35 TB/s) against ~71 GFLOP (0.07
// ms at the bf16 tensor-core peak): memory. The tc body moves x twice, the
// bf16 states twice (134 MB each way) and y once (0.26 ms at 3.35 TB/s),
// but its chunk output is held back by its instructions (the exps of M,
// 9,216 a head and chunk, and the mma.sync chains of the last row tiles,
// bench_scan.py's variants), not by bytes.

#include "attention_tc.cuh"  // ldmatrix and mma.sync bf16
#include "ssd_chain.cuh"

#ifndef PHT_SCAN_RN
#define PHT_SCAN_RN 0
#endif
// bench_scan.py's diagnostic variants (wrong results): 1 forms the chunk
// output's M without its exps, 2 skips the mma.sync of the tc kernels
#ifndef PHT_SCAN_DIAG
#define PHT_SCAN_DIAG 0
#endif

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

// the kernel's dynamic shared memory, with the SM's carveout at its most
// shared memory, so that the CTAs its launch bounds ask for fit an SM
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
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

// ---- the tensor-core body (bf16) --------------------------------------------------
constexpr int kTcSkew = 8;       // bf16 elements appended to every shared row (16 bytes)
constexpr int kRing = 5;         // stages of the chunk-state kernel's cp.async ring
constexpr int kStateWarps = 16;  // one a state tile
constexpr int kOutWarps = 8;     // one a row tile of the chunk

// Shapes the tc body takes (bf16): chunk q, d_state n and headdim p
// multiples of 16 up to 128, 64 and 64. The warp tilings below assume
// these bounds (at most 8 row tiles of 16, 4 column pairs of 16 and 16
// state tiles), and every CTA's staging then fits its shared memory.
__host__ __device__ inline bool scan_tc_body(int q, int n, int p) {
  return q % 16 == 0 && q >= 16 && q <= 128 && n % 16 == 0 && n >= 16 && n <= 64 &&
         p % 16 == 0 && p >= 16 && p <= 64;
}

// dynamic shared memory (bytes) of the cum, chunk-state and chunk-output kernels
__host__ __device__ inline size_t scan_cum_tc_bytes(int q, int h) {
  return 4 * (4 * (size_t)q + 1) * h;
}
__host__ __device__ inline size_t scan_state_tc_bytes(int q, int n, int p) {
  return kRing * (2 * (size_t)q * (p + kTcSkew) + 2 * (size_t)q * (n + kTcSkew) + 12 * (size_t)q);
}
__host__ __device__ inline size_t scan_output_tc_bytes(int q, int n, int p) {
  const size_t ln = n + kTcSkew, lp = p + kTcSkew, mts = q / 16;
  return 2 * ((size_t)q * ln + (size_t)q * (ln > lp ? ln : lp) + 2 * (size_t)q * lp +
              2 * (size_t)n * lp) +
         mts * (mts + 1) / 2 * 512 + 16 * (size_t)q;
}

// acc += a . b with the k-step summed from zero and added with an f32 add,
// which rounds to nearest (the tensor cores' own sums round toward zero,
// csrc/tf32x3.cuh): the chunk sums S, which feed the carried state
__device__ __forceinline__ void mma_rn(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
#if PHT_SCAN_DIAG == 2
  asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  acc[0] += __uint_as_float(b0);
#else
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  attn::mma(d, a, b0, b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
#endif
}

// acc += a . b chained in the tensor core's sum: the chunk output's
// products, at most 8 k-steps of 16 rounded to bf16 at once (PHT_SCAN_RN,
// bench_scan.py's variant: as mma_rn)
__device__ __forceinline__ void mma_out(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
#if PHT_SCAN_DIAG == 2 || PHT_SCAN_RN
  mma_rn(acc, a, b0, b1);
#else
  attn::mma(acc, a, b0, b1);
#endif
}

__device__ __forceinline__ float bf(float x) { return round_to<bf16>(x); }

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// 8 bf16 of a 16-byte word, as floats
__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = unpack2(u[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(attn::pack(f[0], f[1]), attn::pack(f[2], f[3]), attn::pack(f[4], f[5]),
                    attn::pack(f[6], f[7]));
}

// The (row, 8-element group) pairs idx = tid, tid + blockDim.x, ... <
// rows * groups of a [rows][groups * 8] bf16 block, kept incrementally (no
// division by the run-time row width in the loop): f(row, group).
template <typename F>
__device__ __forceinline__ void for_groups(int rows, int groups, F f) {
  const int step_r = blockDim.x / groups, step_c = blockDim.x - step_r * groups;
  int r = threadIdx.x / groups, ch = threadIdx.x - r * groups;
  while (r < rows) {
    f(r, ch);
    r += step_r;
    ch += step_c;
    if (ch >= groups) {
      ch -= groups;
      ++r;
    }
  }
}

// cp.async copies (not committed) of a [rows][cols] bf16 block from rows
// `lds` elements apart into rows `ldd` apart (cols a multiple of 8)
__device__ __forceinline__ void stage_rows(bf16* dst, int ldd, const bf16* src, long lds,
                                           int rows, int cols) {
  for_groups(rows, cols / 8, [&](int r, int ch) {
    sm90::cp_async16(sm90::smem_u32(dst + (size_t)r * ldd + 8 * ch), src + r * lds + 8 * ch, true);
  });
}

// cp.async copies (not committed) of n f32 (a multiple of 4)
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
    sm90::cp_async16(sm90::smem_u32(dst + 4 * i), src + 4 * i, true);
}

// ---- tc 1. cum, round_T(dt) and the decay to the chunk's end, chunk-major ---------
// vec[((b nc + c) h + hh) 3q + i q + t]: i = 0 cum_t, 1 round_T(dt_t), 2
// round_T(exp(cum_{q-1} − cum_t)). One CTA per (chunk, batch) copies the
// chunk's dt [q][h] (contiguous) into shared memory; a thread per head runs
// the sequential adds into its shared row (3q + 1 floats apart, so the
// heads' threads hit distinct banks); then all threads take the decays and
// write the chunk's [h][3q] block in order.
__global__ void __launch_bounds__(128) scan_cum_tc_kernel(const float* __restrict__ dt,
                                                          const float* __restrict__ A,
                                                          float* __restrict__ vec, ScanDims d,
                                                          int round_dA) {
  extern __shared__ __align__(16) float s_vec[];
  const int q = d.q, ld = 3 * q + 1;
  float* s_dt = s_vec + (size_t)d.h * ld;
  const long row0 = (long)blockIdx.y * d.L + (long)blockIdx.x * q;
  for (int i = threadIdx.x; i < q * d.h; i += blockDim.x) s_dt[i] = dt[row0 * d.h + i];
  __syncthreads();
  for (int hh = threadIdx.x; hh < d.h; hh += blockDim.x) {
    float* o = s_vec + (size_t)hh * ld;
    const float a = A[hh];
    float run = 0.f;
#pragma unroll 8
    for (int t = 0; t < q; ++t) {
      const float dtv = s_dt[t * d.h + hh];
      float v = __fmul_rn(dtv, a);
      if (round_dA) v = bf(v);
      run = __fadd_rn(run, v);
      o[t] = run;
      o[q + t] = bf(dtv);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d.h * q; i += blockDim.x) {
    float* o = s_vec + (size_t)(i / q) * ld;
    const int t = i % q;
    o[2 * q + t] = bf(expf(__fsub_rn(o[q - 1], o[t])));
  }
  __syncthreads();
  float* out = vec + ((long)blockIdx.y * d.nc + blockIdx.x) * d.h * 3 * q;
  for (int i = threadIdx.x; i < d.h * 3 * q; i += blockDim.x)
    out[i] = s_vec[(i / (3 * q)) * ld + i % (3 * q)];
}

// ---- tc 2. chunk states and their carry ---------------------------------------------
// One CTA per (head, batch) walks the chunks. Ring stage: x [q][p+8] | B
// [q][n+8] (bf16) | cum, round(dt), decay to the end [3q] (f32). Per chunk:
// v = round(xdt · decay) in place over x; the state's 16 x 16 tiles (at
// most 16), one a warp, as S = B^T·v over the chunk's tokens; each thread
// carries its tile's state elements in registers.
__global__ void __launch_bounds__(kStateWarps * 32, 1) scan_state_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ Bm, const float* __restrict__ vec,
    bf16* __restrict__ states, ScanDims d) {
  const int hh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5,
            lane = tid & 31;
  const int q = d.q, n = d.n, p = d.p, ldp = p + kTcSkew, ldn = n + kTcSkew;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t stage_bytes = scan_state_tc_bytes(q, n, p) / kRing;
  auto slot_x = [&](int s) { return reinterpret_cast<bf16*>(smem_raw + s * stage_bytes); };
  auto slot_b = [&](int s) { return slot_x(s) + (size_t)q * ldp; };
  auto slot_v = [&](int s) { return reinterpret_cast<float*>(slot_b(s) + (size_t)q * ldn); };
  auto issue = [&](int c) {
    const int s = c % kRing;
    const long row0 = (long)b * d.L + (long)c * q;
    stage_rows(slot_x(s), ldp, x + (row0 * d.h + hh) * p, (long)d.h * p, q, p);
    stage_rows(slot_b(s), ldn, Bm + row0 * n, n, q, n);
    stage_vec(slot_v(s), vec + (((long)b * d.nc + c) * d.h + hh) * 3 * q, 3 * q);
  };
  for (int c = 0; c < kRing - 1; ++c) {
    if (c < d.nc) issue(c);
    sm90::cp_async_commit();
  }
  const int npairs = p / 16, units = (n / 16) * npairs;
  const int g = lane >> 2, cq = lane & 3;
  const int i0 = 16 * (warp / npairs), e0 = 16 * (warp % npairs);
  float st[2][4] = {};  // the carried state of the warp's tile (values of T)
  for (int c = 0; c < d.nc; ++c) {
    sm90::cp_async_wait<kRing - 2>();
    __syncthreads();  // chunk c has arrived; everyone is done with chunk c - 1
    if (c + kRing - 1 < d.nc) issue(c + kRing - 1);
    sm90::cp_async_commit();
    bf16* sx = slot_x(c % kRing);
    const bf16* sb = slot_b(c % kRing);
    const float* sv = slot_v(c % kRing);
    for_groups(q, p / 8, [&](int j, int ch) {
      const float dtr = sv[q + j], dte = sv[2 * q + j];
      uint4* w = reinterpret_cast<uint4*>(sx + (size_t)j * ldp + 8 * ch);
      float f[8];
      unpack8(*w, f);
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = __fmul_rn(bf(__fmul_rn(f[k], dtr)), dte);
      *w = pack8(f);  // pack rounds to bf16: v
    });
    __syncthreads();
    if (warp >= units) continue;
    const float a = expf(sv[q - 1]);
    float s4[2][4] = {};
    for (int k0 = 0; k0 < q; k0 += 16) {
      uint32_t af[4], bfr[4];
      // A = B^T (B stored [token][state]): transposed 8 x 8 loads
      attn::ldsm_x4_t(af, sb + (size_t)(k0 + (lane & 7) + (lane >> 4) * 8) * ldn + i0 +
                              ((lane >> 3) & 1) * 8);
      attn::ldsm_x4_t(bfr, sx + (size_t)(k0 + (lane & 15)) * ldp + e0 + (lane >> 4) * 8);
      mma_rn(s4[0], af, bfr[0], bfr[1]);
      mma_rn(s4[1], af, bfr[2], bfr[3]);
    }
    bf16* out = states + (((long)b * d.nc + c) * d.h + hh) * n * p;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = i0 + g + (e ? 8 : 0), col = e0 + 8 * nt + 2 * cq;
        // the state entering chunk c, then the carry (values of T: pack is exact)
        *reinterpret_cast<uint32_t*>(out + (size_t)i * p + col) =
            attn::pack(st[nt][e], st[nt][e + 1]);
        st[nt][e] = bf(__fadd_rn(__fmul_rn(a, st[nt][e]), s4[nt][e]));
        st[nt][e + 1] = bf(__fadd_rn(__fmul_rn(a, st[nt][e + 1]), s4[nt][e + 1]));
      }
    }
  }
}

// ---- tc 3. chunk outputs ----------------------------------------------------------
// One CTA per (chunk, batch) walks the heads; warp w owns row tile w (16
// tokens) and all p columns. Layout (bf16 rows skewed by 8): C [q][n+8] |
// xdt [q][p+8] (first B [q][n+8]; the larger of the two) | 2 x x [q][p+8]
// | 2 x the entering state [n][p+8] | G, the rounded scores' causal 16 x
// 16 tiles in A-fragment order (tile u = (mt, kt <= mt), lane l: 16 bytes
// at 512 u + 16 l) | 2 x (cum, round(dt)) [2q] f32: 110 KB at the prod
// shape, two CTAs an SM. The C·B^T product of a tile leaves each lane
// holding the A fragment of the same tile as it stands, so G is stored and
// reloaded one 16-byte word a lane, and each warp forms the A fragments of
// M = round(G · round(exp(cum_t − cum_j))) for its own rows in registers:
// every exp once, M never stored. Warp 7 does 8 times the causal work of
// warp 0, and two CTAs an SM fill in for it. (Two other plans ran slower,
// PERF.md: the decays formed by all threads beside xdt, balanced but 18 KB
// more, one CTA an SM; each warp on a short and a long row tile with half
// the columns, balanced but every exp twice.)
__global__ void __launch_bounds__(kOutWarps * 32, 2) scan_output_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
    const float* __restrict__ vec, const bf16* __restrict__ states,
    const float* __restrict__ Dr, bf16* __restrict__ y, ScanDims d) {
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = d.q, n = d.n, p = d.p, ldn = n + kTcSkew, ldp = p + kTcSkew;
  const int mts = q / 16, npairs = p / 16;
  const long row0 = (long)b * d.L + (long)c * q;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_c = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_xdt = s_c + (size_t)q * ldn;                                   // xdt, or B
  bf16* s_x = s_xdt + (size_t)q * (ldn > ldp ? ldn : ldp);               // 2 slots
  bf16* s_st = s_x + 2 * (size_t)q * ldp;                                // 2 slots
  uint4* s_g = reinterpret_cast<uint4*>(s_st + 2 * (size_t)n * ldp);     // 32 a tile
  float* s_vec = reinterpret_cast<float*>(s_g + (size_t)mts * (mts + 1) / 2 * 32);  // 2 slots
  const long vec0 = ((long)b * d.nc + c) * d.h * 3 * q, st0 = ((long)b * d.nc + c) * d.h * n * p;

  auto stage_head = [&](int hh, int k) {
    stage_rows(s_x + (size_t)k * q * ldp, ldp, x + (row0 * d.h + hh) * p, (long)d.h * p, q, p);
    stage_rows(s_st + (size_t)k * n * ldp, ldp, states + st0 + (long)hh * n * p, p, n, p);
    stage_vec(s_vec + 2 * k * q, vec + vec0 + (long)hh * 3 * q, 2 * q);
  };
  stage_rows(s_c, ldn, Cm + row0 * n, n, q, n);
  stage_rows(s_xdt, ldn, Bm + row0 * n, n, q, n);  // B, until G is formed
  stage_head(0, 0);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, cq = lane & 3;
  // G = round(C·B^T), its causal 16 x 16 tiles, once for all heads
  for (int mt = 0, u = 0; mt < mts; ++mt) {
    for (int kt = 0; kt <= mt; ++kt, ++u) {
      if (u % kOutWarps != warp) continue;
      float g0[4] = {}, g1[4] = {};
      for (int k0 = 0; k0 < n; k0 += 16) {
        uint32_t af[4], bfr[4];
        attn::ldsm_x4(af, s_c + (size_t)(16 * mt + (lane & 15)) * ldn + k0 + (lane >> 4) * 8);
        attn::ldsm_x4(bfr, s_xdt + (size_t)(16 * kt + (lane & 7) + (lane >> 4) * 8) * ldn + k0 +
                               ((lane >> 3) & 1) * 8);
        mma_out(g0, af, bfr[0], bfr[1]);
        mma_out(g1, af, bfr[2], bfr[3]);
      }
      // D fragments of the two 8-column halves -> the A fragment, rounded
      s_g[u * 32 + lane] = make_uint4(attn::pack(g0[0], g0[1]), attn::pack(g0[2], g0[3]),
                                      attn::pack(g1[0], g1[1]), attn::pack(g1[2], g1[3]));
    }
  }
  __syncthreads();  // B is dead: the region takes xdt

  const int mt = warp, r0 = 16 * mt;
  for (int hh = 0; hh < d.h; ++hh) {
    const int k = hh & 1;
    if (hh + 1 < d.h) stage_head(hh + 1, k ^ 1);
    sm90::cp_async_commit();
    const bf16* sx = s_x + (size_t)k * q * ldp;
    const bf16* sst = s_st + (size_t)k * n * ldp;
    const float* s_cum = s_vec + 2 * k * q;
    const float* s_dt = s_cum + q;
    // xdt = round(x · round(dt))
    for_groups(q, p / 8, [&](int j, int ch) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(sx + (size_t)j * ldp + 8 * ch), f);
      const float dtr = s_dt[j];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(f[e], dtr);
      *reinterpret_cast<uint4*>(s_xdt + (size_t)j * ldp + 8 * ch) = pack8(f);
    });
    __syncthreads();  // xdt is formed

    if (mt < mts) {
      const float Dh = Dr == nullptr ? 0.f : Dr[hh];
      const float ct0 = s_cum[r0 + g], ct1 = s_cum[r0 + g + 8];
      float acc[4][2][4] = {}, rd[4][2][4] = {};
      for (int kt = 0; kt <= mt; ++kt) {  // M · xdt, causal
        // this lane's elements of M's tile (mt, kt): rows g, g + 8; columns
        // 2cq, 2cq + 1, 2cq + 8, 2cq + 9
        const uint4 gw = s_g[(mt * (mt + 1) / 2 + kt) * 32 + lane];
        const int j0 = 16 * kt + 2 * cq;
        const float cj[4] = {s_cum[j0], s_cum[j0 + 1], s_cum[j0 + 8], s_cum[j0 + 9]};
        const uint32_t gr[4] = {gw.x, gw.y, gw.z, gw.w};
        uint32_t af[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // a[r]: row g (r even) or g + 8, columns 2cq (+8 for r >= 2)
          const float2 gv = unpack2(gr[r]);
          const int t = r0 + g + (r & 1) * 8, j = j0 + (r >> 1) * 8;
          const float ct = (r & 1) ? ct1 : ct0;
#if PHT_SCAN_DIAG == 1
          const float m0 = j <= t ? gv.x : 0.f, m1 = j + 1 <= t ? gv.y : 0.f;
#else
          const float m0 = j <= t ? __fmul_rn(gv.x, bf(expf(__fsub_rn(ct, cj[(r >> 1) * 2]))))
                                  : 0.f;
          const float m1 =
              j + 1 <= t ? __fmul_rn(gv.y, bf(expf(__fsub_rn(ct, cj[(r >> 1) * 2 + 1])))) : 0.f;
#endif
          af[r] = attn::pack(m0, m1);
        }
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          if (pr >= npairs) break;
          uint32_t bfr[4];
          attn::ldsm_x4_t(bfr, s_xdt + (size_t)(16 * kt + (lane & 15)) * ldp + 16 * pr +
                                   (lane >> 4) * 8);
          mma_out(acc[pr][0], af, bfr[0], bfr[1]);
          mma_out(acc[pr][1], af, bfr[2], bfr[3]);
        }
      }
      for (int k0 = 0; k0 < n; k0 += 16) {  // C · st
        uint32_t af[4];
        attn::ldsm_x4(af, s_c + (size_t)(r0 + (lane & 15)) * ldn + k0 + (lane >> 4) * 8);
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          if (pr >= npairs) break;
          uint32_t bfr[4];
          attn::ldsm_x4_t(bfr, sst + (size_t)(k0 + (lane & 15)) * ldp + 16 * pr +
                                   (lane >> 4) * 8);
          mma_out(rd[pr][0], af, bfr[0], bfr[1]);
          mma_out(rd[pr][1], af, bfr[2], bfr[3]);
        }
      }
      // y = round(intra + exp(cum_t) · readout), then round(y + round(x · D));
      // pack makes the last rounding
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = r0 + g + (e ? 8 : 0);
        const float decay = expf(e ? ct1 : ct0);
        bf16* yt = y + ((row0 + t) * d.h + hh) * p;
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          if (pr >= npairs) break;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int col = 16 * pr + 8 * nt + 2 * cq;
            float v[2];
#pragma unroll
            for (int m = 0; m < 2; ++m)
              v[m] = __fadd_rn(acc[pr][nt][e + m], __fmul_rn(decay, rd[pr][nt][e + m]));
            if (Dr != nullptr) {
              const float2 xv =
                  unpack2(*reinterpret_cast<const uint32_t*>(sx + (size_t)t * ldp + col));
              v[0] = __fadd_rn(bf(v[0]), bf(__fmul_rn(xv.x, Dh)));
              v[1] = __fadd_rn(bf(v[1]), bf(__fmul_rn(xv.y, Dh)));
            }
            *reinterpret_cast<uint32_t*>(yt + col) = attn::pack(v[0], v[1]);
          }
        }
      }
    }
    sm90::cp_async_wait<0>();
    __syncthreads();  // the next head has arrived; this head's buffers are free
  }
}

int launch_tc(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
              const float* Dr, float* vec, void* states, void* y, ScanDims d, int round_dA,
              cudaStream_t s) {
  const size_t cum_smem = scan_cum_tc_bytes(d.q, d.h);
  const size_t state_smem = scan_state_tc_bytes(d.q, d.n, d.p);
  const size_t out_smem = scan_output_tc_bytes(d.q, d.n, d.p);
  if (!scan_tc_body(d.q, d.n, d.p) || cum_smem > kMaxSmem || state_smem > kMaxSmem ||
      out_smem > kMaxSmem || d.B <= 0 || d.nc <= 0 || d.nc > 65535 || d.B > 65535 ||
      d.h > 65535 || !aligned16(x) || !aligned16(Bm) || !aligned16(Cm) || !aligned16(y) ||
      !aligned16(vec) || !aligned16(states))
    return (int)cudaErrorInvalidValue;
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* bt = static_cast<const bf16*>(Bm);
  cudaError_t err;
  if ((err = set_smem(scan_cum_tc_kernel, cum_smem)) != cudaSuccess) return (int)err;
  scan_cum_tc_kernel<<<dim3(d.nc, d.B), 128, cum_smem, s>>>(dt, A, vec, d, round_dA);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = set_smem(scan_state_tc_kernel, state_smem)) != cudaSuccess) return (int)err;
  scan_state_tc_kernel<<<dim3(d.h, d.B), kStateWarps * 32, state_smem, s>>>(
      xt, bt, vec, static_cast<bf16*>(states), d);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = set_smem(scan_output_tc_kernel, out_smem)) != cudaSuccess) return (int)err;
  scan_output_tc_kernel<<<dim3(d.nc, d.B), kOutWarps * 32, out_smem, s>>>(
      xt, bt, static_cast<const bf16*>(Cm), vec, static_cast<const bf16*>(states), Dr,
      static_cast<bf16*>(y), d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1: the tensor-core body takes this shape (in bf16, with 16-byte aligned
// tensors); 0: the general body
int pht_ssd_scan_body(int q, int n, int p, int is_bf16) {
  return is_bf16 && scan_tc_body(q, n, p) ? 1 : 0;
}

// x [B, L, h, p] (bf16 or f32), B, C [B, L, 1, n] in x's dtype; f32 dt
// [B, L, h], A [h] and D [h] (nullable); y [B, L, h, p] in x's dtype.
// round_dA: dt·A is formed in bf16. tc: the body (pht_ssd_scan_body); its
// scratch: tc 1, f32 vec [B, L/q, h, 3q] and bf16 states [B, L/q, h, n,
// p]; tc 0, f32 cum [B, L, h] and f32 states [B, L/q, h, n, p]. A shape
// the named body does not take is refused before anything launches.
int pht_ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                     const void* Cm, const void* D, void* cum, void* states, void* y, int B,
                     int L, int h, int p, int n, int q, int round_dA, int is_bf16, int tc,
                     void* stream) {
  if (q <= 0 || L % q || (tc && !pht_ssd_scan_body(q, n, p, is_bf16)))
    return (int)cudaErrorInvalidValue;
  ScanDims d;
  d.B = B; d.L = L; d.h = h; d.p = p; d.n = n; d.q = q; d.nc = L / q;
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  const float* Dp = static_cast<const float*>(D);
  float* cp = static_cast<float*>(cum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) return launch_tc(x, dtp, Ap, Bm, Cm, Dp, cp, states, y, d, round_dA, s);
  float* sp = static_cast<float*>(states);
  if (is_bf16)
    return launch<bf16>(x, dtp, Ap, Bm, Cm, Dp, cp, sp, y, d, round_dA, s);
  return launch<float>(x, dtp, Ap, Bm, Cm, Dp, cp, sp, y, d, round_dA, s);
}

// CTAs an SM holds of the tc body's chunk-state (which 0) or chunk-output
// (which 1) kernel at this shape (the bench prints it)
int pht_ssd_scan_tc_occupancy(int which, int q, int n, int p) {
  int blocks = 0;
  const size_t bytes = which ? scan_output_tc_bytes(q, n, p) : scan_state_tc_bytes(q, n, p);
  cudaError_t err = which ? set_smem(scan_output_tc_kernel, bytes)
                          : set_smem(scan_state_tc_kernel, bytes);
  if (err == cudaSuccess)
    err = which ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &blocks, scan_output_tc_kernel, kOutWarps * 32, bytes)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &blocks, scan_state_tc_kernel, kStateWarps * 32, bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}

// dynamic shared memory (bytes) of the tc body's chunk-state (which 0) and
// chunk-output (which 1) kernels
int pht_ssd_scan_tc_smem(int which, int q, int n, int p) {
  return (int)(which ? scan_output_tc_bytes(q, n, p) : scan_state_tc_bytes(q, n, p));
}

}  // extern "C"
