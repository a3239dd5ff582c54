// TransformerBlock forward GEMMs: the general (WMMA) bodies of kernels K2 and
// K3 of the PyTorch port, for the widths 8 does not divide or operands that
// are not 16-byte aligned; the Hopper bodies (pointwise_sm90.cu,
// conv3x3_sm90.cu, on sm90_body.cuh) take the rest (ops/block_cuda.py's gates).
//
// Replace the matrix products of the TPU whole-block kernel `_block_kernel`
// in pixel_heal_thyself_tpu/ops/block_mega.py:413 (launched by `_mega_fwd`,
// :586, pallas_call at :627). With K1 (attention_fwd.cu) they make the
// block: ops/block_cuda.py chains K2 (n_aux, then k, v, q), K1 with the
// first residual fused, K3, and K3 with the second residual fused.
//
// K2 `pht_pointwise_gemm`: out = epi(A1 . W1 [+ A2 . W2]), the 1x1 maps.
//   A [M, K] bf16 row-major (NHWC pixels x channels), W [K, N] bf16.
//   n_aux passes [x; a] as two operands against the two halves of Wcat, so
//   the concat never exists in memory (block_mega.py:473).
// K3 `pht_conv3x3`: out = epi(conv3x3(pad(x)) . W), an implicit GEMM over
//   NHWC with K = 9 C taps ordered (ky, kx, c) to match W = HWIO reshaped
//   to [9 C, N]. Reflect, replicate and zero padding are index arithmetic
//   at the frame edges (reflect maps row -1 to row 1, replicate to row 0:
//   block_mega.py:151-171, :271-282); no padded copy is made.
// Epilogue, in the order of block_mega.py:473-475 and _conv3x3_stripe
//   (:206-233): round the f32 sum to bf16 once; add the bf16 bias (rounded);
//   ReLU; then for K3 optionally out = round(residual + out).
// Training extras: K2 takes an optional bf16 `pre_res` added to the f32
//   sum before its single rounding (the backward's dx = round(dx1 + dv.Wv^T
//   + dz.Wcat[:C]^T), block_mega.py:931-935); K3 optionally also writes
//   f2 = relu(...) before the residual, whose > 0 mask is the backward's
//   conv2 ReLU mask (the TPU kernel's `m2`, block_mega.py:548-556).
//
// What bounds it on the H100: tensor-core throughput. At prod (M = 8 x
// 128 x 128 pixels, C = 256) a 1x1 map is 17 GFLOP against 64 MB of
// operands and a 3x3 conv 155 GFLOP, far above the card's ~295 FLOP/byte
// ridge. The design tiles 128 x 128 outputs per CTA over 32-deep K steps
// staged in shared memory, and each of 8 warps runs bf16 WMMA (mma.sync)
// 16x16x16 products with f32 accumulators. Loads are 16-byte vectors when
// the widths allow and element-wise with bounds checks otherwise; no copy
// pipeline (the Hopper bodies have TMA, an mbarrier ring and wgmma).

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using namespace pht;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int A_LD = BK + 8;   // smem row pitches (bf16), multiples of 8
constexpr int B_LD = BN + 8;

struct Params {
  const bf16* a1; const bf16* w1; int k1;  // operand 1 (conv: the image)
  const bf16* a2; const bf16* w2; int k2;  // operand 2 (K2 only, may be null)
  const bf16* bias;                        // [N] or null
  const bf16* pre_res;                     // [M, N] or null, added before rounding
  const bf16* res;                         // [M, N] or null, added after ReLU
  bf16* out;                               // [M, N]
  bf16* out2;                              // [M, N] or null: out before `res`
  int relu;
  int M, N;
  int H, W, C, pad_mode;                   // conv geometry (K3)
};

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// Address of im2col element (pixel m, tap-channel kk) of the conv input,
// or null for a zero-padding tap. m < M and kk < 9 C are the caller's.
__device__ __forceinline__ const bf16* conv_src(const Params& p, int m, int kk) {
  const int tap = kk / p.C, ci = kk - tap * p.C;
  int x = m % p.W;
  const int t = m / p.W;
  int y = t % p.H;
  const int b = t / p.H;
  y += tap / 3 - 1;
  x += tap % 3 - 1;
  if (!pad_index(y, p.H, p.pad_mode) || !pad_index(x, p.W, p.pad_mode)) return nullptr;
  return p.a1 + (((int64_t)b * p.H + y) * p.W + x) * p.C + ci;
}

// 8 consecutive K elements of A row m starting at kk, into shared memory.
template <bool CONV>
__device__ __forceinline__ void load_a8(bf16* dst, const Params& p, const bf16* a,
                                        int K, int m, int kk, bool vec) {
  const bf16 zero = __float2bfloat16(0.f);
  if (m < p.M && kk + 8 <= K && vec) {
    const bf16* src = CONV ? conv_src(p, m, kk) : a + (int64_t)m * K + kk;
    if (src) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    bf16 val = zero;
    if (m < p.M && kk + e < K) {
      const bf16* src = CONV ? conv_src(p, m, kk + e) : a + (int64_t)m * K + kk + e;
      if (src) val = *src;
    }
    dst[e] = val;
  }
}

__device__ __forceinline__ void load_b8(bf16* dst, const bf16* w, int K, int N,
                                        int k, int n, bool vec) {
  if (k < K && n + 8 <= N && vec) {
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(w + (int64_t)k * N + n);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = (k < K && n + e < N) ? w[(int64_t)k * N + n + e] : __float2bfloat16(0.f);
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// acc += A[m0:m0+BM, :K] . W[:K, n0:n0+BN] for one operand pair.
template <bool CONV>
__device__ void accumulate(Acc (&acc)[2][4], const Params& p, const bf16* a,
                           const bf16* w, int K, int m0, int n0, bf16* As, bf16* Bs) {
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const bool vec_a = (CONV ? p.C % 8 == 0 : K % 8 == 0) && aligned16(a);
  const bool vec_b = p.N % 8 == 0 && aligned16(w);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int c = tid; c < BM * BK / 8; c += kThreads) {
      const int r = c / (BK / 8), c8 = (c % (BK / 8)) * 8;
      load_a8<CONV>(As + r * A_LD + c8, p, a, K, m0 + r, k0 + c8, vec_a);
    }
    for (int c = tid; c < BK * BN / 8; c += kThreads) {
      const int r = c / (BN / 8), c8 = (c % (BN / 8)) * 8;
      load_b8(Bs + r * B_LD + c8, w, K, p.N, k0 + r, n0 + c8, vec_b);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + wn * 64 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The epilogue of output (m, n): returns the output, and the value before
// the residual in `pre` (K3's f2).
__device__ __forceinline__ bf16 epilogue(const Params& p, float acc, int m, int n, bf16& pre) {
  const int64_t off = (int64_t)m * p.N + n;
  if (p.pre_res) acc += bf(p.pre_res[off]);
  bf16 y = __float2bfloat16(acc);
  if (p.bias) y = __float2bfloat16(bf(y) + bf(p.bias[n]));
  if (p.relu) y = __float2bfloat16(fmaxf(bf(y), 0.f));
  pre = y;
  if (p.res) y = __float2bfloat16(bf(p.res[off]) + bf(y));
  return y;
}

template <bool CONV>
__global__ void __launch_bounds__(kThreads) gemm_bf16_kernel(Params p) {
  __shared__ __align__(128) bf16 As[BM * A_LD];
  __shared__ __align__(128) bf16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * 16];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;

  Acc acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  accumulate<CONV>(acc, p, p.a1, p.w1, p.k1, m0, n0, As, Bs);
  if (!CONV && p.a2 != nullptr) accumulate<false>(acc, p, p.a2, p.w2, p.k2, m0, n0, As, Bs);

  // epilogue: each warp stages one 16x16 f32 tile at a time; a lane owns
  // 8 consecutive columns of one row
  float* cs = Cs[warp];
  const int r = lane / 2, cb = (lane % 2) * 8;
  const bool vec_out = p.N % 8 == 0 && aligned16(p.out) && (!p.res || aligned16(p.res)) &&
                       (!p.out2 || aligned16(p.out2));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * 64 + j * 16 + cb;
      if (m < p.M) {
        const int64_t off = (int64_t)m * p.N + n;
        if (vec_out && n + 8 <= p.N) {
          __align__(16) bf16 y[8];
          __align__(16) bf16 pre[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] = epilogue(p, cs[r * 16 + cb + e], m, n + e, pre[e]);
          *reinterpret_cast<uint4*>(p.out + off) = *reinterpret_cast<const uint4*>(y);
          if (p.out2) *reinterpret_cast<uint4*>(p.out2 + off) = *reinterpret_cast<const uint4*>(pre);
        } else {
          for (int e = 0; e < 8 && n + e < p.N; ++e) {
            bf16 pre;
            p.out[off + e] = epilogue(p, cs[r * 16 + cb + e], m, n + e, pre);
            if (p.out2) p.out2[off + e] = pre;
          }
        }
      }
      __syncwarp();
    }
  }
}

template <bool CONV>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.M + BM - 1) / BM), (unsigned)((p.N + BN - 1) / BN));
  gemm_bf16_kernel<CONV><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pht_pointwise_gemm(const void* a1, const void* w1, int k1, const void* a2,
                       const void* w2, int k2, const void* bias, int relu,
                       const void* pre_res, void* out, int M, int N, void* stream) {
  Params p = {};
  p.a1 = static_cast<const bf16*>(a1);
  p.w1 = static_cast<const bf16*>(w1);
  p.k1 = k1;
  p.a2 = static_cast<const bf16*>(a2);
  p.w2 = static_cast<const bf16*>(w2);
  p.k2 = k2;
  p.bias = static_cast<const bf16*>(bias);
  p.pre_res = static_cast<const bf16*>(pre_res);
  p.out = static_cast<bf16*>(out);
  p.relu = relu;
  p.M = M;
  p.N = N;
  return launch<false>(p, static_cast<cudaStream_t>(stream));
}

int pht_conv3x3(const void* x, const void* w, const void* bias, int relu,
                const void* res, void* out, void* out2, int B, int H, int W, int C,
                int N, int pad_mode, void* stream) {
  Params p = {};
  p.a1 = static_cast<const bf16*>(x);
  p.w1 = static_cast<const bf16*>(w);
  p.k1 = 9 * C;
  p.bias = static_cast<const bf16*>(bias);
  p.res = static_cast<const bf16*>(res);
  p.out = static_cast<bf16*>(out);
  p.out2 = static_cast<bf16*>(out2);
  p.relu = relu;
  p.M = B * H * W;
  p.N = N;
  p.H = H;
  p.W = W;
  p.C = C;
  p.pad_mode = pad_mode;
  return launch<true>(p, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
