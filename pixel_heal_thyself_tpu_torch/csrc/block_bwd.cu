// TransformerBlock backward GEMMs: the general (WMMA) bodies of kernels K5 and
// K6 of the PyTorch port, for the widths 8 does not divide or operands that
// are not 16-byte aligned; the Hopper bodies (dgrad_sm90.cu, wgrad_sm90.cu)
// take the rest (ops/block_cuda.py's gates). `pht_sum_splits` serves both
// K6 bodies.
//
// Replace the matrix products of the TPU whole-block backward `_bwd_kernel`
// in pixel_heal_thyself_tpu/ops/block_mega.py:662 (launched by `_mega_bwd`,
// :1006, pallas_call at :1037). With K2 (block_fwd.cu) and K4
// (attention_bwd.cu), ops/block_cuda.py chains them into the 13 block
// gradients in the TPU kernel's order: conv2 -> pad fold -> conv1 -> pad
// fold -> attention -> projections.
//
// K5 `pht_conv3x3_dgrad`: the 3x3 conv input gradient
//     d_in = round(sum_taps (dy * [gate > 0]) . W[tap]^T  [+ pre_res])
//   as an implicit GEMM over NHWC with K = 9 N taps (`_transposed_conv_
//   stripe`, block_mega.py:236). The ReLU mask (gate = the conv's own
//   output, f2 or f1, block_mega.py:812-815, :837-840) is applied in the
//   gather; dy * mask is exact in bf16. The gradient of reflect/replicate
//   padding folds the pad row/column into the interior (`_fold_pad_grads`,
//   :954-998): reflect adds pad -1 into index 1 and pad n into n-2,
//   replicate into 0 and n-1, zero padding drops it. The gather does this by
//   index arithmetic: each tap has an in-frame source and, on the fold
//   targets, a second "fold" source; a CTA runs the fold passes only when
//   its tile holds a fold target. Output tiles are 8 x 16 pixels, so only
//   the tiles on the frame's border run them. All taps and folds sum in f32
//   and round once (the TPU kernel rounds per stripe and per fold in bf16).
// K6 `pht_weight_grad`: the pixel contraction
//     dW[tap*Cin + c, n] = sum_pixels shift_tap(x)[p, c] * (dy * [gate > 0])[p, n]
//   in f32, with optional column sums db[n] = sum_p dy*mask (`contract_px`,
//   block_mega.py:724-730, and the db sums at :816, :841, :928). With 9 taps
//   and the K3 padding modes it is the conv weight gradient; with 1 tap it
//   is every 1x1 gradient (two operands stack along the rows for
//   dWcat = [x; a]^T . dz). K = 131,072 pixels at prod: the pixels are
//   split across CTAs, each writes an f32 partial, and `pht_sum_splits`
//   adds the partials in a fixed order: deterministic, no float atomics.
//
// What bounds them on the H100: tensor-core throughput, as K3 (a prod conv
// gradient is 155 GFLOP). Both reuse K3's design: 128 x 128 output tiles
// per CTA over 32-deep K steps staged in shared memory, 8 warps of bf16
// WMMA 16x16x16 with f32 accumulators, 16-byte loads where widths allow.
// K6 reads x as a column-major A operand (pixels are its K dimension), so
// no transposed copy is made. No copy pipeline (the Hopper bodies have TMA,
// an mbarrier ring and wgmma).

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;
using namespace pht;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int A_LD = BK + 8;   // K5: A [BM][BK] row-major
constexpr int AT_LD = BM + 8;  // K6: A [BK][BM] (column-major operand)
constexpr int B_LD = BN + 8;
constexpr int TH = 8, TW = 16;  // K5 output tile: 8 rows x 16 columns

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// 8 values of dy * [gate > 0] at element offset `off` (gate may be null)
__device__ __forceinline__ void load_gated8(bf16* dst, const bf16* dy, const bf16* gate,
                                            int64_t off, bool vec) {
  const bf16 zero = __float2bfloat16(0.f);
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(dy + off);
    if (gate) {
      __align__(16) bf16 gv[8];
      *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(gate + off);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (!(bf(gv[e]) > 0.f)) dst[e] = zero;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = (!gate || bf(gate[off + e]) > 0.f) ? dy[off + e] : zero;
}

__device__ __forceinline__ void zero8(bf16* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}

// acc[2][4] += As (row- or column-major per LAYOUT) . Bs over one BK step
template <typename LAYOUT>
__device__ __forceinline__ void mma_step(Acc (&acc)[2][4], const bf16* As, const bf16* Bs) {
  const int warp = threadIdx.x / 32;
  const int wm = warp % 4, wn = warp / 4;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LAYOUT> fa[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = wm * 32 + i * 16;
      if constexpr (std::is_same<LAYOUT, wmma::row_major>::value)
        wmma::load_matrix_sync(fa[i], As + m * A_LD + kk, A_LD);
      else
        wmma::load_matrix_sync(fa[i], As + kk * AT_LD + m, AT_LD);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + wn * 64 + j * 16, B_LD);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// Hand each output (row r of the CTA tile, column n) with its f32 sum to
// `store(r, n, value)`, one 16 x 16 fragment at a time through shared memory.
template <typename Store>
__device__ __forceinline__ void for_each_output(Acc (&acc)[2][4], float* cs, Store store) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int r = lane / 2, cb = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e)
        store(wm * 32 + i * 16 + r, wn * 64 + j * 16 + cb + e, cs[r * 16 + cb + e]);
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------- K5 -------

struct DgradParams {
  const bf16* dy;       // [B, H, W, N] gradient of the conv output
  const bf16* gate;     // [B, H, W, N] or null: dy counts where gate > 0
  const bf16* wt;       // [9 N, C] per-tap transposed weights, tap-major
  const bf16* pre_res;  // [B, H, W, C] or null, added before rounding
  bf16* out;            // [B, H, W, C]
  int B, H, W, N, C, pad_mode;
};

// The output coordinate whose tap `k` (0..2) reads input coordinate p, for
// the in-frame source (fold = 0) or the padding folded onto p (fold = 1);
// -1 if none.
__device__ __forceinline__ int dgrad_src(int p, int k, int n, int fold, int mode) {
  if (!fold) {
    const int o = p - k + 1;
    return (o >= 0 && o < n) ? o : -1;
  }
  if (mode == kZeros || k == 1) return -1;
  if (k == 0) return p == (mode == kReflect ? 1 : 0) ? 0 : -1;
  return p == (mode == kReflect ? n - 2 : n - 1) ? n - 1 : -1;
}

// whether some coordinate of [p0, p0 + len) ∩ [0, n) has a source
__device__ __forceinline__ bool any_src(int p0, int len, int k, int n, int fold, int mode) {
  for (int p = p0; p < min(p0 + len, n); ++p)
    if (dgrad_src(p, k, n, fold, mode) >= 0) return true;
  return false;
}

__global__ void __launch_bounds__(kThreads) conv3x3_dgrad_kernel(DgradParams p) {
  __shared__ __align__(128) bf16 As[BM * A_LD];
  __shared__ __align__(128) bf16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * 16];

  const int tiles_x = (p.W + TW - 1) / TW, tiles_y = (p.H + TH - 1) / TH;
  int t = blockIdx.x;
  const int tx = t % tiles_x;
  t /= tiles_x;
  const int ty = t % tiles_y;
  const int b = t / tiles_y;
  const int y0 = ty * TH, x0 = tx * TW;
  const int n0 = blockIdx.y * BN;  // output channel tile
  const int tid = threadIdx.x;
  const bool vec_a = p.N % 8 == 0 && aligned16(p.dy) && (!p.gate || aligned16(p.gate));
  const bool vec_b = p.C % 8 == 0 && aligned16(p.wt);

  Acc acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int pass = 0; pass < 36; ++pass) {
    const int tap = pass % 9, fy = (pass / 9) % 2, fx = pass / 18;
    const int ky = tap / 3, kx = tap % 3;
    if (!any_src(y0, TH, ky, p.H, fy, p.pad_mode) || !any_src(x0, TW, kx, p.W, fx, p.pad_mode))
      continue;  // uniform across the CTA
    for (int k0 = 0; k0 < p.N; k0 += BK) {
      for (int c = tid; c < BM * BK / 8; c += kThreads) {
        const int r = c / (BK / 8), c8 = (c % (BK / 8)) * 8;
        bf16* dst = As + r * A_LD + c8;
        const int y = y0 + r / TW, x = x0 + r % TW;
        const int sy = y < p.H ? dgrad_src(y, ky, p.H, fy, p.pad_mode) : -1;
        const int sx = x < p.W ? dgrad_src(x, kx, p.W, fx, p.pad_mode) : -1;
        const int kk = k0 + c8;
        if (sy < 0 || sx < 0 || kk >= p.N) {
          zero8(dst);
          continue;
        }
        const int64_t off = (((int64_t)b * p.H + sy) * p.W + sx) * p.N + kk;
        if (kk + 8 <= p.N) {
          load_gated8(dst, p.dy, p.gate, off, vec_a);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (kk + e < p.N && (!p.gate || bf(p.gate[off + e]) > 0.f))
                         ? p.dy[off + e] : __float2bfloat16(0.f);
        }
      }
      for (int c = tid; c < BK * BN / 8; c += kThreads) {
        const int r = c / (BN / 8), c8 = (c % (BN / 8)) * 8;
        const int kr = k0 + r, n = n0 + c8;
        bf16* dst = Bs + r * B_LD + c8;
        const bf16* src = p.wt + ((int64_t)tap * p.N + kr) * p.C + n;
        if (kr < p.N && n + 8 <= p.C && vec_b) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (kr < p.N && n + e < p.C) ? src[e] : __float2bfloat16(0.f);
        }
      }
      __syncthreads();
      mma_step<wmma::row_major>(acc, As, Bs);
      __syncthreads();
    }
  }

  for_each_output(acc, Cs[tid / 32], [&](int r, int n, float v) {
    const int y = y0 + r / TW, x = x0 + r % TW;
    const int ch = n0 + n;
    if (y >= p.H || x >= p.W || ch >= p.C) return;
    const int64_t off = (((int64_t)b * p.H + y) * p.W + x) * p.C + ch;
    if (p.pre_res) v += bf(p.pre_res[off]);
    p.out[off] = __float2bfloat16(v);
  });
}

// ---------------------------------------------------------------- K6 -------

struct WgradParams {
  const bf16* a1;    // [P, C1] (NHWC pixels), shifted per tap
  const bf16* a2;    // [P, C2] or null (taps == 1): rows C1.. of dW
  const bf16* dy;    // [P, N]
  const bf16* gate;  // [P, N] or null
  float* part;       // [splits][len] f32 partials: dW [M][N], then db [N]
  int B, H, W, C1, C2, N, taps, pad_mode, pix_per_split, colsum;
  int M;             // taps * C1 + C2
  int64_t len;       // M * N (+ N with colsum)
};

// 8 consecutive dW rows m..m+7 of pixel `pix`: the A operand's column
__device__ __forceinline__ void load_wgrad_a8(bf16* dst, const WgradParams& p, int pix, int m,
                                              bool vec) {
  const bf16 zero = __float2bfloat16(0.f);
  const int P = p.B * p.H * p.W;
  const int k1 = p.taps * p.C1;
  if (pix >= P || m >= p.M) {
    zero8(dst);
    return;
  }
  int x = pix % p.W;
  const int t = pix / p.W;
  int y = t % p.H;
  const int b = t / p.H;
  // the element source of row mm, or null for a zero-padding tap
  auto src = [&](int mm) -> const bf16* {
    if (mm >= k1) return p.a2 + (int64_t)pix * p.C2 + (mm - k1);
    const int tap = mm / p.C1, c = mm - tap * p.C1;
    if (p.taps == 1) return p.a1 + (int64_t)pix * p.C1 + c;
    int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
    if (!pad_index(yy, p.H, p.pad_mode) || !pad_index(xx, p.W, p.pad_mode)) return nullptr;
    return p.a1 + (((int64_t)b * p.H + yy) * p.W + xx) * p.C1 + c;
  };
  // vector path: all 8 rows in one operand and one tap
  if (vec && m + 8 <= p.M && (m >= k1 || (m % p.C1) + 8 <= p.C1)) {
    const bf16* s = src(m);
    if (s) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(s);
    else zero8(dst);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bf16* s = m + e < p.M ? src(m + e) : nullptr;
    dst[e] = s ? *s : zero;
  }
}

__global__ void __launch_bounds__(kThreads) weight_grad_kernel(WgradParams p) {
  __shared__ __align__(128) bf16 As[BK * AT_LD];
  __shared__ __align__(128) bf16 Bs[BK * B_LD];
  __shared__ __align__(128) float Cs[kThreads / 32][16 * 16];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int P = p.B * p.H * p.W;
  const int p0 = split * p.pix_per_split;
  const int p1 = min(P, p0 + p.pix_per_split);
  const int tid = threadIdx.x;
  const bool vec_a = p.C1 % 8 == 0 && aligned16(p.a1) &&
                     (!p.a2 || (p.C2 % 8 == 0 && aligned16(p.a2)));
  const bool vec_b = p.N % 8 == 0 && aligned16(p.dy) && (!p.gate || aligned16(p.gate));
  const bool do_colsum = p.colsum && blockIdx.x == 0;
  float colsum = 0.f;  // column n0 + tid (tid < BN)

  Acc acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = p0; k0 < p1; k0 += BK) {
    // A^T tile: [BK pixels][BM rows of dW]
    for (int c = tid; c < BK * BM / 8; c += kThreads) {
      const int r = c / (BM / 8), c8 = (c % (BM / 8)) * 8;
      const int pix = k0 + r;
      if (pix >= p1) zero8(As + r * AT_LD + c8);
      else load_wgrad_a8(As + r * AT_LD + c8, p, pix, m0 + c8, vec_a);
    }
    for (int c = tid; c < BK * BN / 8; c += kThreads) {
      const int r = c / (BN / 8), c8 = (c % (BN / 8)) * 8;
      const int pix = k0 + r, n = n0 + c8;
      bf16* dst = Bs + r * B_LD + c8;
      if (pix >= p1) {
        zero8(dst);
      } else if (n + 8 <= p.N) {
        load_gated8(dst, p.dy, p.gate, (int64_t)pix * p.N + n, vec_b);
      } else {
        const int64_t off = (int64_t)pix * p.N + n;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (n + e < p.N && (!p.gate || bf(p.gate[off + e]) > 0.f))
                       ? p.dy[off + e] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    if (do_colsum && tid < BN)
      for (int r = 0; r < BK; ++r) colsum += bf(Bs[r * B_LD + tid]);
    mma_step<wmma::col_major>(acc, As, Bs);
    __syncthreads();
  }

  float* part = p.part + (size_t)split * p.len;
  for_each_output(acc, Cs[tid / 32], [&](int r, int n, float v) {
    const int m = m0 + r, col = n0 + n;
    if (m < p.M && col < p.N) part[(size_t)m * p.N + col] = v;
  });
  if (do_colsum && tid < BN && n0 + tid < p.N) part[(size_t)p.M * p.N + n0 + tid] = colsum;
}

// out[i] = sum_s part[s * len + i], s in order
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int64_t len, int splits) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < len;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * len + i];
    out[i] = s;
  }
}

int sum_splits(const float* part, float* out, int64_t len, int splits, cudaStream_t stream) {
  const int blocks = (int)std::min<int64_t>((len + 255) / 256, 132 * 16);
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(part, out, len, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pht_conv3x3_dgrad(const void* dy, const void* gate, const void* wt, const void* pre_res,
                      void* out, int B, int H, int W, int N, int C, int pad_mode,
                      void* stream) {
  DgradParams p;
  p.dy = static_cast<const bf16*>(dy);
  p.gate = static_cast<const bf16*>(gate);
  p.wt = static_cast<const bf16*>(wt);
  p.pre_res = static_cast<const bf16*>(pre_res);
  p.out = static_cast<bf16*>(out);
  p.B = B; p.H = H; p.W = W; p.N = N; p.C = C; p.pad_mode = pad_mode;
  const int tiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  conv3x3_dgrad_kernel<<<dim3((unsigned)tiles, (unsigned)((C + BN - 1) / BN)), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// part: [splits][len] f32 scratch; out: [len] f32: dW [M][N], then db [N]
// when colsum (len = M * N (+ N)). M = taps * C1 + C2.
int pht_weight_grad(const void* a1, int C1, const void* a2, int C2, const void* dy,
                    const void* gate, void* part, void* out, int B, int H, int W, int N,
                    int taps, int pad_mode, int colsum, int splits, void* stream) {
  WgradParams p;
  p.a1 = static_cast<const bf16*>(a1);
  p.a2 = static_cast<const bf16*>(a2);
  p.dy = static_cast<const bf16*>(dy);
  p.gate = static_cast<const bf16*>(gate);
  p.part = static_cast<float*>(part);
  p.B = B; p.H = H; p.W = W; p.C1 = C1; p.C2 = a2 ? C2 : 0; p.N = N;
  p.taps = taps; p.pad_mode = pad_mode; p.colsum = colsum;
  p.M = taps * C1 + p.C2;
  p.len = (int64_t)p.M * N + (colsum ? N : 0);
  const int P = B * H * W;
  p.pix_per_split = ((P + splits - 1) / splits + BK - 1) / BK * BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((p.M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                  (unsigned)splits);
  weight_grad_kernel<<<grid, kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_splits(p.part, static_cast<float*>(out), p.len, splits, s);
}

int pht_sum_splits(const void* part, void* out, long long len, int splits, void* stream) {
  return sum_splits(static_cast<const float*>(part), static_cast<float*>(out), (int64_t)len,
                    splits, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
