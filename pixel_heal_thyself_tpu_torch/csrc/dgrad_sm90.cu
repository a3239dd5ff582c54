// K5's Hopper body `pht_conv3x3_dgrad_sm90`: the 3x3 conv input gradient
//     d_in = round(fold(sum_taps g . W[tap]^T) [+ pre_res]),  g = dy * [gate > 0]
// over NHWC, with W = the forward's [9 C, N] (tap-major) and K = 9 taps x N.
// It replaces `_transposed_conv_stripe` and `_fold_pad_grads` of TPU kernel
// #4, `_bwd_kernel` in pixel_heal_thyself_tpu/ops/block_mega.py:662 (:236,
// :954-998; `conv1_bwd` at :835 adds the `do` residual), as block_bwd.cu's
// general WMMA body does for the shapes outside ops/block_cuda.py's gate (C,
// N multiples of 8). Every tap and fold term is summed in f32 and rounded
// once, as `conv3x3_dgrad_torch` does.
//
// What bounds it on the H100: tensor-core operations (155 GFLOP at prod
// against 201 MB of operands: 0.156 ms at 989 TFLOP/s). Three launches:
// - the ReLU gate (wgrad_sm90.cu's `pht_relu_gate`, shared with K6): g = dy
//   where gate > 0, else 0, exact in bf16; TMA cannot mask;
// - for reflect and replicate padding, the fold pre-pass `dgrad_fold_kernel`
//   (below): the gradient of the padded ring lands on the lines next to the
//   frame edge (reflect: 1 and n - 2; replicate: 0 and n - 1). Its f32 terms
//   go to a side buffer indexed by line pixel: a row-line part [B][2][W][C]
//   (the top and bottom line's terms from source rows 0 and H - 1 through
//   the ky = 0 / 2 taps, with the corners' terms) and a column-line part
//   [B][H][2][C] (source columns 0 and W - 1 through kx = 0 / 2). At prod it
//   is 4 MB and about 1% of the operations, on WMMA;
// - the main passes, sm90_body.cuh's body (shared with K2 and K3): K3's
//   implicit GEMM run the other way, the tap's source pixel y + 1 - ky,
//   x + 1 - kx, only in-frame sources, so zero padding is exact: a row
//   outside the frame reads a zero row past every image and TMA fills the
//   column outside it; no edge is patched. W is read K-major through the
//   same tensor map as K3's (its n is K), so no transposed copy is made.
//   The epilogue adds pre_res and, on the fold lines, the side buffer to the
//   f32 sums before the single rounding. Frames 64 does not divide gather g
//   by cp.async with the reversed shift.

#include <mma.h>

#include "sm90_body.cuh"

extern "C" int pht_relu_gate(const void* dy, const void* gate, void* g, long long elems,
                             void* stream);

namespace {

using namespace nvcuda;
using namespace pht;
using namespace pht::sm90;
using namespace pht::sm90::body;

__global__ void __launch_bounds__(kThreads, 1) conv3x3_dgrad_sm90_kernel(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap amap,
    Params p) {
  run<Op::kDgrad>(wmap, amap, wmap, amap, p);
}

// ---- the fold pre-pass -----------------------------------------------------
//
// A small WMMA GEMM over the fold lines' pixels. blockIdx.y picks the line
// group: 0 / 1 the top / bottom row line, 2 / 3 the left / right column line;
// blockIdx.x a tile of FM of the group's B x (W or H) line pixels, blockIdx.z
// FN output channels. K walks "virtual taps" x N: a row line's pixel x takes
// the fold tap row (ky = 0 top, 2 bottom) at source row 0 / H - 1 and, for
// kx = 0..2, source column x + 1 - kx (in the frame); the corner terms are
// two more virtual taps, on the pixels of the column fold lines: source
// column 0 through kx = 0, column W - 1 through kx = 2. A column line's
// pixel y takes kx = 0 / 2 at source column 0 / W - 1 and, for ky = 0..2,
// source row y + 1 - ky. A virtual tap that no pixel of the tile uses is
// skipped.

// 128-deep K steps: 16 16-byte loads in flight per thread, few barriers
constexpr int FM = 64, FN = 64, FK = 128, FT = 128;  // line pixels, channels, K step, threads
constexpr int F_LD = FK + 8;                       // shared-memory row pitch (bf16)

__global__ void __launch_bounds__(FT) dgrad_fold_kernel(const bf16* __restrict__ g,
                                                        const bf16* __restrict__ w,
                                                        float* __restrict__ fold, int B, int H,
                                                        int W, int N, int C, int mode) {
  __shared__ __align__(128) bf16 As[FM * F_LD];  // [line pixel][k]
  __shared__ __align__(128) bf16 Bs[FN * F_LD];  // [channel][k]: a column-major B
  __shared__ __align__(128) float Cs[FT / 32][16 * 16];

  const int group = blockIdx.y;
  const bool rows = group < 2;
  const int side = group & 1;
  const int len = rows ? W : H;  // line pixels per image
  const int count = B * len;
  const int l0 = blockIdx.x * FM, c0 = blockIdx.z * FN;
  if (l0 >= count) return;
  const int kf = side ? 2 : 0;  // the fold tap's ky (row lines) or kx (column lines)
  const int src_line = side ? (rows ? H - 1 : W - 1) : 0;
  const int tx0 = fold_target(0, W, mode), tx1 = fold_target(1, W, mode);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % 2, wn = warp / 2;  // each warp 32 x 32 of the 64 x 64 tile

  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
  Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int v = 0; v < (rows ? 5 : 3); ++v) {
    if (v >= 3) {  // a corner term: only the pixels of a column fold line
      const int target = v == 3 ? tx0 : tx1;
      bool any = false;
      for (int l = l0 + tid; l < min(count, l0 + FM); l += FT) any |= l % len == target;
      if (!__syncthreads_or(any)) continue;
    }
    const int tap = rows ? 3 * kf + (v < 3 ? v : v == 3 ? 0 : 2) : 3 * v + kf;
    for (int k0 = 0; k0 < N; k0 += FK) {
#pragma unroll
      for (int c = tid; c < FM * FK / 8; c += FT) {
        const int r = c / (FK / 8), c8 = (c % (FK / 8)) * 8;
        const int l = l0 + r, b = l / len, pos = l % len;
        int sy, sx;
        if (rows) {
          sy = src_line;
          sx = v < 3 ? pos + 1 - v : v == 3 ? (pos == tx0 ? 0 : -1) : (pos == tx1 ? W - 1 : -1);
        } else {
          sx = src_line;
          sy = pos + 1 - v;
        }
        const bool ok = l < count && sy >= 0 && sy < H && sx >= 0 && sx < W && k0 + c8 < N;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (ok)
          val = *reinterpret_cast<const uint4*>(g + (((int64_t)b * H + sy) * W + sx) * N + k0 + c8);
        *reinterpret_cast<uint4*>(As + r * F_LD + c8) = val;
      }
#pragma unroll
      for (int c = tid; c < FN * FK / 8; c += FT) {
        const int r = c / (FK / 8), c8 = (c % (FK / 8)) * 8;
        const int ch = c0 + r;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (ch < C && k0 + c8 < N)
          val = *reinterpret_cast<const uint4*>(w + ((int64_t)tap * C + ch) * N + k0 + c8);
        *reinterpret_cast<uint4*>(Bs + r * F_LD + c8) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * F_LD + kk, F_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * F_LD + kk, F_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // store each 16 x 16 fragment through shared memory: a lane owns 8
  // consecutive channels of one line pixel
  float* cs = Cs[warp];
  float* cols = fold + (int64_t)2 * B * W * C;
  const int r = lane / 2, cb = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int l = l0 + wm * 32 + i * 16 + r, ch = c0 + wn * 32 + j * 16 + cb;
      if (l < count && ch < C) {
        const int b = l / len, pos = l % len;
        float* dst = rows ? fold + (((int64_t)b * 2 + side) * W + pos) * C + ch
                          : cols + (((int64_t)b * H + pos) * 2 + side) * C + ch;
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = cs[r * 16 + cb + e];
      }
      __syncwarp();
    }
  }
}

int launch_fold(const void* g, const void* w, void* fold, int B, int H, int W, int N, int C,
                int pad_mode, cudaStream_t stream) {
  const int lines = B * std::max(H, W);
  const dim3 grid((unsigned)((lines + FM - 1) / FM), 4, (unsigned)((C + FN - 1) / FN));
  dgrad_fold_kernel<<<grid, FT, 0, stream>>>(static_cast<const bf16*>(g),
                                             static_cast<const bf16*>(w),
                                             static_cast<float*>(fold), B, H, W, N, C, pad_mode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The fold pre-pass alone (K5's Hopper entry runs it; the card tests hold it
// against `dgrad_fold_torch`): g [B, H, W, N] bf16 (already gated), w [9 C,
// N] bf16, fold: 2 B (W + H) C f32. Reflect or replicate only.
int pht_conv3x3_dgrad_fold(const void* g, const void* w, void* fold, int B, int H, int W, int N,
                           int C, int pad_mode, void* stream) {
  if (pad_mode == kZeros) return (int)cudaErrorInvalidValue;
  return launch_fold(g, w, fold, B, H, W, N, C, pad_mode, static_cast<cudaStream_t>(stream));
}

// dy, gate: [B, H, W, N] bf16 (gate may be null); g: [B, H, W, N] bf16
// scratch (used when gate); w: [9 C, N] bf16, the forward's layout;
// pre_res: [B, H, W, C] or null; fold: 2 B (W + H) C f32 scratch (reflect,
// replicate; null for zeros); out: [B, H, W, C]. Needs C, N multiples of 8
// and 16-byte aligned operands (ops/block_cuda.py's gate). g comes by TMA
// when W % 64 == 0, else by the cp.async gather; the persistent grid is one
// wave, capped at the work.
int pht_conv3x3_dgrad_sm90(const void* dy, const void* gate, void* g, const void* w,
                           const void* pre_res, void* fold, void* out, int B, int H, int W,
                           int N, int C, int pad_mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t P = (int64_t)B * H * W;
  const void* src = dy;
  if (gate) {
    const int err = pht_relu_gate(dy, gate, g, (long long)(P * N), stream);
    if (err) return err;
    src = g;
  }
  if (pad_mode != kZeros) {
    if (!fold) return (int)cudaErrorInvalidValue;
    const int err = launch_fold(src, w, fold, B, H, W, N, C, pad_mode, s);
    if (err) return err;
  }
  Params p = {};
  p.x = static_cast<const bf16*>(src);
  p.a_tma = W % 64 == 0;
  p.pre_res = static_cast<const bf16*>(pre_res);
  p.fold = pad_mode != kZeros ? static_cast<const float*>(fold) : nullptr;
  p.out = static_cast<bf16*>(out);
  p.B = B; p.H = H; p.W = W; p.C = N; p.N = C; p.pad_mode = pad_mode;
  p.P = P;
  p.chunks1 = (N + BK - 1) / BK;
  CUtensorMap wmap, amap = {};
  int err0 = make_tma_2d(&wmap, w, 9 * (uint64_t)C, N);
  if (!err0 && p.a_tma) {
    const uint64_t dims[3] = {(uint64_t)N, (uint64_t)W, (uint64_t)B * H};
    err0 = make_tma(&amap, src, 3, dims);
  }
  if (err0) return err0;
  const int64_t items = (P + BM - 1) / BM * ((C + BN - 1) / BN);
  if (items == 0) return 0;
  static bool configured = false;
  const int grid = grid_of(conv3x3_dgrad_sm90_kernel, configured, items);
  if (grid < 0) return -grid;
  conv3x3_dgrad_sm90_kernel<<<grid, kThreads, SMEM, s>>>(wmap, amap, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
