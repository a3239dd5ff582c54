// K2's Hopper body `pht_pointwise_gemm_sm90`: the 1x1 maps
//     out = epi([pre_res +] a1 . W1 [+ a2 . W2])
// with a1 [M, K1], a2 [M, K2] bf16 (NHWC pixels x channels, K-major), W1
// [K1, N], W2 [K2, N] bf16, one f32 accumulator. It replaces the 1x1 maps of
// TPU kernel #3, `_block_kernel` in pixel_heal_thyself_tpu/ops/block_mega.py:413
// (`phase_b`, :469-485: n_aux as [x; a] . Wcat, then k, v, q) and the input
// gradients of the projections in TPU kernel #4 (`proj_bwd`, :907-935), as
// block_fwd.cu's general WMMA body does for the shapes outside
// ops/block_cuda.py's gate (K1, K2, N multiples of 8). Epilogue, in the order
// of block_fwd.cu's: add pre_res to the f32 sum (the backward's dx =
// round(dx1 + dv . Wv^T + dz . Wcat[:C]^T), block_mega.py:931-935), round to
// bf16 once, add the bf16 bias and round, ReLU.
//
// What bounds it on the H100: bytes. A prod map reads 64 MB of A (128 MB with
// two operands) and writes 64 MB against 17 (34) GFLOP: 0.038 (0.060) ms at
// 3.35 TB/s. The design is sm90_body.cuh's (shared with K3 and K5): a
// persistent one-wave grid of 128-row x 256-column tiles (one column tile
// at N = 256, so A is read once), the K steps running through a1/W1 and
// then a2/W2 (four tensor maps), every operand a 2-D TMA box; with only 4
// (8) K steps a tile, the stage counter that runs across tiles lets the
// producer load the next tile while the consumers store. W (32 KB a stage)
// is read again from L2 for every tile.

#include "sm90_body.cuh"

namespace {

using namespace pht;
using namespace pht::sm90;
using namespace pht::sm90::body;

__global__ void __launch_bounds__(kThreads, 1) pointwise_gemm_kernel(
    const __grid_constant__ CUtensorMap wmap1, const __grid_constant__ CUtensorMap amap1,
    const __grid_constant__ CUtensorMap wmap2, const __grid_constant__ CUtensorMap amap2,
    Params p) {
  run<Op::kPointwise>(wmap1, amap1, wmap2, amap2, p);
}

}  // namespace

extern "C" {

// Arguments as block_fwd.cu's `pht_pointwise_gemm`. Needs K1, K2, N
// multiples of 8 and 16-byte aligned tensors (ops/block_cuda.py's gate);
// every operand comes by TMA, and the persistent grid is one wave, capped at
// the work.
int pht_pointwise_gemm_sm90(const void* a1, const void* w1, int k1, const void* a2,
                            const void* w2, int k2, const void* bias, int relu,
                            const void* pre_res, void* out, int M, int N, void* stream) {
  Params p = {};
  p.a_tma = 1;
  p.bias = static_cast<const bf16*>(bias);
  p.pre_res = static_cast<const bf16*>(pre_res);
  p.out = static_cast<bf16*>(out);
  p.relu = relu;
  p.N = N;
  p.P = M;
  p.chunks1 = (k1 + BK - 1) / BK;
  p.chunks2 = a2 ? (k2 + BK - 1) / BK : 0;
  CUtensorMap wmap1, amap1, wmap2, amap2;
  int err = make_tma_2d(&amap1, a1, (uint64_t)M, k1);
  if (!err) err = make_tma_2d(&wmap1, w1, (uint64_t)k1, N);
  if (!err && a2) err = make_tma_2d(&amap2, a2, (uint64_t)M, k2);
  if (!err && a2) err = make_tma_2d(&wmap2, w2, (uint64_t)k2, N);
  if (err) return err;
  if (!a2) {
    amap2 = amap1;
    wmap2 = wmap1;
  }
  const int64_t items = ((int64_t)M + BM - 1) / BM * ((N + BN - 1) / BN);
  if (items == 0) return 0;
  static bool configured = false;
  const int grid = grid_of(pointwise_gemm_kernel, configured, items);
  if (grid < 0) return -grid;
  pointwise_gemm_kernel<<<grid, kThreads, SMEM, static_cast<cudaStream_t>(stream)>>>(
      wmap1, amap1, wmap2, amap2, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
