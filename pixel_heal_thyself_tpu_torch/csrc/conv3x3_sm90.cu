// K3's Hopper body `pht_conv3x3_sm90`: out = epi(conv3x3(pad(x)) . W), an
// implicit GEMM over NHWC with K = 9 taps x C channels (W = HWIO reshaped to
// [9 C, N], tap-major). It replaces the 3x3 convs of TPU kernel #3,
// `_block_kernel` in pixel_heal_thyself_tpu/ops/block_mega.py:413
// (`_conv3x3_stripe`, :206-233), as block_fwd.cu's general WMMA body does for
// the shapes outside ops/block_cuda.py's gate (C, N multiples of 8).
// Epilogue, in the order of `_conv3x3_stripe`: round the f32 sum to bf16
// once; add the bf16 bias and round; ReLU; then optionally
// out = round(residual + out), and optionally also write f2, the value
// before the residual.
//
// What bounds it on the H100: tensor-core operations (a prod conv is 155
// GFLOP against 200 MB of operands: 0.156 ms at 989 TFLOP/s). The design is
// sm90_body.cuh's (shared with K2 and K5): a persistent one-wave grid of
// 128-pixel x 256-channel tiles, so the image is gathered once per tile, not
// once per column tile; a 4-slot ring walking K = 9 taps (outermost) x C/64
// channel chunks; W by TMA, and the image by TMA when W % 64 == 0 (each tap
// a shifted 64-pixel box of one frame row, its pixel past the frame edge
// patched in shared memory for reflect or replicate padding), else by a
// cp.async gather; two consumer warpgroups of m64n256k16 wgmmas and the
// epilogue straight from their accumulators.

#include "sm90_body.cuh"

namespace {

using namespace pht;
using namespace pht::sm90;
using namespace pht::sm90::body;

__global__ void __launch_bounds__(kThreads, 1) conv3x3_kernel(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap amap,
    Params p) {
  run<Op::kConv>(wmap, amap, wmap, amap, p);
}

}  // namespace

extern "C" {

// Needs C, N multiples of 8 and 16-byte aligned tensors (ops/block_cuda.py's
// gate). A comes by TMA when W % 64 == 0, else by the cp.async gather. The
// persistent grid is one wave (one CTA per SM), capped at the work.
int pht_conv3x3_sm90(const void* x, const void* w, const void* bias, int relu, const void* res,
                     void* out, void* out2, int B, int H, int W, int C, int N, int pad_mode,
                     void* stream) {
  Params p = {};
  p.x = static_cast<const bf16*>(x);
  p.a_tma = W % 64 == 0;
  p.bias = static_cast<const bf16*>(bias);
  p.res = static_cast<const bf16*>(res);
  p.out = static_cast<bf16*>(out);
  p.out2 = static_cast<bf16*>(out2);
  p.relu = relu;
  p.B = B; p.H = H; p.W = W; p.C = C; p.N = N; p.pad_mode = pad_mode;
  p.P = (int64_t)B * H * W;
  p.chunks1 = (C + BK - 1) / BK;
  CUtensorMap wmap, amap = {};
  int err0 = make_tma_2d(&wmap, w, 9 * (uint64_t)C, N);
  if (!err0 && p.a_tma) {
    const uint64_t dims[3] = {(uint64_t)C, (uint64_t)W, (uint64_t)B * H};
    err0 = make_tma(&amap, x, 3, dims);
  }
  if (err0) return err0;
  const int64_t items = (p.P + BM - 1) / BM * ((N + BN - 1) / BN);
  if (items == 0) return 0;
  static bool configured = false;
  const int grid = grid_of(conv3x3_kernel, configured, items);
  if (grid < 0) return -grid;
  conv3x3_kernel<<<grid, kThreads, SMEM, static_cast<cudaStream_t>(stream)>>>(wmap, amap, p);
  return (int)cudaGetLastError();
}

// the dynamic shared memory of one CTA of the body of K2, K3 and K5 (the
// planner's check)
int pht_conv3x3_sm90_smem() { return SMEM; }

}  // extern "C"
