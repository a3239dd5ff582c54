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
// GFLOP against 200 MB of operands: 0.156 ms at 989 TFLOP/s). The design:
// - a persistent grid of one CTA per SM walks the output tiles of 128 pixels
//   x 256 output channels, so the image is gathered once per tile, not once
//   per column tile, and one tile's epilogue overlaps the next tile's copies;
// - a 4-slot ring of 48 KB slots walks K = 9 taps (outermost) x C/64 channel
//   chunks: A (128 pixels x 64 channels, K-major) and B (64 rows of W x 256
//   columns, MN-major), in the 128-byte swizzle that the wgmma descriptors
//   name, both loaded by TMA in 64 x 64 boxes, all issued by one producer
//   thread. A's box for a tap is the half tile's 64 pixels shifted by the
//   tap: one frame row (W % 64 == 0), its row remapped at the frame's top
//   and bottom; TMA fills the one pixel past the left or right edge with
//   zeros, and for reflect or replicate a second producer warp copies the
//   right pixel of the box over it once the box lands, then publishes the
//   stage. No padded copy of the frame is made. Other frames gather A by
//   16-byte cp.async from x: the producer warpgroup computes each tile's
//   pixel coordinates once (a 128-entry table), per tap adds the offset and
//   remaps a frame edge (pad_index), and publishes each stage as it lands.
//   Channels past C in a chunk are zero in A, so the rows of W they meet add
//   nothing; setmaxnreg lowers the producers' registers and raises the
//   consumers';
// - two consumer warpgroups run m64n256k16 wgmmas with f32 accumulators in
//   registers, one stage's wgmmas in flight while they wait for the next,
//   and run the epilogue straight from the accumulators: the four lanes of a
//   quad swap their column pairs by shuffles so that each owns 8 consecutive
//   channels, then load bias and residual and store out (and f2) in 16-byte
//   vectors.

#include "common.cuh"
#include "sm90_gemm.cuh"

namespace {

using namespace pht;
using namespace pht::sm90;

constexpr int BM = 128, BN = 256, BK = 64;  // pixels, output channels, K per stage
constexpr int S = kRingSlots, LAG = kLag;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int A_PER = BM * BK / 8 / kProducers;  // 16-byte copies per producer thread
static_assert(kProducers % 32 == 0, "producer layout");
// ring, barriers, two 128-entry coordinate tables (4 KB), 1 KB to align to 1,024
constexpr int SMEM = S * STAGE + (int)sizeof(Ring<S>) + 2 * BM * 16 + 1024;

struct Params {
  const bf16* x;     // [B, H, W, C]
  int a_tma;         // A by TMA (`amap`), not by the cp.async gather
  const bf16* w;     // [9 C, N]
  const bf16* bias;  // [N] or null
  const bf16* res;   // [B, H, W, N] or null, added after ReLU
  bf16* out;         // [B, H, W, N]
  bf16* out2;        // [B, H, W, N] or null: out before `res`
  int relu, B, H, W, C, N, pad_mode;
};

__device__ __forceinline__ uint32_t pick(uint32_t a, uint32_t b, uint32_t c, uint32_t d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the epilogue of 8 consecutive channels n..n+7 of pixel q, from their sums
// rounded to bf16 (`v`)
__device__ __forceinline__ void epilogue8(const Params& p, uint4 v, int64_t q, int n) {
  const int64_t off = q * p.N + n;
  bf16* y = reinterpret_cast<bf16*>(&v);
  if (p.bias) {
    const uint4 braw = *reinterpret_cast<const uint4*>(p.bias + n);
    const bf16* bb = reinterpret_cast<const bf16*>(&braw);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      y[e] = __float2bfloat16(__bfloat162float(y[e]) + __bfloat162float(bb[e]));
  }
  if (p.relu) {
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = __float2bfloat16(fmaxf(__bfloat162float(y[e]), 0.f));
  }
  if (p.out2) *reinterpret_cast<uint4*>(p.out2 + off) = v;
  if (p.res) {
    const uint4 rraw = *reinterpret_cast<const uint4*>(p.res + off);
    const bf16* rr = reinterpret_cast<const bf16*>(&rraw);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      y[e] = __float2bfloat16(__bfloat162float(rr[e]) + __bfloat162float(y[e]));
  }
  *reinterpret_cast<uint4*>(p.out + off) = v;
}

// `wmap`: W [9 C, N] in 64 x 64 boxes; `amap` (with a_tma): x as
// [B H, W, C] in 64-channel x 64-pixel boxes
__global__ void __launch_bounds__(kThreads, 1) conv3x3_kernel(
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap amap,
    Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Ring<S>& ring = *reinterpret_cast<Ring<S>*>(smem + S * STAGE);
  int4* table = reinterpret_cast<int4*>(smem + S * STAGE + sizeof(Ring<S>));

  const int64_t P = (int64_t)p.B * p.H * p.W;
  const int col_tiles = (p.N + BN - 1) / BN;
  const int items = (int)((P + BM - 1) / BM) * col_tiles;  // pixel tiles x column tiles
  const int chunks = (p.C + BK - 1) / BK;  // channel chunks per tap
  const int ksteps = 9 * chunks;
  if (threadIdx.x == 0) ring.init(p.a_tma ? 1 : kProducers, kConsumers / 32);
  __syncthreads();

  if (threadIdx.x >= kConsumers && p.a_tma) {
    // ------------------------------------------------- producer, A by TMA
    // warp 0's lane 0 issues every box; warp 1 patches the frame edges of
    // A's boxes once they land and publishes the stage
    producer_regs();
    const int pw = (threadIdx.x - kConsumers) / 32, lane = threadIdx.x % 32;
    if (pw < 2 && (pw == 1 || lane == 0)) {
      const int64_t HW = (int64_t)p.H * p.W;
      int i = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int64_t q0 = (int64_t)(item / col_tiles) * BM;
        const int n0 = (item % col_tiles) * BN;
        // each 64-pixel half of the tile lies in one frame row (W % 64 == 0):
        // its image, row and first column; a half past the frame reads zeros
        int img[2], y[2], x0[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t q = q0 + 64 * h;
          const int64_t b = q / HW, r = q - b * HW;
          img[h] = q < P ? (int)b : p.B;
          y[h] = (int)(r / p.W);
          x0[h] = (int)(r % p.W);
        }
        int ky = 0, kx = 0, cc = 0;
        for (int s = 0; s < ksteps; ++s, ++i) {
          unsigned char* slot = smem + (i % S) * STAGE;
          if (pw == 0) {
            wait_slot_free(ring, i);
            uint64_t* bar = &ring.landed[i % S];
#if PHT_SM90_DIAG != 2
            mbar_arrive_expect_tx(bar, A_BYTES);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              // the tap's row, remapped at the frame edge (zeros: a row past
              // every image, which TMA fills with zeros)
              int yy = y[h] + ky - 1;
              const int row = pad_index(yy, p.H, p.pad_mode) && img[h] < p.B
                                  ? img[h] * p.H + yy : p.B * p.H;
              tma_load_3d(smem_u32(slot) + h * 8192, &amap, cc * BK, x0[h] + kx - 1, row, bar);
            }
#else
            mbar_arrive(bar);
#endif
            load_b(ring, i, smem_u32(slot) + A_BYTES, &wmap, n0, (3 * ky + kx) * p.C + cc * BK);
          } else {
            mbar_wait(&ring.landed[i % S], (i / S) & 1);
#if PHT_SM90_DIAG != 2
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // the box's pixel past the frame edge
              const int edge = kx == 0 && x0[h] == 0 ? 0 : kx == 2 && x0[h] + 64 == p.W ? 63 : -1;
              const int src = edge < 0 ? -1 : edge_source(edge, p.pad_mode);
              if (src >= 0) patch_row(slot + h * 8192, edge, src, lane);
            }
            __syncwarp();
            fence_proxy_async();
#endif
            if (lane == 0) mbar_arrive(&ring.full[i % S]);
          }
          if (++cc == chunks) {
            cc = 0;
            if (++kx == 3) {
              kx = 0;
              ++ky;
            }
          }
        }
      }
    }
  } else if (threadIdx.x >= kConsumers) {
    // --------------------------------------------- producer, A by cp.async
    producer_regs();
    const int pt = threadIdx.x - kConsumers;
    const int cv = pt % 8;  // A: this thread's 8 channels of a chunk
    const uint32_t ring0 = smem_u32(smem);
    int i = 0;  // stage counter over all tiles
    for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
      const int64_t q0 = (int64_t)(item / col_tiles) * BM;
      const int n0 = (item % col_tiles) * BN;
      int4* tab = table + (it & 1) * BM;
      for (int r = pt; r < BM; r += kProducers) {  // the tile's pixel coordinates
        const int64_t q = q0 + r;
        const int x = (int)(q % p.W);
        const int64_t t = q / p.W;
        tab[r] = make_int4((int)(t / p.H) * p.H, (int)(t % p.H), x, q < P);
      }
      bar_sync(1, kProducers);
      int ky = 0, kx = 0, cc = 0;
      for (int s = 0; s < ksteps; ++s, ++i) {
        publish<S, LAG>(ring, i);
        wait_slot_free(ring, i);
        const uint32_t slot = ring0 + (i % S) * STAGE;
        const int c = cc * BK + 8 * cv;
        const bool chan_ok = c < p.C;
#if PHT_SM90_DIAG != 2
#pragma unroll 4
        for (int j = 0; j < A_PER; ++j) {  // A: channels c..c+7 of a pixel
          const int px = pt / 8 + (kProducers / 8) * j;
          const int4 e = tab[px];
          int yy = e.y + ky - 1, xx = e.z + kx - 1;
          const bool ok = e.w && chan_ok && pad_index(yy, p.H, p.pad_mode) &&
                          pad_index(xx, p.W, p.pad_mode);
          const bf16* src = ok ? p.x + ((int64_t)(e.x + yy) * p.W + xx) * p.C + c : p.x;
          cp_async16(slot + sw128(px, cv), src, ok);
        }
#endif
        cp_async_commit();
        if (pt == 0)  // B: rows (tap, chunk) of W by TMA
          load_b(ring, i, slot + A_BYTES, &wmap, n0, (3 * ky + kx) * p.C + cc * BK);
        if (++cc == chunks) {
          cc = 0;
          if (++kx == 3) {
            kx = 0;
            ++ky;
          }
        }
      }
    }
    publish_tail<S, LAG>(ring, i);
  } else {
    // --------------------------------------------------------------- consumers
    consumer_regs();
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, quad = lane % 4;
    const uint32_t ring0 = smem_u32(smem);
    float acc[128];  // each tile's first wgmma overwrites it
    int i = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      for (int s = 0; s < ksteps; ++s, ++i) {
        wait_slot_full(ring, i);
        const uint32_t a = ring0 + (i % S) * STAGE + wg * 8192;
        const uint32_t b = ring0 + (i % S) * STAGE + A_BYTES;
#if PHT_SM90_DIAG != 1
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k)
          wgmma_m64n256k16<0, 1>(acc, make_desc(a + 32 * k, 16, 1024),
                                 make_desc(b + 2048 * k, 8192, 1024), s > 0 || k > 0);
        wgmma_commit();
        wgmma_wait<1>();
#endif
        if (s > 0) release(ring, i - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(ring, i - 1);
#if PHT_SM90_DIAG == 1
#pragma unroll
      for (int k = 0; k < 128; ++k) acc[k] = 0.f;
#endif

      // epilogue: lane `quad` of each quad gathers block 4 jj + quad's 8
      // channels for its rows r and r + 8
      const int64_t q = (int64_t)(item / col_tiles) * BM + 64 * wg + 16 * warp + lane / 4;
      const int n0 = (item % col_tiles) * BN;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t in[4], got[4];
#pragma unroll
          for (int jb = 0; jb < 4; ++jb)
            in[jb] = pack_bf16(acc[4 * (4 * jj + jb) + 2 * h], acc[4 * (4 * jj + jb) + 2 * h + 1]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            got[k] = __shfl_xor_sync(0xffffffffu, pick(in[0], in[1], in[2], in[3], quad ^ k), k);
          // channel pair c of the block came from lane c, i.e. got[c ^ quad]
          const uint4 v = make_uint4(pick(got[0], got[1], got[2], got[3], quad),
                                     pick(got[0], got[1], got[2], got[3], 1 ^ quad),
                                     pick(got[0], got[1], got[2], got[3], 2 ^ quad),
                                     pick(got[0], got[1], got[2], got[3], 3 ^ quad));
          const int n = n0 + 8 * (4 * jj + quad);
          const int64_t row = q + 8 * h;
          if (row < P && n < p.N) epilogue8(p, v, row, n);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Needs C, N multiples of 8 and 16-byte aligned tensors (ops/block_cuda.py's
// gate). A comes by TMA when W % 64 == 0, else by the cp.async gather. The
// persistent grid is one wave (one CTA per SM), capped at the work.
int pht_conv3x3_sm90(const void* x, const void* w, const void* bias, int relu, const void* res,
                     void* out, void* out2, int B, int H, int W, int C, int N, int pad_mode,
                     void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.a_tma = W % 64 == 0;
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const bf16*>(bias);
  p.res = static_cast<const bf16*>(res);
  p.out = static_cast<bf16*>(out);
  p.out2 = static_cast<bf16*>(out2);
  p.relu = relu;
  p.B = B; p.H = H; p.W = W; p.C = C; p.N = N; p.pad_mode = pad_mode;
  CUtensorMap wmap, amap = {};
  int err0 = make_tma_2d(&wmap, w, 9 * (uint64_t)C, N);
  if (!err0 && p.a_tma) {
    const uint64_t dims[3] = {(uint64_t)C, (uint64_t)W, (uint64_t)B * H};
    err0 = make_tma(&amap, x, 3, dims);
  }
  if (err0) return err0;
  static bool configured = false;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int64_t items = ((int64_t)B * H * W + BM - 1) / BM * ((N + BN - 1) / BN);
  if (items == 0) return 0;
  const int wave = wave_ctas(conv3x3_kernel, SMEM);
  if (wave <= 0) return (int)cudaErrorInvalidConfiguration;
  conv3x3_kernel<<<(int)std::min<int64_t>(items, wave), kThreads, SMEM,
                   static_cast<cudaStream_t>(stream)>>>(wmap, amap, p);
  return (int)cudaGetLastError();
}

int pht_conv3x3_sm90_smem() { return SMEM; }

}  // extern "C"
