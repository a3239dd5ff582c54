// K6's Hopper body `pht_weight_grad_sm90`: the pixel contraction
//     dW[tap*C1 + c, n] = sum_pixels shift_tap(x)[p, c] * (dy * [gate > 0])[p, n]
// (and db[n] = sum_p dy*[gate > 0] with colsum), in f32. It replaces the pixel
// contractions of TPU kernel #4, `_bwd_kernel` in
// pixel_heal_thyself_tpu/ops/block_mega.py:662 (`contract_px` at :724-730, the
// db sums at :816, :841 and :928), as block_bwd.cu's general WMMA body does
// for the shapes outside ops/block_cuda.py's gate (C1, C2, N multiples of 8).
//
// What bounds it on the H100: tensor-core operations (a prod 3x3 weight
// gradient is 155 GFLOP against 201 MB of operands: 0.156 ms at 989 TFLOP/s).
// The design feeds wgmma without stalls:
// - each CTA owns 128 rows of dW (one tap x 128 channels at prod) x 256
//   columns and a contiguous range of pixels (split-K); the Python planner
//   (`wgrad_plan`) sizes the splits so that the grid is one wave at one CTA
//   per SM (prod: 18 row tiles x 7 splits = 126 CTAs);
// - a 4-slot ring of 48 KB slots holds 64-pixel stages of both operands,
//   MN-major (pixels are K) in the 128-byte swizzle that the wgmma
//   descriptors name. g comes by TMA in four 64 x 64 boxes a stage; so does
//   x when its 64-row boxes hold one tap (C1 % 64 == 0) and, with 9 taps, a
//   stage lies in one frame row (W % 64 == 0): the box shifted by the tap,
//   its row remapped at the frame's top and bottom; TMA fills the one pixel
//   past the left or right edge with zeros, and for reflect or replicate a
//   second producer warp copies the right pixel of the box over it once the
//   box lands, then publishes the stage. One producer thread issues every
//   box. Other shapes gather x by 16-byte cp.async: the producer warpgroup
//   (its registers lowered by setmaxnreg, the consumers' raised) computes
//   each stage's pixel coordinates once per pixel by stepping the previous
//   stage's, so there is no / or % per vector, remaps only a frame edge
//   (pad_index), and publishes each stage as it lands;
// - two consumer warpgroups run m64n256k16 wgmmas (both operands through the
//   transpose flag) with f32 accumulators in registers, keeping one stage's
//   wgmmas in flight while they wait for the next;
// - the ReLU gate is applied by a separate elementwise pass (`mask_kernel`,
//   `pht_relu_gate`, which K5 runs too: g = dy where gate > 0, else 0,
//   exact in bf16) before the contraction;
//   the consumers of the row-tile-0 CTAs sum db from each stage of g while
//   its wgmmas run;
// - each split writes an f32 partial (db too), and `pht_sum_splits` adds
//   them in a fixed order: deterministic, no float atomics.

#include "common.cuh"
#include "sm90_gemm.cuh"

extern "C" int pht_sum_splits(const void* part, void* out, long long len, int splits,
                              void* stream);

namespace {

using namespace pht;
using namespace pht::sm90;

constexpr int BM = 128, BN = 256, BK = 64;  // dW rows, columns, pixels per stage
constexpr int S = kRingSlots, LAG = kLag;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int A_PER = BM * BK / 8 / kProducers;  // 16-byte copies per producer thread
static_assert(kProducers % 32 == 0 && kProducers >= BK, "producer layout");
// ring, barriers, coordinate tables (two of 64 pixels; 4 KB, as K3's), 1 KB
// to align to 1,024
constexpr int SMEM = S * STAGE + (int)sizeof(Ring<S>) + 4096 + 1024;

struct Params {
  const bf16* a1;  // [P, C1] NHWC pixels, shifted per tap
  int a_tma;       // A by TMA (amap1, amap2), not by cp.async
  const bf16* a2;  // [P, C2] or null (taps == 1): rows taps*C1.. of dW
  const bf16* g;   // [P, N] the gated output gradient
  float* part;     // [splits][len]: dW [M][N], then db [N] when colsum
  int B, H, W, C1, C2, N, taps, pad_mode, colsum, pix_per_split;
  int M;           // taps * C1 + C2
  int64_t len;
};

// `gmap`: g [P, N] in 64 x 64 boxes; with a_tma, `amap1`: x as [P, C1]
// (1 tap) or [B H, W, C1] (9 taps), `amap2`: a2 [P, C2], in 64-channel x
// 64-pixel boxes
__global__ void __launch_bounds__(kThreads, 1) wgrad_kernel(
    const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap amap1,
    const __grid_constant__ CUtensorMap amap2, Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Ring<S>& ring = *reinterpret_cast<Ring<S>*>(smem + S * STAGE);
  int4* table = reinterpret_cast<int4*>(smem + S * STAGE + sizeof(Ring<S>));

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int P = p.B * p.H * p.W;
  const int p0 = split * p.pix_per_split;
  const int p1 = min(P, p0 + p.pix_per_split);
  const int stages = p1 > p0 ? (p1 - p0 + BK - 1) / BK : 0;
  if (threadIdx.x == 0) ring.init(p.a_tma ? 1 : kProducers, kConsumers / 32);
  __syncthreads();

  if (threadIdx.x >= kConsumers && p.a_tma) {
    // ------------------------------------------------- producer, A by TMA
    // warp 0's lane 0 issues every box; warp 1 patches the frame edges of
    // A's boxes once they land and publishes the stage
    producer_regs();
    const int pw = (threadIdx.x - kConsumers) / 32, lane = threadIdx.x % 32;
    if (pw < 2 && (pw == 1 || lane == 0)) {
      // the two 64-row boxes of the tile: map, channel, tap offset; a box
      // past M reads zeros (a channel past the map)
      const CUtensorMap* map[2];
      int chan[2], ky[2], kx[2];
      const int k1 = p.taps * p.C1;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int m = m0 + 64 * k;
        map[k] = m < k1 || m >= p.M ? &amap1 : &amap2;
        chan[k] = m >= p.M ? p.C1 : m < k1 ? m % p.C1 : m - k1;
        const int tap = m < k1 ? m / p.C1 : 4;  // 1 tap: the centre, no shift
        ky[k] = p.taps == 9 ? tap / 3 : 1;
        kx[k] = p.taps == 9 ? tap % 3 : 1;
      }
      // 9 taps: the stage's image, frame row and first column (W % 64 == 0)
      int x0 = p0 % p.W, t = p0 / p.W;
      int y = t % p.H, b = t / p.H;
      for (int i = 0; i < stages; ++i) {
        unsigned char* slot = smem + (i % S) * STAGE;
        if (pw == 0) {
          wait_slot_free(ring, i);
          uint64_t* bar = &ring.landed[i % S];
#if PHT_SM90_DIAG != 2
          mbar_arrive_expect_tx(bar, A_BYTES);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (p.taps == 9) {  // the tap's row, remapped at the frame edge
              int yy = y + ky[k] - 1;
              const int row = pad_index(yy, p.H, p.pad_mode) ? b * p.H + yy : p.B * p.H;
              tma_load_3d(smem_u32(slot) + k * 8192, map[k], chan[k], x0 + kx[k] - 1, row, bar);
            } else {
              tma_load_2d(smem_u32(slot) + k * 8192, map[k], chan[k], p0 + i * BK, bar);
            }
          }
#else
          mbar_arrive(bar);
#endif
          load_b(ring, i, smem_u32(slot) + A_BYTES, &gmap, n0, p0 + i * BK);
        } else {
          mbar_wait(&ring.landed[i % S], (i / S) & 1);
#if PHT_SM90_DIAG != 2
#pragma unroll
          for (int k = 0; k < 2; ++k) {  // the box's pixel past the frame edge
            const int edge = p.taps != 9 ? -1
                             : kx[k] == 0 && x0 == 0 ? 0
                             : kx[k] == 2 && x0 + 64 == p.W ? 63 : -1;
            const int src = edge < 0 ? -1 : edge_source(edge, p.pad_mode);
            if (src >= 0) patch_row(slot + k * 8192, edge, src, lane);
          }
          __syncwarp();
          fence_proxy_async();
#endif
          if (lane == 0) mbar_arrive(&ring.full[i % S]);
        }
        if ((x0 += BK) == p.W) {
          x0 = 0;
          if (++y == p.H) {
            y = 0;
            ++b;
          }
        }
      }
    }
  } else if (threadIdx.x >= kConsumers) {
    // --------------------------------------------- producer, A by cp.async
    producer_regs();
    const int pt = threadIdx.x - kConsumers;
    // A: this thread's 8 dW rows (one 16-byte vector), fixed for the CTA
    const int v = pt % 16, m = m0 + 8 * v;
    const int k1 = p.taps * p.C1;
    const bool row_ok = m < p.M;
    const bf16* abase = p.a1;
    int cstride = p.C1, c = m, dy = 0, dx = 0;
    if (m >= k1) {
      abase = p.a2;
      cstride = p.C2;
      c = m - k1;
    } else if (p.taps == 9) {
      const int tap = m / p.C1;
      c = m - tap * p.C1;
      dy = tap / 3 - 1;
      dx = tap % 3 - 1;
    }
    const uint32_t a_off = (v / 8) * 8192;
    // the coordinates of pixel p0 + pt (pt < BK), stepped by BK pixels a stage
    int x = (p0 + pt) % p.W, t = (p0 + pt) / p.W;
    int y = t % p.H, b = t / p.H;
    const int sx = BK % p.W, sy = (BK / p.W) % p.H, sb = BK / (p.W * p.H);
    const uint32_t ring0 = smem_u32(smem);

    for (int i = 0; i < stages; ++i) {
      publish<S, LAG>(ring, i);
      int4* tab = table + (i & 1) * BK;
      if (pt < BK) tab[pt] = make_int4(b * p.H, y, x, p0 + i * BK + pt < p1);
      bar_sync(1, kProducers);
      wait_slot_free(ring, i);
      const uint32_t slot = ring0 + (i % S) * STAGE;
#if PHT_SM90_DIAG != 2
#pragma unroll 4
      for (int j = 0; j < A_PER; ++j) {  // A: rows m..m+7 of a pixel
        const int px = pt / 16 + (kProducers / 16) * j;
        const int4 e = tab[px];
        int yy = e.y + dy, xx = e.z + dx;
        const bool ok = e.w && row_ok && pad_index(yy, p.H, p.pad_mode) &&
                        pad_index(xx, p.W, p.pad_mode);
        const bf16* src = ok ? abase + ((int64_t)(e.x + yy) * p.W + xx) * cstride + c : p.a1;
        cp_async16(slot + a_off + sw128(px, v % 8), src, ok);
      }
#endif
      cp_async_commit();
      if (pt == 0)  // B: the stage's 64 pixels of g by TMA
        load_b(ring, i, slot + A_BYTES, &gmap, n0, p0 + i * BK);
      x += sx;  // the next stage's pixel
      const int cy = x >= p.W;
      x -= cy ? p.W : 0;
      y += sy + cy;
      const int cb = y >= p.H;
      y -= cb ? p.H : 0;
      b += sb + cb;
    }
    publish_tail<S, LAG>(ring, stages);
  } else {
    // --------------------------------------------------------------- consumers
    consumer_regs();
    const int wg = threadIdx.x / 128;
    float acc[128];  // the first wgmma overwrites it (no zero fill: that
                     // would serialize the wgmmas)
    const uint32_t ring0 = smem_u32(smem);
    // db: the row-tile-0 CTAs sum g's columns from each stage while its
    // wgmmas run; thread t takes columns 8 (t % 32).. of 8 of the 64 pixels
    const bool do_colsum = p.colsum && blockIdx.x == 0;
    const int cv = threadIdx.x % 32;
    float db[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) db[e] = 0.f;
    for (int i = 0; i < stages; ++i) {
      wait_slot_full(ring, i);
      const uint32_t a = ring0 + (i % S) * STAGE + wg * 8192, bb = ring0 + (i % S) * STAGE + A_BYTES;
#if PHT_SM90_DIAG != 1
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        wgmma_m64n256k16<1, 1>(acc, make_desc(a + 2048 * k, 8192, 1024),
                               make_desc(bb + 2048 * k, 8192, 1024), i > 0 || k > 0);
      wgmma_commit();
#endif
      if (do_colsum) {
        const unsigned char* bs = smem + (i % S) * STAGE + A_BYTES + (cv / 8) * 8192;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              bs + sw128(threadIdx.x / 32 + 8 * j, cv % 8));
          const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) db[e] += __bfloat162float(h[e]);
        }
      }
#if PHT_SM90_DIAG != 1
      wgmma_wait<1>();
#endif
      if (i > 0) release(ring, i - 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (stages > 0) release(ring, stages - 1);
    if (stages == 0 || PHT_SM90_DIAG == 1) {  // a split without pixels (the planner makes none)
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    }
    if (do_colsum) {  // threads t, t + 32, ... hold the same columns: add in order
      bar_sync(2, kConsumers);  // every consumer is done with the ring
      float* red = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int e = 0; e < 8; ++e) red[threadIdx.x * 8 + e] = db[e];
      bar_sync(2, kConsumers);
      const int n = n0 + 8 * cv;
      if (threadIdx.x < 32 && n < p.N) {
        float* out = p.part + (size_t)split * p.len + (size_t)p.M * p.N + n;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float sum = 0.f;
          for (int k = 0; k < kConsumers / 32; ++k) sum += red[(threadIdx.x + 32 * k) * 8 + e];
          out[e] = sum;
        }
      }
    }

    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row = m0 + 64 * wg + 16 * warp + lane / 4;
    float* part = p.part + (size_t)split * p.len;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= p.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < p.M)
          *reinterpret_cast<float2*>(part + (size_t)r * p.N + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// g = dy where gate > 0, else 0 (exact in bf16); 16-byte vectors
__global__ void mask_kernel(const uint4* __restrict__ dy, const uint4* __restrict__ gate,
                            uint4* __restrict__ g, int64_t vectors) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < vectors;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint4 d = dy[i];
    const uint4 gt = gate[i];
    bf16* dv = reinterpret_cast<bf16*>(&d);
    const bf16* gv = reinterpret_cast<const bf16*>(&gt);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (!(__bfloat162float(gv[e]) > 0.f)) dv[e] = __float2bfloat16(0.f);
    g[i] = d;
  }
}

int configure() {
  static bool done = false;
  if (!done) {
    const cudaError_t err =
        cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    done = true;
  }
  return 0;
}

}  // namespace

extern "C" {

// The ReLU gate of K5 and K6: g = dy where gate > 0, else 0, over `elems`
// bf16 values (a multiple of 8, 16-byte aligned)
int pht_relu_gate(const void* dy, const void* gate, void* g, long long elems, void* stream) {
  const int64_t vectors = elems / 8;
  const int blocks = (int)std::min<int64_t>((vectors + 255) / 256, 132 * 8);
  if (blocks == 0) return 0;
  mask_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(dy), static_cast<const uint4*>(gate), static_cast<uint4*>(g),
      vectors);
  return (int)cudaGetLastError();
}

// A comes by TMA when C1 % 64 == 0 and, with 9 taps, W % 64 == 0; else by the
// cp.async gather from a1 (and a2).
// g: [P, N] bf16 scratch (used when gate); part: [splits][len] f32 scratch;
// out: [len] f32: dW [M][N], then db [N] when colsum (len = M*N (+ N)),
// M = taps*C1 + C2. Needs C1, C2, N multiples of 8 and 16-byte aligned
// operands (ops/block_cuda.py's gate); splits and pix_per_split from
// `wgrad_plan`.
int pht_weight_grad_sm90(const void* a1, int C1, const void* a2, int C2, const void* dy,
                         const void* gate, void* g, void* part, void* out, int B, int H,
                         int W, int N, int taps, int pad_mode, int colsum, int splits,
                         int pix_per_split, void* stream) {
  if (pix_per_split % BK) return (int)cudaErrorInvalidValue;  // stages within a split
  const int a_tma = C1 % 64 == 0 && (taps == 1 || W % 64 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t P = (int64_t)B * H * W;
  Params p;
  p.a1 = static_cast<const bf16*>(a1);
  p.a2 = static_cast<const bf16*>(a2);
  p.a_tma = a_tma;
  p.g = static_cast<const bf16*>(dy);
  if (gate) {
    const int err = pht_relu_gate(dy, gate, g, (long long)(P * N), stream);
    if (err) return err;
    p.g = static_cast<const bf16*>(g);
  }
  p.part = static_cast<float*>(part);
  p.B = B; p.H = H; p.W = W; p.C1 = C1; p.C2 = a2 ? C2 : 0; p.N = N;
  p.taps = taps; p.pad_mode = pad_mode; p.colsum = colsum; p.pix_per_split = pix_per_split;
  p.M = taps * C1 + p.C2;
  p.len = (int64_t)p.M * N + (colsum ? N : 0);
  CUtensorMap gmap, amap1 = {}, amap2 = {};
  int err0 = make_tma_2d(&gmap, p.g, (uint64_t)P, N);
  if (!err0 && a_tma) {
    if (taps == 9) {
      const uint64_t dims[3] = {(uint64_t)C1, (uint64_t)W, (uint64_t)B * H};
      err0 = make_tma(&amap1, a1, 3, dims);
    } else {
      err0 = make_tma_2d(&amap1, a1, (uint64_t)P, C1);
    }
    if (!err0) err0 = a2 ? make_tma_2d(&amap2, a2, (uint64_t)P, C2) : 0;
    if (!a2) amap2 = amap1;
  }
  if (err0) return err0;
  const int err1 = configure();
  if (err1) return err1;
  const dim3 grid((unsigned)((p.M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                  (unsigned)splits);
  wgrad_kernel<<<grid, kThreads, SMEM, s>>>(gmap, amap1, amap2, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return pht_sum_splits(part, out, (long long)p.len, splits, stream);
}

// the dynamic shared memory of one wgrad_kernel CTA (the planner's check)
int pht_weight_grad_sm90_smem() { return SMEM; }

// CTAs of one wave of either Hopper body (the same threads and shared
// memory): the planner's; negative on error
int pht_sm90_wave_ctas() {
  if (configure()) return -1;
  return wave_ctas(wgrad_kernel, SMEM);
}

}  // extern "C"
