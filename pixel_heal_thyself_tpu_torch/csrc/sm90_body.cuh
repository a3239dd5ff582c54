// The Hopper (sm_90a) body of K2, K3 and K5: one persistent, warp-specialized
// wgmma GEMM whose A, B and epilogue a template parameter picks.
//
//   K3 (conv3x3_sm90.cu)   out = epi(conv3x3(pad(x)) . W): A = x shifted by
//                          each tap (K = 9 taps x C), B = W [9 C, N] MN-major.
//   K2 (pointwise_sm90.cu) out = epi([pre_res +] a1 . W1 [+ a2 . W2]): A = a1
//                          [M, K1] then a2 [M, K2], B = W1 then W2 [K, N]
//                          MN-major, one accumulator.
//   K5 (dgrad_sm90.cu)     d_in = round(sum_taps g . W[tap]^T [+ fold] [+
//                          pre_res]): A = g shifted by each tap the other way
//                          (source y + 1 - ky, x + 1 - kx, zeros outside the
//                          frame), B = W [9 C, N] read K-major (n is K), so
//                          no transposed copy of W is made.
//
// The design (what bounds each kernel: the header of its source):
// - a persistent grid of one CTA per SM walks the output tiles of 128 rows
//   (pixels) x 256 columns, with a stage counter that runs across tiles, so
//   the producer loads the next tile's stages while the consumers store;
// - a 4-slot ring of 48 KB slots walks K in 64-deep stages: A (128 rows x 64
//   K, K-major) and B (64 K x 256 columns, MN-major; K5: 256 columns x 64 K,
//   K-major), in the 128-byte swizzle that the wgmma descriptors name
//   (sm90_gemm.cuh), both loaded by TMA in 64 x 64 boxes that one producer
//   thread issues. K2's A is a plain 2-D box. K3's and K5's A for a tap is
//   the half tile's 64 pixels shifted by the tap: one frame row (W % 64 ==
//   0), its row remapped at the frame's top and bottom (a row outside the
//   frame reads a zero row past every image); TMA fills the pixel past the
//   left or right edge with zeros. For K3's reflect or replicate padding a
//   second producer warp copies the right pixel of the box over it once the
//   box lands, then publishes the stage; K2 and K5 need no patch, so their
//   A boxes complete on the stage's `full` barrier directly. Other frames
//   gather A by 16-byte cp.async: the producer warpgroup computes each
//   tile's pixel coordinates once (a 128-entry table), per tap adds the
//   offset and remaps a frame edge (K5: none, zeros), and publishes each
//   stage as it lands. Channels past C in a chunk are zero in A, so the rows
//   of B they meet add nothing; setmaxnreg lowers the producers' registers
//   and raises the consumers';
// - two consumer warpgroups run m64n256k16 wgmmas with f32 accumulators in
//   registers, one stage's wgmmas in flight while they wait for the next,
//   and run the epilogue straight from the accumulators: the four lanes of a
//   quad swap their column pairs by shuffles so that each owns 8 consecutive
//   columns (as bf16 pairs, or as f32 where K2 and K5 add pre_res, and K5
//   its fold lines' terms, loaded as 16-byte vectors, before the single
//   rounding), then add bias and residual and store out (and f2) in 16-byte
//   vectors.
#pragma once

#include "common.cuh"
#include "sm90_gemm.cuh"

namespace pht {
namespace sm90 {
namespace body {

enum class Op { kConv, kPointwise, kDgrad };

constexpr int BM = 128, BN = 256, BK = 64;  // rows (pixels), columns, K per stage
constexpr int S = kRingSlots, LAG = kLag;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int A_PER = BM * BK / 8 / kProducers;  // 16-byte copies per producer thread
static_assert(kProducers % 32 == 0, "producer layout");
// ring, barriers, two 128-entry coordinate tables (4 KB), 1 KB to align to 1,024
constexpr int SMEM = S * STAGE + (int)sizeof(Ring<S>) + 2 * BM * 16 + 1024;

struct Params {
  const bf16* x;        // A: the image [B, H, W, C] (K3: x; K5: g), unused by K2
  int a_tma;            // A by TMA (`amap`), not by the cp.async gather (K2: always)
  const bf16* bias;     // [N] or null
  const bf16* pre_res;  // [P, N] or null: added to the f32 sum before its rounding
  const float* fold;    // K5, reflect or replicate: the fold lines' f32 terms, or null
  const bf16* res;      // [P, N] or null, added after ReLU
  bf16* out;            // [P, N]
  bf16* out2;           // [P, N] or null: out before `res`
  int relu, B, H, W, C, N, pad_mode;  // C: A's channels (K); N: output columns
  int64_t P;            // output rows
  int chunks1, chunks2;  // 64-deep K chunks: per tap (K3, K5); of a1 and a2 (K2)
};

__device__ __forceinline__ uint32_t pick(uint32_t a, uint32_t b, uint32_t c, uint32_t d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

__device__ __forceinline__ float pickf(float a, float b, float c, float d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the fold line of reflect (1, n - 2) or replicate (0, n - 1) padding on
// `side` 0 (top / left) or 1 (bottom / right): the coordinate onto which the
// padded ring's gradient folds
__host__ __device__ __forceinline__ int fold_target(int side, int n, int mode) {
  return side == 0 ? (mode == kReflect ? 1 : 0) : (mode == kReflect ? n - 2 : n - 1);
}

// the end of the epilogue of 8 consecutive columns n..n+7 of row q, from
// their sums rounded to bf16 (`v`), with the bias of those columns (`braw`)
// and K3's residual (`rraw`), loaded before (zeros where absent)
__device__ __forceinline__ void finish8(const Params& p, uint4 v, uint4 braw, uint4 rraw,
                                        int64_t q, int n) {
  const int64_t off = q * p.N + n;
  bf16* y = reinterpret_cast<bf16*>(&v);
  if (p.bias) {
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
    const bf16* rr = reinterpret_cast<const bf16*>(&rraw);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      y[e] = __float2bfloat16(__bfloat162float(rr[e]) + __bfloat162float(y[e]));
  }
  *reinterpret_cast<uint4*>(p.out + off) = v;
}

// K5's fold terms of pixel q: `mask` bit s (0, 1) for the row lines (top,
// bottom), 2 + s for the column lines (left, right); `rline` its index in
// the row-line part [B][2][W] of `fold`, `cline` in the column-line part
// [B][H][2] (dgrad_sm90.cu's pre-pass writes both, N floats per entry)
struct FoldRow {
  int mask;
  int64_t rline, cline;
};

__device__ __forceinline__ FoldRow fold_row(const Params& p, int64_t q) {
  FoldRow f = {0, 0, 0};
  if (!p.fold || q >= p.P) return f;
  const int64_t hw = (int64_t)p.H * p.W;
  const int b = (int)(q / hw);
  const int r = (int)(q - b * hw);
  const int y = r / p.W, x = r % p.W;
  f.mask = (y == fold_target(0, p.H, p.pad_mode)) | (y == fold_target(1, p.H, p.pad_mode)) << 1 |
           (x == fold_target(0, p.W, p.pad_mode)) << 2 |
           (x == fold_target(1, p.W, p.pad_mode)) << 3;
  f.rline = (int64_t)b * 2 * p.W + x;
  f.cline = ((int64_t)b * p.H + y) * 2;
  return f;
}

// adds the fold terms of 8 consecutive columns n..n+7 to `y`
__device__ __forceinline__ void add_fold(const Params& p, const FoldRow& f, int n, float (&y)[8]) {
  const float* rows = p.fold;
  const float* cols = p.fold + (int64_t)2 * p.B * p.W * p.N;
  const float* src[4] = {rows + f.rline * p.N, rows + (f.rline + p.W) * p.N,
                         cols + f.cline * p.N, cols + (f.cline + 1) * p.N};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (f.mask >> k & 1) {
      const float4 t0 = *reinterpret_cast<const float4*>(src[k] + n);
      const float4 t1 = *reinterpret_cast<const float4*>(src[k] + n + 4);
      y[0] += t0.x; y[1] += t0.y; y[2] += t0.z; y[3] += t0.w;
      y[4] += t1.x; y[5] += t1.y; y[6] += t1.z; y[7] += t1.w;
    }
  }
}

// The epilogue of a tile from the accumulators (`q`: this lane's first row,
// `n0`: the tile's first column): lane `quad` of each quad gathers block
// 4 j + quad's 8 columns for its rows q and q + 8. The quads exchange bf16
// pairs, rounded once, or, where f32 terms join the sums before that
// rounding (K2, K5: pre_res; K5: the fold lines), f32 pairs. Every load of
// four column blocks (bias, K3's residual, pre_res) is issued before their
// stores: a load after a store to `out` could alias it, so it would wait
// for the store, and the epilogue would pay a memory latency per block.
template <Op OP, bool F32>
__device__ __forceinline__ void epilogue_tile(const Params& p, float (&acc)[128], int64_t q,
                                              int n0, int quad) {
  const bf16* side = OP == Op::kConv ? p.res : p.pre_res;  // [P, N] or null
  FoldRow fold[2] = {};
  if constexpr (OP == Op::kDgrad) {
    fold[0] = fold_row(p, q);
    fold[1] = fold_row(p, q + 8);
  }
#pragma unroll
  for (int j0 = 0; j0 < 8; j0 += 4) {
    uint4 bias[4], rows[4][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + 8 * (4 * (j0 + jj) + quad);
      bias[jj] = OP != Op::kDgrad && p.bias && n < p.N  // K5 has no bias
                     ? *reinterpret_cast<const uint4*>(p.bias + n) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = q + 8 * h;
        rows[jj][h] = side && row < p.P && n < p.N
                          ? *reinterpret_cast<const uint4*>(side + row * p.N + n)
                          : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + jj;
        const int64_t row = q + 8 * h;
        const int n = n0 + 8 * (4 * j + quad);
        uint4 v;
        if constexpr (!F32) {
          uint32_t in[4], got[4];
#pragma unroll
          for (int jb = 0; jb < 4; ++jb)
            in[jb] = pack_bf16(acc[4 * (4 * j + jb) + 2 * h], acc[4 * (4 * j + jb) + 2 * h + 1]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            got[k] = __shfl_xor_sync(0xffffffffu, pick(in[0], in[1], in[2], in[3], quad ^ k), k);
          // column pair c of the block came from lane c, i.e. got[c ^ quad]
          v = make_uint4(pick(got[0], got[1], got[2], got[3], quad),
                         pick(got[0], got[1], got[2], got[3], 1 ^ quad),
                         pick(got[0], got[1], got[2], got[3], 2 ^ quad),
                         pick(got[0], got[1], got[2], got[3], 3 ^ quad));
        } else {
          float lo[4], hi[4], glo[4], ghi[4];
#pragma unroll
          for (int jb = 0; jb < 4; ++jb) {
            lo[jb] = acc[4 * (4 * j + jb) + 2 * h];
            hi[jb] = acc[4 * (4 * j + jb) + 2 * h + 1];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            glo[k] = __shfl_xor_sync(0xffffffffu, pickf(lo[0], lo[1], lo[2], lo[3], quad ^ k), k);
            ghi[k] = __shfl_xor_sync(0xffffffffu, pickf(hi[0], hi[1], hi[2], hi[3], quad ^ k), k);
          }
          float y[8];  // pair c came from lane c, i.e. glo/ghi[c ^ quad]; + pre_res
          const bf16* r = reinterpret_cast<const bf16*>(&rows[jj][h]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            y[2 * c] = pickf(glo[0], glo[1], glo[2], glo[3], c ^ quad) + __bfloat162float(r[2 * c]);
            y[2 * c + 1] =
                pickf(ghi[0], ghi[1], ghi[2], ghi[3], c ^ quad) + __bfloat162float(r[2 * c + 1]);
          }
          if constexpr (OP == Op::kDgrad)
            if (fold[h].mask && row < p.P && n < p.N) add_fold(p, fold[h], n, y);
          v = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                         pack_bf16(y[6], y[7]));
        }
        if (row < p.P && n < p.N) finish8(p, v, bias[jj], rows[jj][h], row, n);
      }
    }
  }
}

template <Op OP>
__device__ __forceinline__ void epilogue(const Params& p, float (&acc)[128], int64_t q, int n0,
                                         int quad) {
  if constexpr (OP == Op::kConv) {
    epilogue_tile<OP, false>(p, acc, q, n0, quad);
  } else {  // one straight-line body per case: no branch inside the unrolled loops
    if (p.pre_res || p.fold) epilogue_tile<OP, true>(p, acc, q, n0, quad);
    else epilogue_tile<OP, false>(p, acc, q, n0, quad);
  }
}

// `wmap`, `amap`: B and A (K3, K5: A with a_tma only, the image as [B H, W,
// C] in 64-channel x 64-pixel boxes); K2 also `wmap2`, `amap2` (a2, W2)
template <Op OP>
__device__ __forceinline__ void run(const CUtensorMap& wmap, const CUtensorMap& amap,
                                    const CUtensorMap& wmap2, const CUtensorMap& amap2,
                                    const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Ring<S>& ring = *reinterpret_cast<Ring<S>*>(smem + S * STAGE);
  int4* table = reinterpret_cast<int4*>(smem + S * STAGE + sizeof(Ring<S>));
  // K3's reflect or replicate edges are patched after A lands; with zeros
  // K3 patches nothing, but keeps the one flow
  constexpr bool kPatch = OP == Op::kConv;

  const int64_t P = p.P;
  const int col_tiles = (p.N + BN - 1) / BN;
  const int items = (int)((P + BM - 1) / BM) * col_tiles;  // row tiles x column tiles
  const int ksteps = OP == Op::kPointwise ? p.chunks1 + p.chunks2 : 9 * p.chunks1;
  if (threadIdx.x == 0) ring.init(p.a_tma ? 1 : kProducers, kConsumers / 32);
  __syncthreads();

  if (threadIdx.x >= kConsumers && p.a_tma) {
    // ------------------------------------------------- producer, A by TMA
    // warp 0's lane 0 issues every box; for K3, warp 1 patches the frame
    // edges of A's boxes once they land and publishes the stage
    producer_regs();
    const int pw = (threadIdx.x - kConsumers) / 32, lane = threadIdx.x % 32;
    if (pw == 0 ? lane == 0 : kPatch && pw == 1) {
      const int64_t HW = (int64_t)p.H * p.W;
      int i = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int64_t q0 = (int64_t)(item / col_tiles) * BM;
        const int n0 = (item % col_tiles) * BN;
        // K3, K5: each 64-pixel half of the tile lies in one frame row (W %
        // 64 == 0): its image, row and first column; a half past the frame
        // reads zeros
        int img[2] = {0, 0}, y[2] = {0, 0}, x0[2] = {0, 0};
        if constexpr (OP != Op::kPointwise) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t q = q0 + 64 * h;
            const int64_t b = q / HW, r = q - b * HW;
            img[h] = q < P ? (int)b : p.B;
            y[h] = (int)(r / p.W);
            x0[h] = (int)(r % p.W);
          }
        }
        int ky = 0, kx = 0, cc = 0;  // K2: ky is the operand
        for (int s = 0; s < ksteps; ++s, ++i) {
          unsigned char* slot = smem + (i % S) * STAGE;
          if (pw == 0) {
            wait_slot_free(ring, i);
            uint64_t* bar = kPatch ? &ring.landed[i % S] : &ring.full[i % S];
#if PHT_SM90_DIAG != 2
            mbar_arrive_expect_tx(bar, A_BYTES);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t dst = smem_u32(slot) + h * 8192;
              if constexpr (OP == Op::kPointwise) {
                tma_load_2d(dst, ky ? &amap2 : &amap, cc * BK, (int)(q0 + 64 * h), bar);
              } else if constexpr (OP == Op::kConv) {
                // the tap's row, remapped at the frame edge (zeros: a row
                // past every image, which TMA fills with zeros)
                int yy = y[h] + ky - 1;
                const int row = pad_index(yy, p.H, p.pad_mode) && img[h] < p.B
                                    ? img[h] * p.H + yy : p.B * p.H;
                tma_load_3d(dst, &amap, cc * BK, x0[h] + kx - 1, row, bar);
              } else {
                // the source row of the reversed tap; outside the frame, zeros
                const int yy = y[h] + 1 - ky;
                const int row = yy >= 0 && yy < p.H && img[h] < p.B ? img[h] * p.H + yy
                                                                     : p.B * p.H;
                tma_load_3d(dst, &amap, cc * BK, x0[h] + 1 - kx, row, bar);
              }
            }
#else
            mbar_arrive(bar);
#endif
            const uint32_t bdst = smem_u32(slot) + A_BYTES;
            if constexpr (OP == Op::kPointwise)
              load_b(ring, i, bdst, ky ? &wmap2 : &wmap, n0, cc * BK);
            else if constexpr (OP == Op::kConv)
              load_b(ring, i, bdst, &wmap, n0, (3 * ky + kx) * p.C + cc * BK);
            else  // rows tap * N + n0.. of W, K (its n) at cc * BK
              load_b(ring, i, bdst, &wmap, cc * BK, (3 * ky + kx) * p.N + n0, true);
          } else if constexpr (kPatch) {
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
          if constexpr (OP == Op::kPointwise) {
            if (++cc == (ky ? p.chunks2 : p.chunks1)) {
              cc = 0;
              ++ky;
            }
          } else if (++cc == p.chunks1) {
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
    // (K3, K5 only: K2's A always comes by TMA)
    producer_regs();
    if constexpr (OP != Op::kPointwise) {
      const int pt = threadIdx.x - kConsumers;
      const int cv = pt % 8;  // A: this thread's 8 channels of a chunk
      // K5's main passes read only in-frame sources (zero padding); the fold
      // lines come from the pre-pass
      const int a_pad = OP == Op::kDgrad ? kZeros : p.pad_mode;
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
          const int oy = OP == Op::kDgrad ? 1 - ky : ky - 1;
          const int ox = OP == Op::kDgrad ? 1 - kx : kx - 1;
#if PHT_SM90_DIAG != 2
#pragma unroll 4
          for (int j = 0; j < A_PER; ++j) {  // A: channels c..c+7 of a pixel
            const int px = pt / 8 + (kProducers / 8) * j;
            const int4 e = tab[px];
            int yy = e.y + oy, xx = e.z + ox;
            const bool ok = e.w && chan_ok && pad_index(yy, p.H, a_pad) &&
                            pad_index(xx, p.W, a_pad);
            const bf16* src = ok ? p.x + ((int64_t)(e.x + yy) * p.W + xx) * p.C + c : p.x;
            cp_async16(slot + sw128(px, cv), src, ok);
          }
#endif
          cp_async_commit();
          if (pt == 0) {  // B: rows (tap, chunk) of W by TMA
            if constexpr (OP == Op::kConv)
              load_b(ring, i, slot + A_BYTES, &wmap, n0, (3 * ky + kx) * p.C + cc * BK);
            else
              load_b(ring, i, slot + A_BYTES, &wmap, cc * BK, (3 * ky + kx) * p.N + n0, true);
          }
          if (++cc == p.chunks1) {
            cc = 0;
            if (++kx == 3) {
              kx = 0;
              ++ky;
            }
          }
        }
      }
      publish_tail<S, LAG>(ring, i);
    }
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
        for (int k = 0; k < BK / 16; ++k) {
          if constexpr (OP == Op::kDgrad)  // B K-major: 256 rows of 128 bytes
            wgmma_m64n256k16<0, 0>(acc, make_desc(a + 32 * k, 16, 1024),
                                   make_desc(b + 32 * k, 16, 1024), s > 0 || k > 0);
          else
            wgmma_m64n256k16<0, 1>(acc, make_desc(a + 32 * k, 16, 1024),
                                   make_desc(b + 2048 * k, 8192, 1024), s > 0 || k > 0);
        }
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
      // columns for its rows r and r + 8
      const int64_t q = (int64_t)(item / col_tiles) * BM + 64 * wg + 16 * warp + lane / 4;
      const int n0 = (item % col_tiles) * BN;
#if PHT_SM90_DIAG != 3
      epilogue<OP>(p, acc, q, n0, quad);
#endif
    }
  }
}

// dynamic shared memory and one-wave grid of a body kernel: sets the
// kernel's shared-memory maximum (once) and returns the CTAs of one wave,
// capped at the work, or a negative CUDA error
template <typename... Args>
static inline int grid_of(void (*kernel)(Args...), bool& configured, int64_t items) {
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return -(int)err;
    configured = true;
  }
  const int wave = wave_ctas(kernel, SMEM);
  if (wave <= 0) return -(int)cudaErrorInvalidConfiguration;
  return (int)std::min<int64_t>(items, wave);
}

}  // namespace body
}  // namespace sm90
}  // namespace pht
