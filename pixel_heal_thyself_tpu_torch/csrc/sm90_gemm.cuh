// Hopper (sm_90a) building blocks of the port's wgmma kernels: the shared-
// memory ring's mbarriers, 16-byte cp.async copies with zero fill, the
// 128-byte-swizzled operand layouts and their wgmma descriptors, and the
// m64n256k16 bf16 wgmma with f32 accumulators. The body of K2, K3 and K5
// (sm90_body.cuh) and K6's (wgrad_sm90.cu) include it; sm90_probe.cu holds
// the layouts against a plain product on one tile.
//
// Operand layouts (bf16, 128-byte swizzle; an "atom" is 8 rows of 128 bytes,
// 1,024-byte aligned, whose 16-byte chunk c of row r sits at chunk c ^ (r % 8)):
//   K-major:  each of the 64 M rows (256 N rows: K5's B) holds 64 K values
//             (128 bytes) at r * 128; descriptor SBO = 1,024 (the next 8
//             rows); a k16 step adds 32 bytes.
//   MN-major: each K row holds 64 M/N values (128 bytes) at k * 128; wider
//             operands repeat the 64-value column block every `mn_block` bytes
//             (LBO), SBO = 1,024 (the next 8 K rows); a k16 step adds 2,048 bytes.
// wgmma reads an MN-major bf16 operand through its transpose flag.
#pragma once

#include <cuda.h>  // CUtensorMap (the driver's encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace pht {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// generic-proxy writes (cp.async, st.shared) → visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier over `threads` threads (id 0 is __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- cp.async ----------------------------------------------------------------

// 16 bytes global → shared; `valid` false writes 16 zero bytes (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// box (c0, c1) of a 2-D tensor map → shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// box (c0, c1, c2) of a 3-D tensor map → shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// A tensor map of a contiguous bf16 tensor of `rank` dims (innermost first,
// the innermost a multiple of 8) in boxes of 64 x 64 (x 1): the 64 innermost
// values (128 bytes) of 64 rows, 128-byte swizzled, so that each box lands as
// one 8 KB block of the layouts above (MN-major or K-major alike). Reads
// outside the tensor fill zeros. The driver's encoder comes through the
// runtime, so the library links no driver library. Returns a CUDA error code.
static inline int make_tma(CUtensorMap* map, const void* base, int rank,
                           const uint64_t* dims) {
  typedef CUresult (*Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                             const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                             const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                             CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  cuuint64_t d[3], strides[2];
  cuuint32_t box[3], unit[3];
  uint64_t stride = 2;
  for (int k = 0; k < rank; ++k) {
    d[k] = dims[k];
    box[k] = k < 2 ? 64 : 1;
    unit[k] = 1;
    stride *= dims[k];
    if (k + 1 < rank) strides[k] = stride;
  }
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                              const_cast<void*>(base), d, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a row-major [rows, cols] matrix
static inline int make_tma_2d(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols) {
  const uint64_t dims[2] = {cols, rows};
  return make_tma(map, base, 2, dims);
}

// ---- layouts and descriptors -----------------------------------------------

// byte offset of 16-byte chunk `chunk` (0..7) of 128-byte row `row` in a
// swizzled block whose rows start at row * 128
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the accumulator registers live across wgmma_wait (no reordering)
__device__ __forceinline__ void fence_regs(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] (+)= A[64 x 16] . B[16 x 256], bf16 in, f32 accumulate. TA /
// TB: the operand is MN-major (1) or K-major (0). `accumulate` 0 overwrites d.
// Thread t of the warpgroup holds, for each 8-column block j, d[4j + i] at
// row 16 (t / 32) + (t % 32) / 4 + 8 (i / 2), column 8 j + 2 (t % 4) + i % 2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TA), "n"(TB));
}

// ---- the ring ----------------------------------------------------------------

// The warp-specialized layout of the Hopper bodies: two consumer warpgroups and a
// producer warpgroup, whose setmaxnreg moves registers to the consumers: their
// 128 f32 accumulators would otherwise spill under the 168 a 384-thread CTA
// gets. When both operands come by TMA, one producer thread issues every copy;
// the others serve the cp.async gather of the shapes TMA cannot take, each
// keeping kLag stages in flight. PHT_SM90_DIAG (a diagnostic build,
// bench_sm90.py): 1 skips the wgmmas, 2 skips the copies, 3 skips the
// epilogue of the body of K2, K3 and K5 (sm90_body.cuh).
#ifndef PHT_SM90_DIAG
#define PHT_SM90_DIAG 0
#endif
constexpr int kRingSlots = 4, kLag = 3;
constexpr int kConsumers = 256, kProducers = 128;
constexpr int kThreads = kConsumers + kProducers;

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
}

// Stage i of a ring of S slots: slot i % S, waited on with parity (i / S) & 1.
// full[s] counts `producers` arrivals and one more, the arrival that expects
// B's TMA bytes: with the cp.async gather, one per producer thread (once its
// copies of the stage have landed and been fenced for the async proxy); with
// A by TMA (producers = 1), the patching warp's, once A's boxes have landed
// (landed[s], which expects their bytes) and their frame edges are patched,
// or, where nothing is patched (K2, K5), the arrival that expects A's bytes.
// empty[s] counts the consumer warps (lane 0 of each arrives once its wgmmas
// on the slot are done).
template <int S> struct Ring {
  uint64_t full[S];
  uint64_t empty[S];
  uint64_t landed[S];  // A by TMA: its boxes landed, not yet edge-patched

  __device__ __forceinline__ void init(int producers, int consumer_warps) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], producers + 1);
      mbar_init(&empty[s], consumer_warps);
      mbar_init(&landed[s], 1);
    }
    mbar_init_fence();
  }
};

// Reflect and replicate padding under TMA, which fills only zeros: a box of
// 64 pixels of one frame row, shifted by the tap's column offset, reads
// zeros for the one pixel left (dx = -1 at x = 0) or right (dx = +1 at
// x = W - 1) of the frame. `edge_source` says which pixel of the box holds
// the value that padding mode puts there (-1: nothing to patch).
__device__ __forceinline__ int edge_source(int pixel, int mode) {
  if (mode == kZeros) return -1;
  const int step = mode == kReflect ? 2 : 1;
  return pixel == 0 ? step : 63 - step;
}

// copy 128-byte row `src` over row `dst` of a 128-byte-swizzled block
// (lanes 0..7 of a warp, 16 bytes each)
__device__ __forceinline__ void patch_row(unsigned char* block, int dst, int src, int lane) {
  if (lane < 8)
    *reinterpret_cast<uint4*>(block + sw128(dst, lane)) =
        *reinterpret_cast<const uint4*>(block + sw128(src, lane));
}

// The gathering producer's side of stage i, called before it waits for slot
// i % S and issues the stage (one commit group per stage): once its copies
// of stage i - LAG have landed, they are fenced for wgmma and published.
// Publishing before the wait for a free slot keeps a slow consumer from
// delaying a stage that has already landed. LAG < S, or the producer would
// wait for the slot that the consumers wait to see published.
template <int S, int LAG>
__device__ __forceinline__ void publish(Ring<S>& ring, int i) {
  static_assert(LAG >= 1 && LAG < S, "the ring needs 1 <= LAG < S");
  if (i >= LAG) {
    cp_async_wait<LAG - 1>();
    fence_proxy_async();
    mbar_arrive(&ring.full[(i - LAG) % S]);
  }
}

// ... and after its last stage n - 1: publish the last LAG stages
template <int S, int LAG>
__device__ __forceinline__ void publish_tail(Ring<S>& ring, int n) {
  cp_async_wait<0>();
  fence_proxy_async();
  for (int i = n - LAG < 0 ? 0 : n - LAG; i < n; ++i) mbar_arrive(&ring.full[i % S]);
}

// the producer may overwrite slot i % S once the consumers released stage i - S
template <int S>
__device__ __forceinline__ void wait_slot_free(Ring<S>& ring, int i) {
  if (i >= S) mbar_wait(&ring.empty[i % S], ((i / S) & 1) ^ 1);
}

template <int S>
__device__ __forceinline__ void wait_slot_full(Ring<S>& ring, int i) {
  mbar_wait(&ring.full[i % S], (i / S) & 1);
}

// a consumer warp releases stage i (its wgmmas on the slot have completed)
template <int S>
__device__ __forceinline__ void release(Ring<S>& ring, int i) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(&ring.empty[i % S]);
}

// B of stage i by TMA: four 64 x 64 boxes at columns c0 + 64 box, row c1
// (MN-major B: 64 K rows of 256 columns), or with `k_major` at column c0,
// rows c1 + 64 box (K-major B: 256 rows of 64 K values, each box 64 rows),
// into the slot's B block at `dst`
template <int S>
__device__ __forceinline__ void load_b(Ring<S>& ring, int i, uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, bool k_major = false) {
  uint64_t* bar = &ring.full[i % S];
#if PHT_SM90_DIAG == 2
  mbar_arrive(bar);
#else
  mbar_arrive_expect_tx(bar, 4 * 8192);
#pragma unroll
  for (int box = 0; box < 4; ++box)
    tma_load_2d(dst + box * 8192, map, k_major ? c0 : c0 + 64 * box,
                k_major ? c1 + 64 * box : c1, bar);
#endif
}

// CTAs of `kernel` that one wave holds on the current device, at `smem` bytes
// of dynamic shared memory (set as the kernel's maximum first); -1 on error
template <typename... Params>
static inline int wave_ctas(void (*kernel)(Params...), int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return per_sm * sms;
}

}  // namespace sm90
}  // namespace pht
