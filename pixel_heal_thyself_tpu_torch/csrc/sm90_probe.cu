// One warpgroup's product through the layouts of sm90_gemm.cuh:
//     d[64, 256] = a[64, 64] . b[64, 256]   (bf16 in, f32 out, all row-major)
// as four m64n256k16 wgmmas, with A staged K-major (K2's, K3's and K5's A) or
// MN-major (K6's A) and B MN-major (the B of K2, K3 and K6) or K-major (K5's
// B: W read with its n as K), B stored by the threads or loaded by TMA in
// 64 x 64 boxes (as the kernels load it). A test holds it against
// a plain product: a descriptor, swizzle or fragment-order mismatch gives wrong
// numbers here before it gives them in a kernel. Test-only: no entry point
// of the port calls `pht_sm90_probe` (tests/test_torch_port_cuda.py does).
//
// `pht_tf32x3_probe` does the same for tf32x3.cuh, the fragment product of
// K7's and K8's tensor-core bodies: d[64, 64] = a[64, 64] . b[64, 64] (f32,
// row-major) through load_a / load_b and three mma.sync passes (or, with
// passes 1, the one-pass tf32 product the split exists to avoid), which the
// test holds against an f64 product.

#include "common.cuh"
#include "sm90_gemm.cuh"
#include "tf32x3.cuh"

namespace {

using namespace pht;
using namespace pht::sm90;

__global__ void __launch_bounds__(128) probe_kernel(const __grid_constant__ CUtensorMap bmap,
                                                    const bf16* __restrict__ a,
                                                    const bf16* __restrict__ b,
                                                    float* __restrict__ d, int a_mn_major,
                                                    int b_tma, int b_k_major) {
  __shared__ __align__(1024) unsigned char smem[8192 + 32768];
  __shared__ uint64_t bar;
  unsigned char* as = smem;
  unsigned char* bs = smem + 8192;
  const int t = threadIdx.x;
  if (t == 0 && b_tma) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0 && b_tma) {
    mbar_arrive_expect_tx(&bar, 32768);
    for (int box = 0; box < 4; ++box)
      tma_load_2d(smem_u32(bs) + box * 8192, &bmap, b_k_major ? 0 : 64 * box,
                  b_k_major ? 64 * box : 0, &bar);
  }
  for (int i = t; i < 64 * 64; i += 128) {
    const int m = i / 64, k = i % 64;
    const uint32_t off = a_mn_major ? sw128(k, m / 8) + (m % 8) * 2 : sw128(m, k / 8) + (k % 8) * 2;
    *reinterpret_cast<bf16*>(as + off) = a[i];
  }
  for (int i = t; i < 64 * 256 && !b_tma; i += 128) {
    if (b_k_major) {  // b holds B^T [256, 64]: row n at n * 128
      const int n = i / 64, k = i % 64;
      *reinterpret_cast<bf16*>(bs + sw128(n, k / 8) + (k % 8) * 2) = b[i];
    } else {
      const int k = i / 256, n = i % 256;
      *reinterpret_cast<bf16*>(bs + (n / 64) * 8192 + sw128(k, (n % 64) / 8) + (n % 8) * 2) = b[i];
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (b_tma) mbar_wait(&bar, 0);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  const uint32_t a0 = smem_u32(as), b0 = smem_u32(bs);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t da = a_mn_major ? make_desc(a0 + 2048 * j, 8192, 1024)
                                   : make_desc(a0 + 32 * j, 16, 1024);
    if (b_k_major) {
      const uint64_t db = make_desc(b0 + 32 * j, 16, 1024);
      if (a_mn_major) wgmma_m64n256k16<1, 0>(acc, da, db, 1);
      else wgmma_m64n256k16<0, 0>(acc, da, db, 1);
    } else {
      const uint64_t db = make_desc(b0 + 2048 * j, 8192, 1024);
      if (a_mn_major) wgmma_m64n256k16<1, 1>(acc, da, db, 1);
      else wgmma_m64n256k16<0, 1>(acc, da, db, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  const int row = 16 * (t / 32) + (t % 32) / 4, col = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d[(row + 8 * (i / 2)) * 256 + 8 * j + col + i % 2] = acc[4 * j + i];
}

__global__ void __launch_bounds__(128) tf32x3_probe_kernel(const float* __restrict__ a,
                                                          const float* __restrict__ b,
                                                          float* __restrict__ d, int passes) {
  using namespace pht::tf32;
  const int r0 = 16 * (threadIdx.x / 32);
  float acc[8][4] = {};
  for (int k0 = 0; k0 < 64; k0 += 8) {
    const FragA fa = load_a([&](int r, int k) { return a[r * 64 + k]; }, r0, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const FragB fb = load_b([&](int k, int c) { return b[k * 64 + c]; }, k0, 8 * j);
      if (passes == 3) mma3(acc[j], fa, fb);
      else mma(acc[j], fa.hi, fb.hi);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[acc_row(r0, i) * 64 + acc_col(8 * j, i)] = acc[j][i];
}

}  // namespace

// a, b, d [64, 64] f32 row-major; passes 3 (3xTF32) or 1 (one tf32 pass)
extern "C" int pht_tf32x3_probe(const void* a, const void* b, void* d, int passes, void* stream) {
  tf32x3_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(d), passes);
  return (int)cudaGetLastError();
}

// b: B [64, 256] row-major, or with b_k_major B^T [256, 64] row-major
extern "C" int pht_sm90_probe(const void* a, const void* b, void* d, int a_mn_major,
                              int b_tma, int b_k_major, void* stream) {
  CUtensorMap bmap;
  const int err = b_k_major ? make_tma_2d(&bmap, b, 256, 64) : make_tma_2d(&bmap, b, 64, 256);
  if (err) return err;
  probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      bmap, static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<float*>(d),
      a_mn_major, b_tma, b_k_major);
  return (int)cudaGetLastError();
}
