// One warpgroup's product through the layouts of sm90_gemm.cuh:
//     d[64, 256] = a[64, 64] . b[64, 256]   (bf16 in, f32 out, all row-major)
// as four m64n256k16 wgmmas, with A staged K-major (K3's A) or MN-major
// (K6's A) and B MN-major (the B of both), B stored by the threads or loaded
// by TMA in 64 x 64 boxes (as both kernels load it). A test holds it against
// a plain product: a descriptor, swizzle or fragment-order mismatch gives wrong
// numbers here before it gives them in a kernel. Test-only: no entry point
// of the port calls `pht_sm90_probe` (tests/test_torch_port_cuda.py does).

#include "common.cuh"
#include "sm90_gemm.cuh"

namespace {

using namespace pht;
using namespace pht::sm90;

__global__ void __launch_bounds__(128) probe_kernel(const __grid_constant__ CUtensorMap bmap,
                                                    const bf16* __restrict__ a,
                                                    const bf16* __restrict__ b,
                                                    float* __restrict__ d, int a_mn_major,
                                                    int b_tma) {
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
      tma_load_2d(smem_u32(bs) + box * 8192, &bmap, 64 * box, 0, &bar);
  }
  for (int i = t; i < 64 * 64; i += 128) {
    const int m = i / 64, k = i % 64;
    const uint32_t off = a_mn_major ? sw128(k, m / 8) + (m % 8) * 2 : sw128(m, k / 8) + (k % 8) * 2;
    *reinterpret_cast<bf16*>(as + off) = a[i];
  }
  for (int i = t; i < 64 * 256 && !b_tma; i += 128) {
    const int k = i / 256, n = i % 256;
    *reinterpret_cast<bf16*>(bs + (n / 64) * 8192 + sw128(k, (n % 64) / 8) + (n % 8) * 2) = b[i];
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
    const uint64_t db = make_desc(b0 + 2048 * j, 8192, 1024);
    if (a_mn_major)
      wgmma_m64n256k16<1, 1>(acc, make_desc(a0 + 2048 * j, 8192, 1024), db, 1);
    else
      wgmma_m64n256k16<0, 1>(acc, make_desc(a0 + 32 * j, 16, 1024), db, 1);
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

}  // namespace

extern "C" int pht_sm90_probe(const void* a, const void* b, void* d, int a_mn_major,
                              int b_tma, void* stream) {
  CUtensorMap bmap;
  const int err = make_tma_2d(&bmap, b, 64, 256);
  if (err) return err;
  probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      bmap, static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<float*>(d),
      a_mn_major, b_tma);
  return (int)cudaGetLastError();
}
