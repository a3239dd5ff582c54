// Block-halo attention backward (kernel K4 of the PyTorch port).
//
// Replaces the TPU kernel `_bwd_kernel` in
// pixel_heal_thyself_tpu/ops/attention_pallas.py:383 (launched by
// `_attention_bwd_padded`, :561, pallas_call :592) and the attention stage
// of the whole-block backward (block_mega.py:351-399, inside `_bwd_kernel`
// :662), which computes the same math.
//
// What it computes, per (batch, block-row, block-col, head), with the
// forward's k_eff = round_T(k + bias), f32 logits * head_ch^-0.5 and f32
// softmax probabilities P (recomputed, not saved):
//   dattn = do . v^T                                  f32
//   dl    = round_T(P * (dattn - sum_j dattn * P))    f32, then rounded
//   dq    = round_T(dl . k_eff * scale)
//   dk_w  = dl^T . q * scale                          f32, per window
//   dv_w  = round_T(P)^T . do                         f32, per window
// Windows overlap (14 wide at stride 8 at prod), so a key pixel collects
// up to four windows' dk_w/dv_w (nine when halo > bs/2). A key outside the
// frame gets no dk/dv, but its dk_w still counts toward the bias gradient,
// which sums the f32 dk_w before rounding over windows and heads
// (attention_pallas.py:555-557); the wrapper splits it into drel_h (first
// half-channels summed over window columns) and drel_w.
//
// Hopper has no sequential grid to carry image accumulators in, and the
// reductions here are made deterministic without float atomics:
//   1. the main kernel: one CTA per (window, head) writes dq straight to
//      the image (queries do not overlap) and its f32 dk_w/dv_w to
//      per-window partial buffers [windows, nk, C];
//   2. `attention_bwd_gather_kernel`: each key pixel sums the partials of
//      the windows that hold it, in a fixed order, and rounds once (the TPU
//      kernel adds bf16-rounded window gradients in bf16; the port's plain
//      version follows this kernel);
//   3. `attention_bias_reduce_kernel` sums dk_w over groups of windows and
//      the heads, and `pht_sum_splits` (block_bwd.cu) sums the groups.
// A rerun on the card gives the same bits.
//
// Three main kernels. The tensor-core body (`attention_bwd_tc_kernel`, bf16,
// head_ch a multiple of 16 up to 64, block 4 or 8; the prod shape) is what
// the H100 runs. Its five window products (q.k_eff^T, do.v^T, dl.k_eff,
// dl^T.q, round(P)^T.do) are 5 x 64 x 196 x 64 multiply-adds a (window,
// head), bf16 operands exact in f32: 0.07 ms of the card's tensor-core rate
// over the 8,192 items of a prod call. With them on tensor cores, what
// bounds K4 is the partials' traffic (2 x 411 MB written here, read by the
// gather, and dk_w a third time by the bias reduce: about 0.6 ms of HBM
// against a 0.14 ms bound for the call; the gather reads them 16 bytes a
// thread) and, in the main kernel, latency at two CTAs an SM (255
// registers, 97 KB of shared memory at halo 3). The design: one CTA per
// (window, head), 4 warps of 16 query rows; q, do and v arrive by cp.async
// in row-skewed shared memory, k_eff through registers (the bias added and
// rounded on the way; for K4 faster than K1's cp.async and in-place pass,
// PERF.md). Each product is mma.sync m16n8k16 fed by ldmatrix. A warp keeps
// its rows' probabilities P in registers (16 x 208 f32 at halo 3): row max
// and sum by quad shuffles, then D = sum_j dattn * P from dattn tiles
// against the unrounded P, then per key tile dattn again, dl and round(P)
// packed to bf16 fragments; dl feeds dq = dl.k_eff straight from
// registers, and both go to shared memory in sub-chunks of 4 key tiles,
// where after a barrier each warp takes one key tile of dk_w = dl^T.q and
// dv_w = round(P)^T.do (ldmatrix .trans of the [query][key] tiles) and
// stores its f32 partial rows. No f32 P or dattn tile is ever in shared
// memory. Key-tile counts other than 3, 4, 7, 9, 13 and 16 (halo >= 5 at
// block 8) take the same body in three passes over the key tiles (row max
// and sum online, D, the gradients), recomputing the logits and dattn.
//
// The float32 body (`attention_bwd_f32_kernel`: fp32, head_ch a multiple of
// 4 up to 64, block 4 or 8, every halo) runs the five products in true f32
// FMAs, register-tiled (`attention_f32.cuh`): 8 warps, two a row group of 16
// query rows, each warp half of a chunk of up to 208 keys, each lane 4 rows
// x 13 slots. At the prod shape the window's 196 keys are one chunk, so it
// takes one pass: a lane turns its logits into P with the row statistics
// (shuffles over its 8 lanes, the two warps' halves exchanged through shared
// memory in a fixed order), computes dattn = do . v^T into as many
// registers, D = sum dattn * P the same way and dl = P (dattn - D) in place;
// dq = dl . k_eff is summed per lane 8 channels at a time and
// reduce-scattered over the 8 lanes into registers, the halves added at
// the end; P (over v's rows) and dl go to shared memory as [row][slot], and
// dk_w = dl^T . q * scale and dv_w = P^T . do come from one tile of 8 keys x
// 8 channels of both a thread, into the f32 partials (218 KB of shared
// memory, one CTA an SM). Windows of more than 208 keys (halo >= 4 at block 8) take
// three passes over their chunks (the row statistics online, D, the
// gradients), recomputing the logits and dattn. Its partials cost, at fp32
// as at bf16, 2 x 411 MB written here and read back by the gather (0.49 ms
// of the card's memory rate at prod).
//
// The general body (`attention_bwd_kernel`: shapes neither other body
// takes) runs the five products as scalar f32
// FMAs from shared memory: q, do, k_eff and v staged (rows padded to an
// odd word stride), the f32 probabilities and dattn/dl for all keys (bf16
// halo 3: 186 KB, one CTA per SM). When that plan does not fit (fp32, or
// large halos), the keys are walked in chunks in three passes (row max/sum,
// the row sums of dattn * P, then the gradients), recomputing each chunk's
// logits. Only f32 summation order differs between the bodies.

#include "attention_f32.cuh"
#include "attention_tc.cuh"
#include "common.cuh"

namespace {

using namespace pht;

constexpr int kThreads = 256;
constexpr int kRows = 8;  // rows per work item (register blocking)

// row stride (elements) of the staged q/do/k/v rows: an odd number of
// 32-bit words, so threads reading one column of consecutive rows hit
// distinct banks
template <typename T> __host__ __device__ constexpr int row_pad() { return sizeof(T) == 2 ? 2 : 1; }

// fixed part: f32 dq accumulator [nq][hd], row max/sum/D [3][nq], staged
// q and do [2][nq][ld]; per key of a chunk: k and v rows [2][ld] and the
// f32 P and dattn columns [2][nq]
size_t fixed_bytes(int nq, int hd, int ld, size_t elem) {
  return (size_t)nq * hd * 4 + 3 * (size_t)nq * 4 + 2 * (size_t)nq * ld * elem;
}
size_t key_bytes(int nq, int ld, size_t elem) {
  return 2 * (size_t)ld * elem + 2 * (size_t)nq * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w,
    const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ dk_part,
    float* __restrict__ dv_part, int H, int W, int C, int bs, int halo, int heads,
    float scale, int kc) {
  const int hd = C / heads, half = hd / 2;
  const int window = bs + 2 * halo;
  const int nq = bs * bs, nk = window * window;
  const int wb = W / bs, hb = H / bs;
  const int win = blockIdx.x;  // (b * hb + by) * wb + bx
  const int bx = win % wb, by = (win / wb) % hb, b = win / (wb * hb);
  const int c0 = blockIdx.y * hd;
  const int ld = hd + row_pad<T>();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nchunks = (nk + kc - 1) / kc;
  const bool resident = nchunks == 1;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_p = reinterpret_cast<float*>(smem);   // [nq][kc] logits -> P
  float* s_d = s_p + (size_t)nq * kc;             // [nq][kc] dattn -> dl
  float* s_dq = s_d + (size_t)nq * kc;            // [nq][hd] f32 dl . k
  float* s_m = s_dq + (size_t)nq * hd;            // [nq] row max
  float* s_l = s_m + nq;                          // [nq] row sum
  float* s_D = s_l + nq;                          // [nq] sum_j dattn * P
  T* s_q = reinterpret_cast<T*>(s_D + nq);        // [nq][ld]
  T* s_do = s_q + (size_t)nq * ld;                // [nq][ld]
  T* s_k = s_do + (size_t)nq * ld;                // [kc][ld] k_eff
  T* s_v = s_k + (size_t)kc * ld;                 // [kc][ld]

  const int64_t plane = (int64_t)H * W;
  auto qoff = [&](int i, int d) -> int64_t {
    const int y = by * bs + i / bs, x = bx * bs + i % bs;
    return ((b * plane) + (int64_t)y * W + x) * C + c0 + d;
  };
  for (int idx = tid; idx < nq * hd; idx += kThreads) {
    const int i = idx / hd, d = idx - i * hd;
    const int64_t off = qoff(i, d);
    s_q[i * ld + d] = q[off];
    s_do[i * ld + d] = dout[off];
    s_dq[idx] = 0.f;
  }
  for (int i = tid; i < nq; i += kThreads) {
    s_m[i] = -INFINITY;
    s_l[i] = 0.f;
    s_D[i] = 0.f;
  }

  const int ngroups = (nq + kRows - 1) / kRows;

  auto stage = [&](int j0, int n) {
    for (int idx = tid; idx < n * hd; idx += kThreads) {
      const int jj = idx / hd, d = idx - jj * hd;
      const int j = j0 + jj;
      const int wy = j / window, wx = j - wy * window;
      const int y = by * bs - halo + wy, x = bx * bs - halo + wx;
      const bool inside = y >= 0 && y < H && x >= 0 && x < W;
      const int64_t off = ((b * plane) + (int64_t)y * W + x) * C + c0 + d;
      const float kval = inside ? to_f32(k[off]) : 0.f;
      const float bias = d < half ? rel_h[wy * half + d] : rel_w[wx * half + d - half];
      s_k[jj * ld + d] = from_f32<T>(kval + bias);
      s_v[jj * ld + d] = inside ? v[off] : from_f32<T>(0.f);
    }
  };
  // dst[i][jj] = (a_i . b_jj) * mul for jj < n (a = q or do, b = k or v)
  auto rows_dot_keys = [&](const T* a, const T* bm, int n, float mul, float* dst) {
    for (int item = tid; item < ngroups * n; item += kThreads) {
      const int grp = item / n, jj = item - grp * n;
      const int i0 = grp * kRows;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float bv = to_f32(bm[jj * ld + d]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = min(i0 + r, nq - 1);  // clamped rows are discarded
          acc[r] = fmaf(to_f32(a[i * ld + d]), bv, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (i0 + r < nq) dst[(i0 + r) * kc + jj] = acc[r] * mul;
    }
  };
  // logits of chunk j0 into s_p, then (unless stats_only) P in place and
  // dattn into s_d
  auto recompute = [&](int j0, int n, bool stats_only) {
    __syncthreads();  // readers of the previous chunk are done
    stage(j0, n);
    __syncthreads();
    rows_dot_keys(s_q, s_k, n, scale, s_p);
    if (stats_only) return;
    rows_dot_keys(s_do, s_v, n, 1.f, s_d);
    __syncthreads();
    for (int idx = tid; idx < nq * n; idx += kThreads) {
      const int i = idx / n, jj = idx - i * n;
      float* p = s_p + (size_t)i * kc + jj;
      *p = expf(*p - s_m[i]) / s_l[i];
    }
  };

  // ---- pass A: row max and sum (online over chunks) ---------------------
  for (int j0 = 0; j0 < nk; j0 += kc) {
    const int n = min(kc, nk - j0);
    recompute(j0, n, true);
    __syncthreads();
    for (int i = warp; i < nq; i += kThreads / 32) {
      const float* row = s_p + (size_t)i * kc;
      float cm = -INFINITY;
      for (int j = lane; j < n; j += 32) cm = fmaxf(cm, row[j]);
      cm = warp_max(cm);
      const float m_new = fmaxf(s_m[i], cm);
      float s = 0.f;
      for (int j = lane; j < n; j += 32) s += expf(row[j] - m_new);
      s = warp_sum(s);
      if (lane == 0) {
        s_l[i] = s_l[i] * expf(s_m[i] - m_new) + s;
        s_m[i] = m_new;
      }
    }
  }

  // ---- pass B: D_i = sum_j dattn_ij * P_ij --------------------------------
  for (int j0 = 0; j0 < nk; j0 += kc) {
    const int n = min(kc, nk - j0);
    if (resident) {  // logits are still in s_p: P in place, dattn
      __syncthreads();
      rows_dot_keys(s_do, s_v, n, 1.f, s_d);
      for (int idx = tid; idx < nq * n; idx += kThreads) {
        const int i = idx / n, jj = idx - i * n;
        float* p = s_p + (size_t)i * kc + jj;
        *p = expf(*p - s_m[i]) / s_l[i];
      }
    } else {
      recompute(j0, n, false);
    }
    __syncthreads();
    for (int i = warp; i < nq; i += kThreads / 32) {
      float s = 0.f;
      for (int j = lane; j < n; j += 32) s += s_d[i * kc + j] * s_p[i * kc + j];
      s = warp_sum(s);
      if (lane == 0) s_D[i] += s;
    }
  }

  // ---- pass C: dl, dq += dl . k, dk_w, dv_w ------------------------------
  for (int j0 = 0; j0 < nk; j0 += kc) {
    const int n = min(kc, nk - j0);
    if (!resident) recompute(j0, n, false);
    __syncthreads();
    for (int idx = tid; idx < nq * n; idx += kThreads) {
      const int i = idx / n, jj = idx - i * n;
      const size_t o = (size_t)i * kc + jj;
      s_d[o] = round_to<T>(s_p[o] * (s_d[o] - s_D[i]));
    }
    __syncthreads();
    // P rounded to T for dv (dl has consumed the unrounded P)
    for (int idx = tid; idx < nq * n; idx += kThreads) {
      const int i = idx / n, jj = idx - i * n;
      float* p = s_p + (size_t)i * kc + jj;
      *p = round_to<T>(*p);
    }
    // dq[i][d] += sum_jj dl[i][jj] * k[jj][d]
    for (int item = tid; item < ngroups * hd; item += kThreads) {
      const int grp = item / hd, d = item - grp * hd;
      const int i0 = grp * kRows;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int jj = 0; jj < n; ++jj) {
        const float kv = to_f32(s_k[jj * ld + d]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = min(i0 + r, nq - 1);
          acc[r] = fmaf(s_d[i * kc + jj], kv, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (i0 + r < nq) s_dq[(i0 + r) * hd + d] += acc[r];
    }
    __syncthreads();  // the rounded P is complete
    // dk_w[jj][d] = sum_i dl[i][jj] q[i][d] * scale,
    // dv_w[jj][d] = sum_i round(P)[i][jj] do[i][d]
    const int jgroups = (n + kRows - 1) / kRows;
    for (int item = tid; item < 2 * jgroups * hd; item += kThreads) {
      const bool is_v = item >= jgroups * hd;
      const int it = is_v ? item - jgroups * hd : item;
      const int jg = it / hd, d = it - jg * hd;
      const int jj0 = jg * kRows;
      const float* wgt = is_v ? s_p : s_d;
      const T* rows = is_v ? s_do : s_q;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      for (int i = 0; i < nq; ++i) {
        const float a = to_f32(rows[i * ld + d]);
        const float* wr = wgt + (size_t)i * kc;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(wr[min(jj0 + r, n - 1)], a, acc[r]);
      }
      float* part = is_v ? dv_part : dk_part;
      const float mul = is_v ? 1.f : scale;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (jj0 + r >= n) break;
        part[((size_t)win * nk + j0 + jj0 + r) * C + c0 + d] = acc[r] * mul;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nq * hd; idx += kThreads) {
    const int i = idx / hd, d = idx - i * hd;
    dq[qoff(i, d)] = from_f32<T>(s_dq[idx] * scale);
  }
}


// ---- the tensor-core body -------------------------------------------------

// acc[n][i] = 0
__device__ __forceinline__ void zero(float (&acc)[attn::kMaxHead / 8][4]) {
#pragma unroll
  for (int n = 0; n < attn::kMaxHead / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

// the f32 partial rows of key tile t (keys < nk) of this window and head:
// part[win][key][c0 + d] = acc * mul
__device__ __forceinline__ void store_partial(const attn::Win& g,
                                              const float (&acc)[attn::kMaxHead / 8][4],
                                              float mul, int t, float* part) {
  const int lane = threadIdx.x & 31;
  const int key = 16 * t + (lane >> 2), col = g.c0 + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key + 8 * h >= g.nk) continue;
    float* row = part + ((size_t)g.win * g.nk + key + 8 * h) * g.C + col;
#pragma unroll
    for (int n = 0; n < attn::kMaxHead / 8; ++n)
      if (n < g.hd / 8)
        *reinterpret_cast<float2*>(row + 8 * n) =
            make_float2(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
  }
}

// NT > 0: the window's NT key tiles, each warp's probabilities held in
// registers; NT == 0: any count, three passes over the key tiles
template <int NT>
__global__ void __launch_bounds__(128, 2) attention_bwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w,
    const bf16* __restrict__ dout, bf16* __restrict__ dq, float* __restrict__ dk_part,
    float* __restrict__ dv_part, int H, int W, int C, int bs, int halo, int heads,
    float scale) {
  constexpr int kH8 = attn::kMaxHead / 8;
  const attn::Win g = attn::win_geom(H, W, C, bs, halo, heads);
  const int lds = attn::kSub * 16 + attn::kSkew;  // row stride of the dl / round(P) tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);      // [nq][ld]
  bf16* s_do = s_q + (size_t)g.nq * g.ld;          // [nq][ld]
  bf16* s_k = s_do + (size_t)g.nq * g.ld;          // [16 nt][ld] k, then k_eff
  bf16* s_v = s_k + (size_t)16 * g.nt * g.ld;      // [16 nt][ld]
  bf16* s_dl = s_v + (size_t)16 * g.nt * g.ld;     // [nq][lds] dl, kSub key tiles
  bf16* s_pr = s_dl + (size_t)g.nq * lds;          // [nq][lds] round(P)
  attn::stage_queries(g, q, s_q);
  attn::stage_queries(g, dout, s_do);
#if PHT_ATTN_DIAG != 3  // k through registers: the faster for K4
  attn::stage_keys(g, k, v, rel_h, rel_w, s_k, s_v);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
#else
  attn::stage_keys_async(g, k, v, s_k, s_v);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
  attn::add_bias(g, rel_h, rel_w, s_k);
#endif
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int hk = g.hd / 16, r0 = 16 * warp;
  const int row = r0 + (lane >> 2), col = 2 * (lane & 3);
  uint32_t qa[attn::kMaxHead / 16][4], da[attn::kMaxHead / 16][4];
  attn::load_rows(qa, s_q, g.ld, r0, hk);
  attn::load_rows(da, s_do, g.ld, r0, hk);
  // row statistics and D of rows g (index 0) and g + 8 (index 1)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  float dqa[kH8][4];
  zero(dqa);

  // P of key tile t from its logits and the final statistics
  auto probs = [&](int t, float (&p)[8]) {
    attn::logits(qa, s_k, g, t, scale, p);
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = expf(p[i] - m[(i >> 1) & 1]) / l[(i >> 1) & 1];
  };
  // D += sum over key tile t of dattn * P
  auto add_d = [&](int t, const float (&p)[8]) {
    float da_t[8];
    attn::rows_dot_keys(da, s_v, g.ld, t, hk, da_t);
#pragma unroll
    for (int i = 0; i < 8; ++i) dsum[(i >> 1) & 1] += da_t[i] * p[i];
  };
  // key tile t of sub-chunk sc: dl = round(P (dattn - D)) and round(P) into
  // the shared tiles, dq += dl . k_eff
  auto grads = [&](int t, int sc, const float (&p)[8]) {
    float dl[8];
    attn::rows_dot_keys(da, s_v, g.ld, t, hk, dl);
#pragma unroll
    for (int i = 0; i < 8; ++i) dl[i] = p[i] * (dl[i] - dsum[(i >> 1) & 1]);
    uint32_t dla[4], pra[4];
    attn::pack_tile(dl, dla);
    attn::pack_tile(p, pra);
    const int c = 16 * (t - sc) + col;
#pragma unroll
    for (int f = 0; f < 4; ++f) {  // (row, c), (row + 8, c), (row, c + 8), (row + 8, c + 8)
      const size_t o = (size_t)(row + 8 * (f & 1)) * lds + c + 8 * (f >> 1);
      *reinterpret_cast<uint32_t*>(s_dl + o) = dla[f];
      *reinterpret_cast<uint32_t*>(s_pr + o) = pra[f];
    }
    attn::times_rows(dla, s_k, g.ld, t, hk, dqa);
  };
  // after a barrier: each warp's key tiles of sub-chunk sc, dk_w = dl^T.q
  // * scale and dv_w = round(P)^T.do (the [query][key] tiles read by
  // ldmatrix .trans), to the partials
  auto key_grads = [&](int sc) {
    const int n = min(attn::kSub, g.nt - sc);
    for (int tt = warp; tt < n; tt += nwarps) {
      float acc[kH8][4];
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const bf16* a = which ? s_pr : s_dl;
        zero(acc);
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {  // 16 queries a step
          if (16 * kq >= g.nq) break;
          uint32_t at[4];
          attn::ldsm_x4_t(at, a + (size_t)(16 * kq + (lane & 7) + (lane >> 4) * 8) * lds +
                                  16 * tt + ((lane >> 3) & 1) * 8);
          attn::times_rows(at, which ? s_do : s_q, g.ld, kq, hk, acc);
        }
        store_partial(g, acc, which ? 1.f : scale, sc + tt, which ? dv_part : dk_part);
      }
    }
  };

  if constexpr (NT > 0) {
    float p[NT][8];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      attn::logits(qa, s_k, g, t, scale, p[t]);
#pragma unroll
      for (int i = 0; i < 8; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], p[t][i]);
    }
    m[0] = attn::quad_max(m[0]);
    m[1] = attn::quad_max(m[1]);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        p[t][i] = expf(p[t][i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += p[t][i];
      }
    l[0] = attn::quad_sum(l[0]);
    l[1] = attn::quad_sum(l[1]);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int i = 0; i < 8; ++i) p[t][i] /= l[(i >> 1) & 1];
      add_d(t, p[t]);
    }
    dsum[0] = attn::quad_sum(dsum[0]);
    dsum[1] = attn::quad_sum(dsum[1]);
#pragma unroll
    for (int sc = 0; sc < NT; sc += attn::kSub) {
#pragma unroll
      for (int t = sc; t < sc + attn::kSub && t < NT; ++t) grads(t, sc, p[t]);
      __syncthreads();
      key_grads(sc);
      __syncthreads();
    }
  } else {
#pragma unroll 1
    for (int t = 0; t < g.nt; ++t) {
      float s[8];
      attn::logits(qa, s_k, g, t, scale, s);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mt = fmaxf(fmaxf(s[2 * r], s[2 * r + 1]), fmaxf(s[4 + 2 * r], s[5 + 2 * r]));
        const float mn = fmaxf(m[r], mt);
        l[r] = l[r] * expf(m[r] - mn) + expf(s[2 * r] - mn) + expf(s[2 * r + 1] - mn) +
               expf(s[4 + 2 * r] - mn) + expf(s[5 + 2 * r] - mn);
        m[r] = mn;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mq = attn::quad_max(m[r]);
      l[r] = attn::quad_sum(l[r] * expf(m[r] - mq));
      m[r] = mq;
    }
#pragma unroll 1
    for (int t = 0; t < g.nt; ++t) {
      float p[8];
      probs(t, p);
      add_d(t, p);
    }
    dsum[0] = attn::quad_sum(dsum[0]);
    dsum[1] = attn::quad_sum(dsum[1]);
#pragma unroll 1
    for (int sc = 0; sc < g.nt; sc += attn::kSub) {
#pragma unroll 1
      for (int t = sc; t < sc + attn::kSub && t < g.nt; ++t) {
        float p[8];
        probs(t, p);
        grads(t, sc, p);
      }
      __syncthreads();
      key_grads(sc);
      __syncthreads();
    }
  }
  attn::store_rows(g, dqa, scale, s_q, nullptr, dq);
}

// ---- the float32 body ------------------------------------------------------

// TC > 0: TC key slots a lane (the prod shape); TC == 0: any count up to
// f32a::kMaxSlots
template <int TC>
__global__ void __launch_bounds__(256, 1) attention_bwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w,
    const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ dk_part,
    float* __restrict__ dv_part, int H, int W, int C, int bs, int halo, int heads,
    float scale) {
  using f32a::kLd;
  using f32a::kMaxSlots;
  using f32a::kPass;
  using f32a::kRows;
  constexpr int kPasses = f32a::kMaxHead / kPass;
  const attn::Win g = attn::win_geom(H, W, C, bs, halo, heads);
  const int T = TC > 0 ? TC : f32a::slots(g.nk, 2), ck = 16 * T, nc = f32a::chunks(g.nk, 2);
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);  // [nq][kLd]
  float* s_do = s_q + g.nq * kLd;               // [nq][kLd]
  float* s_k = s_do + g.nq * kLd;               // [ck][kLd] k, then k_eff
  float* s_v = s_k + ck * kLd;                  // [ck][kLd] v, then P [nq][ck]
  float* s_dl = s_v + ck * kLd;                 // [nq][ck] dl
  float* s_dq = s_dl + g.nq * ck;               // [nq][kLd] the second half's dq
  float* s_x = s_dq + g.nq * kLd;               // [2 halves][3][nq] row statistics
  float* s_p = s_v;
  // warp: its row group and the half of each chunk's slots it holds
  const int groups = g.nq / 16, warp = threadIdx.x >> 5;
  const int half = warp / groups, lane = threadIdx.x & 31, lk = lane & 7;
  const int r = 16 * (warp - half * groups) + (lane >> 3);  // rows r, r + 4, r + 8, r + 12
  const int slot0 = half * 8 * T + lk;  // the lane's first slot of a chunk
  const int npass = (g.hd + kPass - 1) / kPass;

  f32a::stage_queries(g, q, s_q);
  f32a::stage_queries(g, dout, s_do);
  // chunk j0's keys (and values, still in flight on return), after every
  // reader of the last chunk
  auto stage = [&](int j0, bool values) {
    __syncthreads();
    f32a::stage_keys(g, k, j0, ck, s_k);
    sm90::cp_async_commit();
    if (values) {
      f32a::stage_keys(g, v, j0, ck, s_v);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    f32a::add_bias(g, rel_h, rel_w, j0, ck, s_k);
    __syncthreads();
  };
  // the sum of a row value over the two halves, in a fixed order (which: the
  // exchange slot; every thread calls it, a barrier inside)
  auto both_halves = [&](float (&x)[kRows], int which, bool is_max) {
    if (lk == 0)
#pragma unroll
      for (int i = 0; i < kRows; ++i) s_x[(half * 3 + which) * g.nq + r + 4 * i] = x[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float a = s_x[which * g.nq + r + 4 * i], b = s_x[(3 + which) * g.nq + r + 4 * i];
      x[i] = is_max ? fmaxf(a, b) : a + b;
    }
  };

  float m[kRows], l[kRows], dsum[kRows], dqa[kRows][kPasses];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = dsum[i] = 0.f;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) dqa[i][p] = 0.f;
  }
  float s[kRows][kMaxSlots], da[kRows][kMaxSlots];
  // one chunk: one pass; more: 0 the row statistics, 1 D, 2 the gradients
  for (int pass = nc == 1 ? 2 : 0; pass < 3; ++pass) {
    for (int c = 0; c < nc; ++c) {
      const int j0 = c * ck, n = min(ck, g.nk - j0);
      stage(j0, pass > 0);
      f32a::dots<TC>(s_q, s_k + slot0 * kLd, r, T, g.hd, scale, s);
      f32a::mask_slots<TC>(slot0, T, n, s);
      if (pass == 0 || nc == 1) {  // the statistics, online over the chunks
        float mt[kRows], sum[kRows];
        f32a::row_max<TC>(s, T, mt);
        both_halves(mt, 0, true);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          mt[i] = fmaxf(m[i], mt[i]);
          l[i] *= expf(m[i] - mt[i]);
          m[i] = mt[i];
        }
        f32a::exp_rows<TC>(s, T, m, sum);  // s = exp(s - m)
        both_halves(sum, 1, false);
#pragma unroll
        for (int i = 0; i < kRows; ++i) l[i] += sum[i];
      }
      if (pass == 0) continue;
      // P from the final statistics (0 on the padded slots; one chunk: s
      // holds exp(s - m) already), dattn (0 there: v's padded rows are zero)
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float inv = 1.f / l[i];
#pragma unroll
        for (int t = 0; t < kMaxSlots; ++t)
          if (f32a::live<TC>(t, T)) s[i][t] = (nc == 1 ? s[i][t] : expf(s[i][t] - m[i])) * inv;
      }
      sm90::cp_async_wait<0>();  // v
      __syncthreads();
      f32a::dots<TC>(s_do, s_v + slot0 * kLd, r, T, g.hd, 1.f, da);
      if (pass == 1 || nc == 1) {  // D = sum over the keys of dattn * P
        float part[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float x = 0.f;
#pragma unroll
          for (int t = 0; t < kMaxSlots; ++t)
            if (f32a::live<TC>(t, T)) x += da[i][t] * s[i][t];
          part[i] = f32a::group_sum(x);
        }
        both_halves(part, 2, false);
#pragma unroll
        for (int i = 0; i < kRows; ++i) dsum[i] += part[i];
      }
      if (pass == 1) continue;
      // dl = P (dattn - D) in place
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int t = 0; t < kMaxSlots; ++t)
          if (f32a::live<TC>(t, T)) da[i][t] = s[i][t] * (da[i][t] - dsum[i]);
      __syncthreads();  // every warp's dattn has read v's rows: P goes there
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int t = 0; t < kMaxSlots; ++t) {
          if (f32a::live<TC>(t, T)) {
            s_p[(r + 4 * i) * ck + slot0 + 8 * t] = s[i][t];
            s_dl[(r + 4 * i) * ck + slot0 + 8 * t] = da[i][t];
          }
        }
      }
      // dq += dl . k_eff: the lane's slots, reduce-scattered over the row
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        if (p < npass) {
          float acc[kRows][kPass], part[kRows];
          f32a::times_keys<TC>(da, s_k + slot0 * kLd, T, kPass * p, g.hd, acc);
          f32a::reduce_scatter(acc, lk, part);
#pragma unroll
          for (int i = 0; i < kRows; ++i) dqa[i][p] += part[i];
        }
      }
      __syncthreads();  // P and dl are complete
      // dk_w = dl^T . q * scale and dv_w = P^T . do: a thread takes both
      // products' tiles of 8 keys x 8 channels (4 dg.. and 32 + 4 dg..),
      // over the rows
      const int ngk = PHT_F32_DIAG == 1 || PHT_F32_DIAG == 3 ? 0 : ck / 8;
      for (int tile = threadIdx.x; tile < ngk * 8; tile += blockDim.x) {
        const int dg = tile & 7, jj = 8 * (tile >> 3), d0 = 4 * dg, d1 = 32 + 4 * dg;
        if (jj >= n || d0 >= g.hd) continue;
        const bool hi = d1 < g.hd;
        float ak[8][8], av[8][8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int f = 0; f < 8; ++f) ak[e][f] = av[e][f] = 0.f;
#pragma unroll 2  // 1 ran as fast, 4 slower (PERF.md)
        for (int rr = 0; rr < g.nq; ++rr) {
          const float* wl = s_dl + rr * ck + jj;
          const float* wp = s_p + rr * ck + jj;
          const float4 l0 = *reinterpret_cast<const float4*>(wl);
          const float4 l1 = *reinterpret_cast<const float4*>(wl + 4);
          const float4 p0 = *reinterpret_cast<const float4*>(wp);
          const float4 p1 = *reinterpret_cast<const float4*>(wp + 4);
          const float4 q0 = *reinterpret_cast<const float4*>(s_q + rr * kLd + d0);
          const float4 o0 = *reinterpret_cast<const float4*>(s_do + rr * kLd + d0);
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 q1 = hi ? *reinterpret_cast<const float4*>(s_q + rr * kLd + d1) : zero;
          const float4 o1 = hi ? *reinterpret_cast<const float4*>(s_do + rr * kLd + d1) : zero;
          const float wk[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
          const float wv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
          const float xq[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
          const float xo[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e)
#pragma unroll
            for (int f = 0; f < 8; ++f) {
              ak[e][f] = fmaf(wk[e], xq[f], ak[e][f]);
              av[e][f] = fmaf(wv[e], xo[f], av[e][f]);
            }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (jj + e >= n) break;
          const size_t row = ((size_t)g.win * g.nk + j0 + jj + e) * g.C + g.c0;
          float* rk = dk_part + row;
          float* rv = dv_part + row;
          *reinterpret_cast<float4*>(rk + d0) = make_float4(
              ak[e][0] * scale, ak[e][1] * scale, ak[e][2] * scale, ak[e][3] * scale);
          *reinterpret_cast<float4*>(rv + d0) = make_float4(av[e][0], av[e][1], av[e][2], av[e][3]);
          if (hi) {
            *reinterpret_cast<float4*>(rk + d1) = make_float4(
                ak[e][4] * scale, ak[e][5] * scale, ak[e][6] * scale, ak[e][7] * scale);
            *reinterpret_cast<float4*>(rv + d1) =
                make_float4(av[e][4], av[e][5], av[e][6], av[e][7]);
          }
        }
      }
    }
  }
  // dq = (the first half's dl . k_eff + the second's) * scale
  if (half == 1)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int p = 0; p < kPasses; ++p)
        if (p < npass) s_dq[(r + 4 * i) * kLd + kPass * p + lk] = dqa[i][p];
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t row = attn::query_pixel(g, r + 4 * i) * g.C + g.c0;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int d = kPass * p + lk;
        if (d < g.hd) dq[row + d] = (dqa[i][p] + s_dq[(r + 4 * i) * kLd + d]) * scale;
      }
    }
  }
}

template <int TC>
int launch_f32_main(const float* q, const float* k, const float* v, const float* rel_h,
                    const float* rel_w, const float* dout, float* dq, float* dk_part,
                    float* dv_part, int nwin, int H, int W, int C, int bs, int halo, int heads,
                    float scale, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_f32_kernel<TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_f32_kernel<TC><<<dim3((unsigned)nwin, (unsigned)heads), 4 * bs * bs, smem,
                                 stream>>>(q, k, v, rel_h, rel_w, dout, dq, dk_part, dv_part, H,
                                           W, C, bs, halo, heads, scale);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_tc_main(const bf16* q, const bf16* k, const bf16* v, const float* rel_h,
                   const float* rel_w, const bf16* dout, bf16* dq, float* dk_part,
                   float* dv_part, int nwin, int H, int W, int C, int bs, int halo, int heads,
                   float scale, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_tc_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_tc_kernel<NT><<<dim3((unsigned)nwin, (unsigned)heads), 2 * bs * bs, smem,
                                stream>>>(q, k, v, rel_h, rel_w, dout, dq, dk_part, dv_part, H,
                                          W, C, bs, halo, heads, scale);
  return (int)cudaGetLastError();
}

// dst[0..V) = round(x)
template <typename T, int V>
__device__ __forceinline__ void store_rounded(T* dst, const float (&x)[V]) {
  if constexpr (V == 4 && sizeof(T) == 2) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                *reinterpret_cast<const uint32_t*>(&hi));
  } else if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) dst[e] = from_f32<T>(x[e]);
  }
}

// dk/dv[b, y, x, c] = round(sum over the windows holding (y, x) of the
// partials), windows in raster order; V channels a thread (4 when C allows:
// 16-byte loads of the partials)
template <typename T, int V>
__global__ void attention_bwd_gather_kernel(const float* __restrict__ dk_part,
                                            const float* __restrict__ dv_part,
                                            T* __restrict__ dk, T* __restrict__ dv, int B,
                                            int H, int W, int C, int bs, int halo) {
  const int cv = C / V;
  const int64_t total = (int64_t)B * H * W * cv;
  const int window = bs + 2 * halo;
  const int nk = window * window;
  const int wb = W / bs, hb = H / bs;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % cv) * V;
    int64_t pix = idx / cv;
    const int x = (int)(pix % W);
    pix /= W;
    const int y = (int)(pix % H);
    const int b = (int)(pix / H);
    // windows by with by*bs - halo <= y < by*bs + bs + halo
    const int by_lo = max(0, (y - bs - halo + bs) / bs), by_hi = min(hb - 1, (y + halo) / bs);
    const int bx_lo = max(0, (x - bs - halo + bs) / bs), bx_hi = min(wb - 1, (x + halo) / bs);
    float sk[V], sv[V];
#pragma unroll
    for (int e = 0; e < V; ++e) sk[e] = sv[e] = 0.f;
    for (int by = by_lo; by <= by_hi; ++by) {
      const int wy = y - by * bs + halo;
      if (wy < 0 || wy >= window) continue;
      for (int bx = bx_lo; bx <= bx_hi; ++bx) {
        const int wx = x - bx * bs + halo;
        if (wx < 0 || wx >= window) continue;
        const size_t off = (((size_t)(b * hb + by) * wb + bx) * nk + wy * window + wx) * C + c;
        if constexpr (V == 4) {
          const float4 k4 = __ldg(reinterpret_cast<const float4*>(dk_part + off));
          const float4 v4 = __ldg(reinterpret_cast<const float4*>(dv_part + off));
          sk[0] += k4.x; sk[1] += k4.y; sk[2] += k4.z; sk[3] += k4.w;
          sv[0] += v4.x; sv[1] += v4.y; sv[2] += v4.z; sv[3] += v4.w;
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            sk[e] += dk_part[off + e];
            sv[e] += dv_part[off + e];
          }
        }
      }
    }
    store_rounded<T, V>(dk + idx * V, sk);
    store_rounded<T, V>(dv + idx * V, sv);
  }
}

// part[g][j][d] = sum over windows [g*group, (g+1)*group) and heads of
// dk_part[w][j][h*hd + d]
__global__ void attention_bias_reduce_kernel(const float* __restrict__ dk_part,
                                             float* __restrict__ part, int nwin, int nk,
                                             int C, int heads, int group) {
  const int hd = C / heads;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nk * hd) return;
  const int j = t / hd, d = t - j * hd;
  const int g = blockIdx.y;
  const int w1 = min(nwin, (g + 1) * group);
  float s = 0.f;
  for (int w = g * group; w < w1; ++w) {
    const float* src = dk_part + ((size_t)w * nk + j) * C + d;
    for (int h = 0; h < heads; ++h) s += src[h * hd];
  }
  part[(size_t)g * nk * hd + t] = s;
}

// the gather of dk/dv and the first level of the bias reduction (both bodies)
template <typename T>
int reduce_partials(const float* dk_part, const float* dv_part, float* bias_part,
                    int bias_group, void* dk, void* dv, int B, int H, int W, int C, int bs,
                    int halo, int heads, cudaStream_t stream) {
  const int nk = (bs + 2 * halo) * (bs + 2 * halo), hd = C / heads;
  const int nwin = B * (H / bs) * (W / bs);
  const int vec = C % 4 == 0 ? 4 : 1;
  const int64_t total = (int64_t)B * H * W * C / vec;
  const int gblocks = (int)std::min<int64_t>((total + 255) / 256, 132 * 64);
  if (vec == 4)
    attention_bwd_gather_kernel<T, 4><<<gblocks, 256, 0, stream>>>(
        dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), B, H, W, C, bs, halo);
  else
    attention_bwd_gather_kernel<T, 1><<<gblocks, 256, 0, stream>>>(
        dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), B, H, W, C, bs, halo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ngroups = (nwin + bias_group - 1) / bias_group;
  attention_bias_reduce_kernel<<<dim3((unsigned)((nk * hd + 255) / 256), (unsigned)ngroups),
                                 256, 0, stream>>>(dk_part, bias_part, nwin, nk, C, heads,
                                                   bias_group);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* rel_h,
           const float* rel_w, const void* dout, void* dq, void* dk, void* dv,
           float* dk_part, float* dv_part, float* bias_part, int bias_group, int B, int H,
           int W, int C, int bs, int halo, int heads, float scale, cudaStream_t stream) {
  const int hd = C / heads;
  const int nq = bs * bs, nk = (bs + 2 * halo) * (bs + 2 * halo);
  const int ld = hd + row_pad<T>();
  const size_t fixed = fixed_bytes(nq, hd, ld, sizeof(T));
  const size_t per_key = key_bytes(nq, ld, sizeof(T));
  if (fixed + per_key > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int kc = (int)std::min<size_t>((size_t)nk, (kMaxSmem - fixed) / per_key);
  const size_t smem = fixed + per_key * kc;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nwin = B * (H / bs) * (W / bs);
  attention_bwd_kernel<T><<<dim3((unsigned)nwin, (unsigned)heads), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), rel_h,
      rel_w, static_cast<const T*>(dout), static_cast<T*>(dq), dk_part, dv_part, H, W, C,
      bs, halo, heads, scale, kc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return reduce_partials<T>(dk_part, dv_part, bias_part, bias_group, dk, dv, B, H, W, C, bs,
                            halo, heads, stream);
}

}  // namespace

extern "C" {

// Writes dq, dk, dv (T images) and bias_part [ceil(windows / bias_group)]
// [nk][hd] f32, to be summed over its first axis (pht_sum_splits).
int pht_attention_bwd(const void* q, const void* k, const void* v, const void* rel_h,
                      const void* rel_w, const void* dout, void* dq, void* dk, void* dv,
                      void* dk_part, void* dv_part, void* bias_part, int bias_group, int B,
                      int H, int W, int C, int bs, int halo, int heads, int is_bf16,
                      float scale, void* stream) {
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  float* kp = static_cast<float*>(dk_part);
  float* vp = static_cast<float*>(dv_part);
  float* bp = static_cast<float*>(bias_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(q, k, v, rh, rw, dout, dq, dk, dv, kp, vp, bp, bias_group, B, H, W, C,
                        bs, halo, heads, scale, s);
  return launch<float>(q, k, v, rh, rw, dout, dq, dk, dv, kp, vp, bp, bias_group, B, H, W, C,
                       bs, halo, heads, scale, s);
}

// The tensor-core body (bf16 only): the same arguments as pht_attention_bwd.
// Refuses (cudaErrorInvalidValue, before any launch) a dtype, shape,
// alignment or shared memory the body does not take.
int pht_attention_bwd_tc(const void* q, const void* k, const void* v, const void* rel_h,
                         const void* rel_w, const void* dout, void* dq, void* dk, void* dv,
                         void* dk_part, void* dv_part, void* bias_part, int bias_group, int B,
                         int H, int W, int C, int bs, int halo, int heads, int is_bf16,
                         float scale, void* stream) {
  const int hd = C / heads;
  if (!is_bf16 || !attn::admits(bs, hd, C)) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, rel_h, rel_w, dout, static_cast<const void*>(dq)})
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  const size_t smem = attn::bwd_smem(bs, halo, hd);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  const bf16* dot = static_cast<const bf16*>(dout);
  bf16* dqt = static_cast<bf16*>(dq);
  float* kp = static_cast<float*>(dk_part);
  float* vp = static_cast<float*>(dv_part);
  const int nwin = B * (H / bs) * (W / bs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
#define PHT_BWD_TC(NT)                                                                     \
  launch_tc_main<NT>(qt, kt, vt, rh, rw, dot, dqt, kp, vp, nwin, H, W, C, bs, halo, heads, \
                     scale, smem, s)
  const int nt = attn::key_tiles(bs, halo);
  switch (attn::resident_tiles(nt) ? nt : 0) {
    case 3: err = PHT_BWD_TC(3); break;
    case 4: err = PHT_BWD_TC(4); break;
    case 7: err = PHT_BWD_TC(7); break;
    case 9: err = PHT_BWD_TC(9); break;
    case 13: err = PHT_BWD_TC(13); break;
    case 16: err = PHT_BWD_TC(16); break;
    default: err = PHT_BWD_TC(0); break;
  }
#undef PHT_BWD_TC
  if (err != 0) return err;
  return reduce_partials<bf16>(kp, vp, static_cast<float*>(bias_part), bias_group, dk, dv, B,
                               H, W, C, bs, halo, heads, s);
}

// The float32 body: the same arguments as pht_attention_bwd. Refuses
// (cudaErrorInvalidValue, before any launch) a dtype, shape, alignment or
// shared memory the body does not take.
int pht_attention_bwd_f32(const void* q, const void* k, const void* v, const void* rel_h,
                          const void* rel_w, const void* dout, void* dq, void* dk, void* dv,
                          void* dk_part, void* dv_part, void* bias_part, int bias_group, int B,
                          int H, int W, int C, int bs, int halo, int heads, int is_bf16,
                          float scale, void* stream) {
  if (is_bf16 || !f32a::admits(bs, halo, C / heads, C)) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, rel_h, rel_w, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk), static_cast<const void*>(dv),
                        static_cast<const void*>(dk_part), static_cast<const void*>(dv_part)})
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  const size_t smem = f32a::bwd_smem(bs, halo);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  const float* dot = static_cast<const float*>(dout);
  float* dqt = static_cast<float*>(dq);
  float* kp = static_cast<float*>(dk_part);
  float* vp = static_cast<float*>(dv_part);
  const int nwin = B * (H / bs) * (W / bs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fast = f32a::slots(f32a::window_keys(bs, halo), 2) == f32a::kFastSlots &&
                    PHT_F32_DIAG != 4;
  const int err = fast ? launch_f32_main<f32a::kFastSlots>(qt, kt, vt, rh, rw, dot, dqt, kp, vp,
                                                           nwin, H, W, C, bs, halo, heads, scale,
                                                           smem, s)
                       : launch_f32_main<0>(qt, kt, vt, rh, rw, dot, dqt, kp, vp, nwin, H, W, C,
                                            bs, halo, heads, scale, smem, s);
  if (err != 0) return err;
  return reduce_partials<float>(kp, vp, static_cast<float*>(bias_part), bias_group, dk, dv, B,
                                H, W, C, bs, halo, heads, s);
}

}  // extern "C"
