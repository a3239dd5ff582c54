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
//   1. `attention_bwd_kernel`: one CTA per (window, head) writes dq
//      straight to the image (queries do not overlap) and its f32 dk_w/dv_w
//      to per-window partial buffers [windows, nk, C];
//   2. `attention_bwd_gather_kernel`: each key pixel sums the partials of
//      the windows that hold it, in a fixed order, and rounds once (the TPU
//      kernel adds bf16-rounded window gradients in bf16; the port's plain
//      version follows this kernel);
//   3. `attention_bias_reduce_kernel` sums dk_w over groups of windows and
//      the heads, and `pht_sum_splits` (block_bwd.cu) sums the groups.
// A rerun on the card gives the same bits.
//
// What bounds it on the H100: like K1, shared-memory bandwidth of scalar
// f32 FMAs (five window products per CTA instead of two), plus the
// partials' HBM traffic (2 x 411 MB written and read once at prod, about
// 0.5 ms at 3.35 TB/s). Each CTA stages q, do, k_eff and v (rows padded to
// an odd word stride so a warp walking keys hits distinct banks), the f32
// probabilities and dattn/dl for all keys (bf16 halo 3: 186 KB, one CTA
// per SM). When that plan does not fit (fp32, or large halos), the keys
// are walked in chunks in three passes (row max/sum, the row sums of
// dattn * P, then the gradients), recomputing each chunk's logits.

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

// dk/dv[b, y, x, c] = round(sum over the windows holding (y, x) of the
// partials), windows in raster order
template <typename T>
__global__ void attention_bwd_gather_kernel(const float* __restrict__ dk_part,
                                            const float* __restrict__ dv_part,
                                            T* __restrict__ dk, T* __restrict__ dv, int B,
                                            int H, int W, int C, int bs, int halo) {
  const int64_t total = (int64_t)B * H * W * C;
  const int window = bs + 2 * halo;
  const int nk = window * window;
  const int wb = W / bs, hb = H / bs;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    int64_t pix = idx / C;
    const int x = (int)(pix % W);
    pix /= W;
    const int y = (int)(pix % H);
    const int b = (int)(pix / H);
    // windows by with by*bs - halo <= y < by*bs + bs + halo
    const int by_lo = max(0, (y - bs - halo + bs) / bs), by_hi = min(hb - 1, (y + halo) / bs);
    const int bx_lo = max(0, (x - bs - halo + bs) / bs), bx_hi = min(wb - 1, (x + halo) / bs);
    float sk = 0.f, sv = 0.f;
    for (int by = by_lo; by <= by_hi; ++by) {
      const int wy = y - by * bs + halo;
      if (wy < 0 || wy >= window) continue;
      for (int bx = bx_lo; bx <= bx_hi; ++bx) {
        const int wx = x - bx * bs + halo;
        if (wx < 0 || wx >= window) continue;
        const size_t off = (((size_t)(b * hb + by) * wb + bx) * nk + wy * window + wx) * C + c;
        sk += dk_part[off];
        sv += dv_part[off];
      }
    }
    dk[idx] = from_f32<T>(sk);
    dv[idx] = from_f32<T>(sv);
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

  const int64_t total = (int64_t)B * H * W * C;
  const int gblocks = (int)std::min<int64_t>((total + 255) / 256, 132 * 64);
  attention_bwd_gather_kernel<T><<<gblocks, 256, 0, stream>>>(
      dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), B, H, W, C, bs, halo);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int ngroups = (nwin + bias_group - 1) / bias_group;
  attention_bias_reduce_kernel<<<dim3((unsigned)((nk * hd + 255) / 256), (unsigned)ngroups),
                                 256, 0, stream>>>(dk_part, bias_part, nwin, nk, C, heads,
                                                   bias_group);
  return (int)cudaGetLastError();
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

}  // extern "C"
