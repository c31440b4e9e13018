// Fused backward of the flash-attention block step (flash_block.cu) for
// Hopper (sm_90a). Given the step's inputs (q, k, v, m, l, o, mask) and
// the cotangents (cm, cl, co) of its outputs (m', l', o'), it returns
// (dq, dk, dv, dm, dl, do) by recomputing s and p, with JAX's tie rules:
//   t = rowmax s;  m' = max(m, t);  alpha = exp(m - m');  p = exp(s - m')
//   do = co alpha;  dl = cl alpha;  dv = p^T co
//   dalpha = cl l + sum_d co o;  dp = co v^T + cl
//   dm' = cm - dalpha alpha - sum_j dp p
//   sel = 1 if m > t, 0 if m < t, 0.5 at a tie   (maximum splits a tie)
//   dm = dalpha alpha + dm' sel
//   ds = dp p + [s == t] dm' (1 - sel) / #{j: s == t}  (reduce_max splits
//        its cotangent among the tied lanes), 0 on masked lanes, * scale
//   dq = ds k;  dk = ds^T q
//
// Replaces the TPU kernel rabit_tpu/ops/pallas_kernels.py::flash_block_bwd
// (body _flash_bwd_body), one program a head that holds the [T, S] score,
// probability and gradient tiles in VMEM. Here nothing of size [T, S]
// reaches device memory. Two launches:
//   (a) flash_bwd_rows, a block per (64 query rows, head): three passes
//       over the key tiles. Pass 1 finds t and the count of lanes equal to
//       it; pass 2 sums dp p; then dm', sel and the tie term are known and
//       it writes dm, dl, do and the per-row (m', t, tie term) scratch;
//       pass 3 forms ds and accumulates dq.
//   (b) flash_bwd_cols, a block per (64 keys, head): streams the query
//       tiles, forms p and ds from the per-row scratch of (a), and
//       accumulates dk = ds^T q and dv = p^T co.
// Both recompute s with rabit_flash::scores4x4 (flash_common.cuh), so the
// test s == t finds the same lanes in (a) and (b). Every pass skips a
// tile that the mask covers wherever that is exact
// (rabit_flash::tile_masked): about half the tiles under a causal mask.
//
// Bound: operations. 10 D flops (five products) for each (query, key)
// pair the mask leaves, on about 4 D words a row and key; at the training
// shape (BH 64, T = S = 512, D 32, causal) 2.7 GFLOP, 40 us at 67 TFLOP/s
// f32. This first version
// recomputes: (a) forms q k^T three times and co v^T twice, (b) once
// each, so it does about twice the bound's operations, as f32 FMAs on
// the CUDA cores from shared memory.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the first launch error.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace rabit_flash;

template <bool kMasked>
__device__ __forceinline__ bool masked_at(const unsigned char* mask, int row,
                                          int col, int S) {
  return kMasked && mask[static_cast<long long>(row) * S + col];
}

// kMasked (here and in flash_bwd_cols): whether mask is given; the
// kernels without one read no mask.
template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_rows(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ m,
                   const float* __restrict__ l, const float* __restrict__ o,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ cm, const float* __restrict__ cl,
                   const float* __restrict__ co, int T, int S, int D,
                   float scale, float* __restrict__ dq,
                   float* __restrict__ dm, float* __restrict__ dl,
                   float* __restrict__ dO, float* __restrict__ mnew_out,
                   float* __restrict__ trow_out,
                   float* __restrict__ tie_out) {
  constexpr int kLd = Tile<DP>::kLd;
  constexpr int kOut = DP / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kRows, kLd]
  float* co_s = q_s + kRows * kLd;    // [kRows, kLd]
  float* k_s = co_s + kRows * kLd;    // [kCols, kLd]
  float* v_s = k_s + kCols * kLd;     // [kCols, kLd]
  float* ds_s = v_s + kCols * kLd;    // [kRows, kCols + 1]

  const int row0 = blockIdx.x * kRows;
  const long long hq = static_cast<long long>(blockIdx.y) * T;
  const long long hk = static_cast<long long>(blockIdx.y) * S;
  const int rg = threadIdx.x / 16, lane = threadIdx.x % 16;

  load_tile<DP>(q_s, q + hq * D, row0, T, D);
  load_tile<DP>(co_s, co + hq * D, row0, T, D);
  __syncthreads();

  float m_in[4], cm_in[4], cl_in[4], dalpha[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = rg * 4 + a, row = row0 + r;
    const bool ok = row < T;
    m_in[a] = ok ? m[hq + row] : kNegInf;
    cm_in[a] = ok ? cm[hq + row] : 0.f;
    cl_in[a] = ok ? cl[hq + row] : 0.f;
    float co_o = 0.f;
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      const int c = lane + 16 * e;
      if (ok && c < D)
        co_o = fmaf(co_s[r * kLd + c], o[(hq + row) * D + c], co_o);
    }
    dalpha[a] = cl_in[a] * (ok ? l[hq + row] : 0.f) + group_sum(co_o);
  }

  // pass 1: t = rowmax s and the number of lanes equal to it
  float t_row[4], n_tie[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    t_row[a] = -INFINITY;
    n_tie[a] = 0.f;
  }
  for (int col0 = 0; col0 < S; col0 += kCols) {
    // a fully masked tile cannot move t once t is above -1e30
    bool rows_ok = true;
    if (kMasked) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float t_now = group_max(t_row[a]);
        if (row0 + rg * 4 + a < T && !(t_now > kNegInf)) rows_ok = false;
      }
    }
    if (tile_masked<kMasked>(mask, row0, col0, T, S, rows_ok)) continue;
    load_tile<DP>(k_s, k + hk * D, col0, S, D);
    __syncthreads();
    float s[4][4];
    scores4x4<DP>(q_s, k_s, rg * 4, lane, scale, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = row0 + rg * 4 + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = col0 + lane + 16 * b;
        if (col >= S) continue;
        const bool msk = row < T && masked_at<kMasked>(mask, row, col, S);
        const float x = msk ? kNegInf : s[a][b];
        if (x > t_row[a]) {
          t_row[a] = x;
          n_tie[a] = 1.f;
        } else if (x == t_row[a]) {
          n_tie[a] += 1.f;
        }
      }
    }
  }
  float m_new[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    group_max_count(t_row[a], n_tie[a]);
    m_new[a] = fmaxf(m_in[a], t_row[a]);
  }

  // pass 2: sum_j dp p (p = 0 on a masked lane once m' is above -1e30)
  bool finite_rows = true;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    if (row0 + rg * 4 + a < T && !(m_new[a] > kNegInf)) finite_rows = false;
  float dpp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int col0 = 0; col0 < S; col0 += kCols) {
    if (tile_masked<kMasked>(mask, row0, col0, T, S, finite_rows)) continue;
    load_tile<DP>(k_s, k + hk * D, col0, S, D);
    load_tile<DP>(v_s, v + hk * D, col0, S, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores4x4<DP>(q_s, k_s, rg * 4, lane, scale, s);
    dots4x4<DP>(co_s, v_s, rg * 4, lane, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = row0 + rg * 4 + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = col0 + lane + 16 * b;
        if (col >= S) continue;
        const bool msk = row < T && masked_at<kMasked>(mask, row, col, S);
        const float x = msk ? kNegInf : s[a][b];
        const float p = expf(x - m_new[a]);
        dpp[a] = fmaf(dp[a][b] + cl_in[a], p, dpp[a]);
      }
    }
  }

  float tie[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = rg * 4 + a, row = row0 + r;
    const float alpha = expf(m_in[a] - m_new[a]);
    const float dm_new = cm_in[a] - dalpha[a] * alpha - group_sum(dpp[a]);
    const float sel =
        m_in[a] > t_row[a] ? 1.f : (m_in[a] < t_row[a] ? 0.f : 0.5f);
    tie[a] = dm_new * (1.f - sel) / n_tie[a];
    if (row >= T) continue;
    if (lane == 0) {
      dm[hq + row] = dalpha[a] * alpha + dm_new * sel;
      dl[hq + row] = cl_in[a] * alpha;
      mnew_out[hq + row] = m_new[a];
      trow_out[hq + row] = t_row[a];
      tie_out[hq + row] = tie[a];
    }
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      const int c = lane + 16 * e;
      if (c < D) dO[(hq + row) * D + c] = co_s[r * kLd + c] * alpha;
    }
  }

  // pass 3: ds, and dq = ds k
  float acc[4][kOut];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kOut; ++e) acc[a][e] = 0.f;
  for (int col0 = 0; col0 < S; col0 += kCols) {
    // ds is 0 on every masked lane
    if (tile_masked<kMasked>(mask, row0, col0, T, S, true)) continue;
    load_tile<DP>(k_s, k + hk * D, col0, S, D);
    load_tile<DP>(v_s, v + hk * D, col0, S, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores4x4<DP>(q_s, k_s, rg * 4, lane, scale, s);
    dots4x4<DP>(co_s, v_s, rg * 4, lane, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = rg * 4 + a, row = row0 + r;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = lane + 16 * b, col = col0 + c;
        float ds = 0.f;
        if (col < S) {
          const bool msk = row < T && masked_at<kMasked>(mask, row, col, S);
          const float x = msk ? kNegInf : s[a][b];
          ds = (dp[a][b] + cl_in[a]) * expf(x - m_new[a]);
          if (x == t_row[a]) ds += tie[a];
          ds = msk ? 0.f : ds * scale;
        }
        ds_s[r * (kCols + 1) + c] = ds;
      }
    }
    __syncthreads();
    for (int j = 0; j < kCols; ++j) {
      float kj[kOut];
#pragma unroll
      for (int e = 0; e < kOut; ++e) kj[e] = k_s[j * kLd + lane + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float x = ds_s[(rg * 4 + a) * (kCols + 1) + j];
#pragma unroll
        for (int e = 0; e < kOut; ++e) acc[a][e] = fmaf(x, kj[e], acc[a][e]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + rg * 4 + a;
    if (row >= T) continue;
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      const int c = lane + 16 * e;
      if (c < D) dq[(hq + row) * D + c] = acc[a][e];
    }
  }
}

template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_cols(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ cl, const float* __restrict__ co,
                   const float* __restrict__ mnew,
                   const float* __restrict__ trow,
                   const float* __restrict__ tie, int T, int S, int D,
                   float scale, float* __restrict__ dk,
                   float* __restrict__ dv) {
  constexpr int kLd = Tile<DP>::kLd;
  constexpr int kOut = DP / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                      // [kCols, kLd], resident
  float* v_s = k_s + kCols * kLd;         // [kCols, kLd], resident
  float* q_s = v_s + kCols * kLd;         // [kRows, kLd]
  float* co_s = q_s + kRows * kLd;        // [kRows, kLd]
  float* ds_s = co_s + kRows * kLd;       // [kRows, kCols + 1]
  float* p_s = ds_s + kRows * (kCols + 1);  // [kRows, kCols + 1]
  float* mn_s = p_s + kRows * (kCols + 1);  // [kRows] per-row scalars
  float* tr_s = mn_s + kRows;
  float* tie_s = tr_s + kRows;
  float* cl_s = tie_s + kRows;

  const int col0 = blockIdx.x * kCols;
  const long long hq = static_cast<long long>(blockIdx.y) * T;
  const long long hk = static_cast<long long>(blockIdx.y) * S;
  const int rg = threadIdx.x / 16, lane = threadIdx.x % 16;

  load_tile<DP>(k_s, k + hk * D, col0, S, D);
  load_tile<DP>(v_s, v + hk * D, col0, S, D);
  float acc_k[4][kOut], acc_v[4][kOut];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kOut; ++e) acc_k[a][e] = acc_v[a][e] = 0.f;

  for (int row0 = 0; row0 < T; row0 += kRows) {
    // on a fully masked tile ds = 0, and p = 0 where m' is above -1e30
    bool rows_ok = true;
    if (kMasked) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = row0 + rg * 4 + a;
        if (row < T && !(mnew[hq + row] > kNegInf)) rows_ok = false;
      }
    }
    if (tile_masked<kMasked>(mask, row0, col0, T, S, rows_ok)) continue;
    load_tile<DP>(q_s, q + hq * D, row0, T, D);
    load_tile<DP>(co_s, co + hq * D, row0, T, D);
    load_rows(mn_s, mnew + hq, row0, T, 0.f);
    load_rows(tr_s, trow + hq, row0, T, 0.f);
    load_rows(tie_s, tie + hq, row0, T, 0.f);
    load_rows(cl_s, cl + hq, row0, T, 0.f);
    __syncthreads();
    // pairs: query i = rg*4 + a of this tile, key j = lane + 16 b
    float s[4][4], dp[4][4];
    scores4x4<DP>(q_s, k_s, rg * 4, lane, scale, s);
    dots4x4<DP>(co_s, v_s, rg * 4, lane, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = rg * 4 + a, row = row0 + i;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = lane + 16 * b, col = col0 + j;
        float p = 0.f, ds = 0.f;
        if (row < T && col < S) {
          const bool msk = masked_at<kMasked>(mask, row, col, S);
          const float x = msk ? kNegInf : s[a][b];
          p = expf(x - mn_s[i]);
          ds = (dp[a][b] + cl_s[i]) * p;
          if (x == tr_s[i]) ds += tie_s[i];
          ds = msk ? 0.f : ds * scale;
        }
        p_s[i * (kCols + 1) + j] = p;
        ds_s[i * (kCols + 1) + j] = ds;
      }
    }
    __syncthreads();
    // this thread's keys rg*4 + a, columns lane + 16 e
    for (int i = 0; i < kRows; ++i) {
      float qi[kOut], coi[kOut];
#pragma unroll
      for (int e = 0; e < kOut; ++e) {
        qi[e] = q_s[i * kLd + lane + 16 * e];
        coi[e] = co_s[i * kLd + lane + 16 * e];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float x = ds_s[i * (kCols + 1) + rg * 4 + a];
        const float y = p_s[i * (kCols + 1) + rg * 4 + a];
#pragma unroll
        for (int e = 0; e < kOut; ++e) {
          acc_k[a][e] = fmaf(x, qi[e], acc_k[a][e]);
          acc_v[a][e] = fmaf(y, coi[e], acc_v[a][e]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int col = col0 + rg * 4 + a;
    if (col >= S) continue;
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      const int c = lane + 16 * e;
      if (c < D) {
        dk[(hk + col) * D + c] = acc_k[a][e];
        dv[(hk + col) * D + c] = acc_v[a][e];
      }
    }
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* m, const float* l, const float* o,
                   const unsigned char* mask, const float* cm,
                   const float* cl, const float* co, int bh, int T, int S,
                   int D, float scale, float* dq, float* dk, float* dv,
                   float* dm, float* dl, float* dO, float* scratch,
                   cudaStream_t stream) {
  constexpr int kLd = Tile<DP>::kLd;
  float* mnew = scratch;
  float* trow = mnew + static_cast<long long>(bh) * T;
  float* tie = trow + static_cast<long long>(bh) * T;

  const size_t rows_smem =
      sizeof(float) * ((2 * kRows + 2 * kCols) * kLd + kRows * (kCols + 1));
  auto rows = mask != nullptr ? flash_bwd_rows<DP, true>
                               : flash_bwd_rows<DP, false>;
  cudaError_t err = allow_smem(rows, rows_smem);
  if (err != cudaSuccess) return err;
  rows<<<dim3((T + kRows - 1) / kRows, bh), kThreads, rows_smem, stream>>>(
      q, k, v, m, l, o, mask, cm, cl, co, T, S, D, scale, dq, dm, dl, dO,
      mnew, trow, tie);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t cols_smem =
      sizeof(float) * ((2 * kRows + 2 * kCols) * kLd +
                       2 * kRows * (kCols + 1) + 4 * kRows);
  auto cols = mask != nullptr ? flash_bwd_cols<DP, true>
                               : flash_bwd_cols<DP, false>;
  if ((err = allow_smem(cols, cols_smem)) != cudaSuccess) return err;
  cols<<<dim3((S + kCols - 1) / kCols, bh), kThreads, cols_smem, stream>>>(
      q, k, v, mask, cl, co, mnew, trow, tie, T, S, D, scale, dk, dv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Inputs as rabit_flash_block_f32, plus the cotangents cm/cl [bh, t] and
// co [bh, t, d]; outputs dq [bh, t, d], dk/dv [bh, s, d], dm/dl [bh, t],
// do [bh, t, d]; scratch f32 [3, bh, t]. All f32 device pointers,
// contiguous. 1 <= d <= 128. Returns a cudaError_t (0 on success).
int rabit_flash_block_bwd_f32(const void* q, const void* k, const void* v,
                              const void* m, const void* l, const void* o,
                              const void* mask, const void* cm,
                              const void* cl, const void* co, int bh, int t,
                              int s, int d, float scale, void* dq, void* dk,
                              void* dv, void* dm, void* dl, void* dO,
                              void* scratch, void* stream) {
  if (bh < 1 || bh > 65535 || t < 1 || s < 1 || d < 1 || d > 128)
    return cudaErrorInvalidValue;
#define RABIT_FLASH_BWD_ARGS                                              \
  static_cast<const float*>(q), static_cast<const float*>(k),             \
      static_cast<const float*>(v), static_cast<const float*>(m),         \
      static_cast<const float*>(l), static_cast<const float*>(o),         \
      static_cast<const unsigned char*>(mask),                            \
      static_cast<const float*>(cm), static_cast<const float*>(cl),       \
      static_cast<const float*>(co), bh, t, s, d, scale,                  \
      static_cast<float*>(dq), static_cast<float*>(dk),                   \
      static_cast<float*>(dv), static_cast<float*>(dm),                   \
      static_cast<float*>(dl), static_cast<float*>(dO),                   \
      static_cast<float*>(scratch), static_cast<cudaStream_t>(stream)
  if (d <= 16) return launch<16>(RABIT_FLASH_BWD_ARGS);
  if (d <= 32) return launch<32>(RABIT_FLASH_BWD_ARGS);
  if (d <= 64) return launch<64>(RABIT_FLASH_BWD_ARGS);
  return launch<128>(RABIT_FLASH_BWD_ARGS);
#undef RABIT_FLASH_BWD_ARGS
}

const char* rabit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
