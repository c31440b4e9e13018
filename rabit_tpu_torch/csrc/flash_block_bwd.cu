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
// probability and gradient tiles in VMEM, its f32 dots at the TPU's
// default matmul precision. Here nothing of size [T, S] reaches device
// memory, and every product runs on the tensor cores at f32 accuracy
// through the 3xTF32 split (flash_mma.cuh): three TF32 mma.sync products
// a step, within about 1e-6 of f64 on a dot of width 128. Two launches,
// 8 warps a block in four pairs, a pair for each 16-row slice of a
// 64-row tile:
//   (a) flash_bwd_rows, a block per (64 query rows, head), two passes
//       over the key tiles. Pass 1 forms s = q k^T and dp = co v^T a tile
//       and keeps, per row, the running max t, its tie count and
//       sum_j (dp + cl) exp(s - m'), rescaled whenever m' = max(m, t)
//       rises; then dm', sel and the tie term are known, and it writes
//       dm, dl, do and the per-row (m', t, tie term) scratch. Pass 2 forms
//       s and dp again, then ds, staged in shared memory, and dq += ds k.
//   (b) flash_bwd_cols, a block per (64 keys, head): streams the query
//       tiles, forms s and dp, then p and ds from the scratch of (a), each
//       staged in shared memory, and accumulates dv = p^T co, dk = ds^T q.
// The two warps of a pair split the tile's 64 keys for s and dp (so each
// (query, key) element is one warp's mma sequence) and the D columns of
// dq, dk and dv. Both kernels form s with rabit_mma::score_tile, so the
// test s == t finds the same lanes in (a) and (b). K/V (or q/co) tiles
// stream through two shared-memory stages by cp.async, the next tile in
// flight while the current one is multiplied. Every pass skips a tile
// that the mask covers wherever that is exact (next_tile's rule): about
// half the tiles under a causal mask; a tile that the mask leaves whole
// is multiplied without reading the mask.
//
// Work: 9 products of 2 D flops a (query, key) pair that the mask leaves
// (a: s and dp twice, ds k; b: s, dp, p^T co, ds^T q), against the 5 of
// the bound. dq stays in the row kernel: summing it from the column
// blocks would take f32 atomics, whose order, and so whose bits, change
// from run to run; this port keeps its gradients bit-reproducible.
//
// Bound: operations. 10 D flops (five products) for each pair the mask
// leaves, on about 4 D words a row and key; at f32 accuracy the card does
// them on the tensor cores at 495 / 3 = 165 TFLOP/s (3xTF32). At the
// training shape (BH 64, T = S = 512, D 32, causal) 2.69 GFLOP, 16.3 us;
// at the ring chain's block (BH 8, T = S = 1024, D 128) 10.7 GFLOP, 65 us.
//
// The bf16 path (rabit_flash_block_bwd_bf16; the TPU kernel's bf16 q/k/v
// contract, pallas_kernels.py:275-318): the same two kernels, their
// bodies templated on q/k/v's element type. Every product of the
// contract has at most one f32 operand (s: q, k; dp: co, v; dv: p, co;
// dq: ds, k; dk: ds, q), and a bf16 value widened to f32 is exact in TF32
// (split_tf32 gives it a small part of 0), so the 3xTF32 products form
// each one at f32 accuracy as they stand. So bf16 q, K and V are widened
// as they land in shared memory (plain loads: cp.async cannot convert),
// and the shared memory, the products, score_tile, the skip and tie rules
// and every sum are the f32 kernels'; only the TF32 products that take a
// small part of 0 (exact zeros) are left out (mma3_tf32's flags): s takes
// one, dp, dv, dq and dk two, 15 a pair where f32 takes 27, the same
// sums. Two roundings are the contract's own: the column kernel rounds
// p to bf16 to nearest even against the final m' of the scratch, for dv
// = bf16(p)^T co alone (ds, and the row kernel's pass 1, take the f32
// p), and dq, dk and dv round to bf16 at the store from their f32 sums.
// dm, dl and do stay f32. Bound at bf16:
// 10 D flops a pair at 989 TFLOP/s of dense bf16 against q, k, v and
// their gradients at 2 B and m, l, o, the cotangents, dm, dl and do at 4
// B: at the training shape about 26 MB, 7.8 us (bytes), against 2.7 us;
// at the chain block 10.7 GFLOP, 10.9 us (operations), against 7.6 us.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return the first launch error.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace rabit_flash;
using namespace rabit_mma;

constexpr int kNt = 4;            // 8-key C tiles of a warp's 32 keys
constexpr int kLdS = kCols + 4;   // ds in (a): read as A rows
constexpr int kLdT = kCols + 8;   // p, ds in (b): read as A columns

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The first tile from `from` on (a key tile of rows [row0, row0 + 64), or
// a query tile of keys [col0, col0 + 64)) that a pass must visit. A tile
// is skipped where every pair of it that exists (row < T, col < S) is
// masked and `ok` (the calling thread's part of the rows' condition)
// holds on every thread. Thread (rg, lane) = (tid / 16, tid % 16) reads
// the mask at its 4 x 4 block, rows 4 rg + i and columns lane + 16 j.
// Barriers: every thread gets the same answer.
//
// Why the rows' condition: a masked lane's score is -1e30 exactly. Where
// a row's running max m is above -1e30, such a lane gives p = exp(-1e30 -
// m) = 0, moves neither the max nor the sum, and adds 0 to every product:
// skipping it is exact. A row whose max is still -1e30 (fully masked so
// far) gets p = 1 on such a lane, so the callers' `ok` is false for it.
template <bool kMasked, bool kKeys, typename RowOk>
__device__ __forceinline__ Visit next_tile(const unsigned char* mask,
                                           int row0, int col0, int T, int S,
                                           RowOk ok) {
  int& from = kKeys ? col0 : row0;
  const int end = kKeys ? S : T;
  if constexpr (!kMasked) {
    __syncthreads();
    return {from, true};
  }
  const int rg = threadIdx.x / 16, lane = threadIdx.x % 16;
  for (; from < end; from += 64) {
    bool all = ok(row0), none = true;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = row0 + rg * 4 + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = col0 + lane + 16 * b;
        if (row < T && col < S) {
          const bool masked = mask[static_cast<long long>(row) * S + col];
          all = all && masked;
          none = none && !masked;
        }
      }
    }
    if (!__syncthreads_and(all)) return {from, __syncthreads_and(none) != 0};
  }
  return {from, true};
}

// (t, count, sum, m') of a part of a row, merged with another part's:
// the max and its count exactly, the sums at the larger m'. Symmetric, so
// two lanes that merge each other's parts get the same bits.
__device__ __forceinline__ void merge_rows(float& t, float& n, float& sum,
                                           float& mref, float t2, float n2,
                                           float sum2, float mref2) {
  const float m_new = fmaxf(mref, mref2);
  sum = sum * expf(mref - m_new) + sum2 * expf(mref2 - m_new);
  n = t > t2 ? n : (t < t2 ? n2 : n + n2);
  t = fmaxf(t, t2);
  mref = m_new;
}

// Up to D 32 two blocks share an SM (at most 128 registers a thread and
// 74-76 KB of shared memory a block); from D 64 on the shared memory
// holds one block, which may then take up to 255 registers a thread.
template <int DP>
constexpr int kMinBlocks = DP <= 32 ? 2 : 1;

// The row kernel's work, for q/k/v (and dq) of element type E: f32, or
// bf16 widened to f32 as it lands in shared memory (the products, the
// scores and every sum as at f32; dq rounded to bf16 at the store).
// kMasked (here and in bwd_cols): whether mask is given; the kernels
// without one read no mask.
template <typename E, int DP, bool kMasked>
__device__ __forceinline__ void bwd_rows(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ o,
    const unsigned char* __restrict__ mask, const float* __restrict__ cm,
    const float* __restrict__ cl, const float* __restrict__ co, int T, int S,
    int D, float scale, E* __restrict__ dq, float* __restrict__ dm,
    float* __restrict__ dl, float* __restrict__ dO,
    float* __restrict__ mnew_out, float* __restrict__ trow_out,
    float* __restrict__ tie_out) {
  constexpr int kLd = MmaTile<DP>::kLd;
  constexpr int kTile = kRows * kLd;
  constexpr int kNq = DP / 16;  // 8-column C tiles of the warp's dq half
  constexpr bool kExact = sizeof(E) == 2;  // q, k, v exact in TF32
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                      // [kRows, kLd]
  float* co_s = q_s + kTile;              // [kRows, kLd]
  float* kv_s = co_s + kTile;             // [2 stages][k, v][kCols, kLd]
  float* ds_s = kv_s + 4 * kTile;         // [kRows, kLdS]
  float* part_s = ds_s + kRows * kLdS;    // [2 halves][kRows][t, n, sum, m']
  float* dalpha_s = part_s + 2 * kRows * 4;  // [kRows]
  float* alpha_s = dalpha_s + kRows;         // [kRows]
  int* seen_s = reinterpret_cast<int*>(alpha_s + kRows);  // [kRows]

  const int row0 = blockIdx.x * kRows;
  const long long hq = static_cast<long long>(blockIdx.y) * T;
  const long long hk = static_cast<long long>(blockIdx.y) * S;
  const E* kh = k + hk * D;
  const E* vh = v + hk * D;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slice = 16 * (w / 2), half = w % 2;  // rows slice.. + 16
  const int keys = 32 * half;                    // s, dp: keys keys.. + 32
  const int cols = half * (DP / 2);              // dq: columns cols.. + DP/2

  load_tile_async<DP>(q_s, q + hq * D, row0, T, D);
  load_tile_async<DP>(co_s, co + hq * D, row0, T, D);
  cp_async_commit();
  if (threadIdx.x < kRows) seen_s[threadIdx.x] = 0;
  auto load_kv = [&](int stage, int col0) {
    load_tile_async<DP>(kv_s + 2 * stage * kTile, kh, col0, S, D);
    load_tile_async<DP>(kv_s + (2 * stage + 1) * kTile, vh, col0, S, D);
  };
  // pass 1 may skip a masked tile once every row that exists has a score
  // above -1e30 (seen_s); pass 2 skips every masked tile (ds = 0 there)
  auto seen = [&](int) {
    return !(threadIdx.x < kRows && row0 + threadIdx.x < T) ||
           seen_s[threadIdx.x] != 0;
  };
  auto any = [](int) { return true; };
  // the s and dp of this warp's 16 rows x 32 keys of the key tile at col0
  // (k_s, then v_s); returns the masked lanes' bits
  float s[kNt][4], dp[kNt][4];
  auto scores = [&](const float* k_s, Visit tile) {
    return score_tile<DP, kNt, kMasked, kExact>(
        s, dp, q_s + slice * kLd, k_s + keys * kLd, co_s + slice * kLd,
        k_s + kTile + keys * kLd, kLd, scale, mask, !tile.unmasked,
        row0 + slice, tile.from + keys, T, S);
  };

  // this thread's rows slice + c_row(e): h = 0 for e < 2, 1 for e >= 2
  float m_in[2], cl_in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + slice + c_row(2 * h);
    m_in[h] = row < T ? m[hq + row] : kNegInf;
    cl_in[h] = row < T ? cl[hq + row] : 0.f;
  }

  Visit tile = next_tile<kMasked, true>(mask, row0, 0, T, S, seen);
  if (tile.from < S) load_kv(0, tile.from);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // dalpha = cl l + sum_d co o, a warp for 8 rows
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * w + i, row = row0 + r;
    float acc = 0.f;
    if (row < T)
      for (int c = lane; c < D; c += 32)
        acc = fmaf(co_s[r * kLd + c], o[(hq + row) * D + c], acc);
    acc = warp_sum(acc);
    if (lane == 0) dalpha_s[r] = row < T ? cl[hq + row] * l[hq + row] + acc
                                         : 0.f;
  }

  // pass 1: this thread's part of t, its count and sum_j (dp + cl) p. A
  // key past S is no lane: -inf, so it neither sets t nor adds to the sum
  // (a part that saw only such keys loses every merge)
  float t_run[2] = {-INFINITY, -INFINITY}, n_run[2] = {0.f, 0.f};
  float sum_run[2] = {0.f, 0.f}, m_run[2] = {m_in[0], m_in[1]};
  for (int stage = 0; tile.from < S; stage ^= 1) {
    const Visit next = next_tile<kMasked, true>(mask, row0,
                                                tile.from + kCols, T, S,
                                                seen);
    if (next.from < S) load_kv(stage ^ 1, next.from);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    scores(kv_s + 2 * stage * kTile, tile);
    const int lanes = S - tile.from - keys;  // keys below S: c_col < lanes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = t_run[h], n = n_run[h];
#pragma unroll
      for (int j = 0; j < 2 * kNt; ++j) {
        const int nt = j / 2, e = 2 * h + j % 2;
        if (c_col(nt, e) >= lanes) s[nt][e] = -INFINITY;
        const float x = s[nt][e];
        n = x > t ? 1.f : (x == t ? n + 1.f : n);
        t = fmaxf(t, x);
      }
      const float m_new = fmaxf(m_in[h], t);
      float sum = sum_run[h] * expf(m_run[h] - m_new);
#pragma unroll
      for (int j = 0; j < 2 * kNt; ++j) {
        const int nt = j / 2, e = 2 * h + j % 2;
        sum = fmaf(dp[nt][e] + cl_in[h], expf(s[nt][e] - m_new), sum);
      }
      t_run[h] = t;
      n_run[h] = n;
      sum_run[h] = sum;
      m_run[h] = m_new;
      if (kMasked && t > kNegInf) seen_s[slice + c_row(2 * h)] = 1;
    }
    __syncthreads();
    tile = next;
  }

  // the row's parts: the 4 lanes of a quad, then the two warps of a pair
  // (merged in one order, so both get the same bits)
  float t_row[2], m_new[2], tie[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      merge_rows(t_run[h], n_run[h], sum_run[h], m_run[h],
                 __shfl_xor_sync(0xffffffffu, t_run[h], off),
                 __shfl_xor_sync(0xffffffffu, n_run[h], off),
                 __shfl_xor_sync(0xffffffffu, sum_run[h], off),
                 __shfl_xor_sync(0xffffffffu, m_run[h], off));
    if (lane % 4 == 0) {
      float* p = part_s + (half * kRows + slice + c_row(2 * h)) * 4;
      p[0] = t_run[h];
      p[1] = n_run[h];
      p[2] = sum_run[h];
      p[3] = m_run[h];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = slice + c_row(2 * h), row = row0 + r;
    const float* a = part_s + r * 4;
    const float* b = part_s + (kRows + r) * 4;
    float t = a[0], n = a[1], dpp = a[2], mr = a[3];
    merge_rows(t, n, dpp, mr, b[0], b[1], b[2], b[3]);
    t_row[h] = t;
    m_new[h] = mr;  // max(m, t)
    const float alpha = expf(m_in[h] - mr);
    const float dm_new = (row < T ? cm[hq + row] : 0.f) -
                         dalpha_s[r] * alpha - dpp;
    const float sel = m_in[h] > t ? 1.f : (m_in[h] < t ? 0.f : 0.5f);
    tie[h] = dm_new * (1.f - sel) / n;
    if (half == 0 && lane % 4 == 0) {
      alpha_s[r] = alpha;
      if (row < T) {
        dm[hq + row] = dalpha_s[r] * alpha + dm_new * sel;
        dl[hq + row] = cl_in[h] * alpha;
        mnew_out[hq + row] = mr;
        trow_out[hq + row] = t;
        tie_out[hq + row] = tie[h];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP, row = row0 + r;
    if (row < T && c < D)
      dO[(hq + row) * D + c] = co_s[r * kLd + c] * alpha_s[r];
  }

  // pass 2: ds, and dq = ds k
  float acc[kNq][4] = {};
  tile = next_tile<kMasked, true>(mask, row0, 0, T, S, any);
  if (tile.from < S) load_kv(0, tile.from);
  cp_async_commit();
  for (int stage = 0; tile.from < S; stage ^= 1) {
    const Visit next = next_tile<kMasked, true>(mask, row0,
                                                tile.from + kCols, T, S,
                                                any);
    if (next.from < S) load_kv(stage ^ 1, next.from);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* k_s = kv_s + 2 * stage * kTile;
    const unsigned masked = scores(k_s, tile);
    const int lanes = S - tile.from - keys;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const float x = s[nt][e];
        float ds = (dp[nt][e] + cl_in[h]) * expf(x - m_new[h]);
        if (x == t_row[h]) ds += tie[h];
        // 0 on a masked lane and past S
        ds = (masked >> (4 * nt + e) & 1u) || c_col(nt, e) >= lanes
                 ? 0.f
                 : ds * scale;
        ds_s[(slice + c_row(e)) * kLdS + keys + c_col(nt, e)] = ds;
      }
    __syncthreads();
    mma3_tf32<kCols / 8, kNq, false, kExact>(acc, ds_s + slice * kLdS, kLdS,
                                             1, k_s + cols, kLd, 1);
    __syncthreads();
    tile = next;
  }
#pragma unroll
  for (int nt = 0; nt < kNq; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + slice + c_row(e), c = cols + c_col(nt, e);
      if (row < T && c < D) store_as(dq + (hq + row) * D + c, acc[nt][e]);
    }
}

// The column kernel's work, for q/k/v (and dk, dv) of element type E, as
// bwd_rows; at bf16 also p rounds to bf16 for dv = p^T co alone (the
// forward's p v takes p so), against the final m' of the scratch.
template <typename E, int DP, bool kMasked>
__device__ __forceinline__ void bwd_cols(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const unsigned char* __restrict__ mask,
    const float* __restrict__ cl, const float* __restrict__ co,
    const float* __restrict__ mnew, const float* __restrict__ trow,
    const float* __restrict__ tie, int T, int S, int D, float scale,
    E* __restrict__ dk, E* __restrict__ dv) {
  constexpr int kLd = MmaTile<DP>::kLd;
  constexpr int kTile = kRows * kLd;
  constexpr int kNd = DP / 16;  // 8-column C tiles of the warp's dk, dv half
  constexpr bool kExact = sizeof(E) == 2;  // q, k, v and the staged p
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                  // [kCols, kLd], resident
  float* v_s = k_s + kTile;           // [kCols, kLd], resident
  float* qc_s = v_s + kTile;          // [2 stages][q, co][kRows, kLd]
  float* pd_s = qc_s + 4 * kTile;     // [kRows, kLdT]: p, then ds

  const int col0 = blockIdx.x * kCols;
  const long long hq = static_cast<long long>(blockIdx.y) * T;
  const long long hk = static_cast<long long>(blockIdx.y) * S;
  const E* qh = q + hq * D;
  const float* coh = co + hq * D;
  const int w = threadIdx.x / 32;
  // s, dp: query rows slice.. + 16 x keys keys.. + 32; dk, dv: keys
  // slice.. + 16 x columns cols.. + DP/2
  const int slice = 16 * (w / 2), half = w % 2;
  const int keys = 32 * half, cols = half * (DP / 2);

  load_tile_async<DP>(k_s, k + hk * D, col0, S, D);
  load_tile_async<DP>(v_s, v + hk * D, col0, S, D);
  cp_async_commit();
  auto load_qc = [&](int stage, int row0) {
    load_tile_async<DP>(qc_s + 2 * stage * kTile, qh, row0, T, D);
    load_tile_async<DP>(qc_s + (2 * stage + 1) * kTile, coh, row0, T, D);
  };
  // on a fully masked tile ds = 0, and p = 0 where m' is above -1e30
  auto rows_ok = [&](int row0) {
    const int row = row0 + threadIdx.x;
    return !(threadIdx.x < kRows && row < T) || mnew[hq + row] > kNegInf;
  };

  float acc_k[kNd][4] = {}, acc_v[kNd][4] = {};
  Visit tile = next_tile<kMasked, false>(mask, 0, col0, T, S, rows_ok);
  if (tile.from < T) load_qc(0, tile.from);
  cp_async_commit();
  for (int stage = 0; tile.from < T; stage ^= 1) {
    const int row0 = tile.from;
    const Visit next = next_tile<kMasked, false>(mask, row0 + kRows, col0,
                                                 T, S, rows_ok);
    if (next.from < T) load_qc(stage ^ 1, next.from);
    cp_async_commit();
    float mn[2], tr[2], ti[2], cl_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + slice + c_row(2 * h);
      const bool ok = row < T;
      mn[h] = ok ? mnew[hq + row] : 0.f;
      tr[h] = ok ? trow[hq + row] : 0.f;
      ti[h] = ok ? tie[hq + row] : 0.f;
      cl_r[h] = ok ? cl[hq + row] : 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();
    const float* q_s = qc_s + 2 * stage * kTile;
    const float* co_s = q_s + kTile;
    float s[kNt][4], dp[kNt][4], ds[kNt][4];
    const unsigned masked = score_tile<DP, kNt, kMasked, kExact>(
        s, dp, q_s + slice * kLd, k_s + keys * kLd, co_s + slice * kLd,
        v_s + keys * kLd, kLd, scale, mask, !tile.unmasked, row0 + slice,
        col0 + keys, T, S);
    const int lanes = S - col0 - keys;  // keys below S: c_col < lanes
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, r = slice + c_row(e);
        const float x = s[nt][e];
        float p = expf(x - mn[h]);
        float d = (dp[nt][e] + cl_r[h]) * p;
        if (x == tr[h]) d += ti[h];
        // rows past T and keys past S add nothing; ds is 0 on a masked
        // lane. ds has taken the f32 p; dv takes p in q/k/v's type.
        const bool out = row0 + r >= T || c_col(nt, e) >= lanes;
        p = out ? 0.f : p;
        ds[nt][e] = out || (masked >> (4 * nt + e) & 1u) ? 0.f : d * scale;
        pd_s[r * kLdT + keys + c_col(nt, e)] =
            sizeof(E) == 2 ? round_bf16(p) : p;
      }
    __syncthreads();
    // dv += p^T co, dk += ds^T q
    mma3_tf32<kRows / 8, kNd, kExact>(acc_v, pd_s + slice, 1, kLdT,
                                      co_s + cols, kLd, 1);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pd_s[(slice + c_row(e)) * kLdT + keys + c_col(nt, e)] = ds[nt][e];
    __syncthreads();
    mma3_tf32<kRows / 8, kNd, false, kExact>(acc_k, pd_s + slice, 1, kLdT,
                                             q_s + cols, kLd, 1);
    __syncthreads();
    tile = next;
  }
#pragma unroll
  for (int nt = 0; nt < kNd; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = col0 + slice + c_row(e), c = cols + c_col(nt, e);
      if (key < S && c < D) {
        store_as(dk + (hk + key) * D + c, acc_k[nt][e]);
        store_as(dv + (hk + key) * D + c, acc_v[nt][e]);
      }
    }
}

// The f32 kernels, and the bf16 ones (q/k/v and dq/dk/dv bf16). Each pass
// keeps the "flash_bwd_" prefix that the build's checks look for.
#define RABIT_BWD_ROWS_PARAMS(E)                                           \
  const E *__restrict__ q, const E *__restrict__ k,                        \
      const E *__restrict__ v, const float *__restrict__ m,                \
      const float *__restrict__ l, const float *__restrict__ o,            \
      const unsigned char *__restrict__ mask, const float *__restrict__ cm, \
      const float *__restrict__ cl, const float *__restrict__ co, int T,    \
      int S, int D, float scale, E *__restrict__ dq,                       \
      float *__restrict__ dm, float *__restrict__ dl,                      \
      float *__restrict__ dO, float *__restrict__ mnew_out,                \
      float *__restrict__ trow_out, float *__restrict__ tie_out
#define RABIT_BWD_ROWS_ARGS                                               \
  q, k, v, m, l, o, mask, cm, cl, co, T, S, D, scale, dq, dm, dl, dO,     \
      mnew_out, trow_out, tie_out
#define RABIT_BWD_COLS_PARAMS(E)                                           \
  const E *__restrict__ q, const E *__restrict__ k,                        \
      const E *__restrict__ v, const unsigned char *__restrict__ mask,     \
      const float *__restrict__ cl, const float *__restrict__ co,          \
      const float *__restrict__ mnew, const float *__restrict__ trow,      \
      const float *__restrict__ tie, int T, int S, int D, float scale,     \
      E *__restrict__ dk, E *__restrict__ dv
#define RABIT_BWD_COLS_ARGS \
  q, k, v, mask, cl, co, mnew, trow, tie, T, S, D, scale, dk, dv

template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DP>)
    flash_bwd_rows(RABIT_BWD_ROWS_PARAMS(float)) {
  bwd_rows<float, DP, kMasked>(RABIT_BWD_ROWS_ARGS);
}

template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DP>)
    flash_bwd_bf16_rows(RABIT_BWD_ROWS_PARAMS(bf16)) {
  bwd_rows<bf16, DP, kMasked>(RABIT_BWD_ROWS_ARGS);
}

template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DP>)
    flash_bwd_cols(RABIT_BWD_COLS_PARAMS(float)) {
  bwd_cols<float, DP, kMasked>(RABIT_BWD_COLS_ARGS);
}

template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DP>)
    flash_bwd_bf16_cols(RABIT_BWD_COLS_PARAMS(bf16)) {
  bwd_cols<bf16, DP, kMasked>(RABIT_BWD_COLS_ARGS);
}

#undef RABIT_BWD_ROWS_PARAMS
#undef RABIT_BWD_ROWS_ARGS
#undef RABIT_BWD_COLS_PARAMS
#undef RABIT_BWD_COLS_ARGS

template <typename E, int DP, bool kMasked>
constexpr auto rows_kernel() {
  if constexpr (sizeof(E) == 2)
    return flash_bwd_bf16_rows<DP, kMasked>;
  else
    return flash_bwd_rows<DP, kMasked>;
}

template <typename E, int DP, bool kMasked>
constexpr auto cols_kernel() {
  if constexpr (sizeof(E) == 2)
    return flash_bwd_bf16_cols<DP, kMasked>;
  else
    return flash_bwd_cols<DP, kMasked>;
}

// One 64 x 64 tile out = a b^T of a, b [64, d] through score_tile (scale
// 1, no mask; its dp, of the same operands, is dropped): the check of the
// 3xTF32 product and its fragment layout.
template <int DP>
__global__ void __launch_bounds__(kThreads)
    mma_tile_check(const float* __restrict__ a, const float* __restrict__ b,
                   int d, float* __restrict__ out) {
  constexpr int kLd = MmaTile<DP>::kLd;
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;
  float* b_s = a_s + kRows * kLd;
  load_tile_async<DP>(a_s, a, 0, kRows, d);
  load_tile_async<DP>(b_s, b, 0, kCols, d);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int w = threadIdx.x / 32, slice = 16 * (w / 2), keys = 32 * (w % 2);
  float s[kNt][4], dp[kNt][4];
  score_tile<DP, kNt, false>(s, dp, a_s + slice * kLd, b_s + keys * kLd,
                             a_s + slice * kLd, b_s + keys * kLd, kLd, 1.f,
                             nullptr, false, 0, 0, kRows, kCols);
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(slice + c_row(e)) * kCols + keys + c_col(nt, e)] = s[nt][e];
}

template <typename E, int DP>
cudaError_t launch(const E* q, const E* k, const E* v, const float* m,
                   const float* l, const float* o, const unsigned char* mask,
                   const float* cm, const float* cl, const float* co, int bh,
                   int T, int S, int D, float scale, E* dq, E* dk, E* dv,
                   float* dm, float* dl, float* dO, float* scratch,
                   cudaStream_t stream) {
  constexpr int kTile = kRows * MmaTile<DP>::kLd;
  float* mnew = scratch;
  float* trow = mnew + static_cast<long long>(bh) * T;
  float* tie = trow + static_cast<long long>(bh) * T;

  const size_t rows_smem =
      sizeof(float) * (6 * kTile + kRows * kLdS + 2 * kRows * 4 + 3 * kRows);
  auto rows = mask != nullptr ? rows_kernel<E, DP, true>()
                               : rows_kernel<E, DP, false>();
  cudaError_t err = allow_smem(rows, rows_smem);
  if (err != cudaSuccess) return err;
  rows<<<dim3((T + kRows - 1) / kRows, bh), kThreads, rows_smem, stream>>>(
      q, k, v, m, l, o, mask, cm, cl, co, T, S, D, scale, dq, dm, dl, dO,
      mnew, trow, tie);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t cols_smem = sizeof(float) * (6 * kTile + kRows * kLdT);
  auto cols = mask != nullptr ? cols_kernel<E, DP, true>()
                               : cols_kernel<E, DP, false>();
  if ((err = allow_smem(cols, cols_smem)) != cudaSuccess) return err;
  cols<<<dim3((S + kCols - 1) / kCols, bh), kThreads, cols_smem, stream>>>(
      q, k, v, mask, cl, co, mnew, trow, tie, T, S, D, scale, dk, dv);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_check(const float* a, const float* b, int d, float* out,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * kRows * MmaTile<DP>::kLd;
  cudaError_t err = allow_smem(mma_tile_check<DP>, smem);
  if (err != cudaSuccess) return err;
  mma_tile_check<DP><<<1, kThreads, smem, stream>>>(a, b, d, out);
  return cudaGetLastError();
}

// q/k/v of element type E: checks the sizes, then the launch of the D
// bucket's instantiation.
template <typename E>
int dispatch(const void* q, const void* k, const void* v, const void* m,
             const void* l, const void* o, const void* mask, const void* cm,
             const void* cl, const void* co, int bh, int t, int s, int d,
             float scale, void* dq, void* dk, void* dv, void* dm, void* dl,
             void* dO, void* scratch, void* stream) {
  if (bh < 1 || bh > 65535 || t < 1 || s < 1 || d < 1 || d > 128)
    return cudaErrorInvalidValue;
#define RABIT_FLASH_BWD_ARGS                                              \
  static_cast<const E*>(q), static_cast<const E*>(k),                     \
      static_cast<const E*>(v), static_cast<const float*>(m),             \
      static_cast<const float*>(l), static_cast<const float*>(o),         \
      static_cast<const unsigned char*>(mask),                            \
      static_cast<const float*>(cm), static_cast<const float*>(cl),       \
      static_cast<const float*>(co), bh, t, s, d, scale,                  \
      static_cast<E*>(dq), static_cast<E*>(dk), static_cast<E*>(dv),      \
      static_cast<float*>(dm), static_cast<float*>(dl),                   \
      static_cast<float*>(dO), static_cast<float*>(scratch),              \
      static_cast<cudaStream_t>(stream)
  if (d <= 16) return launch<E, 16>(RABIT_FLASH_BWD_ARGS);
  if (d <= 32) return launch<E, 32>(RABIT_FLASH_BWD_ARGS);
  if (d <= 64) return launch<E, 64>(RABIT_FLASH_BWD_ARGS);
  return launch<E, 128>(RABIT_FLASH_BWD_ARGS);
#undef RABIT_FLASH_BWD_ARGS
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
  return dispatch<float>(q, k, v, m, l, o, mask, cm, cl, co, bh, t, s, d,
                         scale, dq, dk, dv, dm, dl, dO, scratch, stream);
}

// As rabit_flash_block_bwd_f32, with q [bh, t, d], k/v [bh, s, d] and
// dq/dk/dv bf16; m, l, o, the cotangents, dm, dl, do and the scratch stay
// f32.
int rabit_flash_block_bwd_bf16(const void* q, const void* k, const void* v,
                               const void* m, const void* l, const void* o,
                               const void* mask, const void* cm,
                               const void* cl, const void* co, int bh, int t,
                               int s, int d, float scale, void* dq, void* dk,
                               void* dv, void* dm, void* dl, void* dO,
                               void* scratch, void* stream) {
  return dispatch<bf16>(q, k, v, m, l, o, mask, cm, cl, co, bh, t, s, d,
                        scale, dq, dk, dv, dm, dl, dO, scratch, stream);
}

// out [64, 64] = a b^T for a, b f32 [64, d] on the device, through the
// backward's score-tile function (3xTF32 on the tensor cores). A check of
// the product, not a path of the step. 1 <= d <= 128.
int rabit_flash_mma_tile_f32(const void* a, const void* b, int d, void* out,
                             void* stream) {
  if (d < 1 || d > 128) return cudaErrorInvalidValue;
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch_check<16>(pa, pb, d, po, st);
  if (d <= 32) return launch_check<32>(pa, pb, d, po, st);
  if (d <= 64) return launch_check<64>(pa, pb, d, po, st);
  return launch_check<128>(pa, pb, d, po, st);
}

const char* rabit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
