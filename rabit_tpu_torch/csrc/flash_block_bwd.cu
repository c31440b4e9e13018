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
// memory. Two launches, 8 warps a block in four pairs, a pair for each
// 16-row slice of a 64-row tile:
//   (a) *_rows, a block per (64 query rows, head), two passes over the key
//       tiles. Pass 1 forms s = q k^T and dp = co v^T a tile and keeps,
//       per row, the running max t, its tie count and sum_j (dp + cl)
//       exp(s - m'), rescaled whenever m' = max(m, t) rises; then dm', sel
//       and the tie term are known, and it writes dm, dl, do and the
//       per-row (m', t, tie term) scratch. Pass 2 forms s and dp again,
//       then ds, staged in shared memory, and dq += ds k.
//   (b) *_cols, a block per (64 keys, head): streams the query tiles,
//       forms s and dp, then p and ds from the scratch of (a), each staged
//       in shared memory, and accumulates dv = p^T co, dk = ds^T q.
// The two warps of a pair split the tile's 64 keys for s and dp (so each
// (query, key) element is one warp's mma sequence) and the D columns of
// dq, dk and dv. Both kernels of a type form s with rabit_mma::score_tile,
// so the test s == t finds the same lanes in (a) and (b). K/V (or q) tiles
// stream through two shared-memory stages by cp.async, the next tile in
// flight while the current one is multiplied. Every pass skips a tile
// that the mask covers wherever that is exact (next_tile's rule): about
// half the tiles under a causal mask; a tile that the mask leaves whole
// is multiplied without reading the mask. dq stays in the row kernel:
// summing it from the column blocks would take f32 atomics, whose order,
// and so whose bits, change from run to run; this port keeps its
// gradients bit-reproducible.
//
// The f32 kernels (rabit_flash_block_bwd_f32): every product on the
// tensor cores at f32 accuracy through the 3xTF32 split (flash_mma.cuh):
// three TF32 mma.sync products a step, within about 1e-6 of f64 on a dot
// of width 128; ds and p staged as f32; the mask read tile by tile
// (next_tile). Work: 9 products of 2 D flops a (query, key) pair that the
// mask leaves (a: s and dp twice, ds k; b: s, dp, p^T co, ds^T q), 27
// TF32 mma a pair, against the 5 of the bound. Bound: operations. 10 D
// flops (five products) for each pair the mask leaves, on about 4 D words
// a row and key; at f32 accuracy the card does them on the tensor cores
// at 495 / 3 = 165 TFLOP/s (3xTF32). At the training shape (BH 64, T = S
// = 512, D 32, causal) 2.69 GFLOP, 16.3 us; at the ring chain's block (BH
// 8, T = S = 1024, D 128) 10.7 GFLOP, 65 us.
//
// The bf16 kernels (rabit_flash_block_bwd_bf16; the TPU kernel's bf16
// q/k/v contract, pallas_kernels.py:275-318): the same launches, passes,
// warp split, sums, skip and tie rules, on the bf16 tensor cores.
//   - q, k and v stay bf16 in shared memory, [64, DP + 8] tiles staged by
//     cp.async: K/V in (a) and q in (b) through the two stages.
//   - s = q k^T is the forward's bf16 score_tile, one mma.sync.m16n8k16 a
//     k-step of 16 with f32 sums, in both kernels: the forward and both
//     backward kernels form a pair's s by the same mma sequence.
//   - Every other product of the contract has one f32 operand, co or ds,
//     and rounding it once to bf16 would put dq, dk and dv about 2e-3 off
//     (over the 1e-3 the kernel is held to). So each is split into two
//     bf16 halves, hi = bf16_rn(x) and lo = bf16_rn(x - hi), |x - hi - lo|
//     <= 2^-16 |x| (flash_mma.cuh), and each product takes two bf16
//     products, the small term first: dp = co_lo v^T + co_hi v^T, dv =
//     bf16(p)^T co_lo + bf16(p)^T co_hi, dq = ds_lo k + ds_hi k, dk =
//     ds_lo^T q + ds_hi^T q. co is split once, as it lands (once a block
//     in (a), once a query tile in (b), from an f32 stage); ds as it is
//     formed, staged as its lo and hi tiles. 15 bf16 products of k 16 a
//     pair (a: s and dp twice, dq; b: s, dp, dv, dk), at twice TF32's
//     rate and with no split in the loop.
//   - Fragments by ldmatrix: .x4 where k runs along a tile's rows, .trans
//     where it runs down the columns (k in ds k; p^T and ds^T as A; co
//     and q as B in dv and dk).
//   - The mask by bits (flash_common.cuh): each pass reads a key tile's
//     (a) or a query tile's (b) flags, some pair masked and some
//     unmasked, once for a chunk of 64 tiles with 16-byte loads; (b)'s
//     also say whether a row of the query tile has m' at -1e30. The skip
//     rules are next_tile's; pass 1's rows condition is marked by the pair
//     that owns a row and met at the tile's barrier.
//   - Barriers a tile: pass 1 one (and one of the pair with a mask), pass
//     2 one and one of the pair, (b) three.
// Two roundings are the contract's own: (b) rounds p to bf16 to nearest
// even against the final m' of the scratch, for dv = bf16(p)^T co alone
// (ds, and the row kernel's pass 1, take the f32 p), and dq, dk and dv
// round to bf16 at the store from their f32 sums. dm, dl and do stay f32.
// Bound at bf16: 10 D flops a pair at 989 TFLOP/s of dense bf16 against
// q, k, v and their gradients at 2 B and m, l, o, the cotangents, dm, dl
// and do at 4 B: at the training shape about 26 MB, 7.8 us (bytes),
// against 2.7 us; at the chain block 10.7 GFLOP, 10.9 us (operations),
// against 7.6 us.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return the first launch error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace rabit_flash;
using namespace rabit_mma;

constexpr int kNt = 4;            // 8-key C tiles of a warp's 32 keys
constexpr int kLdS = kCols + 4;   // f32 ds in (a): read as A rows
constexpr int kLdT = kCols + 8;   // f32 p, ds in (b): read as A columns

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The first tile from `from` on (a key tile of rows [row0, row0 + 64), or
// a query tile of keys [col0, col0 + 64)) that a pass of the f32 kernels
// must visit. A tile
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

// The f32 kernels: up to D 32 two blocks share an SM (at most 128
// registers a thread and 74-76 KB of shared memory a block); from D 64 on
// the shared memory holds one block, which may then take up to 255
// registers a thread.
template <int DP>
constexpr int kMinBlocks = DP <= 32 ? 2 : 1;

// The f32 row kernel's work. kMasked (here and in the other bodies):
// whether mask is given; the kernels without one read no mask.
template <int DP, bool kMasked>
__device__ __forceinline__ void bwd_rows(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ o,
    const unsigned char* __restrict__ mask, const float* __restrict__ cm,
    const float* __restrict__ cl, const float* __restrict__ co, int T, int S,
    int D, float scale, float* __restrict__ dq, float* __restrict__ dm,
    float* __restrict__ dl, float* __restrict__ dO,
    float* __restrict__ mnew_out, float* __restrict__ trow_out,
    float* __restrict__ tie_out) {
  constexpr int kLd = MmaTile<DP>::kLd;
  constexpr int kTile = kRows * kLd;
  constexpr int kNq = DP / 16;  // 8-column C tiles of the warp's dq half
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
  const float* kh = k + hk * D;
  const float* vh = v + hk * D;
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
    return score_tile<DP, kNt, kMasked>(
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
    mma3_tf32<kCols / 8, kNq>(acc, ds_s + slice * kLdS, kLdS, 1, k_s + cols,
                              kLd, 1);
    __syncthreads();
    tile = next;
  }
#pragma unroll
  for (int nt = 0; nt < kNq; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + slice + c_row(e), c = cols + c_col(nt, e);
      if (row < T && c < D) dq[(hq + row) * D + c] = acc[nt][e];
    }
}

// The f32 column kernel's work.
template <int DP, bool kMasked>
__device__ __forceinline__ void bwd_cols(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ mask,
    const float* __restrict__ cl, const float* __restrict__ co,
    const float* __restrict__ mnew, const float* __restrict__ trow,
    const float* __restrict__ tie, int T, int S, int D, float scale,
    float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int kLd = MmaTile<DP>::kLd;
  constexpr int kTile = kRows * kLd;
  constexpr int kNd = DP / 16;  // 8-column C tiles of the warp's dk, dv half
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                  // [kCols, kLd], resident
  float* v_s = k_s + kTile;           // [kCols, kLd], resident
  float* qc_s = v_s + kTile;          // [2 stages][q, co][kRows, kLd]
  float* pd_s = qc_s + 4 * kTile;     // [kRows, kLdT]: p, then ds

  const int col0 = blockIdx.x * kCols;
  const long long hq = static_cast<long long>(blockIdx.y) * T;
  const long long hk = static_cast<long long>(blockIdx.y) * S;
  const float* qh = q + hq * D;
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
    const unsigned masked = score_tile<DP, kNt, kMasked>(
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
        // lane
        const bool out = row0 + r >= T || c_col(nt, e) >= lanes;
        p = out ? 0.f : p;
        ds[nt][e] = out || (masked >> (4 * nt + e) & 1u) ? 0.f : d * scale;
        pd_s[r * kLdT + keys + c_col(nt, e)] = p;
      }
    __syncthreads();
    // dv += p^T co, dk += ds^T q
    mma3_tf32<kRows / 8, kNd>(acc_v, pd_s + slice, 1, kLdT, co_s + cols, kLd,
                              1);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pd_s[(slice + c_row(e)) * kLdT + keys + c_col(nt, e)] = ds[nt][e];
    __syncthreads();
    mma3_tf32<kRows / 8, kNd>(acc_k, pd_s + slice, 1, kLdT, q_s + cols, kLd,
                              1);
    __syncthreads();
    tile = next;
  }
#pragma unroll
  for (int nt = 0; nt < kNd; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = col0 + slice + c_row(e), c = cols + c_col(nt, e);
      if (key < S && c < D) {
        dk[(hk + key) * D + c] = acc_k[nt][e];
        dv[(hk + key) * D + c] = acc_v[nt][e];
      }
    }
}

// ---- the bf16 kernels ----

// Shared memory of the bf16 kernels. q, co's halves, K and V as bf16
// [64, kLd] tiles (MmaTileBf16: rows 16-byte aligned, ldmatrix free of
// bank conflicts), p and ds's halves as bf16 [64, kLdP] tiles (72 bf16 =
// 36 words a row, 4 mod 8: the same rule), the column kernel's co as f32
// [64, kLdC] as it lands.
template <int DP>
struct SmemBf16 {
  static constexpr int kLd = MmaTileBf16<DP>::kLd;
  static constexpr int kLdP = kCols + 8;
  static constexpr int kLdC = MmaTile<DP>::kLd;
  static constexpr int kTile = kRows * kLd;   // bf16 elements
  static constexpr int kPTile = kRows * kLdP;  // bf16 elements
  // rows: q, co (lo, hi), two stages of (K, V), ds (lo, hi); part_s,
  // dalpha_s, alpha_s, seen_s, bits_s
  static constexpr size_t kRowsBytes =
      sizeof(bf16) * (7 * kTile + 2 * kPTile) +
      sizeof(float) * (2 * kRows * 4 + 2 * kRows) + sizeof(int) * kRows +
      sizeof(unsigned) * kChunk;
  // cols: K, V, two stages of q, co (lo, hi), p, ds (lo, hi); co as f32,
  // bits_s
  static constexpr size_t kColsBytes =
      sizeof(bf16) * (6 * kTile + 3 * kPTile) +
      sizeof(float) * kRows * kLdC + sizeof(unsigned) * kChunk;
};

// A gradient's pair of neighbouring columns (c, c + 1) of row `at` / D,
// rounded to bf16: one 4-byte store where D is even (c is), else each
// column below D on its own.
__device__ __forceinline__ void store_pair(bf16* dst, long long at, int c,
                                           int D, float x0, float x1) {
  if (D % 2 == 0) {
    if (c < D)
      *reinterpret_cast<__nv_bfloat162*>(dst + at) =
          __floats2bfloat162_rn(x0, x1);
  } else {
    if (c < D) dst[at] = __float2bfloat16_rn(x0);
    if (c + 1 < D) dst[at + 1] = __float2bfloat16_rn(x1);
  }
}

// Blocks an SM, from ptxas and the timings (H100 80GB HBM3, 700 W). To D
// 32 two (shared memory: row kernel 43 and 57.3 KB at D 16 and 32, column
// kernel 51.5 and 67.8 KB), which may take up to 128 registers a thread:
// at one block an SM the training shape took 0.223 ms against 0.160. From
// D 64 one (D 64: 86 and 100.6 KB; D 128: 143.4 and 166.1 KB), up to 255
// registers: at 128 the D-64 kernels spilled 4-16 B. The row kernel
// without a mask (kRowsUnmasked) takes one block from D 32 on: at 128
// registers it spilled about 100 B (no main path runs it at D 32). The
// ring chain's D-128 block (H 8, T 1024) launches 128 blocks a kernel for
// 132 SMs, so a second slot would stay empty there.
template <int DP, bool kRowsUnmasked = false>
constexpr int kMinBlocksBf16 =
    DP <= 16 || (DP <= 32 && !kRowsUnmasked) ? 2 : 1;

// The row kernel's prologue: rows [row0, row0 + 64) of the head's co and
// o ([T, D] f32): co split into its lo and hi halves (co_s, [lo, hi][64,
// kLd]; zero past T and D) and dalpha_s[r] = cl l + sum_d co o. Where D %
// 4 == 0 and the rows are 16-byte aligned, a thread takes 4 columns a
// chunk, every chunk's loads in flight together, and a row's partial sums
// meet over its DP / 4 neighbouring lanes in a fixed order; else a warp
// takes 8 rows, a column a lane.
template <int DP>
__device__ __forceinline__ void split_co_dalpha(
    bf16* co_s, float* dalpha_s, const float* co, const float* o,
    const float* cl, const float* l, int row0, int T, int D) {
  constexpr int kLd = SmemBf16<DP>::kLd, kTile = SmemBf16<DP>::kTile;
  constexpr int kC = DP / 4;                   // chunks a row
  constexpr int kPer = kRows * kC / kThreads;  // chunks a thread
  const int lane = threadIdx.x % 32;
  if (D % 4 == 0 && reinterpret_cast<uintptr_t>(co) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(o) % 16 == 0) {
    float4 xc[kPer], xo[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int idx = threadIdx.x + j * kThreads, r = idx / kC;
      const int c = 4 * (idx % kC), row = row0 + r;
      xc[j] = xo[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < T && c < D) {
        xc[j] = *reinterpret_cast<const float4*>(
            co + static_cast<long long>(row) * D + c);
        xo[j] = *reinterpret_cast<const float4*>(
            o + static_cast<long long>(row) * D + c);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int idx = threadIdx.x + j * kThreads, r = idx / kC;
      const int c = 4 * (idx % kC), row = row0 + r;
      __nv_bfloat162 hi[2], lo[2];
      split_bf16(xc[j].x, xc[j].y, hi[0], lo[0]);
      split_bf16(xc[j].z, xc[j].w, hi[1], lo[1]);
      *reinterpret_cast<uint2*>(co_s + r * kLd + c) =
          *reinterpret_cast<const uint2*>(lo);
      *reinterpret_cast<uint2*>(co_s + kTile + r * kLd + c) =
          *reinterpret_cast<const uint2*>(hi);
      float acc = fmaf(xc[j].x, xo[j].x, 0.f);
      acc = fmaf(xc[j].y, xo[j].y, acc);
      acc = fmaf(xc[j].z, xo[j].z, acc);
      acc = fmaf(xc[j].w, xo[j].w, acc);
#pragma unroll
      for (int off = 1; off < kC; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (idx % kC == 0)
        dalpha_s[r] = row < T ? cl[row] * l[row] + acc : 0.f;
    }
    return;
  }
  const int w = threadIdx.x / 32;
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * w + i, row = row0 + r;
    float acc = 0.f;
    for (int c = lane; c < DP; c += 32) {
      const bool in = row < T && c < D;
      const float x = in ? co[static_cast<long long>(row) * D + c] : 0.f;
      if (in) acc = fmaf(x, o[static_cast<long long>(row) * D + c], acc);
      const bf16 hi = __float2bfloat16_rn(x);
      co_s[r * kLd + c] =
          __float2bfloat16_rn(__fsub_rn(x, __bfloat162float(hi)));
      co_s[kTile + r * kLd + c] = hi;
    }
    acc = warp_sum(acc);
    if (lane == 0) dalpha_s[r] = row < T ? cl[row] * l[row] + acc : 0.f;
  }
}

// The bf16 row kernel's work. co is split once into its bf16 halves as
// the block starts; s = q k^T (score_tile), dp = co_lo v^T + co_hi v^T,
// and pass 2 stages ds's halves for dq = ds_lo k + ds_hi k. The bits of
// the mask pick the key tiles.
template <int DP, bool kMasked>
__device__ __forceinline__ void bwd_rows_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ o,
    const unsigned char* __restrict__ mask, const float* __restrict__ cm,
    const float* __restrict__ cl, const float* __restrict__ co, int T, int S,
    int D, float scale, bf16* __restrict__ dq, float* __restrict__ dm,
    float* __restrict__ dl, float* __restrict__ dO,
    float* __restrict__ mnew_out, float* __restrict__ trow_out,
    float* __restrict__ tie_out) {
  using L = SmemBf16<DP>;
  constexpr int kLd = L::kLd, kLdP = L::kLdP, kTile = L::kTile;
  constexpr int kNq = DP / 16;  // 8-column C tiles of the warp's dq half
  extern __shared__ __align__(16) float smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kRows, kLd]
  bf16* co_s = q_s + kTile;                   // [lo, hi][kRows, kLd]
  bf16* kv_s = co_s + 2 * kTile;              // [2 stages][K, V][kCols, kLd]
  bf16* ds_s = kv_s + 4 * kTile;              // [lo, hi][kRows, kLdP]
  float* part_s = reinterpret_cast<float*>(ds_s + 2 * L::kPTile);
  float* dalpha_s = part_s + 2 * kRows * 4;  // [kRows]
  float* alpha_s = dalpha_s + kRows;         // [kRows]
  int* seen_s = reinterpret_cast<int*>(alpha_s + kRows);      // [kRows]
  unsigned* bits_s = reinterpret_cast<unsigned*>(seen_s + kRows);

  const int row0 = blockIdx.x * kRows;
  const long long hq = static_cast<long long>(blockIdx.y) * T;
  const long long hk = static_cast<long long>(blockIdx.y) * S;
  const bf16* kh = k + hk * D;
  const bf16* vh = v + hk * D;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = w / 2, slice = 16 * pair, half = w % 2;  // rows slice..
  const int keys = 32 * half;        // s, dp: keys keys.. + 32
  const int cols = half * (DP / 2);  // dq: columns cols.. + DP/2

  load_tile_async<DP>(q_s, q + hq * D, row0, T, D);
  cp_async_commit();
  if (threadIdx.x < kRows) seen_s[threadIdx.x] = 0;
  auto load_kv = [&](int stage, int col0) {
    load_tile_async<DP>(kv_s + 2 * stage * kTile, kh, col0, S, D);
    load_tile_async<DP>(kv_s + (2 * stage + 1) * kTile, vh, col0, S, D);
  };
  // the first key tile from j on to visit: one that holds an unmasked
  // pair, or any where `rows_ok` is false. Pass 1 may skip a masked tile
  // once every row that exists has had a score above -1e30 (seen); pass 2
  // skips every masked tile (ds = 0 there). Reads the bits of another
  // chunk where it needs them (the same on every thread, so the barriers
  // of mask_bits are met).
  int chunk = -1;
  auto next_visit = [&](int j, bool rows_ok) -> Visit {
    if constexpr (kMasked) {
      for (; j * kCols < S; ++j) {
        if (j / kChunk != chunk) {
          chunk = j / kChunk;
          mask_bits(bits_s, mask, row0, chunk * kChunk, T, S);
        }
        const unsigned b = bits_s[j % kChunk];
        if ((b & kSomeUnmasked) || !rows_ok)
          return {j * kCols, (b & kSomeMasked) == 0};
      }
    }
    return {j * kCols, true};
  };
  // a barrier; with a mask, also whether every row of the block that
  // exists is seen. A thread asks for its pair's rows, which its pair
  // marks (then meets at the pair barrier) as it leaves a tile.
  auto seen = [&] {
    if constexpr (!kMasked) {
      __syncthreads();
      return true;
    }
    bool ok = true;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = slice + c_row(2 * h);
      ok = ok && (row0 + r >= T || seen_s[r] != 0);
    }
    return __syncthreads_and(ok) != 0;
  };
  // the s and dp of this warp's 16 rows x 32 keys of the key tile at
  // tile.from (k_s, then its V); returns the masked lanes' bits
  float s[kNt][4], dp[kNt][4];
  auto scores = [&](const bf16* k_s, Visit tile) {
    const unsigned masked = score_tile<DP, kNt, kMasked>(
        s, q_s + slice * kLd, k_s + keys * kLd, kLd, scale, mask,
        !tile.unmasked, row0 + slice, tile.from + keys, T, S);
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
    const bf16* const a[2] = {co_s + slice * kLd, co_s + kTile + slice * kLd};
    const bf16* const b[1] = {k_s + kTile + keys * kLd};
    mma_bf16_sum<DP, kNt, false, false, 2, 1>(dp, a, kLd, b, kLd);
    return masked;
  };

  Visit tile = next_visit(0, false);
  if (tile.from < S) load_kv(0, tile.from);
  cp_async_commit();
  // co split into its halves, and dalpha = cl l + sum_d co o (the loads
  // overlap the copies in flight)
  split_co_dalpha<DP>(co_s, dalpha_s, co + hq * D, o + hq * D, cl + hq,
                      l + hq, row0, T, D);

  // this thread's rows slice + c_row(e): h = 0 for e < 2, 1 for e >= 2
  float m_in[2], cl_in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + slice + c_row(2 * h);
    m_in[h] = row < T ? m[hq + row] : kNegInf;
    cl_in[h] = row < T ? cl[hq + row] : 0.f;
  }

  // pass 1: this thread's part of t, its count and sum_j (dp + cl) p. A
  // key past S is no lane: -inf, so it neither sets t nor adds to the sum
  // (a part that saw only such keys loses every merge)
  float t_run[2] = {-INFINITY, -INFINITY}, n_run[2] = {0.f, 0.f};
  float sum_run[2] = {0.f, 0.f}, m_run[2] = {m_in[0], m_in[1]};
  for (int stage = 0; tile.from < S; stage ^= 1) {
    cp_async_wait<0>();
    // the tile (and q, co, dalpha) landed; the other stage is free
    const Visit next = next_visit(tile.from / kCols + 1, seen());
    if (next.from < S) load_kv(stage ^ 1, next.from);
    cp_async_commit();
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
    if constexpr (kMasked) pair_sync(pair);
    tile = next;
  }
  cp_async_wait<0>();

  // the row's parts: the 4 lanes of a quad, then the two warps of a pair
  // (merged in one order, so both get the same bits); pass 2's first tile
  // loads meanwhile
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
  Visit tile2 = next_visit(0, true);  // every warp left pass 1
  if (tile2.from < S) load_kv(0, tile2.from);
  cp_async_commit();
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
  // do = co alpha: the block's rows of co are contiguous
  const int n_rows = min(kRows, T - row0);
  for (int idx = threadIdx.x; idx < n_rows * D; idx += kThreads)
    dO[(hq + row0) * D + idx] = co[(hq + row0) * D + idx] * alpha_s[idx / D];

  // pass 2: ds, staged as its halves, and dq = ds_lo k + ds_hi k
  float acc[kNq][4] = {};
  tile = tile2;
  for (int stage = 0; tile.from < S; stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // the tile landed; the last tile's readers are done
    const Visit next = next_visit(tile.from / kCols + 1, true);
    if (next.from < S) load_kv(stage ^ 1, next.from);
    cp_async_commit();
    const bf16* k_s = kv_s + 2 * stage * kTile;
    const unsigned masked = scores(k_s, tile);
    const int lanes = S - tile.from - keys;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float d2[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * h + j;
          const float x = s[nt][e];
          float ds = (dp[nt][e] + cl_in[h]) * expf(x - m_new[h]);
          if (x == t_row[h]) ds += tie[h];
          // 0 on a masked lane and past S
          d2[j] = (masked >> (4 * nt + e) & 1u) || c_col(nt, e) >= lanes
                      ? 0.f
                      : ds * scale;
        }
        __nv_bfloat162 hi, lo;
        split_bf16(d2[0], d2[1], hi, lo);
        const int at = (slice + c_row(2 * h)) * kLdP + keys + c_col(nt, 2 * h);
        *reinterpret_cast<__nv_bfloat162*>(ds_s + at) = lo;
        *reinterpret_cast<__nv_bfloat162*>(ds_s + L::kPTile + at) = hi;
      }
    pair_sync(pair);  // the pair's rows of ds, all 64 keys
    const bf16* const a[2] = {ds_s + slice * kLdP,
                              ds_s + L::kPTile + slice * kLdP};
    const bf16* const b[1] = {k_s + cols};
    mma_bf16_sum<kCols, kNq, false, true, 2, 1>(acc, a, kLdP, b, kLd);
    tile = next;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int nt = 0; nt < kNq; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + slice + c_row(2 * h);
      const int c = cols + c_col(nt, 2 * h);
      if (row < T)
        store_pair(dq, (hq + row) * D + c, c, D, acc[nt][2 * h],
                   acc[nt][2 * h + 1]);
    }
}

// The bf16 column kernel's work. Each query tile's co lands as f32 and is
// split once into its bf16 halves; s = q k^T (score_tile), dp = co_lo v^T
// + co_hi v^T; p rounds to bf16 for dv = bf16(p)^T co_lo + bf16(p)^T co_hi
// alone (the forward's p v takes p so), against the final m' of the
// scratch; ds is staged as its halves for dk = ds_lo^T q + ds_hi^T q. The
// bits of the mask and of the scratch's m' pick the query tiles.
template <int DP, bool kMasked>
__device__ __forceinline__ void bwd_cols_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
    const float* __restrict__ cl, const float* __restrict__ co,
    const float* __restrict__ mnew, const float* __restrict__ trow,
    const float* __restrict__ tie, int T, int S, int D, float scale,
    bf16* __restrict__ dk, bf16* __restrict__ dv) {
  using L = SmemBf16<DP>;
  constexpr int kLd = L::kLd, kLdP = L::kLdP, kLdC = L::kLdC;
  constexpr int kTile = L::kTile;
  constexpr int kNd = DP / 16;  // 8-column C tiles of the warp's dk, dv half
  extern __shared__ __align__(16) float smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kCols, kLd], resident
  bf16* v_s = k_s + kTile;                    // [kCols, kLd], resident
  bf16* q_s = v_s + kTile;                    // [2 stages][kRows, kLd]
  bf16* co_s = q_s + 2 * kTile;               // [lo, hi][kRows, kLd]
  bf16* p_s = co_s + 2 * kTile;               // [kRows, kLdP]: bf16(p)
  bf16* ds_s = p_s + L::kPTile;               // [lo, hi][kRows, kLdP]
  // co as it lands, f32 [kRows, kLdC]
  float* cof_s = reinterpret_cast<float*>(ds_s + 2 * L::kPTile);
  unsigned* bits_s = reinterpret_cast<unsigned*>(cof_s + kRows * kLdC);

  const int col0 = blockIdx.x * kCols;
  const long long hq = static_cast<long long>(blockIdx.y) * T;
  const long long hk = static_cast<long long>(blockIdx.y) * S;
  const bf16* qh = q + hq * D;
  const float* coh = co + hq * D;
  const int w = threadIdx.x / 32;
  // s, dp: query rows slice.. + 16 x keys keys.. + 32; dk, dv: keys
  // slice.. + 16 x columns cols.. + DP/2
  const int slice = 16 * (w / 2), half = w % 2;
  const int keys = 32 * half, cols = half * (DP / 2);

  load_tile_async<DP>(k_s, k + hk * D, col0, S, D);
  load_tile_async<DP>(v_s, v + hk * D, col0, S, D);
  cp_async_commit();
  // the first query tile from i on to visit: one that holds an unmasked
  // pair, or a row whose m' is -1e30 (on a fully masked tile ds = 0, and
  // p = 0 where m' is above -1e30). Barriers as next_visit's in the row
  // kernel.
  int chunk = -1;
  auto next_visit = [&](int i) -> Visit {
    if constexpr (kMasked) {
      for (; i * kRows < T; ++i) {
        if (i / kChunk != chunk) {
          chunk = i / kChunk;
          mask_bits_cols(bits_s, mask, mnew + hq, col0, chunk * kChunk, T,
                         S);
        }
        const unsigned b = bits_s[i % kChunk];
        if (b & (kSomeUnmasked | kSomeRowNegInf))
          return {i * kRows, (b & kSomeMasked) == 0};
      }
    }
    return {i * kRows, true};
  };
  auto load_q = [&](int stage, int row0) {
    load_tile_async<DP>(q_s + stage * kTile, qh, row0, T, D);
  };

  float acc_k[kNd][4] = {}, acc_v[kNd][4] = {};
  Visit tile = next_visit(0);
  if (tile.from < T) {
    load_q(0, tile.from);
    load_tile_async<DP, kLdC>(cof_s, coh, tile.from, T, D);
  }
  cp_async_commit();
  for (int stage = 0; tile.from < T; stage ^= 1) {
    const int row0 = tile.from;
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
    cp_async_wait<0>();
    __syncthreads();  // q and co landed; the last tile's readers are done
    const Visit next = next_visit(row0 / kRows + 1);
    if (next.from < T) load_q(stage ^ 1, next.from);
    // co -> its halves, four neighbouring columns a thread
#pragma unroll
    for (int idx = threadIdx.x; idx < kRows * DP / 4; idx += kThreads) {
      const int r = idx / (DP / 4), c = 4 * (idx % (DP / 4));
      const float4 x =
          *reinterpret_cast<const float4*>(cof_s + r * kLdC + c);
      __nv_bfloat162 hi[2], lo[2];
      split_bf16(x.x, x.y, hi[0], lo[0]);
      split_bf16(x.z, x.w, hi[1], lo[1]);
      *reinterpret_cast<uint2*>(co_s + r * kLd + c) =
          *reinterpret_cast<const uint2*>(lo);
      *reinterpret_cast<uint2*>(co_s + kTile + r * kLd + c) =
          *reinterpret_cast<const uint2*>(hi);
    }
    __syncthreads();  // co's halves are in; its f32 stage is free
    if (next.from < T) load_tile_async<DP, kLdC>(cof_s, coh, next.from, T, D);
    cp_async_commit();

    const bf16* q_t = q_s + stage * kTile;
    float s[kNt][4], dp[kNt][4];
    const unsigned masked = score_tile<DP, kNt, kMasked>(
        s, q_t + slice * kLd, k_s + keys * kLd, kLd, scale, mask,
        !tile.unmasked, row0 + slice, col0 + keys, T, S);
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
    {
      const bf16* const a[2] = {co_s + slice * kLd,
                                co_s + kTile + slice * kLd};
      const bf16* const b[1] = {v_s + keys * kLd};
      mma_bf16_sum<DP, kNt, false, false, 2, 1>(dp, a, kLd, b, kLd);
    }
    const int lanes = S - col0 - keys;  // keys below S: c_col < lanes
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p2[2], d2[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * h + j, r = slice + c_row(e);
          const float x = s[nt][e];
          const float p = expf(x - mn[h]);
          float d = (dp[nt][e] + cl_r[h]) * p;
          if (x == tr[h]) d += ti[h];
          // rows past T and keys past S add nothing; ds is 0 on a masked
          // lane. ds takes the f32 p, dv bf16(p).
          const bool out = row0 + r >= T || c_col(nt, e) >= lanes;
          p2[j] = out ? 0.f : p;
          d2[j] = out || (masked >> (4 * nt + e) & 1u) ? 0.f : d * scale;
        }
        const int at = (slice + c_row(2 * h)) * kLdP + keys + c_col(nt, 2 * h);
        *reinterpret_cast<__nv_bfloat162*>(p_s + at) =
            __floats2bfloat162_rn(p2[0], p2[1]);
        __nv_bfloat162 hi, lo;
        split_bf16(d2[0], d2[1], hi, lo);
        *reinterpret_cast<__nv_bfloat162*>(ds_s + at) = lo;
        *reinterpret_cast<__nv_bfloat162*>(ds_s + L::kPTile + at) = hi;
      }
    __syncthreads();
    // dv += p^T co_lo + p^T co_hi, dk += ds_lo^T q + ds_hi^T q: the
    // warp's keys slice.. + 16 x columns cols.. + DP/2, k the 64 queries
    {
      const bf16* const a[1] = {p_s + slice};
      const bf16* const b[2] = {co_s + cols, co_s + kTile + cols};
      mma_bf16_sum<kRows, kNd, true, true, 1, 2>(acc_v, a, kLdP, b, kLd);
    }
    {
      const bf16* const a[2] = {ds_s + slice, ds_s + L::kPTile + slice};
      const bf16* const b[1] = {q_t + cols};
      mma_bf16_sum<kRows, kNd, true, true, 2, 1>(acc_k, a, kLdP, b, kLd);
    }
    tile = next;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int nt = 0; nt < kNd; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = col0 + slice + c_row(2 * h);
      const int c = cols + c_col(nt, 2 * h);
      if (key < S) {
        store_pair(dk, (hk + key) * D + c, c, D, acc_k[nt][2 * h],
                   acc_k[nt][2 * h + 1]);
        store_pair(dv, (hk + key) * D + c, c, D, acc_v[nt][2 * h],
                   acc_v[nt][2 * h + 1]);
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
  bwd_rows<DP, kMasked>(RABIT_BWD_ROWS_ARGS);
}

template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads, kMinBlocksBf16<DP, !kMasked>)
    flash_bwd_bf16_rows(RABIT_BWD_ROWS_PARAMS(bf16)) {
  bwd_rows_bf16<DP, kMasked>(RABIT_BWD_ROWS_ARGS);
}

template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DP>)
    flash_bwd_cols(RABIT_BWD_COLS_PARAMS(float)) {
  bwd_cols<DP, kMasked>(RABIT_BWD_COLS_ARGS);
}

template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads, kMinBlocksBf16<DP>)
    flash_bwd_bf16_cols(RABIT_BWD_COLS_PARAMS(bf16)) {
  bwd_cols_bf16<DP, kMasked>(RABIT_BWD_COLS_ARGS);
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
  constexpr bool kBf16 = sizeof(E) == 2;
  constexpr int kTile = kRows * MmaTile<DP>::kLd;
  float* mnew = scratch;
  float* trow = mnew + static_cast<long long>(bh) * T;
  float* tie = trow + static_cast<long long>(bh) * T;

  const size_t rows_smem =
      kBf16 ? SmemBf16<DP>::kRowsBytes
            : sizeof(float) *
                  (6 * kTile + kRows * kLdS + 2 * kRows * 4 + 3 * kRows);
  auto rows = mask != nullptr ? rows_kernel<E, DP, true>()
                               : rows_kernel<E, DP, false>();
  cudaError_t err = allow_smem(rows, rows_smem);
  if (err != cudaSuccess) return err;
  rows<<<dim3((T + kRows - 1) / kRows, bh), kThreads, rows_smem, stream>>>(
      q, k, v, m, l, o, mask, cm, cl, co, T, S, D, scale, dq, dm, dl, dO,
      mnew, trow, tie);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t cols_smem = kBf16 ? SmemBf16<DP>::kColsBytes
                                 : sizeof(float) * (6 * kTile + kRows * kLdT);
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
