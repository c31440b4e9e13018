// Flash-attention block step for Hopper (sm_90a): one online-softmax
// update of a running (m, l, o) over a block of keys, per head h:
//   s  = q k^T * scale, masked lanes set to -1e30
//   m' = max(m, rowmax s);  alpha = exp(m - m');  p = exp(s - m')
//   l' = l alpha + sum_j p;  o' = o alpha + p v
// q [BH, T, D], k/v [BH, S, D] all f32 or all bf16; m/l [BH, T], o [BH,
// T, D] f32; mask u8 [T, S] (non-zero = masked) shared by every head, or
// null.
//
// Replaces the TPU kernel rabit_tpu/ops/pallas_kernels.py::flash_block
// (body _flash_block_body). That program holds one head's whole [T, S]
// score tile in VMEM (1 MB at T = S = 512 in f32); an SM has 228 KB of
// shared memory. So the work is tiled: a block keeps a 64-row query tile
// in shared memory and streams 64-key tiles of K and V through two
// cp.async stages (tile j + 1 in flight while tile j is multiplied),
// carrying a running max and sum (the online softmax) from the incoming
// (m, l, o) to (m', l', o'). The result equals the single-pass formula up
// to f32 rounding (the rescale by alpha is applied per key tile).
//
// Both products run on the tensor cores at f32 accuracy, 3xTF32
// mma.sync (flash_mma.cuh): s = q k^T through score_tile, queries as A
// and keys as B, the backward's very mma sequence, so a (query, key) pair
// gets the same s here as in both backward kernels; then p, staged in
// shared memory, as A and V as B for o += p v.
//
// Warps: 8 a block, in four pairs, a pair for each 16-row slice of the
// query tile, as in the backward. The two warps of a pair split the 64
// keys of a tile for s (16 x 32 each) and the D columns of o (16 x D/2
// each, its C fragments kept in registers across the key tiles, rescaled
// by alpha in place). So the row max is a quad shuffle and one exchange
// between the pair through shared memory under a 64-thread named
// barrier, the row sum stays in per-thread parts until the end, and each
// warp's share of the products is half that of a warp that held all 64
// keys or all D columns, which lets 8 warps, not 4, work on one query
// tile: a block per tile of the ring chain's block (H 8, T 1024: 128
// blocks for 132 SMs) then still runs 8 warps on its SM. A tile costs a
// block barrier (the stage landed) and two pair barriers.
//
// The causal critical path: with a mask, a block takes two query tiles
// of a head one after the other, i and n - 1 - i (n tiles; the middle
// one alone when n is odd). Under a causal mask every block then streams
// n + 1 key tiles, where a block a tile would stream from 1 to n. Without
// a mask every tile streams all keys, and a block takes one tile.
//
// A fully masked row whose m is -1e30 gets p = 1 on every lane and l' =
// S, as the TPU kernel and its jnp twin give. A key tile whose every pair
// (that exists) the mask covers is skipped once every row's running max
// is finite: a masked lane's s is -1e30 exactly, so there p = exp(-1e30 -
// m') = 0, and skipping it is exact; a row still at m = -1e30 would get
// p = 1 there. (The backward's rule.) Tile j + 1 is chosen before tile j
// is multiplied, as it must be to load it early. Under a causal mask this
// skips the tiles above the diagonal. Each query tile first reads its
// rows of the mask once, every thread 16 bytes of each key tile, all the
// loads in flight together, into two bits a key tile in shared memory
// (some pair unmasked, some pair masked; mask_bits, flash_common.cuh,
// shared with the bf16 backward); the lookahead then reads only those, and
// the rows' condition rides on the stage barrier. (Read tile by tile, as
// the f32 backward reads it, the mask cost about a quarter of the time at
// the training shape: a global round trip and two barriers a tile.) A
// tile that the mask leaves whole is multiplied without reading
// the mask. Keys past S get -inf, with no branch: they neither set the
// max nor add to the sum.
//
// Occupancy: shared memory is the q tile, two stages of K and V and p:
// q and K at the stride MmaTile<DP>::kLd = DP + 4, V at DP + 8 (rows
// 16-byte aligned for cp.async, and fragments free of bank conflicts: K
// is read with k along its rows, V with k down its columns), 44.8 KB at
// D 16, 64.8 KB at D 32, 104.8 KB at D 64, so two blocks of 8 warps an SM
// to D 64; 184.8 KB at D 128, one block an SM. At D 128 a second block
// would need 32-key tiles or a single stage; the repo's D-128 shape (the
// chain block) has 128 blocks for 132 SMs, so it would not fill a second
// slot.
//
// Bound: operations. 4 D flops (q k^T and p v) for each (query, key) pair
// the mask leaves, on 2 + 3 D + 3 D words per row; at f32 accuracy the
// card does them on the tensor cores at 495 / 3 = 165 TFLOP/s (3xTF32).
// At the training shape (BH 64, T = S = 512, D 32, causal: 512 * 513 / 2
// pairs a head) 1.08 GFLOP, 6.5 us; at the chain block (BH 8, T = S =
// 1024, D 128) 4.3 GFLOP, 26 us.
//
// The bf16 path (rabit_flash_block_bf16, body flash_fwd_bf16): the TPU
// kernel's bf16 q/k/v contract (pallas_kernels.py:241-253, _flash_block_
// body). s = q k^T in f32 from bf16 operands on mma.sync.m16n8k16 .bf16
// (a bf16 x bf16 product is exact in f32), scaled and masked as above;
// m', alpha and l' in f32, l' summing the f32 p = exp(s - m'); p rounded
// to bf16 to nearest even (__floats2bfloat162_rn, the TPU kernel's
// p.astype(v.dtype)) at the final m', and p v on the same bf16 product
// with f32 sums. A pre-pass over the key tiles finds each row's m' first
// (an online rescale would round exp(s - m_j) of a running max and scale
// the rounded p later: o' 2.06e-3 of max|o'| off), so every tile's alpha
// in pass 1 is exp(0) = 1.
//
// Bound: bytes. q, k, v read at 2 B, (m, l, o) read and (m', l', o')
// written at 4 B, and the mask: 4.6 us at the training shape (B*H 64, T =
// S = 512, D 32, causal) and 4.4 us at the chain block (H 8, T = S =
// 1024, D 128) at 3.35 TB/s, against 1.1 and 4.3 us of dense bf16
// products at 989 TFLOP/s.
//
// What set the time of the first bf16 body (flash_fwd's schedule, which
// the f32 path keeps): the latency of one key-tile visit, on an H100
// 80GB HBM3 at 700 W about 2.0 us at the training shape (0.0724 ms over
// 36 visits one after another: 18 a block, two waves of one block an SM)
// and 1.9 us at the chain block (0.0608 ms, one wave of 32), the same at
// D 32 as at D 128 with 4x the products and bytes: 6.4 % and 7.3 % of
// the bound. Each visit was one dependent chain of a
// cp.async wait with one tile in flight, a block barrier, the score tile,
// the pair's row max through shared memory under a pair barrier, p
// stored to shared memory as bf16, a second pair barrier and p read back
// by ldmatrix, on 8 warps an SM. This body shortens the chain and runs
// more of them at once:
//   1. A warp owns whole rows: its 16 rows x all 64 keys of a tile
//      (score_tile<DP, 8, .>, the k-steps in the backward's order, so a
//      (query, key) pair keeps its bits and m' its value) and all D
//      columns of o. The row max is a quad shuffle. The C fragments of
//      8-key tiles 2kk and 2kk + 1 are exactly the A fragment of the 16-key
//      k-step kk, so p is rounded from the C registers into A registers
//      and multiplied by V (ldmatrix.trans) at once: no p in shared
//      memory, no exchange, no pair barrier.
//   2. Key tiles are split over warp groups. A block holds a 64-row query
//      tile and kGroups groups of 4 warps, a warp a 16-row slice in each;
//      group g takes the visited key tiles g, g + kGroups, ... of a pass.
//      Pass 0 is a max and pass 1 a plain sum (alpha = 1), so the groups
//      meet once a pass: the partial maxes (then the incoming (l, o) is
//      scaled by exp(m - m')), and at the end the partial (l, o), added
//      in group order by group 0, which stores them as before. The visited
//      tiles are known before a pass starts. Pass 1 skips a tile with no
//      unmasked pair where every row's m' is above kNegInf (the rule
//      above: p = 0 on every skipped lane). Pass 0 forms a max alone: a
//      masked lane adds exactly kNegInf to a max that starts at m, so
//      skipping a fully masked tile leaves m' as it is wherever every row
//      has m >= kNegInf (the first step's m = kNegInf included); it visits
//      every tile otherwise. m' is the value the running rule gives. The
//      mask is read a chunk at a time into bits_s (mask_bits) and one warp
//      lists the chunk's visited tiles.
//   3. A deeper ring: each group streams its tiles through kStagesBf16
//      cp.async stages of its own (K in pass 0, K and V in pass 1), waits
//      with kStagesBf16 - 2 tiles still in flight, and meets its 4 warps
//      at one named barrier a tile (bar.sync 1 + g, 128), which marks the
//      oldest stage free; the groups do not wait for each other. A tile's
//      16-byte copies come from offsets a thread keeps for the kernel (a
//      generic loader's index loops cost as many instructions as the
//      tile's products). Pass 1's first tiles are requested before the
//      groups exchange their maxes, as pass 0 listed them; where pass 1
//      lists others (a row left at m' = kNegInf) they are dropped and
//      loaded again.
//   4. More warps an SM: at most 128 registers a thread where the shared
//      memory holds two blocks of 8 warps (D <= 32 at three stages: 67.9
//      KB a block; 121.1 KB at D 64 holds one), so two blocks at D 32,
//      where one block ran 1.6x slower (but the masked D-16 kernel, which
//      spills at 128); 255 at D 128 (227.6 KB, one block of 8 warps). The
//      incoming m waits for pass 1 in shared memory, not in registers.
//      With a mask a block takes query tiles i and n - 1 - i (kPairBf16),
//      as the f32 path does: a block a tile ran 1.17x slower.
// mma.sync, not wgmma: the time is latency with a bytes bound, not the
// products (at D 32 a tile's products take well under 0.1 us of an SM's
// tensor cores), and s must keep the m16n8k16 sequence that both backward
// kernels use to find the row max's lanes; wgmma gives no guarantee of
// the same bits.

// The C entry points launch on the caller's stream, allocate nothing,
// do not synchronise, and return the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace rabit_flash;
using namespace rabit_mma;

constexpr int kNt = 4;            // 8-key C tiles of a warp's 32 keys

// Shared memory of an f32 block: q, two stages of (K, V) and p, then the
// pair exchange and the mask bits.
template <int DP>
struct Smem {
  static constexpr int kLd = MmaTile<DP>::kLd;  // q, K
  static constexpr int kLdV = DP + 8;           // V: read as B columns
  static constexpr int kLdP = kCols + 4;        // p: read as A rows
  static constexpr int kTile = kRows * kLd;
  static constexpr int kStage = kTile + kCols * kLdV;  // K, then V
  static constexpr size_t kBytes =
      sizeof(float) * (kTile + 2 * kStage + kRows * kLdP) +
      sizeof(float) * 2 * kRows + sizeof(unsigned) * kChunk;
};

// Two blocks share an SM to D 64 (at most 128 registers a thread and
// 104.8 KB of shared memory a block); at D 128 the shared memory holds one
// block, which may then take up to 255 registers a thread.
template <int DP>
constexpr int kMinBlocks = DP <= 64 ? 2 : 1;

// The f32 block's work (3xTF32 products). kMasked: whether mask is given;
// the kernel without one reads no mask.
template <int DP, bool kMasked>
__device__ __forceinline__ void flash_fwd(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ o,
    const unsigned char* __restrict__ mask, int T, int S, int D,
    float scale, float* __restrict__ mo, float* __restrict__ lo,
    float* __restrict__ oo) {
  using L = Smem<DP>;
  constexpr int kLd = L::kLd, kLdP = L::kLdP;
  constexpr int kNo = DP / 16;  // 8-column C tiles of the warp's o half
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kRows, kLd]
  float* kv_s = q_s + L::kTile;  // [2][k: kCols, kLd; v: kCols, kLdV]
  float* p_s = kv_s + 2 * L::kStage;  // [kRows, kLdP]
  // [2 halves][kRows]: max, then sum
  float* part_s = p_s + kRows * kLdP;
  unsigned* bits_s = reinterpret_cast<unsigned*>(part_s + 2 * kRows);

  const int tiles = (T + kRows - 1) / kRows;
  const long long hq = static_cast<long long>(blockIdx.y) * T;
  const long long hk = static_cast<long long>(blockIdx.y) * S;
  const float* kh = k + hk * D;
  const float* vh = v + hk * D;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = w / 2, slice = 16 * pair, half = w % 2;
  const int keys = 32 * half;        // s: keys keys.. + 32 of a tile
  const int cols = half * (DP / 2);  // o: columns cols.. + DP/2
  // a stage's K and V tiles, or (`with_v` false) its K tile alone
  auto load_kv = [&](int stage, int col0, bool with_v) {
    load_tile_async<DP, kLd>(kv_s + stage * L::kStage, kh, col0, S, D);
    if (with_v)
      load_tile_async<DP, L::kLdV>(kv_s + stage * L::kStage + L::kTile, vh,
                                   col0, S, D);
  };

  const int first = blockIdx.x, last = kMasked ? tiles - 1 - first : first;
  for (int qt = first;; qt = last) {
    const int row0 = qt * kRows;
    // this thread's rows slice + c_row(e): h = 0 for e < 2, 1 for e >= 2
    int row[2];
    float m_in[2], m_run[2], l_run[2], acc[kNo][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = row0 + slice + c_row(2 * h);
      const bool ok = row[h] < T;
      m_in[h] = m_run[h] = ok ? m[hq + row[h]] : kNegInf;
      // l enters once, through the first lane of the row's half 0
      l_run[h] = ok && half == 0 && lane % 4 == 0 ? l[hq + row[h]] : 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < kNo; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e / 2], c = cols + c_col(nt, e);
        acc[nt][e] = r < T && c < D ? o[(hq + r) * D + c] : 0.f;
      }
    // a barrier; with a mask, also whether every row of the tile has a
    // finite max
    auto finite = [&] {
      if constexpr (!kMasked) {
        __syncthreads();
        return true;
      }
      return __syncthreads_and((row[0] >= T || m_run[0] > kNegInf) &&
                               (row[1] >= T || m_run[1] > kNegInf)) != 0;
    };
    // the first key tile from j on to visit; `rows_ok`: a masked tile may
    // be skipped. Reads the mask bits of another chunk where it needs them
    // (the same on every thread, so the barriers of mask_bits are met).
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

    // One pass over the key tiles, pass 1 (pass 0 is the bf16 path's max
    // pre-pass, in flash_fwd_bf16), kept as a loop with m_in and with_v:
    // ptxas allocates the straight-line body with other register counts,
    // and these are the counts the f32 kernels were timed with.
    constexpr int kFirstPass = 1;
    for (int pass = kFirstPass; pass < 2; ++pass) {
      // the previous query tile's (or pass's) readers of q_s and bits_s
      // are done
      const bool rows_ok = finite();
      if (pass == kFirstPass)
        load_tile_async<DP, kLd>(q_s, q + hq * D, row0, T, D);
      Visit tile = next_visit(0, rows_ok);
      if (tile.from < S) load_kv(0, tile.from, pass == 1);
      cp_async_commit();
      for (int stage = 0; tile.from < S; stage ^= 1) {
        cp_async_wait<0>();
        // tile (and q) landed; the other stage is free
        const Visit next = next_visit(tile.from / kCols + 1, finite());
        if (next.from < S) load_kv(stage ^ 1, next.from, pass == 1);
        cp_async_commit();
        const float* k_s = kv_s + stage * L::kStage;
        const float* v_s = k_s + L::kTile;

        float s[kNt][4];
        score_tile<DP, kNt, kMasked>(s, q_s + slice * kLd, k_s + keys * kLd,
                                     kLd, scale, mask, !tile.unmasked,
                                     row0 + slice, tile.from + keys, T, S);
        const int lanes = S - tile.from - keys;  // keys below S: c_col < lanes
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[nt][e] = c_col(nt, e) < lanes ? s[nt][e] : -INFINITY;
            tmax[e / 2] = fmaxf(tmax[e / 2], s[nt][e]);
          }
        // the row's max over the warp's 32 keys (a quad), then the pair's
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            tmax[h] =
                fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], off));
          if (lane % 4 == 0)
            part_s[half * kRows + slice + c_row(2 * h)] = tmax[h];
        }
        pair_sync(pair);
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float other = part_s[(half ^ 1) * kRows + slice + c_row(2 * h)];
          const float m_new = fmaxf(m_run[h], fmaxf(tmax[h], other));
          alpha[h] = expf(m_run[h] - m_new);
          m_run[h] = m_new;
          l_run[h] *= alpha[h];
        }
        // p in f32, summed into l in f32; then staged, a row's two
        // neighbouring keys together
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p0 = expf(s[nt][2 * h] - m_run[h]);
            l_run[h] += p0;
            const float p1 = expf(s[nt][2 * h + 1] - m_run[h]);
            l_run[h] += p1;
            float* dst = p_s + (slice + c_row(2 * h)) * kLdP + keys +
                     c_col(nt, 2 * h);
            dst[0] = p0;
            dst[1] = p1;
          }
#pragma unroll
        for (int nt = 0; nt < kNo; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e / 2];
        pair_sync(pair);
        // o += p v over the tile's 64 keys (p is 0 and v is 0 past S)
        mma3_tf32<kCols / 8, kNo>(acc, p_s + slice * kLdP, kLdP, 1,
                                    v_s + cols, L::kLdV, 1);
        tile = next;
      }
      cp_async_wait<0>();  // nothing in flight into q_s if no tile was visited
    }

    // l' = the row's parts: a quad's lanes, then the pair's two halves
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], off);
      if (half == 1 && lane % 4 == 0) part_s[slice + c_row(2 * h)] = l_run[h];
    }
    pair_sync(pair);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (half == 0 && lane % 4 == 0 && row[h] < T) {
        mo[hq + row[h]] = m_run[h];
        lo[hq + row[h]] = l_run[h] + part_s[slice + c_row(2 * h)];
      }
#pragma unroll
    for (int nt = 0; nt < kNo; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e / 2], c = cols + c_col(nt, e);
        if (r < T && c < D) oo[(hq + r) * D + c] = acc[nt][e];
      }
    if (qt == last) break;
  }
}

// The f32 path: q, k, v f32 (3xTF32 products).
template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DP>)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ m,
                     const float* __restrict__ l, const float* __restrict__ o,
                     const unsigned char* __restrict__ mask, int T, int S,
                     int D, float scale, float* __restrict__ mo,
                     float* __restrict__ lo, float* __restrict__ oo) {
  flash_fwd<DP, kMasked>(q, k, v, m, l, o, mask, T, S, D, scale, mo, lo, oo);
}

// ---- the bf16 path (see the note at the head of the file) ----

constexpr int kGroups = 2;  // warp groups a block, 4 warps each
static_assert(128 * kGroups == kThreads, "mask_bits reads with 256 threads");
constexpr int kStagesBf16 = 3;         // cp.async stages a group
constexpr bool kPairBf16 = true;       // with a mask, tiles i, n - 1 - i
constexpr size_t kSmemPerSm = 233472;  // 228 KB, 1 KB of it per block

// Shared memory of a bf16 block: q, each group's ring of (K, V) stages,
// the groups' maxes and the incoming m, the mask's bits and the chunk's
// visited tiles (and their count). At the end of pass 1 the groups'
// partial (o, l) overlay the rings: [kGroups - 1][kRows][kLdX] f32, then
// [kGroups - 1][kRows].
template <int DP>
struct SmemBf16 {
  static constexpr int kLd = MmaTileBf16<DP>::kLd;    // q, K and V rows
  static constexpr int kTile = kRows * kLd;
  static constexpr int kStage = 2 * kTile;            // K, then V
  static constexpr int kRing = kStagesBf16 * kStage;  // a group's
  static constexpr int kLdX = DP + 8;  // a partial o's rows (f32)
  static constexpr size_t kBytes =
      sizeof(bf16) * (kTile + kGroups * kRing) +
      sizeof(float) * (kGroups + 1) * kRows +
      sizeof(unsigned) * (2 * kChunk + 4);
  static_assert((kGroups - 1) * kRows * (kLdX + 1) * sizeof(float) <=
                    sizeof(bf16) * kGroups * kRing,
                "the partial sums fit over the rings");
};

// Two blocks an SM (at most 128 registers a thread) where the shared
// memory holds two, but for the masked kernel at D 16, which spills at
// 128: one block, up to 255 registers, as at D 64 and 128.
template <int DP, bool kMasked>
constexpr int kMinBlocksBf16 =
    2 * (SmemBf16<DP>::kBytes + 1024) <= kSmemPerSm && !(DP == 16 && kMasked)
        ? 2
        : 1;

// The 4 warps of group g wait for each other; barrier 0 is
// __syncthreads'.
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(g + 1) : "memory");
}

// (lo, hi) rounded to bf16 to nearest even, one register (lo in the low
// half): an A fragment's pair of neighbouring k
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&x);
}

// The bf16 block's work: one query tile (with a mask and kPairBf16, two)
// in two passes over the key tiles. kMasked: whether mask is given; the
// kernel without one reads no mask.
template <int DP, bool kMasked>
__device__ __forceinline__ void flash_fwd_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ o,
    const unsigned char* __restrict__ mask, int T, int S, int D,
    float scale, float* __restrict__ mo, float* __restrict__ lo,
    float* __restrict__ oo) {
  using L = SmemBf16<DP>;
  constexpr int kLd = L::kLd;
  constexpr int kKeys = kCols / 8;  // 8-key C tiles of s: the tile's 64
  constexpr int kNo = DP / 8;       // 8-column C tiles of o: all of D
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kRows, kLd]
  bf16* ring_s = q_s + L::kTile;  // [kGroups][kStagesBf16][K, V: kRows, kLd]
  float* max_s = reinterpret_cast<float*>(ring_s + kGroups * L::kRing);
  float* m_in_s = max_s + kGroups * kRows;  // [kRows]: m, held for pass 1
  unsigned* bits_s = reinterpret_cast<unsigned*>(m_in_s + kRows);
  unsigned* list_s = bits_s + kChunk;  // [kChunk] tiles, then the count
  float* xo_s = reinterpret_cast<float*>(ring_s);
  float* xl_s = xo_s + (kGroups - 1) * kRows * L::kLdX;

  const int tiles = (T + kRows - 1) / kRows;
  const int key_tiles = (S + kCols - 1) / kCols;
  const long long hq = static_cast<long long>(blockIdx.y) * T;
  const long long hk = static_cast<long long>(blockIdx.y) * S;
  const bf16* kh = k + hk * D;
  const bf16* vh = v + hk * D;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = w / 4, slice = 16 * (w % 4), gtid = threadIdx.x % 128;
  bf16* ring = ring_s + grp * L::kRing;

  // rows from .. from + 64 of a [n, D] array into a [64, kLd] tile, by the
  // group's 128 threads; rows past n and columns past D become zero. Where
  // every row is 16-byte aligned, 16-byte cp.async copies, this thread's
  // at rows cp_row + j kCpStride and columns cp_col .. + 8 of every tile;
  // else 2-byte loads and stores (an odd D, or an unaligned array), which
  // land at once in a stage the group has freed: the group's barrier
  // before the tile is read makes them visible as it does the copies
  constexpr int kCpRow = DP / 8, kCpStride = 128 / kCpRow;
  const int cp_col = gtid % kCpRow * 8, cp_row = gtid / kCpRow;
  const bool wide = D % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(v) % 16 == 0;
  auto load_tile = [&](bf16* dst, const bf16* src, int from, int n) {
    if (wide) {
      const bf16* at = src + static_cast<long long>(from) * D + cp_col;
#pragma unroll
      for (int j = 0; j < kRows / kCpStride; ++j) {
        const int r = cp_row + j * kCpStride;
        const bool full = from + r < n && cp_col < D;
        cp_async16(dst + r * kLd + cp_col, full ? at + r * D : src, full);
      }
    } else {
      const auto* s16 = reinterpret_cast<const unsigned short*>(src);
      auto* d16 = reinterpret_cast<unsigned short*>(dst);
      for (int idx = gtid; idx < kRows * DP; idx += 128) {
        const int r = idx / DP, c = idx % DP, row = from + r;
        d16[r * kLd + c] = row < n && c < D
                               ? s16[static_cast<long long>(row) * D + c]
                               : static_cast<unsigned short>(0);
      }
    }
  };

  const int first = blockIdx.x;
  const int last = kMasked && kPairBf16 ? tiles - 1 - first : first;
  // a chunk of key tiles at a time (without a mask, one of them all: its
  // groups meet at no barrier inside a pass)
  constexpr int kStep = kMasked ? kChunk : 1 << 30;
  const bool one_chunk = key_tiles <= kStep;
  for (int qt = first;; qt = last) {
    const int row0 = qt * kRows;
    // this thread's rows slice + c_row(e): h = 0 for e < 2, 1 for e >= 2.
    // l and o enter through group 0 (l through a row's first lane).
    int row[2];
    float m_run[2], l_run[2], acc[kNo][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = row0 + slice + c_row(2 * h);
      const bool ok = row[h] < T;
      m_run[h] = ok ? m[hq + row[h]] : kNegInf;
      if (grp == 0 && lane % 4 == 0) m_in_s[slice + c_row(2 * h)] = m_run[h];
      l_run[h] = ok && grp == 0 && lane % 4 == 0 ? l[hq + row[h]] : 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < kNo; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row[e / 2], c = c_col(nt, e);
        acc[nt][e] = grp == 0 && r < T && c < D ? o[(hq + r) * D + c] : 0.f;
      }
    // the previous query tile's readers of q_s, the rings and the lists
    // are done; pass 0 may skip a fully masked tile where every row has m
    // >= kNegInf
    const bool rows_ok0 =
        __syncthreads_and((row[0] >= T || m_run[0] >= kNegInf) &&
                          (row[1] >= T || m_run[1] >= kNegInf)) != 0;
    if (grp == 0) load_tile(q_s, q + hq * D, row0, T);
    cp_async_commit();

    // the visited tiles of chunk j0 (with a mask): warp 0 lists them from
    // bits_s (a tile with no unmasked pair only where rows_ok is false)
    // into list_s, with their count after them; then a barrier
    auto list_tiles = [&](int j0, bool rows_ok) {
      const int n = min(kChunk, key_tiles - j0);
      if (w == 0) {
        int base = 0;
        for (int i0 = 0; i0 < kChunk; i0 += 32) {
          const int i = i0 + lane;
          const unsigned b = i < n ? bits_s[i] : 0u;
          const bool take = i < n && ((b & kSomeUnmasked) || !rows_ok);
          const unsigned vote = __ballot_sync(0xffffffffu, take);
          if (take)
            list_s[base + __popc(vote & ((1u << lane) - 1u))] =
                i | ((b & kSomeMasked) ? 0u : 0x100u);
          base += __popc(vote);
        }
        if (lane == 0) list_s[kChunk] = base;
      }
      __syncthreads();
    };
    auto n_vis = [&](int j0) {
      return kMasked ? static_cast<int>(list_s[kChunk])
                     : min(kStep, key_tiles - j0);
    };
    auto tile_of = [&](int j0, int v) -> Visit {
      if constexpr (kMasked) {
        const unsigned e = list_s[v];
        return {(j0 + static_cast<int>(e & 0xffu)) * kCols, (e & 0x100u) != 0};
      }
      return {(j0 + v) * kCols, true};
    };
    // group grp takes the chunk's visited tiles grp, grp + kGroups, ...:
    // its i-th through stage i % kStagesBf16
    auto mine_of = [&](int n) {
      return n > grp ? (n - grp - 1) / kGroups + 1 : 0;
    };
    auto load = [&](int j0, int i, bool with_v) {
      const int from = tile_of(j0, grp + i * kGroups).from;
      bf16* stage = ring + (i % kStagesBf16) * L::kStage;
      load_tile(stage, kh, from, S);
      if (with_v) load_tile(stage + L::kTile, vh, from, S);
    };
    auto prologue = [&](int j0, int mine, bool with_v) {
#pragma unroll
      for (int i = 0; i < kStagesBf16 - 1; ++i) {
        if (i < mine) load(j0, i, with_v);
        cp_async_commit();
      }
    };
    // pass 0: s and each row's max; pass 1: p, l and o at the final max
    auto run = [&](auto pass_c, int j0, int mine) {
      constexpr int kPass = decltype(pass_c)::value;
      for (int i = 0; i < mine; ++i) {
        cp_async_wait<kStagesBf16 - 2>();
        // tile i landed on the group; the stage of tile i - 1 is free
        group_sync(grp);
        if (i + kStagesBf16 - 1 < mine) load(j0, i + kStagesBf16 - 1, kPass);
        cp_async_commit();
        const Visit t = tile_of(j0, grp + i * kGroups);
        const bf16* k_s = ring + (i % kStagesBf16) * L::kStage;
        float s[kKeys][4];
        score_tile<DP, kKeys, kMasked>(s, q_s + slice * kLd, k_s, kLd, scale,
                                       mask, !t.unmasked, row0 + slice,
                                       t.from, T, S);
        const int lanes = S - t.from;  // keys below S: c_col < lanes
        if (lanes < kCols)
#pragma unroll
          for (int nt = 0; nt < kKeys; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[nt][e] = c_col(nt, e) < lanes ? s[nt][e] : -INFINITY;
        if constexpr (kPass == 0) {
          float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int nt = 0; nt < kKeys; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              tmax[e / 2] = fmaxf(tmax[e / 2], s[nt][e]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int off = 1; off < 4; off <<= 1)
              tmax[h] =
                  fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], off));
            m_run[h] = fmaxf(m_run[h], tmax[h]);
          }
        } else {
          // p = exp(s - m') in f32, summed into l; C tiles 2kk and 2kk + 1
          // rounded to bf16 are the A fragment of keys 16 kk .. + 16, times
          // V's rows 16 kk .. + 16 into every column of o
          const bf16* v_s = k_s + L::kTile;
#pragma unroll
          for (int kk = 0; kk < kKeys / 2; ++kk) {
            unsigned a[4];
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float p0 = expf(s[2 * kk + j][2 * h] - m_run[h]);
                l_run[h] += p0;
                const float p1 = expf(s[2 * kk + j][2 * h + 1] - m_run[h]);
                l_run[h] += p1;
                a[2 * j + h] = pack_bf16(p0, p1);
              }
#pragma unroll
            for (int n = 0; n < kNo; n += 2) {
              unsigned b[4];
              b_frags2<true>(b, v_s, kLd, 16 * kk, 8 * n);
              const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
              mma_bf16(acc[n], a, b0);
              mma_bf16(acc[n + 1], a, b1);
            }
          }
        }
      }
      cp_async_wait<0>();
    };

    constexpr std::integral_constant<int, 0> kPass0{};
    constexpr std::integral_constant<int, 1> kPass1{};
    for (int j0 = 0; j0 < key_tiles; j0 += kStep) {
      if constexpr (kMasked) {
        mask_bits(bits_s, mask, row0, j0, T, S);
        list_tiles(j0, rows_ok0);
      }
      const int mine = mine_of(n_vis(j0));
      prologue(j0, mine, false);
      if (j0 == 0) {  // q (group 0's oldest copies) landed
        cp_async_wait<kStagesBf16 - 2>();
        __syncthreads();
      }
      run(kPass0, j0, mine);
    }
    // pass 1's first tiles as pass 0 listed them, in flight during the
    // groups' exchange; pass 1 lists the same tiles unless rows_ok changes
    if (one_chunk) {
      group_sync(grp);  // the group's last tile is read
      prologue(0, mine_of(n_vis(0)), true);
    }
    // m' = the groups' maxes (a max: the same value in any order); the
    // incoming (l, o) scaled to it
    if (lane % 4 == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        max_s[grp * kRows + slice + c_row(2 * h)] = m_run[h];
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
        m_run[h] = fmaxf(m_run[h], max_s[g * kRows + slice + c_row(2 * h)]);
      const float alpha = expf(m_in_s[slice + c_row(2 * h)] - m_run[h]);
      l_run[h] *= alpha;
#pragma unroll
      for (int nt = 0; nt < kNo; ++nt) {
        acc[nt][2 * h] *= alpha;
        acc[nt][2 * h + 1] *= alpha;
      }
    }
    // pass 1 may skip a fully masked tile where every row's m' is above
    // kNegInf (p = 0 on its every lane)
    const bool rows_ok1 =
        __syncthreads_and((row[0] >= T || m_run[0] > kNegInf) &&
                          (row[1] >= T || m_run[1] > kNegInf)) != 0;
    for (int j0 = 0; j0 < key_tiles; j0 += kStep) {
      if (!one_chunk || (kMasked && rows_ok1 != rows_ok0)) {
        if constexpr (kMasked) {
          cp_async_wait<0>();  // the early copies land before others start
          if (!one_chunk) mask_bits(bits_s, mask, row0, j0, T, S);
          list_tiles(j0, rows_ok1);
        }
        prologue(j0, mine_of(n_vis(j0)), true);
      }
      run(kPass1, j0, mine_of(n_vis(j0)));
    }

    // l' and o': each group's parts (a row's quad first), added in group
    // order by group 0, which stores them
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], off);
    if constexpr (kGroups > 1) {
      __syncthreads();  // the rings are read: the partial sums overlay them
      if (grp > 0) {
        float* xo = xo_s + (grp - 1) * kRows * L::kLdX;
#pragma unroll
        for (int nt = 0; nt < kNo; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(
                xo + (slice + c_row(2 * h)) * L::kLdX + c_col(nt, 2 * h)) =
                make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
        if (lane % 4 == 0)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xl_s[(grp - 1) * kRows + slice + c_row(2 * h)] = l_run[h];
      }
      __syncthreads();
    }
    if (grp == 0) {
#pragma unroll
      for (int g = 1; g < kGroups; ++g) {
        const float* xo = xo_s + (g - 1) * kRows * L::kLdX;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l_run[h] += xl_s[(g - 1) * kRows + slice + c_row(2 * h)];
#pragma unroll
          for (int nt = 0; nt < kNo; ++nt) {
            const float2 x = *reinterpret_cast<const float2*>(
                xo + (slice + c_row(2 * h)) * L::kLdX + c_col(nt, 2 * h));
            acc[nt][2 * h] += x.x;
            acc[nt][2 * h + 1] += x.y;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (lane % 4 == 0 && row[h] < T) {
          mo[hq + row[h]] = m_run[h];
          lo[hq + row[h]] = l_run[h];
        }
#pragma unroll
      for (int nt = 0; nt < kNo; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row[e / 2], c = c_col(nt, e);
          if (r < T && c < D) oo[(hq + r) * D + c] = acc[nt][e];
        }
    }
    if (qt == last) break;
  }
}

// The bf16 path: q, k, v bf16 (bf16 products, p rounded to bf16).
template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads, kMinBlocksBf16<DP, kMasked>)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ o,
                          const unsigned char* __restrict__ mask, int T,
                          int S, int D, float scale, float* __restrict__ mo,
                          float* __restrict__ lo, float* __restrict__ oo) {
  flash_fwd_bf16<DP, kMasked>(q, k, v, m, l, o, mask, T, S, D, scale, mo,
                              lo, oo);
}

// One launch at D bucket DP: f32 q/k/v, then bf16.
template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* m, const float* l, const float* o,
                   const unsigned char* mask, int bh, int T, int S, int D,
                   float scale, float* mo, float* lo, float* oo,
                   cudaStream_t stream) {
  const size_t smem = Smem<DP>::kBytes;
  auto kernel = mask != nullptr ? flash_fwd_kernel<DP, true>
                                : flash_fwd_kernel<DP, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // with a mask, a block takes query tiles i and n - 1 - i
  const int tiles = (T + kRows - 1) / kRows;
  const dim3 grid(mask != nullptr ? (tiles + 1) / 2 : tiles, bh);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, m, l, o, mask, T, S, D,
                                           scale, mo, lo, oo);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const float* m, const float* l, const float* o,
                   const unsigned char* mask, int bh, int T, int S, int D,
                   float scale, float* mo, float* lo, float* oo,
                   cudaStream_t stream) {
  const size_t smem = SmemBf16<DP>::kBytes;
  auto kernel = mask != nullptr ? flash_fwd_bf16_kernel<DP, true>
                                : flash_fwd_bf16_kernel<DP, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (T + kRows - 1) / kRows;
  const dim3 grid(mask != nullptr && kPairBf16 ? (tiles + 1) / 2 : tiles, bh);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, m, l, o, mask, T, S, D,
                                           scale, mo, lo, oo);
  return cudaGetLastError();
}

// q/k/v of element type E: checks the sizes, then the launch of the D
// bucket's instantiation.
template <typename E>
int dispatch(const void* q, const void* k, const void* v, const void* m,
             const void* l, const void* o, const void* mask, int bh, int t,
             int s, int d, float scale, void* mo, void* lo, void* oo,
             void* stream) {
  if (bh < 1 || bh > 65535 || t < 1 || s < 1 || d < 1 || d > 128)
    return cudaErrorInvalidValue;
  const auto* qe = static_cast<const E*>(q);
  const auto* ke = static_cast<const E*>(k);
  const auto* ve = static_cast<const E*>(v);
  const auto* mf = static_cast<const float*>(m);
  const auto* lf = static_cast<const float*>(l);
  const auto* of = static_cast<const float*>(o);
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto* mof = static_cast<float*>(mo);
  auto* lof = static_cast<float*>(lo);
  auto* oof = static_cast<float*>(oo);
  auto st = static_cast<cudaStream_t>(stream);
  if (d <= 16)
    return launch<16>(qe, ke, ve, mf, lf, of, mk, bh, t, s, d, scale, mof,
                      lof, oof, st);
  if (d <= 32)
    return launch<32>(qe, ke, ve, mf, lf, of, mk, bh, t, s, d, scale, mof,
                      lof, oof, st);
  if (d <= 64)
    return launch<64>(qe, ke, ve, mf, lf, of, mk, bh, t, s, d, scale, mof,
                      lof, oof, st);
  return launch<128>(qe, ke, ve, mf, lf, of, mk, bh, t, s, d, scale, mof,
                     lof, oof, st);
}

// Blocks an SM of the bf16 kernel that launch<DP> runs, or a negative
// cudaError_t.
template <int DP>
int occupancy(bool masked) {
  constexpr size_t smem = SmemBf16<DP>::kBytes;
  auto kernel = masked ? flash_fwd_bf16_kernel<DP, true>
                       : flash_fwd_bf16_kernel<DP, false>;
  cudaError_t err = allow_smem(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

int occupancy_at(int d, bool masked) {
  if (d < 1 || d > 128) return -static_cast<int>(cudaErrorInvalidValue);
  if (d <= 16) return occupancy<16>(masked);
  if (d <= 32) return occupancy<32>(masked);
  if (d <= 64) return occupancy<64>(masked);
  return occupancy<128>(masked);
}

}  // namespace

extern "C" {

// q [bh, t, d], k/v [bh, s, d], m/l [bh, t], o [bh, t, d] f32; mask u8
// [t, s] or null; outputs mo/lo [bh, t], oo [bh, t, d] f32. All device
// pointers, contiguous. 1 <= d <= 128. Returns a cudaError_t (0 on
// success).
int rabit_flash_block_f32(const void* q, const void* k, const void* v,
                          const void* m, const void* l, const void* o,
                          const void* mask, int bh, int t, int s, int d,
                          float scale, void* mo, void* lo, void* oo,
                          void* stream) {
  return dispatch<float>(q, k, v, m, l, o, mask, bh, t, s, d, scale, mo, lo,
                         oo, stream);
}

// As rabit_flash_block_f32, with q [bh, t, d] and k/v [bh, s, d] bf16;
// m, l, o and the outputs stay f32.
int rabit_flash_block_bf16(const void* q, const void* k, const void* v,
                           const void* m, const void* l, const void* o,
                           const void* mask, int bh, int t, int s, int d,
                           float scale, void* mo, void* lo, void* oo,
                           void* stream) {
  return dispatch<bf16>(q, k, v, m, l, o, mask, bh, t, s, d, scale, mo, lo,
                        oo, stream);
}

// Blocks of the bf16 forward kernel that one SM holds at head width d
// (1 to 128), with or without a mask; a negative value is a cudaError_t.
int rabit_flash_block_bf16_occupancy(int d, int masked) {
  return occupancy_at(d, masked != 0);
}

const char* rabit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
