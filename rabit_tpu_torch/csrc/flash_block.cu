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
// The bf16 path (rabit_flash_block_bf16; the TPU kernel's bf16 q/k/v
// contract, pallas_kernels.py:241-253): the same schedule, skip and warp
// split, one body templated on the element type, with a pre-pass over the
// key tiles for each row's final max (see the pass loop). q, K, V and p
// live in
// shared memory as bf16 (MmaTileBf16<DP>::kLd = DP + 8, p at 64 + 8:
// rows 16-byte aligned and fragments free of bank conflicts), about half
// the f32 path's bytes (35.6 KB at D 32, 97 KB at D 128). s = q k^T runs
// on mma.sync.m16n8k16 .bf16 with f32 sums (a bf16 x bf16 product is
// exact in f32, so no split; fragments by ldmatrix, score_tile's, which
// the bf16 backward shares), scaled and masked as above; m', alpha and
// p are f32 and l' sums the f32 p; then p is rounded to bf16 to nearest
// even (__floats2bfloat162_rn), as the TPU kernel's p.astype(v.dtype),
// and p v runs on the same bf16 product into the f32 o (mma_bf16_sum,
// V's k down its columns by ldmatrix.trans). A row of an odd
// D is only 2-byte aligned, so such tiles load through plain loads
// (load_tile_async's third branch). Bound: bytes. q, k, v at 2 B and o
// read and written at 4 B: at the training shape about 15 MB, 4.5 us at
// 3.35 TB/s, against 1.08 GFLOP, 1.1 us at 989 TFLOP/s of dense bf16; at
// the chain block about 14.7 MB, 4.4 us, against 4.3 GFLOP, 4.3 us.
//
// The C entry points launch on the caller's stream, allocate nothing,
// do not synchronise, and return the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace rabit_flash;
using namespace rabit_mma;

constexpr int kNt = 4;            // 8-key C tiles of a warp's 32 keys

// Shared memory of a block: q, two stages of (K, V) and p in elements of
// E (f32 or bf16), then the pair exchange and the mask bits.
template <typename E, int DP>
struct Smem {
  static constexpr bool kBf16 = sizeof(E) == 2;
  static constexpr int kLd =
      kBf16 ? MmaTileBf16<DP>::kLd : MmaTile<DP>::kLd;  // q, K
  static constexpr int kLdV = DP + 8;                   // V: read as B columns
  static constexpr int kLdP = kCols + (kBf16 ? 8 : 4);  // p: read as A rows
  static constexpr int kTile = kRows * kLd;
  static constexpr int kStage = kTile + kCols * kLdV;  // K, then V
  static constexpr size_t kBytes =
      sizeof(E) * (kTile + 2 * kStage + kRows * kLdP) +
      sizeof(float) * 2 * kRows + sizeof(unsigned) * kChunk;
};

// Two blocks share an SM to D 64 (at most 128 registers a thread and
// 104.8 KB of shared memory a block); at D 128 the f32 path's shared
// memory holds one block, which may then take up to 255 registers a
// thread. The bf16 path asks for one block (at 128 registers its masked
// kernels at D 32 and 64 spilled); its shared memory would hold two.
template <int DP>
constexpr int kMinBlocks = DP <= 64 ? 2 : 1;
constexpr int kMinBlocksBf16 = 1;

// The block's work, for q/k/v of element type E (f32: 3xTF32 products;
// bf16: bf16 products, p rounded to bf16). kMasked: whether mask is
// given; the kernel without one reads no mask.
template <typename E, int DP, bool kMasked>
__device__ __forceinline__ void flash_fwd(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const float* __restrict__ m,
    const float* __restrict__ l, const float* __restrict__ o,
    const unsigned char* __restrict__ mask, int T, int S, int D,
    float scale, float* __restrict__ mo, float* __restrict__ lo,
    float* __restrict__ oo) {
  using L = Smem<E, DP>;
  constexpr int kLd = L::kLd, kLdP = L::kLdP;
  constexpr int kNo = DP / 16;  // 8-column C tiles of the warp's o half
  extern __shared__ __align__(16) unsigned char smem[];
  E* q_s = reinterpret_cast<E*>(smem);  // [kRows, kLd]
  E* kv_s = q_s + L::kTile;         // [2][k: kCols, kLd; v: kCols, kLdV]
  E* p_s = kv_s + 2 * L::kStage;    // [kRows, kLdP]
  // [2 halves][kRows]: max, then sum
  float* part_s = reinterpret_cast<float*>(p_s + kRows * kLdP);
  unsigned* bits_s = reinterpret_cast<unsigned*>(part_s + 2 * kRows);

  const int tiles = (T + kRows - 1) / kRows;
  const long long hq = static_cast<long long>(blockIdx.y) * T;
  const long long hk = static_cast<long long>(blockIdx.y) * S;
  const E* kh = k + hk * D;
  const E* vh = v + hk * D;
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

    // The bf16 path walks the key tiles twice: pass 0 forms s alone and
    // takes each row's max, so that pass 1 computes p = exp(s - m') with
    // m' final, as the contract does before it rounds p to bf16 (an
    // online rescale would round exp(s - m_j) of a running max m_j and
    // scale the rounded p later, which is off by up to half an ulp of
    // bf16 on every p of a row whose max rose). In pass 1 every tile's
    // alpha is then exp(0) = 1. The f32 path makes pass 1 alone.
    constexpr int kFirstPass = L::kBf16 ? 0 : 1;
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
        const E* k_s = kv_s + stage * L::kStage;
        const E* v_s = k_s + L::kTile;

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
        if (pass == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            m_run[h] = fmaxf(m_run[h],
                             fmaxf(tmax[h], part_s[(half ^ 1) * kRows + slice +
                                                   c_row(2 * h)]));
          tile = next;
          continue;
        }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float other = part_s[(half ^ 1) * kRows + slice + c_row(2 * h)];
          const float m_new = fmaxf(m_run[h], fmaxf(tmax[h], other));
          alpha[h] = expf(m_run[h] - m_new);
          m_run[h] = m_new;
          l_run[h] *= alpha[h];
        }
        // p in f32, summed into l in f32; then staged as E (for bf16,
        // rounded to nearest even), a row's two neighbouring keys together
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p0 = expf(s[nt][2 * h] - m_run[h]);
            l_run[h] += p0;
            const float p1 = expf(s[nt][2 * h + 1] - m_run[h]);
            l_run[h] += p1;
            E* dst = p_s + (slice + c_row(2 * h)) * kLdP + keys +
                     c_col(nt, 2 * h);
            if constexpr (L::kBf16) {
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(p0, p1);
            } else {
              dst[0] = p0;
              dst[1] = p1;
            }
          }
#pragma unroll
        for (int nt = 0; nt < kNo; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e / 2];
        pair_sync(pair);
        // o += p v over the tile's 64 keys (p is 0 and v is 0 past S)
        if constexpr (L::kBf16) {
          const E* const a[1] = {p_s + slice * kLdP};
          const E* const b[1] = {v_s + cols};
          mma_bf16_sum<kCols, kNo, false, true, 1, 1>(acc, a, kLdP, b, L::kLdV);
        } else
          mma3_tf32<kCols / 8, kNo>(acc, p_s + slice * kLdP, kLdP, 1,
                                    v_s + cols, L::kLdV, 1);
        tile = next;
      }
      cp_async_wait<0>();  // nothing in flight into q_s if no tile was visited
      if (pass == 0) {
        // (m, l, o) enter scaled to the final max
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float alpha = expf(m_in[h] - m_run[h]);
          l_run[h] *= alpha;
#pragma unroll
          for (int nt = 0; nt < kNo; ++nt) {
            acc[nt][2 * h] *= alpha;
            acc[nt][2 * h + 1] *= alpha;
          }
        }
      }
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
  flash_fwd<float, DP, kMasked>(q, k, v, m, l, o, mask, T, S, D, scale, mo,
                                lo, oo);
}

// The bf16 path: q, k, v bf16 (bf16 products, p rounded to bf16).
template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads, kMinBlocksBf16)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ o,
                          const unsigned char* __restrict__ mask, int T,
                          int S, int D, float scale, float* __restrict__ mo,
                          float* __restrict__ lo, float* __restrict__ oo) {
  flash_fwd<bf16, DP, kMasked>(q, k, v, m, l, o, mask, T, S, D, scale, mo,
                               lo, oo);
}

template <typename E, int DP, bool kMasked>
constexpr auto kernel_of() {
  if constexpr (sizeof(E) == 2)
    return flash_fwd_bf16_kernel<DP, kMasked>;
  else
    return flash_fwd_kernel<DP, kMasked>;
}

template <typename E, int DP>
cudaError_t launch(const E* q, const E* k, const E* v, const float* m,
                   const float* l, const float* o, const unsigned char* mask,
                   int bh, int T, int S, int D, float scale, float* mo,
                   float* lo, float* oo, cudaStream_t stream) {
  const size_t smem = Smem<E, DP>::kBytes;
  auto kernel = mask != nullptr ? kernel_of<E, DP, true>()
                                : kernel_of<E, DP, false>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // with a mask, a block takes query tiles i and n - 1 - i
  const int tiles = (T + kRows - 1) / kRows;
  const dim3 grid(mask != nullptr ? (tiles + 1) / 2 : tiles, bh);
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
    return launch<E, 16>(qe, ke, ve, mf, lf, of, mk, bh, t, s, d, scale, mof,
                         lof, oof, st);
  if (d <= 32)
    return launch<E, 32>(qe, ke, ve, mf, lf, of, mk, bh, t, s, d, scale, mof,
                         lof, oof, st);
  if (d <= 64)
    return launch<E, 64>(qe, ke, ve, mf, lf, of, mk, bh, t, s, d, scale, mof,
                         lof, oof, st);
  return launch<E, 128>(qe, ke, ve, mf, lf, of, mk, bh, t, s, d, scale, mof,
                        lof, oof, st);
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

const char* rabit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
