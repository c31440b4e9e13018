// Flash-attention block step for Hopper (sm_90a): one online-softmax
// update of a running (m, l, o) over a block of keys, per head h:
//   s  = q k^T * scale, masked lanes set to -1e30
//   m' = max(m, rowmax s);  alpha = exp(m - m');  p = exp(s - m')
//   l' = l alpha + sum_j p;  o' = o alpha + p v
// q [BH, T, D], k/v [BH, S, D], m/l [BH, T], o [BH, T, D], all f32; mask
// u8 [T, S] (non-zero = masked) shared by every head, or null.
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
// (some pair unmasked, some pair masked); the lookahead then reads only
// those, and the rows' condition rides on the stage barrier. (Read tile
// by tile, as the backward reads it, the mask cost about a quarter of the
// time at the training shape: a global round trip and two barriers a
// tile.) A tile that the mask leaves whole is multiplied without reading
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
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace rabit_flash;
using namespace rabit_mma;

constexpr int kNt = 4;            // 8-key C tiles of a warp's 32 keys
constexpr int kLdP = kCols + 4;   // p: read as A rows
constexpr int kChunk = 64;        // key tiles whose mask bits a pass reads
constexpr unsigned kSomeUnmasked = 1, kSomeMasked = 2;

// Shared memory of a block: q, two stages of (K, V), p, the pair
// exchange, the mask bits.
template <int DP>
struct Smem {
  static constexpr int kLd = MmaTile<DP>::kLd;  // q, K
  static constexpr int kLdV = DP + 8;           // V: read as B columns
  static constexpr int kTile = kRows * kLd;
  static constexpr int kStage = kTile + kCols * kLdV;  // K, then V
  static constexpr int kFloats =
      kTile + 2 * kStage + kRows * kLdP + 2 * kRows + kChunk;
};

// Two blocks share an SM to D 64 (at most 128 registers a thread and
// 104.8 KB of shared memory a block); at D 128 the shared memory holds one
// block, which may then take up to 255 registers a thread.
template <int DP>
constexpr int kMinBlocks = DP <= 64 ? 2 : 1;

__device__ __forceinline__ bool has_zero_byte(unsigned x) {
  return ((x - 0x01010101u) & ~x & 0x80808080u) != 0;
}

// bits_s[i] = kSomeUnmasked | kSomeMasked as the pairs of rows [row0,
// row0 + 64) x key tile j0 + i (i < kChunk) that exist (row < T, key < S)
// hold an unmasked or a masked one. Thread tid reads keys 16 (tid % 4)..
// + 16 of each tile in row tid / 4: one 16-byte load where the mask's
// rows are 16-byte aligned, four tiles' loads in flight at once.
// Barriers first (a scan may still be reading the bits it replaces) and
// last.
__device__ __forceinline__ void mask_bits(unsigned* bits_s,
                                          const unsigned char* mask,
                                          int row0, int j0, int T, int S) {
  const int n = min(kChunk, (S + kCols - 1) / kCols - j0);
  __syncthreads();
  if (threadIdx.x < kChunk) bits_s[threadIdx.x] = 0;
  __syncthreads();
  const int row = row0 + threadIdx.x / 4, c16 = 16 * (threadIdx.x % 4);
  const unsigned char* mrow =
      mask + static_cast<long long>(min(row, T - 1)) * S;
  const bool wide =
      S % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  for (int i0 = 0; i0 < n; i0 += 4) {
    bool some_unmasked[4] = {}, some_masked[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = (j0 + i0 + i) * kCols + c16;
      if (i0 + i >= n || row >= T || col >= S) continue;
      if (wide) {  // col + 16 <= S
        const uint4 x = *reinterpret_cast<const uint4*>(mrow + col);
        some_masked[i] = (x.x | x.y | x.z | x.w) != 0;
        some_unmasked[i] = has_zero_byte(x.x) || has_zero_byte(x.y) ||
                           has_zero_byte(x.z) || has_zero_byte(x.w);
      } else {
        for (int b = 0; b < 16 && col + b < S; ++b) {
          const bool masked = mrow[col + b] != 0;
          some_masked[i] = some_masked[i] || masked;
          some_unmasked[i] = some_unmasked[i] || !masked;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned b =
          (__any_sync(0xffffffffu, some_unmasked[i]) ? kSomeUnmasked : 0u) |
          (__any_sync(0xffffffffu, some_masked[i]) ? kSomeMasked : 0u);
      if (threadIdx.x % 32 == 0 && b != 0) atomicOr(&bits_s[i0 + i], b);
    }
  }
  __syncthreads();
}

// The two warps of pair `pair` (threads 64 pair .. + 64) wait for each
// other; barrier 0 is __syncthreads'.
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

// kMasked: whether mask is given; the kernel without one reads no mask.
template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads, kMinBlocks<DP>)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ m,
                     const float* __restrict__ l, const float* __restrict__ o,
                     const unsigned char* __restrict__ mask, int T, int S,
                     int D, float scale, float* __restrict__ mo,
                     float* __restrict__ lo, float* __restrict__ oo) {
  using L = Smem<DP>;
  constexpr int kLd = L::kLd;
  constexpr int kNo = DP / 16;  // 8-column C tiles of the warp's o half
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [kRows, kLd]
  float* kv_s = q_s + L::kTile;         // [2][k: kCols, kLd; v: kCols, kLdV]
  float* p_s = kv_s + 2 * L::kStage;    // [kRows, kLdP]
  float* part_s = p_s + kRows * kLdP;   // [2 halves][kRows]: max, then sum
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
  auto load_kv = [&](int stage, int col0) {
    load_tile_async<DP>(kv_s + stage * L::kStage, kh, col0, S, D);
    load_tile_async<DP, L::kLdV>(kv_s + stage * L::kStage + L::kTile, vh,
                                 col0, S, D);
  };

  const int first = blockIdx.x, last = kMasked ? tiles - 1 - first : first;
  for (int qt = first;; qt = last) {
    const int row0 = qt * kRows;
    // this thread's rows slice + c_row(e): h = 0 for e < 2, 1 for e >= 2
    int row[2];
    float m_run[2], l_run[2], acc[kNo][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = row0 + slice + c_row(2 * h);
      const bool ok = row[h] < T;
      m_run[h] = ok ? m[hq + row[h]] : kNegInf;
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

    // the previous query tile's readers of q_s and bits_s are done
    const bool rows_ok = finite();
    load_tile_async<DP>(q_s, q + hq * D, row0, T, D);
    Visit tile = next_visit(0, rows_ok);
    if (tile.from < S) load_kv(0, tile.from);
    cp_async_commit();
    for (int stage = 0; tile.from < S; stage ^= 1) {
      cp_async_wait<0>();
      // tile (and q) landed; the other stage is free
      const Visit next = next_visit(tile.from / kCols + 1, finite());
      if (next.from < S) load_kv(stage ^ 1, next.from);
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
          tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], off));
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
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - m_run[e / 2]);
          l_run[e / 2] += p;
          p_s[(slice + c_row(e)) * kLdP + keys + c_col(nt, e)] = p;
        }
#pragma unroll
      for (int nt = 0; nt < kNo; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e / 2];
      pair_sync(pair);
      // o += p v over the tile's 64 keys (p is 0 and v is 0 past S)
      mma3_tf32<kCols / 8, kNo>(acc, p_s + slice * kLdP, kLdP, 1, v_s + cols,
                                L::kLdV, 1);
      tile = next;
    }
    cp_async_wait<0>();  // nothing in flight into q_s if no tile was visited

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

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* m, const float* l, const float* o,
                   const unsigned char* mask, int bh, int T, int S, int D,
                   float scale, float* mo, float* lo, float* oo,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * Smem<DP>::kFloats;
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
  if (bh < 1 || bh > 65535 || t < 1 || s < 1 || d < 1 || d > 128)
    return cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mf = static_cast<const float*>(m);
  const auto* lf = static_cast<const float*>(l);
  const auto* of = static_cast<const float*>(o);
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto* mof = static_cast<float*>(mo);
  auto* lof = static_cast<float*>(lo);
  auto* oof = static_cast<float*>(oo);
  auto st = static_cast<cudaStream_t>(stream);
  if (d <= 16)
    return launch<16>(qf, kf, vf, mf, lf, of, mk, bh, t, s, d, scale, mof,
                      lof, oof, st);
  if (d <= 32)
    return launch<32>(qf, kf, vf, mf, lf, of, mk, bh, t, s, d, scale, mof,
                      lof, oof, st);
  if (d <= 64)
    return launch<64>(qf, kf, vf, mf, lf, of, mk, bh, t, s, d, scale, mof,
                      lof, oof, st);
  return launch<128>(qf, kf, vf, mf, lf, of, mk, bh, t, s, d, scale, mof,
                     lof, oof, st);
}

const char* rabit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
