// Pieces shared by the flash-attention block kernels (flash_block.cu and
// flash_block_bwd.cu): the tile shape and block size, a tile that a pass
// visits, the pair barrier, the mask's bits a tile, and the opt-in to
// large shared memory. The products, the score function and the tile
// loads are in flash_mma.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rabit_flash {

constexpr float kNegInf = -1e30f;  // the masking constant, not -inf
constexpr int kRows = 64;          // query rows of a tile
constexpr int kCols = 64;          // key columns of a tile
constexpr int kThreads = 256;      // 8 warps, in four pairs

// A tile that a pass visits: where it starts, and whether the mask leaves
// every pair of it (then no mask is read for it).
struct Visit {
  int from;
  bool unmasked;
};

// The two warps of pair `pair` (threads 64 pair .. + 64) wait for each
// other; barrier 0 is __syncthreads'.
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

// ---- the mask's bits a tile ----
//
// A pass reads the mask of a chunk of up to kChunk tiles once, all the
// loads in flight together, into a word a tile in shared memory; it then
// picks the tiles to visit from those bits alone. (Read tile by tile, a
// global round trip and two barriers a tile, the mask cost about a
// quarter of the forward's time at the training shape.)

constexpr int kChunk = 64;  // tiles whose bits one read covers
constexpr unsigned kSomeUnmasked = 1, kSomeMasked = 2;
// mask_bits_cols: some row of the query tile that exists has m' at or
// below kNegInf
constexpr unsigned kSomeRowNegInf = 4;

__device__ __forceinline__ bool has_zero_byte(unsigned x) {
  return ((x - 0x01010101u) & ~x & 0x80808080u) != 0;
}

// Whether the 16 mask bytes of row `mrow` from column col (those below S)
// hold a masked and an unmasked one: one 16-byte load where `wide` (the
// mask's rows 16-byte aligned), else a byte at a time.
__device__ __forceinline__ void scan16(const unsigned char* mrow, int col,
                                       int S, bool wide, bool& some_masked,
                                       bool& some_unmasked) {
  if (wide) {  // col + 16 <= S
    const uint4 x = *reinterpret_cast<const uint4*>(mrow + col);
    some_masked = (x.x | x.y | x.z | x.w) != 0;
    some_unmasked = has_zero_byte(x.x) || has_zero_byte(x.y) ||
                    has_zero_byte(x.z) || has_zero_byte(x.w);
  } else {
    for (int b = 0; b < 16 && col + b < S; ++b) {
      const bool masked = mrow[col + b] != 0;
      some_masked = some_masked || masked;
      some_unmasked = some_unmasked || !masked;
    }
  }
}

// ORs the flags of N tiles over the warp into bits_s[i0 ..]; kExtra, if
// not 0, where `extra` holds on some lane. The votes are ballots. Written
// with two __any_sync, the bf16 row kernel (kExtra 0) was built by nvcc
// 12.9 for sm_90a into VOTE.ANY P2 and VOTE.ANY P4, then "@P5 BRA" past
// the atomicOr with P5 = lane != 0 | (P2 & P4) (PLOP3.LUT 0xf8, where
// lane != 0 | !(P2 | P4) was meant): a tile with both flags was never
// written, each flag alone was (the SASS and the failed checks: PERF.md,
// section 6).
template <int N, unsigned kExtra>
__device__ __forceinline__ void or_bits(unsigned* bits_s, int i0,
                                        const bool (&some_unmasked)[N],
                                        const bool (&some_masked)[N],
                                        const bool (&extra)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const unsigned bu = __ballot_sync(0xffffffffu, some_unmasked[i]);
    const unsigned bm = __ballot_sync(0xffffffffu, some_masked[i]);
    unsigned b = (bu != 0u ? kSomeUnmasked : 0u) |
                 (bm != 0u ? kSomeMasked : 0u);
    if constexpr (kExtra != 0)
      b |= __ballot_sync(0xffffffffu, extra[i]) != 0u ? kExtra : 0u;
    if (threadIdx.x % 32 == 0 && b != 0) atomicOr(&bits_s[i0 + i], b);
  }
}

// bits_s[i] = kSomeUnmasked | kSomeMasked as the pairs of rows [row0,
// row0 + 64) x key tile j0 + i (i < kChunk) that exist (row < T, key < S)
// hold an unmasked or a masked one. Thread tid reads keys 16 (tid % 4)..
// + 16 of each tile in row tid / 4, four tiles' loads in flight at once.
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
    bool some_unmasked[4] = {}, some_masked[4] = {}, none[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = (j0 + i0 + i) * kCols + c16;
      if (i0 + i < n && row < T && col < S)
        scan16(mrow, col, S, wide, some_masked[i], some_unmasked[i]);
    }
    or_bits<4, 0>(bits_s, i0, some_unmasked, some_masked, none);
  }
  __syncthreads();
}

// The column-wise twin: bits_s[i] for query tile j0 + i (rows (j0 + i) *
// 64 .. + 64) x keys [col0, col0 + 64), as mask_bits gives them, and
// kSomeRowNegInf where a row of that tile that exists has mnew (the
// head's m', [T]) at or below kNegInf. Thread tid reads keys col0 + 16
// (tid % 4) .. + 16 of row tid / 4 of each tile, eight tiles' loads in
// flight at once (a T of 512 in one round). Barriers as mask_bits.
__device__ __forceinline__ void mask_bits_cols(unsigned* bits_s,
                                               const unsigned char* mask,
                                               const float* mnew, int col0,
                                               int j0, int T, int S) {
  const int n = min(kChunk, (T + kRows - 1) / kRows - j0);
  __syncthreads();
  if (threadIdx.x < kChunk) bits_s[threadIdx.x] = 0;
  __syncthreads();
  const int r = threadIdx.x / 4, col = col0 + 16 * (threadIdx.x % 4);
  const bool wide =
      S % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  for (int i0 = 0; i0 < n; i0 += 8) {
    bool some_unmasked[8] = {}, some_masked[8] = {}, neg_inf[8] = {};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = (j0 + i0 + i) * kRows + r;
      if (i0 + i >= n || row >= T) continue;
      neg_inf[i] = !(mnew[row] > kNegInf);
      if (col < S)
        scan16(mask + static_cast<long long>(row) * S, col, S, wide,
               some_masked[i], some_unmasked[i]);
    }
    or_bits<8, kSomeRowNegInf>(bits_s, i0, some_unmasked, some_masked,
                               neg_inf);
  }
  __syncthreads();
}

// Opt in to more than 48 KB of dynamic shared memory where needed; without
// it the launch is refused and nothing runs.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rabit_flash
