// Pieces shared by the flash-attention block kernels (flash_block.cu and
// flash_block_bwd.cu): the tile shape, the staging of [rows, D] tiles into
// shared memory, and the one score function.
//
// The score s = (q . k) * scale is computed by one __device__ function
// (scores4x4), with a fixed order of explicit fmaf's and a multiply that
// is never contracted (__fmul_rn), so every kernel that recomputes s gets
// the same bits. The backward's row and column kernels both test
// s == rowmax(s) to find the lanes that carry reduce_max's cotangent; a
// score that differed in its last bit between them would drop that term
// from dk.

#pragma once

#include <cuda_runtime.h>

namespace rabit_flash {

constexpr float kNegInf = -1e30f;  // the masking constant, not -inf
constexpr int kRows = 64;          // query rows of a tile
constexpr int kCols = 64;          // key columns of a tile
// 16 row groups of 4 rows x 16 lanes: thread (rg, lane) = (tid / 16,
// tid % 16) holds the pairs (rows 4 rg + i, columns lane + 16 j), i, j < 4
constexpr int kThreads = 256;

// Shared-memory row stride of a [rows, DP] tile: odd, so that 16 lanes
// reading 16 different rows at one column hit 16 different banks.
template <int DP>
struct Tile {
  static constexpr int kLd = DP + 1;
};

// Rows [row0, row0 + kRows) of a [n, d] f32 array into dst [kRows, DP+1];
// rows past n and columns past d are zero.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n, int d) {
  constexpr int kLd = Tile<DP>::kLd;
  for (int idx = threadIdx.x; idx < kRows * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    const int row = row0 + r;
    dst[r * kLd + c] =
        (row < n && c < d) ? src[static_cast<long long>(row) * d + c] : 0.f;
  }
}

// Per-row values [row0, row0 + kRows) of a [n] f32 array; `fill` past n.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n, float fill) {
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    dst[r] = row0 + r < n ? src[row0 + r] : fill;
}

// The 4 x 4 block of a thread: out[i][j] = a_s[r0 + i] . b_s[c0 + 16 j]
// over the padded width DP (padding is zero, and fmaf(0, 0, acc) == acc),
// as an outer product in registers: 8 shared loads for 16 FMAs. Every
// element is one chain of fmaf's in the order d = 0, 1, ..., DP - 1, so a
// given pair of rows gives the same bits in every kernel.
template <int DP>
__device__ __forceinline__ void dots4x4(const float* a_s, const float* b_s,
                                        int r0, int c0, float out[4][4]) {
  constexpr int kLd = Tile<DP>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a_s[(r0 + i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = b_s[(c0 + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

// s = (q . k) * scale for the thread's 4 x 4 block of (query, key) pairs.
// The multiply is __fmul_rn, which is never contracted into an FMA with
// what follows, so s is the same wherever it is recomputed.
template <int DP>
__device__ __forceinline__ void scores4x4(const float* q_s, const float* k_s,
                                          int r0, int c0, float scale,
                                          float s[4][4]) {
  dots4x4<DP>(q_s, k_s, r0, c0, s);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = __fmul_rn(s[i][j], scale);
}

// Sum, max and (max, count) over the 16 lanes of a row group (lanes
// 0-15 or 16-31 of a warp).
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void group_max_count(float& m, float& n) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float on = __shfl_xor_sync(0xffffffffu, n, off);
    if (om > m) {
      m = om;
      n = on;
    } else if (om == m) {
      n += on;
    }
  }
}

// Whether a tile can be skipped: every pair (row0 + i, col0 + j), i < kRows,
// j < kCols, that exists (row < T, col < S) is masked, and `rows_ok` (the
// caller's condition on its own rows) holds on every thread. Thread
// (rg, lane) reads the mask at its own 4 x 4 block. It is a barrier
// (__syncthreads_and), so every thread of the block gets the same answer;
// in a kernel built without a mask (kMasked false) it is a plain barrier
// and false.
//
// A masked lane's score is -1e30 exactly. Where a row's running max m is
// above -1e30, such a lane gives p = exp(-1e30 - m) = 0, moves neither the
// max nor the sum, and adds 0 to every product: skipping it is exact. A
// row whose max is still -1e30 (fully masked so far) gets p = 1 on such a
// lane, so the callers pass rows_ok = false for it.
template <bool kMasked>
__device__ __forceinline__ bool tile_masked(const unsigned char* mask,
                                            int row0, int col0, int T, int S,
                                            bool rows_ok) {
  if constexpr (!kMasked) {
    __syncthreads();
    return false;
  }
  const int rg = threadIdx.x / 16, lane = threadIdx.x % 16;
  bool all = rows_ok;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + rg * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = col0 + lane + 16 * b;
      if (row < T && col < S && !mask[static_cast<long long>(row) * S + col])
        all = false;
    }
  }
  return __syncthreads_and(all);
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
