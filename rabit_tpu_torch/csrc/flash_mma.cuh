// Tensor-core pieces of the flash kernels (flash_block.cu and
// flash_block_bwd.cu): f32 products at f32 accuracy from TF32 operands
// (the 3xTF32 split), the one score-tile function, and asynchronous tile
// loads.
//
// 3xTF32 ("fast f32", CUTLASS's OpMultiplyAddFastF32): each f32 operand x
// splits into big = tf32(x) and small = tf32(x - big), both rounded to
// nearest with ties away (as cvt.rna). big + small holds x to about 2^-22
// relative. a b is then a_small b_big + a_big b_small + a_big b_big (the
// small x small term, about 2^-22 of a b, is dropped), three
// mma.sync.m16n8k8 TF32 products into one f32 accumulator, the small
// terms first so that they are not lost against the big one. A dot of
// width 128 lands within about 1e-6 of f64 (1xTF32: about 3e-4).
//
// Fragments of mma.m16n8k8 .tf32 (PTX ISA; CuTe's
// SM80_16x8x8_F32TF32TF32F32_TN), lane = 4 g + t:
//   A (16 x 8, row): (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
//   B (8 x 8, col):  (k = t, n = g), (k = t + 4, n = g)
//   C (16 x 8):      (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
// C is not laid out as A, so a product whose A operand is another
// product's result goes through shared memory.
//
// The score s = (q . k) * scale is computed by score_tile alone, with the
// query rows as A, the keys as B, k stepped 0, 8, ..., DP - 8 and the
// three products in the order above, then a multiply that is never
// contracted (__fmul_rn). (The backward's overload forms dp = co . v
// beside s, interleaved, which leaves each accumulator's sequence as it
// would be alone; the forward's forms s alone.) Every kernel tiles
// queries and keys from multiples of 64 and gives a warp 16-row slices
// and 8-key groups from multiples of 8, so a (query, key) pair sits at
// the same place of the same mma sequence on the same operand values in
// the forward and in both backward kernels, and gets the same bits: the
// backward tests s == rowmax(s) to find the lanes that carry reduce_max's
// cotangent, and the forward's m' is that row max.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace rabit_mma {

using rabit_flash::kNegInf;
using rabit_flash::kThreads;

// Row stride of a [64, DP] tile in shared memory: a multiple of 4 (rows
// start 16-byte aligned, for cp.async) and 4 mod 8, so that the 8 rows x
// 4 columns of an A or B fragment whose k runs along the row fall in 32
// different banks. (A B operand whose k runs down the columns, as V in p
// v, wants 8 mod 32: its 4 rows x 8 columns then do.)
template <int DP>
struct MmaTile {
  static constexpr int kLd = DP + 4;
};

// x -> (big, small) as TF32 operands. The mma reads the top 19 bits of a
// TF32 operand (sign, exponent, 10 mantissa bits) and ignores the low 13,
// so adding half a TF32 ulp (0x1000) to the bits rounds the magnitude to
// nearest with ties away, as cvt.rna.tf32.f32 does. (On sm_90 cvt.rna
// compiles to a compare-and-select sequence, and a split made with it
// took about twice the instructions.) big's value is its bits with the
// low 13 cleared.
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big & 0xffffe000u))) +
          0x1000u;
}

// acc += a b: one m16n8k8 product of TF32 operands with f32 sums
__device__ __forceinline__ void mma_tf32(float (&acc)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[n] += A B_n over K = 8 KSTEPS, 3xTF32, for the calling warp: A is
// 16 x K with A(m, k) at a[m * am + k * ak]; B_n is K x 8 with B_n(k, j)
// at b[k * bk + (8 n + j) * bn]. acc[n] is the C fragment of the 16 x 8
// tile n. Only this loop over k is unrolled.
template <int KSTEPS, int NT>
__device__ __forceinline__ void mma3_tf32(float (&acc)[NT][4],
                                          const float* a, int am, int ak,
                                          const float* b, int bk, int bn) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int k0 = 8 * ks;
    unsigned a_big[4], a_small[4];
    split_tf32(a[g * am + (k0 + t) * ak], a_big[0], a_small[0]);
    split_tf32(a[(g + 8) * am + (k0 + t) * ak], a_big[1], a_small[1]);
    split_tf32(a[g * am + (k0 + t + 4) * ak], a_big[2], a_small[2]);
    split_tf32(a[(g + 8) * am + (k0 + t + 4) * ak], a_big[3], a_small[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      unsigned b_big[2], b_small[2];
      split_tf32(b[(k0 + t) * bk + (8 * n + g) * bn], b_big[0], b_small[0]);
      split_tf32(b[(k0 + t + 4) * bk + (8 * n + g) * bn], b_big[1],
                 b_small[1]);
      mma_tf32(acc[n], a_small, b_big);
      mma_tf32(acc[n], a_big, b_small);
      mma_tf32(acc[n], a_big, b_big);
    }
  }
}

// s[n] += Q K_n^T and dp[n] += CO V_n^T over K = DP: two products of
// rows x rows (Q, CO: the warp's 16 rows of [., ld] tiles; K_n, V_n: 8
// rows from 8 n), as mma3_tf32 would form each alone, interleaved k-step
// by k-step so that two chains of mma are in flight.
template <int DP, int NT>
__device__ __forceinline__ void mma3_tf32_pair(float (&s)[NT][4],
                                               float (&dp)[NT][4],
                                               const float* q_s,
                                               const float* k_s,
                                               const float* co_s,
                                               const float* v_s, int ld) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks) {
    const int k0 = 8 * ks;
    const int ai[4] = {g * ld + k0 + t, (g + 8) * ld + k0 + t,
                       g * ld + k0 + t + 4, (g + 8) * ld + k0 + t + 4};
    unsigned q_big[4], q_small[4], c_big[4], c_small[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split_tf32(q_s[ai[i]], q_big[i], q_small[i]);
      split_tf32(co_s[ai[i]], c_big[i], c_small[i]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int b0 = (8 * n + g) * ld + k0 + t, b1 = b0 + 4;
      unsigned k_big[2], k_small[2], v_big[2], v_small[2];
      split_tf32(k_s[b0], k_big[0], k_small[0]);
      split_tf32(k_s[b1], k_big[1], k_small[1]);
      split_tf32(v_s[b0], v_big[0], v_small[0]);
      split_tf32(v_s[b1], v_big[1], v_small[1]);
      mma_tf32(s[n], q_small, k_big);
      mma_tf32(dp[n], c_small, v_big);
      mma_tf32(s[n], q_big, k_small);
      mma_tf32(dp[n], c_big, v_small);
      mma_tf32(s[n], q_big, k_big);
      mma_tf32(dp[n], c_big, v_big);
    }
  }
}

// Row and column of element e (0..3) of C tile n, relative to the warp's
// 16-row, 8 NT-column block.
__device__ __forceinline__ int c_row(int e) {
  return (threadIdx.x % 32) / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int c_col(int n, int e) {
  return 8 * n + 2 * (threadIdx.x % 4) + e % 2;
}

// s *= scale (never contracted), then, where `check_mask` (kMasked: mask
// [T, S]), masked lanes (rows below T, keys below S) get kNegInf; bit 4 n
// + e of the result says that element e of tile n is masked. s is the
// warp's 16 rows (from row0) x 8 NT keys (from col0).
template <int NT, bool kMasked>
__device__ __forceinline__ unsigned scale_and_mask(
    float (&s)[NT][4], float scale, const unsigned char* mask,
    bool check_mask, int row0, int col0, int T, int S) {
  unsigned bits = 0;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
  if (kMasked && check_mask) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + c_row(2 * h);
      if (row >= T) continue;
      const unsigned char* mrow = mask + static_cast<long long>(row) * S;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * h + j, col = col0 + c_col(n, e);
          if (col < S && mrow[col]) {
            s[n][e] = kNegInf;
            bits |= 1u << (4 * n + e);
          }
        }
    }
  }
  return bits;
}

// The score tile: s = (q . k) * scale for the warp's 16 query rows (q_s,
// rows from row0) x 8 NT keys (k_s, keys from col0), and with it dp =
// co . v (co_s, v_s), all [., ld] tiles of width DP padded with zeros.
// Masked lanes as scale_and_mask; a caller that knows the tile holds no
// masked pair passes check_mask false and reads no mask.
template <int DP, int NT, bool kMasked>
__device__ __forceinline__ unsigned score_tile(
    float (&s)[NT][4], float (&dp)[NT][4], const float* q_s,
    const float* k_s, const float* co_s, const float* v_s, int ld,
    float scale, const unsigned char* mask, bool check_mask, int row0,
    int col0, int T, int S) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  mma3_tf32_pair<DP, NT>(s, dp, q_s, k_s, co_s, v_s, ld);
  return scale_and_mask<NT, kMasked>(s, scale, mask, check_mask, row0, col0,
                                     T, S);
}

// The score tile alone (the forward): s as the overload above forms it,
// by the same mma sequence, so with the same bits.
template <int DP, int NT, bool kMasked>
__device__ __forceinline__ unsigned score_tile(
    float (&s)[NT][4], const float* q_s, const float* k_s, int ld,
    float scale, const unsigned char* mask, bool check_mask, int row0,
    int col0, int T, int S) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  mma3_tf32<DP / 8, NT>(s, q_s, ld, 1, k_s, 1, ld);
  return scale_and_mask<NT, kMasked>(s, scale, mask, check_mask, row0, col0,
                                     T, S);
}

// Asynchronous copies into shared memory: `bytes` (16 or 4) from src, or
// zeros where `full` is false (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts copying rows [row0, row0 + 64) of a [n, d] f32 array into dst
// [64, kLd] (kLd a multiple of 4, by default MmaTile<DP>::kLd); rows past n
// and columns past d become zero. 16-byte copies where every row starts
// 16-byte aligned (d % 4 == 0 and an aligned src), else 4-byte copies.
// The caller commits the group.
template <int DP, int kLd = MmaTile<DP>::kLd>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src,
                                                int row0, int n, int d) {
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    constexpr int kChunks = DP / 4;
    for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 4, row = row0 + r;
      const bool full = row < n && c < d;
      cp_async16(dst + r * kLd + c,
                 full ? src + static_cast<long long>(row) * d + c : src,
                 full);
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP, row = row0 + r;
      const bool full = row < n && c < d;
      cp_async4(dst + r * kLd + c,
                full ? src + static_cast<long long>(row) * d + c : src,
                full);
    }
  }
}

}  // namespace rabit_mma
