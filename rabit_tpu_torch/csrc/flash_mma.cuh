// Tensor-core pieces of the flash kernels (flash_block.cu and
// flash_block_bwd.cu): f32 products at f32 accuracy from TF32 operands
// (the 3xTF32 split), the one score-tile function, and asynchronous tile
// loads; and their bf16 counterparts for the forward's bf16 path, and the
// backward's bf16 loads, widened to f32, and stores (at the end of the
// file).
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

#include <cuda_bf16.h>
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
// tile n. Only this loop over k is unrolled. kAExact / kBExact: every
// value of A / B is exact in TF32 (a widened bf16 value), so its small
// part is 0 and the product that takes it, which adds exact zeros, is
// left out: the same sums, one product fewer.
template <int KSTEPS, int NT, bool kAExact = false, bool kBExact = false>
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
      if constexpr (!kAExact) mma_tf32(acc[n], a_small, b_big);
      if constexpr (!kBExact) mma_tf32(acc[n], a_big, b_small);
      mma_tf32(acc[n], a_big, b_big);
    }
  }
}

// s[n] += Q K_n^T and dp[n] += CO V_n^T over K = DP: two products of
// rows x rows (Q, CO: the warp's 16 rows of [., ld] tiles; K_n, V_n: 8
// rows from 8 n), as mma3_tf32 would form each alone, interleaved k-step
// by k-step so that two chains of mma are in flight. kExact: Q, K and V
// are exact in TF32 (widened bf16; CO never is), so s takes one product
// and dp two, as mma3_tf32 with its flags set would.
template <int DP, int NT, bool kExact = false>
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
      if constexpr (!kExact) mma_tf32(s[n], q_small, k_big);
      mma_tf32(dp[n], c_small, v_big);
      if constexpr (!kExact) {
        mma_tf32(s[n], q_big, k_small);
        mma_tf32(dp[n], c_big, v_small);
      }
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
// masked pair passes check_mask false and reads no mask. kExact as
// mma3_tf32_pair's.
template <int DP, int NT, bool kMasked, bool kExact = false>
__device__ __forceinline__ unsigned score_tile(
    float (&s)[NT][4], float (&dp)[NT][4], const float* q_s,
    const float* k_s, const float* co_s, const float* v_s, int ld,
    float scale, const unsigned char* mask, bool check_mask, int row0,
    int col0, int T, int S) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  mma3_tf32_pair<DP, NT, kExact>(s, dp, q_s, k_s, co_s, v_s, ld);
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
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
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

// ---- bf16 (the forward's bf16 path) ----
//
// A product of two bf16 values is exact in f32, so one
// mma.sync.m16n8k16 .bf16 with f32 accumulation gives what a dot with
// preferred_element_type=f32 gives, up to the order of the f32 sums: no
// split. Fragments (PTX ISA; CuTe's SM80_16x8x16_F32BF16BF16F32_TN),
// lane = 4 g + t; each 32-bit register holds two bf16, the lower k in
// its low half:
//   A (16 x 16, row): (g, 2t..2t+1), (g + 8, 2t..2t+1),
//                     (g, 2t+8..2t+9), (g + 8, 2t+8..2t+9)
//   B (16 x 8, col):  (k = 2t..2t+1, n = g), (k = 2t+8..2t+9, n = g)
//   C (16 x 8):       as the TF32 product's above.
// So an A fragment, and a B fragment whose k runs along a row (K in
// q k^T), is four or two 32-bit loads; a B fragment whose k runs down
// the columns (V in p v) packs two rows' 16-bit values a register.

using bf16 = __nv_bfloat16;

// Row stride, in bf16, of a [64, DP] bf16 tile: a multiple of 8 (rows
// start 16-byte aligned, for cp.async), and kLd / 2 words = 4 mod 8, so
// that the 8 rows x 4 words of a fragment whose k runs along the rows
// fall in 32 different banks. A B operand whose k runs down the columns
// reads rows 2t (and 2t + 1), kLd words apart (8 or 24 mod 32 at these
// DP): its 4 rows x 4 words (8 columns, two a word) fall in 16 different
// banks, so that too is free of conflicts.
template <int DP>
struct MmaTileBf16 {
  static constexpr int kLd = DP + 8;
};

// acc += a b: one m16n8k16 product of bf16 operands with f32 sums
__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 at x (4-byte aligned) as one register, x[0] in the low half
__device__ __forceinline__ unsigned ld_pair(const bf16* x) {
  return *reinterpret_cast<const unsigned*>(x);
}

// The A fragment of k0.. k0 + 15 of the warp's 16 rows of a [., ld] tile
__device__ __forceinline__ void a_frag_bf16(unsigned (&a)[4], const bf16* x,
                                            int ld, int k0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  a[0] = ld_pair(x + g * ld + k0 + 2 * t);
  a[1] = ld_pair(x + (g + 8) * ld + k0 + 2 * t);
  a[2] = ld_pair(x + g * ld + k0 + 2 * t + 8);
  a[3] = ld_pair(x + (g + 8) * ld + k0 + 2 * t + 8);
}

// acc[n] += A B_n^T over K = DP: A the warp's 16 rows of a [., ld] tile,
// B_n rows 8 n .. 8 n + 7 of another; k runs along the rows of both.
template <int DP, int NT>
__device__ __forceinline__ void mma_bf16_rows(float (&acc)[NT][4],
                                              const bf16* a, const bf16* b,
                                              int ld) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < DP; k0 += 16) {
    unsigned af[4];
    a_frag_bf16(af, a, ld, k0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* row = b + (8 * n + g) * ld + k0 + 2 * t;
      const unsigned bf[2] = {ld_pair(row), ld_pair(row + 8)};
      mma_bf16(acc[n], af, bf);
    }
  }
}

// acc[n] += A B_n over K = KS: A the warp's 16 rows of a [., lda] tile
// (k along its rows), B_n columns 8 n .. 8 n + 7 of a [KS, ldb] tile (k
// down its columns).
template <int KS, int NT>
__device__ __forceinline__ void mma_bf16_cols(float (&acc)[NT][4],
                                              const bf16* a, int lda,
                                              const bf16* b, int ldb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const auto* bu = reinterpret_cast<const unsigned short*>(b);
#pragma unroll
  for (int k0 = 0; k0 < KS; k0 += 16) {
    unsigned af[4];
    a_frag_bf16(af, a, lda, k0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const unsigned short* col = bu + (k0 + 2 * t) * ldb + 8 * n + g;
      const unsigned bf[2] = {
          col[0] | static_cast<unsigned>(col[ldb]) << 16,
          col[8 * ldb] | static_cast<unsigned>(col[9 * ldb]) << 16};
      mma_bf16(acc[n], af, bf);
    }
  }
}

// The score tile of bf16 q and k: s = (q . k) * scale with f32 sums, for
// the warp's 16 query rows (q_s, rows from row0) x 8 NT keys (k_s, keys
// from col0) of [., ld] tiles of width DP padded with zeros; masked lanes
// as scale_and_mask.
template <int DP, int NT, bool kMasked>
__device__ __forceinline__ unsigned score_tile(
    float (&s)[NT][4], const bf16* q_s, const bf16* k_s, int ld,
    float scale, const unsigned char* mask, bool check_mask, int row0,
    int col0, int T, int S) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  mma_bf16_rows<DP, NT>(s, q_s, k_s, ld);
  return scale_and_mask<NT, kMasked>(s, scale, mask, check_mask, row0, col0,
                                     T, S);
}

// Starts copying rows [row0, row0 + 64) of a [n, d] bf16 array into dst
// [64, kLd] (kLd a multiple of 8); rows past n and columns past d become
// zero. 16-byte copies where every row starts 16-byte aligned (d % 8 == 0
// and an aligned src), 4-byte copies where every row starts 4-byte
// aligned (d even and src so), else plain loads and stores: a row of an
// odd d is only 2-byte aligned, which no cp.async takes. Those land at
// once, in the stage the caller has freed, and the caller's barrier
// before the tile is read makes them visible as it does the copies. The
// caller commits the group.
template <int DP, int kLd = MmaTileBf16<DP>::kLd>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int row0, int n, int d) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  if (d % 8 == 0 && at % 16 == 0) {
    constexpr int kChunks = DP / 8;
    for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8, row = row0 + r;
      const bool full = row < n && c < d;
      cp_async16(dst + r * kLd + c,
                 full ? src + static_cast<long long>(row) * d + c : src,
                 full);
    }
  } else if (d % 2 == 0 && at % 4 == 0) {
    constexpr int kChunks = DP / 2;
    for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 2, row = row0 + r;
      const bool full = row < n && c < d;
      cp_async4(dst + r * kLd + c,
                full ? src + static_cast<long long>(row) * d + c : src,
                full);
    }
  } else {
    const auto* s16 = reinterpret_cast<const unsigned short*>(src);
    auto* d16 = reinterpret_cast<unsigned short*>(dst);
    for (int idx = threadIdx.x; idx < 64 * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP, row = row0 + r;
      d16[r * kLd + c] = row < n && c < d
                             ? s16[static_cast<long long>(row) * d + c]
                             : static_cast<unsigned short>(0);
    }
  }
}

// ---- bf16 widened to f32 (the backward's bf16 path) ----
//
// A bf16 value is an f32 whose low 16 bits are zero: widening is exact,
// and its 8-bit significand fits TF32's 11, so split_tf32 gives big = x
// and small = 0, and the 3xTF32 products above form every product of a
// widened bf16 operand at f32 accuracy, unchanged (their kAExact,
// kBExact and kExact flags leave out the products of its zero small
// part).

// The f32 value of the bf16 bits b (in the low half)
__device__ __forceinline__ float widen_bf16(unsigned b) {
  return __uint_as_float(b << 16);
}

// x rounded to bf16 to nearest even, widened back to f32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [row0, row0 + 64) of a [n, d] bf16 array into the f32 tile dst
// [64, kLd], each value widened; rows past n and columns past d become
// zero. cp.async cannot convert, so these are plain loads and stores:
// 16-byte loads of 8 values where every row starts 16-byte aligned (d % 8
// == 0 and an aligned src), else 2-byte loads. They land at once, in the
// stage the caller has freed, and the caller's barrier before the tile is
// read makes them visible as it does the copies. The name is the copies':
// a kernel templated on q/k/v's type calls one function for both. (The
// caller's commit then closes an empty group, or its f32 copies'.)
template <int DP, int kLd = MmaTile<DP>::kLd>
__device__ __forceinline__ void load_tile_async(float* dst, const bf16* src,
                                                int row0, int n, int d) {
  if (d % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    constexpr int kChunks = DP / 8;
    for (int idx = threadIdx.x; idx < 64 * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8, row = row0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < n && c < d)
        x = *reinterpret_cast<const uint4*>(
            src + static_cast<long long>(row) * d + c);
      // kLd and c are multiples of 4: 16-byte aligned stores
      float4* out = reinterpret_cast<float4*>(dst + r * kLd + c);
      out[0] = make_float4(widen_bf16(x.x & 0xffffu), widen_bf16(x.x >> 16),
                           widen_bf16(x.y & 0xffffu), widen_bf16(x.y >> 16));
      out[1] = make_float4(widen_bf16(x.z & 0xffffu), widen_bf16(x.z >> 16),
                           widen_bf16(x.w & 0xffffu), widen_bf16(x.w >> 16));
    }
  } else {
    const auto* s16 = reinterpret_cast<const unsigned short*>(src);
    for (int idx = threadIdx.x; idx < 64 * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP, row = row0 + r;
      dst[r * kLd + c] = widen_bf16(
          row < n && c < d ? s16[static_cast<long long>(row) * d + c] : 0u);
    }
  }
}

// A gradient stored in q/k/v's type from its f32 sum: as it is, or
// rounded to bf16 to nearest even
__device__ __forceinline__ void store_as(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store_as(bf16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

}  // namespace rabit_mma
