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
// shared memory. So the work is tiled: one block per (64 query rows,
// head) keeps its q tile in shared memory and streams 64-key tiles of K
// and V through it, carrying a running max and sum (the online softmax)
// from the incoming (m, l, o) to (m', l', o'). The result equals the
// single-pass formula up to f32 rounding (the rescale by alpha is applied
// per key tile).
//
// Bound: operations. 4 D flops (q k^T and p v) for each (query, key) pair
// the mask leaves, on 2 + 3 D + 3 D words per row; at the training shape
// (BH 64, T = S = 512, D 32, causal: 512 * 513 / 2 pairs a head) that is
// 1.08 GFLOP, 16 us at the 67 TFLOP/s of f32 on the CUDA cores, against
// 6.5 us of device-memory traffic. This first version runs f32 FMAs on
// the CUDA cores from shared memory (no TF32, no tensor cores): each
// thread holds a 4 x 4 block of scores and 4 rows x D/16 columns of o.
//
// A fully masked row whose m is -1e30 gets p = 1 on every lane and
// l' = S, as the TPU kernel and its jnp twin give. A key tile that the
// mask covers for all 64 rows of a block is skipped once every row's
// running max is finite (rabit_flash::tile_masked): exact, and it halves
// the work under a causal mask.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace rabit_flash;

// kMasked: whether mask is given; the kernel without one reads no mask.
template <int DP, bool kMasked>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ m,
                     const float* __restrict__ l, const float* __restrict__ o,
                     const unsigned char* __restrict__ mask, int T, int S,
                     int D, float scale, float* __restrict__ mo,
                     float* __restrict__ lo, float* __restrict__ oo) {
  constexpr int kLd = Tile<DP>::kLd;
  constexpr int kOut = DP / 16;  // o columns a thread holds
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kRows, kLd]
  float* k_s = q_s + kRows * kLd;     // [kCols, kLd]
  float* v_s = k_s + kCols * kLd;     // [kCols, kLd]
  float* p_s = v_s + kCols * kLd;     // [kRows, kCols + 1]

  const int row0 = blockIdx.x * kRows;
  const long long hq = static_cast<long long>(blockIdx.y) * T;
  const long long hk = static_cast<long long>(blockIdx.y) * S;
  const int rg = threadIdx.x / 16, lane = threadIdx.x % 16;

  load_tile<DP>(q_s, q + hq * D, row0, T, D);
  float m_run[4], l_run[4], acc[4][kOut];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + rg * 4 + a;
    const bool ok = row < T;
    m_run[a] = ok ? m[hq + row] : kNegInf;
    l_run[a] = ok ? l[hq + row] : 0.f;
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      const int c = lane + 16 * e;
      acc[a][e] = (ok && c < D) ? o[(hq + row) * D + c] : 0.f;
    }
  }

  for (int col0 = 0; col0 < S; col0 += kCols) {
    // a barrier: the previous tile's readers are done. A fully masked tile
    // is skipped once every row has a finite max (above a causal diagonal)
    bool rows_ok = true;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (row0 + rg * 4 + a < T && !(m_run[a] > kNegInf)) rows_ok = false;
    if (tile_masked<kMasked>(mask, row0, col0, T, S, rows_ok)) continue;
    load_tile<DP>(k_s, k + hk * D, col0, S, D);
    load_tile<DP>(v_s, v + hk * D, col0, S, D);
    __syncthreads();
    float s[4][4];
    scores4x4<DP>(q_s, k_s, rg * 4, lane, scale, s);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = rg * 4 + a, row = row0 + r;
      float tmax = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = col0 + lane + 16 * b;
        if (col >= S)
          s[a][b] = -INFINITY;  // past S: no lane
        else if (kMasked && row < T &&
                 mask[static_cast<long long>(row) * S + col])
          s[a][b] = kNegInf;
        tmax = fmaxf(tmax, s[a][b]);
      }
      const float m_new = fmaxf(m_run[a], group_max(tmax));
      const float alpha = expf(m_run[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = lane + 16 * b;
        const float p = col0 + c < S ? expf(s[a][b] - m_new) : 0.f;
        p_s[r * (kCols + 1) + c] = p;
        psum += p;
      }
      l_run[a] = l_run[a] * alpha + group_sum(psum);
      m_run[a] = m_new;
#pragma unroll
      for (int e = 0; e < kOut; ++e) acc[a][e] *= alpha;
    }
    __syncthreads();
    // o += p v over this key tile (p is 0 and v is 0 past S)
    for (int j = 0; j < kCols; ++j) {
      float vj[kOut];
#pragma unroll
      for (int e = 0; e < kOut; ++e) vj[e] = v_s[j * kLd + lane + 16 * e];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = p_s[(rg * 4 + a) * (kCols + 1) + j];
#pragma unroll
        for (int e = 0; e < kOut; ++e) acc[a][e] = fmaf(p, vj[e], acc[a][e]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = row0 + rg * 4 + a;
    if (row >= T) continue;
    if (lane == 0) {
      mo[hq + row] = m_run[a];
      lo[hq + row] = l_run[a];
    }
#pragma unroll
    for (int e = 0; e < kOut; ++e) {
      const int c = lane + 16 * e;
      if (c < D) oo[(hq + row) * D + c] = acc[a][e];
    }
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* m, const float* l, const float* o,
                   const unsigned char* mask, int bh, int T, int S, int D,
                   float scale, float* mo, float* lo, float* oo,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kRows + 2 * kCols) * Tile<DP>::kLd +
                       kRows * (kCols + 1));
  auto kernel = mask != nullptr ? flash_fwd_kernel<DP, true>
                                 : flash_fwd_kernel<DP, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kRows - 1) / kRows, bh);
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
