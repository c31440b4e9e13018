// Gradient histogram for Hopper (sm_90a):
//   out[b] = (sum grad[i], sum hess[i]) over the rows i with bins[i] == b,
// an f32 [nbins, 2] array. Rows whose bin id lies outside [0, nbins) --
// the padding id nbins, negative ids, INT32_MIN -- contribute nothing.
//
// Replaces the TPU kernel rabit_tpu/ops/pallas_kernels.py::
// _histogram_tpu_impl (body _hist_kernel_body, public histogram_tpu). That
// kernel recasts the scatter as two-level one-hot matmuls (bin = hi*128 +
// lo) because the TPU has no scatter. Hopper has fast shared-memory
// atomics, so this is a privatized histogram and keeps none of it.
//
// Bound: device-memory reads. Every row is read once, 12 bytes (bin i32,
// grad f32, hess f32), for two additions, so at 3.35 TB/s a 2^21-row call
// takes at least 7.5 us. Rows stream in as 16-byte vector loads (four
// rows a thread), with the streaming cache hint, on a grid of up to two
// blocks an SM. The loads alone reach 87 % of that rate at the margin;
// the two shared compare-and-swap loops a row bring the kernel to about
// 63 % (PERF.md, section 5).
//
// Contention: each block accumulates into its own copy of the histogram in
// shared memory, where the atomics resolve inside the SM. The f32 shared
// atomicAdd compiles to a compare-and-swap loop (LDS, FADD,
// ATOMS.CAST.SPIN), two a row, so the copy keeps the grad sums and the
// hess sums in two arrays: the 32 lanes of a warp spread over all 32
// banks, where the interleaved (grad, hess) pairs left them 16. The flush
// goes through thread-block clusters (cluster_bins.cuh): the copies of a
// cluster are summed through distributed shared memory, and each bin gets
// one global reduction a cluster, not one a block. One launch a call and
// no zero fill before it: the first block of a call zeroes the output.
//
// A bin range larger than one block's shared memory is tiled over
// blockIdx.y (the counterpart of the TPU kernel's a-tile grid axis); every
// tile reads all rows and keeps the ones that fall into its range.
//
// Precision: fast=1 rounds each value to bf16 (round to nearest even, as
// JAX's astype(bfloat16) does) before accumulating in f32; fast=0
// accumulates the f32 values as they are. Atomics add in an order that
// changes from run to run, so the last bits of a bin's sum do too.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the launch's cudaError_t.

#include <cuda_bf16.h>

#include "cluster_bins.cuh"

namespace {

using namespace rabit_bins;

// 28672 bins * 8 B = 229,376 B of dynamic shared memory, under the
// 232,448 B a block may use (with the flush's static words).
constexpr int kMaxTile = 28672;

// hist: the grad sums, the hess sums at hist + hoff
template <bool FAST>
__device__ __forceinline__ void add_row(float* hist, int hoff, int bin,
                                        float g, float h, int lo,
                                        int width) {
  // One unsigned compare keeps lo <= bin < lo + width: a negative bin wraps
  // to at least 2^31, past every tile, and so does the padding id nbins.
  const unsigned rel = static_cast<unsigned>(bin) - static_cast<unsigned>(lo);
  if (rel < static_cast<unsigned>(width)) {
    if (FAST) {
      g = __bfloat162float(__float2bfloat16_rn(g));
      h = __bfloat162float(__float2bfloat16_rn(h));
    }
    atomicAdd(&hist[rel], g);
    atomicAdd(&hist[hoff + rel], h);
  }
}

template <bool FAST>
__device__ __forceinline__ void add_group(float* hist, int hoff, int4 b,
                                          float4 g, float4 h, int lo,
                                          int width) {
  add_row<FAST>(hist, hoff, b.x, g.x, h.x, lo, width);
  add_row<FAST>(hist, hoff, b.y, g.y, h.y, lo, width);
  add_row<FAST>(hist, hoff, b.z, g.z, h.z, lo, width);
  add_row<FAST>(hist, hoff, b.w, g.w, h.w, lo, width);
}

template <bool FAST>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
    histogram_kernel(const int* __restrict__ bins,
                     const float* __restrict__ grad,
                     const float* __restrict__ hess, long long n,
                     long long groups, int nbins, int tile,
                     u64* __restrict__ state, u64 gen,
                     float* __restrict__ out) {
  // the grad sums in vectors [0, gv), the hess sums in [gv, 2 gv)
  extern __shared__ float4 copy4[];
  float* hist = reinterpret_cast<float*>(copy4);
  __shared__ int first;
  const int lo = blockIdx.y * tile;
  const int width = min(tile, nbins - lo);
  const int gv = (width + 3) / 4, hoff = 4 * gv;
  u64* started = state + 2 * blockIdx.y;   // and the tile's "zeroed" word
  ask_first(started, gen, &first);
  for (int i = threadIdx.x; i < 2 * gv; i += kThreads)
    copy4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  // out + 2 lo is 16-byte aligned (lo is 0 or a multiple of kMaxTile)
  float* dst = out + 2 * static_cast<long long>(lo);
  if (first) zero_output(dst, 2 * width, started + 1, gen);

  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long at =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // groups of four rows, 16-byte aligned (groups == 0 when the caller's
  // pointers are not)
  const int4* b4 = reinterpret_cast<const int4*>(bins);
  const float4* g4 = reinterpret_cast<const float4*>(grad);
  const float4* h4 = reinterpret_cast<const float4*>(hess);
  for (long long i = at; i < groups; i += step)
    add_group<FAST>(hist, hoff, __ldcs(b4 + i), __ldcs(g4 + i),
                    __ldcs(h4 + i), lo, width);
  // the rows after the last whole group (all rows when unaligned)
  for (long long i = 4 * groups + at; i < n; i += step)
    add_row<FAST>(hist, hoff, bins[i], grad[i], hess[i], lo, width);

  cluster_flush<2>(copy4, gv, started + 1, gen, [=](int q, const float4* s) {
    // the (grad, hess) pairs of local bins 4q .. 4q + 3, interleaved
    const float4 lo2 = make_float4(s[0].x, s[1].x, s[0].y, s[1].y);
    const float4 hi2 = make_float4(s[0].z, s[1].z, s[0].w, s[1].w);
    float* o = dst + 8 * q;
    if (4 * q + 3 < width) {
      red_add4(o, lo2);
      red_add4(o + 4, hi2);
    } else {   // the tile's last, partial quad
      const float pair[8] = {lo2.x, lo2.y, lo2.z, lo2.w,
                             hi2.x, hi2.y, hi2.z, hi2.w};
      for (int j = 0; j < 2 * (width - 4 * q); ++j)
        if (pair[j] != 0.f) atomicAdd(o + j, pair[j]);
    }
  });
}

constexpr size_t smem_bytes(int tile) {
  return static_cast<size_t>(2 * ((tile + 3) / 4)) * sizeof(float4);
}

}  // namespace

extern "C" {

// Once per device and bin count, not once per call (see bins_info):
// info[6] = threads a block, blocks a cluster, blocks an SM at most, SMs,
// clusters the device holds at once with the tile of `nbins` bins, the
// largest tile.
int rabit_histogram_info(int nbins, int* info) {
  if (nbins <= 0) return cudaErrorInvalidValue;
  const int tile = nbins < kMaxTile ? nbins : kMaxTile;
  int fast[6];
  cudaError_t err = bins_info(histogram_kernel<false>, smem_bytes(kMaxTile),
                              smem_bytes(tile), kMaxTile, info);
  if (err == cudaSuccess)
    err = bins_info(histogram_kernel<true>, smem_bytes(kMaxTile),
                    smem_bytes(tile), kMaxTile, fast);
  if (err != cudaSuccess) return err;
  if (fast[4] < info[4]) info[4] = fast[4];   // the one plan serves both
  return cudaSuccess;
}

// bins int32 [n], grad/hess f32 [n]; out f32 [nbins, 2], written whole
// (no zero fill before the call); state u64 [2 * tiles], zero-filled once
// per device and passed to every call; gen one higher than the last call's
// (any call's, of either binning kernel) on the device; all device
// pointers. tile and clusters come from the host's plan. Returns a
// cudaError_t (0 on success).
int rabit_histogram_f32(const void* bins, const void* grad, const void* hess,
                        long long n, int nbins, int fast, int tile,
                        int clusters, void* state, unsigned long long gen,
                        void* out, void* stream) {
  if (!plan_ok(n, nbins, tile, kMaxTile, clusters, gen))
    return cudaErrorInvalidValue;
  const int tiles = (nbins + tile - 1) / tile;
  const bool aligned = ((reinterpret_cast<uintptr_t>(bins) |
                         reinterpret_cast<uintptr_t>(grad) |
                         reinterpret_cast<uintptr_t>(hess)) &
                        15) == 0;
  const long long groups = aligned ? n / 4 : 0;
  const int* b = static_cast<const int*>(bins);
  const float* g = static_cast<const float*>(grad);
  const float* h = static_cast<const float*>(hess);
  u64* st = static_cast<u64*>(state);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch_clusters(histogram_kernel<true>, clusters, tiles,
                                smem_bytes(tile), s, b, g, h, n, groups,
                                nbins, tile, st, gen, o)
              : launch_clusters(histogram_kernel<false>, clusters, tiles,
                                smem_bytes(tile), s, b, g, h, n, groups,
                                nbins, tile, st, gen, o);
}

const char* rabit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
