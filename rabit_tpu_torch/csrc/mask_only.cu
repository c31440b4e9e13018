// Bin count for Hopper (sm_90a):
//   out[b] = #{i : bins[i] == b}, an f32 [nbins] array.
// Rows whose bin id lies outside [0, nbins) count nothing.
//
// Replaces the TPU kernel tools/histogram_sweep.py:79 (mask_only, body
// _mask_only_body): the histogram kernel's two one-hot masks and one
// value-free count dot, the floor of that kernel without its per-value
// work. The TPU builds masks only because it has no scatter; on Hopper the
// same function is a privatized bin count on the skeleton of
// csrc/histogram.cu (cluster_bins.cuh: 512 threads, 16-byte streaming
// loads of four ids a thread, bins beyond one block's shared memory tiled
// over blockIdx.y, one unsigned compare to drop an id outside the tile,
// the cluster flush), so a sweep of the two compares like with like: this
// kernel reads 4 B a row with one shared atomic, the histogram 12 B with
// two.
//
// Exactness: the counters are u32 in shared memory; a cluster sums its
// copies as u32 and adds each count into the f32 output (zeroed by the
// call's first block) with one global reduction. f32 adds of whole numbers
// are exact up to 2^24 rows a bin -- the same limit as the TPU kernel's f32
// counts -- so the result is the same bits on every run, whatever the
// order of the atomics, and one launch a call: no zero fill, no second
// pass. Unlike the TPU kernel, which drops the rows after the last whole
// 16384-row chunk, it takes any row count.
//
// Bound: device-memory bytes, 4 B a row in and 4 B a bin out: at 3.35 TB/s
// 2^21 rows take 2.5 us, below the latency of one launch, so at the
// sweep's sizes the launch and the flush weigh as much as the row stream.
//
// The C entry point runs one kernel on the caller's stream, allocates
// nothing, does not synchronise, and returns its cudaError_t.

#include "cluster_bins.cuh"

namespace {

using namespace rabit_bins;

// 57344 bins * 4 B = 229,376 B of dynamic shared memory, under the
// 232,448 B a block may use (with the flush's static words).
constexpr int kMaxTile = 57344;

__device__ __forceinline__ void count_row(unsigned* counts, int bin, int lo,
                                          int width) {
  // lo <= bin < lo + width in one compare: a negative bin wraps to at least
  // 2^31, past every tile, and so does an id at or beyond nbins.
  const unsigned rel = static_cast<unsigned>(bin) - static_cast<unsigned>(lo);
  if (rel < static_cast<unsigned>(width)) atomicAdd(&counts[rel], 1u);
}

__device__ __forceinline__ void count_group(unsigned* counts, int4 b, int lo,
                                            int width) {
  count_row(counts, b.x, lo, width);
  count_row(counts, b.y, lo, width);
  count_row(counts, b.z, lo, width);
  count_row(counts, b.w, lo, width);
}

__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
    mask_only_kernel(const int* __restrict__ bins, long long n,
                     long long groups, int nbins, int tile,
                     u64* __restrict__ state, u64 gen,
                     float* __restrict__ out) {
  extern __shared__ uint4 copy4[];  // [width], padded to 16 B
  unsigned* counts = reinterpret_cast<unsigned*>(copy4);
  __shared__ int first;
  const int lo = blockIdx.y * tile;
  const int width = min(tile, nbins - lo);
  const int vecs = (width + 3) / 4;
  u64* started = state + 2 * blockIdx.y;   // and the tile's "zeroed" word
  ask_first(started, gen, &first);
  for (int i = threadIdx.x; i < vecs; i += kThreads)
    copy4[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // out + lo is 16-byte aligned (lo is 0 or a multiple of kMaxTile)
  float* dst = out + lo;
  if (first) zero_output(dst, width, started + 1, gen);

  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long at =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // groups of four ids, 16-byte aligned (groups == 0 when the caller's
  // pointer is not)
  const int4* b4 = reinterpret_cast<const int4*>(bins);
  for (long long i = at; i < groups; i += step)
    count_group(counts, __ldcs(b4 + i), lo, width);
  // the ids after the last whole group (all ids when unaligned)
  for (long long i = 4 * groups + at; i < n; i += step)
    count_row(counts, bins[i], lo, width);

  cluster_flush<1>(copy4, vecs, started + 1, gen, [=](int q, const uint4* c) {
    // the counts of local bins 4q .. 4q + 3
    const float4 f = make_float4(
        static_cast<float>(c->x), static_cast<float>(c->y),
        static_cast<float>(c->z), static_cast<float>(c->w));
    if (4 * q + 3 < width) {
      red_add4(dst + 4 * q, f);
    } else {   // the tile's last, partial quad
      const float part[4] = {f.x, f.y, f.z, f.w};
      for (int j = 0; j < width - 4 * q; ++j)
        if (part[j] != 0.f) atomicAdd(dst + 4 * q + j, part[j]);
    }
  });
}

constexpr size_t smem_bytes(int tile) {
  return static_cast<size_t>((tile + 3) / 4) * sizeof(uint4);
}

}  // namespace

extern "C" {

// Once per device and bin count, not once per call (see bins_info):
// info[6] = threads a block, blocks a cluster, blocks an SM at most, SMs,
// clusters the device holds at once with the tile of `nbins` bins, the
// largest tile.
int rabit_mask_only_info(int nbins, int* info) {
  if (nbins <= 0) return cudaErrorInvalidValue;
  const int tile = nbins < kMaxTile ? nbins : kMaxTile;
  return bins_info(mask_only_kernel, smem_bytes(kMaxTile), smem_bytes(tile),
                   kMaxTile, info);
}

// bins int32 [n]; out f32 [nbins], written whole (no zero fill before
// the call); state u64 [2 * tiles], zero-filled once per device and passed
// to every call; gen one higher than the last call's (any call's, of
// either binning kernel) on the device; all device pointers. tile and
// clusters come from the host's plan. Returns a cudaError_t (0 on
// success).
int rabit_mask_only_f32(const void* bins, long long n, int nbins, int tile,
                        int clusters, void* state, unsigned long long gen,
                        void* out, void* stream) {
  if (!plan_ok(n, nbins, tile, kMaxTile, clusters, gen))
    return cudaErrorInvalidValue;
  const int tiles = (nbins + tile - 1) / tile;
  const long long groups =
      (reinterpret_cast<uintptr_t>(bins) & 15) == 0 ? n / 4 : 0;
  return launch_clusters(mask_only_kernel, clusters, tiles, smem_bytes(tile),
                         static_cast<cudaStream_t>(stream),
                         static_cast<const int*>(bins), n, groups, nbins,
                         tile, static_cast<u64*>(state), gen,
                         static_cast<float*>(out));
}

const char* rabit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
