// Bin count for Hopper (sm_90a):
//   out[b] = #{i : bins[i] == b}, an f32 [nbins] array.
// Rows whose bin id lies outside [0, nbins) count nothing.
//
// Replaces the TPU kernel tools/histogram_sweep.py:79 (mask_only, body
// _mask_only_body): the histogram kernel's two one-hot masks and one
// value-free count dot, the floor of that kernel without its per-value
// work. The TPU builds masks only because it has no scatter; on Hopper the
// same function is a privatized bin count on the skeleton of
// csrc/histogram.cu (512 threads, 16-byte streaming loads of four ids a
// thread, the grid capped at two blocks an SM, bins beyond one block's
// shared memory tiled over blockIdx.y, one unsigned compare to drop an id
// outside the tile), so a sweep of the two compares like with like: this
// kernel reads 4 B a row with one shared atomic, the histogram 12 B with
// two.
//
// Exactness: the counters are u32 in shared memory and the flush adds
// each block's non-zero count into a zero-filled u32 buffer with one
// integer atomicAdd, so the counts are exact and the same bits on every
// run, whatever the atomics' order. A second pass converts them to f32,
// which is exact up to 2^24 rows a bin -- the same limit as the TPU
// kernel's f32 counts. Unlike the TPU kernel, which drops the rows after
// the last whole 16384-row chunk, it takes any row count.
//
// Bound: device-memory bytes, 4 B a row in and 4 B a bin out: at 3.35 TB/s
// 2^21 rows take 2.5 us, below the latency of one launch, so at the
// sweep's sizes the launch, the zero fill and the flush set the time, not
// the row stream.
//
// Contention: with 256 bins, the 512 threads of a block hit 256 shared
// words, so lanes of one warp often add to the same address and the
// atomics serialise. One copy of the counters a warp is the obvious cure;
// it is left for later unless the sweep shows 256 bins well off the
// 1024-bin rate.
//
// The C entry point runs on the caller's stream (zero fill, count,
// conversion), allocates nothing, does not synchronise, and returns the
// first cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
// 57344 bins * 4 B = 229,376 B of dynamic shared memory, under the
// 232,448 B a block may use on sm_90.
constexpr int kMaxTile = 57344;
constexpr int kMaxBlocksPerSm = 2;

__device__ __forceinline__ void count_row(unsigned* counts, int bin, int lo,
                                          int width) {
  // lo <= bin < lo + width in one compare: a negative bin wraps to at least
  // 2^31, past every tile, and so does an id at or beyond nbins.
  const unsigned rel = static_cast<unsigned>(bin) - static_cast<unsigned>(lo);
  if (rel < static_cast<unsigned>(width)) atomicAdd(&counts[rel], 1u);
}

__global__ void __launch_bounds__(kThreads)
    mask_only_kernel(const int* __restrict__ bins, long long n,
                     long long groups, int nbins, int tile,
                     unsigned* __restrict__ out) {
  extern __shared__ unsigned counts[];  // [width]
  const int lo = blockIdx.y * tile;
  const int width = min(tile, nbins - lo);
  for (int i = threadIdx.x; i < width; i += blockDim.x) counts[i] = 0u;
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // groups of four ids, 16-byte aligned (groups == 0 when the caller's
  // pointer is not)
  const int4* b4 = reinterpret_cast<const int4*>(bins);
  for (long long i = first; i < groups; i += stride) {
    const int4 b = __ldcs(b4 + i);
    count_row(counts, b.x, lo, width);
    count_row(counts, b.y, lo, width);
    count_row(counts, b.z, lo, width);
    count_row(counts, b.w, lo, width);
  }
  // the ids after the last whole group (all ids when unaligned)
  for (long long i = 4 * groups + first; i < n; i += stride)
    count_row(counts, bins[i], lo, width);
  __syncthreads();

  unsigned* dst = out + lo;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const unsigned c = counts[i];
    if (c != 0u) atomicAdd(&dst[i], c);
  }
}

__global__ void to_float_kernel(const unsigned* __restrict__ counts,
                                int nbins, float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nbins;
       i += gridDim.x * blockDim.x)
    out[i] = static_cast<float>(counts[i]);
}

cudaError_t launch(const int* bins, long long n, int nbins, unsigned* counts,
                   float* out, cudaStream_t stream) {
  const int tile = nbins < kMaxTile ? nbins : kMaxTile;
  const int tiles = (nbins + tile - 1) / tile;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(tile) * sizeof(unsigned);
  cudaError_t err;
  if (smem > 48 * 1024) {
    // above 48 KB only as opted-in dynamic shared memory; without this the
    // launch is refused and nothing runs
    err = cudaFuncSetAttribute(mask_only_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, mask_only_kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (per_sm > kMaxBlocksPerSm) per_sm = kMaxBlocksPerSm;

  const bool aligned = (reinterpret_cast<uintptr_t>(bins) & 15) == 0;
  const long long groups = aligned ? n / 4 : 0;
  const long long items = groups + (n - 4 * groups);
  long long blocks = static_cast<long long>(sms) * per_sm;
  const long long needed = (items + kThreads - 1) / kThreads;
  if (needed < blocks) blocks = needed;
  if (blocks < 1) blocks = 1;

  err = cudaMemsetAsync(counts, 0, static_cast<size_t>(nbins) * 4, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  mask_only_kernel<<<grid, kThreads, smem, stream>>>(bins, n, groups, nbins,
                                                     tile, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  int convert_blocks = (nbins + 255) / 256;
  if (convert_blocks > sms * 4) convert_blocks = sms * 4;
  to_float_kernel<<<convert_blocks, 256, 0, stream>>>(counts, nbins, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bins int32 [n]; counts u32 [nbins] scratch (zero-filled here); out f32
// [nbins]; all device pointers. Returns a cudaError_t (0 on success).
int rabit_mask_only_f32(const void* bins, long long n, int nbins,
                        void* counts, void* out, void* stream) {
  if (n < 0 || nbins <= 0) return cudaErrorInvalidValue;
  return launch(static_cast<const int*>(bins), n, nbins,
                static_cast<unsigned*>(counts), static_cast<float*>(out),
                static_cast<cudaStream_t>(stream));
}

const char* rabit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
