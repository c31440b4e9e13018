// The skeleton shared by the two binning kernels (histogram.cu and
// mask_only.cu): a privatized shared-memory binning whose flush goes
// through thread-block clusters, in one launch a call with no zero fill
// before it.
//
// Each block bins its rows into its own copy of its bin tile in shared
// memory. Then, per cluster of kCluster blocks: cluster.sync(); block r of
// the cluster sums slice r of the kCluster copies through distributed
// shared memory (map_shared_rank) and adds the sums into the output with
// global reductions (fire-and-forget atomics in L2, four words each,
// skipping zeros); cluster.sync() again, so that no block leaves while a
// peer still reads its shared memory. Four bins get one reduction a
// cluster, not one a bin and block.
//
// The output is zeroed inside the same launch: the first block of a bin
// tile to start in this call (the one whose atomicMax lifts the tile's
// "started" word to this call's generation) zeroes the tile's output and
// then publishes the generation in the tile's "zeroed" word (a release
// store). Every block waits for that word before its reductions (an
// acquire load, passed at once unless the first block is still zeroing).
// The wait cannot deadlock: the block it waits for is running and waits
// for nobody. The generation is a count kept by the host, one higher each
// call; the words only grow, so nothing is reset, and a launch that never
// ran (a generation skipped) does no harm. Being a launch argument, it
// would repeat in every replay of a captured CUDA graph, whose replays
// would then skip the zeroing: a graph needs the generation in device
// memory first.
//
// The state words live in a buffer that the host allocates once per
// device, zero-filled, and passes to every call. Calls that share it must
// be ordered on one stream (as every caller of the port is): two calls
// running at once could each take the other's zeroing for their own.
//
// The grid: x = clusters * kCluster (a cluster spans x only), y = bin
// tiles. The host plans it (rabit_tpu_torch/ops/histogram.py::plan, tested
// on the CPU) from the counts that bins_info reports once per device and
// bin count; the C entry points take the plan and only check it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rabit_bins {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
// The flush's reductions grow with the clusters: with 2 blocks an SM,
// clusters of 2, 4 and 8 (132, 66, 30 of them on an H100) took 56.7, 42.1
// and 33.2 us at 3,670,016 rows x 7168 bins with one reduction a word
// (PERF.md, section 6). 16 is not portable and was slower.
constexpr int kCluster = 8;
// the plan caps the grid at two blocks an SM (and __launch_bounds__ keeps
// the registers to that): three or four made more copies to flush and
// spilled registers, for a row stream no faster (PERF.md, section 6)
constexpr int kMaxBlocksPerSm = 2;

using u64 = unsigned long long;

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// out[0..3] += v, one reduction in L2 (16-byte aligned out), unless v is 0
__device__ __forceinline__ void red_add4(float* out, float4 v) {
  if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(out),
                 "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                 : "memory");
}

// Whether this block is the first of its bin tile to start in call `gen`
// (state[0] is the tile's "started" word). Only thread 0 asks; the answer
// is in the result after the caller's next __syncthreads(), so the
// atomic's latency overlaps the zeroing of the shared copy.
__device__ __forceinline__ void ask_first(u64* started, u64 gen, int* first) {
  if (threadIdx.x == 0) *first = atomicMax(started, gen) < gen;
}

// The first block of the tile zeroes the tile's output, `words` floats
// from a 16-byte aligned `dst`, and publishes generation `gen` in `zeroed`.
__device__ __forceinline__ void zero_output(float* dst, int words,
                                            u64* zeroed, u64 gen) {
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < words / 4; i += kThreads)
    dst4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 4 * (words / 4) + threadIdx.x; i < words; i += kThreads)
    dst[i] = 0.f;
  __syncthreads();   // every thread's zeros before thread 0's release
  if (threadIdx.x == 0) st_release(zeroed, gen);
}

// The flush of one block after its row stream. `mine` is its shared copy:
// WORDS arrays of `quads` 16-byte vectors (array w at mine + w * quads),
// vector q of each holding one word of the four bins 4q .. 4q + 3.
// red(q, sums) adds the cluster's sums of quad q into the output.
template <int WORDS, class Vec, class Red>
__device__ __forceinline__ void cluster_flush(Vec* mine, int quads,
                                              const u64* zeroed, u64 gen,
                                              Red red) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = (quads + kCluster - 1) / kCluster;
  const int s0 = min(quads, rank * per), s1 = min(quads, s0 + per);
  if (threadIdx.x == 0)   // the output is zero before the first reduction
    while (ld_acquire(zeroed) < gen) {
    }
  cluster.sync();   // every copy of the cluster is complete
  for (int q = s0 + threadIdx.x; q < s1; q += kThreads) {
    Vec acc[WORDS];
#pragma unroll
    for (int w = 0; w < WORDS; ++w) acc[w] = mine[w * quads + q];
#pragma unroll
    for (int k = 1; k < kCluster; ++k) {   // the peers after this rank
      const Vec* peer =
          cluster.map_shared_rank(mine, (rank + k) % kCluster);
#pragma unroll
      for (int w = 0; w < WORDS; ++w) {
        const Vec x = peer[w * quads + q];
        acc[w].x += x.x, acc[w].y += x.y, acc[w].z += x.z, acc[w].w += x.w;
      }
    }
    red(q, acc);
  }
  cluster.sync();   // no block leaves while a peer reads its copy
}

// The launch: grid (clusters * kCluster, tiles), clusters of (kCluster, 1,
// 1), on the caller's stream.
template <class... Params, class... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int clusters,
                            int tiles, size_t smem, cudaStream_t stream,
                            Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kCluster),
                     static_cast<unsigned>(tiles), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// Once per device and bin count, not once per call: lets the kernel take
// `max_smem` bytes of dynamic shared memory (above 48 KB only so opted
// in; a launch above it is refused and nothing runs), then reports
// info[0..5] = kThreads, kCluster, kMaxBlocksPerSm, the SM count, the
// clusters the device holds at once with `smem` bytes a block, and the
// kernel's tile limit `max_tile` (bins).
template <class... Params>
cudaError_t bins_info(void (*kernel)(Params...), size_t max_smem,
                      size_t smem, int max_tile, int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(max_smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, clusters = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) !=
      cudaSuccess)
    return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  info[0] = kThreads;
  info[1] = kCluster;
  info[2] = kMaxBlocksPerSm;
  info[3] = sms;
  info[4] = clusters;
  info[5] = max_tile;
  return cudaSuccess;
}

// The checks of a plan that the C entry points take from the host.
inline bool plan_ok(long long n, int nbins, int tile, int max_tile,
                    int clusters, u64 gen) {
  if (n < 0 || nbins <= 0 || tile <= 0 || tile > max_tile) return false;
  if (clusters < 1 || clusters > 65535 / kCluster || gen == 0) return false;
  const long long tiles = (static_cast<long long>(nbins) + tile - 1) / tile;
  return tiles <= 65535 && (tiles == 1 || tile == max_tile);
}

}  // namespace rabit_bins
