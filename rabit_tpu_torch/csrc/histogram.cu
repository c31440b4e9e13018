// Gradient histogram for Hopper (sm_90a):
//   out[b] = (sum grad[i], sum hess[i]) over the rows i with bins[i] == b,
// an f32 [nbins, 2] array. Rows whose bin id lies outside [0, nbins) --
// the padding id nbins, and negative ids -- contribute nothing.
//
// Replaces the TPU kernel rabit_tpu/ops/pallas_kernels.py::
// _histogram_tpu_impl (body _hist_kernel_body, public histogram_tpu). That
// kernel recasts the scatter as two-level one-hot matmuls (bin = hi*128 +
// lo) because the TPU has no scatter. Hopper has fast shared-memory
// atomics, so this is a plain privatized histogram and keeps none of it.
//
// Bound: device-memory reads. Every row is read once, 12 bytes (bin i32,
// grad f32, hess f32), for two additions, so at 3.35 TB/s a 2^21-row call
// takes at least 7.5 us. Rows stream in as 16-byte vector loads (four
// rows a thread), with the streaming cache hint, on a grid that fills
// every SM.
//
// Contention: one global atomic per row would pile every update onto the
// 2*nbins output words in L2. Each block instead accumulates into its own
// copy of the histogram in shared memory, where the atomics resolve inside
// the SM, and goes to global memory only in the flush: one atomicAdd per
// non-zero bin word and block. The grid is capped at two blocks an SM, so
// the flush stays small next to the row stream.
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
// 28672 bins * 8 B = 229,376 B of dynamic shared memory, under the
// 232,448 B a block may use on sm_90.
constexpr int kMaxTile = 28672;
constexpr int kMaxBlocksPerSm = 2;

template <bool FAST>
__device__ __forceinline__ void add_row(float* hist, int bin, float g,
                                        float h, int lo, int width) {
  // One unsigned compare keeps lo <= bin < lo + width: a negative bin wraps
  // to at least 2^31, past every tile, and so does the padding id nbins.
  const unsigned rel = static_cast<unsigned>(bin) - static_cast<unsigned>(lo);
  if (rel < static_cast<unsigned>(width)) {
    if (FAST) {
      g = __bfloat162float(__float2bfloat16_rn(g));
      h = __bfloat162float(__float2bfloat16_rn(h));
    }
    atomicAdd(&hist[2 * rel], g);
    atomicAdd(&hist[2 * rel + 1], h);
  }
}

template <bool FAST>
__global__ void __launch_bounds__(kThreads)
    histogram_kernel(const int* __restrict__ bins,
                     const float* __restrict__ grad,
                     const float* __restrict__ hess, long long n,
                     long long groups, int nbins, int tile,
                     float* __restrict__ out) {
  extern __shared__ float hist[];  // [width, 2]
  const int lo = blockIdx.y * tile;
  const int width = min(tile, nbins - lo);
  for (int i = threadIdx.x; i < 2 * width; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  // groups of four rows, 16-byte aligned (groups == 0 when the caller's
  // pointers are not)
  const int4* b4 = reinterpret_cast<const int4*>(bins);
  const float4* g4 = reinterpret_cast<const float4*>(grad);
  const float4* h4 = reinterpret_cast<const float4*>(hess);
  for (long long i = first; i < groups; i += stride) {
    const int4 b = __ldcs(b4 + i);
    const float4 g = __ldcs(g4 + i);
    const float4 h = __ldcs(h4 + i);
    add_row<FAST>(hist, b.x, g.x, h.x, lo, width);
    add_row<FAST>(hist, b.y, g.y, h.y, lo, width);
    add_row<FAST>(hist, b.z, g.z, h.z, lo, width);
    add_row<FAST>(hist, b.w, g.w, h.w, lo, width);
  }
  // the rows after the last whole group (all rows when unaligned)
  for (long long i = 4 * groups + first; i < n; i += stride)
    add_row<FAST>(hist, bins[i], grad[i], hess[i], lo, width);
  __syncthreads();

  float* dst = out + 2 * static_cast<long long>(lo);
  for (int i = threadIdx.x; i < 2 * width; i += blockDim.x) {
    const float v = hist[i];
    if (v != 0.f) atomicAdd(&dst[i], v);
  }
}

template <bool FAST>
cudaError_t launch(const int* bins, const float* grad, const float* hess,
                   long long n, int nbins, float* out, cudaStream_t stream) {
  const int tile = nbins < kMaxTile ? nbins : kMaxTile;
  const int tiles = (nbins + tile - 1) / tile;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(tile) * 2 * sizeof(float);
  auto kernel = histogram_kernel<FAST>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    // above 48 KB only as opted-in dynamic shared memory; without this the
    // launch is refused and nothing runs
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (per_sm > kMaxBlocksPerSm) per_sm = kMaxBlocksPerSm;

  const bool aligned = ((reinterpret_cast<uintptr_t>(bins) |
                         reinterpret_cast<uintptr_t>(grad) |
                         reinterpret_cast<uintptr_t>(hess)) &
                        15) == 0;
  const long long groups = aligned ? n / 4 : 0;
  const long long items = groups + (n - 4 * groups);
  long long blocks = static_cast<long long>(sms) * per_sm;
  const long long needed = (items + kThreads - 1) / kThreads;
  if (needed < blocks) blocks = needed;
  if (blocks < 1) blocks = 1;

  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles));
  histogram_kernel<FAST><<<grid, kThreads, smem, stream>>>(
      bins, grad, hess, n, groups, nbins, tile, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bins int32 [n], grad/hess f32 [n], out f32 [nbins, 2] zero-filled by the
// caller; all device pointers. Returns a cudaError_t (0 on success).
int rabit_histogram_f32(const void* bins, const void* grad, const void* hess,
                        long long n, int nbins, int fast, void* out,
                        void* stream) {
  if (n < 0 || nbins <= 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int* b = static_cast<const int*>(bins);
  const float* g = static_cast<const float*>(grad);
  const float* h = static_cast<const float*>(hess);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<true>(b, g, h, n, nbins, o, s)
              : launch<false>(b, g, h, n, nbins, o, s);
}

const char* rabit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
