// Pieces shared by the flash-attention block kernels (flash_block.cu and
// flash_block_bwd.cu): the tile shape and block size, a tile that a pass
// visits, and the opt-in to large shared memory. The products, the score
// function and the tile loads are in flash_mma.cuh.

#pragma once

#include <cuda_runtime.h>

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
