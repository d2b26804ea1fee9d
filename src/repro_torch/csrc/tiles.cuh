// Device-wide building blocks of the merge_add and sort_dedup kernels:
// tiles of kTile consecutive entries of one group (a leading batch index),
// and the fill of an output's dead tail.
//
// A group of width n has tiles_per_group = ceil(n / kTile) tiles; tile t
// belongs to group t / tiles_per_group, so no tile spans two groups.  A
// thread of a tile owns kTileItems consecutive entries (a blocked
// arrangement, as cub::BlockScan and cub::BlockRadixSort take them).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "merge.cuh"

namespace d4m {

constexpr int kTileThreads = 256;
constexpr int kTileItems = 16;
constexpr int64_t kTile = kTileThreads * kTileItems;
constexpr int kFlatThreads = 256;

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Blocks for a grid-stride loop over `total` entries.
inline unsigned int flat_blocks(int64_t total) {
  const int64_t b = ceil_div(total, kFlatThreads);
  return static_cast<unsigned int>(b < 132 * 32 ? b : 132 * 32);
}

// Dead slots [nnz[g], cap) of each output group: PAD keys, the zero value.
template <typename T>
__global__ void fill_tail(int32_t* rows, int32_t* cols, T* vals,
                          const int32_t* nnz, int64_t groups, int64_t cap,
                          uint32_t zero_bits) {
  const T zero = Value<T>::from_bits(zero_bits);
  const int64_t total = groups * cap;
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       p < total; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t g = p / cap;
    if (p - g * cap >= nnz[g]) {
      rows[p] = kPad;
      cols[p] = kPad;
      vals[p] = zero;
    }
  }
}

template <typename T>
inline cudaError_t launch_fill_tail(int32_t* rows, int32_t* cols, T* vals,
                                    const int32_t* nnz, int64_t groups,
                                    int64_t cap, uint32_t zero_bits,
                                    cudaStream_t stream,
                                    int* launches = nullptr) {
  if (groups * cap == 0) return cudaSuccess;
  fill_tail<T><<<flat_blocks(groups * cap), kFlatThreads, 0, stream>>>(
      rows, cols, vals, nnz, groups, cap, zero_bits);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && launches != nullptr) ++*launches;
  return err;
}

}  // namespace d4m
