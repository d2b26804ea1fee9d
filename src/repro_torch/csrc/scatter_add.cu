// scatter_add: table[ids] += rows, in place, for sorted-unique int32 ids.
//
// Replaces the TPU kernel repro/kernels/scatter_add/kernel.py:45
// (scatter_add_pallas: one grid walk over the ids, a dynamic-slice
// read-modify-write of one table row per live id, the table aliased in
// place) and computes what its oracle, repro/kernels/scatter_add/ref.py
// (scatter_add_ref, `table.at[where(live, ids, 0)].add(where(live, rows,
// 0).astype(table.dtype))`), computes, bit for bit:
//   * each row is cast to the table's type first, then added in that type
//     (float32 arithmetic rounded to bfloat16 or float16 for such a table:
//     two roundings for float32 rows, as the oracle's astype-then-add);
//   * a negative live id wraps to nrows + id; a live id still outside
//     [0, nrows) is dropped (what `.at[]` does);
//   * PAD slots (2^31 - 1) send "+ 0.0" to row 0: whenever ids hold a PAD,
//     row 0 becomes row 0 + 0.0 after its live add (-0.0 turns +0.0, NaN
//     stays NaN).  The TPU kernel skips PAD slots instead; the port keeps
//     the oracle's rule (ROADMAP C10).  PAD rows are never read, so NaN
//     there is harmless, as the oracle's mask makes it;
//   * a wrapped negative id that lands on the row of a non-negative id adds
//     first, as its slot comes first in the sorted ids.
//
// Rows are independent and the ids unique, so there are no atomics: one
// block owns one table row at a time (a grid-stride loop over the ids),
// its threads split the columns, 8 values a thread as 16-byte vectors where
// d is a multiple of 8 and both buffers are 16-byte aligned, one value a
// thread otherwise.  Row 0's "+ 0.0" is applied by the block that owns row
// 0 (after its add), or, when no live id reaches row 0, by the block that
// meets the first PAD slot: one writer per row, no race.  The ids are
// sorted, so "any PAD" is ids[k - 1] == PAD, read on the device, and a
// block stops at its first PAD slot.  Ownership searches run only where
// the ids hold a negative value (ids[0] < 0).
//
// What bounds it: bytes.  The least it must move is, per live id, one
// table row read and written and one row read (12 B a column in float32,
// 8 B for a bfloat16 table with float32 rows), plus the ids.  It does one
// add per value.  Dead slots cost a read of their id.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "value_types.cuh"

namespace {

constexpr int32_t kPad = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kVec = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// t + cast<T>(r), in T
template <typename T, typename R>
__device__ __forceinline__ T add_row(T t, R r) {
  return from_f<T>(to_f(t) + to_f(from_f<T>(to_f(r))));
}

template <typename T>
__device__ __forceinline__ T plus_zero(T t) {
  return from_f<T>(to_f(t) + 0.0f);
}

template <typename X>
struct alignas(16) Pack {
  X v[kVec];
};

// position of x in the sorted ids, or -1
__device__ __forceinline__ int64_t find(const int32_t* ids, int64_t k,
                                        int64_t x) {
  int64_t lo = 0, hi = k;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(ids[mid]) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return (lo < k && static_cast<int64_t>(ids[lo]) == x) ? lo : -1;
}

// trow[c] = ((trow[c] + prow[c]) + rrow[c]) (+ 0.0), prow optional
template <typename T, typename R, bool kVectors>
__device__ __forceinline__ void apply_row(T* __restrict__ trow,
                                          const R* __restrict__ rrow,
                                          const R* __restrict__ prow,
                                          bool zero, int64_t d) {
  if (kVectors) {
    for (int64_t c = static_cast<int64_t>(threadIdx.x) * kVec; c < d;
         c += static_cast<int64_t>(kThreads) * kVec) {
      Pack<T> t = *reinterpret_cast<const Pack<T>*>(trow + c);
      if (prow != nullptr) {
        const Pack<R> p = *reinterpret_cast<const Pack<R>*>(prow + c);
#pragma unroll
        for (int j = 0; j < kVec; ++j) t.v[j] = add_row(t.v[j], p.v[j]);
      }
      if (rrow != nullptr) {
        const Pack<R> r = *reinterpret_cast<const Pack<R>*>(rrow + c);
#pragma unroll
        for (int j = 0; j < kVec; ++j) t.v[j] = add_row(t.v[j], r.v[j]);
      }
      if (zero) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) t.v[j] = plus_zero(t.v[j]);
      }
      *reinterpret_cast<Pack<T>*>(trow + c) = t;
    }
  } else {
    for (int64_t c = threadIdx.x; c < d; c += kThreads) {
      T t = trow[c];
      if (prow != nullptr) t = add_row(t, prow[c]);
      if (rrow != nullptr) t = add_row(t, rrow[c]);
      if (zero) t = plus_zero(t);
      trow[c] = t;
    }
  }
}

template <typename T, typename R, bool kVectors>
__global__ void __launch_bounds__(kThreads)
    scatter_add_kernel(const int32_t* __restrict__ ids,
                       const R* __restrict__ rows, T* __restrict__ table,
                       int64_t k, int64_t nrows, int64_t d) {
  const int32_t first = ids[0];
  const bool has_neg = first < 0;
  const bool any_pad = ids[k - 1] == kPad;
  for (int64_t i = blockIdx.x; i < k; i += gridDim.x) {
    const int32_t id = ids[i];
    if (id == kPad) {
      if (i == 0 || ids[i - 1] != kPad) {
        // the first PAD slot: row 0 + 0.0, unless a live id owns row 0
        const bool owned = has_neg ? (find(ids, k, 0) >= 0 || find(ids, k, -nrows) >= 0)
                                   : first == 0;
        if (!owned) {
          apply_row<T, R, kVectors>(table, nullptr, nullptr, true, d);
        }
      }
      return;  // the ids are sorted: every later slot is PAD too
    }
    const int64_t t = id < 0 ? id + nrows : id;
    if (t < 0 || t >= nrows) continue;  // dropped
    int64_t partner = -1;
    if (id < 0) {
      if (find(ids, k, t) >= 0) continue;  // the id t owns the row, adds us
    } else if (has_neg) {
      partner = find(ids, k, static_cast<int64_t>(id) - nrows);
    }
    apply_row<T, R, kVectors>(table + t * d, rows + i * d,
                              partner >= 0 ? rows + partner * d : nullptr,
                              any_pad && t == 0, d);
  }
}

template <typename T, typename R>
cudaError_t launch(const void* ids, const void* rows, void* table, int64_t k,
                   int64_t nrows, int64_t d, bool vectors, int64_t grid,
                   cudaStream_t stream) {
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* r = static_cast<const R*>(rows);
  auto* t = static_cast<T*>(table);
  if (vectors) {
    scatter_add_kernel<T, R, true>
        <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(i, r, t, k,
                                                               nrows, d);
  } else {
    scatter_add_kernel<T, R, false>
        <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(i, r, t, k,
                                                               nrows, d);
  }
  return cudaGetLastError();
}

}  // namespace

// table_dtype, rows_dtype: 0 float32, 1 bfloat16, 3 float16.  ids int32[k],
// rows [k, d], table [nrows, d], all contiguous on the stream's device;
// vectors asks for the 16-byte path (d % 8 == 0, rows and table 16-byte
// aligned).
extern "C" int scatter_add_run(int table_dtype, int rows_dtype,
                               const void* ids, const void* rows, void* table,
                               int64_t k, int64_t nrows, int64_t d,
                               int vectors, void* stream) {
  if (k < 0 || nrows < 0 || d < 0 || nrows >= kPad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k == 0 || nrows == 0 || d == 0) return 0;
  if (vectors && d % kVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int64_t grid = k < most ? k : most;
  auto s = static_cast<cudaStream_t>(stream);
  const bool v = vectors != 0;
  return d4m::by_float_type(table_dtype, [&](auto t) {
    return d4m::by_float_type(rows_dtype, [&](auto r) {
      return static_cast<int>(launch<decltype(t), decltype(r)>(
          ids, rows, table, k, nrows, d, v, grid, s));
    });
  });
}

extern "C" const char* scatter_add_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
