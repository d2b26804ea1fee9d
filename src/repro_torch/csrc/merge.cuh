// Block-level in-place merge of two sorted, unique-key COO lists with a
// semiring fold (hier_cascade's merge), and the key, fold and search
// helpers every kernel of the port shares (merge_add, sort_dedup).
//
// Keys are (row, col) int32 pairs ordered lexicographically, compared as the
// int64 key (row << 32) + (col + 2^31).  Dead slots carry PAD keys and sit
// after the live prefix.
//
// merge_into() merges the live prefix of `src` into the live prefix of `dst`
// *in place in dst*.  Equal keys fold as fold_add(dst, src), dst on the left,
// as repro.core.assoc.add folds them.  The result is truncated to `cap`
// entries, like assoc._compact: entries past it are dropped, and the caller
// sees the untruncated survivor count.
//
// Why in place: the destination is a layer of up to tens of millions of
// entries per instance, and a scratch copy of it per instance would double
// the state.  Only a source-sized scratch is used:
//   pass 0  for each src element s: rank[s] = lower_bound(dst, key_s) and a
//           block prefix sum over "key_s is not in dst" -> uniq[s]
//           (exclusive), uniq[ns] = number of new keys;
//   pass 1  dst element j moves to j + uniq[upper_bound(src, key_j)] >= j,
//           folding the equal src element when there is one.  Chunks go from
//           the back to the front; each chunk is read into registers before
//           a barrier and written after it, and writes land at or above the
//           chunk's start, so no unread dst entry is ever overwritten;
//   pass 2  each new src element s goes to the hole rank[s] + uniq[s].
// Every written value gets "+ 0.0f", which turns -0.0 into +0.0 exactly as
// the reference's associative-scan interleave does.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include <cub/block/block_scan.cuh>

namespace d4m {

constexpr int32_t kPad = 0x7fffffff;

// semiring fold codes (repro_torch.core.semiring.FOLD_*)
enum Fold : int { kFoldPlus = 0, kFoldMax = 1, kFoldMin = 2, kFoldFirst = 3 };

__device__ __forceinline__ int64_t pack_key(int32_t r, int32_t c) {
  return static_cast<int64_t>(r) * 4294967296LL +
         (static_cast<int64_t>(c) + 2147483648LL);
}

// sr.add(dst, src).  max/min propagate NaN like torch.maximum/jnp.maximum;
// fmaxf/fminf would drop it.
__device__ __forceinline__ float fold_add(int fold, float dst, float src) {
  switch (fold) {
    case kFoldPlus:
      return dst + src;
    case kFoldMax:
      return (dst != dst || dst > src) ? dst : src;
    case kFoldMin:
      return (dst != dst || dst < src) ? dst : src;
    default:  // kFoldFirst
      return dst;
  }
}

// Value types the kernels take (float32 and bfloat16): every fold runs in
// float32 and rounds back to the value type after each operation, as a
// PyTorch elementwise op on the value type does.
template <typename T>
struct Value;

template <>
struct Value<float> {
  static __device__ __forceinline__ float to_float(float x) { return x; }
  static __device__ __forceinline__ float from_float(float x) { return x; }
  static __device__ __forceinline__ float from_bits(uint32_t b) {
    return __uint_as_float(b);
  }
};

template <>
struct Value<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_bits(uint32_t b) {
    return __ushort_as_bfloat16(static_cast<unsigned short>(b));
  }
};

// sr.add(dst, src) on the value type
template <typename T>
__device__ __forceinline__ T fold_value(int fold, T dst, T src) {
  return Value<T>::from_float(
      fold_add(fold, Value<T>::to_float(dst), Value<T>::to_float(src)));
}

// "+ 0.0": what the reference's scan interleave does to every value it
// writes (-0.0 becomes +0.0, a NaN becomes the canonical NaN)
template <typename T>
__device__ __forceinline__ T plus_zero(T x) {
  return Value<T>::from_float(Value<T>::to_float(x) + 0.0f);
}

// First index in [0, n) whose key is >= q (kUpper = false) or > q (true).
template <bool kUpper>
__device__ __forceinline__ int64_t search(const int32_t* rows,
                                          const int32_t* cols, int64_t n,
                                          int64_t q) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int64_t k = pack_key(rows[mid], cols[mid]);
    if (kUpper ? (k <= q) : (k < q)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int kThreads>
struct MergeShared {
  typename cub::BlockScan<int32_t, kThreads>::TempStorage scan;
  int32_t carry;
};

// Whole block calls; returns nd + (number of src keys not in dst).
// rank/uniq: scratch of at least ns and ns + 1 int32.
template <int kThreads>
__device__ int64_t merge_into(int32_t* dr, int32_t* dc, float* dv, int64_t nd,
                              int64_t cap, const int32_t* sr,
                              const int32_t* sc, const float* sv, int64_t ns,
                              int32_t* rank, int32_t* uniq, int fold,
                              MergeShared<kThreads>& sh) {
  using Scan = cub::BlockScan<int32_t, kThreads>;
  const int tid = threadIdx.x;

  // pass 0: ranks of src in dst, prefix count of new keys
  if (tid == 0) sh.carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < ns; base += kThreads) {
    const int64_t s = base + tid;
    int32_t fresh = 0;
    if (s < ns) {
      const int64_t key = pack_key(sr[s], sc[s]);
      const int64_t r = search<false>(dr, dc, nd, key);
      fresh = !(r < nd && pack_key(dr[r], dc[r]) == key);
      rank[s] = static_cast<int32_t>(r);
    }
    int32_t excl, total;
    Scan(sh.scan).ExclusiveSum(fresh, excl, total);
    const int32_t carry = sh.carry;
    if (s < ns) uniq[s] = carry + excl;
    __syncthreads();  // all read carry; scan storage free again
    if (tid == 0) sh.carry = carry + total;
    __syncthreads();
  }
  const int32_t n_fresh = sh.carry;
  if (tid == 0) uniq[ns] = n_fresh;
  __syncthreads();

  // pass 1: dst entries move right, back to front
  if (nd > 0) {
    for (int64_t base = ((nd - 1) / kThreads) * kThreads; base >= 0;
         base -= kThreads) {
      const int64_t j = base + tid;
      int32_t r = 0, c = 0;
      float v = 0.0f;
      int64_t out = cap;
      if (j < nd) {
        r = dr[j];
        c = dc[j];
        v = dv[j];
        const int64_t key = pack_key(r, c);
        const int64_t ub = search<true>(sr, sc, ns, key);
        if (ub > 0 && pack_key(sr[ub - 1], sc[ub - 1]) == key) {
          v = fold_add(fold, v, sv[ub - 1]);
        }
        out = j + uniq[ub];
      }
      __syncthreads();  // the chunk is read before any of it is written
      if (out < cap) {
        dr[out] = r;
        dc[out] = c;
        dv[out] = v + 0.0f;
      }
    }
  }
  __syncthreads();

  // pass 2: new src keys fill the holes
  for (int64_t s = tid; s < ns; s += kThreads) {
    const int32_t u = uniq[s];
    if (uniq[s + 1] != u) {
      const int64_t out = static_cast<int64_t>(rank[s]) + u;
      if (out < cap) {
        dr[out] = sr[s];
        dc[out] = sc[s];
        dv[out] = sv[s] + 0.0f;
      }
    }
  }
  __syncthreads();
  return nd + n_fresh;
}

}  // namespace d4m
