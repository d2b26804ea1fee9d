// The merge of two sorted, unique-key COO lists with a semiring fold, by
// merge-path partitions over the whole card (hier_cascade's and merge_add's
// merge, below), its stable counterpart without a fold (sort_dedup's merge
// rounds, at the end), and the key, fold and value helpers every kernel of
// the port shares.
//
// Keys are (row, col) int32 pairs ordered lexicographically, compared as the
// int64 key (row << 32) + (col + 2^31).  Dead slots carry PAD keys and sit
// after the live prefix.  Every written value gets "+ 0.0" where the
// reference's associative-scan interleave adds it (-0.0 becomes +0.0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include <cub/block/block_scan.cuh>

#include "value_types.cuh"

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

// Value types the kernels take: float32, bfloat16, float16 and int32.  A
// float fold runs in float32 and rounds back to the value type after each
// operation, as a PyTorch elementwise op on the value type does.  An int32
// fold never goes through float: plus wraps (two's complement, as XLA's and
// PyTorch's int32 add), max and min compare as integers.
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

template <>
struct Value<__half> {
  static __device__ __forceinline__ float to_float(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from_float(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ __half from_bits(uint32_t b) {
    return __ushort_as_half(static_cast<unsigned short>(b));
  }
};

template <>
struct Value<int32_t> {
  static __device__ __forceinline__ int32_t from_bits(uint32_t b) {
    return static_cast<int32_t>(b);
  }
};

// sr.add(dst, src) on the value type
template <typename T>
__device__ __forceinline__ T fold_value(int fold, T dst, T src) {
  if constexpr (std::is_same_v<T, int32_t>) {
    switch (fold) {
      case kFoldPlus:
        return static_cast<int32_t>(static_cast<uint32_t>(dst) +
                                    static_cast<uint32_t>(src));
      case kFoldMax:
        return dst > src ? dst : src;
      case kFoldMin:
        return dst < src ? dst : src;
      default:  // kFoldFirst
        return dst;
    }
  } else {
    return Value<T>::from_float(
        fold_add(fold, Value<T>::to_float(dst), Value<T>::to_float(src)));
  }
}

// "+ 0.0": what the reference's scan interleave does to every float value
// it writes (-0.0 becomes +0.0, a NaN becomes the canonical NaN); integers
// take no "+ 0.0"
template <typename T>
__device__ __forceinline__ T plus_zero(T x) {
  if constexpr (std::is_same_v<T, int32_t>) {
    return x;
  } else {
    return Value<T>::from_float(Value<T>::to_float(x) + 0.0f);
  }
}

// Key fields of a packed key (the inverse of pack_key).
__device__ __forceinline__ int32_t key_row(int64_t k) {
  return static_cast<int32_t>(k >> 32);
}
__device__ __forceinline__ int32_t key_col(int64_t k) {
  return static_cast<int32_t>(static_cast<uint32_t>(k) ^ 0x80000000u);
}

// ---------------------------------------------------------------------------
// The merge-path merge of two sorted unique-key lists, dst (a, left) and
// src (b), folding equal keys as sr.add(dst, src) (hier_cascade and
// merge_add).
//
// Order.  The merged order puts a before b on equal keys.  The split of
// diagonal d is the pair (i, j) such that the first i + j entries of that
// order are a[0, i) and b[0, j): i + j = d, except where the split would
// cut an equal-key pair a[i-1] == b[j]; then the pair stays whole and
// j = d - i + 1.  Splits are monotone in d, every split is a prefix of the
// merged order, and no pair ever straddles one.
//
// Partitions.  Tile t of a group owns the entries between the splits of
// diagonals t * kMergeTile and (t + 1) * kMergeTile: kMergeTile - 1 to
// kMergeTile + 1 of them, which fold to at most kMergeTile survivors.  A
// warp finds each split with one 32-way search in global memory
// (warp_split).  The block copies its slices of a and b into shared memory
// with cp.async, all in flight at once, in 16-byte vectors
// (block_copy_async: each slice lands at its global address's offset
// within 16 bytes, so the middle of every slice is whole vectors on both
// sides; the head and tail go one element a thread), and each thread
// merges kMergeItems diagonals of them, split the same way inside the
// tile, so a thread's survivors also fit in kMergeItems registers.
//
// Output positions.  An entry lands at its position in the merged order
// less the pairs folded before it.  merge_count counts each tile's
// survivors, and the group's last block to finish (a device-wide counter,
// which that block sets back to zero) scans the counts into tile offsets
// and hands the untruncated survivor count to the caller; merge_write then
// merges again with values, places survivors by a block scan plus the
// tile's offset, stages them in shared memory at the output's offset
// within 16 bytes and writes them out in 16-byte vectors (block_store),
// truncated at cap.  Keys are read twice (count, then write); values once.
// A tile that holds entries of one list only (one side empty, or long runs
// of one side) folds nothing: its count is its size, taken without reading
// it.
//
// The caller's Problem (merge_add.cu, hier_cascade.cu) says, per group g:
//   bool input(g, MergeInput<T>&)  the two live lists, or false: the group
//                                   does nothing (a cut that did not fire);
//   void skip(g)                    merge_count, block 0, groups without
//                                   input;
//   void finish(g, n_keep)          merge_count, the group's last block;
//   MergeOutput<T> output(g)        where merge_write puts the survivors;
// and has members groups, tiles (tiles per group of scratch), fold,
// normalize ("+ 0.0" on every written value), splits ([groups, tiles + 1]
// int2), counts ([groups, tiles] int32), offsets ([groups, tiles] int64)
// and done ([groups] int32: zero before the first merge_count, and zero
// again after each).
// ---------------------------------------------------------------------------

constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 8;
constexpr int kMergeTile = kMergeThreads * kMergeItems;
// shared slots of one array of a tile: kMergeTile + 1 entries (a pair may
// be added) and up to 3 x 7 elements that align its two slices (or the
// survivors) with global memory
constexpr int kMergeSlots = kMergeTile + 24;
// resident blocks an SM the merge kernels are compiled for (registers
// capped at 65536 / (kMergeThreads * kMergeBlocksPerSM) a thread)
constexpr int kMergeBlocksPerSM = 3;

template <typename T>
struct MergeInput {
  const int32_t* ar;
  const int32_t* ac;
  const T* av;
  int64_t na;
  const int32_t* br;
  const int32_t* bc;
  const T* bv;
  int64_t nb;
};

template <typename T>
struct MergeOutput {
  int32_t* rows;
  int32_t* cols;
  T* vals;
  int64_t cap;
};

__host__ __device__ inline int64_t merge_tiles(int64_t n) {
  return n > 0 ? (n + kMergeTile - 1) / kMergeTile : 1;
}

// Grid of a merge launch: tile blocks x group blocks, about 8 blocks an SM
// in all (blocks stride over tiles and groups beyond it).
inline dim3 merge_grid(int64_t tiles, int64_t groups, int sm_count) {
  const int64_t gy = groups < 65535 ? groups : 65535;
  int64_t gx = 8LL * sm_count / gy;
  gx = gx < 1 ? 1 : (gx < tiles ? gx : tiles);
  return dim3(static_cast<unsigned int>(gx), static_cast<unsigned int>(gy));
}

// The split of diagonal d (0 <= d <= na + nb) of one group, by a 32-way
// search along the diagonal: each round probes 32 points at once, so a
// list of n entries costs about log32(n) rounds of one load each.  Whole
// warp calls; every lane returns the same split.
template <typename T>
__device__ int2 warp_split(const MergeInput<T>& in, int64_t d) {
  const int lane = threadIdx.x & 31;
  // i = lo + #{x in [lo, hi) : a[x] <= b[d - 1 - x]}; the predicate is
  // true, then false, along the diagonal
  int64_t lo = d > in.nb ? d - in.nb : 0;
  int64_t hi = d < in.na ? d : in.na;
  auto probe = [&](int64_t x) {
    return x < hi && pack_key(in.ar[x], in.ac[x]) <=
                         pack_key(in.br[d - 1 - x], in.bc[d - 1 - x]);
  };
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int c = __popc(__ballot_sync(0xffffffffu, probe(lo + lane * step)));
    if (c == 0) {
      hi = lo;
    } else {
      const int64_t top = lo + c * step;
      lo += (c - 1) * step + 1;
      hi = top < hi ? top : hi;
    }
  }
  const int64_t i =
      lo + __popc(__ballot_sync(0xffffffffu, probe(lo + lane)));
  int64_t j = d - i;
  if (i > 0 && j < in.nb &&
      pack_key(in.ar[i - 1], in.ac[i - 1]) == pack_key(in.br[j], in.bc[j])) {
    ++j;
  }
  return make_int2(static_cast<int>(i), static_cast<int>(j));
}

template <typename T>
struct MergeTileShared {
  // a's slice, then b's; later the survivors (16-byte aligned arrays)
  alignas(16) int32_t rows[kMergeSlots];
  alignas(16) int32_t cols[kMergeSlots];
  alignas(16) unsigned char val_bytes[kMergeSlots * sizeof(T)];
  int2 thread_split[kMergeThreads + 1];
  int2 tile_split[2];
  typename cub::BlockScan<int32_t, kMergeThreads>::TempStorage scan;

  // the values' slots (raw bytes above: no constructor runs in shared
  // memory)
  __device__ T* vals() { return reinterpret_cast<T*>(val_bytes); }
};

// The offset of p within its 16 bytes, in elements: where a slice that
// starts at p lands in a 16-byte aligned shared array.
template <typename E>
__device__ __forceinline__ int lead(const E* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(E));
}

// Where a second slice that starts at p lands, after a first that ends at
// shared slot `end`: the next 16-byte boundary plus p's own offset.
template <typename E>
__device__ __forceinline__ int lead_after(int end, const E* p) {
  constexpr int kVec = 16 / sizeof(E);
  return (end + kVec - 1) / kVec * kVec + lead(p);
}

// The first element of [0, len) from which dst and src are both 16-byte
// aligned (len where their offsets within 16 bytes differ: no vectors).
template <typename E>
__device__ __forceinline__ int vector_head(const E* dst, const E* src,
                                           int len) {
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  if (((sa ^ reinterpret_cast<uintptr_t>(dst)) & 15) != 0) return len;
  const int head = static_cast<int>(((16 - (sa & 15)) & 15) / sizeof(E));
  return head < len ? head : len;
}

// One element from global into shared memory: cp.async for 4 bytes, a
// plain copy for 2 (cp.async moves 4, 8 or 16).
template <typename E>
__device__ __forceinline__ void copy_one_async(E* dst, const E* src) {
  if constexpr (sizeof(E) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src));
  } else {
    *dst = *src;
  }
}

// Starts dst[0, len) = src[0, len), global into shared memory, by the whole
// block with cp.async: every copy is in flight before any is waited for
// (copy_wait).  The middle moves in 16-byte vectors where dst and src share
// their offset within 16 bytes (as lead() places them), the head and tail
// one element a thread.
template <typename E>
__device__ void block_copy_async(E* dst, const E* src, int len) {
  constexpr int kVec = 16 / sizeof(E);
  const int head = vector_head(dst, src, len);
  const int n_vec = (len - head) / kVec;
  for (int q = threadIdx.x; q < n_vec; q += kMergeThreads) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<unsigned>(
                         __cvta_generic_to_shared(dst + head + q * kVec))),
                 "l"(src + head + q * kVec));
  }
  for (int x = threadIdx.x; x < head; x += kMergeThreads) {
    copy_one_async(dst + x, src + x);
  }
  for (int x = head + n_vec * kVec + threadIdx.x; x < len;
       x += kMergeThreads) {
    copy_one_async(dst + x, src + x);
  }
}

// Waits for this thread's cp.async copies; the block syncs after it.
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// dst[0, len) = src[0, len), shared into global memory, by the whole
// block: 16-byte vectors where the two share their offset within 16 bytes
// (the survivors are staged at the output's lead()), single elements
// elsewhere.
template <typename E>
__device__ void block_store(E* dst, const E* src, int len) {
  constexpr int kVec = 16 / sizeof(E);
  const int head = vector_head(dst, src, len);
  const int n_vec = (len - head) / kVec;
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (int q = threadIdx.x; q < n_vec; q += kMergeThreads) d4[q] = s4[q];
  for (int x = threadIdx.x; x < head; x += kMergeThreads) dst[x] = src[x];
  for (int x = head + n_vec * kVec + threadIdx.x; x < len;
       x += kMergeThreads) {
    dst[x] = src[x];
  }
}

// A tile's two slices in shared memory: where each array's slice of a and
// of b starts, and their lengths.
struct TileView {
  int ra, ca, va;  // a's rows, cols, values
  int rb, cb, vb;  // b's
  int na, nb;
};

template <typename T>
__device__ __forceinline__ int64_t tile_key(const MergeTileShared<T>& sh,
                                            int r, int c, int i) {
  return pack_key(sh.rows[r + i], sh.cols[c + i]);
}

// Copies a[s0.x, s1.x) and b[s0.y, s1.y) into shared memory: keys, and
// values when kVals.  Every thread has waited for its copies on return;
// the caller syncs before reading them.
template <bool kVals, typename T>
__device__ TileView load_tile(const MergeInput<T>& in, int2 s0, int2 s1,
                              MergeTileShared<T>& sh) {
  TileView v;
  v.na = s1.x - s0.x;
  v.nb = s1.y - s0.y;
  const int32_t* gar = in.ar + s0.x;
  const int32_t* gac = in.ac + s0.x;
  const int32_t* gbr = in.br + s0.y;
  const int32_t* gbc = in.bc + s0.y;
  v.ra = lead(gar);
  v.ca = lead(gac);
  v.rb = lead_after(v.ra + v.na, gbr);
  v.cb = lead_after(v.ca + v.na, gbc);
  block_copy_async(sh.rows + v.ra, gar, v.na);
  block_copy_async(sh.cols + v.ca, gac, v.na);
  block_copy_async(sh.rows + v.rb, gbr, v.nb);
  block_copy_async(sh.cols + v.cb, gbc, v.nb);
  v.va = v.vb = 0;
  if (kVals) {
    const T* gav = in.av + s0.x;
    const T* gbv = in.bv + s0.y;
    v.va = lead(gav);
    v.vb = lead_after(v.va + v.na, gbv);
    block_copy_async(sh.vals() + v.va, gav, v.na);
    block_copy_async(sh.vals() + v.vb, gbv, v.nb);
  }
  copy_wait();
  return v;
}

// This thread's survivors of the tile in shared memory, in order: keys,
// and folded values when kVals.  Returns their number (at most
// kMergeItems).
template <bool kVals, typename T>
__device__ int thread_merge(const TileView& t, MergeTileShared<T>& sh,
                            int fold, int64_t (&okey)[kMergeItems],
                            T (&oval)[kMergeItems]) {
  const int tid = threadIdx.x;
  const int na = t.na, nb = t.nb;
  {
    // the split of local diagonal tid * kMergeItems, the pair rule as in
    // warp_split (a pair never straddles a tile edge, so the check stays
    // inside the tile)
    const int n = na + nb;
    const int d = min(tid * kMergeItems, n);
    int lo = max(0, d - nb), hi = min(d, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tile_key(sh, t.ra, t.ca, mid) <=
          tile_key(sh, t.rb, t.cb, d - 1 - mid)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int j = d - lo;
    if (lo > 0 && j < nb &&
        tile_key(sh, t.ra, t.ca, lo - 1) == tile_key(sh, t.rb, t.cb, j)) {
      ++j;
    }
    sh.thread_split[tid] = make_int2(lo, j);
    if (tid == 0) sh.thread_split[kMergeThreads] = make_int2(na, nb);
  }
  __syncthreads();
  int ai = sh.thread_split[tid].x, bi = sh.thread_split[tid].y;
  const int ae = sh.thread_split[tid + 1].x, be = sh.thread_split[tid + 1].y;
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < kMergeItems; ++q) {
    const bool has_a = ai < ae, has_b = bi < be;
    if (has_a || has_b) {
      const int64_t ka = has_a ? tile_key(sh, t.ra, t.ca, ai) : 0;
      const int64_t kb = has_b ? tile_key(sh, t.rb, t.cb, bi) : 0;
      const bool take_a = has_a && (!has_b || ka <= kb);
      const bool pair = take_a && has_b && ka == kb;
      okey[q] = take_a ? ka : kb;
      if (kVals) {
        const T* vals = sh.vals();
        T v = take_a ? vals[t.va + ai] : vals[t.vb + bi];
        if (pair) v = fold_value(fold, v, vals[t.vb + bi]);
        oval[q] = v;
      }
      ai += take_a;
      bi += !take_a || pair;
      ++cnt;
    }
  }
  return cnt;
}

// Exclusive scan of counts[0, n) into off[0, n) by one block, reading what
// other blocks wrote (L2, not the incoherent L1); returns the total.
template <typename T>
__device__ int64_t scan_counts(const int32_t* counts, int64_t* off, int64_t n,
                               MergeTileShared<T>& sh) {
  using Scan = cub::BlockScan<int32_t, kMergeThreads>;
  constexpr int kPer = kMergeItems;
  int64_t carry = 0;
  for (int64_t base = 0; base < n; base += kMergeTile) {
    int32_t v[kPer], ex[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int64_t x = base + threadIdx.x * kPer + q;
      v[q] = x < n ? __ldcg(counts + x) : 0;
    }
    int32_t total;
    Scan(sh.scan).ExclusiveSum(v, ex, total);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int64_t x = base + threadIdx.x * kPer + q;
      if (x < n) off[x] = carry + ex[q];
    }
    carry += total;
    __syncthreads();  // scan storage free again
  }
  return carry;
}

// Pass 1: every tile's split and survivor count; the group's last block
// scans the counts, calls finish(g, n_keep) and sets the group's counter
// back to zero for the next launch.  Grid (tile blocks, group blocks);
// blocks stride over both.
template <typename T, typename Problem>
__global__ void __launch_bounds__(kMergeThreads, kMergeBlocksPerSM)
    merge_count(const Problem p) {
  using Scan = cub::BlockScan<int32_t, kMergeThreads>;
  __shared__ MergeTileShared<T> sh;
  __shared__ bool last;
  const int tid = threadIdx.x;
  int64_t okey[kMergeItems];
  T oval[kMergeItems];
  for (int64_t g = blockIdx.y; g < p.groups; g += gridDim.y) {
    MergeInput<T> in;
    if (!p.input(g, in)) {
      if (blockIdx.x == 0 && tid == 0) p.skip(g);
      continue;
    }
    const int64_t n = in.na + in.nb;
    const int64_t n_tiles = merge_tiles(n);
    int2* splits = p.splits + g * (p.tiles + 1);
    int32_t mine = 0;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int warp = tid >> 5;
      if (warp < 2) {
        const int64_t d = (t + warp) * kMergeTile;
        const int2 s = warp_split(in, d < n ? d : n);
        if ((tid & 31) == 0) sh.tile_split[warp] = s;
      }
      __syncthreads();
      const int2 s0 = sh.tile_split[0], s1 = sh.tile_split[1];
      const int na = s1.x - s0.x, nb = s1.y - s0.y;
      int32_t total = na + nb;  // a tile of one list alone folds nothing
      if (na > 0 && nb > 0) {
        const TileView view = load_tile<false>(in, s0, s1, sh);
        __syncthreads();
        const int cnt = thread_merge<false>(view, sh, p.fold, okey, oval);
        int32_t before;
        Scan(sh.scan).ExclusiveSum(cnt, before, total);
      }
      if (tid == 0) {
        p.counts[g * p.tiles + t] = total;
        splits[t] = s0;
        if (t + 1 == n_tiles) splits[t + 1] = s1;
      }
      ++mine;
      __syncthreads();  // shared memory free for the next tile
    }
    if (mine == 0) continue;
    __threadfence();  // this block's counts and splits, before the count
    __syncthreads();
    if (tid == 0) last = atomicAdd(p.done + g, mine) + mine == n_tiles;
    __syncthreads();
    if (last) {
      __threadfence();
      const int64_t n_keep =
          scan_counts(p.counts + g * p.tiles, p.offsets + g * p.tiles,
                      n_tiles, sh);
      if (tid == 0) {
        p.finish(g, n_keep);
        p.done[g] = 0;  // every block of the group has counted
      }
    }
  }
}

// Pass 2: merge each tile with values and write its survivors, from the
// splits and offsets of pass 1.  The same grid as merge_count.
template <typename T, typename Problem>
__global__ void __launch_bounds__(kMergeThreads, kMergeBlocksPerSM)
    merge_write(const Problem p) {
  using Scan = cub::BlockScan<int32_t, kMergeThreads>;
  __shared__ MergeTileShared<T> sh;
  const int tid = threadIdx.x;
  int64_t okey[kMergeItems];
  T oval[kMergeItems];
  for (int64_t g = blockIdx.y; g < p.groups; g += gridDim.y) {
    MergeInput<T> in;
    if (!p.input(g, in)) continue;
    const MergeOutput<T> out = p.output(g);
    const int64_t n_tiles = merge_tiles(in.na + in.nb);
    const int2* splits = p.splits + g * (p.tiles + 1);
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int64_t base = p.offsets[g * p.tiles + t];
      if (base >= out.cap) continue;  // truncated away
      const TileView view = load_tile<true>(in, splits[t], splits[t + 1], sh);
      __syncthreads();
      const int cnt = thread_merge<true>(view, sh, p.fold, okey, oval);
      int32_t at, total;
      Scan(sh.scan).ExclusiveSum(cnt, at, total);
      __syncthreads();  // every thread has read its inputs
      // survivors staged at the output's offset within 16 bytes
      int32_t* orow = out.rows + base;
      int32_t* ocol = out.cols + base;
      T* oval_g = out.vals + base;
      const int ro = lead(orow), co = lead(ocol), vo = lead(oval_g);
#pragma unroll
      for (int q = 0; q < kMergeItems; ++q) {
        if (q < cnt) {
          sh.rows[ro + at + q] = key_row(okey[q]);
          sh.cols[co + at + q] = key_col(okey[q]);
          sh.vals()[vo + at + q] = p.normalize ? plus_zero(oval[q]) : oval[q];
        }
      }
      __syncthreads();
      const int64_t room = out.cap - base;
      const int n_out = total < room ? total : static_cast<int>(room);
      block_store(orow, sh.rows + ro, n_out);
      block_store(ocol, sh.cols + co, n_out);
      block_store(oval_g, sh.vals() + vo, n_out);
      __syncthreads();  // shared memory free for the next tile
    }
  }
}

// ---------------------------------------------------------------------------
// The stable merge-path merge of two sorted runs of 64-bit keys, each key
// carrying a 4-byte payload, without folding (sort_dedup's merge rounds).
//
// Order.  Equal keys take the left run (a) first, so merging two stably
// sorted runs sorts both stably.  The split of diagonal d is the pair
// (i, d - i) such that the first d entries of that order are a[0, i) and
// b[0, d - i): nothing folds, so there is no pair rule, and a tile of
// diagonals [d0, d0 + kMergeTile) holds exactly that many entries.
//
// A warp finds a tile's splits (stable_warp_split, warp_split's 32-way
// search); stable_merge_tile copies the two slices into shared memory with
// cp.async in 16-byte vectors, each thread merges kMergeItems diagonals
// (split by a binary search in shared memory), and the block stores the
// merged keys and payloads in 16-byte vectors, staged at the output's
// offset within 16 bytes.
// ---------------------------------------------------------------------------

struct StableMergeShared {
  alignas(16) uint64_t keys[kMergeSlots];
  alignas(16) uint32_t pay[kMergeSlots];
  int2 thread_split[kMergeThreads + 1];
  int2 tile_split[2];
};

// The split of diagonal d (0 <= d <= na + nb) of the left-first order of
// a[0, na) and b[0, nb).  Whole warp calls; every lane returns it.
__device__ inline int2 stable_warp_split(const uint64_t* a, int na,
                                         const uint64_t* b, int nb, int d) {
  const int lane = threadIdx.x & 31;
  // i = lo + #{x in [lo, hi) : a[x] <= b[d - 1 - x]}, true then false
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  auto probe = [&](int x) { return x < hi && a[x] <= b[d - 1 - x]; };
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int c = __popc(__ballot_sync(0xffffffffu, probe(lo + lane * step)));
    if (c == 0) {
      hi = lo;
    } else {
      const int top = lo + c * step;
      lo += (c - 1) * step + 1;
      hi = top < hi ? top : hi;
    }
  }
  const int i = lo + __popc(__ballot_sync(0xffffffffu, probe(lo + lane)));
  return make_int2(i, d - i);
}

// out[0, na + nb) = the left-first merge of the tile's slices a[0, na) and
// b[0, nb), keys and payloads, all in global memory (na + nb <=
// kMergeTile).  Whole block calls.
__device__ inline void stable_merge_tile(const uint64_t* ak, const uint32_t* ai,
                                         int na, const uint64_t* bk,
                                         const uint32_t* bi, int nb,
                                         uint64_t* ok, uint32_t* oi,
                                         StableMergeShared& sh) {
  const int tid = threadIdx.x;
  const int n = na + nb;
  const int ka = lead(ak), kb = lead_after(ka + na, bk);
  const int ia = lead(ai), ib = lead_after(ia + na, bi);
  block_copy_async(sh.keys + ka, ak, na);
  block_copy_async(sh.keys + kb, bk, nb);
  block_copy_async(sh.pay + ia, ai, na);
  block_copy_async(sh.pay + ib, bi, nb);
  copy_wait();
  __syncthreads();
  {
    const int d = min(tid * kMergeItems, n);
    int lo = max(0, d - nb), hi = min(d, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sh.keys[ka + mid] <= sh.keys[kb + d - 1 - mid]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    sh.thread_split[tid] = make_int2(lo, d - lo);
    if (tid == 0) sh.thread_split[kMergeThreads] = make_int2(na, nb);
  }
  __syncthreads();
  int x = sh.thread_split[tid].x, y = sh.thread_split[tid].y;
  const int ex = sh.thread_split[tid + 1].x, ey = sh.thread_split[tid + 1].y;
  uint64_t okey[kMergeItems];
  uint32_t opay[kMergeItems];
#pragma unroll
  for (int q = 0; q < kMergeItems; ++q) {
    const bool has_a = x < ex, has_b = y < ey;
    const uint64_t va = has_a ? sh.keys[ka + x] : 0;
    const uint64_t vb = has_b ? sh.keys[kb + y] : 0;
    const bool take_a = has_a && (!has_b || va <= vb);
    okey[q] = take_a ? va : vb;
    opay[q] = take_a ? sh.pay[ia + x] : (has_b ? sh.pay[ib + y] : 0);
    x += take_a;
    y += !take_a && has_b;
  }
  __syncthreads();  // every thread has read its inputs
  const int ko = lead(ok), io = lead(oi);
  const int mine = min(kMergeItems, max(0, n - tid * kMergeItems));
#pragma unroll
  for (int q = 0; q < kMergeItems; ++q) {
    if (q < mine) {
      sh.keys[ko + tid * kMergeItems + q] = okey[q];
      sh.pay[io + tid * kMergeItems + q] = opay[q];
    }
  }
  __syncthreads();
  block_store(ok, sh.keys + ko, n);
  block_store(oi, sh.pay + io, n);
}

}  // namespace d4m
