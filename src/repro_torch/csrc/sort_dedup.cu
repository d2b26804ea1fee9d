// sort_dedup: from_triples and its fold stage (combine_sorted) for G
// groups (leading batch axes) of n triples each.
//
// Replaces the TPU kernel repro/kernels/sort_dedup/kernel.py:50
// (sort_dedup_pallas: a bitonic sort network plus a Hillis-Steele run
// fold in VMEM, compacted by its wrapper ops.py:18) and computes what its
// oracle, repro.core.assoc.from_triples, computes, bit for bit, values
// included (the TPU kernel folds in another order and differs in the last
// bits):
//   * the order of jnp.lexsort((cols, rows)): a stable sort on the key
//     (row << 32) + (col + 2^31), so equal keys keep their input order;
//   * each run of equal adjacent keys folds with sr.add in the bracketing
//     of lax.associative_scan (run_value below), and every value gets
//     "+ 0.0" when n >= 2.  Equal live keys must be adjacent: sorted input,
//     or sorted unique keys with PAD holes (elem_mul, extract_row), as every
//     caller gives.  A key that recurs after a hole is folded by the
//     reference's scan in a bracketing-dependent way this kernel does not
//     replay;
//   * PAD keys drop; survivors are compacted to cap, nnz = min(count, cap),
//     overflow = count > cap.
//
// The sort (from_triples only), in 1 + ceil(log2(n / 4096)) launches:
//   1. tile_sort: each tile of 4096 entries sorts its (key, input index)
//      pairs in shared memory with cub::BlockRadixSort (stable), reading
//      rows/cols/valid directly;
//   2. merge_round: runs of width w merge pairwise into runs of 2w; each
//      entry finds its place by one binary search in the partner run
//      (lower bound from the left run, upper bound from the right run, so
//      equal keys keep their order).
// The fold, in four launches over sorted keys:
//   3. mark_ends: tiles count the run ends that are not PAD;
//   4. scan_tile_counts: one block scans those counts, finishes nnz/overflow;
//   5. fold_write: a block scan per tile places each run end; its thread
//      folds the run's values in the scan's bracketing and writes the entry;
//   6. fill_tail: PAD keys and the zero value in [nnz, cap).
//
// What bounds it: bytes.  The least it must move is each input triple read
// once and each live output entry written once (12 B each in float32); it
// does one comparison per element per sort level.  The merge sort moves
// more: the tile sort and each merge round read and write 12 B an entry
// (an 8 B key and a 4 B index), plus a binary search per entry per round
// (latency-bound).  A run of length L costs its thread O(L + log n),
// serially: long runs (a vertex's degree) are the slow case.
#include <cuda_runtime.h>

#include <cstdint>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "merge.cuh"
#include "tiles.cuh"

namespace {

using d4m::kTile;
using d4m::kTileItems;
using d4m::kTileThreads;

constexpr uint64_t kSign = 0x8000000000000000ull;

// The packed key as an unsigned integer that orders the same way.
__device__ __forceinline__ uint64_t sort_key(int32_t r, int32_t c) {
  return static_cast<uint64_t>(d4m::pack_key(r, c)) ^ kSign;
}

__device__ __forceinline__ int32_t key_row(uint64_t u) {
  return static_cast<int32_t>(static_cast<int64_t>(u ^ kSign) >> 32);
}

__device__ __forceinline__ int32_t key_col(uint64_t u) {
  return static_cast<int32_t>(
      static_cast<int64_t>((u ^ kSign) & 0xffffffffull) - 2147483648LL);
}

// ---------------------------------------------------------------- the sort

__global__ void __launch_bounds__(kTileThreads)
    tile_sort(const int32_t* rows, const int32_t* cols, const uint8_t* valid,
              int64_t n, int64_t tpg, uint64_t* keys, int32_t* idx) {
  using Sort = cub::BlockRadixSort<uint64_t, kTileThreads, kTileItems, int32_t>;
  __shared__ typename Sort::TempStorage tmp;
  const int64_t tile = blockIdx.x;
  const int64_t g = tile / tpg;
  const int64_t j0 = (tile - g * tpg) * kTile + threadIdx.x * kTileItems;
  uint64_t k[kTileItems];
  int32_t v[kTileItems];
  for (int i = 0; i < kTileItems; ++i) {
    const int64_t j = j0 + i;
    v[i] = static_cast<int32_t>(j);
    if (j < n) {
      const int64_t q = g * n + j;
      const bool live = valid == nullptr || valid[q];
      k[i] = live ? sort_key(rows[q], cols[q]) : sort_key(d4m::kPad, d4m::kPad);
    } else {
      // past the group's end: the largest key and the largest indices, so
      // (the sort being stable) these sort after everything real
      k[i] = ~0ull;
    }
  }
  Sort(tmp).Sort(k, v);  // blocked arrangement again, now sorted
  for (int i = 0; i < kTileItems; ++i) {
    const int64_t j = j0 + i;
    if (j < n) {
      keys[g * n + j] = k[i];
      idx[g * n + j] = v[i];
    }
  }
}

// Entries of [0, len) of a sorted run with key < q (kUpper: <= q).
template <bool kUpper>
__device__ __forceinline__ int64_t count_below(const uint64_t* run,
                                               int64_t len, uint64_t q) {
  int64_t lo = 0, hi = len;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const uint64_t k = run[mid];
    if (kUpper ? (k <= q) : (k < q)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void merge_round(const uint64_t* kin, const int32_t* iin,
                            uint64_t* kout, int32_t* iout, int64_t groups,
                            int64_t n, int64_t w) {
  const int64_t total = groups * n;
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       p < total; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t g = p / n;
    const int64_t j = p - g * n;
    const uint64_t* gk = kin + g * n;
    const uint64_t key = kin[p];
    const int64_t r = j / w;
    int64_t dst;
    if ((r & 1) == 0) {  // left run: partner is the next run, if any
      const int64_t lo = (r + 1) * w;
      if (lo >= n) {
        dst = j;
      } else {
        const int64_t hi = lo + w < n ? lo + w : n;
        dst = j + count_below<false>(gk + lo, hi - lo, key);
      }
    } else {  // right run: partner is the previous (full) run
      dst = j - w + count_below<true>(gk + (r - 1) * w, w, key);
    }
    kout[g * n + dst] = key;
    iout[g * n + dst] = iin[p];
  }
}

__global__ void pack_keys(const int32_t* rows, const int32_t* cols,
                          int64_t total, uint64_t* keys) {
  for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       p < total; p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    keys[p] = sort_key(rows[p], cols[p]);
  }
}

// ---------------------------------------------------------------- the fold

template <typename T>
struct FoldArgs {
  const uint64_t* keys;  // [G, n], runs of equal keys adjacent
  const int32_t* idx;    // [G, n] input index of each sorted entry, or null
  const T* vals;         // [G, n] input values
  int64_t n;
  int32_t* orow;
  int32_t* ocol;
  T* oval;
  int32_t* o_nnz;
  uint8_t* o_ov;
  int64_t cap;
  int32_t* counts;
  int32_t* off;
  int64_t tpg;
  int fold;
  bool normalize;  // n >= 2
};

__device__ __forceinline__ bool is_end(const uint64_t* gk, int64_t n,
                                       int64_t j) {
  const uint64_t k = gk[j];
  return (j + 1 == n || gk[j + 1] != k) && key_row(k) != d4m::kPad;
}

// Value at sorted position j of group g.
template <typename T>
__device__ __forceinline__ T value_at(const FoldArgs<T>& p, int64_t g,
                                      int64_t j) {
  const int64_t q = g * p.n + j;
  return p.idx == nullptr ? p.vals[q] : p.vals[g * p.n + p.idx[q]];
}

// node(L, i): the pair-tree fold of x over [i 2^L, (i+1) 2^L - 1], cut to
// the part at or after s; a node whose left child ends before s is its
// right child alone.  A binary counter over the elements, with a stack of
// at most 32 pending left siblings, in place of the recursion.
template <typename T>
__device__ T node_fold(const FoldArgs<T>& p, int64_t g, int L, int64_t i,
                       int64_t s) {
  T stack[32];
  int sp = 0;
  const int64_t lo = i << L;
  const int64_t hi = ((i + 1) << L) - 1;
  for (int64_t j = lo > s ? lo : s;; ++j) {
    T cur = value_at(p, g, j);
    int h = 0;
    int64_t at = j;
    while (h < L && (at & 1)) {
      // the left sibling (h, at - 1) ends at (at << h) - 1
      if ((at << h) - 1 >= s) cur = d4m::fold_value(p.fold, stack[--sp], cur);
      at >>= 1;
      ++h;
    }
    if (h == L) return cur;  // only at j == hi, whose index is odd at every level
    stack[sp++] = cur;
  }
}

// The value lax.associative_scan leaves at the run end e of the run [s, e]
// (before its final "+ 0.0"), with P(L, i) its inclusive scan at level L:
//   P(L, 0) = node(L, 0);  P(L, i odd) = P(L+1, (i-1)/2);
//   P(L, i even) = add(P(L+1, i/2 - 1), node(L, i)) if i 2^L > s,
//                  else node(L, i).
// Walking up from P(0, e) collects the right-hand nodes; the fold then runs
// from the top node down through them.
template <typename T>
__device__ T run_value(const FoldArgs<T>& p, int64_t g, int64_t s,
                       int64_t e) {
  int levels[32];
  int64_t index[32];
  int count = 0;
  int L = 0;
  int64_t i = e;
  while (i != 0) {
    if (i & 1) {
      i = (i - 1) >> 1;
    } else if ((i << L) > s) {
      levels[count] = L;
      index[count] = i;
      ++count;
      i = (i >> 1) - 1;
    } else {
      break;
    }
    ++L;
  }
  T acc = node_fold(p, g, L, i, s);
  while (count > 0) {
    --count;
    acc = d4m::fold_value(p.fold, acc,
                          node_fold(p, g, levels[count], index[count], s));
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads) mark_ends(const FoldArgs<T> p) {
  using Reduce = cub::BlockReduce<int32_t, kTileThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const int64_t tile = blockIdx.x;
  const int64_t g = tile / p.tpg;
  const int64_t j0 = (tile - g * p.tpg) * kTile + threadIdx.x * kTileItems;
  const uint64_t* gk = p.keys + g * p.n;
  int32_t ends = 0;
  for (int k = 0; k < kTileItems; ++k) {
    const int64_t j = j0 + k;
    if (j < p.n) ends += is_end(gk, p.n, j);
  }
  const int32_t total = Reduce(tmp).Sum(ends);
  if (threadIdx.x == 0) p.counts[tile] = total;
}

template <typename T>
struct FinishFold {
  FoldArgs<T> p;
  __device__ void operator()(int64_t g, int32_t count) const {
    p.o_nnz[g] = static_cast<int32_t>(count < p.cap ? count : p.cap);
    p.o_ov[g] = count > p.cap;
  }
};

template <typename T>
__global__ void __launch_bounds__(kTileThreads) fold_write(const FoldArgs<T> p) {
  using Scan = cub::BlockScan<int32_t, kTileThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int64_t tile = blockIdx.x;
  const int64_t g = tile / p.tpg;
  const int64_t j0 = (tile - g * p.tpg) * kTile + threadIdx.x * kTileItems;
  const uint64_t* gk = p.keys + g * p.n;
  int32_t end[kTileItems];
  int32_t before[kTileItems];
  for (int k = 0; k < kTileItems; ++k) {
    const int64_t j = j0 + k;
    end[k] = j < p.n && is_end(gk, p.n, j);
  }
  Scan(tmp).ExclusiveSum(end, before);
  const int64_t base = p.off[tile] - p.off[g * p.tpg];
  for (int k = 0; k < kTileItems; ++k) {
    const int64_t pos = base + before[k];
    if (!end[k] || pos >= p.cap) continue;
    const int64_t e = j0 + k;
    const uint64_t key = gk[e];
    int64_t s = e;
    while (s > 0 && gk[s - 1] == key) --s;
    T v = run_value(p, g, s, e);
    const int64_t o = g * p.cap + pos;
    p.orow[o] = key_row(key);
    p.ocol[o] = key_col(key);
    p.oval[o] = p.normalize ? d4m::plus_zero(v) : v;
  }
}

template <typename T>
cudaError_t fold_runs(const FoldArgs<T>& p, int64_t groups, uint32_t zero_bits,
                 cudaStream_t stream) {
  cudaError_t err;
  const int64_t n_tiles = groups * p.tpg;
  if (n_tiles > 0) {
    mark_ends<T><<<static_cast<unsigned int>(n_tiles), kTileThreads, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  d4m::scan_tile_counts<FinishFold<T>><<<1, d4m::kScanThreads, 0, stream>>>(
      p.counts, p.off, n_tiles, groups, p.tpg, FinishFold<T>{p});
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (n_tiles > 0) {
    fold_write<T><<<static_cast<unsigned int>(n_tiles), kTileThreads, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return d4m::launch_fill_tail<T>(p.orow, p.ocol, p.oval, p.o_nnz, groups,
                                  p.cap, zero_bits, stream);
}

// Sorts into (keys0, idx0), ping-ponging with (keys1, idx1); returns which
// pair holds the result.
cudaError_t sort(const int32_t* rows, const int32_t* cols,
                 const uint8_t* valid, int64_t groups, int64_t n,
                 uint64_t* keys[2], int32_t* idx[2], int* which,
                 cudaStream_t stream) {
  cudaError_t err;
  const int64_t tpg = d4m::ceil_div(n, kTile);
  *which = 0;
  if (groups * tpg == 0) return cudaSuccess;
  tile_sort<<<static_cast<unsigned int>(groups * tpg), kTileThreads, 0, stream>>>(
      rows, cols, valid, n, tpg, keys[0], idx[0]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int64_t w = kTile; w < n; w *= 2) {
    merge_round<<<d4m::flat_blocks(groups * n), d4m::kFlatThreads, 0, stream>>>(
        keys[*which], idx[*which], keys[1 - *which], idx[1 - *which], groups,
        n, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    *which = 1 - *which;
  }
  return cudaSuccess;
}

template <typename T>
FoldArgs<T> fold_args(int64_t n, const void* vals, void* orow, void* ocol,
                      void* oval, void* o_nnz, void* o_ov, int64_t cap,
                      void* counts, void* off, int fold) {
  FoldArgs<T> p{};
  p.vals = static_cast<const T*>(vals);
  p.n = n;
  p.orow = static_cast<int32_t*>(orow);
  p.ocol = static_cast<int32_t*>(ocol);
  p.oval = static_cast<T*>(oval);
  p.o_nnz = static_cast<int32_t*>(o_nnz);
  p.o_ov = static_cast<uint8_t*>(o_ov);
  p.cap = cap;
  p.counts = static_cast<int32_t*>(counts);
  p.off = static_cast<int32_t*>(off);
  p.tpg = d4m::ceil_div(n, kTile);
  p.fold = fold;
  p.normalize = n >= 2;
  return p;
}

template <typename T>
int from_triples_typed(int64_t groups, int64_t n, const void* rows,
                       const void* cols, const void* vals, const void* valid,
                       void* orow, void* ocol, void* oval, void* o_nnz,
                       void* o_ov, int64_t cap, void* keys0, void* keys1,
                       void* idx0, void* idx1, void* counts, void* off,
                       int fold, uint32_t zero_bits, cudaStream_t stream) {
  uint64_t* keys[2] = {static_cast<uint64_t*>(keys0),
                       static_cast<uint64_t*>(keys1)};
  int32_t* idx[2] = {static_cast<int32_t*>(idx0), static_cast<int32_t*>(idx1)};
  int which = 0;
  cudaError_t err =
      sort(static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
           static_cast<const uint8_t*>(valid), groups, n, keys, idx, &which,
           stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  FoldArgs<T> p = fold_args<T>(n, vals, orow, ocol, oval, o_nnz, o_ov, cap,
                               counts, off, fold);
  p.keys = keys[which];
  p.idx = idx[which];
  return static_cast<int>(fold_runs<T>(p, groups, zero_bits, stream));
}

template <typename T>
int combine_typed(int64_t groups, int64_t n, const void* rows,
                  const void* cols, const void* vals, void* orow, void* ocol,
                  void* oval, void* o_nnz, void* o_ov, int64_t cap, void* keys,
                  void* counts, void* off, int fold, uint32_t zero_bits,
                  cudaStream_t stream) {
  if (groups * n > 0) {
    pack_keys<<<d4m::flat_blocks(groups * n), d4m::kFlatThreads, 0, stream>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        groups * n, static_cast<uint64_t*>(keys));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  FoldArgs<T> p = fold_args<T>(n, vals, orow, ocol, oval, o_nnz, o_ov, cap,
                               counts, off, fold);
  p.keys = static_cast<const uint64_t*>(keys);
  p.idx = nullptr;
  return static_cast<int>(fold_runs<T>(p, groups, zero_bits, stream));
}

bool bad_args(int64_t groups, int64_t n, int64_t cap) {
  return groups < 1 || n < 0 || cap < 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  valid: [G, n] bool or null.  Scratch:
// keys0/keys1 [G, n] uint64, idx0/idx1 [G, n] int32, counts
// [G * ceil(n / 4096)] int32, off [that + 1] int32.
extern "C" int sort_dedup_from_triples(
    int dtype, int64_t groups, int64_t n, const void* rows, const void* cols,
    const void* vals, const void* valid, void* orow, void* ocol, void* oval,
    void* o_nnz, void* o_ov, int64_t cap, void* keys0, void* keys1,
    void* idx0, void* idx1, void* counts, void* off, int fold,
    uint32_t zero_bits, void* stream) {
  if (bad_args(groups, n, cap)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return from_triples_typed<float>(groups, n, rows, cols, vals, valid, orow,
                                     ocol, oval, o_nnz, o_ov, cap, keys0,
                                     keys1, idx0, idx1, counts, off, fold,
                                     zero_bits, s);
  }
  if (dtype == 1) {
    return from_triples_typed<__nv_bfloat16>(
        groups, n, rows, cols, vals, valid, orow, ocol, oval, o_nnz, o_ov, cap,
        keys0, keys1, idx0, idx1, counts, off, fold, zero_bits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fold stage alone, on triples whose equal keys are already adjacent.
// Scratch: keys [G, n] uint64, counts and off as above.
extern "C" int sort_dedup_combine(int dtype, int64_t groups, int64_t n,
                                  const void* rows, const void* cols,
                                  const void* vals, void* orow, void* ocol,
                                  void* oval, void* o_nnz, void* o_ov,
                                  int64_t cap, void* keys, void* counts,
                                  void* off, int fold, uint32_t zero_bits,
                                  void* stream) {
  if (bad_args(groups, n, cap)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return combine_typed<float>(groups, n, rows, cols, vals, orow, ocol, oval,
                                o_nnz, o_ov, cap, keys, counts, off, fold,
                                zero_bits, s);
  }
  if (dtype == 1) {
    return combine_typed<__nv_bfloat16>(groups, n, rows, cols, vals, orow,
                                        ocol, oval, o_nnz, o_ov, cap, keys,
                                        counts, off, fold, zero_bits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sort_dedup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
