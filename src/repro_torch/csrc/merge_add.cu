// merge_add: C = A (+) B for G groups (leading batch axes) of two sorted,
// unique-key COO lists, out of place, over the whole card.
//
// Replaces the TPU kernel repro/kernels/merge_add/kernel.py:75
// (merge_add_pallas, a bitonic merge network in VMEM plus a Hillis-Steele
// fold, compacted by its wrapper ops.py:33) and computes what its oracle,
// repro.core.assoc.add, computes, bit for bit:
//   * keys of both inputs, in order, each once; equal keys fold as
//     sr.add(a, b), a on the left (merge.cuh fold_value);
//   * every written value "+ 0.0" when m + n >= 2 (the oracle's scan
//     interleave turns -0.0 into +0.0); max/min carry NaN;
//   * the result truncated to cap; nnz = min(n_keep, cap) and
//     overflow = n_keep > cap | a.overflow | b.overflow.
//
// What bounds it: bytes.  The least it must move is each live input entry
// read once and each output entry written once (12 B an entry in float32,
// 10 B in bfloat16); it does a handful of comparisons per entry.  The
// design reads only the live prefixes (inputs hold the Assoc invariant, so
// the work is bounded by nnz, not by the capacities) and spreads one merge
// over the whole card, since one merge is up to 19 M entries (the
// full-width snapshot).  Five launches:
//   1. mark_b: each b entry j < nnz_b finds lb_a(j) = lower_bound(a, key_j)
//      by binary search and whether key_j is in a; tiles count the matches;
//   2. scan_tile_counts: one block scans the tile counts and finishes each
//      group's nnz and overflow;
//   3. place_b: a block scan per tile gives dup_before(j), the matched b
//      entries before j; an unmatched b entry goes to j - dup_before(j) +
//      lb_a(j);
//   4. place_a: each a entry i < nnz_a finds lb_b(i) and goes to
//      i + lb_b(i) - dup_before(lb_b(i)), folding the equal b entry;
//   5. fill_tail: PAD keys and the zero value in [nnz, cap).
// The binary searches are latency-bound (one dependent load a level), not
// byte-bound: the price of a simple first design, measured in PERF.md.
#include <cuda_runtime.h>

#include <cstdint>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "merge.cuh"
#include "tiles.cuh"

namespace {

using d4m::kTile;
using d4m::kTileItems;
using d4m::kTileThreads;

template <typename T>
struct MergeArgs {
  const int32_t* ar;
  const int32_t* ac;
  const T* av;
  const int32_t* a_nnz;
  const uint8_t* a_ov;
  int64_t m;  // a's width
  const int32_t* br;
  const int32_t* bc;
  const T* bv;
  const int32_t* b_nnz;
  const uint8_t* b_ov;
  int64_t n;  // b's width
  int32_t* orow;
  int32_t* ocol;
  T* oval;
  int32_t* o_nnz;
  uint8_t* o_ov;
  int64_t cap;
  int32_t* code;    // [G, n]: lb_a(j), or ~lb_a(j) where key_j is in a
  int32_t* dupb;    // [G, n]: dup_before(j)
  int32_t* counts;  // [G * tpg]
  int32_t* off;     // [G * tpg + 1]
  int32_t* dups;    // [G]: matched b entries of the group
  int64_t tpg;      // tiles per group over b
  int fold;
  bool normalize;   // m + n >= 2
};

template <typename T>
__device__ __forceinline__ void put(const MergeArgs<T>& p, int64_t g,
                                    int64_t pos, int32_t r, int32_t c, T v) {
  if (pos < p.cap) {
    const int64_t o = g * p.cap + pos;
    p.orow[o] = r;
    p.ocol[o] = c;
    p.oval[o] = p.normalize ? d4m::plus_zero(v) : v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads) mark_b(const MergeArgs<T> p) {
  using Reduce = cub::BlockReduce<int32_t, kTileThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const int64_t tile = blockIdx.x;
  const int64_t g = tile / p.tpg;
  const int64_t j0 = (tile - g * p.tpg) * kTile + threadIdx.x * kTileItems;
  const int64_t na = p.a_nnz[g];
  const int64_t nb = p.b_nnz[g];
  const int32_t* ar = p.ar + g * p.m;
  const int32_t* ac = p.ac + g * p.m;
  int32_t hits = 0;
  for (int k = 0; k < kTileItems; ++k) {
    const int64_t j = j0 + k;
    if (j < nb) {
      const int64_t key = d4m::pack_key(p.br[g * p.n + j], p.bc[g * p.n + j]);
      const int64_t lb = d4m::search<false>(ar, ac, na, key);
      const bool hit = lb < na && d4m::pack_key(ar[lb], ac[lb]) == key;
      p.code[g * p.n + j] = hit ? ~static_cast<int32_t>(lb) : static_cast<int32_t>(lb);
      hits += hit;
    }
  }
  const int32_t total = Reduce(tmp).Sum(hits);
  if (threadIdx.x == 0) p.counts[tile] = total;
}

template <typename T>
struct FinishMerge {
  MergeArgs<T> p;
  __device__ void operator()(int64_t g, int32_t n_dup) const {
    const int64_t n_keep =
        static_cast<int64_t>(p.a_nnz[g]) + p.b_nnz[g] - n_dup;
    p.dups[g] = n_dup;
    p.o_nnz[g] = static_cast<int32_t>(n_keep < p.cap ? n_keep : p.cap);
    p.o_ov[g] = (n_keep > p.cap) | p.a_ov[g] | p.b_ov[g];
  }
};

template <typename T>
__global__ void __launch_bounds__(kTileThreads) place_b(const MergeArgs<T> p) {
  using Scan = cub::BlockScan<int32_t, kTileThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int64_t tile = blockIdx.x;
  const int64_t g = tile / p.tpg;
  const int64_t j0 = (tile - g * p.tpg) * kTile + threadIdx.x * kTileItems;
  const int64_t nb = p.b_nnz[g];
  int32_t code[kTileItems];
  int32_t hit[kTileItems];
  int32_t before[kTileItems];
  for (int k = 0; k < kTileItems; ++k) {
    const int64_t j = j0 + k;
    code[k] = j < nb ? p.code[g * p.n + j] : 0;
    hit[k] = code[k] < 0;
  }
  Scan(tmp).ExclusiveSum(hit, before);
  const int32_t base = p.off[tile] - p.off[g * p.tpg];
  for (int k = 0; k < kTileItems; ++k) {
    const int64_t j = j0 + k;
    if (j < nb) {
      const int32_t d = base + before[k];
      p.dupb[g * p.n + j] = d;
      if (!hit[k]) {
        const int64_t b = g * p.n + j;
        put(p, g, j - d + code[k], p.br[b], p.bc[b], p.bv[b]);
      }
    }
  }
}

template <typename T>
__global__ void place_a(const MergeArgs<T> p, int64_t groups) {
  const int64_t total = groups * p.m;
  for (int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       q < total; q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t g = q / p.m;
    const int64_t i = q - g * p.m;
    if (i >= p.a_nnz[g]) continue;
    const int64_t nb = p.b_nnz[g];
    const int32_t* br = p.br + g * p.n;
    const int32_t* bc = p.bc + g * p.n;
    const int32_t r = p.ar[q];
    const int32_t c = p.ac[q];
    const int64_t key = d4m::pack_key(r, c);
    const int64_t lb = d4m::search<false>(br, bc, nb, key);
    T v = p.av[q];
    int64_t d;
    if (lb < nb) {
      if (d4m::pack_key(br[lb], bc[lb]) == key) {
        v = d4m::fold_value(p.fold, v, p.bv[g * p.n + lb]);
      }
      d = p.dupb[g * p.n + lb];
    } else {
      d = p.dups[g];
    }
    put(p, g, i + lb - d, r, c, v);
  }
}

template <typename T>
cudaError_t run(MergeArgs<T> p, int64_t groups, uint32_t zero_bits,
                cudaStream_t stream) {
  cudaError_t err;
  const int64_t n_tiles = groups * p.tpg;
  if (n_tiles > 0) {
    mark_b<T><<<static_cast<unsigned int>(n_tiles), kTileThreads, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  d4m::scan_tile_counts<FinishMerge<T>><<<1, d4m::kScanThreads, 0, stream>>>(
      p.counts, p.off, n_tiles, groups, p.tpg, FinishMerge<T>{p});
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (n_tiles > 0) {
    place_b<T><<<static_cast<unsigned int>(n_tiles), kTileThreads, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (groups * p.m > 0) {
    place_a<T><<<d4m::flat_blocks(groups * p.m), d4m::kFlatThreads, 0, stream>>>(
        p, groups);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return d4m::launch_fill_tail<T>(p.orow, p.ocol, p.oval, p.o_nnz, groups,
                                  p.cap, zero_bits, stream);
}

template <typename T>
int merge_add_typed(int64_t groups, const void* ar, const void* ac,
                    const void* av, const void* a_nnz, const void* a_ov,
                    int64_t m, const void* br, const void* bc, const void* bv,
                    const void* b_nnz, const void* b_ov, int64_t n, void* orow,
                    void* ocol, void* oval, void* o_nnz, void* o_ov,
                    int64_t cap, void* code, void* dupb, void* counts,
                    void* off, void* dups, int fold, uint32_t zero_bits,
                    void* stream) {
  MergeArgs<T> p{};
  p.ar = static_cast<const int32_t*>(ar);
  p.ac = static_cast<const int32_t*>(ac);
  p.av = static_cast<const T*>(av);
  p.a_nnz = static_cast<const int32_t*>(a_nnz);
  p.a_ov = static_cast<const uint8_t*>(a_ov);
  p.m = m;
  p.br = static_cast<const int32_t*>(br);
  p.bc = static_cast<const int32_t*>(bc);
  p.bv = static_cast<const T*>(bv);
  p.b_nnz = static_cast<const int32_t*>(b_nnz);
  p.b_ov = static_cast<const uint8_t*>(b_ov);
  p.n = n;
  p.orow = static_cast<int32_t*>(orow);
  p.ocol = static_cast<int32_t*>(ocol);
  p.oval = static_cast<T*>(oval);
  p.o_nnz = static_cast<int32_t*>(o_nnz);
  p.o_ov = static_cast<uint8_t*>(o_ov);
  p.cap = cap;
  p.code = static_cast<int32_t*>(code);
  p.dupb = static_cast<int32_t*>(dupb);
  p.counts = static_cast<int32_t*>(counts);
  p.off = static_cast<int32_t*>(off);
  p.dups = static_cast<int32_t*>(dups);
  p.tpg = d4m::ceil_div(n, kTile);
  p.fold = fold;
  p.normalize = m + n >= 2;
  return static_cast<int>(
      run<T>(p, groups, zero_bits, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Scratch: code and dupb [G, n] int32,
// counts [G * ceil(n / 4096)] int32, off [that + 1] int32, dups [G] int32.
extern "C" int merge_add_run(int dtype, int64_t groups, const void* ar,
                             const void* ac, const void* av, const void* a_nnz,
                             const void* a_ov, int64_t m, const void* br,
                             const void* bc, const void* bv, const void* b_nnz,
                             const void* b_ov, int64_t n, void* orow,
                             void* ocol, void* oval, void* o_nnz, void* o_ov,
                             int64_t cap, void* code, void* dupb, void* counts,
                             void* off, void* dups, int fold,
                             uint32_t zero_bits, void* stream) {
  if (groups < 1 || m < 0 || n < 0 || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return merge_add_typed<float>(groups, ar, ac, av, a_nnz, a_ov, m, br, bc,
                                  bv, b_nnz, b_ov, n, orow, ocol, oval, o_nnz,
                                  o_ov, cap, code, dupb, counts, off, dups,
                                  fold, zero_bits, stream);
  }
  if (dtype == 1) {
    return merge_add_typed<__nv_bfloat16>(
        groups, ar, ac, av, a_nnz, a_ov, m, br, bc, bv, b_nnz, b_ov, n, orow,
        ocol, oval, o_nnz, o_ov, cap, code, dupb, counts, off, dups, fold,
        zero_bits, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* merge_add_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
