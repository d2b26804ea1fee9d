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
// read once and each live output entry written once (12 B an entry in
// float32, 10 B in bfloat16); it does a handful of comparisons per entry.
// The Assoc invariant also wants PAD keys in the output's dead tail
// [nnz, cap), which the plain version writes too: those bytes are counted
// apart (PERF.md).  The design (merge.cuh, the merge-path merge) reads only
// the live prefixes, in tiles of 2048 merged entries whose bounds one warp
// finds by a 32-way search along the tile's diagonal, so no entry searches
// for its place.  Three launches:
//   1. merge_count: tile splits and survivor counts; each group's last
//      block scans them and finishes the group's nnz and overflow;
//   2. merge_write: each tile merges in shared memory, folds, writes its
//      survivors at its offset, coalesced, truncated at cap;
//   3. fill_tail: PAD keys and the zero value in [nnz, cap).
#include <cuda_runtime.h>

#include <cstdint>

#include "merge.cuh"
#include "tiles.cuh"

namespace {

template <typename T>
struct AddProblem {
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
  int64_t groups;
  int64_t tiles;  // tiles per group of the scratch, >= merge_tiles(m + n)
  int2* splits;
  int32_t* counts;
  int64_t* offsets;
  int32_t* done;
  int fold;
  bool normalize;  // m + n >= 2

  __device__ bool input(int64_t g, d4m::MergeInput<T>& in) const {
    in = {ar + g * m, ac + g * m, av + g * m, a_nnz[g],
          br + g * n, bc + g * n, bv + g * n, b_nnz[g]};
    return true;
  }
  __device__ void skip(int64_t) const {}
  __device__ void finish(int64_t g, int64_t n_keep) const {
    o_nnz[g] = static_cast<int32_t>(n_keep < cap ? n_keep : cap);
    o_ov[g] = (n_keep > cap) | a_ov[g] | b_ov[g];
  }
  __device__ d4m::MergeOutput<T> output(int64_t g) const {
    return {orow + g * cap, ocol + g * cap, oval + g * cap, cap};
  }
};

template <typename T>
cudaError_t run(const AddProblem<T>& p, int sm_count, uint32_t zero_bits,
                int* launches, cudaStream_t stream) {
  cudaError_t err;
  const dim3 grid = d4m::merge_grid(d4m::merge_tiles(p.m + p.n), p.groups,
                                    sm_count);
  d4m::merge_count<T><<<grid, d4m::kMergeThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++*launches;
  d4m::merge_write<T><<<grid, d4m::kMergeThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ++*launches;
  return d4m::launch_fill_tail<T>(p.orow, p.ocol, p.oval, p.o_nnz, p.groups,
                                  p.cap, zero_bits, stream, launches);
}

template <typename T>
int merge_add_typed(int64_t groups, const void* ar, const void* ac,
                    const void* av, const void* a_nnz, const void* a_ov,
                    int64_t m, const void* br, const void* bc, const void* bv,
                    const void* b_nnz, const void* b_ov, int64_t n, void* orow,
                    void* ocol, void* oval, void* o_nnz, void* o_ov,
                    int64_t cap, void* splits, void* counts, void* offsets,
                    void* done, int64_t tiles, int fold, uint32_t zero_bits,
                    int sm_count, int* launches, void* stream) {
  AddProblem<T> p{};
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
  p.groups = groups;
  p.tiles = tiles;
  p.splits = static_cast<int2*>(splits);
  p.counts = static_cast<int32_t*>(counts);
  p.offsets = static_cast<int64_t*>(offsets);
  p.done = static_cast<int32_t*>(done);
  p.fold = fold;
  p.normalize = m + n >= 2;
  return static_cast<int>(run<T>(p, sm_count, zero_bits, launches,
                                 static_cast<cudaStream_t>(stream)));
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int32, 3 float16.  Scratch, with tiles = t >=
// merge_tiles(m + n): splits [G, t + 1] int2, counts [G, t] int32, offsets
// [G, t] int64, done [G] int32 zeroed (the count pass leaves it zeroed
// again).  *launches is set to the kernel launches made.
extern "C" int merge_add_run(int dtype, int64_t groups, const void* ar,
                             const void* ac, const void* av, const void* a_nnz,
                             const void* a_ov, int64_t m, const void* br,
                             const void* bc, const void* bv, const void* b_nnz,
                             const void* b_ov, int64_t n, void* orow,
                             void* ocol, void* oval, void* o_nnz, void* o_ov,
                             int64_t cap, void* splits, void* counts,
                             void* offsets, void* done, int64_t tiles,
                             int fold, uint32_t zero_bits, int sm_count,
                             int* launches, void* stream) {
  *launches = 0;
  if (groups < 1 || m < 0 || n < 0 || cap < 0 || sm_count < 1 ||
      d4m::merge_tiles(m + n) > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return d4m::by_value_type(dtype, [&](auto tag) {
    return merge_add_typed<decltype(tag)>(
        groups, ar, ac, av, a_nnz, a_ov, m, br, bc, bv, b_nnz, b_ov, n, orow,
        ocol, oval, o_nnz, o_ov, cap, splits, counts, offsets, done, tiles,
        fold, zero_bits, sm_count, launches, stream);
  });
}

extern "C" const char* merge_add_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
