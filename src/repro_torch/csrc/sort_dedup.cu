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
//     of lax.associative_scan, and every value gets "+ 0.0" when n >= 2.
//     Equal live keys must be adjacent: sorted input, or sorted unique keys
//     with PAD holes (elem_mul, extract_row), as every caller gives.  A key
//     that recurs after a hole is folded by the reference's scan in a
//     bracketing-dependent way this kernel does not replay;
//   * PAD keys drop; survivors are compacted to cap, nnz = min(count, cap),
//     overflow = count > cap; dead output slots hold PAD and the zero.
//
// The bracketing.  The scan's value at the end e of a run [s, e] is the
// left fold, in position order, of the aligned blocks of the pair tree over
// positions that tile [s, e] greedily from s (each the largest aligned
// block that starts there and fits: sizes rise, then fall), each block the
// plain pair-tree fold of its entries ("node"; tests/test_torch_sort_dedup.py
// holds this to the scan).  A block of a tile's size or less lies in one
// tile; a larger one is a run of whole tiles, aligned.
//
// The sort (from_triples only), in 1 + ceil(log2(n / 4096)) launches:
//   1. sort_tiles: each tile of 4096 entries reads its triples and mask and
//      counts its live keys (live: valid and row != PAD); a tile with no
//      live key stops there.  The others sort, carrying each value's bits,
//      with a stable cub::BlockRadixSort on the bits that vary among their
//      live keys only (the AND and OR of the row and column words give
//      them: row bits above column bits, plus one bit that puts every dead
//      key last where the tile has one), and write the sorted live prefix
//      and its length;
//   2. merge_round: the live prefixes of each pair of runs merge into one
//      run of twice the width, left run first on equal keys, by merge-path
//      tiles of 2048 entries (stable_merge_tile in merge.cuh); each pair's
//      first tile writes its live length.  Dead keys never enter a round;
//      the live entries end in [0, m) in the order the stable sort gives.
// The fold, in two launches over the sorted keys (from_triples: its live
// prefix [0, m)) or over rows/cols (combine), in tiles of 4096 entries:
//   3. fold_tiles: each tile counts its live run ends and records its last
//      run start.  Where its last run goes on into the next tile, it builds
//      its pair tree (levels 0-12) in shared memory and records that run's
//      fold in the tile; a tile of one key also hands its root up the tree
//      over tiles (the second of two sibling tiles to arrive folds their
//      parent).  The group's last tile to finish scans the counts into
//      output offsets and the run starts into each tile's carried run
//      start, writes nnz/overflow and sets the group's counters back to
//      zero;
//   4. fold_write: each tile builds its tree (levels above 4 only where a
//      run end needs a node of 32 entries or more), finds each entry's run
//      start (a block max-scan from the carried start) and folds each live
//      run end from its tile's nodes, plus, for a run begun in an earlier
//      tile, that tile's recorded fold and the tiles' tree (at most
//      2 log2(n) blocks a run end, no walk along the run); it stages the
//      survivors in shared memory and stores them in 16-byte vectors, and
//      fills its slice of the dead output slots.
// Each launch is a programmatic dependent launch: the card launches it as
// the blocks of the kernel before it exit, and it waits for that kernel's
// writes before reading.
//
// What bounds it: bytes.  The least it must move is each input triple read
// once and each live output entry written once (12 B each in float32).  The
// sort reads the triples once and writes 12 B a live entry (key and value
// bits) per tile sort and per round; the fold reads keys and values twice
// (count, then write).  At the batch shapes (10^5 entries) it is bound by
// latency instead: each launch is a few dependent steps of one wave.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "merge.cuh"
#include "tiles.cuh"

namespace {

using d4m::kMergeThreads;
using d4m::kMergeTile;
using d4m::kTile;
using d4m::kTileItems;
using d4m::kTileThreads;

constexpr uint32_t kSignWord = 0x80000000u;
constexpr int kTileLevels = 12;   // log2(kTile)
constexpr int kThreadLevels = 4;  // log2(kTileItems): levels a thread builds alone
static_assert(kTile == (1 << kTileLevels) && kTileItems == (1 << kThreadLevels),
              "the fold's tile is a power of two");

// The packed key as an unsigned integer that orders the same way: row and
// column, each with its sign bit flipped, in the high and low words.
__device__ __forceinline__ uint64_t sort_key(int32_t r, int32_t c) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(r) ^ kSignWord) << 32) |
         (static_cast<uint32_t>(c) ^ kSignWord);
}

__device__ __forceinline__ int32_t key_row(uint64_t u) {
  return static_cast<int32_t>(static_cast<uint32_t>(u >> 32) ^ kSignWord);
}

__device__ __forceinline__ int32_t key_col(uint64_t u) {
  return static_cast<int32_t>(static_cast<uint32_t>(u) ^ kSignWord);
}

struct MaxOp {
  __device__ int32_t operator()(int32_t a, int32_t b) const {
    return a > b ? a : b;
  }
};

// Programmatic dependent launch (Hopper): each kernel is launched as the
// blocks of the kernel before it on the stream exit, so its launch overlaps
// that kernel's tail, and waits here, first thing, until that kernel has
// finished and its writes are visible.  (Letting the next kernel launch
// when this one starts, with griddepcontrol.launch_dependents, was slower:
// its blocks wait on the SMs.)
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launches kernel over `blocks` blocks on the stream, as a programmatic
// dependent launch (see wait_for_previous).
template <typename... Params, typename... Args>
cudaError_t launch_kernel(void (*kernel)(Params...), int64_t blocks, int threads,
                          int smem_bytes, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The bits of value q of a 4-byte (float32, int32) or 2-byte (bfloat16,
// float16) value array,
// as the 4-byte payload the sort carries with each key.
__device__ __forceinline__ uint32_t value_bits(const void* vals, int value_bytes,
                                               int64_t q) {
  return value_bytes == 4 ? static_cast<const uint32_t*>(vals)[q]
                          : static_cast<const uint16_t*>(vals)[q];
}

// The value type from those bits.
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using Word = uint32_t;
  static __device__ float from(Word w) { return __uint_as_float(w); }
};
template <>
struct Bits<__nv_bfloat16> {
  using Word = uint16_t;
  static __device__ __nv_bfloat16 from(Word w) { return __ushort_as_bfloat16(w); }
};
template <>
struct Bits<__half> {
  using Word = uint16_t;
  static __device__ __half from(Word w) { return __ushort_as_half(w); }
};
template <>
struct Bits<int32_t> {
  using Word = uint32_t;
  static __device__ int32_t from(Word w) { return static_cast<int32_t>(w); }
};

// ---------------------------------------------------------------- the sort

// The AND and OR of a tile's live keys, word by word, and their count.
struct KeyBits {
  uint32_t and_hi, or_hi, and_lo, or_lo;
  int32_t live;
};

struct KeyBitsOp {
  __device__ KeyBits operator()(const KeyBits& a, const KeyBits& b) const {
    return {a.and_hi & b.and_hi, a.or_hi | b.or_hi, a.and_lo & b.and_lo,
            a.or_lo | b.or_lo, a.live + b.live};
  }
};

// Bits [0, result) hold every bit in which the words differ.
__device__ __forceinline__ int varying_bits(uint32_t and_w, uint32_t or_w) {
  return 32 - __clz(and_w ^ or_w);
}

__device__ __forceinline__ uint32_t low_mask(int bits) {
  return bits >= 32 ? ~0u : (1u << bits) - 1;
}

// Tile t of group g sorts entries [t kTile, (t + 1) kTile) of the group.
__global__ void __launch_bounds__(kTileThreads)
    sort_tiles(const int32_t* rows, const int32_t* cols, const void* vals,
               int value_bytes, const uint8_t* valid, int64_t n, int64_t tpg,
               uint64_t* keys, uint32_t* pay, int32_t* live_count) {
  wait_for_previous();
  using Sort = cub::BlockRadixSort<uint64_t, kTileThreads, kTileItems, uint32_t, 6>;
  using Reduce = cub::BlockReduce<KeyBits, kTileThreads>;
  __shared__ union {
    typename Sort::TempStorage sort;
    typename Reduce::TempStorage reduce;
  } tmp;
  __shared__ KeyBits all;
  const int64_t tile = blockIdx.x;
  const int64_t g = tile / tpg;
  const int64_t t0 = (tile - g * tpg) * kTile;
  const int64_t j0 = t0 + threadIdx.x * kTileItems;
  uint32_t hi[kTileItems], lo[kTileItems], v[kTileItems];
  bool live[kTileItems];
  KeyBits mine{~0u, 0u, ~0u, 0u, 0};
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    const int64_t j = j0 + i;
    live[i] = false;
    hi[i] = lo[i] = v[i] = 0;
    if (j < n) {
      const int64_t q = g * n + j;
      const int32_t r = rows[q];
      live[i] = r != d4m::kPad && (valid == nullptr || valid[q]);
      hi[i] = static_cast<uint32_t>(r) ^ kSignWord;
      lo[i] = static_cast<uint32_t>(cols[q]) ^ kSignWord;
      if (live[i]) {
        v[i] = value_bits(vals, value_bytes, q);
        mine.and_hi &= hi[i];
        mine.or_hi |= hi[i];
        mine.and_lo &= lo[i];
        mine.or_lo |= lo[i];
        ++mine.live;
      }
    }
  }
  const KeyBits total = Reduce(tmp.reduce).Reduce(mine, KeyBitsOp());
  if (threadIdx.x == 0) all = total;
  __syncthreads();  // also: every thread is done with tmp.reduce
  const KeyBits b = all;
  if (b.live == 0) {
    if (threadIdx.x == 0) live_count[tile] = 0;
    return;
  }
  // The sort key: the varying row bits above the varying column bits (all
  // live keys agree on the others, so this orders them as the full key
  // does), and, where the tile has a dead slot, the next bit up for a dead
  // key.  A live key below 64 bits leaves that bit free; at 64 every row
  // bit varies, and a live key, whose row is below PAD, stays below ~0.
  const int bits_r = varying_bits(b.and_hi, b.or_hi);
  const int bits_c = varying_bits(b.and_lo, b.or_lo);
  const uint32_t mask_r = low_mask(bits_r), mask_c = low_mask(bits_c);
  const int end_bit = bits_r + bits_c;
  const uint64_t dead = end_bit < 64 ? (1ull << end_bit) : ~0ull;
  const int sort_bits = b.live < kTile && end_bit < 64 ? end_bit + 1 : end_bit;
  uint64_t k[kTileItems];
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    k[i] = live[i] ? (static_cast<uint64_t>(hi[i] & mask_r) << bits_c) | (lo[i] & mask_c)
                   : dead;
  }
  // striped out of the sort: this thread holds ranks i * kTileThreads + threadIdx.x
  Sort(tmp.sort).SortBlockedToStriped(k, v, 0, sort_bits);
  const uint32_t fixed_hi = b.and_hi & ~mask_r, fixed_lo = b.and_lo & ~mask_c;
  const int64_t base = g * n + t0;
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    const int rank = i * kTileThreads + threadIdx.x;
    if (rank < b.live) {
      const uint32_t h = fixed_hi | (static_cast<uint32_t>(k[i] >> bits_c) & mask_r);
      const uint32_t l = fixed_lo | (static_cast<uint32_t>(k[i]) & mask_c);
      keys[base + rank] = (static_cast<uint64_t>(h) << 32) | l;
      pay[base + rank] = v[i];
    }
  }
  if (threadIdx.x == 0) live_count[tile] = b.live;
}

// Runs of width w (live lengths cin[g * stride + run]) merge pairwise into
// runs of 2w; block b of a group merges output diagonals
// [b kMergeTile, (b + 1) kMergeTile) of the group.
__global__ void __launch_bounds__(kMergeThreads)
    merge_round(const uint64_t* kin, const uint32_t* pin, uint64_t* kout,
                uint32_t* pout, const int32_t* cin, int32_t* cout, int64_t n,
                int64_t w, int64_t stride, int64_t tiles_per_group) {
  wait_for_previous();
  __shared__ d4m::StableMergeShared sh;
  const int64_t g = blockIdx.x / tiles_per_group;
  const int64_t d0 = (blockIdx.x - g * tiles_per_group) * kMergeTile;
  const int64_t pair = d0 / (2 * w);
  const int d = static_cast<int>(d0 - pair * 2 * w);
  const int la = cin[g * stride + 2 * pair];
  const int lb = (2 * pair + 1) * w < n ? cin[g * stride + 2 * pair + 1] : 0;
  if (d == 0 && threadIdx.x == 0) cout[g * stride + pair] = la + lb;
  if (d >= la + lb) return;
  const int64_t base = g * n + pair * 2 * w;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int e = d + warp * kMergeTile;
    const int2 s = d4m::stable_warp_split(kin + base, la, kin + base + w, lb,
                                          e < la + lb ? e : la + lb);
    if ((threadIdx.x & 31) == 0) sh.tile_split[warp] = s;
  }
  __syncthreads();
  const int2 s0 = sh.tile_split[0], s1 = sh.tile_split[1];
  d4m::stable_merge_tile(kin + base + s0.x, pin + base + s0.x, s1.x - s0.x,
                         kin + base + w + s0.y, pin + base + w + s0.y,
                         s1.y - s0.y, kout + base + d, pout + base + d, sh);
}

// ---------------------------------------------------------------- the fold

template <typename T>
struct FoldArgs {
  const uint64_t* keys;  // [G, n] sorted keys, or null: keys from rows/cols
  const uint32_t* pay;   // [G, n] the value bits of each sorted key (with keys)
  const int32_t* rows;   // [G, n] (without keys)
  const int32_t* cols;
  const T* vals;           // [G, n] input values
  const int32_t* present;  // entries [0, present[g * present_stride]) of
                           // group g are there; null: all n
  int64_t present_stride;
  int64_t n;
  int32_t* orow;
  int32_t* ocol;
  T* oval;
  int32_t* o_nnz;
  uint8_t* o_ov;
  int64_t cap;
  // per tile ([G, tpf]): live run ends, last run start (-1: none), output
  // offset, carried run start (the last start before the tile, -1: none),
  // the fold of the tile's last run's part in it
  int32_t* counts;
  int32_t* last_start;
  int32_t* offsets;
  int32_t* carried;
  T* run_tail;
  T* tree;  // [G, 2 tpf]: the tiles' tree, level by level
  // [G, 2 tpf]: arrivals at each node of that tree, and [G] tiles finished,
  // each zero between calls (the group's last tile sets them back)
  unsigned int* arrive;
  int32_t* done;
  int64_t tpf;      // fold tiles a group (at least 1)
  int64_t tpc;      // fold_write blocks a group: tiles of max(n, cap)
  int fold;
  bool normalize;  // n >= 2
  uint32_t zero_bits;

  __device__ uint64_t key(int64_t g, int64_t j) const {
    const int64_t q = g * n + j;
    return keys != nullptr ? keys[q] : sort_key(rows[q], cols[q]);
  }
  __device__ T value(int64_t g, int64_t j) const {
    const int64_t q = g * n + j;
    return pay != nullptr ? Bits<T>::from(static_cast<typename Bits<T>::Word>(pay[q]))
                          : vals[q];
  }
  __device__ int64_t length(int64_t g) const {
    return present != nullptr ? present[g * present_stride] : n;
  }
};

// The level of the largest aligned block that starts at p and ends at or
// before e.
__device__ __forceinline__ int piece_level(int64_t p, int64_t e) {
  const int align = p == 0 ? 62 : __ffsll(p) - 1;
  const int fit = 63 - __clzll(e - p + 1);
  return align < fit ? align : fit;
}

// A tile's tree in shared memory: level L (kTile >> L nodes) from node slot
// 2 kTile - (2 kTile >> L); one pad slot every 32 (skew), so the threads of
// a warp that each write consecutive nodes hit different banks.  Once the
// run ends' values are in registers, the same bytes stage the tile's output
// rows and columns (kStageWords).
__device__ __forceinline__ int skew(int p) { return p + (p >> 5); }
constexpr int kTreeSlots = 2 * kTile + (2 * kTile >> 5);
constexpr int kStageWords = 2 * kTile + 16;

template <typename T>
struct FoldShared {
  static constexpr int kBytes = kTreeSlots * sizeof(T) > kStageWords * 4
                                    ? kTreeSlots * sizeof(T) : kStageWords * 4;
  alignas(16) unsigned char bytes[kBytes];
  alignas(4) unsigned char carry_bytes[2 * sizeof(T)];  // IN, END
  union {
    typename cub::BlockScan<int32_t, kTileThreads>::TempStorage scan;
    typename cub::BlockReduce<int2, kTileThreads>::TempStorage reduce;
  } tmp;
  uint64_t head, tail;  // the tile's first and last keys
  int32_t last_start;   // the tile's last run start (-1: none)
  int top;              // the highest tree level the tile's run ends read
  bool goes_on;         // the tile's last run goes on into the next tile
  bool last;

  __device__ T& node(int L, int i) {
    return reinterpret_cast<T*>(bytes)[skew(2 * kTile - (2 * kTile >> L) + i)];
  }
  __device__ int32_t* words() { return reinterpret_cast<int32_t*>(bytes); }
  __device__ T* staged_vals() { return reinterpret_cast<T*>(bytes); }
  __device__ T& carry(int which) { return reinterpret_cast<T*>(carry_bytes)[which]; }
};

__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ int32_t load_cg(const int32_t* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 load_cg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ __half load_cg(const __half* p) {
  return __ushort_as_half(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// out[i] = p[i] for the kTileItems elements from p, in 16-byte vectors
// where p is 16-byte aligned (E: a 2-, 4- or 8-byte integer).
template <typename E>
__device__ __forceinline__ void load_items(const E* p, E (&out)[kTileItems]) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    constexpr int kVec = 16 / sizeof(E);
#pragma unroll
    for (int q = 0; q < kTileItems / kVec; ++q) {
      const int4 x = reinterpret_cast<const int4*>(p)[q];
      memcpy(out + q * kVec, &x, 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kTileItems; ++i) out[i] = p[i];
  }
}

// This thread's kTileItems values from tile position lo + first (the zero
// past the present entries).
template <typename T>
__device__ void load_values(const FoldArgs<T>& p, int64_t g, int64_t j0,
                            int64_t len, T (&v)[kTileItems]) {
  const T zero = d4m::Value<T>::from_bits(p.zero_bits);
  const int64_t q = g * p.n + j0;
  if (j0 + kTileItems <= len) {
    using Word = typename Bits<T>::Word;
    if (p.pay != nullptr) {
      uint32_t w[kTileItems];
      load_items(p.pay + q, w);
#pragma unroll
      for (int i = 0; i < kTileItems; ++i) v[i] = Bits<T>::from(static_cast<Word>(w[i]));
    } else {
      Word w[kTileItems];
      load_items(reinterpret_cast<const Word*>(p.vals + q), w);
#pragma unroll
      for (int i = 0; i < kTileItems; ++i) v[i] = Bits<T>::from(w[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kTileItems; ++i) v[i] = j0 + i < len ? p.value(g, j0 + i) : zero;
  }
}

// The level of the largest block among those that tile a run's part of
// `span` entries (floor(log2(span))).
__device__ __forceinline__ int top_level(int span) { return 31 - __clz(span); }

// Builds the tile's tree from this thread's values v (positions
// threadIdx.x * kTileItems on): levels 0-4, then levels 5 to `top` (nodes
// of 32 entries or more).  Ends with the block synced.
template <typename T>
__device__ void build_tree(int fold, FoldShared<T>& sh, T (&v)[kTileItems],
                           int top) {
  const int first = threadIdx.x * kTileItems;
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) sh.node(0, first + i) = v[i];
#pragma unroll
  for (int L = 1; L <= kThreadLevels; ++L) {
#pragma unroll
    for (int i = 0; i < (kTileItems >> L); ++i) {
      v[i] = d4m::fold_value(fold, v[2 * i], v[2 * i + 1]);
      sh.node(L, (first >> L) + i) = v[i];
    }
  }
  for (int L = kThreadLevels + 1; L <= top; ++L) {
    __syncthreads();
    for (int i = threadIdx.x; i < (kTile >> L); i += kTileThreads) {
      sh.node(L, i) = d4m::fold_value(fold, sh.node(L - 1, 2 * i), sh.node(L - 1, 2 * i + 1));
    }
  }
  __syncthreads();
}

// The subtree of the tile's last 32 entries (levels 0-5), by warp 0: all a
// run's part there reads.
template <typename T>
__device__ void build_last_32(const FoldArgs<T>& p, int64_t g, int64_t lo,
                              int64_t len, FoldShared<T>& sh) {
  constexpr int kFirst = kTile - 32;
  const int lane = threadIdx.x;
  const int64_t j = lo + kFirst + lane;
  sh.node(0, kFirst + lane) = j < len ? p.value(g, j) : d4m::Value<T>::from_bits(p.zero_bits);
  for (int L = 1; L <= 5; ++L) {
    __syncwarp();
    if (lane < (32 >> L)) {
      const int i = (kFirst >> L) + lane;
      sh.node(L, i) = d4m::fold_value(p.fold, sh.node(L - 1, 2 * i), sh.node(L - 1, 2 * i + 1));
    }
  }
  __syncwarp();
}

// acc (when have), then the tile's blocks that tile [s, e] (positions in
// the tile) greedily from s, folded left.
template <typename T>
__device__ T fold_pieces(int fold, FoldShared<T>& sh, bool have, T acc, int s,
                         int e) {
  for (int q = s; q <= e;) {
    const int L = piece_level(q, e);
    const T v = sh.node(L, q >> L);
    acc = have ? d4m::fold_value(fold, acc, v) : v;
    have = true;
    q += 1 << L;
  }
  return acc;
}

// Offset of level k of a group's tiles' tree (level 0: the roots; level k:
// its tpf >> k complete nodes).
__device__ __forceinline__ int64_t tiles_level(int64_t tpf, int k) {
  int64_t off = 0;
  for (int l = 0; l < k; ++l) off += tpf >> l;
  return off;
}

// The fold of [s, the end of tile b] of group g, for a run that starts at s
// in an earlier tile or at the start of one: the recorded fold of its part
// in its first tile (unless it starts there), then whole tiles' nodes.
template <typename T>
__device__ T through(const FoldArgs<T>& p, int64_t g, int64_t s, int64_t b) {
  const int64_t ts = s / kTile;
  const T* tree = p.tree + g * 2 * p.tpf;
  T acc = d4m::Value<T>::from_bits(p.zero_bits);
  bool have = false;
  int64_t a = ts;
  if (s % kTile != 0) {
    acc = p.run_tail[g * p.tpf + ts];
    have = true;
    a = ts + 1;
  }
  for (int64_t q = a; q <= b;) {
    const int k = piece_level(q, b);
    const T v = tree[tiles_level(p.tpf, k) + (q >> k)];
    acc = have ? d4m::fold_value(p.fold, acc, v) : v;
    have = true;
    q += int64_t(1) << k;
  }
  return acc;
}

// This thread's kTileItems keys from position j0, which of them start a
// run and which end a live run (among the len present entries), and
// whether the last one's run goes on past them.
struct TileFlags {
  uint64_t key[kTileItems];
  bool start[kTileItems];
  bool end[kTileItems];
  bool goes_on;
};

template <typename T>
__device__ void tile_flags(const FoldArgs<T>& p, int64_t g, int64_t j0,
                           int64_t len, TileFlags& f) {
  const uint64_t prev = j0 > 0 && j0 - 1 < len ? p.key(g, j0 - 1) : 0;
  const int64_t q = g * p.n + j0;
  if (j0 + kTileItems <= len && p.keys != nullptr) {
    load_items(p.keys + q, f.key);
  } else if (j0 + kTileItems <= len) {
    int32_t r[kTileItems], c[kTileItems];
    load_items(p.rows + q, r);
    load_items(p.cols + q, c);
#pragma unroll
    for (int i = 0; i < kTileItems; ++i) f.key[i] = sort_key(r[i], c[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kTileItems; ++i) {
      f.key[i] = j0 + i < len ? p.key(g, j0 + i) : 0;
    }
  }
  const uint64_t next = j0 + kTileItems < len ? p.key(g, j0 + kTileItems) : 0;
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    const int64_t j = j0 + i;
    const uint64_t before = i == 0 ? prev : f.key[i - 1];
    const uint64_t after = i + 1 < kTileItems ? f.key[i + 1] : next;
    f.start[i] = j < len && (j == 0 || before != f.key[i]);
    f.end[i] = j < len && (j + 1 == len || after != f.key[i]) &&
               key_row(f.key[i]) != d4m::kPad;
  }
  f.goes_on = j0 + kTileItems < len && next == f.key[kTileItems - 1];
}

struct EndsAndLastStart {
  __device__ int2 operator()(int2 a, int2 b) const {
    return make_int2(a.x + b.x, a.y > b.y ? a.y : b.y);
  }
};

// Up from the root v of tile t, which holds one key: the second of two
// sibling nodes of the tiles' tree to arrive folds their parent, while the
// parent is complete.  Only nodes of one key are ever read, and only tiles
// of one key climb, so a parent with a child of several keys is left
// unfolded.
template <typename T>
__device__ void climb(const FoldArgs<T>& p, int64_t g, int64_t t, T v) {
  T* tree = p.tree + g * 2 * p.tpf;
  unsigned int* arrive = p.arrive + g * 2 * p.tpf;
  tree[t] = v;
  int64_t i = t;
  for (int k = 0; (i >> 1) < (p.tpf >> (k + 1)); ++k) {
    const int64_t parent = i >> 1;
    const int64_t slot = tiles_level(p.tpf, k + 1) + parent;
    __threadfence();  // this node, before its arrival
    if (atomicAdd(arrive + slot, 1u) == 0) return;  // the sibling folds it
    const T sib = load_cg(tree + tiles_level(p.tpf, k) + (i ^ 1));
    v = (i & 1) ? d4m::fold_value(p.fold, sib, v) : d4m::fold_value(p.fold, v, sib);
    i = parent;
    tree[slot] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads) fold_tiles(const FoldArgs<T> p) {
  wait_for_previous();
  __shared__ FoldShared<T> sh;
  const int64_t tile = blockIdx.x;
  const int64_t g = tile / p.tpf;
  const int64_t t = tile - g * p.tpf;
  const int64_t lo = t * kTile;
  const int64_t len = p.length(g);
  const int64_t j0 = lo + threadIdx.x * kTileItems;
  TileFlags f;
  tile_flags(p, g, j0, len, f);
  int2 mine = make_int2(0, -1);  // live run ends, last run start
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    mine.x += f.end[i];
    if (f.start[i]) mine.y = static_cast<int32_t>(j0 + i);
  }
  if (threadIdx.x == 0) sh.head = f.key[0];
  if (threadIdx.x == kTileThreads - 1) {
    sh.tail = f.key[kTileItems - 1];
    sh.goes_on = f.goes_on;
  }
  const int2 total = cub::BlockReduce<int2, kTileThreads>(sh.tmp.reduce)
                         .Reduce(mine, EndsAndLastStart());
  if (threadIdx.x == 0) sh.last_start = total.y;
  __syncthreads();
  // the tile's tree is read only for a run that goes on into the next tile
  // (its part here, from s) or a tile of one key (its root); a part in the
  // last 32 entries needs their subtree alone
  const bool one_key = lo + kTile <= len && sh.head == sh.tail;
  const int s = sh.last_start >= lo ? static_cast<int>(sh.last_start - lo) : 0;
  if (one_key || (sh.goes_on && kTile - s > 32)) {
    T v[kTileItems];
    load_values(p, g, j0, len, v);
    build_tree(p.fold, sh, v, one_key ? kTileLevels : top_level(kTile - s));
  } else if (sh.goes_on && threadIdx.x < 32) {
    build_last_32(p, g, lo, len, sh);
  }
  if (threadIdx.x == 0) {
    p.counts[tile] = total.x;
    p.last_start[tile] = total.y;
    if (sh.goes_on) {
      p.run_tail[tile] = fold_pieces(p.fold, sh, false, sh.node(0, 0), s, kTile - 1);
    }
    if (one_key) climb(p, g, t, sh.node(kTileLevels, 0));
    __threadfence();  // this tile's records, before it counts as finished
    sh.last = atomicAdd(p.done + g, 1) + 1 == p.tpf;
  }
  __syncthreads();
  if (!sh.last) return;
  // the group's last tile: offsets, carried run starts, nnz and overflow
  // (reading the other tiles' records from L2)
  __threadfence();
  using Scan = cub::BlockScan<int32_t, kTileThreads>;
  int64_t sum = 0;
  int32_t high = -1;
  const int64_t rec = g * p.tpf;
  for (int64_t base = 0; base < p.tpf; base += kTile) {
    int32_t c[kTileItems], m[kTileItems];
#pragma unroll
    for (int i = 0; i < kTileItems; ++i) {
      const int64_t x = base + threadIdx.x * kTileItems + i;
      c[i] = x < p.tpf ? __ldcg(p.counts + rec + x) : 0;
      m[i] = x < p.tpf ? __ldcg(p.last_start + rec + x) : -1;
    }
    int32_t c_before[kTileItems], m_before[kTileItems], c_total, m_total;
    Scan(sh.tmp.scan).ExclusiveSum(c, c_before, c_total);
    __syncthreads();
    Scan(sh.tmp.scan).ExclusiveScan(m, m_before, -1, MaxOp(), m_total);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTileItems; ++i) {
      const int64_t x = base + threadIdx.x * kTileItems + i;
      if (x < p.tpf) {
        p.offsets[rec + x] = static_cast<int32_t>(sum + c_before[i]);
        p.carried[rec + x] = m_before[i] > high ? m_before[i] : high;
      }
    }
    sum += c_total;
    high = m_total > high ? m_total : high;
  }
  // every tile of the group has finished: its counters back to zero
  for (int64_t q = threadIdx.x; q < 2 * p.tpf; q += kTileThreads) {
    p.arrive[g * 2 * p.tpf + q] = 0;
  }
  if (threadIdx.x == 0) {
    p.o_nnz[g] = static_cast<int32_t>(sum < p.cap ? sum : p.cap);
    p.o_ov[g] = sum > p.cap;
    p.done[g] = 0;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads) fold_write(const FoldArgs<T> p) {
  wait_for_previous();
  __shared__ FoldShared<T> sh;
  const int64_t g = blockIdx.x / p.tpc;
  const int64_t t = blockIdx.x - g * p.tpc;
  const int64_t lo = t * kTile;
  const int64_t tile = g * p.tpf + t;
  const bool fold_tile = t < p.tpf;  // else a block of dead output slots only
  // the records this block reads, all loads in flight at once
  const int64_t nnz = p.o_nnz[g];
  const int32_t off = fold_tile ? p.offsets[tile] : 0;
  const int32_t count = fold_tile ? p.counts[tile] : 0;
  const int32_t carried = fold_tile ? p.carried[tile] : 0;
  const int64_t len = p.length(g);
  {  // this block's slice of the dead output slots [nnz, cap)
    const T zero = d4m::Value<T>::from_bits(p.zero_bits);
    const int64_t a = lo > nnz ? lo : nnz;
    const int64_t b = lo + kTile < p.cap ? lo + kTile : p.cap;
    for (int64_t q = a + threadIdx.x; q < b; q += kTileThreads) {
      p.orow[g * p.cap + q] = d4m::kPad;
      p.ocol[g * p.cap + q] = d4m::kPad;
      p.oval[g * p.cap + q] = zero;
    }
  }
  if (count == 0 || off >= p.cap) return;  // nothing to write
  if (threadIdx.x == 0) sh.top = kThreadLevels;
  const int64_t j0 = lo + threadIdx.x * kTileItems;
  TileFlags f;
  tile_flags(p, g, j0, len, f);
  T v[kTileItems];
  load_values(p, g, j0, len, v);
  if (threadIdx.x == 0 && !f.start[0]) {
    // the tile's first run began in an earlier tile: its fold up to the
    // tile (IN) and, should it cover the whole tile, through it (END),
    // while the other threads load
    sh.carry(0) = through(p, g, carried, t - 1);
    sh.carry(1) = through(p, g, carried, t);
  }
  int32_t starts[kTileItems], ends[kTileItems], st[kTileItems], before[kTileItems];
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    starts[i] = f.start[i] ? static_cast<int32_t>(j0 + i) : -1;
    ends[i] = f.end[i];
  }
  using Scan = cub::BlockScan<int32_t, kTileThreads>;
  Scan(sh.tmp.scan).InclusiveScan(starts, st, MaxOp());  // each entry's run start
  __syncthreads();
  Scan(sh.tmp.scan).ExclusiveSum(ends, before);
  int top = 0;  // the highest tree level this thread's run ends read
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    if (st[i] < carried) st[i] = carried;
    const int e = static_cast<int>(j0 + i - lo);
    // a run begun in an earlier tile reads IN, then nodes of [0, e]
    const int from = st[i] < lo ? 0 : static_cast<int>(st[i] - lo);
    if (f.end[i] && !(st[i] < lo && e == kTile - 1)) top = max(top, top_level(e - from + 1));
  }
  if (top > kThreadLevels) atomicMax(&sh.top, top);
  __syncthreads();
  build_tree(p.fold, sh, v, sh.top);  // ends synced: IN, END too
  // the run ends' values, then rows and columns, then values, staged at the
  // output's offset within 16 bytes and stored in 16-byte vectors
  T out[kTileItems];
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    if (!f.end[i]) continue;
    const int e = static_cast<int>(j0 + i - lo);
    if (st[i] >= lo) {
      out[i] = fold_pieces(p.fold, sh, false, sh.carry(0), static_cast<int>(st[i] - lo), e);
    } else if (e == kTile - 1) {
      out[i] = sh.carry(1);
    } else {
      out[i] = fold_pieces(p.fold, sh, true, sh.carry(0), 0, e);
    }
    if (p.normalize) out[i] = d4m::plus_zero(out[i]);
  }
  const int64_t room = p.cap - off;
  const int n_out = static_cast<int>(count < room ? count : room);
  int32_t* orow = p.orow + g * p.cap + off;
  int32_t* ocol = p.ocol + g * p.cap + off;
  T* oval = p.oval + g * p.cap + off;
  const int ro = d4m::lead(orow), co = d4m::lead_after(ro + n_out, ocol);
  __syncthreads();  // every thread has read the tree
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    if (f.end[i] && before[i] < n_out) {
      sh.words()[ro + before[i]] = key_row(f.key[i]);
      sh.words()[co + before[i]] = key_col(f.key[i]);
    }
  }
  __syncthreads();
  d4m::block_store(orow, sh.words() + ro, n_out);
  d4m::block_store(ocol, sh.words() + co, n_out);
  __syncthreads();
  const int vo = d4m::lead(oval);
#pragma unroll
  for (int i = 0; i < kTileItems; ++i) {
    if (f.end[i] && before[i] < n_out) sh.staged_vals()[vo + before[i]] = out[i];
  }
  __syncthreads();
  d4m::block_store(oval, sh.staged_vals() + vo, n_out);
}

// ------------------------------------------------------------ the workspace

// Regions of the workspace, 16-byte aligned, carved in one order so that a
// null base gives the sizes.
struct Carver {
  unsigned char* base;
  int64_t used = 0;
  template <typename E>
  E* take(int64_t count) {
    E* at = base != nullptr ? reinterpret_cast<E*>(base + used) : nullptr;
    used += (count * static_cast<int64_t>(sizeof(E)) + 15) / 16 * 16;
    return at;
  }
};

struct Regions {
  uint64_t* keys[2];
  uint32_t* pay[2];  // the value bits carried with each key
  int32_t* live[2];
  int32_t *counts, *last_start, *offsets, *carried;
  uint32_t* run_tail;  // value-sized slots (4 bytes hold either type)
  uint32_t* tree;
  unsigned int* arrive;
  int32_t* done;
};

int64_t fold_tiles_per_group(int64_t n) {
  const int64_t t = d4m::ceil_div(n, kTile);
  return t > 0 ? t : 1;
}

// Two workspaces: `work` (no initial contents) and `zeroed` (counters every
// call leaves zero, whatever its shape).  sorting false: the fold stage
// alone.
void carve(int64_t groups, int64_t n, bool sorting, void* work, void* zeroed,
           Regions* r, int64_t bytes[2]) {
  Carver w{static_cast<unsigned char*>(work)};
  const int64_t tpf = fold_tiles_per_group(n);
  for (int i = 0; i < 2; ++i) {
    r->keys[i] = w.take<uint64_t>(sorting ? groups * n : 0);
    r->pay[i] = w.take<uint32_t>(sorting ? groups * n : 0);
    r->live[i] = w.take<int32_t>(sorting ? groups * d4m::ceil_div(n, kTile) : 0);
  }
  r->counts = w.take<int32_t>(groups * tpf);
  r->last_start = w.take<int32_t>(groups * tpf);
  r->offsets = w.take<int32_t>(groups * tpf);
  r->carried = w.take<int32_t>(groups * tpf);
  r->run_tail = w.take<uint32_t>(groups * tpf);
  r->tree = w.take<uint32_t>(groups * 2 * tpf);
  Carver z{static_cast<unsigned char*>(zeroed)};
  r->done = z.take<int32_t>(groups);
  r->arrive = z.take<unsigned int>(groups * 2 * tpf);
  bytes[0] = w.used;
  bytes[1] = z.used;
}

// ------------------------------------------------------------ the launches

// Sorts the live keys, with their values' bits, into regions (keys, pay,
// live)[*which].
cudaError_t sort(const int32_t* rows, const int32_t* cols, const void* vals,
                 int value_bytes, const uint8_t* valid, int64_t groups, int64_t n,
                 const Regions& r, int* which, int* launches, cudaStream_t stream) {
  *which = 0;
  const int64_t stride = d4m::ceil_div(n, kTile);  // sort tiles a group
  cudaError_t err = launch_kernel(sort_tiles, groups * stride, kTileThreads, 0, stream,
                                  rows, cols, vals, value_bytes, valid, n, stride,
                                  r.keys[0], r.pay[0], r.live[0]);
  if (err != cudaSuccess) return err;
  ++*launches;
  const int64_t mtpg = d4m::ceil_div(n, kMergeTile);
  for (int64_t w = kTile; w < n; w *= 2) {
    const int a = *which;
    err = launch_kernel(merge_round, groups * mtpg, kMergeThreads, 0, stream,
                        static_cast<const uint64_t*>(r.keys[a]),
                        static_cast<const uint32_t*>(r.pay[a]), r.keys[1 - a],
                        r.pay[1 - a], static_cast<const int32_t*>(r.live[a]),
                        r.live[1 - a], n, w, stride, mtpg);
    if (err != cudaSuccess) return err;
    ++*launches;
    *which = 1 - a;
  }
  return cudaSuccess;
}

// One call of either entry point.
struct Call {
  int64_t groups, n, cap;
  const void *rows, *cols, *vals, *valid;
  void *orow, *ocol, *oval, *o_nnz, *o_ov;
  void *work, *zeroed;
  bool sorting;  // false: the fold stage alone
  int fold;
  uint32_t zero_bits;
  int* launches;
  cudaStream_t stream;
};

template <typename T>
int run(const Call& c) {
  Regions r;
  int64_t bytes[2];
  carve(c.groups, c.n, c.sorting, c.work, c.zeroed, &r, bytes);
  FoldArgs<T> p{};
  p.rows = static_cast<const int32_t*>(c.rows);
  p.cols = static_cast<const int32_t*>(c.cols);
  p.vals = static_cast<const T*>(c.vals);
  p.n = c.n;
  p.orow = static_cast<int32_t*>(c.orow);
  p.ocol = static_cast<int32_t*>(c.ocol);
  p.oval = static_cast<T*>(c.oval);
  p.o_nnz = static_cast<int32_t*>(c.o_nnz);
  p.o_ov = static_cast<uint8_t*>(c.o_ov);
  p.cap = c.cap;
  p.counts = r.counts;
  p.last_start = r.last_start;
  p.offsets = r.offsets;
  p.carried = r.carried;
  p.run_tail = reinterpret_cast<T*>(r.run_tail);
  p.tree = reinterpret_cast<T*>(r.tree);
  p.arrive = r.arrive;
  p.done = r.done;
  p.tpf = fold_tiles_per_group(c.n);
  const int64_t cap_tiles = d4m::ceil_div(c.cap, kTile);
  p.tpc = p.tpf > cap_tiles ? p.tpf : cap_tiles;
  p.fold = c.fold;
  p.normalize = c.n >= 2;
  p.zero_bits = c.zero_bits;
  cudaError_t err;
  if (c.sorting && c.n > 0) {
    int which = 0;
    err = sort(static_cast<const int32_t*>(c.rows), static_cast<const int32_t*>(c.cols),
               c.vals, sizeof(T), static_cast<const uint8_t*>(c.valid), c.groups, c.n, r,
               &which, c.launches, c.stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    p.keys = r.keys[which];
    p.pay = r.pay[which];
    p.present = r.live[which];
    p.present_stride = d4m::ceil_div(c.n, kTile);
  }
  err = launch_kernel(fold_tiles<T>, c.groups * p.tpf, kTileThreads, 0, c.stream, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*c.launches;
  err = launch_kernel(fold_write<T>, c.groups * p.tpc, kTileThreads, 0, c.stream, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*c.launches;
  return 0;
}

int dispatch(int dtype, const Call& c) {
  if (c.groups < 1 || c.n < 0 || c.cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return d4m::by_value_type(dtype, [&](auto tag) { return run<decltype(tag)>(c); });
}

}  // namespace

// Bytes of the two workspaces a call needs (bytes[0..1]: work, zeroed; see
// carve).  zeroed is all zero when made.  sorting: 1 for a from_triples
// call, 0 for sort_dedup_combine.
extern "C" int sort_dedup_workspace(int64_t groups, int64_t n, int sorting,
                                    int64_t* bytes) {
  if (groups < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  Regions r;
  carve(groups, n, sorting != 0, nullptr, nullptr, &r, bytes);
  return 0;
}

// dtype: 0 float32, 1 bfloat16, 2 int32, 3 float16.  valid: [G, n] bool or
// null.  work, zeroed:
// sort_dedup_workspace's sizes for (groups, n, 1).  *launches grows by the
// CUDA launches made.
extern "C" int sort_dedup_from_triples(
    int dtype, int64_t groups, int64_t n, const void* rows, const void* cols,
    const void* vals, const void* valid, void* orow, void* ocol, void* oval,
    void* o_nnz, void* o_ov, int64_t cap, void* work, void* zeroed, int fold,
    uint32_t zero_bits, int* launches, void* stream) {
  return dispatch(dtype, Call{groups, n, cap, rows, cols, vals, valid, orow, ocol,
                              oval, o_nnz, o_ov, work, zeroed, true, fold,
                              zero_bits, launches, static_cast<cudaStream_t>(stream)});
}

// The fold stage alone, on triples whose equal keys are already adjacent.
// Workspaces: sort_dedup_workspace's sizes for (groups, n, 0).
extern "C" int sort_dedup_combine(int dtype, int64_t groups, int64_t n,
                                  const void* rows, const void* cols,
                                  const void* vals, void* orow, void* ocol,
                                  void* oval, void* o_nnz, void* o_ov,
                                  int64_t cap, void* work, void* zeroed,
                                  int fold, uint32_t zero_bits, int* launches,
                                  void* stream) {
  return dispatch(dtype, Call{groups, n, cap, rows, cols, vals, nullptr, orow,
                              ocol, oval, o_nnz, o_ov, work, zeroed, false, fold,
                              zero_bits, launches, static_cast<cudaStream_t>(stream)});
}

extern "C" const char* sort_dedup_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
