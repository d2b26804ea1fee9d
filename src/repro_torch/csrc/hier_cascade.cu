// hier_cascade: one packed streaming update step over K hierarchical
// associative arrays, every merge spread over the whole card.
//
// Replaces the TPU kernel repro/kernels/hier_cascade/kernel.py:168
// (hier_cascade_pallas; body _cascade_kernel, merge _merge_canonical) and
// computes what it computes, bit for bit, in float32, bfloat16, float16 and
// int32:
//   * layer 1 always merges the canonical batch (whose overflow the wrapper
//     has already OR-ed into layer 1's flag);
//   * layer i merges into layer i+1 only when nnz_i > cut_i, read after this
//     step's lower merges.  That is the lane skip: it is decided on the card
//     from nnz in device memory, per instance, so a lane whose cut does not
//     fire touches no upper layer and the host never waits for the card;
//   * a fired merge clears the source (PAD keys, semiring-zero values,
//     nnz 0, overflow false), adds one to cascades[i+1] and sets
//     overflow[i+1] |= overflow[i] | merge_overflow;
//   * merges fold equal keys as sr.add(dst, src), dst on the left, round to
//     the value type after each operation (an int32 fold stays integer),
//     add "+ 0.0" to every written float value, and truncate to the layer's true capacity.
//
// What bounds it: bytes.  A step must read the live prefixes of the layers
// it merges and of the batch, write the merged layers back and clear the
// fired sources; it does a handful of comparisons per entry.  The design:
// each of the L merges of a step (the batch into layer 1, then layer i into
// i+1) is one level of three launches over a grid of merge-path tiles x K
// instances (merge.cuh): merge_count, merge_write into a scratch of the
// destination's size (a merge in place across blocks would overwrite dst
// entries another block has not read yet), and level_finish, which copies
// the live prefix back, clears a fired source and updates the instance's
// nnz, overflow and cascade counters.  An instance whose cut did not fire
// exits each launch at once; tiles past an instance's live length are never
// visited.  Launches rather than one cooperative kernel: a level's grid is
// sized from its capacities and each instance's work from its own nnz,
// with no residency limit on the grid and no grid-wide barrier.
#include <cuda_runtime.h>

#include <cstdint>

#include "merge.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kCopyThreads = 256;

template <typename T>
struct Layers {
  int32_t* rows[kMaxLayers];
  int32_t* cols[kMaxLayers];
  T* vals[kMaxLayers];
  int64_t width[kMaxLayers];  // buffer width of each layer (row stride)
  int64_t cap[kMaxLayers];    // true telescoped capacity
  int64_t cut[kMaxLayers];    // cut of layers 0 .. L-2
  const int32_t* b_rows;      // canonical batch [K, b_width]
  const int32_t* b_cols;
  const T* b_vals;
  const int32_t* b_nnz;  // [K]
  int64_t b_width;
  int32_t* nnz;   // [K, L]
  int32_t* casc;  // [K, L]
  uint8_t* ov;    // [K, L] bool
  int n_layers;
};

// Level `level` of a step: level 0 merges the batch into layer 0; level
// i >= 1 merges layer i-1 into layer i where the instance's cut fired.
template <typename T>
struct LevelProblem {
  Layers<T> s;
  int level;
  int32_t* out_rows;  // scratch [K, out_stride]
  int32_t* out_cols;
  T* out_vals;
  int64_t out_stride;
  int64_t* rec;  // [K, 2]: survivors (-1: no merge), source entries
  int64_t groups;  // K
  int64_t tiles;   // tiles per instance of the scratch
  int2* splits;
  int32_t* counts;
  int64_t* offsets;
  int32_t* done;
  int fold;
  bool normalize;
  uint32_t zero_bits;

  __device__ bool input(int64_t k, d4m::MergeInput<T>& in) const {
    const int L = s.n_layers, d = level;
    const int64_t dof = k * s.width[d];
    in.ar = s.rows[d] + dof;
    in.ac = s.cols[d] + dof;
    in.av = s.vals[d] + dof;
    in.na = s.nnz[k * L + d];
    if (level == 0) {
      const int64_t bof = k * s.b_width;
      in.br = s.b_rows + bof;
      in.bc = s.b_cols + bof;
      in.bv = s.b_vals + bof;
      in.nb = s.b_nnz[k];
      return true;
    }
    const int src = d - 1;
    const int64_t sof = k * s.width[src];
    in.br = s.rows[src] + sof;
    in.bc = s.cols[src] + sof;
    in.bv = s.vals[src] + sof;
    in.nb = s.nnz[k * L + src];
    return in.nb > s.cut[src];  // the lane skip
  }
  __device__ void skip(int64_t k) const { rec[2 * k] = -1; }
  __device__ void finish(int64_t k, int64_t n_keep) const {
    rec[2 * k] = n_keep;
    rec[2 * k + 1] = level == 0 ? 0 : s.nnz[k * s.n_layers + level - 1];
  }
  __device__ d4m::MergeOutput<T> output(int64_t k) const {
    const int64_t o = k * out_stride;
    return {out_rows + o, out_cols + o, out_vals + o, s.cap[level]};
  }
};

// The merged layer's live prefix from the scratch back into its buffer,
// the fired source cleared, then the instance's counters.  Reads the
// record of merge_count, not nnz, which its block 0 rewrites.
template <typename T>
__global__ void __launch_bounds__(kCopyThreads)
    level_finish(const LevelProblem<T> p) {
  const int L = p.s.n_layers, d = p.level;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kCopyThreads;
  for (int64_t k = blockIdx.y; k < p.groups; k += gridDim.y) {
    const int64_t n_keep = p.rec[2 * k];
    if (n_keep < 0) continue;
    const int64_t cap = p.s.cap[d];
    const int64_t n_out = n_keep < cap ? n_keep : cap;
    const int64_t x0 = blockIdx.x * static_cast<int64_t>(kCopyThreads) +
                       threadIdx.x;
    {
      const int64_t o = k * p.out_stride, dof = k * p.s.width[d];
      for (int64_t x = x0; x < n_out; x += stride) {
        p.s.rows[d][dof + x] = p.out_rows[o + x];
        p.s.cols[d][dof + x] = p.out_cols[o + x];
        p.s.vals[d][dof + x] = p.out_vals[o + x];
      }
    }
    if (d > 0) {
      const T zero = d4m::Value<T>::from_bits(p.zero_bits);
      const int64_t ns = p.rec[2 * k + 1], sof = k * p.s.width[d - 1];
      for (int64_t x = x0; x < ns; x += stride) {
        p.s.rows[d - 1][sof + x] = d4m::kPad;
        p.s.cols[d - 1][sof + x] = d4m::kPad;
        p.s.vals[d - 1][sof + x] = zero;
      }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      const int64_t id = k * L + d;
      uint8_t ov = p.s.ov[id] | (n_keep > cap);
      if (d > 0) {
        const int64_t is = id - 1;
        ov |= p.s.ov[is];
        p.s.nnz[is] = 0;
        p.s.ov[is] = 0;
        p.s.casc[id] += 1;
      }
      p.s.nnz[id] = static_cast<int32_t>(n_out);
      p.s.ov[id] = ov;
    }
  }
}

template <typename T>
int launch(int n_instances, int n_layers, const void* b_rows,
           const void* b_cols, const void* b_vals, const void* b_nnz,
           int64_t b_width, void* const* rows, void* const* cols,
           void* const* vals, const int64_t* widths, const int64_t* caps,
           const int64_t* cuts, void* nnz, void* casc, void* ov,
           void* out_rows, void* out_cols, void* out_vals, int64_t out_stride,
           void* splits, void* counts, void* offsets, void* rec, void* done,
           int64_t tiles, int fold, uint32_t zero_bits, int sm_count,
           int* launches, cudaStream_t stream) {
  Layers<T> s{};
  for (int i = 0; i < n_layers; ++i) {
    s.rows[i] = static_cast<int32_t*>(rows[i]);
    s.cols[i] = static_cast<int32_t*>(cols[i]);
    s.vals[i] = static_cast<T*>(vals[i]);
    s.width[i] = widths[i];
    s.cap[i] = caps[i];
    s.cut[i] = i + 1 < n_layers ? cuts[i] : 0;
    if (caps[i] > out_stride) return static_cast<int>(cudaErrorInvalidValue);
  }
  s.b_rows = static_cast<const int32_t*>(b_rows);
  s.b_cols = static_cast<const int32_t*>(b_cols);
  s.b_vals = static_cast<const T*>(b_vals);
  s.b_nnz = static_cast<const int32_t*>(b_nnz);
  s.b_width = b_width;
  s.nnz = static_cast<int32_t*>(nnz);
  s.casc = static_cast<int32_t*>(casc);
  s.ov = static_cast<uint8_t*>(ov);
  s.n_layers = n_layers;

  LevelProblem<T> p{};
  p.s = s;
  p.out_rows = static_cast<int32_t*>(out_rows);
  p.out_cols = static_cast<int32_t*>(out_cols);
  p.out_vals = static_cast<T*>(out_vals);
  p.out_stride = out_stride;
  p.rec = static_cast<int64_t*>(rec);
  p.groups = n_instances;
  p.tiles = tiles;
  p.splits = static_cast<int2*>(splits);
  p.counts = static_cast<int32_t*>(counts);
  p.offsets = static_cast<int64_t*>(offsets);
  p.done = static_cast<int32_t*>(done);
  p.fold = fold;
  p.zero_bits = zero_bits;
  cudaError_t err;
  for (int level = 0; level < n_layers; ++level) {
    // widest source: the batch, or the layer below at its capacity
    const int64_t src_w = level == 0 ? b_width : caps[level - 1];
    const int64_t level_tiles = d4m::merge_tiles(caps[level] + src_w);
    if (level_tiles > tiles) return static_cast<int>(cudaErrorInvalidValue);
    p.level = level;
    p.normalize = widths[level] + (level == 0 ? b_width : widths[level - 1]) >= 2;
    const dim3 grid = d4m::merge_grid(level_tiles, n_instances, sm_count);
    d4m::merge_count<T><<<grid, d4m::kMergeThreads, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launches;
    d4m::merge_write<T><<<grid, d4m::kMergeThreads, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launches;
    const int64_t widest = caps[level] > src_w ? caps[level] : src_w;
    const int64_t copy_blocks = (widest + kCopyThreads - 1) / kCopyThreads;
    const dim3 copy_grid = d4m::merge_grid(copy_blocks, n_instances, sm_count);
    level_finish<T><<<copy_grid, kCopyThreads, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 int32, 3 float16 (kernels/_launch.py
// DTYPE_CODES).  Scratch:
// out rows/cols/vals [K, out_stride] (out_stride >= every cap); with t >=
// merge_tiles(cap[i] + the widest source of level i) for every level:
// splits [K, t + 1] int2, counts [K, t] int32, offsets [K, t] int64,
// rec [K, 2] int64, done [K] int32 zeroed (each level's count pass leaves
// it zeroed again).  *launches is set to the kernel launches made.
extern "C" int hier_cascade_step(
    int dtype, int n_instances, int n_layers, const void* b_rows,
    const void* b_cols, const void* b_vals, const void* b_nnz,
    int64_t b_width, void* const* rows, void* const* cols, void* const* vals,
    const int64_t* widths, const int64_t* caps, const int64_t* cuts,
    void* nnz, void* casc, void* ov, void* out_rows, void* out_cols,
    void* out_vals, int64_t out_stride, void* splits, void* counts,
    void* offsets, void* rec, void* done, int64_t tiles, int fold,
    uint32_t zero_bits, int sm_count, int* launches, void* stream) {
  *launches = 0;
  if (n_layers < 1 || n_layers > kMaxLayers || n_instances < 1 ||
      sm_count < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  return d4m::by_value_type(dtype, [&](auto tag) {
    return launch<decltype(tag)>(
        n_instances, n_layers, b_rows, b_cols, b_vals, b_nnz, b_width, rows,
        cols, vals, widths, caps, cuts, nnz, casc, ov, out_rows, out_cols,
        out_vals, out_stride, splits, counts, offsets, rec, done, tiles, fold,
        zero_bits, sm_count, launches, st);
  });
}

extern "C" const char* hier_cascade_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
