// hier_cascade: one packed streaming update step over K hierarchical
// associative arrays, one thread block per instance.
//
// Replaces the TPU kernel repro/kernels/hier_cascade/kernel.py:168
// (hier_cascade_pallas; body _cascade_kernel, merge _merge_canonical) and
// computes what it computes, bit for bit:
//   * layer 1 always merges the canonical batch (whose overflow the wrapper
//     has already OR-ed into layer 1's flag);
//   * layer i merges into layer i+1 only when nnz_i > cut_i, read after this
//     step's lower merges.  The branch is uniform across the block: that is
//     the lane skip, and a lane whose cuts do not fire touches no upper
//     layer;
//   * a fired merge clears the source (PAD keys, semiring-zero values,
//     nnz 0, overflow false), adds one to cascades[i+1] and sets
//     overflow[i+1] |= overflow[i] | merge_overflow;
//   * merges fold equal keys as sr.add(dst, src) and truncate to the layer's
//     true capacity (d4m::merge_into, merge.cuh).
//
// What bounds it: bytes.  A step without cascades must read the live prefix
// of layer 1 and the batch's live entries and write the merged layer 1 back;
// it does almost no arithmetic.  The design moves only those live prefixes
// (never the dead tails of the layer buffers, which need no power-of-two
// padding here: a layer's width is only its row stride), merges in place so
// the state is not doubled by a destination copy, and skips every upper
// layer whose cut does not fire.  One block per instance fills only K of the
// card's SMs, and each element's binary searches are latency-bound: this is
// the simple first design, measured in PERF.md.
#include <cuda_runtime.h>

#include <cstdint>

#include "merge.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLayers = 8;

struct CascadeParams {
  int32_t* rows[kMaxLayers];
  int32_t* cols[kMaxLayers];
  float* vals[kMaxLayers];
  int64_t width[kMaxLayers];  // buffer width of each layer (row stride)
  int64_t cap[kMaxLayers];    // true telescoped capacity
  int64_t cut[kMaxLayers];    // cut of layers 0 .. L-2
  const int32_t* b_rows;      // canonical batch [K, b_width]
  const int32_t* b_cols;
  const float* b_vals;
  const int32_t* b_nnz;  // [K]
  int64_t b_width;
  int32_t* nnz;   // [K, L]
  int32_t* casc;  // [K, L]
  uint8_t* ov;    // [K, L] bool
  int32_t* scratch;  // [K, scratch_stride]
  int64_t scratch_stride;
  int64_t scratch_half;  // offset of uniq[] inside one instance's scratch
  int n_layers;
  int fold;
  float zero;
};

__global__ void __launch_bounds__(kThreads)
    hier_cascade_kernel(const CascadeParams p) {
  __shared__ d4m::MergeShared<kThreads> sh;
  __shared__ int32_t s_nnz[kMaxLayers];
  __shared__ int32_t s_casc[kMaxLayers];
  __shared__ uint8_t s_ov[kMaxLayers];

  const int64_t k = blockIdx.x;
  const int L = p.n_layers;
  const int tid = threadIdx.x;
  if (tid < L) {
    s_nnz[tid] = p.nnz[k * L + tid];
    s_casc[tid] = p.casc[k * L + tid];
    s_ov[tid] = p.ov[k * L + tid];
  }
  __syncthreads();
  int32_t* rank = p.scratch + k * p.scratch_stride;
  int32_t* uniq = rank + p.scratch_half;

  // layer-1 insert: always runs
  {
    const int64_t off = k * p.width[0];
    const int64_t boff = k * p.b_width;
    const int64_t n = d4m::merge_into<kThreads>(
        p.rows[0] + off, p.cols[0] + off, p.vals[0] + off, s_nnz[0], p.cap[0],
        p.b_rows + boff, p.b_cols + boff, p.b_vals + boff, p.b_nnz[k], rank,
        uniq, p.fold, sh);
    if (tid == 0) {
      s_nnz[0] = static_cast<int32_t>(n < p.cap[0] ? n : p.cap[0]);
      s_ov[0] = s_ov[0] | (n > p.cap[0]);
    }
    __syncthreads();
  }

  // cascade: layer i -> i+1 only where this lane's cut fired
  for (int i = 0; i + 1 < L; ++i) {
    if (s_nnz[i] > p.cut[i]) {
      const int64_t so = k * p.width[i];
      const int64_t dof = k * p.width[i + 1];
      const int64_t ns = s_nnz[i];
      int32_t* src_r = p.rows[i] + so;
      int32_t* src_c = p.cols[i] + so;
      float* src_v = p.vals[i] + so;
      const int64_t cap = p.cap[i + 1];
      const int64_t n = d4m::merge_into<kThreads>(
          p.rows[i + 1] + dof, p.cols[i + 1] + dof, p.vals[i + 1] + dof,
          s_nnz[i + 1], cap, src_r, src_c, src_v, ns, rank, uniq, p.fold, sh);
      for (int64_t s = tid; s < ns; s += kThreads) {
        src_r[s] = d4m::kPad;
        src_c[s] = d4m::kPad;
        src_v[s] = p.zero;
      }
      if (tid == 0) {
        s_nnz[i + 1] = static_cast<int32_t>(n < cap ? n : cap);
        s_ov[i + 1] = s_ov[i + 1] | s_ov[i] | (n > cap);
        s_nnz[i] = 0;
        s_ov[i] = 0;
        s_casc[i + 1] += 1;
      }
      __syncthreads();
    }
  }

  if (tid < L) {
    p.nnz[k * L + tid] = s_nnz[tid];
    p.casc[k * L + tid] = s_casc[tid];
    p.ov[k * L + tid] = s_ov[tid];
  }
}

}  // namespace

extern "C" int hier_cascade_step(
    int n_instances, int n_layers, const void* b_rows, const void* b_cols,
    const void* b_vals, const void* b_nnz, int64_t b_width,
    void* const* rows, void* const* cols, void* const* vals,
    const int64_t* widths, const int64_t* caps, const int64_t* cuts,
    void* nnz, void* casc, void* ov, void* scratch, int64_t scratch_stride,
    int64_t scratch_half, int fold, float zero, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_instances < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CascadeParams p{};
  for (int i = 0; i < n_layers; ++i) {
    p.rows[i] = static_cast<int32_t*>(rows[i]);
    p.cols[i] = static_cast<int32_t*>(cols[i]);
    p.vals[i] = static_cast<float*>(vals[i]);
    p.width[i] = widths[i];
    p.cap[i] = caps[i];
    p.cut[i] = i + 1 < n_layers ? cuts[i] : 0;
  }
  p.b_rows = static_cast<const int32_t*>(b_rows);
  p.b_cols = static_cast<const int32_t*>(b_cols);
  p.b_vals = static_cast<const float*>(b_vals);
  p.b_nnz = static_cast<const int32_t*>(b_nnz);
  p.b_width = b_width;
  p.nnz = static_cast<int32_t*>(nnz);
  p.casc = static_cast<int32_t*>(casc);
  p.ov = static_cast<uint8_t*>(ov);
  p.scratch = static_cast<int32_t*>(scratch);
  p.scratch_stride = scratch_stride;
  p.scratch_half = scratch_half;
  p.n_layers = n_layers;
  p.fold = fold;
  p.zero = zero;
  hier_cascade_kernel<<<n_instances, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hier_cascade_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
