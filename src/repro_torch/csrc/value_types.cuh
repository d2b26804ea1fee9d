// The value-type codes the CUDA entry points take (kernels/_launch.py
// DTYPE_CODES: 0 float32, 1 bfloat16, 2 int32, 3 float16), and the dispatch
// from a code to its C++ type.  An unknown code is cudaErrorInvalidValue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace d4m {

// Runs f(T{}) for a float value type: float32, bfloat16 or float16.
template <typename F>
int by_float_type(int dtype, F f) {
  switch (dtype) {
    case 0:
      return f(float{});
    case 1:
      return f(__nv_bfloat16{});
    case 3:
      return f(__half{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Runs f(T{}) for any value type: the float types and int32.
template <typename F>
int by_value_type(int dtype, F f) {
  return dtype == 2 ? f(int32_t{}) : by_float_type(dtype, f);
}

}  // namespace d4m
