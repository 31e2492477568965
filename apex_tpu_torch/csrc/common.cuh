// Helpers shared by the port's kernels: 16-byte vector loads and stores
// with fp32 conversion, warp and block reductions, and the error-string
// entry every kernel library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace apex {

// Finite stand-in for -inf (ops/attention.py NEG_INF): exp() of it is an
// exact 0 and (-1e30) - (-1e30) is no NaN.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
// round to nearest even, as torch's and XLA's casts do
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_f(float v, __half* out) {
  *out = __float2half_rn(v);
}

// The input-type code of the C entries (ops/_kernel_util.py
// `dtype_code`): 0 fp32, 1 bf16, 2 fp16
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

// elements of T in one 16-byte vector
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// p must be 16-byte aligned
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) from_f(in[i], &e[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions for a block of WARPS warps; every thread gets the
// result. `red` is WARPS floats of shared memory; the leading barrier
// keeps a previous call's readers ahead of this call's writers.
template <int WARPS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r += red[i];
  return r;
}

template <int WARPS>
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = fmaxf(r, red[i]);
  return r;
}

}  // namespace apex

// Runs the statement given with the type name T bound to the element type
// of `code` (apex::kF32, kBF16 or kF16); `otherwise` for any other code
#define APEX_TYPE_SWITCH(code, T, otherwise, ...) \
  switch (code) {                                 \
    case apex::kF32: {                            \
      using T = float;                            \
      __VA_ARGS__;                                \
    } break;                                      \
    case apex::kBF16: {                           \
      using T = __nv_bfloat16;                    \
      __VA_ARGS__;                                \
    } break;                                      \
    case apex::kF16: {                            \
      using T = __half;                           \
      __VA_ARGS__;                                \
    } break;                                      \
    default:                                      \
      otherwise;                                  \
  }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
