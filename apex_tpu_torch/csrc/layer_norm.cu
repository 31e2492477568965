// LayerNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel apex_tpu/ops/layer_norm.py `_ln_fwd_kernel`
// (reached through `_ln_fwd`, pallas_call at layer_norm.py:191).
//
// Math: exactly `layer_norm_reference` (layer_norm.py:46-58), not Welford:
// fp32 sums of x and x*x, mean = sum/h, var = max(E[x^2] - mean^2, 0),
// rstd = rsqrt(var + eps), y = ((x - mean) * rstd) * w + b, cast to the
// input type. Serving needs no mean/rstd outputs, so none are written.
//
// Bound on this card: device memory. Each row is read once for the sums,
// then again (from L1/L2) for the output, and written once; the least
// traffic is 2 * rows * hidden * sizeof(T) bytes over 3.35 TB/s, and the
// arithmetic is a few operations per element.
//
// Design: one warp per row, four rows per 128-thread block, so any row
// count works (the TPU gate refused rows % 8 != 0, e.g. 4 decode slots).
// Loads and stores are 16-byte vectors (8 bf16 or 4 fp32 per lane), the
// row statistics are two warp shuffle reductions, and nothing goes
// through shared memory. hidden must be a multiple of the vector width.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
    layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ b, T* __restrict__ y,
                          int rows, int hidden, float eps) {
  constexpr int N = apex::Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + row * hidden;
  T* yr = y + row * hidden;
  const int nvec = hidden / N;

  float s = 0.f, ss = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    float f[N];
    apex::load_vec(xr + v * N, f);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s += f[i];
      ss += f[i] * f[i];
    }
  }
  s = apex::warp_sum(s);
  ss = apex::warp_sum(ss);
  const float mean = s / hidden;
  const float var = fmaxf(ss / hidden - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);

  for (int v = lane; v < nvec; v += 32) {
    float f[N], wf[N], bf[N], o[N];
    apex::load_vec(xr + v * N, f);
    apex::load_vec(w + v * N, wf);
    apex::load_vec(b + v * N, bf);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = (f[i] - mean) * rstd * wf[i] + bf[i];
    apex::store_vec(yr + v * N, o);
  }
}

}  // namespace

// On CUDA device `device`, on `stream`:
// x, y: (rows, hidden) contiguous; w, b: (hidden,); all of one type
// (is_bf16 ? bf16 : fp32), 16-byte aligned, hidden % (16/sizeof(T)) == 0.
extern "C" int layer_norm_fwd(int device, const void* x, const void* w,
                              const void* b, void* y, int rows, int hidden,
                              float eps, int is_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (rows > 0) {
    const dim3 grid((rows + kWarps - 1) / kWarps), block(32 * kWarps);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
      using T = __nv_bfloat16;
      layer_norm_fwd_kernel<T><<<grid, block, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const T*>(b), static_cast<T*>(y), rows, hidden, eps);
    } else {
      layer_norm_fwd_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const float*>(b), static_cast<float*>(y), rows, hidden,
          eps);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
