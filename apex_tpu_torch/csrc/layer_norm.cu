// LayerNorm forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of apex_tpu/ops/layer_norm.py:
//   * `_ln_fwd_kernel` (reached through `_ln_fwd`, pallas_call at :191);
//   * `_ln_bwd_kernel` (reached through `_layer_norm_affine_bwd`,
//     pallas_call at :224).
//
// Forward math: exactly `layer_norm_reference` (layer_norm.py:46-58), not
// Welford: fp32 sums of x and x*x, mean = sum/h, var = max(E[x^2] -
// mean^2, 0), rstd = rsqrt(var + eps), y = ((x - mean) * rstd) * w + b,
// cast to the input type. mean and rstd (fp32, one per row) are written
// only when the caller passes pointers for them (training); serving passes
// null.
//
// Backward math (`_ln_bwd_kernel`, :87-112), all in fp32:
//   xhat = (x - mean) * rstd, g = dy * w,
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),
//   dw = sum over rows of dy * xhat, db = sum over rows of dy.
//
// Bound on this card: device memory. Forward: read x, write y (2 * rows *
// hidden * sizeof(T)); backward: read dy and x, write dx (3 * rows * hidden
// * sizeof(T)). The arithmetic is a few operations per element.
//
// Design: one warp per row, four rows per 128-thread block, so any row
// count works (the TPU gate refused rows % 8 != 0). Loads and stores are
// 16-byte vectors (8 bf16 or 4 fp32 per lane), the row statistics are warp
// shuffle reductions. hidden must be a multiple of the vector width.
//
// dw/db without atomics: the TPU kernel summed them across its sequential
// grid into one output block. Here blocks run in parallel, so the sum is
// two-stage and deterministic. Stage 1: block p owns the fixed rows
// [p * rows_per_part, (p + 1) * rows_per_part); each of its warps adds its
// rows (warp, warp + 4, ...) into its own shared-memory row of fp32
// partials, the block then adds its four warp rows in order and writes one
// row of a (parts, hidden) fp32 workspace. Stage 2: one thread per column
// adds the parts in order 0..parts-1 and writes dw/db in the weight's type.
// The same input gives bitwise the same dw/db on every run.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
    layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ b, T* __restrict__ y,
                          float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int rows, int hidden,
                          float eps) {
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
  if (lane == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }

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

// Stage 1 of the backward: dx for the block's rows, and the block's fp32
// partial dw/db rows. Dynamic shared memory: 2 * kWarps * hidden floats.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
    layer_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const T* __restrict__ w, T* __restrict__ dx,
                          float* __restrict__ part_dw,
                          float* __restrict__ part_db, int rows, int hidden,
                          int rows_per_part) {
  constexpr int N = apex::Vec<T>::N;
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* my_dw = smem + warp * hidden;
  float* my_db = smem + (kWarps + warp) * hidden;
  const int nvec = hidden / N;
  // zeroed with the accumulation's own mapping (lane owns the columns of
  // vectors v = lane, lane + 32, ...), so each lane touches only its own
  // columns of its warp's rows: no barrier is needed until the block-wide
  // sum below
  for (int v = lane; v < nvec; v += 32) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      my_dw[v * N + i] = 0.f;
      my_db[v * N + i] = 0.f;
    }
  }
  const long first = static_cast<long>(blockIdx.x) * rows_per_part;
  long last = first + rows_per_part;
  if (last > rows) last = rows;
  const float inv_h = 1.f / hidden;
  for (long row = first + warp; row < last; row += kWarps) {
    const T* dyr = dy + row * hidden;
    const T* xr = x + row * hidden;
    const float mu = mean[row], rs = rstd[row];
    float c1 = 0.f, c2 = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      float fdy[N], fx[N], fw[N];
      apex::load_vec(dyr + v * N, fdy);
      apex::load_vec(xr + v * N, fx);
      apex::load_vec(w + v * N, fw);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float g = fdy[i] * fw[i];
        c1 += g;
        c2 += g * ((fx[i] - mu) * rs);
      }
    }
    c1 = apex::warp_sum(c1) * inv_h;
    c2 = apex::warp_sum(c2) * inv_h;
    T* dxr = dx + row * hidden;
    for (int v = lane; v < nvec; v += 32) {
      float fdy[N], fx[N], fw[N], o[N];
      apex::load_vec(dyr + v * N, fdy);
      apex::load_vec(xr + v * N, fx);
      apex::load_vec(w + v * N, fw);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xhat = (fx[i] - mu) * rs;
        const float g = fdy[i] * fw[i];
        o[i] = (g - c1 - xhat * c2) * rs;
        my_dw[v * N + i] += fdy[i] * xhat;
        my_db[v * N + i] += fdy[i];
      }
      apex::store_vec(dxr + v * N, o);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < hidden; c += 32 * kWarps) {
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      sw += smem[k * hidden + c];
      sb += smem[(kWarps + k) * hidden + c];
    }
    part_dw[static_cast<long>(blockIdx.x) * hidden + c] = sw;
    part_db[static_cast<long>(blockIdx.x) * hidden + c] = sb;
  }
}

// Stage 2: dw[c] = sum over parts in order; written in the weight's type.
template <typename T>
__global__ void layer_norm_bwd_reduce_kernel(const float* __restrict__ part_dw,
                                             const float* __restrict__ part_db,
                                             T* __restrict__ dw,
                                             T* __restrict__ db, int parts,
                                             int hidden) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= hidden) return;
  float sw = 0.f, sb = 0.f;
  for (int p = 0; p < parts; ++p) {
    sw += part_dw[static_cast<long>(p) * hidden + c];
    sb += part_db[static_cast<long>(p) * hidden + c];
  }
  apex::from_f(sw, dw + c);
  apex::from_f(sb, db + c);
}

template <typename T>
int launch_bwd(const void* dy, const void* x, const void* mean,
               const void* rstd, const void* w, void* dx, void* dw, void* db,
               void* workspace, int rows, int hidden, int parts,
               cudaStream_t s) {
  const size_t smem = 2 * kWarps * static_cast<size_t>(hidden) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        layer_norm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows_per_part = (rows + parts - 1) / parts;
  float* part_dw = static_cast<float*>(workspace);
  float* part_db = part_dw + static_cast<long>(parts) * hidden;
  layer_norm_bwd_kernel<T><<<parts, 32 * kWarps, smem, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(w), static_cast<T*>(dx), part_dw, part_db, rows,
      hidden, rows_per_part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  layer_norm_bwd_reduce_kernel<T><<<(hidden + 127) / 128, 128, 0, s>>>(
      part_dw, part_db, static_cast<T*>(dw), static_cast<T*>(db), parts,
      hidden);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// On CUDA device `device`, on `stream`:
// x, y: (rows, hidden) contiguous; w, b: (hidden,); all of one type
// (is_bf16 ? bf16 : fp32), 16-byte aligned, hidden % (16/sizeof(T)) == 0.
// mean, rstd: (rows,) fp32, or both null when the statistics are not needed.
extern "C" int layer_norm_fwd(int device, const void* x, const void* w,
                              const void* b, void* y, void* mean, void* rstd,
                              int rows, int hidden, float eps, int is_bf16,
                              void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (rows > 0) {
    const dim3 grid((rows + kWarps - 1) / kWarps), block(32 * kWarps);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* m = static_cast<float*>(mean);
    float* r = static_cast<float*>(rstd);
    if (is_bf16) {
      using T = __nv_bfloat16;
      layer_norm_fwd_kernel<T><<<grid, block, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<const T*>(b), static_cast<T*>(y), m, r, rows, hidden,
          eps);
    } else {
      layer_norm_fwd_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const float*>(b), static_cast<float*>(y), m, r, rows,
          hidden, eps);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// dy, x, dx: (rows, hidden); w, dw, db: (hidden,); one type as above.
// mean, rstd: (rows,) fp32 from the forward. workspace: 2 * parts * hidden
// fp32 (the partial dw and db rows); parts >= 1 blocks each own
// ceil(rows / parts) consecutive rows.
extern "C" int layer_norm_bwd(int device, const void* dy, const void* x,
                              const void* mean, const void* rstd,
                              const void* w, void* dx, void* dw, void* db,
                              void* workspace, int rows, int hidden,
                              int parts, int is_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(dy, x, mean, rstd, w, dx, dw, db,
                                     workspace, rows, hidden, parts, s);
  return launch_bwd<float>(dy, x, mean, rstd, w, dx, dw, db, workspace, rows,
                           hidden, parts, s);
}
