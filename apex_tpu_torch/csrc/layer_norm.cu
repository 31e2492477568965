// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of apex_tpu/ops/layer_norm.py:
//   * `_ln_fwd_kernel` (reached through `_ln_fwd`, pallas_call at :191);
//   * `_ln_bwd_kernel` (reached through `_layer_norm_affine_bwd`,
//     pallas_call at :224);
//   * `_rms_fwd_kernel` (reached through `_rms_fwd`, pallas_call at :262);
//   * `_rms_bwd_kernel` (reached through `_rms_norm_affine_bwd`,
//     pallas_call at :292).
//
// Types: x, y, dy and dx are T; the weight, the bias, dw and db are TW;
// each fp32 or bf16 on its own (JAX's `FusedLayerNorm` and `MixedFused*`
// make fp32 params for a bf16 model). Everything is computed in fp32.
//
// LayerNorm forward: exactly `layer_norm_reference` (layer_norm.py:46-58),
// not Welford: fp32 sums of x and x*x, mean = sum/h, var = max(E[x^2] -
// mean^2, 0), rstd = rsqrt(var + eps), y = ((x - mean) * rstd) * w + b.
// RMSNorm forward (`_rms_fwd_kernel`, :115-121): rstd = rsqrt(sum(x*x)/h +
// eps), y = (x * rstd) * w. The fp32 row statistics (mean and rstd, or
// rstd) are written only when the caller passes pointers for them
// (training); serving passes null.
//
// Backward, all in fp32, from the saved statistics: xhat = (x - mean) *
// rstd (LayerNorm) or x * rstd (RMSNorm), g = dy * w,
//   LayerNorm (`_ln_bwd_kernel`, :87-112):
//     dx = rstd * (g - mean(g) - xhat * mean(g * xhat)), db = sum dy;
//   RMSNorm (`_rms_bwd_kernel`, :124-138):
//     dx = rstd * (g - xhat * mean(g * xhat));
//   both: dw = sum over rows of dy * xhat.
//
// Bound on this card: device memory. Forward: read x, write y (2 * rows *
// hidden * sizeof(T)); backward: read dy and x, write dx (3 * rows *
// hidden * sizeof(T)). The arithmetic is a few operations per element.
//
// Design. Forward and dx: one warp per row, four rows per 128-thread
// block, so any row count works. Loads and stores are 16-byte vectors of
// T (8 bf16 or 4 fp32 per lane; the weight's N values of TW beside them),
// the row sums are warp shuffle reductions, and a row is read a second
// time (from the cache) to normalize it, so no register or shared memory
// grows with hidden. hidden must be a multiple of the vector width.
//
// dw/db without atomics: the TPU kernel summed them across its sequential
// grid into one output block. Here blocks run in parallel, so the sum is
// two-stage and deterministic, and needs no row statistic but the saved
// mean/rstd. Stage 1 (`norm_bwd_part_kernel`): block (p, c) owns the
// fixed rows [p * rows_per_part, (p + 1) * rows_per_part) and one 16-byte
// column vector per thread of column tile c; each thread walks its rows in
// order, summing dy * xhat (and dy) in registers, and writes its columns
// of row p of a (parts, hidden) fp32 workspace. Stage 2
// (`norm_bwd_reduce_kernel`): one thread per column adds the parts in
// order 0..parts-1 and writes dw/db in the weight's type. Neither stage's
// memory grows with hidden, so every width JAX's gate admits runs (its
// 8-row blocks take hidden up to 37,449), and the same input gives bitwise
// the same dw/db on every run.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;      // rows of a forward / dx block
constexpr int kPartCols = 128;  // threads (column vectors) of a stage-1 block

// N consecutive values of TW (the weight) at p as fp32; p is aligned to
// N * sizeof(TW) bytes (a multiple of 8)
template <typename TW, int N>
__device__ __forceinline__ void load_n(const TW* p, float* out) {
  if constexpr (N * sizeof(TW) >= 16) {
#pragma unroll
    for (int c = 0; c < N; c += apex::Vec<TW>::N)
      apex::load_vec(p + c, out + c);
  } else {  // 8 bytes: 4 bf16 beside 4 fp32 of x
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const TW* e = reinterpret_cast<const TW*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = apex::to_f(e[i]);
  }
}

// ---------------------------------------------------------------------------
// forward

template <typename T, typename TW, bool RMS>
__global__ void __launch_bounds__(32 * kWarps)
    norm_fwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                    const TW* __restrict__ b, T* __restrict__ y,
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
      if (!RMS) s += f[i];
      ss += f[i] * f[i];
    }
  }
  ss = apex::warp_sum(ss);
  float mean = 0.f, rstd;
  if constexpr (RMS) {
    rstd = rsqrtf(ss / hidden + eps);
  } else {
    s = apex::warp_sum(s);
    mean = s / hidden;
    const float var = fmaxf(ss / hidden - mean * mean, 0.f);
    rstd = rsqrtf(var + eps);
  }
  if (lane == 0 && rstd_out != nullptr) {
    if (!RMS) mean_out[row] = mean;
    rstd_out[row] = rstd;
  }

  for (int v = lane; v < nvec; v += 32) {
    float f[N], wf[N], bf[N], o[N];
    apex::load_vec(xr + v * N, f);
    load_n<TW, N>(w + v * N, wf);
    if (!RMS) load_n<TW, N>(b + v * N, bf);
#pragma unroll
    for (int i = 0; i < N; ++i)
      o[i] = RMS ? (f[i] * rstd) * wf[i]
                 : (f[i] - mean) * rstd * wf[i] + bf[i];
    apex::store_vec(yr + v * N, o);
  }
}

// ---------------------------------------------------------------------------
// backward, dx: one warp per row

template <typename T, typename TW, bool RMS>
__global__ void __launch_bounds__(32 * kWarps)
    norm_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const TW* __restrict__ w, T* __restrict__ dx, int rows,
                       int hidden) {
  constexpr int N = apex::Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* dyr = dy + row * hidden;
  const T* xr = x + row * hidden;
  T* dxr = dx + row * hidden;
  const int nvec = hidden / N;
  const float mu = RMS ? 0.f : mean[row], rs = rstd[row];
  const float inv_h = 1.f / hidden;
  float c1 = 0.f, c2 = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    float fdy[N], fx[N], fw[N];
    apex::load_vec(dyr + v * N, fdy);
    apex::load_vec(xr + v * N, fx);
    load_n<TW, N>(w + v * N, fw);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float g = fdy[i] * fw[i];
      if (!RMS) c1 += g;
      c2 += g * ((fx[i] - mu) * rs);
    }
  }
  c1 = RMS ? 0.f : apex::warp_sum(c1) * inv_h;
  c2 = apex::warp_sum(c2) * inv_h;
  for (int v = lane; v < nvec; v += 32) {
    float fdy[N], fx[N], fw[N], o[N];
    apex::load_vec(dyr + v * N, fdy);
    apex::load_vec(xr + v * N, fx);
    load_n<TW, N>(w + v * N, fw);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xhat = (fx[i] - mu) * rs;
      const float g = fdy[i] * fw[i];
      o[i] = RMS ? (g - xhat * c2) * rs : (g - c1 - xhat * c2) * rs;
    }
    apex::store_vec(dxr + v * N, o);
  }
}

// Stage 1 of dw/db: block (p, c) sums the rows of part p over its column
// vectors (thread t: vector c * kPartCols + t) in row order, in registers,
// and writes row p of the fp32 partial rows (db's only for LayerNorm).
template <typename T, bool RMS>
__global__ void __launch_bounds__(kPartCols)
    norm_bwd_part_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         float* __restrict__ part_dw,
                         float* __restrict__ part_db, int rows, int hidden,
                         int rows_per_part) {
  constexpr int N = apex::Vec<T>::N;
  const int vec = blockIdx.y * kPartCols + threadIdx.x;
  if (vec >= hidden / N) return;
  const long first = static_cast<long>(blockIdx.x) * rows_per_part;
  long last = first + rows_per_part;
  if (last > rows) last = rows;
  float sw[N], sb[N];
#pragma unroll
  for (int i = 0; i < N; ++i) sw[i] = sb[i] = 0.f;
#pragma unroll 4
  for (long row = first; row < last; ++row) {
    float fdy[N], fx[N];
    apex::load_vec(dy + row * hidden + vec * N, fdy);
    apex::load_vec(x + row * hidden + vec * N, fx);
    const float mu = RMS ? 0.f : mean[row], rs = rstd[row];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      sw[i] += fdy[i] * ((fx[i] - mu) * rs);
      if (!RMS) sb[i] += fdy[i];
    }
  }
  const long out = static_cast<long>(blockIdx.x) * hidden + vec * N;
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    *reinterpret_cast<float4*>(part_dw + out + i) =
        make_float4(sw[i], sw[i + 1], sw[i + 2], sw[i + 3]);
    if (!RMS)
      *reinterpret_cast<float4*>(part_db + out + i) =
          make_float4(sb[i], sb[i + 1], sb[i + 2], sb[i + 3]);
  }
}

// Stage 2: dw[c] = sum over parts in order; written in the weight's type
// (db too, when part_db is not null).
template <typename TW>
__global__ void norm_bwd_reduce_kernel(const float* __restrict__ part_dw,
                                       const float* __restrict__ part_db,
                                       TW* __restrict__ dw,
                                       TW* __restrict__ db, int parts,
                                       int hidden) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= hidden) return;
  float sw = 0.f, sb = 0.f;
#pragma unroll 8
  for (int p = 0; p < parts; ++p) {
    sw += part_dw[static_cast<long>(p) * hidden + c];
    if (part_db != nullptr) sb += part_db[static_cast<long>(p) * hidden + c];
  }
  apex::from_f(sw, dw + c);
  if (part_db != nullptr) apex::from_f(sb, db + c);
}

template <typename T, typename TW, bool RMS>
int launch_fwd(const void* x, const void* w, const void* b, void* y,
               void* mean, void* rstd, int rows, int hidden, float eps,
               cudaStream_t s) {
  if (rows > 0)
    norm_fwd_kernel<T, TW, RMS>
        <<<(rows + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(
            static_cast<const T*>(x), static_cast<const TW*>(w),
            static_cast<const TW*>(b), static_cast<T*>(y),
            static_cast<float*>(mean), static_cast<float*>(rstd), rows,
            hidden, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW, bool RMS>
int launch_bwd(const void* dy, const void* x, const void* mean,
               const void* rstd, const void* w, void* dx, void* dw, void* db,
               void* workspace, int rows, int hidden, int parts,
               cudaStream_t s) {
  constexpr int N = apex::Vec<T>::N;
  float* part_dw = static_cast<float*>(workspace);
  float* part_db = RMS ? nullptr : part_dw + static_cast<long>(parts) * hidden;
  if (rows > 0) {
    norm_bwd_dx_kernel<T, TW, RMS>
        <<<(rows + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(
            static_cast<const T*>(dy), static_cast<const T*>(x),
            static_cast<const float*>(mean), static_cast<const float*>(rstd),
            static_cast<const TW*>(w), static_cast<T*>(dx), rows, hidden);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows_per_part = (rows + parts - 1) / parts;
  const int col_tiles = (hidden / N + kPartCols - 1) / kPartCols;
  norm_bwd_part_kernel<T, RMS><<<dim3(parts, col_tiles), kPartCols, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      part_dw, part_db, rows, hidden, rows_per_part);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  norm_bwd_reduce_kernel<TW><<<(hidden + 127) / 128, 128, 0, s>>>(
      part_dw, part_db, static_cast<TW*>(dw), static_cast<TW*>(db), parts,
      hidden);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// runs the call given with T (x's type) and TW (the weight's) bound
#define APEX_NORM_DISPATCH(...)                                        \
  do {                                                                 \
    using bf16 = __nv_bfloat16;                                        \
    if (x_bf16 && w_bf16) {                                            \
      using T = bf16; using TW = bf16; return __VA_ARGS__;             \
    } else if (x_bf16) {                                               \
      using T = bf16; using TW = float; return __VA_ARGS__;            \
    } else if (w_bf16) {                                               \
      using T = float; using TW = bf16; return __VA_ARGS__;            \
    } else {                                                           \
      using T = float; using TW = float; return __VA_ARGS__;           \
    }                                                                  \
  } while (0)

// On CUDA device `device`, on `stream`:
// x, y: (rows, hidden) contiguous, T = (x_bf16 ? bf16 : fp32); w, b:
// (hidden,), TW = (w_bf16 ? bf16 : fp32); 16-byte aligned, hidden %
// (16/sizeof(T)) == 0. mean, rstd: (rows,) fp32, or both null when the
// statistics are not needed.
extern "C" int layer_norm_fwd(int device, const void* x, const void* w,
                              const void* b, void* y, void* mean, void* rstd,
                              int rows, int hidden, float eps, int x_bf16,
                              int w_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_NORM_DISPATCH(launch_fwd<T, TW, false>(x, w, b, y, mean, rstd, rows,
                                              hidden, eps, s));
}

// As layer_norm_fwd, without a bias; rstd: (rows,) fp32 or null.
extern "C" int rms_norm_fwd(int device, const void* x, const void* w,
                            void* y, void* rstd, int rows, int hidden,
                            float eps, int x_bf16, int w_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_NORM_DISPATCH(launch_fwd<T, TW, true>(x, w, nullptr, y, nullptr, rstd,
                                             rows, hidden, eps, s));
}

// dy, x, dx: (rows, hidden) of T; w, dw, db: (hidden,) of TW; as above.
// mean, rstd: (rows,) fp32 from the forward. workspace: 2 * parts * hidden
// fp32 (the partial dw and db rows); parts >= 1 blocks of rows each own
// ceil(rows / parts) consecutive rows.
extern "C" int layer_norm_bwd(int device, const void* dy, const void* x,
                              const void* mean, const void* rstd,
                              const void* w, void* dx, void* dw, void* db,
                              void* workspace, int rows, int hidden,
                              int parts, int x_bf16, int w_bf16,
                              void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_NORM_DISPATCH(launch_bwd<T, TW, false>(dy, x, mean, rstd, w, dx, dw,
                                              db, workspace, rows, hidden,
                                              parts, s));
}

// As layer_norm_bwd without mean, db and db's half of the workspace
// (parts * hidden fp32).
extern "C" int rms_norm_bwd(int device, const void* dy, const void* x,
                            const void* rstd, const void* w, void* dx,
                            void* dw, void* workspace, int rows, int hidden,
                            int parts, int x_bf16, int w_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_NORM_DISPATCH(launch_bwd<T, TW, true>(dy, x, nullptr, rstd, w, dx, dw,
                                             nullptr, workspace, rows, hidden,
                                             parts, s));
}
