// Tile code shared by the CUDA-core flash attention kernels
// (flash_attention.cu) and the packed variable-length ones
// (flash_varlen.cu).
//
// A tile is BR rows of one (batch*head) slice: kB = 64 up to D = 256, and
// above it BR = 16,384 / D (32 at D = 512, 16 at 1024, 8 at 2048), so two
// (BR, D) fp32 tiles keep to 128 KB of shared memory. The wrappers' 64-row
// unit stays (the bias padding, the varlen tile tables, the causal
// diagonal): a BR-row tile reads a half, a quarter or an eighth of a
// 64-row entry.
// K/V (or Q/dO) tiles are staged in shared memory as fp32, D floats a row,
// where D is the instantiated head dim (32, 64, 128, 256, 512, 1024 or
// 2048) and the
// true head dim d (a multiple of 8, at most D) is the row stride in device
// memory: columns d..D-1 and
// the rows past the end of a sequence are filled with zeros, so dot
// products over D equal those over d and nothing is read past the end. A
// row held in registers belongs to TPR = D / DPT neighbouring threads (at
// most a warp), each
// owning DPT of its dims in interleaved float4 chunks (h, h + TPR, ...), so
// the group's shared-memory reads are conflict-free broadcasts; dot
// products end with an xor-shuffle sum inside the group.
#pragma once

#include "common.cuh"

namespace {

constexpr int kB = 64;      // rows of the wrappers' tile unit
constexpr int kChunk = 16;  // keys per online-softmax update

// the instantiated head dim that runs head dim d (0: none)
inline int flash_head_dim(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256
         : d <= 512 ? 512 : d <= 1024 ? 1024 : d <= 2048 ? 2048 : 0;
}

// rows BR of a kernel tile at head dim D: two (BR, D) fp32 tiles take 128
// KB of shared memory from D = 256 (64 rows) to D = 2048 (8 rows)
__host__ __device__ constexpr int flash_tile_rows(int D) {
  return D >= 256 ? 16384 / D : kB;
}

// dims a forward, dQ or d(bias) thread holds of its row: 32, and 64 at D =
// 2048, so a row belongs to at most one warp (its sums are xor-shuffles)
__host__ __device__ constexpr int row_dims(int D) {
  return D == 2048 ? 64 : 32;
}

// threads of a forward, dQ or d(bias) block: 512 from D = 256 to 1024, 256
// at D = 2048
__host__ __device__ constexpr int row_threads(int D) {
  return flash_tile_rows(D) * (D / row_dims(D));
}

// dims a dK/dV thread holds of each of its four rows (k, v, dk, dv): 512
// threads from D = 512 to 1024 as at D = 256 (1,024 for dK/dV there), 256
// at D = 2048
__host__ __device__ constexpr int dkv_dims(int D) {
  return D == 2048 ? 64 : D >= 512 ? 32 : 16;
}

// keys per online-softmax update: kChunk, or the whole tile when it has
// fewer rows (BR = 8 at D = 2048)
__host__ __device__ constexpr int chunk_keys(int BR) {
  return BR < kChunk ? BR : kChunk;
}

// tiles of BR rows over n rows
template <int BR = kB>
__host__ __device__ inline int tiles(int n) {
  return (n + BR - 1) / BR;
}

// shared memory above the static 48 KB needs the kernel's opt-in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void load4(const __half* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __half* e = reinterpret_cast<const __half*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __half2float(e[i]);
}
__device__ __forceinline__ void store4(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* in) {
  uint2 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = __float2bfloat16_rn(in[i]);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(__half* p, const float* in) {
  uint2 raw;
  __half* e = reinterpret_cast<__half*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = __float2half_rn(in[i]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// the value after a cast to T and back (JAX casts p and ds before a dot)
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ float round_to<__half>(float v) {
  return __half2float(__float2half_rn(v));
}

// sum over the TPR neighbouring lanes that hold one row
template <int TPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy `rows` rows (1 <= rows <= BR) of `cols` columns of T (a multiple of
// 8, at most D), row stride `stride`, into a (BR, D) fp32 tile; the other
// rows and columns become zeros. Every load is made, from an address
// clamped into the tile, and zeroed by value: a load behind a branch
// cannot start ahead of the others.
template <typename T, int D, int BR>
__device__ __forceinline__ void stage_cols(float* dst, const T* src, int rows,
                                           int stride, int cols,
                                           int nthreads) {
  constexpr int N = apex::Vec<T>::N, PER_ROW = D / N;
  for (int u = threadIdx.x; u < BR * PER_ROW; u += nthreads) {
    const int row = u / PER_ROW, c = (u % PER_ROW) * N;
    float f[N];
    apex::load_vec(src + static_cast<long>(min(row, rows - 1)) * stride +
                       min(c, cols - N),
                   f);
    const bool in = row < rows && c < cols;
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = in ? f[e] : 0.f;
#pragma unroll
    for (int e = 0; e < N; e += 4) store4(dst + row * D + c + e, f + e);
  }
}

// stage_cols over a whole row of d columns (row stride d)
template <typename T, int D, int BR>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int rows,
                                           int d, int nthreads) {
  stage_cols<T, D, BR>(dst, src, rows, d, d, nthreads);
}

// dims of this thread: float4 chunks h, h + TPR, h + 2*TPR, ... of a row
template <int DPT, int TPR>
__device__ __forceinline__ float dot_part(const float* reg, const float* row,
                                          int h) {
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const float4 r4 = reinterpret_cast<const float4*>(row)[h + TPR * i];
    d += reg[4 * i] * r4.x + reg[4 * i + 1] * r4.y + reg[4 * i + 2] * r4.z +
         reg[4 * i + 3] * r4.w;
  }
  return d;
}

template <int DPT, int TPR>
__device__ __forceinline__ void axpy_part(float* acc, float a,
                                          const float* row, int h) {
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const float4 r4 = reinterpret_cast<const float4*>(row)[h + TPR * i];
    acc[4 * i] += a * r4.x;
    acc[4 * i + 1] += a * r4.y;
    acc[4 * i + 2] += a * r4.z;
    acc[4 * i + 3] += a * r4.w;
  }
}

// this thread's dims of a row of d columns; zeros past d (d = 0 for a row
// past the end of the sequence: nothing is read)
template <typename T, int DPT, int TPR>
__device__ __forceinline__ void load_row_part(const T* row, float* reg, int h,
                                              int d) {
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const int c = 4 * (h + TPR * i);
    if (c < d) {
      load4(row + c, reg + 4 * i);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) reg[4 * i + e] = 0.f;
    }
  }
}

template <typename T, int DPT, int TPR>
__device__ __forceinline__ void store_row_part(T* row, const float* reg,
                                               int h, int d) {
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const int c = 4 * (h + TPR * i);
    if (c < d) store4(row + c, reg + 4 * i);
  }
}

// The packed varlen kernels' block skipping (flash_varlen.cu,
// flash_varlen_mma.cu): JAX's `_skip`, negated. Can q tile qt and kv tile
// kt (both of BR rows) meet at all? qi and ki are the 64-row table entries
// (segment min, max, live lo, hi) that hold them.
template <int BR>
__device__ __forceinline__ bool tiles_meet(int4 qi, int4 ki, int qt, int kt,
                                           int causal) {
  const bool meet = !(qi.x > ki.y || qi.y < ki.x) && qi.y >= 0 && ki.y >= 0;
  return meet && (!causal || kt * BR <= qt * BR + BR - 1);
}

// after a launch: the launch's own error, else whatever the card reported
inline int status_of(cudaError_t launched) {
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}

// one case of the dispatch below: T, D and BR bound, the launch's status
// returned from the calling entry point
#define APEX_FLASH_CASE(CODE, TYPE, DIM, ...)                         \
  case CODE: {                                                        \
    using T = TYPE;                                                   \
    constexpr int D = DIM, BR = flash_tile_rows(DIM);                 \
    (void)BR;                                                         \
    return status_of(__VA_ARGS__);                                    \
  }

// runs the launch given, as written, with T and D bound to the input type
// (`dtype`: apex::kF32, kBF16 or kF16) and the instantiated head dim that
// takes d (BR to its tile rows), and returns its status from the calling
// entry point: fp32 at every D, bf16 and fp16 from D = 512 on (bf16 and
// fp16 inputs at d <= 256 run on the tensor cores, flash_mma.cu and
// flash_varlen_mma.cu); cudaErrorInvalidValue for the rest and for a d
// above 2048
#define APEX_FLASH_DISPATCH_CORE(...)                                 \
  do {                                                                \
    switch (dtype >= 0 && dtype <= 2 ? flash_head_dim(d) * 4 + dtype  \
                                     : 0) {                           \
      APEX_FLASH_CASE(128, float, 32, __VA_ARGS__)                    \
      APEX_FLASH_CASE(256, float, 64, __VA_ARGS__)                    \
      APEX_FLASH_CASE(512, float, 128, __VA_ARGS__)                   \
      APEX_FLASH_CASE(1024, float, 256, __VA_ARGS__)                  \
      APEX_FLASH_CASE(2048, float, 512, __VA_ARGS__)                  \
      APEX_FLASH_CASE(2049, __nv_bfloat16, 512, __VA_ARGS__)          \
      APEX_FLASH_CASE(2050, __half, 512, __VA_ARGS__)                 \
      APEX_FLASH_CASE(4096, float, 1024, __VA_ARGS__)                 \
      APEX_FLASH_CASE(4097, __nv_bfloat16, 1024, __VA_ARGS__)         \
      APEX_FLASH_CASE(4098, __half, 1024, __VA_ARGS__)                \
      APEX_FLASH_CASE(8192, float, 2048, __VA_ARGS__)                 \
      APEX_FLASH_CASE(8193, __nv_bfloat16, 2048, __VA_ARGS__)         \
      APEX_FLASH_CASE(8194, __half, 2048, __VA_ARGS__)                \
      default: return static_cast<int>(cudaErrorInvalidValue);        \
    }                                                                 \
  } while (0)

}  // namespace
