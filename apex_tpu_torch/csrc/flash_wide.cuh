// Tile code of the CUDA-core flash and varlen kernels above head dim 2048
// (flash_attention.cu, flash_varlen.cu): any d % 8 == 0, as JAX's kernel
// takes, with no upper limit.
//
// The head dim is cut into chunks of kWideCols = 2048 columns, the widest
// the D = 2048 instantiation stages: a tile is kWideRows = 8 rows of one
// chunk, 64 KB of fp32, a row held by one warp (32 lanes of 64 dims, as at
// D = 2048). A score s = q . k and dP = dO . v are sums over the whole head
// dim, so a block forms them chunk by chunk: it stages chunk c of the 8
// key (or query) rows, each thread adds its 64 dims of the other operand's
// row, read from device memory, to one fp32 partial per tile row, and
// after the last chunk the row's 32 lanes sum their partials. The chunks
// are summed in order and their boundaries are a function of d alone, so
// a result is the same bits on every launch. An output with a head-dim
// axis (o, dQ, dK, dV) has one owner block per (tile, batch*head, chunk):
// it forms the scores over every chunk and accumulates its own chunk of
// columns, so the kernel does about (chunks + 1) times the operations of
// one pass. No configuration of the repo uses a head dim above 256: these
// kernels are simple and right, not fast.
#pragma once

#include "flash_tile.cuh"

namespace {

// columns of a head-dim chunk; a wider head dim runs the wide kernels
constexpr int kWideCols = 2048;
constexpr int kWideRows = 8;     // rows of a tile
constexpr int kWideDims = 64;    // dims of a chunk row one thread holds
constexpr int kWideLanes = kWideCols / kWideDims;  // 32: a row is a warp
constexpr int kWideThreads = kWideRows * kWideLanes;
// one (kWideRows, kWideCols) fp32 tile
constexpr int kWideTileBytes = kWideRows * kWideCols * 4;

// columns of the chunk starting at column c0 of a head dim d
__device__ __forceinline__ int wide_cols(int d, int c0) {
  return min(kWideCols, d - c0);
}

// chunks of a head dim d
__host__ __device__ inline int wide_chunks(int d) {
  return (d + kWideCols - 1) / kWideCols;
}

// acc[j] += this thread's dims of (row . tile row j), j < kWideRows, over
// the chunk's `cols` columns (0 for a row past the end: nothing is read);
// `row` points to the chunk's first column in device memory
template <typename T>
__device__ __forceinline__ void dots_part(float (&acc)[kWideRows],
                                          const T* row, int cols,
                                          const float* tile, int lane) {
#pragma unroll
  for (int i = 0; i < kWideDims / 4; ++i) {
    const int c = 4 * (lane + kWideLanes * i);
    if (c < cols) {
      float r[4];
      load4(row + c, r);
#pragma unroll
      for (int j = 0; j < kWideRows; ++j) {
        const float4 t4 =
            *reinterpret_cast<const float4*>(tile + j * kWideCols + c);
        acc[j] += r[0] * t4.x + r[1] * t4.y + r[2] * t4.z + r[3] * t4.w;
      }
    }
  }
}

// For each of NP pairs p: out[p][j] = row[p] . (row j of tile[p]) over the
// whole head dim d, j < kWideRows (tile[p]: `rows` rows of row stride d
// from its first row; rows past `rows` give 0). Chunk by chunk, tile[p]'s
// chunk is staged in buf[p] (one kWideTileBytes tile each) and summed in
// chunk order, then over the row's lanes: every lane gets the sums. Every
// thread of the block calls it; it syncs the block around each staging,
// and on return buf[p] holds the last chunk.
template <typename T, int NP>
__device__ __forceinline__ void wide_dots(float (&out)[NP][kWideRows],
                                          const T* const (&row)[NP],
                                          bool row_valid,
                                          const T* const (&tile)[NP],
                                          int rows, int d,
                                          float* const (&buf)[NP],
                                          int lane) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < kWideRows; ++j) out[p][j] = 0.f;
  for (int c0 = 0; c0 < d; c0 += kWideCols) {
    const int cols = wide_cols(d, c0);
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int p = 0; p < NP; ++p)
      stage_cols<T, kWideCols, kWideRows>(buf[p], tile[p] + c0, rows, d, cols,
                                          kWideThreads);
    __syncthreads();
#pragma unroll
    for (int p = 0; p < NP; ++p)
      dots_part<T>(out[p], row[p] + c0, row_valid ? cols : 0, buf[p], lane);
  }
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < kWideRows; ++j)
      out[p][j] = group_sum<kWideLanes>(out[p][j]);
}

// Stage chunk c0 of `rows` rows (row stride d) of each of NP sources into
// buf[p], unless wide_dots left it there (the last chunk); syncs around it
template <typename T, int NP>
__device__ __forceinline__ void wide_restage(float* const (&buf)[NP],
                                             const T* const (&src)[NP],
                                             int rows, int d, int c0) {
  if (c0 + kWideCols >= d) return;  // the last chunk: already staged
  __syncthreads();
#pragma unroll
  for (int p = 0; p < NP; ++p)
    stage_cols<T, kWideCols, kWideRows>(buf[p], src[p] + c0, rows, d,
                                        kWideCols, kWideThreads);
  __syncthreads();
}

// returns FN<T>(args...)'s status from the calling entry point, T the
// input type (`dtype`: apex::kF32, kBF16 or kF16)
#define APEX_WIDE_DISPATCH_T(FN, ...)                                     \
  do {                                                                    \
    APEX_TYPE_SWITCH(dtype, T,                                            \
                     return static_cast<int>(cudaErrorInvalidValue),      \
                     return status_of(FN<T>(__VA_ARGS__)));               \
  } while (0)

}  // namespace
