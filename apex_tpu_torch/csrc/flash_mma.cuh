// Tensor-core tile code for bf16 and fp16 kernels (the attention kernels
// of flash_mma.cu and flash_varlen_mma.cu, the LM-head of lm_head_mma.cu;
// bf16 only in the serving kernels): warp-level mma.sync.m16n8k16 products
// with fp32 accumulation, operands loaded from shared memory by ldmatrix,
// tiles filled by 16-byte cp.async copies.
//
// Layout. A tile is kB = 64 rows of D elements E, bf16 or fp16 (D = 32, 64,
// 128 or 256, the instantiated head dim; the true head dim d, a multiple of 8
// up to D, is the row stride in device memory). In shared memory a row takes
// kStride<D> = D + 8 elements: the 16 bytes of padding put the 8 rows that one
// ldmatrix reads at one column on 8 different 16-byte bank groups, so its
// reads are conflict-free at every D. Columns d..D-1 and the rows past the end
// of a sequence are zero-filled by the copy (src-size 0), so products over D
// equal those over d.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16 or .f16): a lane l of a
// warp holds, with g = l / 4 and t = l % 4,
//   A (16 x 16, row-major): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..2t+1),
//                           a2 = (g, 2t+8..2t+9), a3 = (g+8, 2t+8..2t+9);
//   B (16 x 8, k x n):      b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g);
//   C (16 x 8, fp32):       c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// Two C tiles side by side (16 x 16 of fp32) are, packed to E pairs, the
// A fragment of the next product over those 16 columns (the P @ V step),
// with no data movement between lanes.
#pragma once

#include "flash_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int D>
constexpr int kStride = D + 8;  // shared-memory elements a tile row takes

template <int D>
constexpr int tile_bytes = kB * kStride<D> * 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, asynchronously; `fill`
// false writes 16 zero bytes and reads nothing (src must still be a valid
// address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 matrices of a 16-bit type; lane l gives the row address of
// matrix l / 8
template <typename E>
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const E* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

template <typename E>
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const E* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on the tensor cores, a and b of E, fp32 accumulation
template <typename E>
__device__ __forceinline__ void mma16(float c[4], const uint32_t a[4],
                                      uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16<bf16>(float c[4], const uint32_t a[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16<__half>(float c[4],
                                              const uint32_t a[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest even to E and packed, lo in the low half
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Start copying `rows` rows (1 <= rows <= kB) of d columns of E, row
// stride d, into a (kB, D) tile; rows past `rows` and columns past d
// become zeros. Every copy reads from an address clamped into the source,
// so none reads past it. The caller commits the group.
template <int D, typename E>
__device__ __forceinline__ void tile_async(E* dst, const E* src,
                                           int rows, int d, int tid,
                                           int nthreads) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks a row
  for (int u = tid; u < kB * CHUNKS; u += nthreads) {
    const int row = u / CHUNKS, c = (u % CHUNKS) * 8;
    const E* from = src + static_cast<long>(min(row, rows - 1)) * d +
                       min(c, d - 8);
    cp_async16(dst + row * kStride<D> + c, from, row < rows && c < d);
  }
}

// Start copying `rows` fp32 values (rows a multiple of 4) into 64, zeros
// past `rows`; the 16 threads with 0 <= tid < 16 do it
__device__ __forceinline__ void rows_async(float* dst, const float* src,
                                           int rows, int tid) {
  if (static_cast<unsigned>(tid) < kB / 4) {
    const int i = 4 * tid;
    cp_async16(dst + i, src + (i < rows ? i : 0), i < rows);
  }
}

// The A fragment of rows r0..r0+15, columns c0..c0+15 of a tile
template <int D, typename E>
__device__ __forceinline__ void load_a(uint32_t a[4], const E* tile,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * kStride<D> + c0 +
                     (lane >> 4) * 8);
}

// B fragments of the product with the transpose of tile rows n0..n0+15
// (two n-blocks of 8) over columns c0..c0+15: (b[0], b[1]) for rows
// n0..n0+7, (b[2], b[3]) for n0+8..n0+15 (S = Q K^T with K the tile)
template <int D, typename E>
__device__ __forceinline__ void load_bt(uint32_t b[4], const E* tile,
                                        int n0, int c0, int lane) {
  ldmatrix_x4(b, tile + (n0 + ((lane >> 4) << 3) + (lane & 7)) * kStride<D> +
                     c0 + ((lane >> 3) & 1) * 8);
}

// B fragments of the product with tile rows k0..k0+15 (the k dim) over
// columns n0..n0+15 (two n-blocks of 8): (b[0], b[1]) for columns
// n0..n0+7, (b[2], b[3]) for n0+8..n0+15 (O = P V with V the tile)
template <int D, typename E>
__device__ __forceinline__ void load_b(uint32_t b[4], const E* tile,
                                       int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 15)) * kStride<D> + n0 +
                           (lane >> 4) * 8);
}

// The A fragment of columns 16j..16j+15 of a warp's 16-row fp32
// accumulator s[n-block][4], rounded to E
template <int NB, typename E = bf16>
__device__ __forceinline__ void acc_to_a(uint32_t a[4],
                                         const float (&s)[NB][4], int j) {
  a[0] = pack2<E>(s[2 * j][0], s[2 * j][1]);
  a[1] = pack2<E>(s[2 * j][2], s[2 * j][3]);
  a[2] = pack2<E>(s[2 * j + 1][0], s[2 * j + 1][1]);
  a[3] = pack2<E>(s[2 * j + 1][2], s[2 * j + 1][3]);
}

// s = rows r0..r0+15 of tile `a` times the transpose of tile `b`'s 64
// rows, over D columns (a warp's 16 x 64 of S = Q K^T, dP = dO V^T); the
// products of each element summed in ascending column order
template <int D, typename E>
__device__ __forceinline__ void mma_abt(float (&s)[kB / 8][4],
                                        const E* a, int r0,
                                        const E* b, int lane) {
#pragma unroll
  for (int j = 0; j < kB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 16) {
    uint32_t af[4];
    load_a<D>(af, a, r0, c, lane);
#pragma unroll
    for (int j = 0; j < kB / 8; j += 2) {
      uint32_t bf[4];
      load_bt<D>(bf, b, j * 8, c, lane);
      mma16<E>(s[j], af, bf[0], bf[1]);
      mma16<E>(s[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc += round_E(p) times the 64 rows of `tile`, over its columns c0
// .. c0 + 8 NC - 1 (a warp's O += P V, dQ += dS K); p is the warp's 16 x
// 64 fp32 accumulator, the keys in ascending order
template <int D, int NC, typename E>
__device__ __forceinline__ void mma_pv(float (&acc)[NC][4],
                                       const float (&p)[kB / 8][4],
                                       const E* tile, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) {
    uint32_t a[4];
    acc_to_a<kB / 8, E>(a, p, kk);
#pragma unroll
    for (int c = 0; c < NC; c += 2) {
      uint32_t b[4];
      load_b<D>(b, tile, kk * 16, c0 + c * 8, lane);
      mma16<E>(acc[c], a, b[0], b[1]);
      mma16<E>(acc[c + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace
