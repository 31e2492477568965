// What the dense flash attention kernels share, on the CUDA cores
// (flash_attention.cu) and on the tensor cores (flash_mma.cu): the dropout
// hash, the dropout and shape arguments of a launch, the bias's layout.
#pragma once

#include "flash_tile.cuh"

namespace {

// `_hash_keep` of ops/attention.py, in uint32 arithmetic; `base` is
// seed * 0xC2B2AE3D + bh * 0x27D4EB2F
__device__ __forceinline__ bool hash_keep(uint32_t qpos, uint32_t kpos,
                                          uint32_t base, uint32_t thresh) {
  uint32_t x = qpos * 0x9E3779B1u + kpos * 0x85EBCA77u + base;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= thresh;
}

// q_off, k_off place the launch's rows and columns in the global sequence
// (JAX's SMEM triple [seed, q_off, k_off]): a chunk of a longer sequence
// then drops the entries of the dense mask that its positions select
struct Dropout {
  int on;
  uint32_t seed, thresh;
  float inv_keep;  // 1 / (1 - rate), as the JAX kernels scale
  uint32_t q_off, k_off;
  // whether the entry at local row `qpos`, local column `kpos` is kept
  __device__ __forceinline__ bool keep(uint32_t qpos, uint32_t kpos,
                                       uint32_t base) const {
    return hash_keep(qpos + q_off, kpos + k_off, base, thresh);
  }
};

// shapes of one launch: sq, sk rows; d the true head dim (the row stride);
// bsq, bsk the bias's (and d(bias)'s) rows and columns, sq and sk rounded
// up to whole 64-row tiles
struct Dims {
  int heads, sq, sk, d, bsq, bsk;
  Dims(int heads_, int sq_, int sk_, int d_)
      : heads(heads_), sq(sq_), sk(sk_), d(d_), bsq(tiles(sq_) * kB),
        bsk(tiles(sk_) * kB) {}
};

// row `qpos` of head `head` of the (heads, bsq, bsk) bias; null without one
template <bool HasBias>
__device__ __forceinline__ const float* bias_row(const float* bias, int head,
                                                 int qpos, const Dims& n) {
  if constexpr (HasBias)
    return bias + (static_cast<long>(head) * n.bsq + qpos) * n.bsk;
  else
    return nullptr;
}

}  // namespace
