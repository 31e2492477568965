// Hidden dropout keyed by JAX's threefry-2x32, for Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX computes `_hidden_dropout`
// (apex_tpu/transformer/testing/standalone_gpt.py) in XLA as
// jax.random.bernoulli over threefry bits and a select. The port needs the
// same bits on the card: in plain PyTorch each element's 20 threefry rounds
// are over a hundred int64 elementwise launches.
//
// Per element j of the flat input (64-bit index):
//   (b0, b1) = threefry2x32(k0, k1; x0 = j >> 32, x1 = j & 0xffffffff)
//   keep     = ((b0 ^ b1) >> 9) < threshold        // JAX: uniform < fp32 p
//   y[j]     = keep ? x[j] * scale : 0              // rounded to x's type
// threshold = ceil(fp32(1 - rate) * 2^23) and scale (fp32, or already rounded
// to x's type for bf16 or fp16 x) come from the host (ops/dropout.py), so the
// bits, the mask and the products are JAX's exactly.
//
// Bound on this card: instruction issue. Each element needs at least ~71
// instructions (20 rounds of add / rotate / xor, the key injections a
// three-input add cannot absorb, the final xor, compare, product, select
// and the counter) against 4-8 bytes moved; at the SMs' issue rate (4 warp
// instructions a clock, 132 SMs, 1.98 GHz: 33.5 T/s) that is ~2.1 ms per
// G elements, against ~1.2-2.4 ms for the bytes at 3.35 TB/s. Integer
// adds issue on the FMA pipe too (IMAD), so the 64-lane integer pipe alone
// is no bound: on GPT-2's (8, 1024, 768) this kernel runs in less than
// that pipe's 85-operation time.
//
// Design: one pass, a grid-stride loop of 16-byte vectors (4 fp32, 8 bf16 or 8
// fp16 elements a thread an iteration), rotations as funnel shifts (one SHF
// each), the key schedule's sums hoisted out of the loop; the elements past
// the last whole vector by single-element steps. No shared memory, no atomics:
// every element is a pure function of (key, index, x).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct Key {
  uint32_t ks0, ks1, ks2;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define APEX_ROUND(r)  \
  x0 += x1;            \
  x1 = rotl(x1, r);    \
  x1 ^= x0;

// JAX's _threefry2x32_lowering, unrolled; returns b0 ^ b1
__device__ __forceinline__ uint32_t threefry_bits(const Key& k, uint32_t x0,
                                                  uint32_t x1) {
  x0 += k.ks0;
  x1 += k.ks1;
  APEX_ROUND(13) APEX_ROUND(15) APEX_ROUND(26) APEX_ROUND(6)
  x0 += k.ks1;
  x1 += k.ks2 + 1u;
  APEX_ROUND(17) APEX_ROUND(29) APEX_ROUND(16) APEX_ROUND(24)
  x0 += k.ks2;
  x1 += k.ks0 + 2u;
  APEX_ROUND(13) APEX_ROUND(15) APEX_ROUND(26) APEX_ROUND(6)
  x0 += k.ks0;
  x1 += k.ks1 + 3u;
  APEX_ROUND(17) APEX_ROUND(29) APEX_ROUND(16) APEX_ROUND(24)
  x0 += k.ks1;
  x1 += k.ks2 + 4u;
  APEX_ROUND(13) APEX_ROUND(15) APEX_ROUND(26) APEX_ROUND(6)
  x0 += k.ks2;
  x1 += k.ks0 + 5u;
  return x0 ^ x1;
}

#undef APEX_ROUND

__device__ __forceinline__ float drop(const Key& k, unsigned long long j,
                                      float x, uint32_t threshold,
                                      float scale) {
  const uint32_t bits = threefry_bits(
      k, static_cast<uint32_t>(j >> 32), static_cast<uint32_t>(j));
  // the product is rounded to x's type by the caller's store, as XLA
  // rounds x * scale; a dropped element is +0 whatever x is
  return (bits >> 9) < threshold ? x * scale : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y,
                   long long n, Key k, uint32_t threshold, float scale) {
  constexpr int V = apex::Vec<T>::N;
  const long long vecs = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long v = first; v < vecs; v += stride) {
    float in[V], out[V];
    apex::load_vec(x + v * V, in);
#pragma unroll
    for (int e = 0; e < V; ++e)
      out[e] = drop(k, static_cast<unsigned long long>(v * V + e), in[e],
                    threshold, scale);
    apex::store_vec(y + v * V, out);
  }
  for (long long j = vecs * V + first; j < n; j += stride) {
    float out;
    out = drop(k, static_cast<unsigned long long>(j), apex::to_f(x[j]),
               threshold, scale);
    apex::from_f(out, &y[j]);
  }
}

}  // namespace

// On CUDA device `device`, on `stream`: y = dropout(x) over n contiguous,
// 16-byte aligned elements of fp32, bf16 or fp16 (dtype 0, 1 or 2);
// (k0, k1) the threefry key, `threshold` and `scale` as above.
extern "C" int hidden_dropout(int device, const void* x, void* y,
                              long long n, unsigned k0, unsigned k1,
                              unsigned threshold, float scale, int dtype,
                              void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Key k{k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_TYPE_SWITCH(dtype, T, return static_cast<int>(cudaErrorInvalidValue), {
    const long long want = (n / apex::Vec<T>::N + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(
        want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks : want));
    dropout_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, k, threshold,
        scale);
  });
  return static_cast<int>(cudaGetLastError());
}
