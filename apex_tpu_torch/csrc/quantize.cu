// Blockwise quantize and dequantize (the comm codec) for Hopper (sm_90a).
//
// Replaces the TPU kernels of apex_tpu/comm/quantize.py:
//   * `_quant_kernel_stochastic` (reached through `_quantize_pallas`,
//     pallas_call at :201): stochastic rounding;
//   * `_quant_kernel` (`_quantize_pallas`, pallas_call at :213): rounding
//     to nearest; one kernel here, templated on the rounding mode, covers
//     both, at qmax 127 (int8) or 7 (int4, packed afterwards);
//   * `_dequant_kernel` (`_dequantize_pallas`, pallas_call at :226).
//
// Math, exactly the JAX kernels' (fp32): a flat buffer is cut into rows of
// B elements (one codec block each); scale = amax * fp32(1 / qmax) over
// the row's |x| (1 where amax is 0: XLA turns JAX's division by the
// constant qmax into this product, bit for bit its interpret-mode
// kernel), y = x / scale (IEEE division: the build has no fast math), q = clip(rint(y), -qmax, qmax) (round half to even, as
// jnp.round; not roundf) or, stochastic, clip(floor(y + u), -qmax, qmax),
// written as int8 codes with one fp32 scale a row. Dequantize: codes *
// scale in fp32.
//
// Stochastic rounding: JAX draws u from the TPU core's PRNG (reseeded per
// grid step) or threefry, neither of which exists here. u is the top 24
// bits of a counter hash of (seed, flat element index), times 2^-24, as
// `_uniform_from_bits`; the hash is murmur3's fmix32 (the sampler's mix,
// serve/sampling.py) of key + i_lo * 0x9E3779B1 + i_hi * 0x85EBCA77 with
// key = fmix32(seed), so each element's draw depends on nothing else and
// the plain version (comm/quantize.py) computes the same bits.
//
// Bound on this card: device memory. Quantize reads x once and writes n
// codes and n / B scales (n * sizeof(T) + n + 4n/B bytes); dequantize
// reads n + 4n/B bytes and writes 4n. A few operations per element.
//
// Design: quantize runs one warp per row, eight rows a 256-thread block:
// the amax is a warp reduction over 16-byte vectors of x (4 fp32 or 8
// bf16 a lane, so B % 128 == 0 gives every lane whole vectors), then the
// warp reads its row again (from the cache) and writes each lane's codes
// as one 4- or 8-byte store. Dequantize: one thread per 16 codes (one
// 16-byte load, four float4 stores; B % 16 == 0, so the 16 share a
// scale). Every row and vector has one owner: no atomics, no order.

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // warps of a quantize block

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// u in [0, 1) for flat element i: the top 24 bits of its hash, exactly
__device__ __forceinline__ float uniform(uint32_t key, unsigned long long i) {
  const uint32_t lo = static_cast<uint32_t>(i);
  const uint32_t hi = static_cast<uint32_t>(i >> 32);
  const uint32_t h = fmix32(key + lo * 0x9E3779B1u + hi * 0x85EBCA77u);
  return static_cast<float>(h >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

template <typename T, bool Stochastic>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scales, long rows, int block,
                    float qmax, uint32_t key) {
  constexpr int N = apex::Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const long row =
      static_cast<long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + row * block;
  const int nvec = block / N;
  float amax = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    float f[N];
    apex::load_vec(xr + v * N, f);
#pragma unroll
    for (int i = 0; i < N; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
  amax = apex::warp_max(amax);
  const float scale = amax > 0.f ? amax * (1.f / qmax) : 1.f;
  if (lane == 0) scales[row] = scale;
  for (int v = lane; v < nvec; v += 32) {
    float f[N];
    apex::load_vec(xr + v * N, f);
    uint32_t packed[N / 4] = {};  // the lane's N codes, 4 to a word
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float y = f[i] / scale;
      float r;
      if constexpr (Stochastic)
        r = floorf(__fadd_rn(
            y, uniform(key, static_cast<unsigned long long>(row) * block +
                                v * N + i)));
      else
        r = rintf(y);
      const int code = static_cast<int>(fminf(fmaxf(r, -qmax), qmax));
      packed[i / 4] |= static_cast<uint32_t>(code & 0xFF) << (8 * (i % 4));
    }
    int8_t* out = q + row * block + v * N;
    if constexpr (N == 4)
      *reinterpret_cast<uint32_t*>(out) = packed[0];
    else
      *reinterpret_cast<uint2*>(out) = make_uint2(packed[0], packed[1]);
  }
}

__global__ void __launch_bounds__(256)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales, float* __restrict__ y,
                      long nvec, int block) {
  const long v = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= nvec) return;
  const int4 raw = *reinterpret_cast<const int4*>(q + v * 16);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  const float s = scales[v * 16 / block];
  float4* out = reinterpret_cast<float4*>(y + v * 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = make_float4(c[4 * i] * s, c[4 * i + 1] * s, c[4 * i + 2] * s,
                         c[4 * i + 3] * s);
}

template <typename T>
int launch_quantize(const void* x, void* q, void* scales, long rows,
                    int block, float qmax, int stochastic, uint32_t key,
                    cudaStream_t s) {
  if (rows > 0) {
    const long grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (stochastic)
      quantize_kernel<T, true><<<grid, 32 * kRowsPerBlock, 0, s>>>(
          static_cast<const T*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(scales), rows, block, qmax, key);
    else
      quantize_kernel<T, false><<<grid, 32 * kRowsPerBlock, 0, s>>>(
          static_cast<const T*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(scales), rows, block, qmax, key);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// On CUDA device `device`, on `stream`: x (rows * block,) contiguous, fp32
// or bf16 (is_bf16), 16-byte aligned, block % 128 == 0; q (rows * block,)
// int8; scales (rows,) fp32. `key` is fmix32(seed), read only when
// `stochastic` != 0.
extern "C" int quantize_blockwise(int device, const void* x, void* q,
                                  void* scales, long long rows, int block,
                                  float qmax, int stochastic, unsigned key,
                                  int is_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_quantize<__nv_bfloat16>(x, q, scales, rows, block, qmax,
                                          stochastic, key, s);
  return launch_quantize<float>(x, q, scales, rows, block, qmax, stochastic,
                                key, s);
}

// q (n,) int8, 16-byte aligned; scales (n / block,) fp32; y (n,) fp32; n
// and block multiples of 16.
extern "C" int dequantize_blockwise(int device, const void* q,
                                    const void* scales, void* y, long long n,
                                    int block, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long nvec = n / 16;
  if (nvec > 0)
    dequantize_kernel<<<(nvec + 255) / 256, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scales),
        static_cast<float*>(y), nvec, block);
  return static_cast<int>(cudaGetLastError());
}
