// Blockwise quantize and dequantize (the comm codec) for Hopper (sm_90a).
//
// Replaces the TPU kernels of apex_tpu/comm/quantize.py:
//   * `_quant_kernel_stochastic` (reached through `_quantize_pallas`,
//     pallas_call at :201): stochastic rounding;
//   * `_quant_kernel` (`_quantize_pallas`, pallas_call at :213): rounding
//     to nearest; one kernel here, templated on the rounding mode, covers
//     both, at qmax 127 (int8) or 7 (int4, nibble-packed in the kernel);
//   * `_dequant_kernel` (`_dequantize_pallas`, pallas_call at :226), from
//     int8 codes or packed nibbles (JAX unpacks them before its call).
//
// Math, exactly the JAX kernels' (fp32; a bf16 or fp16 x is read in its own
// type and upcast in registers, exactly, as JAX's kernel upcasts it, so
// its codes and scales are the fp32 path's on the same values): a flat
// buffer is cut into rows of
// B elements (one codec block each); scale = amax * fp32(1 / qmax) over
// the row's |x| (1 where amax is 0: XLA turns JAX's division by the
// constant qmax into this product, bit for bit its interpret-mode
// kernel), y = x / scale rounded once (IEEE), q = clip(rint(y), -qmax,
// qmax) (round half to even, as jnp.round) or, stochastic, clip(floor(y +
// u), -qmax, qmax), written as int8 codes, or as nibbles two to a byte
// (code 2i in the low nibble, 2i + 1 in the high one: pack_int4's
// layout), with one fp32 scale a row. Dequantize: code * scale in fp32.
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
// codes (n / 2 bytes packed) and n / B scales; dequantize reads n (n / 2)
// + 4n / B bytes and writes 4n. From a half type a stochastic element's
// ~28 instructions (10 of them the hash) come close to the issue rate, so
// the element's arithmetic avoids the division, conversion and
// special-function units, and a bf16 or fp16 row's amax takes |x| two at a
// time (__hmax2 on bf16 or half pairs, exact):
//   * y: one correctly rounded reciprocal r of the scale a row, then q0 =
//     x * r, e = fma(-q0, scale, x) (exact), y = fma(e, r, q0): the
//     correction step of the card's own IEEE division, which returns the
//     rounded quotient wherever no product or remainder leaves the normal
//     range: for a scale in [2^-60, 2^60] wherever |q0| >= 2^-40. Below
//     that |y| < 2^-39 either way, whose code is 0 whatever its last bits
//     (rint; floor(y + u) for u >= 2^-24), so only a stochastic draw u = 0
//     (one in 2^24) sees the sign of a tiny y: a vector holding one, and
//     a row with its scale outside the range, divide instead. The CPU
//     tests hold the sequence to x / scale and its codes to the plain
//     version's over ties, subnormals, random and all-zero rows;
//   * rint and floor: add 1.5 * 2^23, rounding to nearest or down, where
//     the float's integer spacing is 1 (|y| < 2^22 always: |x| <= amax);
//     the clamp runs in that domain and the code is the low byte of the
//     float's bits. NaN and inf clamp as fminf / fmaxf do;
//   * u: the hash's top 24 bits, exactly converted, added to y in one fma;
//     the 64-bit element index enters the hash once a row, a vector adds
//     its 32-bit offset.
//
// Design. Quantize: a team of lanes owns a row, each lane four 16-byte vectors
// of it at a time (64 bytes of x; lane t vector j at t + j * team, so a warp's
// loads are consecutive bytes), all loaded before the first max. The team is
// the fewest lanes, a power of 2 up to a warp, that hold the row four vectors
// a lane (comm/quantize.py `_quant_plan`, from the block, type and rounding
// mode): at a power-of-2 row of 16-128 vectors (the main path's B 256 and G
// 128 in both types) every lane holds four and the row stays in registers from
// load to store; a longer row is walked by a warp in chunks of 128 vectors,
// read once for the amax and again for the codes, and a partial chunk leaves
// lanes idle. One row a team, CTAs of 256 threads, as many as rows need, the
// block scheduler keeping loads in flight: bytes bound the nearest and the
// fp32 cells. From bf16 the stochastic cells come close to the issue rate: a
// resident grid whose teams walk the rows, each issuing its next row's loads
// before this row's arithmetic. The codes of a vector leave as one
// 2- to 8-byte store. Dequantize: a warp takes four consecutive
// 128-element chunks; each lane turns 4 codes (4 bytes, or 2 of nibbles)
// into one float4, so each load of a warp covers consecutive bytes, the
// float4s gather in shared memory and leave as one 2 KB bulk copy (TMA);
// the row (for the scale) advances by counting, no division. Every row
// and chunk has one owner: no atomics, no order.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kCta = 256;      // threads of a CTA
constexpr int kVecs = 4;       // 16-byte vectors of x a quantize lane holds
constexpr int kDeqUnroll = 4;  // chunks a dequantize warp has in flight
constexpr float kMagic = 12582912.f;  // 1.5 * 2^23: x + kMagic rounds x to
                                      // an integer (|x| < 2^22)

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// word i of a 16-byte vector (i known at compile time: a register)
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// element e of a 16-byte vector of T, as fp32
template <typename T>
__device__ __forceinline__ float element(const uint4& v, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(v, e));
  } else if constexpr (std::is_same_v<T, __half>) {
    const uint32_t w = word(v, e / 2);
    return __half2float(
        __ushort_as_half(static_cast<unsigned short>(e % 2 ? w >> 16 : w)));
  } else {
    const uint32_t w = word(v, e / 2);
    return __uint_as_float(e % 2 ? w & 0xFFFF0000u : w << 16);
  }
}

// the largest |x| of a lane's kVecs vectors of a half type, |x| two at a
// time in pairs of T2 (__nv_bfloat162 or __half2), exactly (a NaN loses to
// the other operand of __hmax2, as in fmaxf)
template <typename T2>
__device__ __forceinline__ float half_amax(const uint4* vecs) {
  const uint32_t zero = 0u;  // +0 in both halves
  T2 pair = *reinterpret_cast<const T2*>(&zero);
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t a = word(vecs[j], w) & 0x7FFF7FFFu;
      pair = __hmax2(pair, *reinterpret_cast<const T2*>(&a));
    }
  return fmaxf(__low2float(pair), __high2float(pair));
}

// The code of y in kMagic's domain (the float kMagic + code): the low byte
// of its bits is the code mod 256, the low nibble the code mod 16.
// Stochastic: floor(y + u), u = hm * 2^-32 exactly (hm: the hash's top 24
// bits in place), the sum rounded once and kMagic added rounding down.
template <bool Stochastic>
__device__ __forceinline__ uint32_t code_bits(float y, uint32_t hm, float lo,
                                              float hi) {
  const float m =
      Stochastic
          ? __fadd_rd(__fmaf_rn(__uint2float_rn(hm), 0x1p-32f, y), kMagic)
          : __fadd_rn(y, kMagic);
  return __float_as_uint(fminf(fmaxf(m, lo), hi));
}

// byte 0 of each word, in order
__device__ __forceinline__ uint32_t pack_bytes(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// the low nibbles of a and b as one byte, a's low (pack_int4's layout)
__device__ __forceinline__ uint32_t pack_nibbles(uint32_t a, uint32_t b) {
  return (a & 0xFu) | ((b << 4) & 0xF0u);
}

// A team of `team` lanes (a power of 2, at most a warp; `_quant_plan`)
// owns a row, kCta / team rows a CTA, the grid's teams walking the rows.
// Lane t holds vectors c * span + t + j * team, j < kVecs, of chunk c
// (span = team * kVecs vectors), those below nvec. A row of one chunk
// stays in registers from load to store, and the team's next row is
// loaded before this row's arithmetic (on a resident grid: in one row a
// team the walk ends after a row); a longer row is read twice, its chunks
// once for the amax and again for the codes (`Chunked`: more than one
// chunk; else the chunk loops compile away).
template <typename T, bool Stochastic, bool Packed, bool Chunked>
__global__ void __launch_bounds__(kCta)
    quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
                    float* __restrict__ scales, long rows, int block,
                    int team, float qmax, uint32_t key) {
  constexpr int N = apex::Vec<T>::N;
  const int nvec = block / N;
  const int span = team * kVecs;
  const int chunks = Chunked ? (nvec + span - 1) / span : 1;  // CTA-uniform
  const int cta_teams = kCta / team;
  const int team_in_cta = threadIdx.x / team;
  const int t = threadIdx.x % team;
  const long stride = static_cast<long>(gridDim.x) * cta_teams;
  const float inv_qmax = 1.f / qmax;
  const float lo = kMagic - qmax, hi = kMagic + qmax;

  auto load = [&](long r, int c, uint4* buf) {
    const T* xr = x + r * block;
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int v = c * span + t + j * team;
      buf[j] = r < rows && v < nvec
                   ? __ldg(reinterpret_cast<const uint4*>(xr + v * N))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  // cur: this row (chunk); nxt: the team's next row, its loads in flight.
  // One array for both: two separate ones compiled to a slower kernel
  uint4 ring[2][kVecs] = {};
  uint4* cur = ring[0];
  uint4* nxt = ring[1];
  long row0 = static_cast<long>(blockIdx.x) * cta_teams;  // CTA-uniform
  if (!Chunked) load(row0 + team_in_cta, 0, cur);
  for (; row0 < rows; row0 += stride) {
    const long row = row0 + team_in_cta;
    if (!Chunked && row0 + stride < rows) load(row + stride, 0, nxt);
    float amax = 0.f;
    for (int c = 0; c < chunks; ++c) {
      if (Chunked) load(row, c, cur);
      if constexpr (std::is_same_v<T, __half>) {  // |x| two at a time
        amax = fmaxf(amax, half_amax<__half2>(cur));
      } else if constexpr (N == 8) {
        amax = fmaxf(amax, half_amax<__nv_bfloat162>(cur));
      } else {
#pragma unroll
        for (int j = 0; j < kVecs; ++j)
#pragma unroll
          for (int e = 0; e < N; ++e)
            amax = fmaxf(amax, fabsf(element<T>(cur[j], e)));
      }
    }
    for (int o = team / 2; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (row < rows) {
      const float s = amax > 0.f ? amax * inv_qmax : 1.f;
      const float r = __frcp_rn(s);
      const bool fast = s >= 0x1p-60f && s <= 0x1p60f;
      if (t == 0) scales[row] = s;
      // the row's flat index i = base + o: the hash input is key + i_lo *
      // C1 + i_hi * C2, so a vector's is the row's plus o * C1, and C2
      // where i_lo wraps past 2^32 (a vector never straddles it)
      const unsigned long long base =
          static_cast<unsigned long long>(row) * block;
      const uint32_t base_lo = static_cast<uint32_t>(base);
      const uint32_t hash_row = key + base_lo * 0x9E3779B1u +
                                static_cast<uint32_t>(base >> 32) *
                                    0x85EBCA77u;
      uint8_t* out_row = q + (Packed ? base / 2 : base);
      for (int c = 0; c < chunks; ++c) {
        if (Chunked) load(row, c, cur);
#pragma unroll
        for (int j = 0; j < kVecs; ++j) {
          const int v = c * span + t + j * team;
          if (v >= nvec) continue;
          const uint32_t o = static_cast<uint32_t>(v * N);
          const uint32_t hash0 = hash_row + o * 0x9E3779B1u +
                                 (base_lo + o < base_lo ? 0x85EBCA77u : 0u);
          uint32_t hm[N] = {};
          bool recip = fast;  // the reciprocal path's y gives these codes
          if constexpr (Stochastic) {
#pragma unroll
            for (int e = 0; e < N; ++e) {
              hm[e] = fmix32(hash0 + e * 0x9E3779B1u) & 0xFFFFFF00u;
              recip &= hm[e] != 0u;
            }
          }
          float y[N];
          if (recip) {
#pragma unroll
            for (int e = 0; e < N; ++e) {
              const float xe = element<T>(cur[j], e);
              const float q0 = __fmul_rn(xe, r);
              y[e] = __fmaf_rn(__fmaf_rn(-q0, s, xe), r, q0);
            }
          } else {
#pragma unroll
            for (int e = 0; e < N; ++e)
              y[e] = __fdiv_rn(element<T>(cur[j], e), s);
          }
          uint32_t b[N];
#pragma unroll
          for (int e = 0; e < N; ++e)
            b[e] = code_bits<Stochastic>(y[e], hm[e], lo, hi);
          if constexpr (Packed) {
            uint8_t* out = out_row + o / 2;
            if constexpr (N == 4)
              *reinterpret_cast<uint16_t*>(out) = static_cast<uint16_t>(
                  pack_nibbles(b[0], b[1]) | pack_nibbles(b[2], b[3]) << 8);
            else
              *reinterpret_cast<uint32_t*>(out) = pack_bytes(
                  pack_nibbles(b[0], b[1]), pack_nibbles(b[2], b[3]),
                  pack_nibbles(b[4], b[5]), pack_nibbles(b[6], b[7]));
          } else {
            uint8_t* out = out_row + o;
            if constexpr (N == 4)
              *reinterpret_cast<uint32_t*>(out) =
                  pack_bytes(b[0], b[1], b[2], b[3]);
            else
              *reinterpret_cast<uint2*>(out) =
                  make_uint2(pack_bytes(b[0], b[1], b[2], b[3]),
                             pack_bytes(b[4], b[5], b[6], b[7]));
          }
        }
      }
    }
    if (!Chunked)
#pragma unroll
      for (int j = 0; j < kVecs; ++j) cur[j] = nxt[j];
  }
}

// Chunks of 128 elements: a warp takes kDeqUnroll consecutive ones; lane
// l turns elements 4l..4l+3 of each into one float4, staged in shared
// memory, and one lane writes the warp's chunks (contiguous in y) with one
// bulk copy through the tensor memory accelerator.
template <bool Packed>
__global__ void __launch_bounds__(kCta)
    dequantize_kernel(const uint8_t* __restrict__ q,
                      const float* __restrict__ scales, float* __restrict__ y,
                      long chunks, int per_row) {
  __shared__ __align__(128) float4 stage[kCta / 32][kDeqUnroll * 32];
  const int lane = threadIdx.x % 32;
  float4* out = stage[threadIdx.x / 32];
  const long c =
      (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32 *
      kDeqUnroll;
  if (c >= chunks) return;  // the whole warp
  const int count = static_cast<int>(
      chunks - c < kDeqUnroll ? chunks - c : kDeqUnroll);
  long row = c / per_row;  // once a warp; then by counting
  int pos = static_cast<int>(c - row * per_row);
  uint32_t raw[kDeqUnroll];
  float sc[kDeqUnroll];
#pragma unroll
  for (int u = 0; u < kDeqUnroll; ++u) {
    if (u < count) {
      if constexpr (Packed)
        raw[u] = __ldg(
            reinterpret_cast<const uint16_t*>(q + (c + u) * 64 + lane * 2));
      else
        raw[u] = __ldg(
            reinterpret_cast<const uint32_t*>(q + (c + u) * 128 + lane * 4));
      sc[u] = __ldg(scales + row);
    }
    if (++pos == per_row) {
      pos = 0;
      ++row;
    }
  }
#pragma unroll
  for (int u = 0; u < kDeqUnroll; ++u) {
    if (u >= count) continue;
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int code =
          Packed ? static_cast<int32_t>(raw[u] << (28 - 4 * i)) >> 28
                 : static_cast<int32_t>(raw[u] << (24 - 8 * i)) >> 24;
      f[i] = __fmul_rn(static_cast<float>(code), sc[u]);
    }
    out[u * 32 + lane] = make_float4(f[0], f[1], f[2], f[3]);
  }
  // the stores above (generic proxy) before the bulk copy reads them
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
  if (lane == 0) {
    const uint32_t src =
        static_cast<uint32_t>(__cvta_generic_to_shared(out));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            y + c * 128),
        "r"(src), "r"(count * 512)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // shared memory stays the CTA's until the copy has read it
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <typename T, bool Stochastic, bool Packed, bool Chunked>
int launch_quantize(const void* x, void* q, void* scales, long rows,
                    int block, int team, int resident, float qmax,
                    uint32_t key, int device, cudaStream_t s) {
  auto kernel = &quantize_kernel<T, Stochastic, Packed, Chunked>;
  // the CTAs that stay resident on one SM, asked once a kernel
  static const int per_sm = [&] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kCta, 0);
    return n > 0 ? n : 1;
  }();
  long grid = (rows + kCta / team - 1) / (kCta / team);  // one row a team
  if (resident) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long most = static_cast<long>(sms > 0 ? sms : 1) * per_sm;
    grid = grid < most ? grid : most;
  }
  kernel<<<grid, kCta, 0, s>>>(static_cast<const T*>(x),
                               static_cast<uint8_t*>(q),
                               static_cast<float*>(scales), rows, block, team,
                               qmax, key);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int pick_mode(const void* x, void* q, void* scales, long rows, int block,
              int team, int resident, float qmax, int stochastic, int packed,
              uint32_t key, int device, cudaStream_t s) {
  const bool chunked = block / apex::Vec<T>::N > team * kVecs;
  auto go = [&](auto stoch, auto pack, auto chunk) {
    return launch_quantize<T, decltype(stoch)::value, decltype(pack)::value,
                           decltype(chunk)::value>(
        x, q, scales, rows, block, team, resident, qmax, key, device, s);
  };
  auto pick_chunked = [&](auto stoch, auto pack) {
    return chunked ? go(stoch, pack, std::true_type())
                   : go(stoch, pack, std::false_type());
  };
  using Yes = std::true_type;
  using No = std::false_type;
  if (stochastic)
    return packed ? pick_chunked(Yes(), Yes()) : pick_chunked(Yes(), No());
  return packed ? pick_chunked(No(), Yes()) : pick_chunked(No(), No());
}

}  // namespace

// On CUDA device `device`, on `stream`: x (rows * block,) contiguous, of
// the type `dtype` names (common.cuh's code: 0 fp32, 1 bf16, 2 fp16),
// 16-byte aligned, block % 128 == 0 (so even); q (rows
// * block,) int8 codes, or with `packed` (rows * block / 2,) bytes of
// nibble pairs (qmax <= 7); scales (rows,) fp32. `key` is fmix32(seed),
// read only when `stochastic` != 0. Geometry as `_quant_plan` gives it:
// `team`, the lanes of a row, a power of 2 up to 32; `resident`: a grid of
// the CTAs that stay resident, else one row a team. Anything else:
// cudaErrorInvalidValue, no launch.
extern "C" int quantize_blockwise(int device, const void* x, void* q,
                                  void* scales, long long rows, int block,
                                  float qmax, int stochastic, unsigned key,
                                  int dtype, int packed, int team,
                                  int resident, void* stream) {
  if (rows < 0 || block <= 0 || block % 128 || (packed && qmax > 7.f) ||
      team < 1 || team > 32 || (team & (team - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_TYPE_SWITCH(dtype, T,
                   return static_cast<int>(cudaErrorInvalidValue),
                   return pick_mode<T>(x, q, scales, rows, block, team,
                                       resident, qmax, stochastic, packed,
                                       key, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// q: n int8 codes, or with `packed` n / 2 bytes of nibble pairs, 16-byte
// aligned; scales (n / block,) fp32; y (n,) fp32; block % 128 == 0 and n
// a multiple of it (else cudaErrorInvalidValue).
extern "C" int dequantize_blockwise(int device, const void* q,
                                    const void* scales, void* y, long long n,
                                    int block, int packed, void* stream) {
  if (n < 0 || block <= 0 || block % 128 || n % block)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long chunks = n / 128;
  if (chunks == 0) return static_cast<int>(cudaGetLastError());
  const long per_cta = kDeqUnroll * (kCta / 32);
  const long grid = (chunks + per_cta - 1) / per_cta;
  auto kernel = packed ? &dequantize_kernel<true> : &dequantize_kernel<false>;
  kernel<<<grid, kCta, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(y), chunks, block / 128);
  return static_cast<int>(cudaGetLastError());
}
