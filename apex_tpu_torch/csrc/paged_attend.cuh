// The paged-attention block walk of the fused layer (csrc/megakernel.cu's
// attention phase): one block per (row, head), so a fused verify row
// computes exactly what the fused decode of that token does. The per-op
// kernels walk the context in splits instead (paged_split.cuh,
// paged_attention.cu and paged_mma.cu); attend_row now serves only the
// fused layer.
//
// A pool is read through a reader that turns 16 bytes of one token's
// head vector into fp32 channels:
//   FpPool<T>: the model dtype, (H, B, bs, D);
//   Int8Pool:  int8 codes (H, B, bs, D) x one fp32 scale per (head, token)
//              (H, B, bs) — comm.quantize's codec at block = head_dim;
//   Int4Pool:  nibble-packed uint8 codes (H, B, bs, D/2), the even channel
//              in the low nibble, x one bf16 scale per `group` channels
//              (H, B, bs, D/group).
// Dequantizing is code * scale in fp32, the JAX kernel's `_nibble_dequant`
// and `k.astype(f32) * scale` (apex_tpu/serve/decode.py:110-121, 148-151).
// `kCg` reads with ld.global.cg (L2, not L1): the megakernel reads pools
// its own other blocks wrote earlier in the same launch, and L1 is not
// coherent across SMs.
#pragma once

#include "common.cuh"

namespace apex {

template <bool kCg>
__device__ __forceinline__ uint4 ld16(const void* p) {
  if constexpr (kCg) return __ldcg(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<const uint4*>(p);
}

template <bool kCg>
__device__ __forceinline__ float ld_f32(const float* p) {
  if constexpr (kCg) return __ldcg(p);
  return *p;
}

template <bool kCg>
__device__ __forceinline__ float ld_bf16(const __nv_bfloat16* p) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  unsigned short raw;
  if constexpr (kCg) {
    raw = __ldcg(u);
  } else {
    raw = *u;
  }
  return __bfloat162float(__ushort_as_bfloat16(raw));
}

// `tok` is the flat (head, block, offset) token row of the pool.
template <typename T, bool kCg>
struct FpPool {
  static constexpr int kVec = Vec<T>::N;
  const T* data;
  __device__ __forceinline__ void load(long tok, int d0, int D,
                                       float* out) const {
    const uint4 raw = ld16<kCg>(data + tok * D + d0);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = to_f(e[i]);
  }
};

template <bool kCg>
struct Int8Pool {
  static constexpr int kVec = 16;
  const int8_t* codes;
  const float* scales;
  __device__ __forceinline__ void load(long tok, int d0, int D,
                                       float* out) const {
    const uint4 raw = ld16<kCg>(codes + tok * D + d0);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
    const float s = ld_f32<kCg>(scales + tok);
#pragma unroll
    for (int i = 0; i < kVec; ++i) out[i] = static_cast<float>(c[i]) * s;
  }
};

template <bool kCg>
struct Int4Pool {
  static constexpr int kVec = 32;  // 16 bytes of nibble pairs
  const uint8_t* codes;
  const __nv_bfloat16* scales;
  int group;
  __device__ __forceinline__ void load(long tok, int d0, int D,
                                       float* out) const {
    const uint4 raw = ld16<kCg>(codes + tok * (D / 2) + d0 / 2);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    const __nv_bfloat16* s = scales + tok * (D / group);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int lo = b[i] & 0xF, hi = b[i] >> 4;
      lo = lo > 7 ? lo - 16 : lo;
      hi = hi > 7 ? hi - 16 : hi;
      out[2 * i] = static_cast<float>(lo) * ld_bf16<kCg>(s + (d0 + 2 * i) /
                                                                 group);
      out[2 * i + 1] = static_cast<float>(hi) *
                       ld_bf16<kCg>(s + (d0 + 2 * i + 1) / group);
    }
  }
};

// Shared-memory floats attend_row<THREADS, D> uses (the caller's staged
// q vector not included).
template <int THREADS, int D>
struct AttendSmem {
  static constexpr int NT = 4096 / D;  // positions per tile
  static constexpr int LD = D + 1;     // padded row: distinct banks
  static constexpr int kFloats = 2 * NT * LD + NT + THREADS / 32 + THREADS;
};

// softmax(q . K^T * scale) V of one (row, head) over the first `ctx`
// positions of its paged context: position t lives in pool block bt[t /
// bs] at offset t % bs; `head_tok0` is the head's first token row
// (head * pool_blocks * bs). `qs`: the D fp32 query channels in shared
// memory, staged by the caller (the walk's first barrier publishes them).
// Every thread of the block calls this; thread tid < D gets output channel
// tid, 0 when ctx == 0 (decode.py:172-174).
//
// The walk: tiles of NT positions up to ctx only, K and V copied to shared
// memory as fp32 with 16-byte loads; thread i < NT scores position i; block
// reductions give the tile max and the sum of p; thread (part, d)
// accumulates channel d over the positions of its part; the parts are
// summed at the end. Scores, p and the accumulator stay fp32.
template <int THREADS, int D, typename Pool>
__device__ float attend_row(const float* qs, const Pool& kp, const Pool& vp,
                            const int* bt, int ctx, long head_tok0, int bs,
                            float scale, float* smem) {
  using S = AttendSmem<THREADS, D>;
  constexpr int NT = S::NT, LD = S::LD;
  constexpr int VEC = Pool::kVec;
  constexpr int CPR = D / VEC;  // 16-byte chunks per K/V vector
  constexpr int PARTS = THREADS / D;
  static_assert(NT <= THREADS && THREADS % D == 0 && D % VEC == 0, "D");
  float* ks = smem;
  float* vs = ks + NT * LD;
  float* ps = vs + NT * LD;
  float* red = ps + NT;
  float* part_acc = red + THREADS / 32;

  const int tid = threadIdx.x;
  const int d_own = tid % D, part = tid / D;
  float m = kNegInf, l = 0.f, acc = 0.f;
  for (int t0 = 0; t0 < ctx; t0 += NT) {
    __syncthreads();  // q staged; the previous tile fully consumed
    for (int c = tid; c < NT * CPR; c += THREADS) {
      const int i = c / CPR, d0 = (c % CPR) * VEC;
      const int t = t0 + i;
      float fk[VEC], fv[VEC];
      if (t < ctx) {
        const long tok =
            head_tok0 + static_cast<long>(bt[t / bs]) * bs + t % bs;
        kp.load(tok, d0, D, fk);
        vp.load(tok, d0, D, fv);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) fk[j] = fv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ks[i * LD + d0 + j] = fk[j];
        vs[i * LD + d0 + j] = fv[j];
      }
    }
    __syncthreads();

    float s = kNegInf;
    if (tid < NT && t0 + tid < ctx) {
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qs[d] * ks[tid * LD + d];
      s = dot * scale;
    }
    const float m_new = fmaxf(m, block_max<THREADS / 32>(s, red));
    const float corr = expf(m - m_new);
    float p = 0.f;
    if (tid < NT) {
      p = expf(s - m_new);  // masked: exp(-1e30 - m_new) == 0
      ps[tid] = p;
    }
    // block_sum's barriers also publish ps to every thread
    l = corr * l + block_sum<THREADS / 32>(p, red);
    m = m_new;
    acc *= corr;
    for (int i = part; i < NT; i += PARTS) acc += ps[i] * vs[i * LD + d_own];
  }

  __syncthreads();
  part_acc[tid] = acc;
  __syncthreads();
  if (tid >= D) return 0.f;
  float a = 0.f;
#pragma unroll
  for (int p = 0; p < PARTS; ++p) a += part_acc[p * D + tid];
  return l == 0.f ? 0.f : a / l;
}

}  // namespace apex
