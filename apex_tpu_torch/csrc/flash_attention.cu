// Causal / full flash attention, forward and backward, with an optional
// additive logit bias, for Hopper (sm_90a).
//
// Replaces the TPU kernels of apex_tpu/ops/attention.py:
//   * `_fa_fwd_kernel` (reached through `_fa_fwd`, pallas_call at :297):
//     o and the row log-sum-exp lse;
//   * `_fa_bwd_dq_kernel` (`_fa_bwd`, pallas_call at :532): dQ;
//   * `_fa_bwd_dkv_kernel` (`_fa_bwd`, pallas_call at :570): dK and dV;
//   * `_fa_bwd_dbias_kernel` (`_fa_bwd`, pallas_call at :607): dL/dbias,
//     summed over the batch.
// The first three take the bias as a template switch (HasBias): with a
// null bias pointer they are the bias-free kernels, unchanged.
//
// Math, exactly the JAX kernels' (all accumulation in fp32):
//   s = (q . k) * scale (+ bias[bh % heads, qpos, kpos], an fp32 (heads,
//   sq, sk) tensor shared by the batch, added after the scaling and
//   rounded on its own: never fused into the product), then
//   s = NEG_INF where causal and kpos > qpos;
//   forward: online softmax over K/V tiles with running max m and sum l of
//   the UNdropped p = exp(s - m); dropout multiplies p (after l is summed)
//   by keep / (1 - rate); p is rounded to the input type before p @ v;
//   o = acc / l, lse = m + log(l) (o = 0 and lse = NEG_INF where l == 0);
//   backward, from the saved lse and delta = sum(dO * O) per row:
//   p = exp(s - lse), dp = dO . v (times keep / (1 - rate) with dropout),
//   ds = p * (dp - delta) * scale; dQ = sum ds * k, dK = sum ds * q,
//   dV = sum p_dropped * dO, with ds and p_dropped rounded to the input
//   type before each product, as the JAX kernels cast before their dots;
//   dbias[h] = sum over the batch b of p * (dp - delta) at bh = b * heads
//   + h, in fp32 and without `scale` (the bias enters after the scaling).
// Dropout keeps an entry where the murmur3-style counter hash of (seed,
// batch*head, global q position, global k position) is >= thresh: the
// same bits as `_hash_keep` (:129-144), so the mask regenerates exactly in
// the forward, its remat replay and both backward kernels.
//
// Bound on this card: at the flagship shape (bh 96, s 1024, d 64, bf16)
// the tensor-core operations (4, 6 and 8 * bh * s^2 * d, halved by the
// causal mask) bound all three, not the bytes. The bias adds one fp32
// read of heads * sq * sk to each (and d(bias) writes as much): at T5's
// encoder shape (bh 64, s 512, d 64) that is bytes the forward must move
// in about the time of its operations. These first kernels run
// their products on the CUDA cores in fp32, not on the tensor cores, so
// they sit far above that bound: a simple kernel that is right comes
// first, wgmma and TMA come later.
//
// Design: the TPU's sequential (q, kv) grid becomes a loop inside one
// block. Forward and dQ: one block per (q tile of 64 rows, batch*head),
// heaviest causal tiles launched first; dK/dV: one block per (kv tile of
// 64 rows, batch*head), walking the q tiles from the causal diagonal on.
// Each output tile has exactly one owner, so nothing is summed across
// blocks: no atomics, and the results are deterministic. K/V (or Q/dO)
// tiles are staged in shared memory as fp32. A row is held by TPR = D /
// DPT neighbouring threads, each owning DPT of its dims in registers (in
// interleaved float4 chunks, so the group's shared-memory reads are
// conflict-free broadcasts); dot products end with an xor-shuffle sum
// inside the group. Masking is by value, never by branch, so every lane
// reaches every shuffle. Sequence lengths are multiples of 64; D is 32 or
// 64.
//
// The bias is read straight from device memory, one (q tile, k tile)
// block of it where the scores of that tile are formed: a q row's 16
// biases of a key chunk as float4 loads in the forward, a key column's
// bias per q row in dK/dV (neighbouring threads, neighbouring keys). The
// causal tiles that the kernels skip read no bias. d(bias) has no
// sequential grid to carry the batch sum through (JAX runs the batch as
// its innermost, ordered grid axis): one block owns each (head, q tile,
// k tile) output tile and walks the batch in order, summing in registers
// (each thread owns 64 / TPR columns of its row), then writes the tile
// once; no atomics, so the sum is the same bits on every run. Tiles above
// the causal diagonal write zeros.

#include "common.cuh"

namespace {

constexpr int kB = 64;      // rows of a q or kv tile
constexpr int kChunk = 16;  // keys per online-softmax update

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

struct Dropout {
  int on;
  uint32_t seed, thresh;
  float inv_keep;  // 1 / (1 - rate), as the JAX kernels scale
};

// sum over the TPR neighbouring lanes that hold one row
template <int TPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy a contiguous (kB, D) tile of T into shared memory as fp32.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* src,
                                           int nthreads) {
  constexpr int N = apex::Vec<T>::N;
  for (int u = threadIdx.x; u < kB * D / N; u += nthreads) {
    float f[N];
    apex::load_vec(src + static_cast<long>(u) * N, f);
#pragma unroll
    for (int e = 0; e < N; e += 4) store4(dst + u * N + e, f + e);
  }
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

template <typename T, int DPT, int TPR>
__device__ __forceinline__ void load_row_part(const T* row, float* reg,
                                              int h) {
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) load4(row + 4 * (h + TPR * i), reg + 4 * i);
}

template <typename T, int DPT, int TPR>
__device__ __forceinline__ void store_row_part(T* row, const float* reg,
                                               int h) {
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i)
    store4(row + 4 * (h + TPR * i), reg + 4 * i);
}

// row `qpos` of head `head` of the (heads, sq, sk) bias; null without one
template <bool HasBias>
__device__ __forceinline__ const float* bias_row(const float* bias, int head,
                                                 int qpos, int sq, int sk) {
  if constexpr (HasBias)
    return bias + (static_cast<long>(head) * sq + qpos) * sk;
  else
    return nullptr;
}

// ---------------------------------------------------------------------------
// forward: o and lse

template <typename T, int D, bool HasBias>
__global__ void __launch_bounds__(kB * (D / 32))
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const float* __restrict__ bias, T* __restrict__ o,
                     float* __restrict__ lse, int heads, int sq, int sk,
                     float scale, int causal, Dropout drop) {
  constexpr int DPT = 32, TPR = D / DPT, NT = kB * TPR;
  __shared__ __align__(16) float sK[kB * D];
  __shared__ __align__(16) float sV[kB * D];
  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const int qpos = qt * kB + r;
  const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;

  float qr[DPT], acc[DPT];
  const long qrow = (static_cast<long>(bh) * sq + qpos) * D;
  load_row_part<T, DPT, TPR>(q + qrow, qr, h);
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = apex::kNegInf, l = 0.f;
  const float* brow = bias_row<HasBias>(bias, bh % heads, qpos, sq, sk);

  const int nkt = causal ? qt + 1 : sk / kB;
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    const long kbase = (static_cast<long>(bh) * sk + kt * kB) * D;
    stage_tile<T, D>(sK, k + kbase, NT);
    stage_tile<T, D>(sV, v + kbase, NT);
    __syncthreads();
    const bool diag = causal && kt == qt;
    for (int j0 = 0; j0 < kB; j0 += kChunk) {
      float s[kChunk];
      float bv[kChunk];
      if constexpr (HasBias) {
#pragma unroll
        for (int i = 0; i < kChunk; i += 4)
          load4(brow + kt * kB + j0 + i, bv + i);
      }
      float cmax = apex::kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        float sv = group_sum<TPR>(dot_part<DPT, TPR>(qr, sK + j * D, h)) *
                   scale;
        if constexpr (HasBias) sv = __fadd_rn(sv, bv[jj]);
        if (diag && j > r) sv = apex::kNegInf;
        s[jj] = sv;
        cmax = fmaxf(cmax, sv);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
      }
      l = corr * l + psum;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        float p = s[jj];
        if (drop.on)
          p = hash_keep(qpos, kt * kB + j, base, drop.thresh)
                  ? p * drop.inv_keep
                  : 0.f;
        axpy_part<DPT, TPR>(acc, round_to<T>(p), sV + j * D, h);
      }
      m = m_new;
    }
  }
  const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] /= safe_l;
  store_row_part<T, DPT, TPR>(o + qrow, acc, h);
  if (h == 0)
    lse[static_cast<long>(bh) * sq + qpos] =
        l == 0.f ? apex::kNegInf : m + logf(safe_l);
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, bh), looping over the K/V tiles

template <typename T, int D, bool HasBias>
__global__ void __launch_bounds__(kB * (D / 32))
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias, T* __restrict__ dq,
                        int heads, int sq, int sk, float scale, int causal,
                        Dropout drop) {
  constexpr int DPT = 32, TPR = D / DPT, NT = kB * TPR;
  __shared__ __align__(16) float sK[kB * D];
  __shared__ __align__(16) float sV[kB * D];
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const int qpos = qt * kB + r;
  const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;

  float qr[DPT], dor[DPT], acc[DPT];
  const long qrow = (static_cast<long>(bh) * sq + qpos) * D;
  load_row_part<T, DPT, TPR>(q + qrow, qr, h);
  load_row_part<T, DPT, TPR>(dout + qrow, dor, h);
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  const float lse_r = lse[static_cast<long>(bh) * sq + qpos];
  const float delta_r = delta[static_cast<long>(bh) * sq + qpos];
  const float* brow = bias_row<HasBias>(bias, bh % heads, qpos, sq, sk);

  const int nkt = causal ? qt + 1 : sk / kB;
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    const long kbase = (static_cast<long>(bh) * sk + kt * kB) * D;
    stage_tile<T, D>(sK, k + kbase, NT);
    stage_tile<T, D>(sV, v + kbase, NT);
    __syncthreads();
    const bool diag = causal && kt == qt;
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float sv = group_sum<TPR>(dot_part<DPT, TPR>(qr, sK + j * D, h)) *
                 scale;
      if constexpr (HasBias) sv = __fadd_rn(sv, __ldg(brow + kt * kB + j));
      if (diag && j > r) sv = apex::kNegInf;
      const float p = expf(sv - lse_r);
      float dp = group_sum<TPR>(dot_part<DPT, TPR>(dor, sV + j * D, h));
      if (drop.on)
        dp = hash_keep(qpos, kt * kB + j, base, drop.thresh)
                 ? dp * drop.inv_keep
                 : 0.f;
      const float ds = p * (dp - delta_r) * scale;
      axpy_part<DPT, TPR>(acc, round_to<T>(ds), sK + j * D, h);
    }
  }
  store_row_part<T, DPT, TPR>(dq + qrow, acc, h);
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (kv tile, bh), looping over the q tiles from the
// causal diagonal on

template <typename T, int D, bool HasBias>
__global__ void __launch_bounds__(kB * (D / 16))
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias, T* __restrict__ dk,
                         T* __restrict__ dv, int heads, int sq, int sk,
                         float scale, int causal, Dropout drop) {
  constexpr int DPT = 16, TPR = D / DPT, NT = kB * TPR;
  __shared__ __align__(16) float sQ[kB * D];
  __shared__ __align__(16) float sO[kB * D];  // dO
  __shared__ float sL[kB], sD[kB];
  const int kt = blockIdx.x;  // causal: low tiles have the most q tiles
  const int bh = blockIdx.y;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const int kpos = kt * kB + r;
  const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  const long krow = (static_cast<long>(bh) * sk + kpos) * D;
  load_row_part<T, DPT, TPR>(k + krow, kr, h);
  load_row_part<T, DPT, TPR>(v + krow, vr, h);
#pragma unroll
  for (int i = 0; i < DPT; ++i) dka[i] = dva[i] = 0.f;
  // this key's bias column: row i of q tile qt at bcol[(qt * kB + i) * sk]
  const float* bcol =
      HasBias ? bias + static_cast<long>(bh % heads) * sq * sk + kpos
              : nullptr;

  const int nqt = sq / kB;
  for (int qt = causal ? kt : 0; qt < nqt; ++qt) {
    __syncthreads();
    const long qbase = (static_cast<long>(bh) * sq + qt * kB) * D;
    stage_tile<T, D>(sQ, q + qbase, NT);
    stage_tile<T, D>(sO, dout + qbase, NT);
    for (int i = threadIdx.x; i < kB; i += NT) {
      sL[i] = lse[static_cast<long>(bh) * sq + qt * kB + i];
      sD[i] = delta[static_cast<long>(bh) * sq + qt * kB + i];
    }
    __syncthreads();
    const bool diag = causal && kt == qt;
#pragma unroll 4
    for (int i = 0; i < kB; ++i) {
      float sv = group_sum<TPR>(dot_part<DPT, TPR>(kr, sQ + i * D, h)) *
                 scale;
      if constexpr (HasBias)
        sv = __fadd_rn(sv,
                       __ldg(bcol + static_cast<long>(qt * kB + i) * sk));
      if (diag && r > i) sv = apex::kNegInf;  // kpos > qpos
      const float p = expf(sv - sL[i]);
      float dp = group_sum<TPR>(dot_part<DPT, TPR>(vr, sO + i * D, h));
      float pv = p;
      if (drop.on) {
        const bool keep = hash_keep(qt * kB + i, kpos, base, drop.thresh);
        pv = keep ? p * drop.inv_keep : 0.f;
        dp = keep ? dp * drop.inv_keep : 0.f;
      }
      axpy_part<DPT, TPR>(dva, round_to<T>(pv), sO + i * D, h);
      const float ds = p * (dp - sD[i]) * scale;
      axpy_part<DPT, TPR>(dka, round_to<T>(ds), sQ + i * D, h);
    }
  }
  store_row_part<T, DPT, TPR>(dk + krow, dka, h);
  store_row_part<T, DPT, TPR>(dv + krow, dva, h);
}

// ---------------------------------------------------------------------------
// d(bias): one block per (k tile, q tile, head) output tile, walking the
// batch in order

template <typename T, int D>
__global__ void __launch_bounds__(kB * (D / 32))
    flash_bwd_dbias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ bias,
                           float* __restrict__ db, int heads, int nb, int sq,
                           int sk, float scale, int causal, Dropout drop) {
  constexpr int DPT = 32, TPR = D / DPT, NT = kB * TPR;
  constexpr int NJ = kB / TPR;  // columns of the tile one thread sums
  __shared__ __align__(16) float sK[kB * D];
  __shared__ __align__(16) float sV[kB * D];
  const int kt = blockIdx.x, qt = blockIdx.y, head = blockIdx.z;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const int qpos = qt * kB + r;
  // this thread's columns: h, h + TPR, h + 2 * TPR, ... of the tile's row r
  float* dbrow = db + (static_cast<long>(head) * sq + qpos) * sk + kt * kB;
  float acc[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) acc[i] = 0.f;
  if (causal && kt > qt) {  // above the diagonal: no score is live
#pragma unroll
    for (int i = 0; i < NJ; ++i) dbrow[h + TPR * i] = 0.f;
    return;
  }
  const float* brow = bias_row<true>(bias, head, qpos, sq, sk) + kt * kB;
  const bool diag = causal && kt == qt;

  float qr[DPT], dor[DPT];
  for (int b = 0; b < nb; ++b) {
    const int bh = b * heads + head;
    const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;
    const long qrow = (static_cast<long>(bh) * sq + qpos) * D;
    load_row_part<T, DPT, TPR>(q + qrow, qr, h);
    load_row_part<T, DPT, TPR>(dout + qrow, dor, h);
    const float lse_r = lse[static_cast<long>(bh) * sq + qpos];
    const float delta_r = delta[static_cast<long>(bh) * sq + qpos];
    __syncthreads();  // the previous batch item's readers are done
    const long kbase = (static_cast<long>(bh) * sk + kt * kB) * D;
    stage_tile<T, D>(sK, k + kbase, NT);
    stage_tile<T, D>(sV, v + kbase, NT);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      float sv = group_sum<TPR>(dot_part<DPT, TPR>(qr, sK + j * D, h)) *
                 scale;
      sv = __fadd_rn(sv, __ldg(brow + j));
      if (diag && j > r) sv = apex::kNegInf;
      const float p = expf(sv - lse_r);
      float dp = group_sum<TPR>(dot_part<DPT, TPR>(dor, sV + j * D, h));
      if (drop.on)
        dp = hash_keep(qpos, kt * kB + j, base, drop.thresh)
                 ? dp * drop.inv_keep
                 : 0.f;
      // rounded before the sum, as JAX adds p * (dp - delta) to its scratch
      const float ds = __fmul_rn(p, dp - delta_r);
      if (j % TPR == h) acc[j / TPR] = __fadd_rn(acc[j / TPR], ds);
    }
  }
#pragma unroll
  for (int i = 0; i < NJ; ++i) dbrow[h + TPR * i] = acc[i];
}

template <typename T, int D, bool HasBias>
void launch_fwd(const void* q, const void* k, const void* v,
                const void* bias, void* o, void* lse, int heads, int bh,
                int sq, int sk, float scale, int causal, Dropout drop,
                cudaStream_t s) {
  flash_fwd_kernel<T, D, HasBias>
      <<<dim3(sq / kB, bh), kB * (D / 32), 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(bias),
          static_cast<T*>(o), static_cast<float*>(lse), heads, sq, sk, scale,
          causal, drop);
}

template <typename T, int D, bool HasBias>
void launch_dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* bias, void* dq,
               int heads, int bh, int sq, int sk, float scale, int causal,
               Dropout drop, cudaStream_t s) {
  flash_bwd_dq_kernel<T, D, HasBias>
      <<<dim3(sq / kB, bh), kB * (D / 32), 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const float*>(bias), static_cast<T*>(dq), heads, sq,
          sk, scale, causal, drop);
}

template <typename T, int D, bool HasBias>
void launch_dkv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const void* bias, void* dk, void* dv, int heads, int bh,
                int sq, int sk, float scale, int causal, Dropout drop,
                cudaStream_t s) {
  flash_bwd_dkv_kernel<T, D, HasBias>
      <<<dim3(sk / kB, bh), kB * (D / 16), 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const float*>(bias), static_cast<T*>(dk),
          static_cast<T*>(dv), heads, sq, sk, scale, causal, drop);
}

template <typename T, int D>
void launch_dbias(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* bias, void* db, int heads, int bh, int sq,
                  int sk, float scale, int causal, Dropout drop,
                  cudaStream_t s) {
  flash_bwd_dbias_kernel<T, D>
      <<<dim3(sk / kB, sq / kB, heads), kB * (D / 32), 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const float*>(bias), static_cast<float*>(db), heads,
          bh / heads, sq, sk, scale, causal, drop);
}

// runs the statement given, as written, with T and D bound to the
// (type, head_dim) pair; an unsupported pair returns cudaErrorInvalidValue
// from the calling entry point
#define APEX_FLASH_DISPATCH_TD(...)                                  \
  do {                                                               \
    if (is_bf16 && d == 64) {                                        \
      using T = __nv_bfloat16; constexpr int D = 64; __VA_ARGS__;    \
    } else if (is_bf16 && d == 32) {                                 \
      using T = __nv_bfloat16; constexpr int D = 32; __VA_ARGS__;    \
    } else if (!is_bf16 && d == 64) {                                \
      using T = float; constexpr int D = 64; __VA_ARGS__;            \
    } else if (!is_bf16 && d == 32) {                                \
      using T = float; constexpr int D = 32; __VA_ARGS__;            \
    } else {                                                         \
      return static_cast<int>(cudaErrorInvalidValue);                \
    }                                                                \
  } while (0)

// FN<T, D, HasBias>(args...): the bias-free kernels for a null `bias`, the
// bias kernels otherwise
#define APEX_FLASH_DISPATCH(FN, ...)                                 \
  do {                                                               \
    if (bias != nullptr)                                             \
      APEX_FLASH_DISPATCH_TD(FN<T, D, true>(__VA_ARGS__));           \
    else                                                             \
      APEX_FLASH_DISPATCH_TD(FN<T, D, false>(__VA_ARGS__));          \
  } while (0)

}  // namespace

// On CUDA device `device`, on `stream`. q, o, dO, dq: (bh, sq, d); k, v,
// dk, dv: (bh, sk, d); contiguous, 16-byte aligned, all of one type
// (is_bf16 ? bf16 : fp32); lse, delta: (bh, sq) fp32. sq and sk are
// multiples of 64 (equal when causal); d is 32 or 64. `bias` is null or a
// contiguous, 16-byte aligned fp32 (heads, sq, sk) tensor shared by the
// batch (bh = batch * heads, b-major; heads is ignored without a bias);
// d(bias) writes db, fp32 (heads, sq, sk). Dropout is on when `dropout`
// != 0: keep where hash >= thresh, kept values scaled by inv_keep.
extern "C" int flash_attention_fwd(int device, const void* q, const void* k,
                                   const void* v, const void* bias, void* o,
                                   void* lse, int heads, int bh, int sq,
                                   int sk, int d, float scale, int causal,
                                   int dropout, unsigned seed,
                                   unsigned thresh, float inv_keep,
                                   int is_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_FLASH_DISPATCH(launch_fwd, q, k, v, bias, o, lse, heads, bh, sq, sk,
                      scale, causal, drop, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_bwd_dq(int device, const void* q,
                                      const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, const void* bias,
                                      void* dq, int heads, int bh, int sq,
                                      int sk, int d, float scale, int causal,
                                      int dropout, unsigned seed,
                                      unsigned thresh, float inv_keep,
                                      int is_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, bias, dq, heads,
                      bh, sq, sk, scale, causal, drop, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_bwd_dkv(int device, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, const void* bias,
                                       void* dk, void* dv, int heads, int bh,
                                       int sq, int sk, int d, float scale,
                                       int causal, int dropout, unsigned seed,
                                       unsigned thresh, float inv_keep,
                                       int is_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, bias, dk, dv,
                      heads, bh, sq, sk, scale, causal, drop, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_bwd_dbias(int device, const void* q,
                                         const void* k, const void* v,
                                         const void* dout, const void* lse,
                                         const void* delta, const void* bias,
                                         void* db, int heads, int bh, int sq,
                                         int sk, int d, float scale,
                                         int causal, int dropout,
                                         unsigned seed, unsigned thresh,
                                         float inv_keep, int is_bf16,
                                         void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (bias == nullptr || heads <= 0 || bh % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_FLASH_DISPATCH_TD(launch_dbias<T, D>(q, k, v, dout, lse, delta, bias,
                                            db, heads, bh, sq, sk, scale,
                                            causal, drop, s));
  return static_cast<int>(cudaGetLastError());
}
