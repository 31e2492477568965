// Packed variable-length flash attention's dK and dV on the tensor cores,
// bf16 inputs, head dim d <= 256, for Hopper (sm_90a).
//
// Replaces, for bf16 inputs at d <= 256, the TPU kernel of
// apex_tpu/ops/attention_varlen.py `_vl_bwd_dkv_kernel` (reached through
// `_vl_bwd_call`, pallas_call at :451): dK = sum_q ds . q and dV = sum_q
// p . dO over the queries each key may be attended by. fp32 inputs, and
// bf16 above d = 256, keep the CUDA-core kernels of flash_varlen.cu (on
// the tensor cores fp32 products would run as TF32); the varlen forward
// and dQ are flash_varlen.cu's for both types.
//
// Math, flash_varlen.cu's and the JAX kernel's: a score s = (q . k) *
// scale is allowed where seg_q == seg_k >= 0 (and kpos <= qpos when
// causal, absolute positions in the packed row); p = allowed ? exp(s -
// lse) : 0, by value (a pad row's lse is NEG_INF); dp = dO . v, ds = p *
// (dp - delta) * scale; p and ds are rounded to bf16 before their products
// (as JAX's casts), which accumulate in fp32 (mma.sync.m16n8k16,
// flash_mma.cuh).
//
// Bound on this card: operations, 8 * heads * S * d over the S live scores
// of a head (sum over documents of L^2, or L(L+1)/2 causal): at the packed
// path's row (8192 tokens, 12 heads of 64) its bytes, 23 us, bound it.
//
// Design: flash_mma.cu's dense dK/dV kernel with the varlen walk. One
// owner block per (64-row K/V tile, batch * head) keeps K and V in shared
// memory and walks exactly the live q range [ilo, ihi] of its `kr` table
// entry in order, skipping the q tiles that `tiles_meet` (flash_tile.cuh)
// says cannot meet it, so dK and dV are summed by one block in a fixed
// order: no atomics, the same bits on every launch; a K/V tile that no q
// meets writes zeros. Each live q tile's Q, dO, lse, delta and segment ids
// arrive through a two-stage cp.async ring (the next live tile copies
// while this one is used). Each warp owns 16 keys: S^T = K Q^T and dP^T =
// V dO^T (16 x 64) in registers, masked by the segment ids staged beside
// the Q tile and the key's own, then dV += P^T dO and dK += dS^T Q with
// fp32 accumulators in registers. At D >= 128 the block has 8 warps, two
// per 16 keys, each owning half of dK's and dV's columns (the
// accumulators of all D columns would not fit 255 registers a thread). The
// tile tables come from the wrapper (ops/attention_varlen.py `_tables`:
// 64-row entries, the min over real tokens), with the order in which the
// blocks take their K/V tiles: longest live q range first, so the blocks
// that walk a whole long document do not start in the last wave.

#include "flash_mma.cuh"

namespace {

struct VarlenDims {
  int h, sq, sk, d;
};

// warps that share 16 keys, each owning 1 / SPLIT of dK's and dV's columns
template <int D>
__host__ __device__ constexpr int varlen_dkv_split() {
  return D >= 128 ? 2 : 1;
}

// shared memory: K, V, two stages of Q and dO, and two stages of the q
// tile's lse, delta and segment ids
template <int D>
constexpr int varlen_dkv_smem = 6 * tile_bytes<D> + 3 * 2 * kB * 4;

// three blocks an SM at D <= 64 (at most 168 registers a thread)
template <int D>
__global__ void __launch_bounds__(128 * varlen_dkv_split<D>(),
                                  D <= 64 ? 3 : 1)
    varlen_mma_dkv_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ seg_q,
                          const int* __restrict__ seg_k,
                          const int4* __restrict__ qr,
                          const int4* __restrict__ kr,
                          const int* __restrict__ order,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          VarlenDims n, float scale, int causal) {
  constexpr int S = kStride<D>, NB = kB / 8, SPLIT = varlen_dkv_split<D>();
  constexpr int DC = D / SPLIT, NC = DC / 8, NT = 128 * SPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kB * S;
  bf16* sQ = sV + kB * S;      // two stages
  bf16* sO = sQ + 2 * kB * S;  // dO, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * kB * S);  // two stages
  float* sD = sL + 2 * kB;                                // two stages
  int* sSeg = reinterpret_cast<int*>(sD + 2 * kB);        // two stages
  const int nq = n.sq / kB, nk = n.sk / kB;
  const int bh = blockIdx.y, b = bh / n.h;
  const int kt = __ldg(order + static_cast<long>(b) * nk + blockIdx.x);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp % 4, c0 = (warp / 4) * DC;  // keys 16 slab.., cols
  const int4 ki = kr[static_cast<long>(b) * nk + kt];
  const int4* qtab = qr + static_cast<long>(b) * nq;
  // the first q tile at or after qt in the live range that meets this
  // K/V tile (past ihi: none); the same for every thread
  auto live = [&](int qt) {
    while (qt <= ki.w && !tiles_meet<kB>(qtab[qt], ki, qt, kt, causal)) ++qt;
    return qt;
  };

  {
    const long kbase = (static_cast<long>(bh) * n.sk + kt * kB) * n.d;
    tile_async<D>(sK, k + kbase, kB, n.d, tid, NT);
    tile_async<D>(sV, v + kbase, kB, n.d, tid, NT);
  }
  auto stage_q = [&](int qt, int st) {
    const long row0 = static_cast<long>(bh) * n.sq + qt * kB;
    tile_async<D>(sQ + st * kB * S, q + row0 * n.d, kB, n.d, tid, NT);
    tile_async<D>(sO + st * kB * S, dout + row0 * n.d, kB, n.d, tid, NT);
    rows_async(sL + st * kB, lse + row0, kB, tid);
    rows_async(sD + st * kB, delta + row0, kB, tid - 32);
    rows_async(reinterpret_cast<float*>(sSeg + st * kB),
               reinterpret_cast<const float*>(
                   seg_q + static_cast<long>(b) * n.sq + qt * kB),
               kB, tid - 64);
  };
  int qt = live(ki.z);
  if (qt <= ki.w) stage_q(qt, 0);
  cp_async_commit();

  // this thread's keys of the tile, 16 slab + g and + 8, and their
  // segment ids
  const int key[2] = {slab * 16 + g, slab * 16 + g + 8};
  int kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kseg[i] = __ldg(seg_k + static_cast<long>(b) * n.sk + kt * kB + key[i]);
  float dka[NC][4], dva[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int st = 0; qt <= ki.w; st ^= 1) {
    __syncthreads();  // every warp is done with the stage refilled next
    const int next = live(qt + 1);
    if (next <= ki.w) stage_q(next, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this q tile (and K, V) have landed
    __syncthreads();
    const bf16* cQ = sQ + st * kB * S;
    const bf16* cO = sO + st * kB * S;
    const float* cL = sL + st * kB;
    const float* cD = sD + st * kB;
    const int* cSeg = sSeg + st * kB;

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x 64 q rows a warp
    float sc[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 16) {
      uint32_t ak[4], av[4];
      load_a<D>(ak, sK, slab * 16, c, lane);
      load_a<D>(av, sV, slab * 16, c, lane);
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        uint32_t bq[4];
        load_bt<D>(bq, cQ, j * 8, c, lane);
        mma_bf16(sc[j], ak, bq[0], bq[1]);
        mma_bf16(sc[j + 1], ak, bq[2], bq[3]);
        load_bt<D>(bq, cO, j * 8, c, lane);
        mma_bf16(dp[j], av, bq[0], bq[1]);
        mma_bf16(dp[j + 1], av, bq[2], bq[3]);
      }
    }

    // p (into sc) and ds (into dp), masked by value
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = j * 8 + 2 * t + (e & 1);
        const int sgq = cSeg[i];
        const bool ok = sgq >= 0 && sgq == kseg[e >> 1] &&
                        (!causal || kt * kB + key[e >> 1] <= qt * kB + i);
        const float p = ok ? expf(sc[j][e] * scale - cL[i]) : 0.f;
        sc[j][e] = p;
        dp[j][e] = p * (dp[j][e] - cD[i]) * scale;
      }
    }

    // dV += round_bf16(P)^T dO, dK += round_bf16(dS)^T Q over this warp's
    // columns c0 .. c0 + DC - 1
#pragma unroll
    for (int kk = 0; kk < kB / 16; ++kk) {
      uint32_t ap[4], as[4];
      acc_to_a<NB>(ap, sc, kk);
      acc_to_a<NB>(as, dp, kk);
#pragma unroll
      for (int c = 0; c < NC; c += 2) {
        uint32_t bb[4];
        load_b<D>(bb, cO, kk * 16, c0 + c * 8, lane);
        mma_bf16(dva[c], ap, bb[0], bb[1]);
        mma_bf16(dva[c + 1], ap, bb[2], bb[3]);
        load_b<D>(bb, cQ, kk * 16, c0 + c * 8, lane);
        mma_bf16(dka[c], as, bb[0], bb[1]);
        mma_bf16(dka[c + 1], as, bb[2], bb[3]);
      }
    }
    qt = next;
  }
  cp_async_wait<0>();  // K and V when no q tile was live

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long row = (static_cast<long>(bh) * n.sk + kt * kB + key[i]) * n.d;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = c0 + j * 8 + 2 * t;
      if (col < n.d) {
        *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
            __floats2bfloat162_rn(dka[j][2 * i], dka[j][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
            __floats2bfloat162_rn(dva[j][2 * i], dva[j][2 * i + 1]);
      }
    }
  }
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* seg_q, const void* seg_k, const void* qr,
                       const void* kr, const void* order, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       int b, VarlenDims n, float scale, int causal,
                       cudaStream_t s) {
  auto kernel = varlen_mma_dkv_kernel<D>;
  const cudaError_t e = allow_smem(kernel, varlen_dkv_smem<D>);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n.sk / kB, b * n.h), 128 * varlen_dkv_split<D>(),
           varlen_dkv_smem<D>, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int4*>(qr),
      static_cast<const int4*>(kr), static_cast<const int*>(order),
      static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, scale, causal);
  return cudaSuccess;
}

}  // namespace

// flash_varlen.cu's dK/dV entry, with its arguments (see there) and
// `order`, (b, sk / 64) int32: the K/V tiles of each batch row in the
// order their blocks start (each row a permutation of its tiles), for
// bf16 inputs (is_bf16 != 0) and d a multiple of 8 up to 256; anything
// else returns cudaErrorInvalidValue.
extern "C" int flash_varlen_mma_bwd_dkv(int device, const void* q,
                                        const void* k, const void* v,
                                        const void* seg_q, const void* seg_k,
                                        const void* qr, const void* kr,
                                        const void* order, const void* dout,
                                        const void* lse,
                                        const void* delta, void* dk,
                                        void* dv, int b, int h, int sq,
                                        int sk, int d, float scale,
                                        int causal, int is_bf16,
                                        void* stream) {
  if (!is_bf16 || d <= 0 || d % 8 != 0 || d > 256 || sq % kB != 0 ||
      sk % kB != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const VarlenDims n{h, sq, sk, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define APEX_VARLEN_MMA_CASE(DIM)                                          \
  case DIM:                                                               \
    return status_of(launch_dkv<DIM>(q, k, v, seg_q, seg_k, qr, kr,      \
                                     order, dout, lse, delta, dk, dv, b,  \
                                     n, scale, causal, s));
  switch (flash_head_dim(d)) {
    APEX_VARLEN_MMA_CASE(32)
    APEX_VARLEN_MMA_CASE(64)
    APEX_VARLEN_MMA_CASE(128)
    APEX_VARLEN_MMA_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef APEX_VARLEN_MMA_CASE
}
