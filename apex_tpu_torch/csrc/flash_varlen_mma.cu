// Packed variable-length flash attention on the tensor cores, bf16 or fp16
// inputs (E below), head dim d <= 256, for Hopper (sm_90a): the forward, dQ,
// and dK and dV.
//
// Replaces, for bf16 and fp16 inputs at d <= 256, the TPU kernels of
// apex_tpu/ops/attention_varlen.py:
//   * `_vl_fwd_kernel` (reached through `_vl_call`, pallas_call at :377):
//     o and the row log-sum-exp lse;
//   * `_vl_bwd_dq_kernel` (`_vl_bwd_call`, pallas_call at :414): dQ;
//   * `_vl_bwd_dkv_kernel` (`_vl_bwd_call`, pallas_call at :451): dK =
//     sum_q ds . q and dV = sum_q p . dO over the queries each key may be
//     attended by.
// fp32 inputs, and bf16 or fp16 above d = 256, keep the CUDA-core kernels of
// flash_varlen.cu (on the tensor cores fp32 products would run as TF32).
//
// Math, flash_varlen.cu's and the JAX kernels': a score s = (q . k) *
// scale is allowed where seg_q == seg_k >= 0 (and kpos <= qpos when
// causal, absolute positions in the packed row), and every mask is by
// value. Forward: an online softmax over the live K/V tiles in ascending
// order, once per 64-key tile, p = allowed ? exp(s - m_new) : 0 (kNegInf
// is finite, so a tile with no allowed column for a row would otherwise
// give it exp(0) = 1), the correction exp(m_prev - m_new) taken as 0
// while m_prev <= NEG_INF / 2; p rounded to E before p . v; o = acc /
// l, lse = m + log l, and o = 0, lse = NEG_INF where l == 0 (a pad row,
// or a q tile with no live K/V tile). Backward: p = allowed ? exp(s -
// lse) : 0 (a pad row's lse is NEG_INF: exp(s - lse) is inf there, so a
// select, never a product), dp = dO . v, ds = p * (dp - delta) * scale; p
// and ds are rounded to E before their products (as JAX's casts),
// which accumulate in fp32 (mma.sync.m16n8k16, flash_mma.cuh).
//
// Bound on this card: over the S live scores of a head (sum over documents
// of L^2, or L(L+1)/2 causal) the kernels do 4, 6 and 8 * heads * S * d
// operations; at the packed path's row (8192 tokens, 12 heads of 64) their
// bytes, 15, 19 and 23 us, bound them.
//
// Design: flash_mma.cu's dense kernels with the varlen walk; the tile
// tables come from the wrapper (ops/attention_varlen.py `_tables`: 64-row
// entries, the min over real tokens) with the order in which the blocks
// take their tiles, longest live range first; the grid's fast axis is
// b*h, so the blocks start rank by rank across the heads and those that
// walk a whole long document do not start in the last wave. The forward and dQ:
// one owner block per (64-row q tile, batch * head) walks exactly the
// live K/V range [jlo, jhi] of its `qr` table entry in order, skipping the
// K/V tiles that `tiles_meet` (flash_tile.cuh) says cannot meet it; Q
// (and dO) are staged once, each live K/V tile arrives with its 64 key
// segment ids through a two-stage cp.async ring (the next live tile
// copies while this one is used). Each warp owns 16 q rows: S = Q K^T
// (and dP = dO V^T) in registers, masked from its rows' segment ids (in
// registers) and the staged keys' with the per-element absolute
// positions (a live tile below the diagonal can still hold another
// document's keys), the C fragments packed to E as the A operand of O
// += P V (dQ += dS K). The forward's row sum l is this lane's share until
// the end, reduced over the row's 4 lanes once. dQ at D = 256 has 8
// warps, two per 16 rows, each owning half of dQ's columns. dK/dV: one
// owner block per (64-row K/V tile, batch * head) keeps K and V in shared
// memory and walks exactly the live q range [ilo, ihi] of its `kr` entry
// in order; each live q tile's Q, dO, lse, delta and segment ids arrive
// through a two-stage ring. Each warp owns 16 keys: S^T = K Q^T and dP^T
// = V dO^T (16 x 64) in registers, then dV += P^T dO and dK += dS^T Q with
// fp32 accumulators in registers; at D >= 128 the block has 8 warps, two
// per 16 keys, each owning half of dK's and dV's columns (the
// accumulators of all D columns would not fit 255 registers a thread).
// Every output has one owner that sums in a fixed order: no atomics, the
// same bits on every launch; a tile with nothing live writes zeros (and
// NEG_INF). Shared memory: the forward 5 tiles and 2 x 64 ids (166 KB at
// D = 256), dQ 6 tiles and 2 x 64 ids (199 KB), dK/dV 6 tiles and 2 x 3
// x 64 rows (200 KB).

#include "flash_mma.cuh"

namespace {

struct VarlenDims {
  int h, sq, sk, d;
};

// Start copying the 64 segment ids of tile `tile` of a (b, s) row into
// shared memory (16-byte copies by the threads with 0 <= tid < 16)
__device__ __forceinline__ void ids_async(int* dst, const int* row, int tile,
                                          int tid) {
  rows_async(reinterpret_cast<float*>(dst),
             reinterpret_cast<const float*>(row + tile * kB), kB, tid);
}

// ---------------------------------------------------------------------------
// forward: o and lse; one owner block per (q tile, b*h), over the q tile's
// live K/V tiles in order

// shared memory: Q, two stages of K and V, two stages of the key ids
template <int D>
constexpr int varlen_fwd_smem = 5 * tile_bytes<D> + 2 * kB * 4;

// four blocks an SM at D <= 64 (at most 128 registers a thread), two at
// D = 128, one at D = 256: what their shared memory allows
template <typename E, int D>
__global__ void __launch_bounds__(128, D <= 64 ? 4 : D == 128 ? 2 : 1)
    varlen_mma_fwd_kernel(const E* __restrict__ q,
                          const E* __restrict__ k,
                          const E* __restrict__ v,
                          const int* __restrict__ seg_q,
                          const int* __restrict__ seg_k,
                          const int4* __restrict__ qr,
                          const int4* __restrict__ kr,
                          const int* __restrict__ order,
                          E* __restrict__ o, float* __restrict__ lse,
                          VarlenDims n, float scale, int causal) {
  constexpr int S = kStride<D>, NB = kB / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  E* sQ = reinterpret_cast<E*>(smem);
  E* sK = sQ + kB * S;      // two stages
  E* sV = sK + 2 * kB * S;  // two stages
  int* sSeg = reinterpret_cast<int*>(sV + 2 * kB * S);  // two stages
  const int nq = n.sq / kB, nk = n.sk / kB;
  const int bh = blockIdx.x, b = bh / n.h;
  const int qt = __ldg(order + static_cast<long>(b) * nq + blockIdx.y);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int4 qi = qr[static_cast<long>(b) * nq + qt];
  const int4* ktab = kr + static_cast<long>(b) * nk;
  const int* segk_row = seg_k + static_cast<long>(b) * n.sk;
  // the first K/V tile at or after kt in the live range that meets this q
  // tile (past jhi: none); the same for every thread
  auto live = [&](int kt) {
    while (kt <= qi.w && !tiles_meet<kB>(qi, ktab[kt], qt, kt, causal)) ++kt;
    return kt;
  };

  tile_async<D>(sQ, q + (static_cast<long>(bh) * n.sq + qt * kB) * n.d, kB,
                n.d, tid, 128);
  auto stage_kv = [&](int kt, int st) {
    const long kbase = (static_cast<long>(bh) * n.sk + kt * kB) * n.d;
    tile_async<D>(sK + st * kB * S, k + kbase, kB, n.d, tid, 128);
    tile_async<D>(sV + st * kB * S, v + kbase, kB, n.d, tid, 128);
    ids_async(sSeg + st * kB, segk_row, kt, tid);
  };
  int kt = live(qi.z);
  if (kt <= qi.w) stage_kv(kt, 0);
  cp_async_commit();

  // this thread's rows of the tile, 16 warp + g and + 8, and their
  // segment ids
  const int r[2] = {warp * 16 + g, warp * 16 + g + 8};
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    qseg[i] = __ldg(seg_q + static_cast<long>(b) * n.sq + qt * kB + r[i]);
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {apex::kNegInf, apex::kNegInf}, l[2] = {0.f, 0.f};

  for (int st = 0; kt <= qi.w; st ^= 1) {
    __syncthreads();  // every warp is done with the stage refilled next
    const int next = live(kt + 1);
    if (next <= qi.w) stage_kv(next, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this K/V tile (and Q) have landed
    __syncthreads();
    const E* cK = sK + st * kB * S;
    const E* cV = sV + st * kB * S;
    const int* cSeg = sSeg + st * kB;

    float s[NB][4];
    mma_abt<D>(s, sQ, warp * 16, cK, lane);

    // scale and masks (bit 4j + e of `ok`: element (j, e) allowed); the
    // tile's row max
    uint32_t ok = 0;
    float mx[2] = {apex::kNegInf, apex::kNegInf};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int2 ks = *reinterpret_cast<const int2*>(cSeg + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = j * 8 + 2 * t + (e & 1);
        const bool a = qseg[i] >= 0 && (e & 1 ? ks.y : ks.x) == qseg[i] &&
                       (!causal || kt * kB + col <= qt * kB + r[i]);
        ok |= static_cast<uint32_t>(a) << (4 * j + e);
        s[j][e] = a ? s[j][e] * scale : apex::kNegInf;
        mx[i] = fmaxf(mx[i], s[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = m[i] <= 0.5f * apex::kNegInf ? 0.f : expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];  // this lane's share of the row sum
    }
    // p = allowed ? exp(s - m) : 0, by value
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            (ok >> (4 * j + e)) & 1u ? expf(s[j][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    // O += round_E(P) V
    mma_pv<D, ND>(acc, s, cV, 0, lane);
    kt = next;
  }
  cp_async_wait<0>();  // Q when no K/V tile was live

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long row = static_cast<long>(bh) * n.sq + qt * kB + r[i];
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < n.d)
        *reinterpret_cast<uint32_t*>(o + row * n.d + col) =
            pack2<E>(acc[j][2 * i] / safe_l,
                                  acc[j][2 * i + 1] / safe_l);
    }
    if (t == 0)
      lse[row] = l[i] == 0.f ? apex::kNegInf : m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// dQ: one owner block per (q tile, b*h), over the q tile's live K/V tiles
// in order

// warps that share 16 q rows, each owning 1 / SPLIT of dQ's columns
template <int D>
__host__ __device__ constexpr int varlen_dq_split() {
  return D >= 256 ? 2 : 1;
}

// shared memory: Q, dO, two stages of K and V, two stages of the key ids
template <int D>
constexpr int varlen_dq_smem = 6 * tile_bytes<D> + 2 * kB * 4;

// three blocks an SM at D <= 64 (at most 168 registers a thread), two at
// D = 128: what their shared memory allows
template <typename E, int D>
__global__ void __launch_bounds__(128 * varlen_dq_split<D>(),
                                  D <= 64 ? 3 : D == 128 ? 2 : 1)
    varlen_mma_dq_kernel(const E* __restrict__ q,
                         const E* __restrict__ k,
                         const E* __restrict__ v,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ seg_k,
                         const int4* __restrict__ qr,
                         const int4* __restrict__ kr,
                         const int* __restrict__ order,
                         const E* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         E* __restrict__ dq, VarlenDims n, float scale,
                         int causal) {
  constexpr int S = kStride<D>, NB = kB / 8, SPLIT = varlen_dq_split<D>();
  constexpr int DC = D / SPLIT, NC = DC / 8, NT = 128 * SPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  E* sQ = reinterpret_cast<E*>(smem);
  E* sO = sQ + kB * S;      // dO
  E* sK = sO + kB * S;      // two stages
  E* sV = sK + 2 * kB * S;  // two stages
  int* sSeg = reinterpret_cast<int*>(sV + 2 * kB * S);  // two stages
  const int nq = n.sq / kB, nk = n.sk / kB;
  const int bh = blockIdx.x, b = bh / n.h;
  const int qt = __ldg(order + static_cast<long>(b) * nq + blockIdx.y);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp % 4, c0 = (warp / 4) * DC;  // rows 16 slab.., cols
  const int4 qi = qr[static_cast<long>(b) * nq + qt];
  const int4* ktab = kr + static_cast<long>(b) * nk;
  const int* segk_row = seg_k + static_cast<long>(b) * n.sk;
  auto live = [&](int kt) {
    while (kt <= qi.w && !tiles_meet<kB>(qi, ktab[kt], qt, kt, causal)) ++kt;
    return kt;
  };

  {
    const long row0 = (static_cast<long>(bh) * n.sq + qt * kB) * n.d;
    tile_async<D>(sQ, q + row0, kB, n.d, tid, NT);
    tile_async<D>(sO, dout + row0, kB, n.d, tid, NT);
  }
  auto stage_kv = [&](int kt, int st) {
    const long kbase = (static_cast<long>(bh) * n.sk + kt * kB) * n.d;
    tile_async<D>(sK + st * kB * S, k + kbase, kB, n.d, tid, NT);
    tile_async<D>(sV + st * kB * S, v + kbase, kB, n.d, tid, NT);
    ids_async(sSeg + st * kB, segk_row, kt, tid);
  };
  int kt = live(qi.z);
  if (kt <= qi.w) stage_kv(kt, 0);
  cp_async_commit();

  // this thread's rows of the tile, 16 slab + g and + 8: segment ids, lse
  // and delta
  const int r[2] = {slab * 16 + g, slab * 16 + g + 8};
  int qseg[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long row = static_cast<long>(bh) * n.sq + qt * kB + r[i];
    qseg[i] = __ldg(seg_q + static_cast<long>(b) * n.sq + qt * kB + r[i]);
    lse_r[i] = __ldg(lse + row);
    delta_r[i] = __ldg(delta + row);
  }
  float acc[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int st = 0; kt <= qi.w; st ^= 1) {
    __syncthreads();  // every warp is done with the stage refilled next
    const int next = live(kt + 1);
    if (next <= qi.w) stage_kv(next, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this K/V tile (and Q, dO) have landed
    __syncthreads();
    const E* cK = sK + st * kB * S;
    const E* cV = sV + st * kB * S;
    const int* cSeg = sSeg + st * kB;

    // S = Q K^T and dP = dO V^T, 16 q rows x 64 keys a warp
    float sc[NB][4], dp[NB][4];
    mma_abt<D>(sc, sQ, slab * 16, cK, lane);
    mma_abt<D>(dp, sO, slab * 16, cV, lane);

    // ds = p * (dp - delta) * scale (into sc), p = allowed ? exp(s - lse)
    // : 0 by value
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int2 ks = *reinterpret_cast<const int2*>(cSeg + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, col = j * 8 + 2 * t + (e & 1);
        const bool a = qseg[i] >= 0 && (e & 1 ? ks.y : ks.x) == qseg[i] &&
                       (!causal || kt * kB + col <= qt * kB + r[i]);
        const float p = a ? expf(sc[j][e] * scale - lse_r[i]) : 0.f;
        sc[j][e] = p * (dp[j][e] - delta_r[i]) * scale;
      }
    }

    // dQ += round_E(dS) K over this warp's columns c0 .. c0 + DC - 1
    mma_pv<D, NC>(acc, sc, cK, c0, lane);
    kt = next;
  }
  cp_async_wait<0>();  // Q and dO when no K/V tile was live

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    E* row = dq + (static_cast<long>(bh) * n.sq + qt * kB + r[i]) * n.d;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = c0 + j * 8 + 2 * t;
      if (col < n.d)
        *reinterpret_cast<uint32_t*>(row + col) =
            pack2<E>(acc[j][2 * i], acc[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one owner block per (K/V tile, b*h), over the tile's live q
// tiles in order

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
template <typename E, int D>
__global__ void __launch_bounds__(128 * varlen_dkv_split<D>(),
                                  D <= 64 ? 3 : 1)
    varlen_mma_dkv_kernel(const E* __restrict__ q,
                          const E* __restrict__ k,
                          const E* __restrict__ v,
                          const int* __restrict__ seg_q,
                          const int* __restrict__ seg_k,
                          const int4* __restrict__ qr,
                          const int4* __restrict__ kr,
                          const int* __restrict__ order,
                          const E* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          E* __restrict__ dk, E* __restrict__ dv,
                          VarlenDims n, float scale, int causal) {
  constexpr int S = kStride<D>, NB = kB / 8, SPLIT = varlen_dkv_split<D>();
  constexpr int DC = D / SPLIT, NC = DC / 8, NT = 128 * SPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  E* sK = reinterpret_cast<E*>(smem);
  E* sV = sK + kB * S;
  E* sQ = sV + kB * S;      // two stages
  E* sO = sQ + 2 * kB * S;  // dO, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * kB * S);  // two stages
  float* sD = sL + 2 * kB;                                // two stages
  int* sSeg = reinterpret_cast<int*>(sD + 2 * kB);        // two stages
  const int nq = n.sq / kB, nk = n.sk / kB;
  const int bh = blockIdx.x, b = bh / n.h;
  const int kt = __ldg(order + static_cast<long>(b) * nk + blockIdx.y);
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
    ids_async(sSeg + st * kB, seg_q + static_cast<long>(b) * n.sq, qt,
              tid - 64);
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
    const E* cQ = sQ + st * kB * S;
    const E* cO = sO + st * kB * S;
    const float* cL = sL + st * kB;
    const float* cD = sD + st * kB;
    const int* cSeg = sSeg + st * kB;

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x 64 q rows a warp
    float sc[NB][4], dp[NB][4];
    mma_abt<D>(sc, sK, slab * 16, cQ, lane);
    mma_abt<D>(dp, sV, slab * 16, cO, lane);

    // p (into sc) and ds (into dp), masked by value
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int2 qs = *reinterpret_cast<const int2*>(cSeg + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = j * 8 + 2 * t + (e & 1);
        const int sgq = e & 1 ? qs.y : qs.x;
        const bool ok = sgq >= 0 && sgq == kseg[e >> 1] &&
                        (!causal || kt * kB + key[e >> 1] <= qt * kB + i);
        const float p = ok ? expf(sc[j][e] * scale - cL[i]) : 0.f;
        sc[j][e] = p;
        dp[j][e] = p * (dp[j][e] - cD[i]) * scale;
      }
    }

    // dV += round_E(P)^T dO, dK += round_E(dS)^T Q over this warp's
    // columns c0 .. c0 + DC - 1
    mma_pv<D, NC>(dva, sc, cO, c0, lane);
    mma_pv<D, NC>(dka, dp, cQ, c0, lane);
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
        *reinterpret_cast<uint32_t*>(dk + row + col) =
            pack2<E>(dka[j][2 * i], dka[j][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + row + col) =
            pack2<E>(dva[j][2 * i], dva[j][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches: a block per (b*h, rank in the order table) with b*h the fast
// grid axis, so the blocks start rank by rank: every head's longest walks
// first, then the next longest (with the tile fast, the last heads' longest
// walks would start in the last wave)

template <typename E, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* seg_q, const void* seg_k, const void* qr,
                       const void* kr, const void* order, void* o, void* lse,
                       int b, VarlenDims n, float scale, int causal,
                       cudaStream_t s) {
  auto kernel = varlen_mma_fwd_kernel<E, D>;
  const cudaError_t e = allow_smem(kernel, varlen_fwd_smem<D>);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(b * n.h, n.sq / kB), 128, varlen_fwd_smem<D>, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int4*>(qr),
      static_cast<const int4*>(kr), static_cast<const int*>(order),
      static_cast<E*>(o), static_cast<float*>(lse), n, scale, causal);
  return cudaSuccess;
}

template <typename E, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* seg_q, const void* seg_k, const void* qr,
                      const void* kr, const void* order, const void* dout,
                      const void* lse, const void* delta, void* dq, int b,
                      VarlenDims n, float scale, int causal, cudaStream_t s) {
  auto kernel = varlen_mma_dq_kernel<E, D>;
  const cudaError_t e = allow_smem(kernel, varlen_dq_smem<D>);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(b * n.h, n.sq / kB), 128 * varlen_dq_split<D>(),
           varlen_dq_smem<D>, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int4*>(qr),
      static_cast<const int4*>(kr), static_cast<const int*>(order),
      static_cast<const E*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<E*>(dq), n, scale,
      causal);
  return cudaSuccess;
}

template <typename E, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* seg_q, const void* seg_k, const void* qr,
                       const void* kr, const void* order, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       int b, VarlenDims n, float scale, int causal,
                       cudaStream_t s) {
  auto kernel = varlen_mma_dkv_kernel<E, D>;
  const cudaError_t e = allow_smem(kernel, varlen_dkv_smem<D>);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(b * n.h, n.sk / kB), 128 * varlen_dkv_split<D>(),
           varlen_dkv_smem<D>, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int4*>(qr),
      static_cast<const int4*>(kr), static_cast<const int*>(order),
      static_cast<const E*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<E*>(dk), static_cast<E*>(dv), n, scale, causal);
  return cudaSuccess;
}

// the launch given, with E bound to the element type of `dtype` (bf16 or
// fp16) and D to the instantiated head dim that takes d, its status
// returned from the calling entry point (after the checks every entry
// makes: bf16 or fp16, d a positive multiple of 8 up to 256, sq and sk
// multiples of 64 of at most 65,535 tiles (the grid's y axis), and the
// device set)
#define APEX_VARLEN_MMA_CASE(DIM, ...) \
  case DIM: {                          \
    constexpr int D = DIM;             \
    return status_of(__VA_ARGS__);     \
  }
#define APEX_VARLEN_MMA_DIMS(...)                                           \
  switch (flash_head_dim(d)) {                                              \
    APEX_VARLEN_MMA_CASE(32, __VA_ARGS__)                                   \
    APEX_VARLEN_MMA_CASE(64, __VA_ARGS__)                                   \
    APEX_VARLEN_MMA_CASE(128, __VA_ARGS__)                                  \
    APEX_VARLEN_MMA_CASE(256, __VA_ARGS__)                                  \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }
#define APEX_VARLEN_MMA_DISPATCH(...)                                       \
  do {                                                                      \
    if ((dtype != apex::kBF16 && dtype != apex::kF16) || d <= 0 ||          \
        d % 8 != 0 || d > 256 || sq % kB != 0 || sk % kB != 0 ||            \
        sq / kB > 65535 || sk / kB > 65535)                                 \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    const cudaError_t set = cudaSetDevice(device);                          \
    if (set != cudaSuccess) return static_cast<int>(set);                   \
    const VarlenDims n{h, sq, sk, d};                                       \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                     \
    if (dtype == apex::kBF16) {                                             \
      using E = __nv_bfloat16;                                              \
      APEX_VARLEN_MMA_DIMS(__VA_ARGS__)                                     \
    } else {                                                                \
      using E = __half;                                                     \
      APEX_VARLEN_MMA_DIMS(__VA_ARGS__)                                     \
    }                                                                       \
  } while (0)

}  // namespace

// flash_varlen.cu's entries (see there for the arguments), with `order`
// after the tables: the tiles of each batch row in the order their blocks
// start, (b, sq / 64) int32 q tiles for the forward and dQ, (b, sk / 64)
// K/V tiles for dK/dV (each row a permutation of its tiles). They take
// bf16 or fp16 inputs (dtype 1 or 2) and d a multiple of 8 up to 256;
// anything else returns cudaErrorInvalidValue.
extern "C" int flash_varlen_mma_fwd(int device, const void* q, const void* k,
                                    const void* v, const void* seg_q,
                                    const void* seg_k, const void* qr,
                                    const void* kr, const void* order,
                                    void* o, void* lse, int b, int h, int sq,
                                    int sk, int d, float scale, int causal,
                                    int dtype, void* stream) {
  APEX_VARLEN_MMA_DISPATCH(launch_fwd<E, D>(q, k, v, seg_q, seg_k, qr, kr,
                                         order, o, lse, b, n, scale, causal,
                                         s));
}

extern "C" int flash_varlen_mma_bwd_dq(int device, const void* q,
                                       const void* k, const void* v,
                                       const void* seg_q, const void* seg_k,
                                       const void* qr, const void* kr,
                                       const void* order, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int b, int h, int sq, int sk,
                                       int d, float scale, int causal,
                                       int dtype, void* stream) {
  APEX_VARLEN_MMA_DISPATCH(launch_dq<E, D>(q, k, v, seg_q, seg_k, qr, kr,
                                           order, dout, lse, delta, dq, b,
                                           n, scale, causal, s));
}

extern "C" int flash_varlen_mma_bwd_dkv(int device, const void* q,
                                        const void* k, const void* v,
                                        const void* seg_q, const void* seg_k,
                                        const void* qr, const void* kr,
                                        const void* order, const void* dout,
                                        const void* lse,
                                        const void* delta, void* dk,
                                        void* dv, int b, int h, int sq,
                                        int sk, int d, float scale,
                                        int causal, int dtype,
                                        void* stream) {
  APEX_VARLEN_MMA_DISPATCH(launch_dkv<E, D>(q, k, v, seg_q, seg_k, qr, kr,
                                         order, dout, lse, delta, dk, dv, b,
                                         n, scale, causal, s));
}
