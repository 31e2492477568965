// Flash attention's forward, dQ, dK/dV and d(bias) on the tensor cores, bf16
// or fp16 inputs (E below), head dim d <= 256, with an optional additive logit
// bias and the counter hash dropout, for Hopper (sm_90a).
//
// Replaces, for bf16 and fp16 inputs, the TPU kernels of
// apex_tpu/ops/attention.py:
//   * `_fa_fwd_kernel` (reached through `_fa_fwd`, pallas_call at :297):
//     o and the row log-sum-exp lse;
//   * `_fa_bwd_dq_kernel` (`_fa_bwd`, pallas_call at :532): dQ;
//   * `_fa_bwd_dkv_kernel` (`_fa_bwd`, pallas_call at :570): dK and dV;
//   * `_fa_bwd_dbias_kernel` (`_fa_bwd`, pallas_call at :607): dL/dbias,
//     summed over the batch.
// JAX runs these products on its matrix unit as E dots with fp32
// results (`lax.dot_general(..., preferred_element_type=jnp.float32)`,
// :205, :228, :355, :367, :373, :410, :429, :432, :437, :475, :486); so do
// these kernels, with mma.sync.m16n8k16 (flash_mma.cuh; .bf16 or .f16
// operands, the same fragments). fp32 inputs keep
// the CUDA-core kernels of flash_attention.cu: on the tensor cores fp32
// products run as TF32, which keeps 10 bits of mantissa, not the fp32
// products JAX's reference forms, and the fp32 parity gates (1e-4 a
// kernel, 1e-5 on the train step) could not hold. So do d above 256.
//
// Math, the JAX kernels' and flash_attention.cu's: s = (q . k) * scale
// (+ bias[bh % heads, qpos, kpos] by __fadd_rn after the scaling), NEG_INF
// where causal and kpos > qpos and at the columns past sk; the forward's
// online softmax keeps per row the running max m and the sum l of the
// UNdropped p = exp(s - m), p is dropped by the counter hash after l is
// summed, rounded to E (JAX's cast at :228) and multiplied by V; o = acc
// / l, lse = m + log l (o = 0 and lse = NEG_INF where l == 0). The
// backward: p = exp(s - lse), dp = dO . v (times keep / (1 - rate)),
// dQ += round(p * (dp - delta) * scale) k (the cast of :373), dV +=
// round(p dropped)^T dO, dK += round(p * (dp - delta) * scale)^T q (:429,
// :437); d(bias) sums p * (dp - delta) over the batch in fp32, rounded
// before each sum, with no scale and no E rounding (:491).
//
// Bound on this card: operations. At the flagship shape (bh 96, s 1024, d
// 64, causal) the forward does 4 * bh * s^2 * d / 2 = 12.9 GFLOP, dQ 6 *
// .. = 19.3 and dK/dV 8 * .. = 25.8 (with the two products of S and dP
// done twice at D >= 128 in dK/dV and at D = 256 in dQ, below); their
// bytes (q, k, v, o, lse: 50 MB) take 15 us at 3.35 TB/s, the bf16
// operations 13, 20 and 26 us. d(bias) at T5's encoder (bh 64, s 512, d
// 64, an fp32 (8, 512, 512) bias read and written) is bound by its bytes.
// mma.sync reaches about two thirds of the wgmma peak; a first tensor-core
// kernel that is right and simple, wgmma with TMA is the next step.
//
// Design. The forward: one block of 4 warps per (64-row q tile, batch *
// head), heaviest causal tiles first; each warp owns 16 q rows. Q is staged
// once; K and V tiles of 64 keys arrive in a two-stage ring filled by
// cp.async, the next tile copying while this one is used. S = Q K^T (16 x
// 64 a warp) lands in registers; the scale, the bias, the masks, the
// online-softmax update (once per 64-key tile), the dropout and the E
// rounding apply there, each thread knowing the (q, k) position of each
// accumulator element from the fragment layout; the C fragments are the A
// operand of O += P V (V through ldmatrix.trans). The row max and sum are
// reduced over the 4 lanes that share a row. dQ is the forward's shape
// with a second product and no online softmax: Q and dO staged once, K
// and V through the same ring; S = Q K^T and dP = dO V^T in registers, dS
// packed to E as the A operand of dQ += dS K (K through ldmatrix.trans).
// dK/dV: one block per (64-row K/V tile, batch * head); K and V stay in
// shared memory, Q and dO tiles (with their lse and delta) stream through
// a two-stage cp.async ring, from the causal diagonal on. Each warp owns
// 16 keys: S^T = K Q^T and dP^T = V dO^T (16 x 64) in registers, then dV
// += P^T dO and dK += dS^T Q with fp32 accumulators in registers. Where
// the accumulators of all D columns would not fit the 255 registers a
// thread can have (dK/dV at D >= 128: 128 for dK and dV each at D = 256,
// 64 for S and dP; dQ at D = 256) the block has 8 warps, two per 16 rows,
// each owning half of the accumulated columns and forming S and dP
// itself. d(bias): one block of 4 warps per (64 x 64 output tile, head,
// chunk of the batch); it walks its batch items in order, staging Q, dO,
// K, V (and the lse and delta rows) of each through a two-stage ring (one
// stage at D = 256), forms S and dP by mma.sync and adds p * (dp - delta)
// into fp32 registers; tiles above the causal diagonal write zeros. One
// owner per (tile, head) would give T5's decoder (8 heads x 3 live causal
// tiles) 24 blocks on 132 SMs, so the wrapper splits the batch into
// ordered chunks (`_dbias_chunks`, a function of the shape alone): each
// writes an fp32 partial tile, and a second launch adds the partials in
// chunk order. Nothing is summed across blocks otherwise: one owner per
// output tile, no atomics, the same bits on every launch. Masks are by
// value, copies read from clamped addresses. Shared memory: the forward 5
// tiles (169 KB at D = 256), dQ 6 tiles (203 KB), dK/dV 6 tiles and 1 KB
// of rows (204 KB), d(bias) 8 tiles (137 KB at D = 128; 4, 133 KB, at
// 256); one block an SM at D = 256.

#include "flash_dense.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kFwdThreads = 128;

// ---------------------------------------------------------------------------
// forward: o and lse

// four blocks an SM at D <= 64 (at most 128 registers a thread), two at
// D = 128, one at D = 256: what their shared memory allows
template <typename E, int D, bool HasBias>
__global__ void __launch_bounds__(kFwdThreads, D <= 64 ? 4 : D == 128 ? 2 : 1)
    flash_mma_fwd_kernel(const E* __restrict__ q,
                         const E* __restrict__ k,
                         const E* __restrict__ v,
                         const float* __restrict__ bias,
                         E* __restrict__ o, float* __restrict__ lse,
                         Dims n, float scale, int causal, Dropout drop) {
  constexpr int S = kStride<D>, NB = kB / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  E* sQ = reinterpret_cast<E*>(smem);
  E* sK = sQ + kB * S;      // two stages
  E* sV = sK + 2 * kB * S;  // two stages
  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;
  const int nkt = causal ? qt + 1 : tiles(n.sk);

  tile_async<D>(sQ, q + (static_cast<long>(bh) * n.sq + qt * kB) * n.d,
                min(kB, n.sq - qt * kB), n.d, tid, kFwdThreads);
  auto stage_kv = [&](int kt) {
    const long kbase = (static_cast<long>(bh) * n.sk + kt * kB) * n.d;
    const int rows = min(kB, n.sk - kt * kB);
    tile_async<D>(sK + (kt & 1) * kB * S, k + kbase, rows, n.d, tid,
                  kFwdThreads);
    tile_async<D>(sV + (kt & 1) * kB * S, v + kbase, rows, n.d, tid,
                  kFwdThreads);
  };
  stage_kv(0);
  cp_async_commit();

  // this thread's rows of the tile: r[0] = 16 warp + g and r[1] = r[0] + 8
  const int r[2] = {warp * 16 + g, warp * 16 + g + 8};
  const float* brow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    brow[i] = bias_row<HasBias>(bias, bh % n.heads, qt * kB + r[i], n);
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {apex::kNegInf, apex::kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // every warp is done with the stage refilled next
    if (kt + 1 < nkt) stage_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    const E* cK = sK + (kt & 1) * kB * S;
    const E* cV = sV + (kt & 1) * kB * S;

    float s[NB][4];
    mma_abt<D>(s, sQ, warp * 16, cK, lane);

    // scale, bias, masks; the tile's row max
    const bool diag = causal && kt == qt;
    float mx[2] = {apex::kNegInf, apex::kNegInf};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r[e >> 1], col = j * 8 + 2 * t + (e & 1);
        float sv = s[j][e] * scale;
        if constexpr (HasBias)
          sv = __fadd_rn(sv, __ldg(brow[e >> 1] + kt * kB + col));
        if ((diag && col > row) || (!HasBias && kt * kB + col >= n.sk))
          sv = apex::kNegInf;
        s[j][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];  // this lane's part of the row sum
    }
    // p = exp(s - m) summed undropped, then dropped and rescaled
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += p;
        float pv = p;
        if (drop.on)
          pv = hash_keep(qt * kB + r[e >> 1],
                         kt * kB + j * 8 + 2 * t + (e & 1), base,
                         drop.thresh)
                   ? p * drop.inv_keep
                   : 0.f;
        s[j][e] = pv;
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
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qt * kB + r[i];
    if (qpos >= n.sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    E* orow = o + (static_cast<long>(bh) * n.sq + qpos) * n.d;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < n.d)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack2<E>(acc[j][2 * i] / safe_l,
                                  acc[j][2 * i + 1] / safe_l);
    }
    if (t == 0)
      lse[static_cast<long>(bh) * n.sq + qpos] =
          l[i] == 0.f ? apex::kNegInf : m[i] + logf(safe_l);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (kv tile, bh), walking the q tiles from the causal
// diagonal on

// warps that share 16 keys, each owning 1 / SPLIT of dK's and dV's columns
template <int D>
__host__ __device__ constexpr int dkv_split() {
  return D >= 128 ? 2 : 1;
}

// three blocks an SM at D <= 64 (at most 168 registers a thread)
template <typename E, int D, bool HasBias>
__global__ void __launch_bounds__(128 * dkv_split<D>(), D <= 64 ? 3 : 1)
    flash_mma_dkv_kernel(const E* __restrict__ q,
                         const E* __restrict__ k,
                         const E* __restrict__ v,
                         const E* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias,
                         E* __restrict__ dk, E* __restrict__ dv,
                         Dims n, float scale, int causal, Dropout drop) {
  constexpr int S = kStride<D>, NB = kB / 8, SPLIT = dkv_split<D>();
  constexpr int DC = D / SPLIT, NC = DC / 8, NT = 128 * SPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  E* sK = reinterpret_cast<E*>(smem);
  E* sV = sK + kB * S;
  E* sQ = sV + kB * S;      // two stages
  E* sO = sQ + 2 * kB * S;  // dO, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * kB * S);  // two stages
  float* sD = sL + 2 * kB;                                // two stages
  const int kt = blockIdx.x;  // causal: low tiles have the most q tiles
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp % 4, c0 = (warp / 4) * DC;  // keys 16 slab.., cols
  const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;
  const int qt0 = causal ? kt : 0, nqt = tiles(n.sq);

  {
    const long kbase = (static_cast<long>(bh) * n.sk + kt * kB) * n.d;
    const int rows = min(kB, n.sk - kt * kB);
    tile_async<D>(sK, k + kbase, rows, n.d, tid, NT);
    tile_async<D>(sV, v + kbase, rows, n.d, tid, NT);
  }
  auto stage_q = [&](int qt) {
    const int st = (qt - qt0) & 1;
    const long row0 = static_cast<long>(bh) * n.sq + qt * kB;
    const int rows = min(kB, n.sq - qt * kB);
    tile_async<D>(sQ + st * kB * S, q + row0 * n.d, rows, n.d, tid, NT);
    tile_async<D>(sO + st * kB * S, dout + row0 * n.d, rows, n.d, tid, NT);
    rows_async(sL + st * kB, lse + row0, rows, tid);
    rows_async(sD + st * kB, delta + row0, rows, tid - 32);
  };
  stage_q(qt0);
  cp_async_commit();

  // this thread's keys of the tile: kr[0] = 16 slab + g and kr[1] = + 8
  const int kr[2] = {slab * 16 + g, slab * 16 + g + 8};
  const float* bcol[2];  // its bias columns: q row i at bcol[i * bsk]
#pragma unroll
  for (int i = 0; i < 2; ++i)
    bcol[i] = HasBias ? bias + static_cast<long>(bh % n.heads) * n.bsq * n.bsk
                            + kt * kB + kr[i]
                      : nullptr;
  float dka[NC][4], dva[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int qt = qt0; qt < nqt; ++qt) {
    __syncthreads();  // every warp is done with the stage refilled next
    if (qt + 1 < nqt) stage_q(qt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this q tile (and K, V) have landed
    __syncthreads();
    const int st = (qt - qt0) & 1;
    const E* cQ = sQ + st * kB * S;
    const E* cO = sO + st * kB * S;
    const float* cL = sL + st * kB;
    const float* cD = sD + st * kB;

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x 64 q rows a warp
    float sc[NB][4], dp[NB][4];
    mma_abt<D>(sc, sK, slab * 16, cQ, lane);
    mma_abt<D>(dp, sV, slab * 16, cO, lane);

    // p, the dropped p (into sc) and ds (into dp)
    const bool diag = causal && kt == qt;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kr[e >> 1], i = j * 8 + 2 * t + (e & 1);
        const int qpos = qt * kB + i;
        float sv = sc[j][e] * scale;
        if constexpr (HasBias)
          sv = __fadd_rn(sv, __ldg(bcol[e >> 1] +
                                   static_cast<long>(qpos) * n.bsk));
        // kpos > qpos, or a row past sq (with a bias, its NEG_INF does it)
        if ((diag && key > i) || (!HasBias && qpos >= n.sq))
          sv = apex::kNegInf;
        const float p = expf(sv - cL[i]);
        float dpv = dp[j][e], pv = p;
        if (drop.on) {
          const bool keep =
              hash_keep(qpos, kt * kB + key, base, drop.thresh);
          pv = keep ? p * drop.inv_keep : 0.f;
          dpv = keep ? dpv * drop.inv_keep : 0.f;
        }
        sc[j][e] = pv;
        dp[j][e] = p * (dpv - cD[i]) * scale;
      }
    }

    // dV += round_E(P dropped)^T dO, dK += round_E(dS)^T Q over this
    // warp's columns c0 .. c0 + DC - 1
    mma_pv<D, NC>(dva, sc, cO, c0, lane);
    mma_pv<D, NC>(dka, dp, cQ, c0, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = kt * kB + kr[i];
    if (kpos >= n.sk) continue;
    const long row = (static_cast<long>(bh) * n.sk + kpos) * n.d;
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
// dQ: one block per (q tile, bh), walking the K/V tiles up to the causal
// diagonal

// warps that share 16 q rows, each owning 1 / SPLIT of dQ's columns
template <int D>
__host__ __device__ constexpr int dq_split() {
  return D >= 256 ? 2 : 1;
}

// three blocks an SM at D <= 64 (at most 168 registers a thread), two at
// D = 128: what their shared memory allows
template <typename E, int D, bool HasBias>
__global__ void __launch_bounds__(128 * dq_split<D>(),
                                  D <= 64 ? 3 : D == 128 ? 2 : 1)
    flash_mma_dq_kernel(const E* __restrict__ q,
                        const E* __restrict__ k,
                        const E* __restrict__ v,
                        const E* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias,
                        E* __restrict__ dq, Dims n, float scale,
                        int causal, Dropout drop) {
  constexpr int S = kStride<D>, NB = kB / 8, SPLIT = dq_split<D>();
  constexpr int DC = D / SPLIT, NC = DC / 8, NT = 128 * SPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  E* sQ = reinterpret_cast<E*>(smem);
  E* sO = sQ + kB * S;      // dO
  E* sK = sO + kB * S;      // two stages
  E* sV = sK + 2 * kB * S;  // two stages
  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp % 4, c0 = (warp / 4) * DC;  // rows 16 slab.., cols
  const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;
  const int nkt = causal ? qt + 1 : tiles(n.sk);

  {
    const long row0 = static_cast<long>(bh) * n.sq + qt * kB;
    const int rows = min(kB, n.sq - qt * kB);
    tile_async<D>(sQ, q + row0 * n.d, rows, n.d, tid, NT);
    tile_async<D>(sO, dout + row0 * n.d, rows, n.d, tid, NT);
  }
  auto stage_kv = [&](int kt) {
    const long kbase = (static_cast<long>(bh) * n.sk + kt * kB) * n.d;
    const int rows = min(kB, n.sk - kt * kB);
    tile_async<D>(sK + (kt & 1) * kB * S, k + kbase, rows, n.d, tid, NT);
    tile_async<D>(sV + (kt & 1) * kB * S, v + kbase, rows, n.d, tid, NT);
  };
  stage_kv(0);
  cp_async_commit();

  // this thread's rows of the tile: r[0] = 16 slab + g and r[1] = r[0] + 8
  const int r[2] = {slab * 16 + g, slab * 16 + g + 8};
  const float* brow[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qt * kB + r[i];
    brow[i] = bias_row<HasBias>(bias, bh % n.heads, qpos, n);
    const long row = static_cast<long>(bh) * n.sq + min(qpos, n.sq - 1);
    lse_r[i] = qpos < n.sq ? lse[row] : 0.f;
    delta_r[i] = qpos < n.sq ? delta[row] : 0.f;
  }
  float acc[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // every warp is done with the stage refilled next
    if (kt + 1 < nkt) stage_kv(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) have landed
    __syncthreads();
    const E* cK = sK + (kt & 1) * kB * S;
    const E* cV = sV + (kt & 1) * kB * S;

    // S = Q K^T and dP = dO V^T, 16 q rows x 64 keys a warp
    float sc[NB][4], dp[NB][4];
    mma_abt<D>(sc, sQ, slab * 16, cK, lane);
    mma_abt<D>(dp, sO, slab * 16, cV, lane);

    // ds = p * (dp - delta) * scale (into sc), p = exp(s - lse)
    const bool diag = causal && kt == qt;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r[e >> 1], col = j * 8 + 2 * t + (e & 1);
        float sv = sc[j][e] * scale;
        if constexpr (HasBias)
          sv = __fadd_rn(sv, __ldg(brow[e >> 1] + kt * kB + col));
        if ((diag && col > row) || (!HasBias && kt * kB + col >= n.sk))
          sv = apex::kNegInf;
        const float p = expf(sv - lse_r[e >> 1]);
        float dpv = dp[j][e];
        if (drop.on)
          dpv = hash_keep(qt * kB + row, kt * kB + col, base, drop.thresh)
                    ? dpv * drop.inv_keep
                    : 0.f;
        sc[j][e] = p * (dpv - delta_r[e >> 1]) * scale;
      }
    }

    // dQ += round_E(dS) K over this warp's columns c0 .. c0 + DC - 1
    mma_pv<D, NC>(acc, sc, cK, c0, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qt * kB + r[i];
    if (qpos >= n.sq) continue;
    E* row = dq + (static_cast<long>(bh) * n.sq + qpos) * n.d;
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
// d(bias): one block per (k tile, q tile, head x batch chunk) output tile,
// walking its chunk of the batch in order

// stages of the Q/dO/K/V ring across batch items: two where shared memory
// holds eight tiles (D <= 128), one at D = 256
template <int D>
__host__ __device__ constexpr int dbias_stages() {
  return D <= 128 ? 2 : 1;
}

// bytes of one stage: four tiles and 64 lse and 64 delta values
template <int D>
constexpr int dbias_stage_bytes = 4 * tile_bytes<D> + 2 * kB * 4;

// two blocks an SM at D <= 64
template <typename E, int D>
__global__ void __launch_bounds__(128, D <= 64 ? 2 : 1)
    flash_mma_dbias_kernel(const E* __restrict__ q,
                           const E* __restrict__ k,
                           const E* __restrict__ v,
                           const E* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ bias,
                           float* __restrict__ db, Dims n, int nb,
                           int chunks, float scale, int causal,
                           Dropout drop) {
  constexpr int S = kStride<D>, NB = kB / 8, ST = dbias_stages<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int kt = blockIdx.x, qt = blockIdx.y;
  const int head = blockIdx.z % n.heads, chunk = blockIdx.z / n.heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // this block's batch items: [b0, b1), the chunks in batch order
  const int b0 = chunk * nb / chunks, b1 = (chunk + 1) * nb / chunks;
  // its output: db itself (one chunk) or the chunk's (heads, bsq, bsk)
  // partial, added in chunk order by dbias_merge_kernel
  float* out = db + static_cast<long>(chunk) * n.heads * n.bsq * n.bsk +
               (static_cast<long>(head) * n.bsq + qt * kB) * n.bsk + kt * kB;
  if (causal && kt > qt) {  // above the diagonal: no score is live
    for (int u = tid; u < kB * kB / 4; u += 128)
      *reinterpret_cast<float4*>(out + (u / (kB / 4)) * n.bsk +
                                 (u % (kB / 4)) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  unsigned char* const ring = smem;
  auto stage = [&](int b) {
    unsigned char* at = ring + ((b - b0) % ST) * dbias_stage_bytes<D>;
    E* tQ = reinterpret_cast<E*>(at);
    const int bh = b * n.heads + head;
    const long qrow0 = static_cast<long>(bh) * n.sq + qt * kB;
    const long krow0 = static_cast<long>(bh) * n.sk + kt * kB;
    const int qrows = min(kB, n.sq - qt * kB);
    const int krows = min(kB, n.sk - kt * kB);
    tile_async<D>(tQ, q + qrow0 * n.d, qrows, n.d, tid, 128);
    tile_async<D>(tQ + kB * S, dout + qrow0 * n.d, qrows, n.d, tid, 128);
    tile_async<D>(tQ + 2 * kB * S, k + krow0 * n.d, krows, n.d, tid, 128);
    tile_async<D>(tQ + 3 * kB * S, v + krow0 * n.d, krows, n.d, tid, 128);
    float* rows = reinterpret_cast<float*>(tQ + 4 * kB * S);
    rows_async(rows, lse + qrow0, qrows, tid);
    rows_async(rows + kB, delta + qrow0, qrows, tid - 32);
  };
  stage(b0);
  cp_async_commit();

  // this thread's rows of the tile: r[0] = 16 warp + g and r[1] = r[0] + 8
  const int r[2] = {warp * 16 + g, warp * 16 + g + 8};
  // their bias over the tile's keys (NEG_INF past sq and sk)
  const float* brow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    brow[i] = bias_row<true>(bias, head, qt * kB + r[i], n) + kt * kB;
  const bool diag = causal && kt == qt;
  float acc[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int b = b0; b < b1; ++b) {
    if constexpr (ST == 2) {
      __syncthreads();  // every warp is done with the stage refilled next
      if (b + 1 < b1) stage(b + 1);
      cp_async_commit();
      cp_async_wait<1>();  // this batch item's tiles have landed
    } else {
      if (b > b0) {
        __syncthreads();  // every warp is done with the one stage
        stage(b);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* at = ring + ((b - b0) % ST) * dbias_stage_bytes<D>;
    const E* cQ = reinterpret_cast<const E*>(at);
    const E* cO = cQ + kB * S;
    const E* cK = cQ + 2 * kB * S;
    const E* cV = cQ + 3 * kB * S;
    const float* cL = reinterpret_cast<const float*>(cQ + 4 * kB * S);
    const float* cD = cL + kB;
    const int bh = b * n.heads + head;
    const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;

    float sc[NB][4], dp[NB][4];
    mma_abt<D>(sc, cQ, warp * 16, cK, lane);
    mma_abt<D>(dp, cO, warp * 16, cV, lane);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r[e >> 1], col = j * 8 + 2 * t + (e & 1);
        float sv = __fadd_rn(sc[j][e] * scale, __ldg(brow[e >> 1] + col));
        if (diag && col > row) sv = apex::kNegInf;  // pads: bias NEG_INF
        const float p = expf(sv - cL[row]);
        float dpv = dp[j][e];
        if (drop.on)
          dpv = hash_keep(qt * kB + row, kt * kB + col, base, drop.thresh)
                    ? dpv * drop.inv_keep
                    : 0.f;
        // rounded before the sum, as JAX adds p * (dp - delta) to its
        // scratch
        acc[j][e] = __fadd_rn(acc[j][e], __fmul_rn(p, dpv - cD[row]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
      *reinterpret_cast<float2*>(out + r[i] * n.bsk + j * 8 + 2 * t) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
}

// db = the sum of the chunks' partials, in chunk order; float4 a thread
__global__ void dbias_merge_kernel(const float4* __restrict__ part,
                                   float4* __restrict__ db, long n4,
                                   int chunks) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = part[i];
  for (int c = 1; c < chunks; ++c) {
    const float4 x = part[c * n4 + i];
    s.x += x.x;
    s.y += x.y;
    s.z += x.z;
    s.w += x.w;
  }
  db[i] = s;
}

template <typename E, int D, bool HasBias>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, void* o, void* lse, Dims n, int bh,
                       float scale, int causal, Dropout drop,
                       cudaStream_t s) {
  auto kernel = flash_mma_fwd_kernel<E, D, HasBias>;
  constexpr int smem = 5 * tile_bytes<D>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles(n.sq), bh), kFwdThreads, smem, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const float*>(bias),
      static_cast<E*>(o), static_cast<float*>(lse), n, scale, causal,
      drop);
  return cudaSuccess;
}

template <typename E, int D, bool HasBias>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* bias, void* dk, void* dv, Dims n, int bh,
                       float scale, int causal, Dropout drop,
                       cudaStream_t s) {
  auto kernel = flash_mma_dkv_kernel<E, D, HasBias>;
  constexpr int smem = 6 * tile_bytes<D> + 4 * kB * 4;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles(n.sk), bh), 128 * dkv_split<D>(), smem, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<E*>(dk),
      static_cast<E*>(dv), n, scale, causal, drop);
  return cudaSuccess;
}

template <typename E, int D, bool HasBias>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* bias, void* dq, Dims n, int bh, float scale,
                      int causal, Dropout drop, cudaStream_t s) {
  auto kernel = flash_mma_dq_kernel<E, D, HasBias>;
  constexpr int smem = 6 * tile_bytes<D>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles(n.sq), bh), 128 * dq_split<D>(), smem, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const E*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<E*>(dq), n, scale,
      causal, drop);
  return cudaSuccess;
}

// with chunks > 1 the main launch writes the chunks' partials to `part`
// ((chunks, heads, bsq, bsk) fp32) and a second adds them into db
template <typename E, int D>
cudaError_t launch_dbias(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         const void* bias, void* db, void* part, Dims n,
                         int bh, int chunks, float scale, int causal,
                         Dropout drop, cudaStream_t s) {
  auto kernel = flash_mma_dbias_kernel<E, D>;
  constexpr int smem = dbias_stages<D>() * dbias_stage_bytes<D>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles(n.sk), tiles(n.sq), n.heads * chunks), 128, smem,
           s>>>(static_cast<const E*>(q), static_cast<const E*>(k),
                static_cast<const E*>(v), static_cast<const E*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta),
                static_cast<const float*>(bias),
                static_cast<float*>(chunks > 1 ? part : db), n, bh / n.heads,
                chunks, scale, causal, drop);
  if (chunks == 1) return cudaSuccess;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long n4 = static_cast<long>(n.heads) * n.bsq * n.bsk / 4;
  dbias_merge_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float4*>(part), static_cast<float4*>(db), n4, chunks);
  return cudaSuccess;
}

// FN<E, D, HasBias>(args...) at the element type of `dtype` (bf16 or
// fp16) and the instantiated head dim that takes d (32, 64, 128 or 256),
// the bias kernels for a non-null `bias`
#define APEX_MMA_CASE(DIM, FN, ...)                                     \
  case DIM:                                                             \
    return status_of(bias != nullptr ? FN<E, DIM, true>(__VA_ARGS__)    \
                                     : FN<E, DIM, false>(__VA_ARGS__));
#define APEX_MMA_DIMS(FN, ...)                                          \
  switch (flash_head_dim(d)) {                                          \
    APEX_MMA_CASE(32, FN, __VA_ARGS__)                                  \
    APEX_MMA_CASE(64, FN, __VA_ARGS__)                                  \
    APEX_MMA_CASE(128, FN, __VA_ARGS__)                                 \
    APEX_MMA_CASE(256, FN, __VA_ARGS__)                                 \
    default: return static_cast<int>(cudaErrorInvalidValue);            \
  }
#define APEX_MMA_DISPATCH(FN, ...)                                      \
  do {                                                                  \
    if (dtype == apex::kBF16) {                                         \
      using E = __nv_bfloat16;                                          \
      APEX_MMA_DIMS(FN, __VA_ARGS__)                                    \
    } else if (dtype == apex::kF16) {                                   \
      using E = __half;                                                 \
      APEX_MMA_DIMS(FN, __VA_ARGS__)                                    \
    }                                                                   \
    return static_cast<int>(cudaErrorInvalidValue);                     \
  } while (0)

// FN<E, D>(args...) at the element type of `dtype` and the instantiated
// head dim that takes d
#define APEX_MMA_DIMS_D(FN, ...)                                        \
  switch (flash_head_dim(d)) {                                          \
    case 32: return status_of(FN<E, 32>(__VA_ARGS__));                  \
    case 64: return status_of(FN<E, 64>(__VA_ARGS__));                  \
    case 128: return status_of(FN<E, 128>(__VA_ARGS__));                \
    case 256: return status_of(FN<E, 256>(__VA_ARGS__));                \
    default: return static_cast<int>(cudaErrorInvalidValue);            \
  }
#define APEX_MMA_DISPATCH_D(FN, ...)                                    \
  do {                                                                  \
    if (dtype == apex::kBF16) {                                         \
      using E = __nv_bfloat16;                                          \
      APEX_MMA_DIMS_D(FN, __VA_ARGS__)                                  \
    } else if (dtype == apex::kF16) {                                   \
      using E = __half;                                                 \
      APEX_MMA_DIMS_D(FN, __VA_ARGS__)                                  \
    }                                                                   \
    return static_cast<int>(cudaErrorInvalidValue);                     \
  } while (0)

}  // namespace

// The entry points of flash_attention.cu's forward, dQ, dK/dV and d(bias),
// with their arguments (see there; d(bias) takes its batch chunks too),
// for bf16 or fp16 inputs (dtype 1 or 2) and d a multiple of 8 up to 256;
// anything else returns cudaErrorInvalidValue.
extern "C" int flash_mma_fwd(int device, const void* q, const void* k,
                             const void* v, const void* bias, void* o,
                             void* lse, int heads, int bh, int sq, int sk,
                             int d, float scale, int causal, int dropout,
                             unsigned seed, unsigned thresh, float inv_keep,
                             int dtype, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  const Dims n{heads, sq, sk, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_MMA_DISPATCH(launch_fwd, q, k, v, bias, o, lse, n, bh, scale, causal,
                    drop, s);
}

extern "C" int flash_mma_bwd_dkv(int device, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 const void* bias, void* dk, void* dv,
                                 int heads, int bh, int sq, int sk, int d,
                                 float scale, int causal, int dropout,
                                 unsigned seed, unsigned thresh,
                                 float inv_keep, int dtype, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  const Dims n{heads, sq, sk, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_MMA_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, bias, dk, dv, n,
                    bh, scale, causal, drop, s);
}

extern "C" int flash_mma_bwd_dq(int device, const void* q, const void* k,
                                const void* v, const void* dout,
                                const void* lse, const void* delta,
                                const void* bias, void* dq, int heads, int bh,
                                int sq, int sk, int d, float scale,
                                int causal, int dropout, unsigned seed,
                                unsigned thresh, float inv_keep, int dtype,
                                void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  const Dims n{heads, sq, sk, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_MMA_DISPATCH(launch_dq, q, k, v, dout, lse, delta, bias, dq, n, bh,
                    scale, causal, drop, s);
}

// flash_attention.cu's d(bias) entry, with the batch in `chunks` ordered
// chunks (1 <= chunks <= bh / heads): above one, `part` is an fp32
// (chunks, heads, bsq, bsk) scratch for the chunks' partials (null
// otherwise)
extern "C" int flash_mma_bwd_dbias(int device, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* bias, void* db, void* part,
                                   int heads, int bh, int sq, int sk, int d,
                                   float scale, int causal, int dropout,
                                   unsigned seed, unsigned thresh,
                                   float inv_keep, int dtype, int chunks,
                                   void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (bias == nullptr || heads <= 0 || bh % heads != 0 || chunks < 1 ||
      chunks > bh / heads || (chunks > 1) != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{dropout, seed, thresh, inv_keep};
  const Dims n{heads, sq, sk, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_MMA_DISPATCH_D(launch_dbias, q, k, v, dout, lse, delta, bias, db,
                      part, n, bh, chunks, scale, causal, drop, s);
}
