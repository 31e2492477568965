// Packed variable-length flash attention, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of apex_tpu/ops/attention_varlen.py, for fp32
// inputs and bf16 and fp16 above head_dim 256 (up to 256 those run the
// tensor-core kernels of flash_varlen_mma.cu):
//   * `_vl_fwd_kernel` (reached through `_vl_call`, pallas_call at :377):
//     o and the row log-sum-exp lse;
//   * `_vl_bwd_dq_kernel` (`_vl_bwd_call`, pallas_call at :414): dQ;
//   * `_vl_bwd_dkv_kernel` (`_vl_bwd_call`, pallas_call at :451): dK, dV.
//
// Math, exactly the JAX kernels' (all accumulation in fp32): a score
// s = (q . k) * scale is allowed where seg_q == seg_k >= 0 (and kpos <=
// qpos when causal, absolute positions in the packed row); elsewhere it is
// NEG_INF and p is 0 by value. Forward: online softmax over K/V chunks
// with running max m and sum l, the correction exp(m_prev - m_new) taken
// as 0 while m_prev is NEG_INF; p is rounded to the input type before
// p @ v; o = acc / l, lse = m + log(l), and a row with no allowed score
// (a pad row) gives o = 0 and lse = NEG_INF. Backward, from lse and
// delta = sum(dO * O) per row: p = allowed ? exp(s - lse) : 0 (by value: a
// pad row's lse is NEG_INF and exp(s - lse) would be 1), dp = dO . v,
// ds = p * (dp - delta) * scale; dQ = sum ds * k, dK = sum ds * q, dV =
// sum p * dO, with ds and p rounded to the input type before each product.
//
// Bound on this card: the live scores S (sum over documents of L^2, or
// L(L+1)/2 causal) per head set the operations, 4, 6 and 8 * h * S * d for
// the three kernels; at GPT-2's attention width (12 heads of 64) and
// documents of 64-1024 tokens they bound all three on the tensor cores'
// rate. These kernels run their products on the CUDA cores in fp32 (the
// flash kernels' tiling), so they sit far above that bound: fp32 keeps
// them, as TF32 on the tensor cores would break the fp32 gates.
//
// Design: the flash kernels' tiles and row layout (flash_tile.cuh), over a
// packed row padded to a multiple of 64 with segment -1. JAX clamps its K/V
// index maps into each q block's live range [jlo, jhi] and skips the
// blocks in it that cannot meet (`_skip`); here one block per (q tile,
// batch*head) walks exactly that range and skips the same tiles, and a q
// tile with an empty range still writes its zeros and NEG_INF. JAX walks q
// sequentially into one dK/dV block; here one owner block per (K/V tile,
// batch*head) walks its live q range [ilo, ihi] in order, so nothing is
// summed across blocks: no atomics, the same bits on every run, and a K/V
// tile that no q meets writes zeros. The per-tile tables come from the
// wrapper, computed with torch on the card (no host sync): qr[b][qt] =
// (qmin, qmax, jlo, jhi) of the q tile's segment ids, kr[b][kt] = (kmin,
// kmax, ilo, ihi). The min is over the tile's real tokens: JAX counts a
// pad as -1, which makes the tile holding a document's end and padding
// meet every tile, and its block walk the whole row. Each block stages
// the tile's segment ids beside K/V (or Q/dO) in shared memory. From D =
// 512 on the tiles are 32, 16 or 8 rows (flash_tile.cuh, D = 512, 1024,
// 2048): a block reads its part of a 64-row table entry and walks every
// part of each live entry. Above 2048 the wide kernels (flash_wide.cuh)
// walk the same live ranges in 8-row tiles with the head dim in chunks of
// 2048 columns.

#include "flash_wide.cuh"

namespace {

struct Dims {
  int h, sq, sk, d;
};

// ---------------------------------------------------------------------------
// forward: o and lse; one block per (q tile, b*h)

// at most 128 registers a thread, as the flash forward
template <typename T, int D, int BR>
__global__ void __launch_bounds__(row_threads(D),
                                  D == 2048 ? 1 : 512 / row_threads(D))
    varlen_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ seg_q,
                      const int* __restrict__ seg_k,
                      const int4* __restrict__ qr,
                      const int4* __restrict__ kr, T* __restrict__ o,
                      float* __restrict__ lse, Dims n, float scale,
                      int causal) {
  constexpr int DPT = row_dims(D), TPR = D / DPT, NT = BR * TPR;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + BR * D;
  int* sSeg = reinterpret_cast<int*>(smem + 2 * BR * D);
  constexpr int SUB = kB / BR;  // tiles of a 64-row table entry
  const int nq = gridDim.x / SUB, nk = n.sk / kB;
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / n.h;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const int qpos = qt * BR + r;
  const int seg = seg_q[static_cast<long>(b) * n.sq + qpos];

  float qr_[DPT], acc[DPT];
  const long qrow = (static_cast<long>(bh) * n.sq + qpos) * n.d;
  load_row_part<T, DPT, TPR>(q + qrow, qr_, h, n.d);
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = apex::kNegInf, l = 0.f;

  const int4 qi = qr[static_cast<long>(b) * nq + qt / SUB];
  for (int kt = qi.z * SUB; kt <= qi.w * SUB + SUB - 1; ++kt) {
    if (!tiles_meet<BR>(qi, kr[static_cast<long>(b) * nk + kt / SUB], qt, kt,
                        causal))
      continue;  // the same for the whole block
    __syncthreads();  // the previous tile's readers are done
    const long kbase = (static_cast<long>(bh) * n.sk + kt * BR) * n.d;
    stage_tile<T, D, BR>(sK, k + kbase, BR, n.d, NT);
    stage_tile<T, D, BR>(sV, v + kbase, BR, n.d, NT);
    for (int j = threadIdx.x; j < BR; j += NT)
      sSeg[j] = seg_k[static_cast<long>(b) * n.sk + kt * BR + j];
    __syncthreads();
    constexpr int CH = chunk_keys(BR);
    for (int j0 = 0; j0 < BR; j0 += CH) {
      float s[CH];
      bool ok[CH];
      float cmax = apex::kNegInf;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = j0 + jj;
        const float sv =
            group_sum<TPR>(dot_part<DPT, TPR>(qr_, sK + j * D, h)) * scale;
        ok[jj] =
            seg >= 0 && sSeg[j] == seg && (!causal || kt * BR + j <= qpos);
        s[jj] = ok[jj] ? sv : apex::kNegInf;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = m <= 0.5f * apex::kNegInf ? 0.f : expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        s[jj] = ok[jj] ? expf(s[jj] - m_new) : 0.f;
        psum += s[jj];
      }
      l = corr * l + psum;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj)
        axpy_part<DPT, TPR>(acc, round_to<T>(s[jj]), sV + (j0 + jj) * D, h);
      m = m_new;
    }
  }
  const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] /= safe_l;
  store_row_part<T, DPT, TPR>(o + qrow, acc, h, n.d);
  if (h == 0)
    lse[static_cast<long>(bh) * n.sq + qpos] =
        l == 0.f ? apex::kNegInf : m + logf(safe_l);
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, b*h), over the q tile's live K/V tiles

template <typename T, int D, int BR>
__global__ void __launch_bounds__(row_threads(D))
    varlen_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k,
                     const int4* __restrict__ qr, const int4* __restrict__ kr,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dq,
                     Dims n, float scale, int causal) {
  constexpr int DPT = row_dims(D), TPR = D / DPT, NT = BR * TPR;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + BR * D;
  int* sSeg = reinterpret_cast<int*>(smem + 2 * BR * D);
  constexpr int SUB = kB / BR;  // tiles of a 64-row table entry
  const int nq = gridDim.x / SUB, nk = n.sk / kB;
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / n.h;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const int qpos = qt * BR + r;
  const int seg = seg_q[static_cast<long>(b) * n.sq + qpos];

  float qr_[DPT], dor[DPT], acc[DPT];
  const long qrow = (static_cast<long>(bh) * n.sq + qpos) * n.d;
  load_row_part<T, DPT, TPR>(q + qrow, qr_, h, n.d);
  load_row_part<T, DPT, TPR>(dout + qrow, dor, h, n.d);
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  const float lse_r = lse[static_cast<long>(bh) * n.sq + qpos];
  const float delta_r = delta[static_cast<long>(bh) * n.sq + qpos];

  const int4 qi = qr[static_cast<long>(b) * nq + qt / SUB];
  for (int kt = qi.z * SUB; kt <= qi.w * SUB + SUB - 1; ++kt) {
    if (!tiles_meet<BR>(qi, kr[static_cast<long>(b) * nk + kt / SUB], qt, kt,
                        causal))
      continue;
    __syncthreads();
    const long kbase = (static_cast<long>(bh) * n.sk + kt * BR) * n.d;
    stage_tile<T, D, BR>(sK, k + kbase, BR, n.d, NT);
    stage_tile<T, D, BR>(sV, v + kbase, BR, n.d, NT);
    for (int j = threadIdx.x; j < BR; j += NT)
      sSeg[j] = seg_k[static_cast<long>(b) * n.sk + kt * BR + j];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BR; ++j) {
      const float sv =
          group_sum<TPR>(dot_part<DPT, TPR>(qr_, sK + j * D, h)) * scale;
      const bool ok =
          seg >= 0 && sSeg[j] == seg && (!causal || kt * BR + j <= qpos);
      const float p = ok ? expf(sv - lse_r) : 0.f;
      const float dp = group_sum<TPR>(dot_part<DPT, TPR>(dor, sV + j * D, h));
      const float ds = p * (dp - delta_r) * scale;
      axpy_part<DPT, TPR>(acc, round_to<T>(ds), sK + j * D, h);
    }
  }
  store_row_part<T, DPT, TPR>(dq + qrow, acc, h, n.d);
}

// ---------------------------------------------------------------------------
// dK, dV: one owner block per (kv tile, b*h), over the tile's live q tiles
// in order

template <typename T, int D, int BR>
__global__ void __launch_bounds__(BR * (D / dkv_dims(D)))
    varlen_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ seg_q,
                      const int* __restrict__ seg_k,
                      const int4* __restrict__ qr,
                      const int4* __restrict__ kr,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Dims n, float scale, int causal) {
  constexpr int DPT = dkv_dims(D), TPR = D / DPT, NT = BR * TPR;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sO = smem + BR * D;  // dO
  float* sL = smem + 2 * BR * D;
  float* sD = sL + BR;
  int* sSeg = reinterpret_cast<int*>(sD + BR);
  constexpr int SUB = kB / BR;  // tiles of a 64-row table entry
  const int nq = n.sq / kB, nk = gridDim.x / SUB;
  const int kt = blockIdx.x, bh = blockIdx.y, b = bh / n.h;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const int kpos = kt * BR + r;
  const int seg = seg_k[static_cast<long>(b) * n.sk + kpos];

  float kr_[DPT], vr[DPT], dka[DPT], dva[DPT];
  const long krow = (static_cast<long>(bh) * n.sk + kpos) * n.d;
  load_row_part<T, DPT, TPR>(k + krow, kr_, h, n.d);
  load_row_part<T, DPT, TPR>(v + krow, vr, h, n.d);
#pragma unroll
  for (int i = 0; i < DPT; ++i) dka[i] = dva[i] = 0.f;

  const int4 ki = kr[static_cast<long>(b) * nk + kt / SUB];
  for (int qt = ki.z * SUB; qt <= ki.w * SUB + SUB - 1; ++qt) {
    if (!tiles_meet<BR>(qr[static_cast<long>(b) * nq + qt / SUB], ki, qt, kt,
                        causal))
      continue;
    __syncthreads();
    const long qbase = (static_cast<long>(bh) * n.sq + qt * BR) * n.d;
    stage_tile<T, D, BR>(sQ, q + qbase, BR, n.d, NT);
    stage_tile<T, D, BR>(sO, dout + qbase, BR, n.d, NT);
    for (int i = threadIdx.x; i < BR; i += NT) {
      sL[i] = lse[static_cast<long>(bh) * n.sq + qt * BR + i];
      sD[i] = delta[static_cast<long>(bh) * n.sq + qt * BR + i];
      sSeg[i] = seg_q[static_cast<long>(b) * n.sq + qt * BR + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BR; ++i) {
      const float sv =
          group_sum<TPR>(dot_part<DPT, TPR>(kr_, sQ + i * D, h)) * scale;
      const bool ok =
          sSeg[i] >= 0 && sSeg[i] == seg && (!causal || kpos <= qt * BR + i);
      const float p = ok ? expf(sv - sL[i]) : 0.f;
      const float dp = group_sum<TPR>(dot_part<DPT, TPR>(vr, sO + i * D, h));
      axpy_part<DPT, TPR>(dva, round_to<T>(p), sO + i * D, h);
      const float ds = p * (dp - sD[i]) * scale;
      axpy_part<DPT, TPR>(dka, round_to<T>(ds), sQ + i * D, h);
    }
  }
  store_row_part<T, DPT, TPR>(dk + krow, dka, h, n.d);
  store_row_part<T, DPT, TPR>(dv + krow, dva, h, n.d);
}

// ---------------------------------------------------------------------------
// head dims above 2048 (flash_wide.cuh): the same three functions with the
// head dim in chunks of kWideCols columns, 8-row tiles (an eighth of a
// 64-row table entry); the forward in two launches, lse first, then o

// key j of tile kt may be attended by query qpos of segment seg: its score
// scaled, NEG_INF elsewhere (ok[j] false)
__device__ __forceinline__ void varlen_wide_scores(float (&s)[kWideRows],
                                                   bool (&ok)[kWideRows],
                                                   const int* kseg, int seg,
                                                   int kt, int qpos,
                                                   float scale, int causal) {
#pragma unroll
  for (int j = 0; j < kWideRows; ++j) {
    const int kpos = kt * kWideRows + j;
    ok[j] = seg >= 0 && __ldg(kseg + kpos) == seg && (!causal || kpos <= qpos);
    s[j] = ok[j] ? s[j] * scale : apex::kNegInf;
  }
}

// the forward's first launch: each row's lse over its q tile's live K/V
// tiles; one block per (q tile, b*h)
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    varlen_wide_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const int* __restrict__ seg_q,
                             const int* __restrict__ seg_k,
                             const int4* __restrict__ qr,
                             const int4* __restrict__ kr,
                             float* __restrict__ lse, Dims n, float scale,
                             int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int SUB = kB / kWideRows;  // tiles of a 64-row table entry
  const int nq = gridDim.x / SUB, nk = n.sk / kB;
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / n.h;
  const int r = threadIdx.x / kWideLanes, lane = threadIdx.x % kWideLanes;
  const int qpos = qt * kWideRows + r;
  const int seg = seg_q[static_cast<long>(b) * n.sq + qpos];
  const T* qrow = q + (static_cast<long>(bh) * n.sq + qpos) * n.d;
  const int* kseg = seg_k + static_cast<long>(b) * n.sk;
  float m = apex::kNegInf, l = 0.f;
  const int4 qi = qr[static_cast<long>(b) * nq + qt / SUB];
  for (int kt = qi.z * SUB; kt <= qi.w * SUB + SUB - 1; ++kt) {
    if (!tiles_meet<kWideRows>(qi, kr[static_cast<long>(b) * nk + kt / SUB],
                               qt, kt, causal))
      continue;  // the same for the whole block
    float s[1][kWideRows];
    bool ok[kWideRows];
    wide_dots<T, 1>(s, {qrow}, true,
                    {k + (static_cast<long>(bh) * n.sk + kt * kWideRows) *
                             n.d},
                    kWideRows, n.d, {smem}, lane);
    varlen_wide_scores(s[0], ok, kseg, seg, kt, qpos, scale, causal);
    float mx = m;
#pragma unroll
    for (int j = 0; j < kWideRows; ++j) mx = fmaxf(mx, s[0][j]);
    const float corr = m <= 0.5f * apex::kNegInf ? 0.f : expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kWideRows; ++j)
      psum += ok[j] ? expf(s[0][j] - mx) : 0.f;
    l = corr * l + psum;
    m = mx;
  }
  if (lane == 0)
    lse[static_cast<long>(bh) * n.sq + qpos] =
        l == 0.f ? apex::kNegInf : m + logf(l);
}

// the forward's second launch: o's chunk blockIdx.z = sum of the rounded
// p = exp(s - lse) (0 where not allowed) times v
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    varlen_wide_out_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ seg_q,
                           const int* __restrict__ seg_k,
                           const int4* __restrict__ qr,
                           const int4* __restrict__ kr,
                           const float* __restrict__ lse, T* __restrict__ o,
                           Dims n, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + kWideRows * kWideCols;
  constexpr int SUB = kB / kWideRows;
  const int nq = gridDim.x / SUB, nk = n.sk / kB;
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / n.h;
  const int c0 = blockIdx.z * kWideCols;
  const int r = threadIdx.x / kWideLanes, lane = threadIdx.x % kWideLanes;
  const int qpos = qt * kWideRows + r;
  const int seg = seg_q[static_cast<long>(b) * n.sq + qpos];
  const long qrow = (static_cast<long>(bh) * n.sq + qpos) * n.d;
  const int* kseg = seg_k + static_cast<long>(b) * n.sk;
  const float lse_r = lse[static_cast<long>(bh) * n.sq + qpos];
  float acc[kWideDims];
#pragma unroll
  for (int i = 0; i < kWideDims; ++i) acc[i] = 0.f;
  const int4 qi = qr[static_cast<long>(b) * nq + qt / SUB];
  for (int kt = qi.z * SUB; kt <= qi.w * SUB + SUB - 1; ++kt) {
    if (!tiles_meet<kWideRows>(qi, kr[static_cast<long>(b) * nk + kt / SUB],
                               qt, kt, causal))
      continue;
    const long kbase = (static_cast<long>(bh) * n.sk + kt * kWideRows) * n.d;
    float s[1][kWideRows];
    bool ok[kWideRows];
    wide_dots<T, 1>(s, {q + qrow}, true, {k + kbase}, kWideRows, n.d, {sK},
                    lane);
    varlen_wide_scores(s[0], ok, kseg, seg, kt, qpos, scale, causal);
    // sV's last readers passed wide_dots' syncs
    stage_cols<T, kWideCols, kWideRows>(sV, v + kbase + c0, kWideRows, n.d,
                                        wide_cols(n.d, c0), kWideThreads);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kWideRows; ++j)
      axpy_part<kWideDims, kWideLanes>(
          acc, round_to<T>(ok[j] ? expf(s[0][j] - lse_r) : 0.f),
          sV + j * kWideCols, lane);
  }
  store_row_part<T, kWideDims, kWideLanes>(o + qrow + c0, acc, lane,
                                           wide_cols(n.d, c0));
}

// dQ's chunk blockIdx.z; one block per (q tile, b*h, chunk)
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    varlen_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ seg_q,
                          const int* __restrict__ seg_k,
                          const int4* __restrict__ qr,
                          const int4* __restrict__ kr,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dq, Dims n, float scale,
                          int causal) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + kWideRows * kWideCols;
  constexpr int SUB = kB / kWideRows;
  const int nq = gridDim.x / SUB, nk = n.sk / kB;
  const int qt = blockIdx.x, bh = blockIdx.y, b = bh / n.h;
  const int c0 = blockIdx.z * kWideCols;
  const int r = threadIdx.x / kWideLanes, lane = threadIdx.x % kWideLanes;
  const int qpos = qt * kWideRows + r;
  const int seg = seg_q[static_cast<long>(b) * n.sq + qpos];
  const long lrow = static_cast<long>(bh) * n.sq + qpos;
  const int* kseg = seg_k + static_cast<long>(b) * n.sk;
  const float lse_r = lse[lrow], delta_r = delta[lrow];
  float acc[kWideDims];
#pragma unroll
  for (int i = 0; i < kWideDims; ++i) acc[i] = 0.f;
  const int4 qi = qr[static_cast<long>(b) * nq + qt / SUB];
  for (int kt = qi.z * SUB; kt <= qi.w * SUB + SUB - 1; ++kt) {
    if (!tiles_meet<kWideRows>(qi, kr[static_cast<long>(b) * nk + kt / SUB],
                               qt, kt, causal))
      continue;
    const long kbase = (static_cast<long>(bh) * n.sk + kt * kWideRows) * n.d;
    float sd[2][kWideRows];  // s, dp
    bool ok[kWideRows];
    wide_dots<T, 2>(sd, {q + lrow * n.d, dout + lrow * n.d}, true,
                    {k + kbase, v + kbase}, kWideRows, n.d, {sK, sV}, lane);
    varlen_wide_scores(sd[0], ok, kseg, seg, kt, qpos, scale, causal);
    wide_restage<T, 1>({sK}, {k + kbase}, kWideRows, n.d, c0);
#pragma unroll
    for (int j = 0; j < kWideRows; ++j) {
      const float p = ok[j] ? expf(sd[0][j] - lse_r) : 0.f;
      const float ds = p * (sd[1][j] - delta_r) * scale;
      axpy_part<kWideDims, kWideLanes>(acc, round_to<T>(ds),
                                       sK + j * kWideCols, lane);
    }
  }
  store_row_part<T, kWideDims, kWideLanes>(dq + lrow * n.d + c0, acc, lane,
                                           wide_cols(n.d, c0));
}

// dK's and dV's chunk blockIdx.z; one owner block per (kv tile, b*h,
// chunk) over the tile's live q tiles in order
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    varlen_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ seg_q,
                           const int* __restrict__ seg_k,
                           const int4* __restrict__ qr,
                           const int4* __restrict__ kr,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, Dims n,
                           float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sO = smem + kWideRows * kWideCols;  // dO
  constexpr int SUB = kB / kWideRows;
  const int nq = n.sq / kB, nk = gridDim.x / SUB;
  const int kt = blockIdx.x, bh = blockIdx.y, b = bh / n.h;
  const int c0 = blockIdx.z * kWideCols;
  const int r = threadIdx.x / kWideLanes, lane = threadIdx.x % kWideLanes;
  const int kpos = kt * kWideRows + r;
  const int seg = seg_k[static_cast<long>(b) * n.sk + kpos];
  const long krow = (static_cast<long>(bh) * n.sk + kpos) * n.d;
  const int* qseg = seg_q + static_cast<long>(b) * n.sq;
  float dka[kWideDims], dva[kWideDims];
#pragma unroll
  for (int i = 0; i < kWideDims; ++i) dka[i] = dva[i] = 0.f;
  const int4 ki = kr[static_cast<long>(b) * nk + kt / SUB];
  for (int qt = ki.z * SUB; qt <= ki.w * SUB + SUB - 1; ++qt) {
    if (!tiles_meet<kWideRows>(qr[static_cast<long>(b) * nq + qt / SUB], ki,
                               qt, kt, causal))
      continue;
    const long row0 = static_cast<long>(bh) * n.sq + qt * kWideRows;
    float sd[2][kWideRows];  // s^T, dp^T
    wide_dots<T, 2>(sd, {k + krow, v + krow}, true,
                    {q + row0 * n.d, dout + row0 * n.d}, kWideRows, n.d,
                    {sQ, sO}, lane);
    float p[kWideRows], dr[kWideRows];
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) {
      const int qpos = qt * kWideRows + i, qs = __ldg(qseg + qpos);
      const bool ok = qs >= 0 && qs == seg && (!causal || kpos <= qpos);
      p[i] = ok ? expf(sd[0][i] * scale - __ldg(lse + row0 + i)) : 0.f;
      dr[i] = __ldg(delta + row0 + i);
    }
    wide_restage<T, 2>({sQ, sO}, {q + row0 * n.d, dout + row0 * n.d},
                       kWideRows, n.d, c0);
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) {
      axpy_part<kWideDims, kWideLanes>(dva, round_to<T>(p[i]),
                                       sO + i * kWideCols, lane);
      const float ds = p[i] * (sd[1][i] - dr[i]) * scale;
      axpy_part<kWideDims, kWideLanes>(dka, round_to<T>(ds),
                                       sQ + i * kWideCols, lane);
    }
  }
  const int cols = wide_cols(n.d, c0);
  store_row_part<T, kWideDims, kWideLanes>(dk + krow + c0, dka, lane, cols);
  store_row_part<T, kWideDims, kWideLanes>(dv + krow + c0, dva, lane, cols);
}

template <typename T>
cudaError_t launch_wide_fwd(const void* q, const void* k, const void* v,
                            const void* seg_q, const void* seg_k,
                            const void* qr, const void* kr, void* o,
                            void* lse, int b, Dims n, float scale, int causal,
                            cudaStream_t s) {
  auto stats = varlen_wide_stats_kernel<T>;
  auto out = varlen_wide_out_kernel<T>;
  cudaError_t e = allow_smem(stats, kWideTileBytes);
  if (e == cudaSuccess) e = allow_smem(out, 2 * kWideTileBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(n.sq / kWideRows, b * n.h);
  stats<<<grid, kWideThreads, kWideTileBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
      static_cast<const int4*>(qr), static_cast<const int4*>(kr),
      static_cast<float*>(lse), n, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  out<<<dim3(grid.x, grid.y, wide_chunks(n.d)), kWideThreads,
        2 * kWideTileBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int4*>(qr),
      static_cast<const int4*>(kr), static_cast<const float*>(lse),
      static_cast<T*>(o), n, scale, causal);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_wide_dq(const void* q, const void* k, const void* v,
                           const void* seg_q, const void* seg_k,
                           const void* qr, const void* kr, const void* dout,
                           const void* lse, const void* delta, void* dq,
                           int b, Dims n, float scale, int causal,
                           cudaStream_t s) {
  auto kernel = varlen_wide_dq_kernel<T>;
  const cudaError_t e = allow_smem(kernel, 2 * kWideTileBytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n.sq / kWideRows, b * n.h, wide_chunks(n.d)), kWideThreads,
           2 * kWideTileBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int4*>(qr),
      static_cast<const int4*>(kr), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), n, scale, causal);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_wide_dkv(const void* q, const void* k, const void* v,
                            const void* seg_q, const void* seg_k,
                            const void* qr, const void* kr, const void* dout,
                            const void* lse, const void* delta, void* dk,
                            void* dv, int b, Dims n, float scale, int causal,
                            cudaStream_t s) {
  auto kernel = varlen_wide_dkv_kernel<T>;
  const cudaError_t e = allow_smem(kernel, 2 * kWideTileBytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n.sk / kWideRows, b * n.h, wide_chunks(n.d)), kWideThreads,
           2 * kWideTileBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int4*>(qr),
      static_cast<const int4*>(kr), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), n, scale, causal);
  return cudaSuccess;
}

// dynamic shared memory: two (BR, D) fp32 tiles and the tile's segment
// ids (plus, for dK/dV, its lse and delta)
template <int D, int BR>
constexpr int varlen_smem(bool rows) {
  return (2 * BR * D + (rows ? 3 : 1) * BR) * 4;
}

template <typename T, int D, int BR>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* seg_q, const void* seg_k, const void* qr,
                       const void* kr, void* o, void* lse, int b, Dims n,
                       float scale, int causal, cudaStream_t s) {
  auto kernel = varlen_fwd_kernel<T, D, BR>;
  constexpr int smem = varlen_smem<D, BR>(false);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n.sq / BR, b * n.h), row_threads(D), smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int4*>(qr),
      static_cast<const int4*>(kr), static_cast<T*>(o),
      static_cast<float*>(lse), n, scale, causal);
  return cudaSuccess;
}

template <typename T, int D, int BR>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* seg_q, const void* seg_k, const void* qr,
                      const void* kr, const void* dout, const void* lse,
                      const void* delta, void* dq, int b, Dims n, float scale,
                      int causal, cudaStream_t s) {
  auto kernel = varlen_dq_kernel<T, D, BR>;
  constexpr int smem = varlen_smem<D, BR>(false);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n.sq / BR, b * n.h), row_threads(D), smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int4*>(qr),
      static_cast<const int4*>(kr), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), n, scale, causal);
  return cudaSuccess;
}

template <typename T, int D, int BR>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* seg_q, const void* seg_k, const void* qr,
                       const void* kr, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, int b, Dims n,
                       float scale, int causal, cudaStream_t s) {
  auto kernel = varlen_dkv_kernel<T, D, BR>;
  constexpr int smem = varlen_smem<D, BR>(true);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n.sk / BR, b * n.h), BR * (D / dkv_dims(D)), smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<const int4*>(qr),
      static_cast<const int4*>(kr), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), n, scale, causal);
  return cudaSuccess;
}

}  // namespace

// On CUDA device `device`, on `stream`. q, o, dO, dq: (b, h, sq, d); k, v, dk,
// dv: (b, h, sk, d); contiguous, 16-byte aligned, all of one type (dtype: 0
// fp32, 1 bf16, 2 fp16); seg_q (b, sq), seg_k (b, sk) int32; lse, delta: (b,
// h, sq) fp32; qr (b, sq / 64, 4) and kr (b, sk / 64, 4) int32, the per-tile
// tables (segment min, max, live range lo, hi). sq and sk are multiples of 64;
// d is any multiple of 8 (from D = 512 on the kernels' 32-, 16- and 8-row
// tiles read a half, a quarter and an eighth of a 64-row table entry each;
// above 2048 the wide kernels, 8-row tiles). bf16 and fp16 are taken only
// above d 256 (cudaErrorInvalidValue below: flash_varlen_mma.cu's tensor-core
// kernels serve those).
extern "C" int flash_varlen_fwd(int device, const void* q, const void* k,
                                const void* v, const void* seg_q,
                                const void* seg_k, const void* qr,
                                const void* kr, void* o, void* lse, int b,
                                int h, int sq, int sk, int d, float scale,
                                int causal, int dtype, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dims n{h, sq, sk, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kWideCols)
    APEX_WIDE_DISPATCH_T(launch_wide_fwd, q, k, v, seg_q, seg_k, qr, kr, o,
                         lse, b, n, scale, causal, s);
  APEX_FLASH_DISPATCH_CORE(launch_fwd<T, D, BR>(
      q, k, v, seg_q, seg_k, qr, kr, o, lse, b, n, scale, causal, s));
}

extern "C" int flash_varlen_bwd_dq(int device, const void* q, const void* k,
                                   const void* v, const void* seg_q,
                                   const void* seg_k, const void* qr,
                                   const void* kr, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int b, int h, int sq, int sk,
                                   int d, float scale, int causal,
                                   int dtype, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dims n{h, sq, sk, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kWideCols)
    APEX_WIDE_DISPATCH_T(launch_wide_dq, q, k, v, seg_q, seg_k, qr, kr, dout,
                         lse, delta, dq, b, n, scale, causal, s);
  APEX_FLASH_DISPATCH_CORE(launch_dq<T, D, BR>(q, k, v, seg_q, seg_k, qr,
                                               kr, dout, lse, delta, dq, b,
                                               n, scale, causal, s));
}

extern "C" int flash_varlen_bwd_dkv(int device, const void* q, const void* k,
                                    const void* v, const void* seg_q,
                                    const void* seg_k, const void* qr,
                                    const void* kr, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int b, int h, int sq,
                                    int sk, int d, float scale, int causal,
                                    int dtype, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dims n{h, sq, sk, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kWideCols)
    APEX_WIDE_DISPATCH_T(launch_wide_dkv, q, k, v, seg_q, seg_k, qr, kr, dout,
                         lse, delta, dk, dv, b, n, scale, causal, s);
  APEX_FLASH_DISPATCH_CORE(launch_dkv<T, D, BR>(q, k, v, seg_q, seg_k, qr,
                                                kr, dout, lse, delta, dk, dv,
                                                b, n, scale, causal, s));
}
