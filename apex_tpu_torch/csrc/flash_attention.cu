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
// Which kernels run here: fp32 inputs at every head dim, and bf16 and fp16
// inputs from D = 512 on (head dims above 256); bf16 and fp16 inputs at d <=
// 256 run all four on the tensor cores (flash_mma.cu; the wrapper's
// `_flash_route` picks). fp32 products stay here, on the CUDA cores: the
// tensor cores would take fp32 as TF32, not the fp32 products JAX's reference
// forms.
//
// Bound on this card: at the flagship shape (bh 96, s 1024, d 64) the
// operations (4, 6 and 8 * bh * s^2 * d, halved by the causal mask) bound
// all three, not the bytes. The bias adds one fp32 read of heads * sq * sk
// to each (and d(bias) writes as much): at T5's encoder shape (bh 64, s
// 512, d 64) that is bytes the forward must move in about the time of its
// operations. These kernels run their products on the CUDA cores in fp32,
// so they sit far above the bf16 bound: simple kernels that are right.
//
// Design: the TPU's sequential (q, kv) grid becomes a loop inside one
// block. Forward and dQ: one block per (q tile of BR rows, batch*head),
// heaviest causal tiles launched first; dK/dV: one block per (kv tile of
// BR rows, batch*head), walking the q tiles from the causal diagonal on.
// Each output tile has exactly one owner, so nothing is summed across
// blocks: no atomics, and the results are deterministic. The tile code is
// shared with the varlen kernels (flash_tile.cuh): K/V (or Q/dO) tiles
// staged in shared memory as fp32, a row held by TPR = D / DPT
// neighbouring threads. Masking is by value, never by branch, so every
// lane reaches every shuffle. Any sequence length runs: the last tile of
// a length that is not a multiple of BR stages zeros past the end, gives
// the columns past sk the score NEG_INF (p = 0) and stores no row past
// sq. A head dim d (a multiple of 8) up to 2048 runs in the instantiation
// for D = 32, 64, 128, 256, 512, 1024 or 2048 with zeros past d, a wider
// one in the wide kernels below (flash_wide.cuh: the head dim in chunks of
// 2048 columns, the forward in two launches, lse first, then o from p =
// exp(s - lse)); `scale` is the caller's (1 / sqrt(d)). D = 128 stages 64 KB a block, above the 48 KB
// of static shared memory, so every kernel takes its tiles as dynamic
// shared memory. D = 256 stages two 64-row tiles in 128 KB (one block an
// SM) and runs 512 threads a block (1,024 for dK/dV), each holding the
// same DPT dims as at D = 128: the register file then holds the block's
// rows and little else, and the compiler spills, dK/dV most. D = 512
// stages two 32-row tiles in the same 128 KB, 512 threads of 32 dims (dK
// and dV too): slow, and right. D = 1024 and 2048 are the same kernels
// with 16- and 8-row tiles (BR x D = 16,384: the same 128 KB): 512
// threads of 32 dims at D = 1024; at D = 2048 256 threads of 64 dims, so
// a row stays within one warp's shuffles. The spills are in the nvcc log
// chip_smoke.py prints.
//
// The bias is read straight from device memory, one (q tile, k tile)
// block of it where the scores of that tile are formed: a q row's 16
// biases of a key chunk as float4 loads in the forward, a key column's
// bias per q row in dK/dV (neighbouring threads, neighbouring keys). The
// causal tiles that the kernels skip read no bias. The bias and d(bias)
// come in whole tiles, (heads, sq, sk) rounded up to multiples of 64 (the
// wrapper pads a shape that ends in a partial tile, the bias with
// NEG_INF): the reads of a tail tile stay in bounds with no clamp or
// branch, and the padding masks their scores by value, so the bias
// kernels carry no tail mask of their own. d(bias) has no sequential grid
// to carry the batch sum through (JAX runs the batch as its innermost,
// ordered grid axis): one block owns each (head, q tile, k tile) output
// tile and walks the batch in order, summing in registers (each thread
// owns BR / TPR columns of its row, at most one), then writes the tile
// once; no
// atomics, so the sum is the same bits on every run. Tiles above the
// causal diagonal write zeros.

#include "flash_dense.cuh"
#include "flash_wide.cuh"

namespace {

// ---------------------------------------------------------------------------
// forward: o and lse

// at most 128 registers a thread (512 threads an SM): four blocks at D =
// 64; left free, the bias variant takes 135 registers, fits three blocks
// and runs 30 % longer
template <typename T, int D, bool HasBias, int BR>
__global__ void __launch_bounds__(row_threads(D),
                                  D == 2048 ? 1 : 512 / row_threads(D))
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const float* __restrict__ bias, T* __restrict__ o,
                     float* __restrict__ lse, Dims n, float scale,
                     int causal, Dropout drop) {
  constexpr int DPT = row_dims(D), TPR = D / DPT, NT = BR * TPR;
  constexpr int CH = chunk_keys(BR);
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + BR * D;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const int qpos = qt * BR + r;
  const bool qvalid = qpos < n.sq;
  const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;

  float qr[DPT], acc[DPT];
  const long qrow = (static_cast<long>(bh) * n.sq + qpos) * n.d;
  load_row_part<T, DPT, TPR>(q + qrow, qr, h, qvalid ? n.d : 0);
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = apex::kNegInf, l = 0.f;
  const float* brow = bias_row<HasBias>(bias, bh % n.heads, qpos, n);

  const int nkt = causal ? qt + 1 : tiles<BR>(n.sk);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    const long kbase = (static_cast<long>(bh) * n.sk + kt * BR) * n.d;
    const int krows = min(BR, n.sk - kt * BR);
    stage_tile<T, D, BR>(sK, k + kbase, krows, n.d, NT);
    stage_tile<T, D, BR>(sV, v + kbase, krows, n.d, NT);
    __syncthreads();
    const bool diag = causal && kt == qt;
    for (int j0 = 0; j0 < BR; j0 += CH) {
      float s[CH];
      float bv[CH];
      if constexpr (HasBias) {
#pragma unroll
        for (int i = 0; i < CH; i += 4)
          load4(brow + kt * BR + j0 + i, bv + i);
      }
      float cmax = apex::kNegInf;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = j0 + jj;
        float sv = group_sum<TPR>(dot_part<DPT, TPR>(qr, sK + j * D, h)) *
                   scale;
        if constexpr (HasBias) sv = __fadd_rn(sv, bv[jj]);
        if ((diag && j > r) || (!HasBias && j >= krows)) sv = apex::kNegInf;
        s[jj] = sv;
        cmax = fmaxf(cmax, sv);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
      }
      l = corr * l + psum;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int j = j0 + jj;
        float p = s[jj];
        if (drop.on)
          p = drop.keep(qpos, kt * BR + j, base)
                  ? p * drop.inv_keep
                  : 0.f;
        axpy_part<DPT, TPR>(acc, round_to<T>(p), sV + j * D, h);
      }
      m = m_new;
    }
  }
  if (!qvalid) return;
  const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] /= safe_l;
  store_row_part<T, DPT, TPR>(o + qrow, acc, h, n.d);
  if (h == 0)
    lse[static_cast<long>(bh) * n.sq + qpos] =
        l == 0.f ? apex::kNegInf : m + logf(safe_l);
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, bh), looping over the K/V tiles

template <typename T, int D, bool HasBias, int BR>
__global__ void __launch_bounds__(row_threads(D))
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias, T* __restrict__ dq,
                        Dims n, float scale, int causal, Dropout drop) {
  constexpr int DPT = row_dims(D), TPR = D / DPT, NT = BR * TPR;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + BR * D;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const int qpos = qt * BR + r;
  const bool qvalid = qpos < n.sq;
  const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;

  float qr[DPT], dor[DPT], acc[DPT];
  const long qrow = (static_cast<long>(bh) * n.sq + qpos) * n.d;
  load_row_part<T, DPT, TPR>(q + qrow, qr, h, qvalid ? n.d : 0);
  load_row_part<T, DPT, TPR>(dout + qrow, dor, h, qvalid ? n.d : 0);
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  const float lse_r = qvalid ? lse[static_cast<long>(bh) * n.sq + qpos] : 0.f;
  const float delta_r =
      qvalid ? delta[static_cast<long>(bh) * n.sq + qpos] : 0.f;
  const float* brow = bias_row<HasBias>(bias, bh % n.heads, qpos, n);

  const int nkt = causal ? qt + 1 : tiles<BR>(n.sk);
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    const long kbase = (static_cast<long>(bh) * n.sk + kt * BR) * n.d;
    const int krows = min(BR, n.sk - kt * BR);
    stage_tile<T, D, BR>(sK, k + kbase, krows, n.d, NT);
    stage_tile<T, D, BR>(sV, v + kbase, krows, n.d, NT);
    __syncthreads();
    const bool diag = causal && kt == qt;
#pragma unroll 4
    for (int j = 0; j < BR; ++j) {
      float sv = group_sum<TPR>(dot_part<DPT, TPR>(qr, sK + j * D, h)) *
                 scale;
      if constexpr (HasBias)
        sv = __fadd_rn(sv, __ldg(brow + kt * BR + j));
      if ((diag && j > r) || (!HasBias && j >= krows)) sv = apex::kNegInf;
      const float p = expf(sv - lse_r);
      float dp = group_sum<TPR>(dot_part<DPT, TPR>(dor, sV + j * D, h));
      if (drop.on)
        dp = drop.keep(qpos, kt * BR + j, base)
                 ? dp * drop.inv_keep
                 : 0.f;
      const float ds = p * (dp - delta_r) * scale;
      axpy_part<DPT, TPR>(acc, round_to<T>(ds), sK + j * D, h);
    }
  }
  if (qvalid) store_row_part<T, DPT, TPR>(dq + qrow, acc, h, n.d);
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (kv tile, bh), looping over the q tiles from the
// causal diagonal on

template <typename T, int D, bool HasBias, int BR>
__global__ void __launch_bounds__(BR * (D / dkv_dims(D)))
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias, T* __restrict__ dk,
                         T* __restrict__ dv, Dims n, float scale, int causal,
                         Dropout drop) {
  constexpr int DPT = dkv_dims(D), TPR = D / DPT, NT = BR * TPR;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sO = smem + BR * D;  // dO
  float* sL = smem + 2 * BR * D;
  float* sD = sL + BR;
  const int kt = blockIdx.x;  // causal: low tiles have the most q tiles
  const int bh = blockIdx.y;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const int kpos = kt * BR + r;
  const bool kvalid = kpos < n.sk;
  const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  const long krow = (static_cast<long>(bh) * n.sk + kpos) * n.d;
  load_row_part<T, DPT, TPR>(k + krow, kr, h, kvalid ? n.d : 0);
  load_row_part<T, DPT, TPR>(v + krow, vr, h, kvalid ? n.d : 0);
#pragma unroll
  for (int i = 0; i < DPT; ++i) dka[i] = dva[i] = 0.f;
  // this key's bias column: row i of q tile qt at bcol[(qt * BR + i) * bsk]
  const float* bcol =
      HasBias ? bias + static_cast<long>(bh % n.heads) * n.bsq * n.bsk + kpos
              : nullptr;

  const int nqt = tiles<BR>(n.sq);
  for (int qt = causal ? kt : 0; qt < nqt; ++qt) {
    __syncthreads();
    const long qbase = (static_cast<long>(bh) * n.sq + qt * BR) * n.d;
    const int qrows = min(BR, n.sq - qt * BR);
    stage_tile<T, D, BR>(sQ, q + qbase, qrows, n.d, NT);
    stage_tile<T, D, BR>(sO, dout + qbase, qrows, n.d, NT);
    for (int i = threadIdx.x; i < BR; i += NT) {
      const long row = static_cast<long>(bh) * n.sq + qt * BR + i;
      sL[i] = i < qrows ? lse[row] : 0.f;
      sD[i] = i < qrows ? delta[row] : 0.f;
    }
    __syncthreads();
    const bool diag = causal && kt == qt;
#pragma unroll 4
    for (int i = 0; i < BR; ++i) {
      float sv = group_sum<TPR>(dot_part<DPT, TPR>(kr, sQ + i * D, h)) *
                 scale;
      if constexpr (HasBias)
        sv = __fadd_rn(sv,
                       __ldg(bcol + static_cast<long>(qt * BR + i) * n.bsk));
      // kpos > qpos, or a row past sq (with a bias, its NEG_INF does it)
      if ((diag && r > i) || (!HasBias && i >= qrows)) sv = apex::kNegInf;
      const float p = expf(sv - sL[i]);
      float dp = group_sum<TPR>(dot_part<DPT, TPR>(vr, sO + i * D, h));
      float pv = p;
      if (drop.on) {
        const bool keep = drop.keep(qt * BR + i, kpos, base);
        pv = keep ? p * drop.inv_keep : 0.f;
        dp = keep ? dp * drop.inv_keep : 0.f;
      }
      axpy_part<DPT, TPR>(dva, round_to<T>(pv), sO + i * D, h);
      const float ds = p * (dp - sD[i]) * scale;
      axpy_part<DPT, TPR>(dka, round_to<T>(ds), sQ + i * D, h);
    }
  }
  if (!kvalid) return;
  store_row_part<T, DPT, TPR>(dk + krow, dka, h, n.d);
  store_row_part<T, DPT, TPR>(dv + krow, dva, h, n.d);
}

// ---------------------------------------------------------------------------
// d(bias): one block per (k tile, q tile, head) output tile, walking the
// batch in order

// three blocks an SM at D = 64 (168 registers; left free, the compiler
// takes 255 and fits two)
template <typename T, int D, int BR>
__global__ void __launch_bounds__(row_threads(D), D == 64 ? 3 : 1)
    flash_bwd_dbias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ bias,
                           float* __restrict__ db, Dims n, int nb,
                           float scale, int causal, Dropout drop) {
  constexpr int DPT = row_dims(D), TPR = D / DPT, NT = BR * TPR;
  // columns of the tile one thread sums (h, h + TPR, ... below BR; from D
  // = 1024 on, where TPR > BR, the threads h < BR one each)
  constexpr int NJ = (BR + TPR - 1) / TPR;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + BR * D;
  const int kt = blockIdx.x, qt = blockIdx.y, head = blockIdx.z;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR;
  const int qpos = qt * BR + r;
  const bool qvalid = qpos < n.sq;
  const int krows = min(BR, n.sk - kt * BR);
  // this thread's columns: h, h + TPR, h + 2 * TPR, ... of the tile's row r
  float* dbrow =
      db + (static_cast<long>(head) * n.bsq + qpos) * n.bsk + kt * BR;
  float acc[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) acc[i] = 0.f;
  if (causal && kt > qt) {  // above the diagonal: no score is live
#pragma unroll
    for (int i = 0; i < NJ; ++i)
      if (h + TPR * i < BR) dbrow[h + TPR * i] = 0.f;
    return;
  }
  const float* brow = bias_row<true>(bias, head, qpos, n);
  const bool diag = causal && kt == qt;

  float qr[DPT], dor[DPT];
  for (int b = 0; b < nb; ++b) {
    const int bh = b * n.heads + head;
    const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;
    const long qrow = (static_cast<long>(bh) * n.sq + qpos) * n.d;
    load_row_part<T, DPT, TPR>(q + qrow, qr, h, qvalid ? n.d : 0);
    load_row_part<T, DPT, TPR>(dout + qrow, dor, h, qvalid ? n.d : 0);
    const long lrow = static_cast<long>(bh) * n.sq + qpos;
    const float lse_r = qvalid ? lse[lrow] : 0.f;
    const float delta_r = qvalid ? delta[lrow] : 0.f;
    __syncthreads();  // the previous batch item's readers are done
    const long kbase = (static_cast<long>(bh) * n.sk + kt * BR) * n.d;
    stage_tile<T, D, BR>(sK, k + kbase, krows, n.d, NT);
    stage_tile<T, D, BR>(sV, v + kbase, krows, n.d, NT);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BR; ++j) {
      float sv = group_sum<TPR>(dot_part<DPT, TPR>(qr, sK + j * D, h)) *
                 scale;
      sv = __fadd_rn(sv, __ldg(brow + kt * BR + j));
      if (diag && j > r) sv = apex::kNegInf;  // pad columns: bias NEG_INF
      const float p = expf(sv - lse_r);
      float dp = group_sum<TPR>(dot_part<DPT, TPR>(dor, sV + j * D, h));
      if (drop.on)
        dp = drop.keep(qpos, kt * BR + j, base)
                 ? dp * drop.inv_keep
                 : 0.f;
      // rounded before the sum, as JAX adds p * (dp - delta) to its scratch
      const float ds = __fmul_rn(p, dp - delta_r);
      if (j % TPR == h) acc[j / TPR] = __fadd_rn(acc[j / TPR], ds);
    }
  }
#pragma unroll
  for (int i = 0; i < NJ; ++i)
    if (h + TPR * i < BR) dbrow[h + TPR * i] = acc[i];
}

// ---------------------------------------------------------------------------
// head dims above 2048 (flash_wide.cuh): the same four functions with the
// head dim in chunks of kWideCols columns, 8-row tiles

// row r of q tile qt against key tile kt: the sums q . k scaled, the bias
// added after the scaling, NEG_INF above the causal diagonal and (without
// a bias, whose padding does it) at the keys past sk
template <bool HasBias>
__device__ __forceinline__ void wide_scores(float (&s)[kWideRows],
                                            const float* brow, int qt,
                                            int kt, int r, const Dims& n,
                                            float scale, int causal) {
  const bool diag = causal && kt == qt;
  const int krows = n.sk - kt * kWideRows;
#pragma unroll
  for (int j = 0; j < kWideRows; ++j) {
    float sv = s[j] * scale;
    if constexpr (HasBias)
      sv = __fadd_rn(sv, __ldg(brow + kt * kWideRows + j));
    if ((diag && j > r) || (!HasBias && j >= krows)) sv = apex::kNegInf;
    s[j] = sv;
  }
}

// the forward's first launch: each row's lse, by the online softmax over
// its key tiles; one block per (q tile, bh)
template <typename T, bool HasBias>
__global__ void __launch_bounds__(kWideThreads)
    flash_wide_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const float* __restrict__ bias,
                            float* __restrict__ lse, Dims n, float scale,
                            int causal) {
  extern __shared__ __align__(16) float smem[];
  const int qt = gridDim.x - 1 - blockIdx.x;  // heavy causal tiles first
  const int bh = blockIdx.y;
  const int r = threadIdx.x / kWideLanes, lane = threadIdx.x % kWideLanes;
  const int qpos = qt * kWideRows + r;
  const bool qvalid = qpos < n.sq;
  const T* qrow = q + (static_cast<long>(bh) * n.sq + min(qpos, n.sq - 1)) *
                          n.d;
  const float* brow = bias_row<HasBias>(bias, bh % n.heads, qpos, n);
  float m = apex::kNegInf, l = 0.f;
  const int nkt = causal ? qt + 1 : tiles<kWideRows>(n.sk);
  for (int kt = 0; kt < nkt; ++kt) {
    const T* ktile = k + (static_cast<long>(bh) * n.sk + kt * kWideRows) *
                             n.d;
    float s[1][kWideRows];
    wide_dots<T, 1>(s, {qrow}, qvalid, {ktile},
                    min(kWideRows, n.sk - kt * kWideRows), n.d, {smem},
                    lane);
    wide_scores<HasBias>(s[0], brow, qt, kt, r, n, scale, causal);
    float mx = m;
#pragma unroll
    for (int j = 0; j < kWideRows; ++j) mx = fmaxf(mx, s[0][j]);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kWideRows; ++j) psum += expf(s[0][j] - mx);
    l = l * expf(m - mx) + psum;
    m = mx;
  }
  if (qvalid && lane == 0)
    lse[static_cast<long>(bh) * n.sq + qpos] =
        l == 0.f ? apex::kNegInf : m + logf(l);
}

// the forward's second launch: o's chunk blockIdx.z = sum of the rounded,
// dropped p = exp(s - lse) times v; one block per (q tile, bh, chunk)
template <typename T, bool HasBias>
__global__ void __launch_bounds__(kWideThreads)
    flash_wide_out_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ bias,
                          const float* __restrict__ lse, T* __restrict__ o,
                          Dims n, float scale, int causal, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + kWideRows * kWideCols;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, c0 = blockIdx.z * kWideCols;
  const int r = threadIdx.x / kWideLanes, lane = threadIdx.x % kWideLanes;
  const int qpos = qt * kWideRows + r;
  const bool qvalid = qpos < n.sq;
  const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;
  const T* qrow = q + (static_cast<long>(bh) * n.sq + min(qpos, n.sq - 1)) *
                          n.d;
  const float* brow = bias_row<HasBias>(bias, bh % n.heads, qpos, n);
  const float lse_r = qvalid ? lse[static_cast<long>(bh) * n.sq + qpos] : 0.f;
  float acc[kWideDims];
#pragma unroll
  for (int i = 0; i < kWideDims; ++i) acc[i] = 0.f;
  const int nkt = causal ? qt + 1 : tiles<kWideRows>(n.sk);
  for (int kt = 0; kt < nkt; ++kt) {
    const long kbase = (static_cast<long>(bh) * n.sk + kt * kWideRows) * n.d;
    const int krows = min(kWideRows, n.sk - kt * kWideRows);
    float s[1][kWideRows];
    wide_dots<T, 1>(s, {qrow}, qvalid, {k + kbase}, krows, n.d, {sK}, lane);
    wide_scores<HasBias>(s[0], brow, qt, kt, r, n, scale, causal);
    // sV's last readers passed wide_dots' syncs
    stage_cols<T, kWideCols, kWideRows>(sV, v + kbase + c0, krows, n.d,
                                        wide_cols(n.d, c0), kWideThreads);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kWideRows; ++j) {
      float p = expf(s[0][j] - lse_r);
      if (drop.on)
        p = drop.keep(qpos, kt * kWideRows + j, base)
                ? p * drop.inv_keep
                : 0.f;
      axpy_part<kWideDims, kWideLanes>(acc, round_to<T>(p),
                                       sV + j * kWideCols, lane);
    }
  }
  if (qvalid)
    store_row_part<T, kWideDims, kWideLanes>(
        o + (static_cast<long>(bh) * n.sq + qpos) * n.d + c0, acc, lane,
        wide_cols(n.d, c0));
}

// dQ's chunk blockIdx.z; one block per (q tile, bh, chunk)
template <typename T, bool HasBias>
__global__ void __launch_bounds__(kWideThreads)
    flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias, T* __restrict__ dq,
                         Dims n, float scale, int causal, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + kWideRows * kWideCols;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, c0 = blockIdx.z * kWideCols;
  const int r = threadIdx.x / kWideLanes, lane = threadIdx.x % kWideLanes;
  const int qpos = qt * kWideRows + r;
  const bool qvalid = qpos < n.sq;
  const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;
  const long qrow = (static_cast<long>(bh) * n.sq + min(qpos, n.sq - 1)) *
                    n.d;
  const float* brow = bias_row<HasBias>(bias, bh % n.heads, qpos, n);
  const long lrow = static_cast<long>(bh) * n.sq + qpos;
  const float lse_r = qvalid ? lse[lrow] : 0.f;
  const float delta_r = qvalid ? delta[lrow] : 0.f;
  float acc[kWideDims];
#pragma unroll
  for (int i = 0; i < kWideDims; ++i) acc[i] = 0.f;
  const int nkt = causal ? qt + 1 : tiles<kWideRows>(n.sk);
  for (int kt = 0; kt < nkt; ++kt) {
    const long kbase = (static_cast<long>(bh) * n.sk + kt * kWideRows) * n.d;
    const int krows = min(kWideRows, n.sk - kt * kWideRows);
    float sd[2][kWideRows];  // s, dp
    wide_dots<T, 2>(sd, {q + qrow, dout + qrow}, qvalid,
                    {k + kbase, v + kbase}, krows, n.d, {sK, sV}, lane);
    wide_scores<HasBias>(sd[0], brow, qt, kt, r, n, scale, causal);
    wide_restage<T, 1>({sK}, {k + kbase}, krows, n.d, c0);
#pragma unroll
    for (int j = 0; j < kWideRows; ++j) {
      const float p = expf(sd[0][j] - lse_r);
      float dp = sd[1][j];
      if (drop.on)
        dp = drop.keep(qpos, kt * kWideRows + j, base)
                 ? dp * drop.inv_keep
                 : 0.f;
      const float ds = p * (dp - delta_r) * scale;
      axpy_part<kWideDims, kWideLanes>(acc, round_to<T>(ds),
                                       sK + j * kWideCols, lane);
    }
  }
  if (qvalid)
    store_row_part<T, kWideDims, kWideLanes>(dq + lrow * n.d + c0, acc, lane,
                                             wide_cols(n.d, c0));
}

// dK's and dV's chunk blockIdx.z; one block per (kv tile, bh, chunk),
// walking the q tiles from the causal diagonal on
template <typename T, bool HasBias>
__global__ void __launch_bounds__(kWideThreads)
    flash_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ bias, T* __restrict__ dk,
                          T* __restrict__ dv, Dims n, float scale, int causal,
                          Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sO = smem + kWideRows * kWideCols;  // dO
  const int kt = blockIdx.x, bh = blockIdx.y, c0 = blockIdx.z * kWideCols;
  const int r = threadIdx.x / kWideLanes, lane = threadIdx.x % kWideLanes;
  const int kpos = kt * kWideRows + r;
  const bool kvalid = kpos < n.sk;
  const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;
  const long krow = (static_cast<long>(bh) * n.sk + min(kpos, n.sk - 1)) *
                    n.d;
  // this key's bias column: row i of q tile qt at bcol[(qt * 8 + i) * bsk]
  const float* bcol =
      HasBias ? bias + static_cast<long>(bh % n.heads) * n.bsq * n.bsk + kpos
              : nullptr;
  float dka[kWideDims], dva[kWideDims];
#pragma unroll
  for (int i = 0; i < kWideDims; ++i) dka[i] = dva[i] = 0.f;
  const int nqt = tiles<kWideRows>(n.sq);
  for (int qt = causal ? kt : 0; qt < nqt; ++qt) {
    const long row0 = static_cast<long>(bh) * n.sq + qt * kWideRows;
    const int qrows = min(kWideRows, n.sq - qt * kWideRows);
    float sd[2][kWideRows];  // s^T, dp^T
    wide_dots<T, 2>(sd, {k + krow, v + krow}, kvalid,
                    {q + row0 * n.d, dout + row0 * n.d}, qrows, n.d,
                    {sQ, sO}, lane);
    const bool diag = causal && kt == qt;
    float lr[kWideRows], dr[kWideRows];
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) {
      lr[i] = i < qrows ? __ldg(lse + row0 + i) : 0.f;
      dr[i] = i < qrows ? __ldg(delta + row0 + i) : 0.f;
      float sv = sd[0][i] * scale;
      if constexpr (HasBias)
        sv = __fadd_rn(sv, __ldg(bcol + static_cast<long>(qt * kWideRows + i)
                                            * n.bsk));
      // kpos > qpos, or a row past sq (with a bias, its NEG_INF does it)
      if ((diag && r > i) || (!HasBias && i >= qrows)) sv = apex::kNegInf;
      sd[0][i] = sv;
    }
    wide_restage<T, 2>({sQ, sO}, {q + row0 * n.d, dout + row0 * n.d}, qrows,
                       n.d, c0);
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) {
      const float p = expf(sd[0][i] - lr[i]);
      float dp = sd[1][i], pv = p;
      if (drop.on) {
        const bool keep =
            drop.keep(qt * kWideRows + i, kpos, base);
        pv = keep ? p * drop.inv_keep : 0.f;
        dp = keep ? dp * drop.inv_keep : 0.f;
      }
      axpy_part<kWideDims, kWideLanes>(dva, round_to<T>(pv),
                                       sO + i * kWideCols, lane);
      const float ds = p * (dp - dr[i]) * scale;
      axpy_part<kWideDims, kWideLanes>(dka, round_to<T>(ds),
                                       sQ + i * kWideCols, lane);
    }
  }
  if (!kvalid) return;
  const int cols = wide_cols(n.d, c0);
  store_row_part<T, kWideDims, kWideLanes>(dk + krow + c0, dka, lane, cols);
  store_row_part<T, kWideDims, kWideLanes>(dv + krow + c0, dva, lane, cols);
}

// d(bias): one block per (k tile, q tile, head) output tile of 8 x 8,
// walking the batch in order; lane j < 8 of a row sums column j
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    flash_wide_dbias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const float* __restrict__ bias,
                            float* __restrict__ db, Dims n, int nb,
                            float scale, int causal, Dropout drop) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + kWideRows * kWideCols;
  const int kt = blockIdx.x, qt = blockIdx.y, head = blockIdx.z;
  const int r = threadIdx.x / kWideLanes, lane = threadIdx.x % kWideLanes;
  const int qpos = qt * kWideRows + r;
  const bool qvalid = qpos < n.sq;
  const int krows = min(kWideRows, n.sk - kt * kWideRows);
  float* dbrow = db + (static_cast<long>(head) * n.bsq + qpos) * n.bsk +
                 kt * kWideRows;
  if (causal && kt > qt) {  // above the diagonal: no score is live
    if (lane < kWideRows) dbrow[lane] = 0.f;
    return;
  }
  const float* brow = bias_row<true>(bias, head, qpos, n);
  float acc = 0.f;
  for (int b = 0; b < nb; ++b) {
    const int bh = b * n.heads + head;
    const uint32_t base = drop.seed * 0xC2B2AE3Du + bh * 0x27D4EB2Fu;
    const long qrow = (static_cast<long>(bh) * n.sq + min(qpos, n.sq - 1)) *
                      n.d;
    const long lrow = static_cast<long>(bh) * n.sq + qpos;
    const float lse_r = qvalid ? lse[lrow] : 0.f;
    const float delta_r = qvalid ? delta[lrow] : 0.f;
    const long kbase = (static_cast<long>(bh) * n.sk + kt * kWideRows) * n.d;
    float sd[2][kWideRows];
    wide_dots<T, 2>(sd, {q + qrow, dout + qrow}, qvalid,
                    {k + kbase, v + kbase}, krows, n.d, {sK, sV}, lane);
    wide_scores<true>(sd[0], brow, qt, kt, r, n, scale, causal);
#pragma unroll
    for (int j = 0; j < kWideRows; ++j) {
      const float p = expf(sd[0][j] - lse_r);
      float dp = sd[1][j];
      if (drop.on)
        dp = drop.keep(qpos, kt * kWideRows + j, base)
                 ? dp * drop.inv_keep
                 : 0.f;
      // rounded before the sum, as JAX adds p * (dp - delta) to its scratch
      const float ds = __fmul_rn(p, dp - delta_r);
      if (j == lane) acc = __fadd_rn(acc, ds);
    }
  }
  if (lane < kWideRows) dbrow[lane] = acc;
}

template <typename T, bool HasBias>
cudaError_t launch_wide_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* o, void* lse, Dims n,
                            int bh, float scale, int causal, Dropout drop,
                            cudaStream_t s) {
  auto stats = flash_wide_stats_kernel<T, HasBias>;
  auto out = flash_wide_out_kernel<T, HasBias>;
  cudaError_t e = allow_smem(stats, kWideTileBytes);
  if (e == cudaSuccess) e = allow_smem(out, 2 * kWideTileBytes);
  if (e != cudaSuccess) return e;
  const int nqt = tiles<kWideRows>(n.sq);
  stats<<<dim3(nqt, bh), kWideThreads, kWideTileBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const float*>(bias), static_cast<float*>(lse), n, scale,
      causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  out<<<dim3(nqt, bh, wide_chunks(n.d)), kWideThreads, 2 * kWideTileBytes,
        s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
             static_cast<const T*>(v), static_cast<const float*>(bias),
             static_cast<const float*>(lse), static_cast<T*>(o), n, scale,
             causal, drop);
  return cudaSuccess;
}

template <typename T, bool HasBias>
cudaError_t launch_wide_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* bias, void* dq,
                           Dims n, int bh, float scale, int causal,
                           Dropout drop, cudaStream_t s) {
  auto kernel = flash_wide_dq_kernel<T, HasBias>;
  const cudaError_t e = allow_smem(kernel, 2 * kWideTileBytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles<kWideRows>(n.sq), bh, wide_chunks(n.d)), kWideThreads,
           2 * kWideTileBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<T*>(dq), n, scale, causal,
      drop);
  return cudaSuccess;
}

template <typename T, bool HasBias>
cudaError_t launch_wide_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* bias, void* dk,
                            void* dv, Dims n, int bh, float scale, int causal,
                            Dropout drop, cudaStream_t s) {
  auto kernel = flash_wide_dkv_kernel<T, HasBias>;
  const cudaError_t e = allow_smem(kernel, 2 * kWideTileBytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles<kWideRows>(n.sk), bh, wide_chunks(n.d)), kWideThreads,
           2 * kWideTileBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<T*>(dk),
      static_cast<T*>(dv), n, scale, causal, drop);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_wide_dbias(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* bias, void* db,
                              Dims n, int bh, float scale, int causal,
                              Dropout drop, cudaStream_t s) {
  auto kernel = flash_wide_dbias_kernel<T>;
  const cudaError_t e = allow_smem(kernel, 2 * kWideTileBytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles<kWideRows>(n.sk), tiles<kWideRows>(n.sq), n.heads),
           kWideThreads, 2 * kWideTileBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<float*>(db), n,
      bh / n.heads, scale, causal, drop);
  return cudaSuccess;
}

// FN<T, HasBias>(args...) for a head dim above 2048, T the input type, the
// bias kernels for a non-null `bias`
#define APEX_WIDE_DISPATCH(FN, ...)                                       \
  do {                                                                    \
    APEX_TYPE_SWITCH(dtype, T,                                            \
                     return static_cast<int>(cudaErrorInvalidValue),      \
                     return status_of(bias != nullptr                     \
                                          ? FN<T, true>(__VA_ARGS__)      \
                                          : FN<T, false>(__VA_ARGS__)));  \
  } while (0)

// dynamic shared memory of a kernel that stages two (BR, D) fp32 tiles
// (plus, for dK/dV, the tile's lse and delta)
template <int D, int BR>
constexpr int tile_smem(bool rows) {
  return (2 * BR * D + (rows ? 2 * BR : 0)) * static_cast<int>(sizeof(float));
}

template <typename T, int D, bool HasBias, int BR>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, void* o, void* lse, Dims n, int bh,
                       float scale, int causal, Dropout drop,
                       cudaStream_t s) {
  auto kernel = flash_fwd_kernel<T, D, HasBias, BR>;
  constexpr int smem = tile_smem<D, BR>(false);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles<BR>(n.sq), bh), row_threads(D), smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(o), static_cast<float*>(lse), n, scale, causal, drop);
  return cudaSuccess;
}

template <typename T, int D, bool HasBias, int BR>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* bias, void* dq, Dims n, int bh, float scale,
                      int causal, Dropout drop, cudaStream_t s) {
  auto kernel = flash_bwd_dq_kernel<T, D, HasBias, BR>;
  constexpr int smem = tile_smem<D, BR>(false);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles<BR>(n.sq), bh), row_threads(D), smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<T*>(dq), n, scale, causal,
      drop);
  return cudaSuccess;
}

template <typename T, int D, bool HasBias, int BR>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* bias, void* dk, void* dv, Dims n, int bh,
                       float scale, int causal, Dropout drop,
                       cudaStream_t s) {
  auto kernel = flash_bwd_dkv_kernel<T, D, HasBias, BR>;
  constexpr int smem = tile_smem<D, BR>(true);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles<BR>(n.sk), bh), BR * (D / dkv_dims(D)), smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<T*>(dk),
      static_cast<T*>(dv), n, scale, causal, drop);
  return cudaSuccess;
}

template <typename T, int D, int BR>
cudaError_t launch_dbias(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         const void* bias, void* db, Dims n, int bh,
                         float scale, int causal, Dropout drop,
                         cudaStream_t s) {
  auto kernel = flash_bwd_dbias_kernel<T, D, BR>;
  constexpr int smem = tile_smem<D, BR>(false);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles<BR>(n.sk), tiles<BR>(n.sq), n.heads),
           row_threads(D), smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse),
                static_cast<const float*>(delta),
                static_cast<const float*>(bias), static_cast<float*>(db), n,
                bh / n.heads, scale, causal, drop);
  return cudaSuccess;
}

// FN<T, D, HasBias, BR>(args...): the bias-free kernels for a null
// `bias`, the bias kernels otherwise; over the types and D the CUDA-core
// route takes (fp32, and bf16 and fp16 from D = 512 on)
#define APEX_FLASH_DISPATCH_CORE_FN(FN, ...)                         \
  do {                                                               \
    if (bias != nullptr)                                             \
      APEX_FLASH_DISPATCH_CORE(FN<T, D, true, BR>(__VA_ARGS__));     \
    else                                                             \
      APEX_FLASH_DISPATCH_CORE(FN<T, D, false, BR>(__VA_ARGS__));    \
  } while (0)

}  // namespace

// On CUDA device `device`, on `stream`. q, o, dO, dq: (bh, sq, d); k, v, dk,
// dv: (bh, sk, d); contiguous, 16-byte aligned, all of one type (dtype: 0
// fp32, 1 bf16, 2 fp16); lse, delta: (bh, sq) fp32. d is any multiple of 8
// (run by the instantiation for 32, 64, 128, 256, 512, 1024 or 2048, zeros
// past d, and above 2048 by the wide kernels); each takes bf16 and fp16 only
// at d > 256 (below, the entry points of flash_mma.cu run them) and returns
// cudaErrorInvalidValue otherwise. sq and sk are any lengths, equal when
// causal: the last tile of a length that is not a multiple of the tile masks
// the rows and columns past it. `bias` is null or a contiguous, 16-byte
// aligned fp32 (heads, bsq, bsk) tensor shared by the batch (bh = batch *
// heads, b-major; heads is ignored without a bias), bsq and bsk being sq and
// sk rounded up to multiples of 64, its entries past sq, sk NEG_INF (they mask
// the scores of the rows and columns past the end); d(bias) writes db, fp32
// (heads, bsq, bsk), whose entries past sq, sk are scratch. Dropout is on when
// `dropout` != 0: keep where hash >= thresh, kept values scaled by inv_keep;
// the hash reads row q_off + i and column k_off + j (the launch's place in
// the global sequence; 0, 0 for a whole sequence).
extern "C" int flash_attention_fwd(int device, const void* q, const void* k,
                                   const void* v, const void* bias, void* o,
                                   void* lse, int heads, int bh, int sq,
                                   int sk, int d, float scale, int causal,
                                   int dropout, unsigned seed,
                                   unsigned thresh, float inv_keep,
                                   unsigned q_off, unsigned k_off, int dtype, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dropout drop{dropout, seed, thresh, inv_keep, q_off, k_off};
  const Dims n{heads, sq, sk, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kWideCols)
    APEX_WIDE_DISPATCH(launch_wide_fwd, q, k, v, bias, o, lse, n, bh, scale,
                       causal, drop, s);
  APEX_FLASH_DISPATCH_CORE_FN(launch_fwd, q, k, v, bias, o, lse, n, bh,
                              scale, causal, drop, s);
}

extern "C" int flash_attention_bwd_dq(int device, const void* q,
                                      const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, const void* bias,
                                      void* dq, int heads, int bh, int sq,
                                      int sk, int d, float scale, int causal,
                                      int dropout, unsigned seed,
                                      unsigned thresh, float inv_keep,
                                      unsigned q_off, unsigned k_off, int dtype, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dropout drop{dropout, seed, thresh, inv_keep, q_off, k_off};
  const Dims n{heads, sq, sk, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kWideCols)
    APEX_WIDE_DISPATCH(launch_wide_dq, q, k, v, dout, lse, delta, bias, dq,
                       n, bh, scale, causal, drop, s);
  APEX_FLASH_DISPATCH_CORE_FN(launch_dq, q, k, v, dout, lse, delta, bias,
                              dq, n, bh, scale, causal, drop, s);
}

extern "C" int flash_attention_bwd_dkv(int device, const void* q,
                                       const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, const void* bias,
                                       void* dk, void* dv, int heads, int bh,
                                       int sq, int sk, int d, float scale,
                                       int causal, int dropout, unsigned seed,
                                       unsigned thresh, float inv_keep,
                                       unsigned q_off, unsigned k_off, int dtype, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Dropout drop{dropout, seed, thresh, inv_keep, q_off, k_off};
  const Dims n{heads, sq, sk, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kWideCols)
    APEX_WIDE_DISPATCH(launch_wide_dkv, q, k, v, dout, lse, delta, bias, dk,
                       dv, n, bh, scale, causal, drop, s);
  APEX_FLASH_DISPATCH_CORE_FN(launch_dkv, q, k, v, dout, lse, delta, bias,
                              dk, dv, n, bh, scale, causal, drop, s);
}

extern "C" int flash_attention_bwd_dbias(int device, const void* q,
                                         const void* k, const void* v,
                                         const void* dout, const void* lse,
                                         const void* delta, const void* bias,
                                         void* db, int heads, int bh, int sq,
                                         int sk, int d, float scale,
                                         int causal, int dropout,
                                         unsigned seed, unsigned thresh,
                                         float inv_keep, unsigned q_off, unsigned k_off, int dtype,
                                         void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (bias == nullptr || heads <= 0 || bh % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dropout drop{dropout, seed, thresh, inv_keep, q_off, k_off};
  const Dims n{heads, sq, sk, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kWideCols)
    APEX_WIDE_DISPATCH_T(launch_wide_dbias, q, k, v, dout, lse, delta, bias,
                         db, n, bh, scale, causal, drop, s);
  APEX_FLASH_DISPATCH_CORE(launch_dbias<T, D, BR>(
      q, k, v, dout, lse, delta, bias, db, n, bh, scale, causal, drop, s));
}
