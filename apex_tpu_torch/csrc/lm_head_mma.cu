// Fused LM head + softmax cross-entropy, forward, dX and dW, bf16 or fp16
// (E below) on Hopper's tensor cores (sm_90a).
//
// Replaces, for bf16 and fp16 inputs, the TPU kernels of
// apex_tpu/ops/lm_head_loss.py:
//   * `_fwd_kernel` (reached through `_run_fwd`, pallas_call at :198): per
//     row the log-sum-exp lse of s = x . w^T over the vocab and the
//     target's score pred;
//   * `_dx_kernel` (`_run_bwd`, pallas_call at :244): dx = sum_v dl . W_v;
//   * `_dw_kernel` (`_run_bwd`, pallas_call at :263): dw = sum_n dl^T . X_n;
// with dl = (exp(s - lse) - onehot(t)) * g and s = x . w^T recomputed tile
// by tile from the saved (x, w, t, lse): the (rows, vocab) scores never
// reach device memory. fp32 inputs keep the CUDA-core kernels of
// lm_head_loss.cu: on the tensor cores fp32 products run as TF32, and the
// fp32 gates need fp32 products.
//
// Math, the JAX kernels' (:130-183): s is accumulated in fp32; a vocab
// column past V gives dl = 0 (its W row loads as zeros); a target outside
// [0, V) hits no column; dl is rounded to E before the second product,
// whose sums are fp32; dx and dw are written in E.
//
// Bound on this card: tensor-core operations, 4.n.V.h (the scores and the
// second product): 1.28 ms at the training shape (8192 x 768, V 50304) at
// 989 TFLOP/s; the bytes (x, w, dx or dw) take 0.03 ms.
//
// Design. dX and dW are one kernel with the roles of x and w swapped: a
// block owns 64 rows of one matrix (dX: x's rows; dW: w's vocab rows; the
// "own" tile) and streams the other (dX: w; dW: x) in tiles of 64 rows.
// Per tile: S = own . tile^T (64 x 64, fp32) in registers, dl from S in
// registers, rounded to E into a small shared tile, then acc += dl .
// tile with the (64 x hk) fp32 accumulator in registers. The register file
// bounds the accumulator: up to hk = 512 columns (128 fp32 a thread) a CTA
// covers the hidden axis alone (T5-small's 512). Wider, a thread block
// cluster of C CTAs (2 <= C <= 8) splits it into panels of hk <= 384 (96
// fp32 a thread, beside the buffers of the exchange below): CTA r holds
// the own rows and the streamed tiles over its hk columns only, forms its
// part of S over them, and the C parts are summed through distributed
// shared memory, in rank order in every CTA, so all hold the same S bits.
// A pair (C = 2: GPT-2's 768) sends its part with one bulk copy into the
// peer's shared memory, which completes the peer's mbarrier; larger
// clusters read each other's parts after a cluster barrier, whose release
// (a cluster-scope fence a tile) cost pairs more than the bulk copy does
// (PERF.md). The streamed matrix is then read once per 64 own rows (at
// GPT-2's shape 9.9 GB through L2, where 32-row blocks over the whole
// hidden axis read 19.8), and S is formed once. Above 8 x
// 384 hidden columns each CTA covers P > 1 panels of 384: S is formed
// panel by panel and grid.y runs one block per output panel (S recomputed
// P times).
//
// Products: mma.sync.m16n8k16 with fp32 accumulation, operands by ldmatrix
// from shared rows padded by 16 bytes (flash_mma.cuh). Eight warps; for S
// each owns 32 x 16 (2 A and 1 B fragment loads feed 4 products a k
// step), for the accumulator 32 rows x hk/4 columns (2 A and hk/32 B
// loads feed hk/16 products a k step). The streamed tile is
// double-buffered: the next one copies (cp.async) while this one is used.
// Every output element has one owner that sums in a fixed order, no
// atomics: dx and dw repeat bitwise. dX at few rows (T5's 1,024) splits
// the vocab so the grid fills the card: each split writes fp32 partials
// and a second launch adds them in split order. The cluster size, panels
// and split count come from the wrapper (ops/lm_head_loss.py
// `_mma_layout`, `_dx_splits`), functions of (n, V, h) alone.
//
// The forward is a plain GEMM with a light epilogue: no second product and
// no (rows x h) accumulator, so no cluster and no hidden panels. Bound:
// operations, 2.n.V.h (0.64 ms at GPT-2's 8192 x 768, V 50304, at 989
// TFLOP/s). A block owns 128 x rows and a split of the vocab, which it
// walks in tiles of 128 vocab rows; each tile's S = x . w^T (128 x 128,
// fp32) is formed over the hidden axis in k chunks of 64, both operands
// copied by cp.async into a three-stage ring that runs on across tile
// boundaries (the (tile, chunk) walk is one sequence), so the next tile's
// first chunks load while this tile's epilogue runs. Eight warps, 4 (rows)
// x 2 (vocab), each own a 32 x 64 block of S: per k step of 16 their 2 A
// and 4 B ldmatrix loads feed 16 mma.sync; 128 registers a thread and 111
// KB of shared memory let two blocks share an SM, which hides more latency
// than one block of 128 x 256 tiles with 64 x 64 warp blocks did (2.19 vs
// 2.37 ms at GPT-2's shape on an H100 80GB HBM3 at 700 W, PERF.md), though
// it reads 64, not 85, flop a byte through L2. Warp layout and the
// softmax: a thread holds 4 rows (16 mi + g, + 8) x 16 vocab columns of
// each tile, and keeps its OWN running max m, sum l and target score p of
// each of its rows over the columns it holds, updated from S in registers
// after each tile as JAX does per tile (max; rescale by exp(m_prev -
// m_new); sum of exp(s - m_new); the score where col == t), so no tile
// needs a reduction across lanes or warps. The per-thread partials are
// merged once, at the end:
// over a quad's lanes by xor shuffles (the two lanes of a pair compute the
// same commutative sum, so both hold the same bits), then over the warps
// of a row in warp order through shared memory; each block writes its
// rows' (m, l, p) for its split, and a second launch merges the splits in
// split order (lse = M + log sum_s l_s exp(m_s - M), pred = sum_s p_s):
// the forward repeats bitwise. Columns past V are masked by value (s =
// NEG_INF, exp term 0) and load as zeros from clamped addresses; a target
// outside [0, V) hits no column (pred 0). Grid: the row tile is
// blockIdx.x, so the blocks running at once are the row tiles of a few
// splits, which walk the same vocab tiles at about the same time: each
// tile of W (77 MB at GPT-2's shape, more than the 50 MB L2) comes from
// device memory about once and is reread from L2. The split count is the
// wrapper's (`_fwd_splits`, a function of (n, V, h) alone).

#include <cooperative_groups.h>

#include "common.cuh"
#include "flash_mma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kOwnRows = 64;       // own rows of a block
constexpr int kStreamRows = 64;    // rows of a streamed tile
constexpr int kLmThreads = 256;    // 8 warps
// fp32 row strides of a part of S: exchanged through the cluster barrier
// (two buffers), or by bulk copies between the CTAs of a pair (four: two
// received, two sent; four rows of 72 would not fit beside 384-column
// tiles)
constexpr int kPartLd = kStreamRows + 8;
constexpr int kPairLd = kStreamRows + 4;
constexpr int kMaxCluster = 8;
constexpr int kMaxSplits = 16;

template <typename E>
struct BwdArgs {
  const E* own;       // (own_n, h): x for dX, w for dW
  const E* stream;    // (stream_n, h): w for dX, x for dW
  const long long* t;    // (n,) targets
  const float* lse;      // (n,)
  const float* g;        // (n,) upstream gradient of each row's loss
  E* out;             // (own_n, h), or null when `part` takes the sums
  float* part;           // (splits, own_n, h) fp32 partials, or null
  int own_n, stream_n, h, vocab;
  int tiles_per_split;   // streamed tiles one split walks
  int panels;            // hk-wide hidden panels a CTA covers (P)
};

// the own tile, two streamed tiles, dl; the parts of S a cluster
// exchanges (and a pair's two mbarriers)
template <int HK>
constexpr size_t bwd_smem_bytes(int cluster) {
  return (3 * kOwnRows * kStride<HK> + kOwnRows * kStride<64>) * 2 +
         (cluster == 2   ? 4 * kOwnRows * kPairLd * 4 + 16
          : cluster > 2 ? 2 * kOwnRows * kPartLd * 4
                        : 0);
}

// Start copying rows [row0, row0 + 64) x columns [col0, col0 + HK) of a
// (rows, h) E matrix into a (64, HK) tile; rows at or past `limit` and
// columns at or past h become zeros (read from a clamped address). Joins
// the caller's open cp.async group.
template <int HK, typename E>
__device__ __forceinline__ void panel_async(E* dst, const E* src,
                                            int row0, int limit, int col0,
                                            int h) {
  constexpr int CH = HK / 8;  // 16-byte chunks a row
  static_assert(kOwnRows * CH % kLmThreads == 0, "whole rounds of copies");
  auto copy = [&](int u) {
    const int r = u / CH, c = (u % CH) * 8;
    const int row = row0 + r, col = col0 + c;
    const bool in = row < limit && col < h;
    cp_async16(dst + r * kStride<HK> + c,
               src + (in ? static_cast<long>(row) * h + col : 0L), in);
  };
  // unrolled up to 384 columns (GPT-2's pair: faster); at 512, where the
  // accumulator takes 128 registers a thread, unrolled was slower
  if constexpr (HK <= 384) {
#pragma unroll
    for (int k = 0; k < kOwnRows * CH / kLmThreads; ++k)
      copy(threadIdx.x + k * kLmThreads);
  } else {
    for (int u = threadIdx.x; u < kOwnRows * CH; u += kLmThreads) copy(u);
  }
}

// s += own . str^T over the HK columns of the two tiles; the warp's 32 x 16
// block of S: s[m][nb] is rows 32 wm + 16 m, columns 16 wn + 8 nb
template <int HK, typename E>
__device__ __forceinline__ void score_part(float (&s)[2][2][4],
                                           const E* own, const E* str,
                                           int wm, int wn, int lane) {
#pragma unroll 4
  for (int kk = 0; kk < HK; kk += 16) {
    uint32_t a0[4], a1[4], b[4];
    load_a<HK>(a0, own, wm * 32, kk, lane);
    load_a<HK>(a1, own, wm * 32 + 16, kk, lane);
    load_bt<HK>(b, str, wn * 16, kk, lane);
    mma16<E>(s[0][0], a0, b[0], b[1]);
    mma16<E>(s[0][1], a0, b[2], b[3]);
    mma16<E>(s[1][0], a1, b[0], b[1]);
    mma16<E>(s[1][1], a1, b[2], b[3]);
  }
}

// acc += dl . str: dl (64 x 64 E, row stride 72), str the streamed tile
// (64 x HK); the warp's 32 rows x HK/4 columns, acc[m][nt] rows 32 wm +
// 16 m, columns HK/4 wn + 8 nt
template <int HK, typename E>
__device__ __forceinline__ void dl_product(float (&acc)[2][HK / 32][4],
                                           const E* dl, const E* str,
                                           int wm, int wn, int lane) {
  constexpr int NT = HK / 32;
#pragma unroll
  for (int kk = 0; kk < kStreamRows; kk += 16) {
    uint32_t a0[4], a1[4];
    load_a<64>(a0, dl, wm * 32, kk, lane);
    load_a<64>(a1, dl, wm * 32 + 16, kk, lane);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t b[4];
      load_b<HK>(b, str, kk, wn * (HK / 4) + 16 * j, lane);
      mma16<E>(acc[0][2 * j], a0, b[0], b[1]);
      mma16<E>(acc[0][2 * j + 1], a0, b[2], b[3]);
      mma16<E>(acc[1][2 * j], a1, b[0], b[1]);
      mma16<E>(acc[1][2 * j + 1], a1, b[2], b[3]);
    }
  }
}

// mbarriers and copies between the shared memories of a pair (addresses:
// shared::cta for this CTA's, shared::cluster for the peer's)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
// arrive (the one arrival a phase expects) and expect `bytes` more
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// the shared::cluster address of this CTA's `local` in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(local), "r"(rank));
  return out;
}
// `bytes` of this CTA's shared memory at `src` to `dst` in the peer's,
// completing that many bytes of the peer's mbarrier `bar`
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src,
                                             int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A row's target, lse and g (target -1, g 0 past the last row: dl = 0)
struct RowInfo {
  long long t;
  float lse, g;
};

template <typename E>
__device__ __forceinline__ RowInfo row_info(const BwdArgs<E>& a, int row,
                                            int n) {
  if (row >= n) return {-1, 0.f, 0.f};
  return {__ldg(a.t + row), __ldg(a.lse + row), __ldg(a.g + row)};
}

// Block (own tile x cluster rank, output panel, vocab split). DW: own = w,
// streamed = x, the vocab index is the own row; else own = x, streamed =
// w, the vocab index is the streamed row.
template <typename E, bool DW, int HK>
__global__ void __launch_bounds__(kLmThreads, 1)
    lm_mma_bwd_kernel(const BwdArgs<E> a) {
  constexpr int LDH = kStride<HK>, LDL = kStride<64>, NT = HK / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  E* s_own = reinterpret_cast<E*>(smem);        // 64 x LDH
  E* s_str = s_own + kOwnRows * LDH;               // 2 x 64 x LDH
  E* s_dl = s_str + 2 * kStreamRows * LDH;         // 64 x LDL
  // parts of S: a cluster's 2 x 64 x kPartLd, or a pair's 4 x 64 x
  // kPairLd (received [0, 1], sent [2, 3]) and its mbarriers full[2]
  float* s_part = reinterpret_cast<float*>(s_dl + kOwnRows * LDL);
  uint64_t* s_full =
      reinterpret_cast<uint64_t*>(s_part + 4 * kOwnRows * kPairLd);

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int own0 = (blockIdx.x / csize) * kOwnRows;
  const int P = a.panels, group = blockIdx.y;
  if (csize == 2) {
    if (threadIdx.x == 0) {
      mbar_init(smem_addr(s_full), 1);
      mbar_init(smem_addr(s_full + 1), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster.sync();  // the peer's mbarriers exist before any copy to them
  }
  // this thread's S elements in a part with row stride ld: rows 32 wm +
  // 16 m + g8 + 8 hh, columns 16 wn + 8 nb + 2 t4 (and + 1)
  auto frag_at = [&](int m, int nb, int hh, int ld) {
    return (wm * 32 + 16 * m + g8 + 8 * hh) * ld + wn * 16 + 8 * nb + 2 * t4;
  };
  const int n = DW ? a.stream_n : a.own_n;
  const int ntiles = (a.stream_n + kStreamRows - 1) / kStreamRows;
  const int t_begin = blockIdx.z * a.tiles_per_split;
  const int t_end = min(ntiles, t_begin + a.tiles_per_split);

  // dX: the rows of this thread's accumulator and score elements are x
  // rows, fixed for the block: own0 + 32 wm + 16 (i / 2) + g8 + 8 (i % 2)
  RowInfo rows[4];
  if (!DW) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rows[i] = row_info(a, own0 + wm * 32 + 16 * (i >> 1) + g8 + 8 * (i & 1),
                         n);
  }

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;

  const int col1 = rank * HK;  // the one panel when P == 1
  if (P == 1) {
    panel_async<HK>(s_own, a.own, own0, a.own_n, col1, a.h);
    if (t_begin < t_end)
      panel_async<HK>(s_str, a.stream, t_begin * kStreamRows, a.stream_n,
                      col1, a.h);
    cp_async_commit();
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int i = tile - t_begin;
    const int tile0 = tile * kStreamRows;
    // dW: the score columns of this thread are x rows tile0 + 16 wn + 8
    // (j / 2) + 2 t4 + j % 2
    RowInfo cols[4];
    if (DW) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cols[j] = row_info(a, tile0 + wn * 16 + 8 * (j >> 1) + 2 * t4 +
                                  (j & 1), n);
    }
    float s[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[m][nb][q] = 0.f;
    const E* str;
    if (P == 1) {
      __syncthreads();  // the readers of the other buffer (tile - 1) are done
      if (tile + 1 < t_end) {
        panel_async<HK>(s_str + ((i + 1) & 1) * kStreamRows * LDH, a.stream,
                        tile0 + kStreamRows, a.stream_n, col1, a.h);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // this tile has landed for every thread
      str = s_str + (i & 1) * kStreamRows * LDH;
      score_part<HK>(s, s_own, str, wm, wn, lane);
    } else {
      // panel by panel, the output panel last: its streamed tile stays in
      // the buffer for the second product
      for (int kp = 0; kp < P; ++kp) {
        const int col = (rank * P + (group + 1 + kp) % P) * HK;
        __syncthreads();  // the previous panel's (or tile's) readers are done
        panel_async<HK>(s_own, a.own, own0, a.own_n, col, a.h);
        panel_async<HK>(s_str, a.stream, tile0, a.stream_n, col, a.h);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        score_part<HK>(s, s_own, s_str, wm, wn, lane);
      }
      str = s_str;
    }

    if (csize == 2) {
      // a pair: this CTA's part into its send buffer i % 2, one bulk copy
      // of it into the peer's receive buffer i % 2 (completing the peer's
      // mbarrier i % 2), then the peer's part from our receive buffer, the
      // sum in rank order. A send buffer is written again two tiles
      // later: by then the peer's part of tile i + 1 has arrived, which
      // it sent after our copy of tile i had landed.
      constexpr int PART = kOwnRows * kPairLd;
      float* send = s_part + (2 + (i & 1)) * PART;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(send + frag_at(m, nb, hh, kPairLd)) =
                make_float2(s[m][nb][2 * hh], s[m][nb][2 * hh + 1]);
      // the bulk copy reads through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const uint32_t full = smem_addr(s_full + (i & 1));
      if (threadIdx.x == 0) {
        mbar_expect_tx(full, PART * 4);
        bulk_to_peer(map_rank(smem_addr(s_part + (i & 1) * PART), rank ^ 1),
                     smem_addr(send), PART * 4, map_rank(full, rank ^ 1));
      }
      mbar_wait(full, (i >> 1) & 1);
      const float* got = s_part + (i & 1) * PART;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 v = *reinterpret_cast<const float2*>(
                got + frag_at(m, nb, hh, kPairLd));
            float& x = s[m][nb][2 * hh];
            float& y = s[m][nb][2 * hh + 1];
            x = rank == 0 ? x + v.x : v.x + x;
            y = rank == 0 ? y + v.y : v.y + y;
          }
    } else if (csize > 2) {
      // the cluster's parts of S, summed in rank order; parts alternate
      // between two buffers, so one cluster barrier a tile keeps a part
      // from being overwritten before every CTA has read it
      float* mine = s_part + (i & 1) * kOwnRows * kPartLd;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(mine + frag_at(m, nb, hh, kPartLd)) =
                make_float2(s[m][nb][2 * hh], s[m][nb][2 * hh + 1]);
      cluster.sync();
      float sum[2][2][4];
      for (int r = 0; r < csize; ++r) {
        const float* other = cluster.map_shared_rank(mine, r);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float2 v = make_float2(s[m][nb][2 * hh], s[m][nb][2 * hh + 1]);
              if (r != rank)
                v = *reinterpret_cast<const float2*>(
                    other + frag_at(m, nb, hh, kPartLd));
              if (r == 0) {
                sum[m][nb][2 * hh] = v.x;
                sum[m][nb][2 * hh + 1] = v.y;
              } else {
                sum[m][nb][2 * hh] += v.x;
                sum[m][nb][2 * hh + 1] += v.y;
              }
            }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[m][nb][q] = sum[m][nb][q];
    }

    // dl = (exp(s - lse) - hit) * g, 0 past the vocab, rounded to E
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ri = 2 * m + hh, cj = 2 * nb + e;
            const int vocab =
                DW ? own0 + wm * 32 + 16 * m + g8 + 8 * hh
                   : tile0 + wn * 16 + 8 * nb + 2 * t4 + e;
            const RowInfo& ri_ = DW ? cols[cj] : rows[ri];
            const float p = expf(s[m][nb][2 * hh + e] - ri_.lse);
            const float hit = ri_.t == vocab ? 1.f : 0.f;
            d[e] = vocab < a.vocab ? (p - hit) * ri_.g : 0.f;
          }
          *reinterpret_cast<uint32_t*>(s_dl + frag_at(m, nb, hh, LDL)) =
              pack2<E>(d[0], d[1]);
        }
    __syncthreads();
    dl_product<HK>(acc, s_dl, str, wm, wn, lane);
  }
  cp_async_wait<0>();  // an empty split's first copy
  // no CTA leaves while another of its cluster may still read its parts (a
  // pair's reads are all local)
  if (csize > 2) cluster.sync();

  const int col0 = (rank * P + group) * HK + wn * (HK / 4);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = own0 + wm * 32 + 16 * m + g8 + 8 * hh;
      if (row >= a.own_n) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = col0 + 8 * j + 2 * t4;
        if (col >= a.h) continue;
        const float v0 = acc[m][j][2 * hh], v1 = acc[m][j][2 * hh + 1];
        const long at = static_cast<long>(row) * a.h + col;
        if (a.part != nullptr)
          *reinterpret_cast<float2*>(
              a.part + static_cast<long>(blockIdx.z) * a.own_n * a.h + at) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(a.out + at) = pack2<E>(v0, v1);
      }
    }
}

// dx = sum of the splits' fp32 partials in split order, in E; four
// elements a thread (count is a multiple of 128)
template <typename E>
__global__ void __launch_bounds__(kLmThreads)
    lm_mma_dx_merge_kernel(const float* __restrict__ part,
                           E* __restrict__ dx, long count, int splits) {
  const long i = (static_cast<long>(blockIdx.x) * kLmThreads + threadIdx.x) *
                 4;
  if (i >= count) return;
  float4 s = __ldcg(reinterpret_cast<const float4*>(part + i));
  for (int k = 1; k < splits; ++k) {
    const float4 p =
        __ldcg(reinterpret_cast<const float4*>(part + k * count + i));
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  uint2 out;
  out.x = pack2<E>(s.x, s.y);
  out.y = pack2<E>(s.z, s.w);
  *reinterpret_cast<uint2*>(dx + i) = out;
}

template <typename E, bool DW, int HK>
cudaError_t launch_bwd(const BwdArgs<E>& a, int cluster, int own_tiles,
                       int splits, cudaStream_t s) {
  auto kernel = lm_mma_bwd_kernel<E, DW, HK>;
  const size_t bytes = bwd_smem_bytes<HK>(cluster);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(own_tiles * cluster, a.panels, splits);
  cfg.blockDim = dim3(kLmThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <bool DW, typename E>
cudaError_t launch_hk(const BwdArgs<E>& a, int hk, int cluster,
                      int own_tiles, int splits, cudaStream_t s) {
  switch (hk) {
    case 128: return launch_bwd<E, DW, 128>(a, cluster, own_tiles, splits, s);
    case 256: return launch_bwd<E, DW, 256>(a, cluster, own_tiles, splits, s);
    case 384: return launch_bwd<E, DW, 384>(a, cluster, own_tiles, splits, s);
    case 512: return launch_bwd<E, DW, 512>(a, cluster, own_tiles, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// forward: (m, l, p) of each row over a vocab split, then the splits merged
// in order

constexpr int kFwdRows = 128;     // x rows of a block
constexpr int kFwdVocab = 128;    // vocab rows of a tile
constexpr int kFwdWarpRows = 4;   // warps along the rows (the rest along
                                  // the vocab)
constexpr int kFwdStages = 3;     // depth of the cp.async ring
constexpr int kFwdMinBlocks = 2;  // blocks an SM
constexpr int kFwdK = 64;         // hidden columns of a k chunk
constexpr int kFwdMaxSplits = 64;
constexpr int kFwdWarpCols = 8 / kFwdWarpRows;
constexpr int kFwdMI = kFwdRows / kFwdWarpRows / 16;  // m16 tiles a warp
constexpr int kFwdNJ = kFwdVocab / kFwdWarpCols / 8;  // n8 tiles a warp
constexpr int kFwdStageElems = (kFwdRows + kFwdVocab) * kStride<kFwdK>;
// the ring, then the warps' per-row (m, l, p) for the final merge
constexpr size_t kFwdSmem =
    static_cast<size_t>(kFwdStages) * kFwdStageElems * 2 +
    3 * kFwdWarpCols * kFwdRows * 4;
static_assert(kFwdNJ % 2 == 0 && kFwdRows <= kLmThreads, "fwd tiling");

template <typename E>
struct FwdArgs {
  const E* x;         // (n, h)
  const E* w;         // (vocab, h)
  const long long* t;    // (n,) targets
  float* part;           // (3, splits, n): m, l, p of each split
  int n, vocab, h;
  int tiles_per_split;   // vocab tiles one split walks
};

// Start copying rows [row0, row0 + ROWS) x columns [col0, col0 + 64) of a
// (rows, h) E matrix into a (ROWS, 64) ring stage; rows at or past
// `limit` become zeros (read from a clamped address). h is a multiple of
// 64, so no column is past it. Joins the caller's open cp.async group.
template <int ROWS, typename E>
__device__ __forceinline__ void chunk_async(E* dst, const E* src,
                                            int row0, int limit, int col0,
                                            int h) {
  constexpr int CH = kFwdK / 8;  // 16-byte chunks a row
  static_assert(ROWS * CH % kLmThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int k = 0; k < ROWS * CH / kLmThreads; ++k) {
    const int u = threadIdx.x + k * kLmThreads;
    const int r = u / CH, c = (u % CH) * 8;
    const int row = row0 + r;
    const bool in = row < limit;
    cp_async16(dst + r * kStride<kFwdK> + c,
               src + (in ? static_cast<long>(row) * h + col0 + c : 0L), in);
  }
}

// (m, l) of two partials merged: m = max, l = sum of each l rescaled to it
// (commutative: either order gives the same bits)
__device__ __forceinline__ void merge_ml(float& m, float& l, float m2,
                                         float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// Block (row tile, vocab split): its rows' (m, l, p) over the split's vocab
// tiles, written to part[(k * splits + split) * n + row] for k = m, l, p.
template <typename E>
__global__ void __launch_bounds__(kLmThreads, kFwdMinBlocks)
    lm_mma_fwd_kernel(const FwdArgs<E> a) {
  constexpr int MI = kFwdMI, NJ = kFwdNJ, RT = 2 * kFwdMI;
  constexpr int WM = kFwdRows / kFwdWarpRows, WN = kFwdVocab / kFwdWarpCols;
  extern __shared__ __align__(128) unsigned char smem[];
  E* ring = reinterpret_cast<E*>(smem);
  float* red = reinterpret_cast<float*>(ring + kFwdStages * kFwdStageElems);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  // this warp's block of S: rows WM wm.., columns WN wn..
  const int wm = warp / kFwdWarpCols, wn = warp % kFwdWarpCols;
  const int row0 = blockIdx.x * kFwdRows;
  const int vtiles = (a.vocab + kFwdVocab - 1) / kFwdVocab;
  const int t_begin = blockIdx.y * a.tiles_per_split;
  const int t_end = min(vtiles, t_begin + a.tiles_per_split);
  const int nk = a.h / kFwdK;
  const int total = max(0, t_end - t_begin) * nk;

  // step `it` of the (vocab tile, k chunk) walk into its ring stage; an
  // empty group past the end keeps the waits' counts uniform
  auto issue = [&](int it) {
    if (it < total) {
      E* sx = ring + (it % kFwdStages) * kFwdStageElems;
      const int k0 = (it % nk) * kFwdK;
      chunk_async<kFwdRows>(sx, a.x, row0, a.n, k0, a.h);
      chunk_async<kFwdVocab>(sx + kFwdRows * kStride<kFwdK>, a.w,
                             (t_begin + it / nk) * kFwdVocab, a.vocab, k0,
                             a.h);
    }
    cp_async_commit();
  };

  // this thread's rows: i = 2 mi + hh is row WM wm + 16 mi + g8 + 8 hh of
  // the tile; its columns of a tile: WN wn + 8 nj + 2 t4 + e
  int tgt[RT];
  float m[RT], l[RT], p[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = row0 + wm * WM + 16 * (i >> 1) + g8 + 8 * (i & 1);
    const long long tv = row < a.n ? __ldg(a.t + row) : -1;
    tgt[i] = tv >= 0 && tv < a.vocab ? static_cast<int>(tv) : -1;
    m[i] = apex::kNegInf;
    l[i] = 0.f;
    p[i] = 0.f;
  }
  float acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  for (int s = 0; s < kFwdStages - 1; ++s) issue(s);
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kFwdStages - 2>();  // step it has landed (this thread's)
    __syncthreads();  // ... for every thread; step it - 1's readers done
    issue(it + kFwdStages - 1);       // into step it - 1's stage
    const E* sx = ring + (it % kFwdStages) * kFwdStageElems;
    const E* sw = sx + kFwdRows * kStride<kFwdK>;
#pragma unroll
    for (int kk = 0; kk < kFwdK; kk += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        load_a<kFwdK>(af[mi], sx, wm * WM + 16 * mi, kk, lane);
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j) {
        uint32_t b[4];
        load_bt<kFwdK>(b, sw, wn * WN + 16 * j, kk, lane);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma16<E>(acc[mi][2 * j], af[mi], b[0], b[1]);
          mma16<E>(acc[mi][2 * j + 1], af[mi], b[2], b[3]);
        }
      }
    }
    if (it % nk != nk - 1) continue;
    // the tile's S is complete: each row's (m, l, p) over this thread's
    // columns, then S is cleared for the next tile; columns past V only
    // in the vocab's last tile
    const int v0 = (t_begin + it / nk) * kFwdVocab;
    const int c0 = v0 + wn * WN + 2 * t4;
    const bool ragged = v0 + kFwdVocab > a.vocab;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int mi = i >> 1, hh = i & 1;
      float mx = apex::kNegInf;
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * nj + e;
          float& s = acc[mi][nj][2 * hh + e];
          if (ragged && col >= a.vocab) s = apex::kNegInf;
          if (col == tgt[i]) p[i] += s;
          mx = fmaxf(mx, s);
        }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (!ragged || c0 + 8 * nj + e < a.vocab)
            sum += expf(acc[mi][nj][2 * hh + e] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
  }
  cp_async_wait<0>();  // the empty groups past the end

  // merge: the quad's lanes, then the warps of a row in warp order
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[i], o);
      p[i] += __shfl_xor_sync(0xffffffffu, p[i], o);
      merge_ml(m[i], l[i], m2, l2);
    }
    if (t4 == 0) {
      const int r = wm * WM + 16 * (i >> 1) + g8 + 8 * (i & 1);
      red[(0 * kFwdWarpCols + wn) * kFwdRows + r] = m[i];
      red[(1 * kFwdWarpCols + wn) * kFwdRows + r] = l[i];
      red[(2 * kFwdWarpCols + wn) * kFwdRows + r] = p[i];
    }
  }
  __syncthreads();
  const int r = threadIdx.x, row = row0 + r;
  if (r < kFwdRows && row < a.n) {
    constexpr int L = kFwdWarpCols * kFwdRows, P = 2 * L;
    float mm = red[r], ll = red[L + r], pp = red[P + r];
    for (int q = 1; q < kFwdWarpCols; ++q) {
      merge_ml(mm, ll, red[q * kFwdRows + r], red[L + q * kFwdRows + r]);
      pp += red[P + q * kFwdRows + r];
    }
    const long stride = static_cast<long>(gridDim.y) * a.n;
    float* out = a.part + static_cast<long>(blockIdx.y) * a.n + row;
    out[0] = mm;
    out[stride] = ll;
    out[2 * stride] = pp;
  }
}

// lse = M + log(sum_s l_s exp(m_s - M)), M = max_s m_s; pred = sum_s p_s;
// the splits in order
__global__ void __launch_bounds__(kLmThreads)
    lm_mma_fwd_merge_kernel(const float* __restrict__ part,
                            float* __restrict__ lse, float* __restrict__ pred,
                            int n, int splits) {
  const int row = blockIdx.x * kLmThreads + threadIdx.x;
  if (row >= n) return;
  const long stride = static_cast<long>(splits) * n;
  float big = apex::kNegInf;
  for (int k = 0; k < splits; ++k)
    big = fmaxf(big, part[static_cast<long>(k) * n + row]);
  float l = 0.f, p = 0.f;
  for (int k = 0; k < splits; ++k) {
    const long at = static_cast<long>(k) * n + row;
    l += part[stride + at] * expf(part[at] - big);
    p += part[2 * stride + at];
  }
  lse[row] = big + logf(l);
  pred[row] = p;
}

// the layout the wrapper chose: cluster CTAs of `panels` panels of hk
// columns cover the hidden axis (512-column panels only without a
// cluster: their parts of S would not fit beside the tiles)
bool layout_ok(int h, int cluster, int hk, int panels, int splits) {
  return h > 0 && h % 128 == 0 && cluster >= 1 && cluster <= kMaxCluster &&
         (hk == 128 || hk == 256 || hk == 384 ||
          (hk == 512 && cluster == 1)) &&
         panels >= 1 &&
         static_cast<long>(cluster) * panels * hk >= h &&
         static_cast<long>(cluster) * (panels - 1) * hk < h && splits >= 1 &&
         splits <= kMaxSplits;
}


// On CUDA device `device`, on `stream`. x: (n, h), w: (V, h), E,
// contiguous, 16-byte aligned, h a multiple of 128; t: (n,) int64 target
// ids (an id outside [0, V) hits no column: pred 0). Writes the (m, l, p)
// of each of `splits` vocab splits (1 to 64, the caller's) into `part`,
// (3, splits, n) fp32 scratch, then lse and pred, (n,) fp32, merging the
// splits in order.
template <typename E>
int mma_fwd(int device, const void* x, const void* w, const void* t,
            void* part, void* lse, void* pred, int n, int v, int h,
            int splits, void* stream) {
  if (h <= 0 || h % 128 != 0 || n <= 0 || v <= 0 || splits < 1 ||
      splits > kFwdMaxSplits || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      lm_mma_fwd_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFwdSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (v + kFwdVocab - 1) / kFwdVocab;
  const FwdArgs<E> a{static_cast<const E*>(x), static_cast<const E*>(w),
                  static_cast<const long long*>(t), static_cast<float*>(part),
                  n, v, h, (tiles + splits - 1) / splits};
  lm_mma_fwd_kernel<E><<<dim3((n + kFwdRows - 1) / kFwdRows, splits),
                      kLmThreads, kFwdSmem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lm_mma_fwd_merge_kernel<<<(n + kLmThreads - 1) / kLmThreads, kLmThreads, 0,
                            s>>>(static_cast<const float*>(part),
                                 static_cast<float*>(lse),
                                 static_cast<float*>(pred), n, splits);
  return static_cast<int>(cudaGetLastError());
}

// On CUDA device `device`, on `stream`. x: (n, h), w: (V, h), E,
// contiguous, 16-byte aligned, h a multiple of 128; t: (n,) int64 target
// ids (an id outside [0, V) hits no column); lse, g: (n,) fp32. The hidden
// layout (cluster CTAs of `panels` panels of hk in {128, 256, 384}
// columns) and dX's vocab split count come from the caller. dX writes dx
// (n, h) E; with splits > 1 it first writes `part`, (splits, n, h)
// fp32 scratch, and then adds the splits in order. dW writes dw (V, h)
// E.
template <typename E>
int mma_bwd_dx(int device, const void* x, const void* w, const void* t,
               const void* lse, const void* g, void* part, void* dx, int n,
               int v, int h, int cluster, int hk, int panels, int splits,
               void* stream) {
  if (!layout_ok(h, cluster, hk, panels, splits) || n <= 0 || v <= 0 ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (v + kStreamRows - 1) / kStreamRows;
  const BwdArgs<E> a{static_cast<const E*>(x),
                  static_cast<const E*>(w),
                  static_cast<const long long*>(t),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(g),
                  splits > 1 ? nullptr : static_cast<E*>(dx),
                  splits > 1 ? static_cast<float*>(part) : nullptr,
                  n, v, h, v, (tiles + splits - 1) / splits, panels};
  cudaError_t e = launch_hk<false>(a, hk, cluster,
                                   (n + kOwnRows - 1) / kOwnRows, splits, s);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long count = static_cast<long>(n) * h;
  lm_mma_dx_merge_kernel<E><<<(count / 4 + kLmThreads - 1) / kLmThreads,
                           kLmThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<E*>(dx), count,
      splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int mma_bwd_dw(int device, const void* x, const void* w, const void* t,
               const void* lse, const void* g, void* dw, int n, int v, int h,
               int cluster, int hk, int panels, void* stream) {
  if (!layout_ok(h, cluster, hk, panels, 1) || n <= 0 || v <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs<E> a{static_cast<const E*>(w),
                  static_cast<const E*>(x),
                  static_cast<const long long*>(t),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(g),
                  static_cast<E*>(dw),
                  nullptr,
                  v, n, h, v, (n + kStreamRows - 1) / kStreamRows, panels};
  cudaError_t e = launch_hk<true>(a, hk, cluster,
                                  (v + kOwnRows - 1) / kOwnRows, 1, s);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

// runs the entry given with E bound to the element type of `dtype` (bf16
// or fp16); cudaErrorInvalidValue for another type
#define APEX_LM_MMA_DISPATCH(FN, ...)                              \
  do {                                                             \
    if (dtype == apex::kBF16) return FN<__nv_bfloat16>(__VA_ARGS__); \
    if (dtype == apex::kF16) return FN<__half>(__VA_ARGS__);       \
    return static_cast<int>(cudaErrorInvalidValue);                \
  } while (0)

}  // namespace

// The entry points: mma_fwd, mma_bwd_dx and mma_bwd_dw above, for bf16 or
// fp16 x and w (dtype 1 or 2; dx and dw in their type), anything else
// returns cudaErrorInvalidValue.
extern "C" int lm_head_mma_fwd(int device, const void* x, const void* w,
                               const void* t, void* part, void* lse,
                               void* pred, int n, int v, int h, int splits,
                               int dtype, void* stream) {
  APEX_LM_MMA_DISPATCH(mma_fwd, device, x, w, t, part, lse, pred, n, v, h,
                       splits, stream);
}

extern "C" int lm_head_mma_bwd_dx(int device, const void* x, const void* w,
                                  const void* t, const void* lse,
                                  const void* g, void* part, void* dx, int n,
                                  int v, int h, int cluster, int hk,
                                  int panels, int splits, int dtype,
                                  void* stream) {
  APEX_LM_MMA_DISPATCH(mma_bwd_dx, device, x, w, t, lse, g, part, dx, n, v,
                       h, cluster, hk, panels, splits, stream);
}

extern "C" int lm_head_mma_bwd_dw(int device, const void* x, const void* w,
                                  const void* t, const void* lse,
                                  const void* g, void* dw, int n, int v,
                                  int h, int cluster, int hk, int panels,
                                  int dtype, void* stream) {
  APEX_LM_MMA_DISPATCH(mma_bwd_dw, device, x, w, t, lse, g, dw, n, v, h,
                       cluster, hk, panels, stream);
}
