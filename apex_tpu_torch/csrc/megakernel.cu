// One fused GPT decode/verify layer for Hopper (sm_90a): the megakernel.
//
// Replaces the TPU kernel apex_tpu/serve/megakernel.py
// `_fused_block_kernel` (reached through `_fused_block`, pallas_call at
// megakernel.py:668), in the model type T: fp32, bf16 or fp16. Per fed
// row (n slots x q rows, R = n * q, any R):
//   1. LN1 in fp32 (E[x^2] - E[x]^2 clamped at 0, eps), h1 cast to T;
//   2. qkv = h1 @ Wqkv with fp32 accumulation + fp32 bias, kept fp32: q is
//      never rounded to T; K and V are emitted in T (per-head interleaved
//      columns, head-major (H, 3, D));
//   3. each valid fed row writes its K/V into the paged pool at
//      (block_tables[slot, pos / bs], pos % bs): T as is, or through the
//      comm.quantize codec (int8: absmax/127 per head vector; int4:
//      absmax/7 per group, the scale rounded to bf16 first, nibble pairs);
//   4. attention over pool positions 0..pos with paged_split.cuh's split
//      walk; ctx cast to T;
//   5. x1 = x + (ctx @ Wout + b), an fp32 residual, not rounded;
//   6. LN2 of x1 in fp32, cast to T; y = gelu_tanh(h2 @ W1 + b1) in fp32,
//      cast to T; x' = x1 + (y @ W2 + b2), cast to T.
// Invalid rows (inactive slot, w >= n_valid, pos >= mb * bs) write
// nothing; an invalid row attends no position (its ctx is zeros, as the
// per-op path gives it), so it stays finite.
//
// Why the pool is written in the kernel: JAX folds the fed rows through
// the codec round trip after the pool walk (megakernel.py:473-497)
// precisely so that they equal what a read-back returns. Writing first and
// reading back gives that function by construction, walks the same
// positions in the same splits for a verify row as for the decode of that
// token, and takes the eager scatter and codec ops off every layer.
//
// Bound on this card: device memory at serving row counts. One launch
// reads the layer's weights and vectors once ((3h^2 + hd*h + 2*h*f +
// 9h + f) * sizeof(T)), the pool positions it attends (per slot, its
// largest ctx rounded up to whole blocks, * H * D * 2 * elem_bytes) and
// writes the fed rows' K/V and x' (2 * R * h * sizeof(T) for x in and
// out); over 3.35 TB/s.
//
// Design. One cooperative launch per layer: one block of 256 threads an
// SM, every block resident; phases separated by grid syncs, 5 with
// full-precision pools and 6 with int8 / int4 ones:
//   qkv | [int8 / int4 pool write] | attention | merge | out | fc1 | fc2.
// * GEMMs (qkv, out, fc1, fc2): one routine, not inlined, for all four
//   (runtime descriptors; one copy of its code a launch). An item is 16
//   output columns over K; blocks take items in turn (item = blockIdx +
//   j * gridDim). The rows a block multiplies sit in shared memory, in T,
//   in row chunks of up to 64, so each block normalizes the rows it
//   stages: LN1 of x before qkv, LN2 of x1 before fc1 (a warp a row, fp32
//   sums in a fixed order; the raw rows and the LN weights land in one
//   cp.async round). The weights stream through a cp.async ring (bf16 and
//   fp16: 12 stages of 128 k x 16 columns, 44 KB in flight an SM; fp32: 6
//   of 128 k, 40 KB) that runs on across a block's items. bf16 and fp16
//   products run on the tensor cores, mma.sync m16n8k16 (.bf16 or .f16)
//   with fp32 accumulators, the
//   weight's 16 columns on M and the fed rows on N ("swap AB": a decode
//   call is one n8 tile; wider calls loop over n8 tiles, each weight
//   fragment loaded once for all of them): A is the weight tile through
//   ldmatrix.trans (its two 16-byte halves swapped in rows 4-7 of every
//   8: no bank conflicts), B the staged rows through ldmatrix. fp32 stays
//   on the CUDA cores (TF32 would break the fp32 gate), a lane a column x
//   every other row, the rows read 4 k at a time. Warp w of 8 takes k16
//   step w of every 128-k chunk (fp32: k 16w..16w+15); at an item's end
//   the warps' sums are added in warp order, then the bias and the
//   epilogue (its operands fetched when the item starts): q (fp32), K and
//   V (T, and the pool when it is full precision), x1, y, x'. A phase
//   whose rows are copied (out, fc2) splits K where its whole K would not
//   let 64 rows fit the shared memory (fc2 at GPT-2's width: 3 splits in
//   bf16, 6 in fp32; out in fp32: 2): its items leave fp32 partials and
//   the last of a tile's splits to arrive (one fenced atomic a block)
//   adds them in split order. One owner per output element, sums in an
//   order set by K and N alone: not by R, the row chunk or the grid, so
//   two launches are bitwise equal and a row's result does not depend on
//   the rows beside it: a verify row gives the bits the decode of that
//   token gives.
// * int8 / int4 pools: a warp per (row, head, K | V) runs the codec on the
//   emitted vector (it needs the whole head vector, which no 16-column
//   item holds): a phase of its own.
// * Attention: paged_split.cuh's walk (paged_walks.cuh's bodies), one
//   item per (context split, head, tile of one slot's rows), the blocks
//   taking items from a queue (an atomic counter), the last splits first:
//   a slot's K/V tile is read once for all its fed rows. bf16 and fp16 on
//   the tensor cores as paged_mma.cu (q, fp32 here, enters as two terms
//   of T, hi + lo, as p does), fp32 on the CUDA cores as paged_attention.cu,
//   head dims above 256 on the wide walk (128-channel chunks). Head dims
//   are bucketed to 64, 128, 256 (zero-padded) and wide: four
//   instantiations a type and pool format. The K/V ring is 4 stages deep
//   up to 128 (the per-op kernels' 2 at 256). Splits are 4 tiles of 64
//   positions or more (serve/megakernel.py `_fused_splits`, a function of
//   the table's capacity), so a row's bits depend on its own context and
//   the split geometry.
// * Merge: a warp per (row, head) adds the splits in order
//   (paged_split.cuh merge_row), the per-op path's second launch.
// * Data written earlier in the launch by other blocks (scratch, pools) is
//   read through L2 (ld.global.cg, cp.async.cg) or by an SM that has not
//   read those lines before in the launch: L1 is not coherent across SMs.
// Where the time goes (bf16, GPT-2-124M, 8 decode rows; PERF.md §6):
// each phase costs a few microseconds of dependent latency and a grid
// sync besides its bytes, and a cp.async stream reaches about 2 TB/s
// with one block an SM.
// Limits: hidden == heads * head_dim, head_dim % 8 == 0 (so hidden, ffn
// % 8 == 0), and the shared memory: fused_layer_smem_bytes (the largest of
// the attention phase's layout, the codec phase's vectors, and each GEMM
// phase's fewest rows (bf16 16, fp32 8) beside its ring, sums, LN weights
// and raw rows) within kSmemBudget.

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "paged_walks.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 16;        // output columns of a GEMM item
constexpr int kSmemBudget = 229376;  // dynamic shared memory of a block


template <typename T>
struct Gemm;
template <>
struct Gemm<bf16> {
  static constexpr int KC = 128;    // k of a ring stage: 8 k16 steps
  static constexpr int STAGES = 12;
  static constexpr int APAD = 8;    // a staged row's padding: 16 bytes
  static constexpr int RC_MIN = 16, RC_MAX = 64;  // rows of a chunk
};
template <>
struct Gemm<__half> : Gemm<bf16> {};  // fp16: bf16's geometry
template <>
struct Gemm<float> {
  static constexpr int KC = 128;    // k of a ring stage: 16 a warp
  static constexpr int STAGES = 6;
  static constexpr int APAD = 4;
  static constexpr int RC_MIN = 8, RC_MAX = 64;
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ inline size_t align256(size_t b) {
  return (b + 255) / 256 * 256;
}

// Shared memory of a GEMM phase, in the order laid out: the staged rows
// (rc x (kw + APAD) of T), the weight ring, the 8 warps' sums, the LN
// weights (ln: 2 x K of T), the rows' pool tokens, and for an LN of fp32
// rows into bf16 (LN2 of a bf16 model) `raw` raw rows at a time (up to
// kRawRows, as many as the budget leaves; one is the least).
constexpr int kRawRows = 16;

struct GemmSmem {
  int as, ring, red, lnw, tok, raw, total;
};

template <typename T>
__host__ __device__ inline GemmSmem gemm_smem(int kw, int k, int rc, bool ln,
                                              int raw) {
  using G = Gemm<T>;
  const int esz = static_cast<int>(sizeof(T));
  GemmSmem m;
  m.as = 0;
  m.ring = rc * (kw + G::APAD) * esz;
  m.red = m.ring + G::STAGES * G::KC * kNT * esz;
  m.lnw = m.red + kWarps * kNT * rc * 4;
  m.tok = m.lnw + (ln ? round_up(2 * k * esz, 16) : 0);
  m.raw = m.tok + round_up(rc * 4, 16);
  m.total = m.raw + raw * k * 4;
  return m;
}

// A GEMM phase's items: 16-column tiles of N, each over `splits` ordered
// K ranges of `cps` ring chunks (kw = cps * KC columns). A phase whose rows
// are copied (out, fc2) splits K where its whole K would not let RC_MAX
// rows fit kSmemBudget: the fewest splits that do, a function of K, N and
// the type alone (fc2 at GPT-2's width: 3 in bf16, 6 in fp32). The LN
// phases (qkv, fc1) never split: their rows are normalized whole.
struct GemmGeo {
  int tiles, nch, cps, splits, kw;
};

template <typename T>
__host__ __device__ inline GemmGeo gemm_geo(int k, int n, bool split) {
  using G = Gemm<T>;
  GemmGeo g;
  g.tiles = (n + kNT - 1) / kNT;
  g.nch = (k + G::KC - 1) / G::KC;
  int s = 1;
  while (split && s < g.nch &&
         gemm_smem<T>((g.nch + s - 1) / s * G::KC, k, G::RC_MAX, false, 0)
                 .total > kSmemBudget)
    ++s;
  g.cps = (g.nch + s - 1) / s;
  g.splits = (g.nch + g.cps - 1) / g.cps;
  g.kw = g.cps * G::KC;
  return g;
}

// rows of a chunk: the most that fit in `budget` bytes (a multiple of
// RC_MIN, at most RC_MAX), no more than R needs; 0 when not even RC_MIN fit
template <typename T>
__host__ __device__ inline int rows_per_chunk(int kw, int k, int rows,
                                              bool ln, int raw, int budget) {
  using G = Gemm<T>;
  int rc = round_up(rows, G::RC_MIN);
  if (rc > G::RC_MAX) rc = G::RC_MAX;
  while (rc >= G::RC_MIN && gemm_smem<T>(kw, k, rc, ln, raw).total > budget)
    rc -= G::RC_MIN;
  return rc >= G::RC_MIN ? rc : 0;
}

// Byte offsets of the scratch buffers in one allocation: q, each row's
// context, ctx, x1, y, the attention partials, the split GEMMs' fp32
// partials, the counters of their last-arriver sums and the attention's
// item queue (zeroed in the launch's first phase).
struct Layout {
  size_t qbuf, ctx_len, ctx, x1, y, part, gpart, cnt, total;
  int gemm_cnt;  // counters of each split GEMM
};

__host__ __device__ inline Layout scratch_layout(int rows, int h, int f,
                                                 int heads, int d,
                                                 int splits, int q,
                                                 int esz) {
  const size_t r = rows;
  // the split GEMMs (out: K = h, fc2: K = f; N = h) of either type: the
  // larger split count, row chunks of at least 8 rows
  const GemmGeo go = esz == 2 ? gemm_geo<bf16>(h, h, true)
                              : gemm_geo<float>(h, h, true);
  const GemmGeo gf = esz == 2 ? gemm_geo<bf16>(f, h, true)
                              : gemm_geo<float>(f, h, true);
  const int gs = go.splits > gf.splits ? go.splits : gf.splits;
  Layout L;
  L.gemm_cnt = (rows + 7) / 8 * go.tiles;
  size_t o = 0;
  L.qbuf = o;     o += align256(r * h * 4);
  L.ctx_len = o;  o += align256(r * 4);
  L.ctx = o;      o += align256(r * h * esz);
  L.x1 = o;       o += align256(r * h * 4);
  L.y = o;        o += align256(r * f * esz);
  L.part = o;     o += align256(r * heads * splits * (d + 2) * 4);
  L.gpart = o;    o += align256(static_cast<size_t>(gs) * r * h * 4);
  L.cnt = o;      o += align256((2 * L.gemm_cnt + 1) * 4);
  L.total = o;
  return L;
}

struct Args {
  const void* x;  // (R, h) T
  const void *ln1_w, *ln1_b, *qkv_w, *qkv_b, *out_w, *out_b;
  const void *ln2_w, *ln2_b, *fc1_w, *fc1_b, *fc2_w, *fc2_b;
  void *k_pool, *v_pool, *k_scale, *v_scale;  // one layer
  const int* block_tables;                    // (n, mb)
  const int* start;                           // (n,) position of row w=0
  const int* n_valid;                         // (n,) or null: all q rows
  const unsigned char* active;                // (n,) bool
  void *x_out, *k_out, *v_out;                // (R, h), (R, H, D) x 2
  void* scratch;
  int n, q, hidden, heads, d, ffn, pool_blocks, bs, mb, group;
  int splits, split_len, smem;
  float scale, eps;
};

struct Row {
  int slot, pos;
  bool valid, write;
};

__device__ __forceinline__ Row row_of(const Args& a, int r) {
  Row w;
  w.slot = r / a.q;
  const int i = r % a.q;
  w.pos = a.start[w.slot] + i;
  const int nv = a.n_valid != nullptr ? a.n_valid[w.slot] : a.q;
  w.valid = a.active[w.slot] != 0 && i < nv;
  w.write = w.valid && w.pos >= 0 && w.pos < a.mb * a.bs;
  return w;
}

__device__ __forceinline__ void grid_sync(cg::grid_group& g) {
  __threadfence();
  g.sync();
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(inner));
}

// ---------------------------------------------------------------------------
// the GEMM phases: one routine, not inlined, serves the four phases of a
// launch from runtime descriptors, so its code is fetched once a launch
// (a phase's first instructions come from device memory when the L2 was
// flushed, and a megakernel's code is large)

// Loads whose results are used later (an epilogue's operands, fetched when
// its item starts): volatile, so the compiler keeps them where they are
// written, through L2 (some were written earlier in the launch)
__device__ __forceinline__ uint32_t ld_early(const float* p) {
  uint32_t v;
  asm volatile("ld.global.cg.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}
template <typename S, std::enable_if_t<sizeof(S) == 2, int> = 0>
__device__ __forceinline__ uint32_t ld_early(const S* p) {
  unsigned short v;
  asm volatile("ld.global.cg.b16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}
template <typename S>
__device__ __forceinline__ float early_f(uint32_t v) {
  if constexpr (sizeof(S) == 4) {
    return __uint_as_float(v);
  } else if constexpr (std::is_same_v<S, __half>) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(v)));
  } else {
    return __bfloat162float(
        __ushort_as_bfloat16(static_cast<unsigned short>(v)));
  }
}

// Start copying rows [r0, r0 + rows) x columns [k0, k0 + kw) of src (row
// length k) into dst (rc rows of ldd elements); columns past k and rows
// past `rows` zero. The caller commits.
template <typename S>
__device__ __forceinline__ void rows_async(S* dst, int ldd, const S* src,
                                           int k, int r0, int rows, int rc,
                                           int k0, int kw) {
  constexpr int E = 16 / sizeof(S);
  const int chunks = kw / E;
#pragma unroll 1
  for (int u = threadIdx.x; u < rc * chunks; u += kThreads) {
    const int r = u / chunks, c = (u % chunks) * E;
    const bool live = r < rows && k0 + c < k;
    const S* from = src + static_cast<size_t>(r0 + (r < rows ? r : 0)) * k +
                    min(k0 + c, k - E);
    cp_async16(dst + static_cast<size_t>(r) * ldd + c, from, live);
  }
}

// LN of rows [first, first + count) of the chunk from raw values (row
// stride ldr, S: T or fp32) into As, weights lnw (w then b, T): a warp a
// row, fp32 sums of the row's values in lane order and the warp's xor tree
// (a function of K alone), E[x^2] - E[x]^2 clamped at 0, as layer_norm.cu
// computes them; rows past `rows` zero (they are when raw is As itself)
template <typename T, typename S>
__device__ void ln_rows(const S* raw, int ldr, T* As, int lda, int first,
                        int count, int rows, int k, int kw, const T* lnw,
                        float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int r = first + warp; r < first + count; r += kWarps) {
    const S* row = raw + static_cast<size_t>(r - first) * ldr;
    T* dst = As + static_cast<size_t>(r) * lda;
    if (r >= rows) {
      if (static_cast<const void*>(raw) != static_cast<const void*>(As))
#pragma unroll 1
        for (int c = lane; c < kw; c += 32) apex::from_f(0.f, &dst[c]);
      continue;
    }
    float s = 0.f, ss = 0.f;
#pragma unroll 4
    for (int c = lane; c < k; c += 32) {
      const float v = apex::to_f(row[c]);
      s += v;
      ss += v * v;
    }
    s = apex::warp_sum(s);
    ss = apex::warp_sum(ss);
    const float mean = s / k;
    const float var = fmaxf(ss / k - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
#pragma unroll 4
    for (int c = lane; c < k; c += 32)
      apex::from_f((apex::to_f(row[c]) - mean) * rstd * apex::to_f(lnw[c]) +
                       apex::to_f(lnw[k + c]),
                   &dst[c]);
    if (static_cast<const void*>(raw) != static_cast<const void*>(As))
#pragma unroll 1
      for (int c = k + lane; c < kw; c += 32) apex::from_f(0.f, &dst[c]);
  }
}

// one ring stage: the weight rows [k0, k0 + KC) x columns [c0, c0 + 16) of
// W (K, N) into Ws (KC rows of 16); rows past K and columns past N zeros.
// bf16 rows are two 16-byte halves, swapped in rows 4-7 of every 8 so
// that an ldmatrix of 8 rows meets 8 bank groups.
template <typename T>
__device__ __forceinline__ void stage_weights(T* Ws, const T* W, int K,
                                              int N, int k0, int c0) {
  using G = Gemm<T>;
  constexpr int E = 16 / sizeof(T);
  constexpr int CH = kNT / E;  // 16-byte chunks a staged row
  static_assert(G::KC * CH % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int u = threadIdx.x; u < G::KC * CH; u += kThreads) {
    const int kk = u / CH, ch = u % CH;
    const int c = ch * E;
    const bool live = k0 + kk < K && c0 + c < N;
    const T* from = W + static_cast<size_t>(min(k0 + kk, K - 1)) * N +
                    min(c0 + c, N - E);
    const int slot = sizeof(T) == 2 ? (ch ^ ((kk >> 2) & 1)) : ch;
    cp_async16(Ws + kk * kNT + slot * E, from, live);
  }
}

// This warp's share of one stage: bf16 or fp16 (E) on the tensor cores,
// k16 step `warp` of the chunk at kb; acc[j] is n8 tile j of the rows
template <typename E, std::enable_if_t<sizeof(E) == 2, int> = 0>
__device__ __forceinline__ void stage_products(float (&acc)[8][4],
                                               const E* Ws, const E* As,
                                               int lda, int kb, int pairs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = lane / 8, r = lane % 8;
  const int row = warp * 16 + r + (j / 2) * 8;
  uint32_t af[4];
  ldmatrix_x4_trans(af, Ws + row * kNT + (((j % 2) ^ ((row >> 2) & 1)) * 8));
  const int k = kb + warp * 16;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    if (p < pairs) {
      uint32_t b[4];
      ldmatrix_x4(b, As + (p * 16 + r + (lane / 16) * 8) * lda + k +
                         (j % 2) * 8);
      mma16<E>(acc[2 * p], af, b[0], b[1]);
      mma16<E>(acc[2 * p + 1], af, b[2], b[3]);
    }
  }
}

// fp32 on the CUDA cores: k kb + 16 warp .. + 15 of the chunk; lane:
// column lane % 16, rows lane / 16 + 2i; acc[i / 4][i % 4]; `pairs`: rows a
// lane takes
__device__ __forceinline__ void stage_products(float (&acc)[8][4],
                                               const float* Ws,
                                               const float* As, int lda,
                                               int kb, int pairs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = lane % 16, rh = lane / 16;
#pragma unroll
  for (int kk = 0; kk < 16; kk += 4) {
    const int k = warp * 16 + kk;
    const float w0 = Ws[(k + 0) * kNT + col];
    const float w1 = Ws[(k + 1) * kNT + col];
    const float w2 = Ws[(k + 2) * kNT + col];
    const float w3 = Ws[(k + 3) * kNT + col];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i < pairs) {
        const float4 v = *reinterpret_cast<const float4*>(
            As + (rh + 2 * i) * lda + kb + k);
        float t = acc[i / 4][i % 4];
        t = fmaf(v.x, w0, t);
        t = fmaf(v.y, w1, t);
        t = fmaf(v.z, w2, t);
        t = fmaf(v.w, w3, t);
        acc[i / 4][i % 4] = t;
      }
    }
  }
}

// this warp's sums into red[warp][column][row] (rc rows)
__device__ __forceinline__ void stash(const float (&acc)[8][4], float* red,
                                      int rc, bool mma, int pairs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* mine = red + warp * kNT * rc;
  if (mma) {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < 2 * pairs) {
        *reinterpret_cast<float2*>(mine + g * rc + 8 * j + 2 * t) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(mine + (g + 8) * rc + 8 * j + 2 * t) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
  } else {
    const int col = lane % 16, rh = lane / 16;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < pairs) mine[col * rc + rh + 2 * i] = acc[i / 4][i % 4];
  }
}

// The last of `count` arrivals at *counter (a block's partials written
// before): the block's writes ordered before one fenced atomic, the result
// broadcast; the last block's reads after it see every arrival's writes.
__device__ __forceinline__ bool last_arrival(int* counter, int count,
                                             int* s_flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int old = atomicAdd(counter, 1);
    *s_flag = old == count - 1;
    if (*s_flag) __threadfence();
  }
  __syncthreads();
  return *s_flag != 0;
}

// What a GEMM phase multiplies and where its results go.
enum RowKind { kCopy = 0, kLnT = 1, kLnF32 = 2 };
enum EpiKind { kQkv = 0, kOut = 1, kFc1 = 2, kFc2 = 3 };

template <typename T>
struct Phase {
  const T* W;
  const T* bias;
  int K, N;
  bool split;
  int rows;        // RowKind
  const void* src; // rows (R, K): T (copy, kLnT) or fp32 (kLnF32)
  const T *ln_w, *ln_b;
  int epi;         // EpiKind
  int* cnt;        // split phases: counters of the last-arriver sums
};

// The launch-wide pointers an epilogue writes.
template <typename T>
struct Ctx {
  const Args* a;
  float *qbuf, *x1, *gpart;
  T* y;
  int R, budget, kv;
  int* s_flag;
};

// each row's pool token (blk * bs + pos % bs) or -1 where it writes none
__device__ __forceinline__ int pool_token(const Args& a, int r) {
  const Row w = row_of(a, r);
  if (!w.write) return -1;
  return a.block_tables[w.slot * a.mb + w.pos / a.bs] * a.bs + w.pos % a.bs;
}

// the ring's producer: which chunk of which of the block's items goes next
struct Producer {
  int j, c, end, tile, issued;
};

__device__ __forceinline__ void item_of(const GemmGeo& g, int j, int& tile,
                                        int& sp, int& c0, int& c1) {
  const int it = blockIdx.x + j * gridDim.x;
  tile = it % g.tiles;
  sp = it / g.tiles;
  c0 = sp * g.cps;
  c1 = min(g.nch, c0 + g.cps);
}

// Issue the next ring stage (an empty group once the block's chunks are
// all issued, so the groups keep count).
template <typename T>
__device__ __forceinline__ void issue(Producer& p, const GemmGeo& g,
                                      int mine, T* ring, const T* W, int K,
                                      int N) {
  using G = Gemm<T>;
  if (p.j < mine) {
    stage_weights<T>(ring + (p.issued % G::STAGES) * G::KC * kNT, W, K, N,
                     p.c * G::KC, p.tile * kNT);
    if (++p.c == p.end && ++p.j < mine) {
      int sp;
      item_of(g, p.j, p.tile, sp, p.c, p.end);
    }
  }
  ++p.issued;
  cp_async_commit();
}

// A GEMM phase: out[r][c] = sum over k of A[r][k] W[k][c] for the R rows
// and N columns. Items (16-column tile, K split) go to the blocks in turn;
// split items leave fp32 partials and the last to arrive adds them in
// split order. One owner per element, sums in an order set by K and N
// alone. The epilogue adds the bias, then: qkv -> q (fp32), K and V (T,
// and the pool when it is full precision); out -> x1 = x + ...; fc1 -> y =
// gelu(...); fc2 -> x' = x1 + ....
template <typename T>
__device__ __noinline__ void gemm(const Phase<T> ph, const Ctx<T> cx,
                                  unsigned char* smem) {
  using G = Gemm<T>;
  constexpr bool kMma = sizeof(T) == 2;
  const Args& a = *cx.a;
  const int K = ph.K, N = ph.N, R = cx.R;
  const bool ln = ph.rows != kCopy;
  const bool raw = ph.rows == kLnF32 && sizeof(T) == 2;
  const GemmGeo geo = gemm_geo<T>(K, N, ph.split);
  const int items = geo.tiles * geo.splits;
  if (static_cast<int>(blockIdx.x) >= items) return;
  const int mine = (items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int rc = rows_per_chunk<T>(geo.kw, K, R, ln, raw ? 1 : 0, cx.budget);
  // raw rows a batch: up to kRawRows, as many as the budget leaves
  int per = rc;
  if (raw) {
    per = (cx.budget - gemm_smem<T>(geo.kw, K, rc, ln, 0).total) / (K * 4);
    per = max(1, min(per, min(rc, kRawRows)));
  }
  const GemmSmem sm = gemm_smem<T>(geo.kw, K, rc, ln, raw ? per : 0);
  const int lda = geo.kw + G::APAD;
  T* As = reinterpret_cast<T*>(smem + sm.as);
  T* ring = reinterpret_cast<T*>(smem + sm.ring);
  float* red = reinterpret_cast<float*>(smem + sm.red);
  T* lnw = reinterpret_cast<T*>(smem + sm.lnw);
  int* tok = reinterpret_cast<int*>(smem + sm.tok);
  float* rawb = reinterpret_cast<float*>(smem + sm.raw);
  const int tid = threadIdx.x, col = tid % kNT;
  const bool pool_fp = ph.epi == kQkv && cx.kv == 0;
  const int ns = ph.split ? geo.splits : 1;
#pragma unroll 1
  for (int r0 = 0; r0 < R; r0 += rc) {
    const int rows = min(rc, R - r0);
    const int pairs = kMma ? (rows + 15) / 16 : (rows + 1) / 2;
    __syncthreads();  // the previous row chunk's readers are done
    // The rows (and the LN weights; raw LN rows kRawRows at a time) are
    // copied first, the weight ring's first stages right behind them, so
    // the rows do not wait behind the weights; the qkv rows' pool tokens
    // are found meanwhile.
    Producer pr;
    pr.j = 0;
    pr.issued = 0;
    int sp, tile, c0, c1;
    item_of(geo, 0, pr.tile, sp, pr.c, pr.end);
    item_of(geo, 0, tile, sp, c0, c1);
    if (ln) {
      constexpr int E = 16 / sizeof(T);
#pragma unroll 1
      for (int u = tid; u < 2 * (K / E); u += kThreads) {
        const int which = u >= K / E, c = (u - which * (K / E)) * E;
        cp_async16(lnw + which * K + c, (which ? ph.ln_b : ph.ln_w) + c,
                   true);
      }
    }
    if (raw) {
      rows_async(rawb, K, static_cast<const float*>(ph.src), K, r0,
                 min(per, rows), per, 0, K);
    } else if (ph.rows == kLnF32) {  // fp32 rows into fp32 As: in place
      rows_async(reinterpret_cast<float*>(As), lda,
                 static_cast<const float*>(ph.src), K, r0, rows, rc, 0,
                 geo.kw);
    } else {
      rows_async(As, lda, static_cast<const T*>(ph.src), K, r0, rows, rc,
                 c0 * G::KC, geo.kw);
    }
    cp_async_commit();
#pragma unroll 1
    for (int st = 0; st < G::STAGES - 1; ++st)
      issue(pr, geo, mine, ring, ph.W, K, N);
    if (tid < rc)
      tok[tid] = pool_fp && tid < rows ? pool_token(a, r0 + tid) : -1;
    cp_async_wait<G::STAGES - 1>();  // the rows (the oldest group) landed
    __syncthreads();
    if (raw) {
#pragma unroll 1
      for (int first = 0; first < rc; first += per) {
        const int count = min(per, rc - first);
        if (first > 0) {  // a later batch of raw rows
          __syncthreads();
          rows_async(rawb, K, static_cast<const float*>(ph.src), K,
                     r0 + first, max(0, min(count, rows - first)), count, 0,
                     K);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
        ln_rows(static_cast<const float*>(rawb), K, As, lda, first, count,
                rows, K, geo.kw, lnw, a.eps);
      }
    } else if (ln) {
      ln_rows(As, lda, As, lda, 0, rc, rows, K, geo.kw, lnw, a.eps);
    }
    __syncthreads();
    int staged = sp;
    float acc[8][4];
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[e][f] = 0.f;
#pragma unroll 1
    for (int j = 0; j < mine; ++j) {
      item_of(geo, j, tile, sp, c0, c1);
      if (sp != staged) {  // a split phase's next K range (rows copied)
        __syncthreads();
        rows_async(As, lda, static_cast<const T*>(ph.src), K, r0, rows, rc,
                   c0 * G::KC, geo.kw);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        staged = sp;
      }
      // the epilogue's operands, fetched now: pairs (row, column) = (tid /
      // 16 + 16 i, tid % 16)
      const int c = tile * kNT + col;
      const bool col_ok = c < N;
      const uint32_t b_raw = col_ok ? ld_early(ph.bias + c) : 0u;
      uint32_t e0 = 0u, e1 = 0u, e2 = 0u, e3 = 0u;
      if (ph.epi == kOut || ph.epi == kFc2) {
        const int row = tid / kNT;
        const size_t at = static_cast<size_t>(r0 + row) * N + c;
        const T* xs = static_cast<const T*>(a.x);
        if (col_ok && row < rows)
          e0 = ph.epi == kOut ? ld_early(xs + at) : ld_early(cx.x1 + at);
        if (col_ok && row + 16 < rows)
          e1 = ph.epi == kOut ? ld_early(xs + at + 16 * N)
                              : ld_early(cx.x1 + at + 16 * N);
        if (col_ok && row + 32 < rows)
          e2 = ph.epi == kOut ? ld_early(xs + at + 32 * N)
                              : ld_early(cx.x1 + at + 32 * N);
        if (col_ok && row + 48 < rows)
          e3 = ph.epi == kOut ? ld_early(xs + at + 48 * N)
                              : ld_early(cx.x1 + at + 48 * N);
      }
#pragma unroll 1
      for (int ch = c0; ch < c1; ++ch) {
        cp_async_wait<G::STAGES - 2>();  // this chunk has landed
        __syncthreads();                 // ... for all; one slot is free
        const int slot = (pr.issued - (G::STAGES - 1)) % G::STAGES;
        issue(pr, geo, mine, ring, ph.W, K, N);
        stage_products(acc, ring + slot * G::KC * kNT, As, lda,
                       (ch - c0) * G::KC, pairs);
      }
      // the item's sums: warps in order, then (split phases) the splits
      stash(acc, red, rc, kMma, pairs);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[e][f] = 0.f;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = tid / kNT + 16 * i;
        v[i] = 0.f;
        if (row < rows) {
#pragma unroll
          for (int wi = 0; wi < kWarps; ++wi)
            v[i] += red[(wi * kNT + col) * rc + row];
        }
      }
      if (ns > 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = tid / kNT + 16 * i;
          if (col_ok && row < rows)
            cx.gpart[(static_cast<size_t>(sp) * R + r0 + row) * N + c] = v[i];
        }
        if (!last_arrival(ph.cnt + (r0 / rc) * geo.tiles + tile, ns,
                          cx.s_flag))
          continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = tid / kNT + 16 * i;
          v[i] = 0.f;
          if (col_ok && row < rows)
#pragma unroll 1
            for (int s2 = 0; s2 < ns; ++s2)
              v[i] += __ldcg(cx.gpart +
                             (static_cast<size_t>(s2) * R + r0 + row) * N +
                             c);
        }
      }
      const float bv = early_f<T>(b_raw);
      const uint32_t er[4] = {e0, e1, e2, e3};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = tid / kNT + 16 * i;
        if (!col_ok || row >= rows) continue;
        const int r = r0 + row;
        const size_t at = static_cast<size_t>(r) * N + c;
        const float w = v[i] + bv;
        if (ph.epi == kQkv) {
          const int D = a.d, hd = c / (3 * D), rem = c - hd * 3 * D;
          const int which = rem / D, dd = rem - which * D;
          const size_t o = (static_cast<size_t>(r) * a.heads + hd) * D + dd;
          if (which == 0) {
            cx.qbuf[o] = w;
            continue;
          }
          T t;
          apex::from_f(w, &t);
          static_cast<T*>(which == 1 ? a.k_out : a.v_out)[o] = t;
          if (pool_fp && tok[row] >= 0) {
            const long pt = static_cast<long>(hd) * a.pool_blocks * a.bs +
                            tok[row];
            static_cast<T*>(which == 1 ? a.k_pool : a.v_pool)[pt * D + dd] =
                t;
          }
        } else if (ph.epi == kOut) {
          cx.x1[at] = early_f<T>(er[i]) + w;
        } else if (ph.epi == kFc1) {
          apex::from_f(gelu_tanh(w), &cx.y[at]);
        } else {
          apex::from_f(early_f<float>(er[i]) + w,
                       &static_cast<T*>(a.x_out)[at]);
        }
      }
    }
    cp_async_wait<0>();
  }
}

// ---------------------------------------------------------------------------
// the codec of one emitted head vector (vals: d fp32 values of T) into the
// pool; one warp, gsc: d / group floats of shared memory

template <int KV>
__device__ void write_codes(const Args& a, const float* vals, long tok,
                            bool is_k, float* gsc) {
  const int lane = threadIdx.x % 32, D = a.d;
  if constexpr (KV == 1) {
    int8_t* codes = static_cast<int8_t*>(is_k ? a.k_pool : a.v_pool);
    float* scales = static_cast<float*>(is_k ? a.k_scale : a.v_scale);
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(vals[d]));
    amax = apex::warp_max(amax);
    const float s = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
    for (int d = lane; d < D; d += 32) {
      const float c = fminf(fmaxf(rintf(__fdiv_rn(vals[d], s)), -127.f), 127.f);
      codes[tok * D + d] = static_cast<int8_t>(c);
    }
    if (lane == 0) scales[tok] = s;
  } else {
    uint8_t* codes = static_cast<uint8_t*>(is_k ? a.k_pool : a.v_pool);
    __nv_bfloat16* scales =
        static_cast<__nv_bfloat16*>(is_k ? a.k_scale : a.v_scale);
    const int g = a.group, ng = D / g;
    for (int gi = lane; gi < ng; gi += 32) {
      float amax = 0.f;
      for (int e = 0; e < g; ++e) amax = fmaxf(amax, fabsf(vals[gi * g + e]));
      const float s = amax > 0.f ? __fdiv_rn(amax, 7.f) : 1.f;
      const __nv_bfloat16 sb = __float2bfloat16_rn(s);
      scales[tok * ng + gi] = sb;
      gsc[gi] = __bfloat162float(sb);
    }
    __syncwarp();
    for (int i = lane; i < D / 2; i += 32) {
      const int e0 = 2 * i, e1 = 2 * i + 1;
      const float c0 = fminf(
          fmaxf(rintf(__fdiv_rn(vals[e0], gsc[e0 / g])), -7.f), 7.f);
      const float c1 = fminf(
          fmaxf(rintf(__fdiv_rn(vals[e1], gsc[e1 / g])), -7.f), 7.f);
      codes[tok * (D / 2) + i] = static_cast<uint8_t>(
          (static_cast<int>(c0) & 0xF) | ((static_cast<int>(c1) & 0xF) << 4));
    }
  }
}

// the attention walk's K/V ring: deeper than the per-op kernels' two
// stages where the shared memory allows (one block an SM here)
template <int DB>
constexpr int kWalkRing = DB <= 128 ? 4 : 2;

// shared-memory bytes of the attention phase's walk (DB: the head-dim
// bucket, 0 wide); the codec phase's vectors; the fused layer's need
template <typename T, int KV, int DB>
paged::Layout attention_layout(int d, int group) {
  if constexpr (DB == 0) {
    paged::Layout L{};
    L.bytes = paged::kWideSmemBytes;
    return L;
  } else if constexpr (sizeof(T) == 2) {
    // q as two bf16 terms; code rows laid out for DB, scale rows for d
    return paged::make_layout(
        2 * paged::kMaxRows * kStride<DB> * 2, kB * kStride<DB> * 2, kB, KV,
        paged::code_row_bytes(KV, DB),
        KV == 0 ? 0 : paged::scale_row_bytes(KV, d, group), kWalkRing<DB>);
  } else {
    return paged::make_layout(
        paged::kFpRows * DB * 4, paged::kFpTP * (DB + 4) * 4, paged::kFpTP,
        KV, paged::code_row_bytes(KV, DB),
        KV == 0 ? 0 : paged::scale_row_bytes(KV, d, group), kWalkRing<DB>);
  }
}

template <typename T, int KV, int DB>
int smem_need(int hidden, int ffn, int d, int group) {
  using G = Gemm<T>;
  int need = attention_layout<T, KV, DB>(d, group).bytes;
  if (KV != 0) need = std::max(need, kWarps * 2 * d * 4);  // codec vectors
  // the GEMM phases at their fewest rows: qkv and fc1 (LN, K = hidden;
  // fc1's raw fp32 rows in bf16), out (K = hidden) and fc2 (K = ffn) split
  const int k_ln = gemm_geo<T>(hidden, 3 * hidden, false).kw;
  need = std::max(need, gemm_smem<T>(k_ln, hidden, G::RC_MIN, true,
                                     sizeof(T) == 2 ? 1 : 0).total);
  need = std::max(need, gemm_smem<T>(gemm_geo<T>(hidden, hidden, true).kw,
                                     hidden, G::RC_MIN, false, 0).total);
  return std::max(need, gemm_smem<T>(gemm_geo<T>(ffn, hidden, true).kw, ffn,
                                     G::RC_MIN, false, 0).total);
}

// ---------------------------------------------------------------------------
// the kernel

template <typename T, int KV, int DB>
__global__ void __launch_bounds__(kThreads, 1)
    fused_layer_kernel(const Args a, const paged::Layout AL) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_flag;
  cg::grid_group grid = cg::this_grid();
  const int R = a.n * a.q, h = a.hidden, f = a.ffn, H = a.heads, D = a.d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Layout L = scratch_layout(R, h, f, H, D, a.splits, a.q, sizeof(T));
  char* base = static_cast<char*>(a.scratch);
  float* qbuf = reinterpret_cast<float*>(base + L.qbuf);
  int* ctx_len = reinterpret_cast<int*>(base + L.ctx_len);
  T* ctxb = reinterpret_cast<T*>(base + L.ctx);
  float* x1 = reinterpret_cast<float*>(base + L.x1);
  T* y = reinterpret_cast<T*>(base + L.y);
  float* part = reinterpret_cast<float*>(base + L.part);
  int* out_cnt = reinterpret_cast<int*>(base + L.cnt);
  int* fc2_cnt = out_cnt + L.gemm_cnt;
  const int cap = a.mb * a.bs;
  const Ctx<T> cx{&a, qbuf, x1, reinterpret_cast<float*>(base + L.gpart),
                  y, R, a.smem, KV, &s_flag};

  // 1. qkv = LN1(x) @ Wqkv + b: q fp32; K, V in T (and into a
  // full-precision pool). Meanwhile the split GEMMs' counters are zeroed,
  // and the last block writes each row's context.
  for (int i = blockIdx.x * kThreads + tid; i < 2 * L.gemm_cnt + 1;
       i += gridDim.x * kThreads)
    out_cnt[i] = 0;
  if (blockIdx.x == gridDim.x - 1)  // a block with one qkv item at most
    for (int r = tid; r < R; r += kThreads) {
      const Row w = row_of(a, r);
      ctx_len[r] = w.valid ? min(w.pos + 1, cap) : 0;
    }
  {
    const Phase<T> ph{static_cast<const T*>(a.qkv_w),
                      static_cast<const T*>(a.qkv_b), h, 3 * h, false, kLnT,
                      a.x, static_cast<const T*>(a.ln1_w),
                      static_cast<const T*>(a.ln1_b), kQkv, nullptr};
    gemm(ph, cx, smem);
  }
  grid_sync(grid);

  // 1b. int8 / int4 pools: the codec of each valid row's K and V, one warp
  // a (row, head, K | V): it needs the whole head vector
  if constexpr (KV != 0) {
    float* vals = reinterpret_cast<float*>(smem) + warp * 2 * D;
    float* gsc = vals + D;
    for (int item = blockIdx.x * kWarps + warp; item < R * H * 2;
         item += gridDim.x * kWarps) {
      const int r = item / (2 * H), hd = (item / 2) % H;
      const bool is_k = item % 2 == 0;
      const Row w = row_of(a, r);
      if (!w.write) continue;  // uniform in the warp
      const T* src = static_cast<const T*>(is_k ? a.k_out : a.v_out) +
                     (static_cast<size_t>(r) * H + hd) * D;
      for (int dd = lane; dd < D; dd += 32)
        vals[dd] = early_f<T>(ld_early(src + dd));
      __syncwarp();
      const int blk = a.block_tables[w.slot * a.mb + w.pos / a.bs];
      const long tok =
          (static_cast<long>(hd) * a.pool_blocks + blk) * a.bs + w.pos % a.bs;
      write_codes<KV>(a, vals, tok, is_k, gsc);
      __syncwarp();
    }
    grid_sync(grid);
  }

  // 2. attention: the split walk's items, each block in turn
  {
    const paged::Args pa{qbuf, a.k_pool, a.v_pool, a.k_scale, a.v_scale,
                         a.block_tables, ctx_len, ctxb, part, R, H, D,
                         a.pool_blocks, a.bs, a.mb, KV, a.group, a.q,
                         a.splits, a.split_len, a.scale, 1};
    constexpr int kTile = (DB != 0 && sizeof(T) == 2) ? paged::kMaxRows
                        : DB != 0 ? paged::kFpRows : paged::kWideRows;
    const int tiles = (a.q + kTile - 1) / kTile;
    const int items = a.splits * H * a.n * tiles;
    // items from a queue (one atomic a block an item), the last splits
    // first: they are whole splits of the long contexts, or nothing
    int* next = out_cnt + 2 * L.gemm_cnt;
    for (;;) {
      __syncthreads();  // the previous item's readers are done
      if (tid == 0) s_flag = atomicAdd(next, 1);
      __syncthreads();
      const int i = s_flag;
      if (i >= items) break;
      const int per = H * a.n * tiles;
      const uint3 it = make_uint3(a.splits - 1 - i / per, i % H,
                                  (i / H) % (a.n * tiles));
      if constexpr (DB == 0) {
        paged::wide_walk<float, T, KV, kThreads>(pa, it, smem);
      } else if constexpr (sizeof(T) == 2) {
        paged::mma_walk<DB, KV, true, kWalkRing<DB>, T>(pa, AL, it, smem);
      } else {
        paged::fp32_walk<DB, KV, kThreads, kWalkRing<DB>>(pa, AL, it, smem);
      }
    }
  }
  grid_sync(grid);

  // 3. merge the splits in order: ctx in T, one warp a (row, head)
  for (long idx = static_cast<long>(blockIdx.x) * kWarps + warp;
       idx < static_cast<long>(R) * H;
       idx += static_cast<long>(gridDim.x) * kWarps)
    paged::merge_row<T, true>(part, ctx_len, ctxb, R, H, D, a.splits,
                              a.split_len, cap, idx, lane);
  grid_sync(grid);

  // 4. x1 = x + (ctx @ Wout + b), fp32
  {
    const Phase<T> ph{static_cast<const T*>(a.out_w),
                      static_cast<const T*>(a.out_b), h, h, true, kCopy,
                      ctxb, nullptr, nullptr, kOut, out_cnt};
    gemm(ph, cx, smem);
  }
  grid_sync(grid);

  // 5. y = gelu(LN2(x1) @ W1 + b1), cast to T
  {
    const Phase<T> ph{static_cast<const T*>(a.fc1_w),
                      static_cast<const T*>(a.fc1_b), h, f, false, kLnF32,
                      x1, static_cast<const T*>(a.ln2_w),
                      static_cast<const T*>(a.ln2_b), kFc1, nullptr};
    gemm(ph, cx, smem);
  }
  grid_sync(grid);

  // 6. x' = x1 + (y @ W2 + b2), cast to T
  {
    const Phase<T> ph{static_cast<const T*>(a.fc2_w),
                      static_cast<const T*>(a.fc2_b), f, h, true, kCopy, y,
                      nullptr, nullptr, kFc2, fc2_cnt};
    gemm(ph, cx, smem);
  }
}

template <typename T, int KV, int DB>
cudaError_t launch_db(Args a, int device, cudaStream_t stream) {
  auto kern = fused_layer_kernel<T, KV, DB>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  a.smem = std::min(kSmemBudget,
                    optin - static_cast<int>(attr.sharedSizeBytes));
  if (smem_need<T, KV, DB>(a.hidden, a.ffn, a.d, a.group) > a.smem)
    return cudaErrorInvalidValue;
  const paged::Layout AL = attention_layout<T, KV, DB>(a.d, a.group);
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             a.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, a.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  paged::Layout layout = AL;
  void* params[] = {&a, &layout};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(sms),
                                    dim3(kThreads), params, a.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the head-dim bucket of the attention walk: 64, 128, 256, 0 (wide)
inline int head_dim_bucket(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : 0;
}

template <typename T, int KV>
cudaError_t launch_kv(const Args& a, int device, cudaStream_t s) {
  switch (head_dim_bucket(a.d)) {
    case 64: return launch_db<T, KV, 64>(a, device, s);
    case 128: return launch_db<T, KV, 128>(a, device, s);
    case 256: return launch_db<T, KV, 256>(a, device, s);
    default: return launch_db<T, KV, 0>(a, device, s);
  }
}

template <typename T>
cudaError_t launch_t(const Args& a, int kv_mode, int device, cudaStream_t s) {
  switch (kv_mode) {
    case 0: return launch_kv<T, 0>(a, device, s);
    case 1: return launch_kv<T, 1>(a, device, s);
    case 2: return launch_kv<T, 2>(a, device, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int KV>
int need_kv(int hidden, int ffn, int d, int group) {
  switch (head_dim_bucket(d)) {
    case 64: return smem_need<T, KV, 64>(hidden, ffn, d, group);
    case 128: return smem_need<T, KV, 128>(hidden, ffn, d, group);
    case 256: return smem_need<T, KV, 256>(hidden, ffn, d, group);
    default: return smem_need<T, KV, 0>(hidden, ffn, d, group);
  }
}

template <typename T>
int need_t(int hidden, int ffn, int d, int kv_mode, int group) {
  switch (kv_mode) {
    case 0: return need_kv<T, 0>(hidden, ffn, d, group);
    case 1: return need_kv<T, 1>(hidden, ffn, d, group);
    default: return need_kv<T, 2>(hidden, ffn, d, group);
  }
}

}  // namespace

// Bytes of the scratch buffer fused_layer_fwd needs for `rows` fed rows.
// `dtype`: the model type's code (common.cuh: 0 fp32, 1 bf16, 2 fp16).
extern "C" long long fused_layer_scratch_bytes(int rows, int hidden, int ffn,
                                               int heads, int head_dim,
                                               int splits, int q,
                                               int dtype) {
  return static_cast<long long>(scratch_layout(rows, hidden, ffn, heads,
                                               head_dim, splits, q,
                                               dtype == apex::kF32 ? 4 : 2)
                                    .total);
}

// Dynamic shared memory the fused layer needs at this shape, in bytes
// (the launch takes kSmemBudget, less the kernel's static shared memory,
// and refuses a shape whose need is larger).
extern "C" int fused_layer_smem_bytes(int hidden, int head_dim, int ffn,
                                      int kv_mode, int group, int dtype) {
  if (kv_mode < 0 || kv_mode > 2 || head_dim <= 0) return -1;
  int need = -1;
  APEX_TYPE_SWITCH(dtype, T, need = -1,
                   need = need_t<T>(hidden, ffn, head_dim, kv_mode, group));
  return need;
}

// The dynamic shared memory a launch takes at most, in bytes.
extern "C" int fused_layer_smem_budget() { return kSmemBudget; }

// One fused layer on CUDA device `device`, on `stream`. Model type T (the
// code `dtype`: 0 fp32, 1 bf16, 2 fp16) for x, every weight and vector,
// x_out, k_out and v_out. x, x_out: (n * q, hidden); k_out, v_out:
// (n * q, heads, head_dim); weights (hidden, 3 hidden), (hidden, hidden),
// (hidden, ffn), (ffn, hidden) row-major, the qkv columns per-head interleaved; one layer's
// pools as in paged_attention.cu (kv_mode 0: T; 1: int8 + fp32 scales; 2:
// int4 + bf16 group scales), written in place; block_tables (n, max_blocks)
// int32; start, n_valid (null: q each) (n,) int32; active (n,) bool;
// splits x split_len covers max_blocks * block_size (serve/megakernel.py
// `_fused_splits`: split_len a multiple of 64, at most 64 splits);
// scratch: fused_layer_scratch_bytes(n * q, hidden, ffn, heads, head_dim,
// splits, q, dtype) bytes. hidden == heads * head_dim, head_dim % 8 == 0,
// ffn % 8 == 0, fused_layer_smem_bytes within the budget; any n * q; all
// 16-byte aligned.
extern "C" int fused_layer_fwd(
    int device, const void* x, const void* ln1_w, const void* ln1_b,
    const void* qkv_w, const void* qkv_b, const void* out_w,
    const void* out_b, const void* ln2_w, const void* ln2_b,
    const void* fc1_w, const void* fc1_b, const void* fc2_w,
    const void* fc2_b, void* k_pool, void* v_pool, void* k_scale,
    void* v_scale, const void* block_tables, const void* start,
    const void* n_valid, const void* active, void* x_out, void* k_out,
    void* v_out, void* scratch, int n, int q, int hidden, int heads,
    int head_dim, int ffn, int pool_blocks, int block_size, int max_blocks,
    int kv_mode, int group, int splits, int split_len, float scale,
    float eps, int dtype, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n * q == 0) return static_cast<int>(cudaGetLastError());
  if (hidden != heads * head_dim || head_dim % 8 || ffn % 8 || ffn <= 0 ||
      splits <= 0 || splits > paged::kMaxSplits || split_len % kB ||
      static_cast<long>(splits) * split_len <
          static_cast<long>(max_blocks) * block_size)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.ln1_w = ln1_w; a.ln1_b = ln1_b; a.qkv_w = qkv_w; a.qkv_b = qkv_b;
  a.out_w = out_w; a.out_b = out_b; a.ln2_w = ln2_w; a.ln2_b = ln2_b;
  a.fc1_w = fc1_w; a.fc1_b = fc1_b; a.fc2_w = fc2_w; a.fc2_b = fc2_b;
  a.k_pool = k_pool; a.v_pool = v_pool; a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.block_tables = static_cast<const int*>(block_tables);
  a.start = static_cast<const int*>(start);
  a.n_valid = static_cast<const int*>(n_valid);
  a.active = static_cast<const unsigned char*>(active);
  a.x_out = x_out; a.k_out = k_out; a.v_out = v_out; a.scratch = scratch;
  a.n = n; a.q = q; a.hidden = hidden; a.heads = heads; a.d = head_dim;
  a.ffn = ffn; a.pool_blocks = pool_blocks; a.bs = block_size;
  a.mb = max_blocks; a.group = group; a.splits = splits;
  a.split_len = split_len; a.smem = kSmemBudget; a.scale = scale;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  APEX_TYPE_SWITCH(dtype, T, err = cudaErrorInvalidValue,
                   err = launch_t<T>(a, kv_mode, device, s));
  return static_cast<int>(err);
}
