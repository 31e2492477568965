// Fused LM head + softmax cross-entropy, forward, dX and dW, fp32 on the
// CUDA cores, for Hopper (sm_90a). The (rows, vocab) logits never reach
// device memory.
//
// Replaces, for fp32 inputs, the TPU kernels of
// apex_tpu/ops/lm_head_loss.py:
//   * `_fwd_kernel` (reached through `_run_fwd`, pallas_call at :198):
//     per row the log-sum-exp lse of s = x . w^T over the vocab and the
//     target's logit pred;
//   * `_dx_kernel` (`_run_bwd`, pallas_call at :244):
//     dx = sum_v dl . W_v with dl = (exp(s - lse) - onehot) * g;
//   * `_dw_kernel` (`_run_bwd`, pallas_call at :263): dw = sum_n dl^T . X_n.
// bf16 inputs run the tensor-core forward, dX and dW of lm_head_mma.cu; on
// the tensor cores fp32 products would run as TF32, and the fp32 gates
// need fp32 products.
//
// Math, the JAX kernels' formulas: a vocab column past V is masked to
// NEG_INF in the forward and gives dl = 0 in the backward (its W row is
// loaded as zeros); the forward updates a running max m, sum l and target
// logit per vocab tile, lse = m + log(l). Products are fp32; the scores'
// 16-term partials are added in fp64 (ScoreAcc, below), so the fp32 path
// is deliberately more exact than JAX's chain of fp32 FMAs (ROADMAP.md
// section C, "fp32 LM-head sums").
//
// Bound on this card: fp32 operations at 67 TFLOP/s. At the training shape
// (n = 8192 rows, h = 768, V = 50304) the forward does 2.n.V.h = 6.3e11
// flop (9.4 ms) and each backward kernel recomputes the scores and does
// one more product of the same size, 4.n.V.h (18.9 ms); the bytes (x, w,
// dx, dw, a few vectors) are ~0.2 GB, 0.06 ms.
//
// Design: products in fp32 FMAs through a warp-level 16x16x16 fragment
// interface (Mma). Each call sums its 16 products apart and adds that
// partial to the accumulator, so a sum over the hidden or the vocab axis
// is a two-level sum; the scores go further and add the partials in fp64
// (ScoreAcc), so s carries the rounding of one 16-term partial, not of a
// chain of h terms: at h = 2048 a chain of fp32 FMAs left dx's softmax
// term (which cancels) more than the fp32 gate away from an fp64
// evaluation, farther than cuBLAS's fp32 product. The TPU's sequential
// vocab / row grid becomes a loop inside one block, and every output has
// exactly one owner whose sums run in a fixed order: no atomics, results
// repeat bitwise.
//   * forward: a block owns 64 rows and a split of the vocab (enough splits
//     for ~8 blocks an SM), walks it in 64-column tiles keeping m, l and
//     pred in registers (4 lanes per row), and writes them per split; a
//     second launch merges the splits in order (log-sum-exp merge);
//   * dX: a block owns 32 rows and a chunk of at most 512 hidden columns,
//     with its dx accumulator in the warps' fragments, and walks the vocab
//     in 64-column tiles;
//   * dW: a block owns 32 vocab rows and a hidden chunk, and walks the
//     rows in 64-row tiles.
// The scores of a tile come from a product over h whose K chunks stream
// into shared memory with cp.async, two stages deep, so the next chunk
// loads while this one multiplies. They go to shared memory as fp32 for
// the elementwise step, whose dl is the A operand of the second product.
// When a backward block owns the whole hidden axis, the chunks of the
// operand its second product also needs (dX: the w rows, dW: the x rows)
// stream straight into that product's slab, so it is read from global
// memory once per tile. The element type stays a template parameter T
// (float here) of the tile code.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// K chunk of the score product in the forward (KC) and the backward
// (KC_BWD: wider, fewer barriers; the forward keeps its blocks small so
// more fit on an SM), shared-memory row padding (16 bytes), and the widest
// hidden chunk a backward block accumulates
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int KC = 32, KC_BWD = 32, PAD = 4, HCMAX = 512;
};

// Warp-level 16x16x16 products into an fp32 16x16 accumulator, operands in
// shared memory: a_row(a, lda) is A(m, k) = a[m*lda + k], a_col A(m, k) =
// a[k*lda + m], b_row B(k, n) = b[k*ldb + n], b_col B(k, n) = b[n*ldb + k];
// mma(c, A, B) adds A.B to c. A loaded operand may feed several products.
template <typename T>
struct Mma;

// fp32 on the CUDA cores: lane l holds row l / 2, columns (l % 2) * 8 + 0..7
// of the accumulator; an operand is its shared-memory address and layout
// (element (i, j) at p[i*si + j*sj]), read inside mma. Each call sums its
// 16 products apart (fp32 FMAs from 0) and adds that partial to c: into
// fp32 for Acc, into fp64 for ScoreAcc (the scores)
template <>
struct Mma<float> {
  struct Acc {
    float x[8];
  };
  struct ScoreAcc {
    double x[8];
  };
  struct Op {
    const float* p;
    int si, sj;
  };
  template <typename C>
  static __device__ __forceinline__ void zero(C& c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) c.x[j] = 0;
  }
  static __device__ __forceinline__ Op a_row(const float* a, int ld) {
    return {a, ld, 1};
  }
  static __device__ __forceinline__ Op a_col(const float* a, int ld) {
    return {a, 1, ld};
  }
  static __device__ __forceinline__ Op b_row(const float* b, int ld) {
    return {b, ld, 1};
  }
  static __device__ __forceinline__ Op b_col(const float* b, int ld) {
    return {b, 1, ld};
  }
  // c(r, c0 + j) += sum_k A(r, k) B(k, c0 + j), the 16-term sum first
  template <typename C>
  static __device__ __forceinline__ void mma(C& c, const Op& a,
                                             const Op& b) {
    const int r = (threadIdx.x & 31) >> 1, c0 = (threadIdx.x & 1) * 8;
    float part[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) part[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float av = a.p[r * a.si + k * a.sj];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part[j] = fmaf(av, b.p[k * b.si + (c0 + j) * b.sj], part[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) c.x[j] += part[j];
  }
  template <typename C>
  static __device__ __forceinline__ void store(float* out, int ld,
                                               const C& c) {
    const int r = (threadIdx.x & 31) >> 1, c0 = (threadIdx.x & 1) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[r * ld + c0 + j] = static_cast<float>(c.x[j]);
  }
};

__host__ __device__ constexpr size_t round128(size_t bytes) {
  return (bytes + 127) & ~static_cast<size_t>(127);
}

// next `bytes` of the block's dynamic shared memory, 128-byte aligned
template <typename U>
__device__ __forceinline__ U* carve(unsigned char*& at, size_t count) {
  U* p = reinterpret_cast<U*>(at);
  at += round128(count * sizeof(U));
  return p;
}

// dst (rows x cols, row stride ldd) <- rows [row0, row0 + rows) of a matrix
// with row stride lds starting at src; rows at or past `limit` are zeros.
// cols is a multiple of the 16-byte vector; src, lds, ldd keep 16-byte
// alignment.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src,
                                          long lds, int row0, int limit,
                                          int rows, int cols) {
  constexpr int N = apex::Vec<T>::N;
  const int per_row = cols / N;
  for (int u = threadIdx.x; u < rows * per_row; u += kThreads) {
    const int r = u / per_row, c = (u % per_row) * N;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<long>(row0 + r) * lds + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = val;
  }
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte asynchronous copy global -> shared; zero-fills when !pred (no
// bytes are read then, but `src` must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// load_tile, asynchronously (joins the caller's open cp.async group)
template <typename T>
__device__ __forceinline__ void load_tile_async(T* dst, int ldd, const T* src,
                                                long lds, int row0, int limit,
                                                int rows, int cols) {
  constexpr int N = apex::Vec<T>::N;
  const int per_row = cols / N;
  for (int u = threadIdx.x; u < rows * per_row; u += kThreads) {
    const int r = u / per_row, c = (u % per_row) * N;
    const bool in = row0 + r < limit;
    cp_async16(dst + r * ldd + c,
               in ? src + static_cast<long>(row0 + r) * lds + c : src, in);
  }
}

// Where the score product's K chunks of one operand come from: a two-stage
// ring of (rows x LD) buffers (kRing); the matching columns of a (rows x
// ld) tile that the block keeps for its second product, filled as the
// chunks stream in (kSlab); or a (rows x ld) tile the block loaded once and
// keeps for every product (kFixed, nothing streams).
enum OperandMode { kRing, kSlab, kFixed };

template <typename T>
struct Operand {
  T* base;
  int ld;
  OperandMode mode;
  __device__ __forceinline__ T* chunk(int c, int k0, int rows) const {
    return mode == kRing ? base + (c & 1) * rows * ld : base + k0;
  }
};

// wait until at most `pending` (0-3) of the newest cp.async groups are
// still in flight
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// sS (RM x (RV + 4), fp32) <- x[xrow0 .. +RM) . w[wrow0 .. +RV)^T over the
// whole hidden axis, streamed in K chunks through A and B with cp.async:
// one chunk ahead of the product while a ring is in use, three when every
// chunk has a place of its own. Rows of x at or past n and rows of w at or
// past V enter as zeros. Ends with a barrier.
template <typename T, int RM, int RV, int KC>
__device__ __forceinline__ void score_tile(float* sS, Operand<T> A,
                                           Operand<T> B, const T* x,
                                           int xrow0, int n, const T* w,
                                           int wrow0, int V, int h) {
  using M = Mma<T>;
  constexpr int LDS = RV + 4;
  constexpr int FV = RV / 16, NF = (RM / 16) * FV;
  constexpr int PER = (NF + kWarps - 1) / kWarps;
  const int warp = threadIdx.x / 32;
  const int nch = h / KC;  // h is a multiple of 128
  typename M::ScoreAcc acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) M::zero(acc[i]);
  auto issue = [&](int c) {
    const int k0 = c * KC;
    if (A.mode != kFixed)
      load_tile_async<T>(A.chunk(c, k0, RM), A.ld, x + k0, h, xrow0, n, RM,
                         KC);
    if (B.mode != kFixed)
      load_tile_async<T>(B.chunk(c, k0, RV), B.ld, w + k0, h, wrow0, V, RV,
                         KC);
    cp_async_commit();
  };
  const int look = (A.mode == kRing || B.mode == kRing) ? 1 : 3;
  __syncthreads();  // readers of the ring, the slabs and sS are done
  int issued = 0;
  for (; issued < look && issued < nch; ++issued) issue(issued);
  for (int c = 0; c < nch; ++c) {
    if (c > 0) __syncthreads();  // readers of chunk c - 1's stage are done
    if (issued < nch) issue(issued++);
    cp_async_wait_pending(issued - c - 1);
    __syncthreads();  // chunk c has landed for every thread
    const T* a = A.chunk(c, c * KC, RM);
    const T* b = B.chunk(c, c * KC, RV);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int f = warp + kWarps * i;
      if (f < NF) {
        const int fm = f / FV, fv = f % FV;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16)
          M::mma(acc[i], M::a_row(a + fm * 16 * A.ld + kk, A.ld),
                 M::b_col(b + fv * 16 * B.ld + kk, B.ld));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int f = warp + kWarps * i;
    if (f < NF) {
      const int fm = f / FV, fv = f % FV;
      M::store(sS + fm * 16 * LDS + fv * 16, LDS, acc[i]);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward: lse and pred per row, in vocab splits combined in order

constexpr int kFwdRows = 64, kFwdVocab = 64;
constexpr int kFwdTargetBlocks = 1056;  // 8 blocks on each of 132 SMs
constexpr int kFwdMaxSplits = 16;

// Vocab splits of the forward: a function of the shape alone, so the
// in-order combine repeats bitwise.
int fwd_splits(int n, int v) {
  const int row_blocks = (n + kFwdRows - 1) / kFwdRows;
  const int tiles = (v + kFwdVocab - 1) / kFwdVocab;
  int splits = (kFwdTargetBlocks + row_blocks - 1) / row_blocks;
  if (splits > kFwdMaxSplits) splits = kFwdMaxSplits;
  if (splits > tiles) splits = tiles;
  return splits < 1 ? 1 : splits;
}

template <typename T>
size_t fwd_smem() {
  constexpr int LD = Tile<T>::KC + Tile<T>::PAD;
  return round128(2 * kFwdRows * LD * sizeof(T)) +
         round128(2 * kFwdVocab * LD * sizeof(T)) +
         round128(kFwdRows * (kFwdVocab + 4) * sizeof(float));
}

// Block (row tile, split): the running max m, sum l and target score p of
// its rows over the split's vocab tiles, written to part[(k * splits +
// split) * n + row] for k = m, l, p.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const long long* __restrict__ t, float* __restrict__ part,
                  int n, int V, int h) {
  constexpr int RM = kFwdRows, RV = kFwdVocab;
  constexpr int LD = Tile<T>::KC + Tile<T>::PAD, LDS = RV + 4;
  constexpr int TPR = kThreads / RM, CPT = RV / TPR;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  const Operand<T> A{carve<T>(at, 2 * RM * LD), LD, kRing};
  const Operand<T> B{carve<T>(at, 2 * RV * LD), LD, kRing};
  float* sS = carve<float>(at, RM * LDS);

  const int row0 = blockIdx.x * RM;
  const int splits = gridDim.y, split = blockIdx.y;
  const int tiles = (V + RV - 1) / RV, per = (tiles + splits - 1) / splits;
  const int t_end = min(tiles, (split + 1) * per);
  const int r = threadIdx.x / TPR, q = threadIdx.x % TPR;
  const int row = row0 + r;
  const long long tgt = row < n ? t[row] : -1;
  float m = apex::kNegInf, l = 0.f, p = 0.f;
  for (int tile = split * per; tile < t_end; ++tile) {
    const int v0 = tile * RV;
    score_tile<T, RM, RV, Tile<T>::KC>(sS, A, B, x, row0, n, w, v0, V, h);
    float s[CPT];
    float cmax = apex::kNegInf;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = q * CPT + j, col = v0 + c;
      float sv = sS[r * LDS + c];
      if (col >= V) sv = apex::kNegInf;
      if (col == tgt) p += sv;
      s[j] = sv;
      cmax = fmaxf(cmax, sv);
    }
    const float m_new = fmaxf(m, group_max<TPR>(cmax));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) sum += expf(s[j] - m_new);
    l = l * expf(m - m_new) + group_sum<TPR>(sum);
    m = m_new;
  }
  p = group_sum<TPR>(p);
  if (q == 0 && row < n) {
    part[(0 * splits + split) * static_cast<long>(n) + row] = m;
    part[(1 * splits + split) * static_cast<long>(n) + row] = l;
    part[(2 * splits + split) * static_cast<long>(n) + row] = p;
  }
}

// lse = M + log(sum_s l_s exp(m_s - M)), M = max_s m_s; pred = sum_s p_s;
// the splits in order
__global__ void __launch_bounds__(kThreads)
    lm_fwd_combine_kernel(const float* __restrict__ part,
                          float* __restrict__ lse, float* __restrict__ pred,
                          int n, int splits) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  float big = apex::kNegInf;
  for (int k = 0; k < splits; ++k)
    big = fmaxf(big, part[static_cast<long>(k) * n + row]);
  float l = 0.f, p = 0.f;
  for (int k = 0; k < splits; ++k) {
    l += part[static_cast<long>(splits + k) * n + row] *
         expf(part[static_cast<long>(k) * n + row] - big);
    p += part[static_cast<long>(2 * splits + k) * n + row];
  }
  lse[row] = big + logf(l);
  pred[row] = p;
}

// ---------------------------------------------------------------------------
// backward: dX and dW

constexpr int kDxRows = 32, kDxVocab = 64;  // dX: rows owned, vocab tile
constexpr int kDwRows = 64, kDwVocab = 32;  // dW: row tile, vocab owned

// shared memory of a backward block: the score product's operands (when
// the block owns the whole hidden axis, its fixed tile of `fixed_rows` x h;
// otherwise rings for the x rows and the w rows), the scores, dl, the slab
// of its second product, the warps' staging tiles
template <typename T>
size_t bwd_smem(int rows, int vocab, int slab_rows, int fixed_rows, int hc,
                int h) {
  constexpr int LD = Tile<T>::KC_BWD + Tile<T>::PAD, PAD = Tile<T>::PAD;
  const size_t operands =
      hc == h ? static_cast<size_t>(fixed_rows) * (h + PAD) * sizeof(T)
              : (2 * rows * LD + 2 * vocab * LD) * sizeof(T);
  return round128(operands) +
         round128(rows * (vocab + 4) * sizeof(float)) +
         round128(rows * (vocab + PAD) * sizeof(T)) +
         round128(static_cast<size_t>(slab_rows) * (hc + PAD) * sizeof(T)) +
         round128(kWarps * 256 * sizeof(float));
}

// Write a warp's 16x16 accumulator tile to out (row stride ld) through its
// fp32 staging tile; rows at or past `limit` (counted from `row0`) are
// skipped.
template <typename T, typename Acc>
__device__ __forceinline__ void store_acc(T* out, long ld, int row0,
                                          int limit, const Acc& acc,
                                          float* stage) {
  Mma<T>::store(stage, 16, acc);
  __syncwarp();
  const int lane = threadIdx.x & 31, rr = lane >> 1, cc = (lane & 1) * 8;
  if (row0 + rr < limit) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      apex::from_f(stage[rr * 16 + cc + e],
                   out + static_cast<long>(row0 + rr) * ld + cc + e);
  }
  __syncwarp();
}

// dX block: 32 rows x one hidden chunk. When the chunk is the whole hidden
// axis, the score product streams each vocab tile's w rows straight into
// the (64 x h) slab that the dx product then reads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lm_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const long long* __restrict__ t,
                 const float* __restrict__ lse, const float* __restrict__ g,
                 T* __restrict__ dx, int n, int V, int h, int hc) {
  using M = Mma<T>;
  constexpr int RM = kDxRows, RV = kDxVocab;
  constexpr int KC = Tile<T>::KC_BWD, LD = KC + Tile<T>::PAD, LDS = RV + 4;
  constexpr int LDL = RV + Tile<T>::PAD, MAXC = Tile<T>::HCMAX / 128;
  constexpr int TPR = kThreads / RM, CPT = RV / TPR;
  const int LDW = hc + Tile<T>::PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  // whole hidden axis: the 32 x rows stay resident (fixed) and each vocab
  // tile's w rows stream into the slab; else two rings and a slab load
  const bool whole = hc == h;
  T* ops = carve<T>(at, whole ? RM * (h + Tile<T>::PAD)
                              : 2 * RM * LD + 2 * RV * LD);
  float* sS = carve<float>(at, RM * LDS);
  T* sL = carve<T>(at, RM * LDL);
  T* sW = carve<T>(at, static_cast<size_t>(RV) * LDW);
  float* stage = carve<float>(at, kWarps * 256);
  const Operand<T> A = whole
                           ? Operand<T>{ops, h + Tile<T>::PAD, kFixed}
                           : Operand<T>{ops, LD, kRing};
  const Operand<T> B = whole ? Operand<T>{sW, LDW, kSlab}
                             : Operand<T>{ops + 2 * RM * LD, LD, kRing};

  const int warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * RM, hc0 = blockIdx.y * hc, cnt = hc / 128;
  const int r = threadIdx.x / TPR, q = threadIdx.x % TPR;
  const int row = row0 + r;
  const bool valid = row < n;
  const long long tgt = valid ? t[row] : -1;
  const float lse_r = valid ? lse[row] : 0.f;
  const float g_r = valid ? g[row] : 0.f;

  if (whole) load_tile<T>(ops, h + Tile<T>::PAD, x, h, row0, n, RM, h);
  typename M::Acc acc[2][MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    M::zero(acc[0][j]);
    M::zero(acc[1][j]);
  }
  for (int v0 = 0; v0 < V; v0 += RV) {
    score_tile<T, RM, RV, KC>(sS, A, B, x, row0, n, w, v0, V, h);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = q * CPT + j, col = v0 + c;
      const float pv = col < V ? expf(sS[r * LDS + c] - lse_r) : 0.f;
      const float hit = col == tgt ? 1.f : 0.f;
      apex::from_f((pv - hit) * g_r, sL + r * LDL + c);
    }
    if (!whole) load_tile<T>(sW, LDW, w + hc0, h, v0, V, RV, hc);
    __syncthreads();
    // dx += dl . W_tile: each loaded dl and W operand feeds two products
#pragma unroll
    for (int kk = 0; kk < RV; kk += 16) {
      const auto a0 = M::a_row(sL + kk, LDL);
      const auto a1 = M::a_row(sL + 16 * LDL + kk, LDL);
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        if (j < cnt) {
          const auto b = M::b_row(sW + kk * LDW + (warp + kWarps * j) * 16,
                                  LDW);
          M::mma(acc[0][j], a0, b);
          M::mma(acc[1][j], a1, b);
        }
      }
    }
  }
  float* st = stage + warp * 256;
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    if (j < cnt) {
      const int ct = warp + kWarps * j;
#pragma unroll
      for (int fm = 0; fm < 2; ++fm)
        store_acc<T>(dx + hc0 + ct * 16, h, row0 + fm * 16, n, acc[fm][j],
                     st);
    }
  }
}

// dW block: 32 vocab rows x one hidden chunk. When the chunk is the whole
// hidden axis, the score product streams each row tile's x rows straight
// into the (64 x h) slab that the dw product then reads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lm_dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const long long* __restrict__ t,
                 const float* __restrict__ lse, const float* __restrict__ g,
                 T* __restrict__ dw, int n, int V, int h, int hc) {
  using M = Mma<T>;
  constexpr int RN = kDwRows, RV = kDwVocab;
  constexpr int KC = Tile<T>::KC_BWD, LD = KC + Tile<T>::PAD, LDS = RV + 4;
  constexpr int LDL = RV + Tile<T>::PAD, MAXC = Tile<T>::HCMAX / 128;
  constexpr int TPR = kThreads / RN, CPT = RV / TPR;
  const int LDX = hc + Tile<T>::PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* at = smem;
  // whole hidden axis: the 32 w rows stay resident (fixed) and each row
  // tile's x rows stream into the slab; else two rings and a slab load
  const bool whole = hc == h;
  T* ops = carve<T>(at, whole ? RV * (h + Tile<T>::PAD)
                              : 2 * RN * LD + 2 * RV * LD);
  float* sS = carve<float>(at, RN * LDS);
  T* sL = carve<T>(at, RN * LDL);
  T* sX = carve<T>(at, static_cast<size_t>(RN) * LDX);
  float* stage = carve<float>(at, kWarps * 256);
  const Operand<T> A = whole ? Operand<T>{sX, LDX, kSlab}
                             : Operand<T>{ops, LD, kRing};
  const Operand<T> B = whole
                           ? Operand<T>{ops, h + Tile<T>::PAD, kFixed}
                           : Operand<T>{ops + 2 * RN * LD, LD, kRing};

  const int warp = threadIdx.x / 32;
  const int v0 = blockIdx.x * RV, hc0 = blockIdx.y * hc, cnt = hc / 128;
  const int r = threadIdx.x / TPR, q = threadIdx.x % TPR;

  if (whole) load_tile<T>(ops, h + Tile<T>::PAD, w, h, v0, V, RV, h);
  typename M::Acc acc[2][MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    M::zero(acc[0][j]);
    M::zero(acc[1][j]);
  }
  for (int r0 = 0; r0 < n; r0 += RN) {
    score_tile<T, RN, RV, KC>(sS, A, B, x, r0, n, w, v0, V, h);
    const int row = r0 + r;
    const bool valid = row < n;
    const long long tgt = valid ? t[row] : -1;
    const float lse_r = valid ? lse[row] : 0.f;
    const float g_r = valid ? g[row] : 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = q * CPT + j, col = v0 + c;
      const float pv = col < V ? expf(sS[r * LDS + c] - lse_r) : 0.f;
      const float hit = col == tgt ? 1.f : 0.f;
      apex::from_f((pv - hit) * g_r, sL + r * LDL + c);
    }
    if (!whole) load_tile<T>(sX, LDX, x + hc0, h, r0, n, RN, hc);
    __syncthreads();
    // dw += dl^T . X_tile: each loaded dl and X operand feeds two products
#pragma unroll
    for (int kk = 0; kk < RN; kk += 16) {
      const auto a0 = M::a_col(sL + kk * LDL, LDL);
      const auto a1 = M::a_col(sL + kk * LDL + 16, LDL);
#pragma unroll
      for (int j = 0; j < MAXC; ++j) {
        if (j < cnt) {
          const auto b = M::b_row(sX + kk * LDX + (warp + kWarps * j) * 16,
                                  LDX);
          M::mma(acc[0][j], a0, b);
          M::mma(acc[1][j], a1, b);
        }
      }
    }
  }
  float* st = stage + warp * 256;
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    if (j < cnt) {
      const int ct = warp + kWarps * j;
#pragma unroll
      for (int fm = 0; fm < 2; ++fm)
        store_acc<T>(dw + hc0 + ct * 16, h, v0 + fm * 16, V, acc[fm][j], st);
    }
  }
}

// Hidden columns a backward block owns: the widest h / k, k dividing h /
// 128, that is at most HCMAX.
int hidden_chunk(int h, int hcmax) {
  const int p = h / 128;
  for (int k = 1; k <= p; ++k)
    if (p % k == 0 && (p / k) * 128 <= hcmax) return h / k;
  return 128;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const void* t,
                       void* part, void* lse, void* pred, int n, int v,
                       int h, cudaStream_t s) {
  const size_t bytes = fwd_smem<T>();
  cudaError_t e = cudaFuncSetAttribute(
      lm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const int splits = fwd_splits(n, v);
  lm_fwd_kernel<T><<<dim3((n + kFwdRows - 1) / kFwdRows, splits), kThreads,
                     bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const long long*>(t), static_cast<float*>(part), n, v, h);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lm_fwd_combine_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(lse),
      static_cast<float*>(pred), n, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(const void* x, const void* w, const void* t,
                      const void* lse, const void* g, void* dx, int n, int v,
                      int h, cudaStream_t s) {
  const int hc = hidden_chunk(h, Tile<T>::HCMAX);
  const size_t bytes =
      bwd_smem<T>(kDxRows, kDxVocab, kDxVocab, kDxRows, hc, h);
  cudaError_t e = cudaFuncSetAttribute(
      lm_dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((n + kDxRows - 1) / kDxRows, h / hc);
  lm_dx_kernel<T><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const long long*>(t), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<T*>(dx), n, v, h, hc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* w, const void* t,
                      const void* lse, const void* g, void* dw, int n, int v,
                      int h, cudaStream_t s) {
  const int hc = hidden_chunk(h, Tile<T>::HCMAX);
  const size_t bytes =
      bwd_smem<T>(kDwRows, kDwVocab, kDwRows, kDwVocab, hc, h);
  cudaError_t e = cudaFuncSetAttribute(
      lm_dw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((v + kDwVocab - 1) / kDwVocab, h / hc);
  lm_dw_kernel<T><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const long long*>(t), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<T*>(dw), n, v, h, hc);
  return cudaGetLastError();
}

}  // namespace

// Vocab splits of the forward at (n, v): its scratch `part` holds 3 *
// splits * n floats.
extern "C" int lm_head_loss_fwd_splits(int n, int v) {
  return fwd_splits(n, v);
}

// On CUDA device `device`, on `stream`. x: (n, h), w: (V, h), one type
// (is_bf16 ? bf16 : fp32), contiguous, 16-byte aligned, h a multiple of
// 128; t: (n,) int64 target ids (any value: an id outside [0, V) picks no
// logit); lse, pred, g: (n,) fp32. Forward writes lse and pred (through
// `part`, see lm_head_loss_fwd_splits); dX writes dx (n, h) and dW writes
// dw (V, h), both fp32 (bf16 inputs: cudaErrorInvalidValue; their
// forward, dX and dW are lm_head_mma.cu's).
extern "C" int lm_head_loss_fwd(int device, const void* x, const void* w,
                                const void* t, void* part, void* lse,
                                void* pred, int n, int v, int h, int is_bf16,
                                void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? cudaErrorInvalidValue
              : launch_fwd<float>(x, w, t, part, lse, pred, n, v, h, s));
}

extern "C" int lm_head_loss_bwd_dx(int device, const void* x, const void* w,
                                   const void* t, const void* lse,
                                   const void* g, void* dx, int n, int v,
                                   int h, int is_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? cudaErrorInvalidValue
              : launch_dx<float>(x, w, t, lse, g, dx, n, v, h, s));
}

extern "C" int lm_head_loss_bwd_dw(int device, const void* x, const void* w,
                                   const void* t, const void* lse,
                                   const void* g, void* dw, int n, int v,
                                   int h, int is_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? cudaErrorInvalidValue
              : launch_dw<float>(x, w, t, lse, g, dw, n, v, h, s));
}
