// One fused GPT decode/verify layer for Hopper (sm_90a): the megakernel.
//
// Replaces the TPU kernel apex_tpu/serve/megakernel.py
// `_fused_block_kernel` (reached through `_fused_block`, pallas_call at
// megakernel.py:668). Per fed row (n slots x q rows, R = n * q):
//   1. LN1 in fp32 (E[x^2] - E[x]^2 clamped at 0, eps), h1 cast to T;
//   2. qkv = h1 @ Wqkv with fp32 accumulation + fp32 bias, kept fp32: q is
//      never rounded to T; K and V are emitted in T (per-head interleaved
//      columns, head-major (H, 3, D));
//   3. each valid fed row writes its K/V into the paged pool at
//      (block_tables[slot, pos / bs], pos % bs): T as is, or through the
//      comm.quantize codec (int8: absmax/127 per head vector; int4:
//      absmax/7 per group, the scale rounded to bf16 first, nibble pairs);
//   4. attention over pool positions 0..pos with paged_attend.cuh's
//      block walk (one block per row and head); ctx cast to T;
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
// positions in the same blocks for a verify row as for the decode of that
// token, and takes the eager scatter and codec ops off every layer.
//
// Bound on this card: device memory at serving row counts. One launch
// reads the layer's weights and vectors once ((3h^2 + hd*h + 2*h*f +
// 9h + f) * sizeof(T)), the pool positions it attends (sum over rows of
// ceil(ctx / bs) * bs * H * D * 2 * elem_bytes) and writes the fed rows'
// K/V and x' (2 * R * h * sizeof(T) for x in and out); over 3.35 TB/s.
//
// Design (simple first; wgmma and TMA are later work):
// * One launch per layer, a cooperative grid of all co-resident blocks
//   (occupancy API, at most kMaxBlocksPerSm per SM); phases separated by
//   cooperative_groups grid syncs.
// * Weights are read once per launch: each GEMM's output columns are cut
//   into tiles of kNC columns and its K axis into fixed splits of
//   splits_for(K) chunks; a block owns a (tile, split) item and serves all
//   R rows from shared memory (K chunks of kKC, the next chunk loaded into
//   registers while the current one is multiplied).
// * One owner per output element, sums in a fixed order: a split sums its
//   k in increasing order with fp32 FMAs; a later phase adds the splits in
//   order. Split boundaries depend on K alone, not on R or the grid, so
//   two launches are bitwise equal and a row's result does not depend on
//   the rows beside it: a verify row (q = k + 1) gives the bits the decode
//   of that token (q = 1) gives.
// * Data written earlier in the launch by other blocks (scratch, pools) is
//   read with ld.global.cg: L1 is not coherent across SMs.

#include <cooperative_groups.h>

#include "paged_attend.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 128;  // fed rows (n * q) per launch
constexpr int kKC = 32;        // K chunk of a GEMM item
constexpr int kNC = 32;        // output columns of a GEMM tile
constexpr int kRowLanes = kThreads / kNC;
constexpr int kMaxAcc = kMaxRows / kRowLanes;
constexpr int kSplitTarget = 256;  // K per split, about
constexpr int kMaxBlocksPerSm = 2;

__host__ __device__ inline int splits_for(int k) {
  int s = (k + kSplitTarget - 1) / kSplitTarget;
  while (k % (s * kKC)) ++s;  // k % kKC == 0, so s = k / kKC ends it
  return s;
}

__host__ __device__ inline size_t align256(size_t b) {
  return (b + 255) / 256 * 256;
}

// Byte offsets of the scratch buffers in one allocation.
struct Layout {
  size_t h1, qbuf, ctx, x1, h2, y, part, total;
};

__host__ __device__ inline Layout layout(int rows, int h, int f, int esz) {
  const size_t r = rows;
  Layout L;
  size_t o = 0;
  L.h1 = o;    o += align256(r * h * esz);
  L.qbuf = o;  o += align256(r * h * 4);
  L.ctx = o;   o += align256(r * h * esz);
  L.x1 = o;    o += align256(r * h * 4);
  L.h2 = o;    o += align256(r * h * esz);
  L.y = o;     o += align256(r * f * esz);
  size_t part = static_cast<size_t>(splits_for(h)) * 3 * h;
  const size_t fc1 = static_cast<size_t>(splits_for(h)) * f;
  const size_t fc2 = static_cast<size_t>(splits_for(f)) * h;
  part = part > fc1 ? part : fc1;
  part = part > fc2 ? part : fc2;
  L.part = o;  o += align256(part * r * 4);
  L.total = o;
  return L;
}

// Dynamic shared memory (floats): the largest phase.
__host__ __device__ inline int smem_floats(int h, int head_dim, int attend) {
  int n = kMaxRows * (kKC + 1) + kKC * kNC;            // GEMM chunks
  n = n > attend + head_dim ? n : attend + head_dim;   // attention + q
  n = n > kWarps * (head_dim + head_dim / 2) ? n
                                             : kWarps * (head_dim + head_dim / 2);
  n = n > h + kWarps ? n : h + kWarps;                 // one LN row
  return n;
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
  int n, q, hidden, heads, ffn, pool_blocks, bs, mb, group;
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

// LayerNorm of one row of `h` values (fp32 in `row`, shared memory) into
// `out` (T): fp32 statistics, E[x^2] - E[x]^2 clamped at 0, as
// layer_norm.cu and the JAX reference compute them.
template <typename T>
__device__ void ln_row(const float* row, const T* w, const T* b, T* out,
                       int h, float eps, float* red) {
  float s = 0.f, ss = 0.f;
  for (int c = threadIdx.x; c < h; c += kThreads) {
    s += row[c];
    ss += row[c] * row[c];
  }
  s = apex::block_sum<kWarps>(s, red);
  ss = apex::block_sum<kWarps>(ss, red);
  const float mean = s / h;
  const float var = fmaxf(ss / h - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < h; c += kThreads)
    apex::from_f((row[c] - mean) * rstd * apex::to_f(w[c]) +
                     apex::to_f(b[c]),
                 &out[c]);
}

// 16-byte vectors of one GEMM chunk: A rows (kKC wide), W rows (kNC wide)
template <typename T>
struct Chunk {
  static constexpr int V = apex::Vec<T>::N;  // elements per vector
  static constexpr int AV = kKC / V;         // vectors per A chunk row
  static constexpr int WV = kNC / V;         // vectors per W chunk row
  static constexpr int kAVT = kMaxRows * AV / kThreads;
  static constexpr int kWVT = (kKC * WV + kThreads - 1) / kThreads;
  static_assert(kMaxRows * AV % kThreads == 0, "A chunk split");
};

// Load the chunk at k0 (A rows 0..R-1, W columns c0..c0+kNC-1) into
// registers: A through L2 (written in this launch), W as a weight.
template <typename T>
__device__ __forceinline__ void fetch_chunk(const T* A, const T* W, int K,
                                            int N, int R, int k0, int c0,
                                            uint4 (&ar)[Chunk<T>::kAVT],
                                            uint4 (&wr)[Chunk<T>::kWVT]) {
  using C = Chunk<T>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < C::kAVT; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / C::AV, v = idx % C::AV;
    if (r < R) ar[i] = apex::ld16<true>(A + (size_t)r * K + k0 + v * C::V);
  }
#pragma unroll
  for (int i = 0; i < C::kWVT; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < kKC * C::WV) {
      const int kk = idx / C::WV, v = idx % C::WV;
      wr[i] = apex::ld16<false>(W + (size_t)(k0 + kk) * N + c0 + v * C::V);
    }
  }
}

// part[s][r][c] = sum over k of split s, in increasing k, of A[r][k] *
// W[k][c] (fp32 FMAs). A (R, K) was written in this launch; W (K, N) is a
// weight. Items are (column tile, split).
template <typename T>
__device__ void gemm_partials(const T* A, const T* W, int K, int N, int R,
                              float* part, float* smem) {
  constexpr int V = Chunk<T>::V, AV = Chunk<T>::AV, WV = Chunk<T>::WV;
  constexpr int kAVT = Chunk<T>::kAVT, kWVT = Chunk<T>::kWVT;
  float* As = smem;                          // [kMaxRows][kKC + 1]
  float* Ws = smem + kMaxRows * (kKC + 1);   // [kKC][kNC]
  const int ns = splits_for(K), ks = K / ns, chunks = ks / kKC;
  const int tiles = N / kNC, items = tiles * ns;
  const int tid = threadIdx.x, cl = tid % kNC, rl = tid / kNC;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int c0 = (it % tiles) * kNC, split = it / tiles;
    const int k_begin = split * ks;
    float acc[kMaxAcc];
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
    uint4 ar[kAVT], wr[kWVT];
    fetch_chunk<T>(A, W, K, N, R, k_begin, c0, ar, wr);
    for (int ch = 0; ch < chunks; ++ch) {
      __syncthreads();  // the previous chunk fully consumed
#pragma unroll
      for (int i = 0; i < kAVT; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / AV, v = idx % AV;
        if (r < R) {
          const T* e = reinterpret_cast<const T*>(&ar[i]);
#pragma unroll
          for (int j = 0; j < V; ++j)
            As[r * (kKC + 1) + v * V + j] = apex::to_f(e[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kWVT; ++i) {
        const int idx = tid + i * kThreads;
        if (idx < kKC * WV) {
          const int kk = idx / WV, v = idx % WV;
          const T* e = reinterpret_cast<const T*>(&wr[i]);
#pragma unroll
          for (int j = 0; j < V; ++j)
            Ws[kk * kNC + v * V + j] = apex::to_f(e[j]);
        }
      }
      __syncthreads();
      // the next chunk's loads fly while this one is multiplied
      if (ch + 1 < chunks)
        fetch_chunk<T>(A, W, K, N, R, k_begin + (ch + 1) * kKC, c0, ar, wr);
#pragma unroll 4
      for (int kk = 0; kk < kKC; ++kk) {
        const float w = Ws[kk * kNC + cl];
#pragma unroll
        for (int j = 0; j < kMaxAcc; ++j) {
          if (j * kRowLanes >= R) break;  // uniform: rows past R idle
          const int r = rl + j * kRowLanes;
          if (r < R) acc[j] = fmaf(As[r * (kKC + 1) + kk], w, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int r = rl + j * kRowLanes;
      if (r < R) part[((size_t)split * R + r) * N + c0 + cl] = acc[j];
    }
  }
}

// sum of the splits of output (r, c), in split order
__device__ __forceinline__ float split_sum(const float* part, int splits,
                                           int R, int N, int r, int c) {
  float s = 0.f;
  for (int i = 0; i < splits; ++i)
    s += __ldcg(part + ((size_t)i * R + r) * N + c);
  return s;
}

template <int KV, int D, typename T>
__device__ void write_pool(const Args& a, const float* vals, long tok,
                           bool is_k, float* gsc) {
  const int lane = threadIdx.x % 32;
  if constexpr (KV == 0) {
    T* pool = static_cast<T*>(is_k ? a.k_pool : a.v_pool);
    for (int d = lane; d < D; d += 32) apex::from_f(vals[d], &pool[tok * D + d]);
  } else if constexpr (KV == 1) {
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

template <int KV, bool kCg>
struct Reader;
template <bool kCg>
struct Reader<1, kCg> {
  using Pool = apex::Int8Pool<kCg>;
  static __device__ Pool make(void* codes, void* scales, int) {
    return Pool{static_cast<const int8_t*>(codes),
                static_cast<const float*>(scales)};
  }
};
template <bool kCg>
struct Reader<2, kCg> {
  using Pool = apex::Int4Pool<kCg>;
  static __device__ Pool make(void* codes, void* scales, int group) {
    return Pool{static_cast<const uint8_t*>(codes),
                static_cast<const __nv_bfloat16*>(scales), group};
  }
};

template <typename T, int KV, int D>
struct PoolOf {
  using R = Reader<KV, true>;
  using Pool = typename R::Pool;
  static __device__ Pool make(void* codes, void* scales, int group) {
    return R::make(codes, scales, group);
  }
};
template <typename T, int D>
struct PoolOf<T, 0, D> {
  using Pool = apex::FpPool<T, true>;
  static __device__ Pool make(void* data, void*, int) {
    return Pool{static_cast<const T*>(data)};
  }
};

__device__ __forceinline__ float gelu_tanh(float v) {
  const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  return 0.5f * v * (1.f + tanhf(inner));
}

template <typename T, int KV, int D>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
    fused_layer_kernel(const Args a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int R = a.n * a.q, h = a.hidden, f = a.ffn, H = a.heads;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Layout L = layout(R, h, f, sizeof(T));
  char* base = static_cast<char*>(a.scratch);
  T* h1 = reinterpret_cast<T*>(base + L.h1);
  float* qbuf = reinterpret_cast<float*>(base + L.qbuf);
  T* ctxb = reinterpret_cast<T*>(base + L.ctx);
  float* x1 = reinterpret_cast<float*>(base + L.x1);
  T* h2 = reinterpret_cast<T*>(base + L.h2);
  T* y = reinterpret_cast<T*>(base + L.y);
  float* part = reinterpret_cast<float*>(base + L.part);
  const T* x = static_cast<const T*>(a.x);
  T* x_out = static_cast<T*>(a.x_out);
  float* red = smem + h;  // after one LN row

  // 1. LN1, one block per row
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    __syncthreads();
    for (int c = tid; c < h; c += kThreads) smem[c] = apex::to_f(x[(size_t)r * h + c]);
    __syncthreads();
    ln_row(smem, static_cast<const T*>(a.ln1_w),
           static_cast<const T*>(a.ln1_b), h1 + (size_t)r * h, h, a.eps, red);
  }
  grid_sync(grid);

  // 2. qkv partial sums
  gemm_partials(h1, static_cast<const T*>(a.qkv_w), h, 3 * h, R, part, smem);
  grid_sync(grid);

  // 3. qkv: splits summed + bias; q kept fp32, K and V emitted in T and
  // written to the pool. One warp per (row, head, q|k|v).
  {
    const int ns = splits_for(h);
    const T* bias = static_cast<const T*>(a.qkv_b);
    float* vals = smem + warp * (D + D / 2);
    float* gsc = vals + D;
    for (int item = blockIdx.x * kWarps + warp; item < R * H * 3;
         item += gridDim.x * kWarps) {
      const int r = item / (3 * H), hd = (item / 3) % H, which = item % 3;
      const int c0 = hd * 3 * D + which * D;
      for (int d = lane; d < D; d += 32) {
        const float v = split_sum(part, ns, R, 3 * h, r, c0 + d) +
                        apex::to_f(bias[c0 + d]);
        const size_t o = ((size_t)r * H + hd) * D + d;
        if (which == 0) {
          qbuf[o] = v;
        } else {
          T t;
          apex::from_f(v, &t);
          static_cast<T*>(which == 1 ? a.k_out : a.v_out)[o] = t;
          vals[d] = apex::to_f(t);
        }
      }
      __syncwarp();
      const Row w = row_of(a, r);
      if (which != 0 && w.write) {
        const int blk = a.block_tables[w.slot * a.mb + w.pos / a.bs];
        const long tok =
            (static_cast<long>(hd) * a.pool_blocks + blk) * a.bs + w.pos % a.bs;
        write_pool<KV, D, T>(a, vals, tok, which == 1, gsc);
      }
      __syncwarp();
    }
  }
  grid_sync(grid);

  // 4. attention over pool positions 0..pos, one block per (row, head)
  {
    using P = PoolOf<T, KV, D>;
    const typename P::Pool kp = P::make(a.k_pool, a.k_scale, a.group);
    const typename P::Pool vp = P::make(a.v_pool, a.v_scale, a.group);
    float* qs = smem;
    float* att = smem + D;
    for (int item = blockIdx.x; item < R * H; item += gridDim.x) {
      const int r = item / H, hd = item % H;
      const Row w = row_of(a, r);
      const int ctx = w.valid ? min(w.pos + 1, a.mb * a.bs) : 0;
      __syncthreads();  // the previous item's readers are done
      if (tid < D) qs[tid] = __ldcg(qbuf + ((size_t)r * H + hd) * D + tid);
      const float o = apex::attend_row<kThreads, D>(
          qs, kp, vp, a.block_tables + w.slot * a.mb, ctx,
          static_cast<long>(hd) * a.pool_blocks * a.bs, a.bs, a.scale, att);
      if (tid < D) apex::from_f(o, &ctxb[(size_t)r * h + hd * D + tid]);
    }
  }
  grid_sync(grid);

  // 5. out-projection partial sums
  gemm_partials(static_cast<const T*>(ctxb), static_cast<const T*>(a.out_w),
                h, h, R, part, smem);
  grid_sync(grid);

  // 6. x1 = x + (sum + b), fp32; LN2 -> h2. One block per row.
  {
    const int ns = splits_for(h);
    const T* bias = static_cast<const T*>(a.out_b);
    for (int r = blockIdx.x; r < R; r += gridDim.x) {
      __syncthreads();
      for (int c = tid; c < h; c += kThreads) {
        const float v = apex::to_f(x[(size_t)r * h + c]) +
                        (split_sum(part, ns, R, h, r, c) + apex::to_f(bias[c]));
        x1[(size_t)r * h + c] = v;
        smem[c] = v;
      }
      __syncthreads();
      ln_row(smem, static_cast<const T*>(a.ln2_w),
             static_cast<const T*>(a.ln2_b), h2 + (size_t)r * h, h, a.eps,
             red);
    }
  }
  grid_sync(grid);

  // 7. fc1 partial sums
  gemm_partials(static_cast<const T*>(h2), static_cast<const T*>(a.fc1_w), h,
                f, R, part, smem);
  grid_sync(grid);

  // 8. y = gelu(sum + b1) in fp32, cast to T
  {
    const int ns = splits_for(h);
    const T* bias = static_cast<const T*>(a.fc1_b);
    for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < (size_t)R * f;
         i += (size_t)gridDim.x * kThreads) {
      const int r = i / f, c = i % f;
      apex::from_f(gelu_tanh(split_sum(part, ns, R, f, r, c) +
                             apex::to_f(bias[c])),
                   &y[i]);
    }
  }
  grid_sync(grid);

  // 9. fc2 partial sums
  gemm_partials(static_cast<const T*>(y), static_cast<const T*>(a.fc2_w), f,
                h, R, part, smem);
  grid_sync(grid);

  // 10. x' = x1 + (sum + b2), cast to T
  {
    const int ns = splits_for(f);
    const T* bias = static_cast<const T*>(a.fc2_b);
    for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < (size_t)R * h;
         i += (size_t)gridDim.x * kThreads) {
      const int r = i / h, c = i % h;
      apex::from_f(__ldcg(x1 + i) + (split_sum(part, ns, R, h, r, c) +
                                     apex::to_f(bias[c])),
                   &x_out[i]);
    }
  }
}

template <typename T, int KV, int D>
cudaError_t launch_d(const Args& a, int device, cudaStream_t stream) {
  auto kern = fused_layer_kernel<T, KV, D>;
  const size_t smem = sizeof(float) *
      smem_floats(a.hidden, D, apex::AttendSmem<kThreads, D>::kFloats);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int blocks = sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
  Args args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                    dim3(blocks), dim3(kThreads), params,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int KV>
cudaError_t launch_kv(const Args& a, int head_dim, int device,
                      cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_d<T, KV, 32>(a, device, s);
    case 64: return launch_d<T, KV, 64>(a, device, s);
    case 128: return launch_d<T, KV, 128>(a, device, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const Args& a, int head_dim, int kv_mode, int device,
                     cudaStream_t s) {
  switch (kv_mode) {
    case 0: return launch_kv<T, 0>(a, head_dim, device, s);
    case 1: return launch_kv<T, 1>(a, head_dim, device, s);
    case 2: return launch_kv<T, 2>(a, head_dim, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of the scratch buffer fused_layer_fwd needs for `rows` fed rows.
extern "C" long long fused_layer_scratch_bytes(int rows, int hidden, int ffn,
                                               int is_bf16) {
  return static_cast<long long>(
      layout(rows, hidden, ffn, is_bf16 ? 2 : 4).total);
}

// Dynamic shared memory of one block, in bytes.
extern "C" int fused_layer_smem_bytes(int hidden, int head_dim) {
  int attend = 0;
  switch (head_dim) {
    case 32: attend = apex::AttendSmem<kThreads, 32>::kFloats; break;
    case 64: attend = apex::AttendSmem<kThreads, 64>::kFloats; break;
    case 128: attend = apex::AttendSmem<kThreads, 128>::kFloats; break;
    default: return -1;
  }
  return static_cast<int>(sizeof(float)) *
         smem_floats(hidden, head_dim, attend);
}

// One fused layer on CUDA device `device`, on `stream`. Model type T =
// is_bf16 ? bf16 : fp32 for x, every weight and vector, x_out, k_out and
// v_out. x, x_out: (n * q, hidden); k_out, v_out: (n * q, heads, head_dim);
// weights (hidden, 3 hidden), (hidden, hidden), (hidden, ffn), (ffn,
// hidden) row-major, the qkv columns per-head interleaved; one layer's
// pools as in paged_attention.cu (kv_mode 0: T; 1: int8 + fp32 scales; 2:
// int4 + bf16 group scales), written in place; block_tables (n, max_blocks)
// int32; start, n_valid (null: q each) (n,) int32; active (n,) bool;
// scratch: fused_layer_scratch_bytes(n * q, hidden, ffn, is_bf16) bytes.
// hidden == heads * head_dim, head_dim in {32, 64, 128}, n * q <= 128;
// all 16-byte aligned.
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
    int kv_mode, int group, float scale, float eps, int is_bf16,
    void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n * q == 0) return static_cast<int>(cudaGetLastError());
  if (n * q > kMaxRows || hidden != heads * head_dim || hidden % kNC ||
      ffn % kNC || hidden % kKC || ffn % kKC)
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
  a.n = n; a.q = q; a.hidden = hidden; a.heads = heads; a.ffn = ffn;
  a.pool_blocks = pool_blocks; a.bs = block_size; a.mb = max_blocks;
  a.group = group; a.scale = scale; a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_t<__nv_bfloat16>(a, head_dim, kv_mode, device, s)
              : launch_t<float>(a, head_dim, kv_mode, device, s);
  return static_cast<int>(err);
}
