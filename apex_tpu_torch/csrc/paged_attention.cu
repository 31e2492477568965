// Paged attention on the CUDA cores, for Hopper (sm_90a): fp32 queries at
// head dim d % 8 == 0 up to 256 (`paged_attention_fwd`), and fp32 or bf16
// queries at every d % 8 == 0 above 256 (`paged_wide_fwd`), over
// full-precision, int8 and int4 pools.
//
// Replaces, for fp32 queries, the TPU kernel apex_tpu/serve/decode.py
// `_paged_kernel` (reached through `_paged_pallas`, pallas_call at
// decode.py:228), for full-precision, int8 and int4 pools (its `quantized`
// / `kv_bits` branches, decode.py:146-151); bf16 queries run on the tensor
// cores (paged_mma.cu). The tensor cores would take fp32 as TF32, which
// the fp32 gates (2e-5 a kernel, equal streams) would not survive.
//
// Computes, per row n and head h: softmax(q . K^T * scale) V over the
// first ctx_lens[n] positions of the row's paged context, where position t
// lives in pool block block_tables[n, t / bs] at offset t % bs. Scores, p
// and the accumulator are fp32, positions >= ctx are masked (p = 0 by
// value), the softmax is online, a row with ctx == 0 writes zeros
// (decode.py:172-174). Quantized pools are dequantized (code x scale,
// fp32) into the fp32 tile the full-precision pools fill.
//
// Bound on this card: device memory. Every live K and V vector is read
// once per group of rows sharing a block table: sum over groups of the
// group's largest ctx * H * d * 2 * elem_bytes (4; 1 + 4/d int8; 0.5 +
// 2/group int4) over 3.35 TB/s; the arithmetic is 4 operations per K/V
// element pair and row.
//
// Design: the walk of paged_split.cuh, as paged_mma.cu's. One owner block
// of 128 threads per (context split, head, tile of up to 8 rows of one
// group: a prefill chunk's 32 rows make 4 tiles, so the chunk has enough
// blocks for the card), the splits merged in order by a second launch,
// counted once with this one. K/V tiles of 32 positions through a two-stage cp.async ring
// (codes and scales for quantized pools, dequantized into one fp32 tile a
// step after they land). Warp w scores the rows w, w + 4, ... of the tile,
// lane i position i: one fp32 chain over the head dim (float4 reads, rows
// padded by 16 bytes: conflict-free), then the row's online-softmax update
// by xor-shuffles; thread (row, channel) pairs then add p V in position
// order. Every row takes the same code path and sum orders whatever its
// group, so its bits do not depend on the group size or the launch.
// Instantiations D = 32, 64, 128, 256; the true d (a multiple of 8) bounds
// the loops.
//
// Shared memory (D = 256): q 8 KB; full-precision K and V, two stages,
// 130 KB; quantized: one fp32 stage of K and V 65 KB + two stages of codes
// and scales.

// The wide walk (`paged_wide_fwd`, d > 256, fp32 or bf16 q). Neither
// kernel above fits there: their q and K/V tiles hold whole head dims in
// shared memory (281 KB at d = 512 here, 300 KB on the tensor cores). So
// the head dim goes in chunks of kWideChunk channels, as flash_wide.cuh
// does for flash: per tile of 32 positions, each chunk of q and K is
// staged in turn and a row's score continues one fp32 chain through the
// chunks in channel order; then each chunk of V is staged and the rows'
// accumulators for that chunk take p V in position order. The
// accumulators live in the block's own slice of the partials in device
// memory (read and written by the thread that owns the (row, channel)
// pair, so no barrier guards them), so nothing a block holds grows with
// d: every head dim runs. The same split walk, the same merge, masks by
// value, and every row takes the same code path whatever its group, so
// a row's bits do not depend on its group size or on repeats. Pools are
// read with plain vector loads (8 channels an item) and dequantized in
// registers into the fp32 tile: code * scale in fp32, rounded to the
// query's type first (the plain version's gather into the model dtype).
// Shared memory: 4 KB of q, 16.5 KB of K or V, the scores' p.

#include "paged_split.cuh"

namespace {

using paged::Args;
using paged::Layout;
using paged::Walk;

constexpr int kThreads = 128;
constexpr int kTP = 32;   // positions of a tile: one a lane
constexpr int kRows = 8;  // rows of a group a block takes

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
    paged_fp32_kernel(const Args a, const Layout L) {
  constexpr int TP = kTP, LD = D + 4, R = kRows;
  constexpr int ROWS_A_WARP = R / (kThreads / 32);
  constexpr int ITEMS = R * D / kThreads;  // (row, channel) pairs a thread
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ctx[paged::kMaxRows];
  __shared__ int s_max;
  __shared__ float sP[R][TP];
  __shared__ float sCorr[R];
  paged::let_merge_launch();
  const Walk w = paged::walk_of(a, R, s_ctx, &s_max);
  if (w.t_begin >= w.t_end) return;  // past every row's context
  const int ntiles = (w.t_end - w.t_begin + TP - 1) / TP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  float* sQ = reinterpret_cast<float*>(smem + L.q);
  float* sK = reinterpret_cast<float*>(smem + L.k);
  float* sV = reinterpret_cast<float*>(smem + L.v);
  unsigned char* raw_k = smem + L.raw_k;
  unsigned char* raw_v = smem + L.raw_v;
  unsigned char* sc_k = smem + L.sc_k;
  unsigned char* sc_v = smem + L.sc_v;
  int* offs = reinterpret_cast<int*>(smem + L.offs);

  paged::stage_q(sQ, D, R, a, w, a.d, tid, kThreads);
  auto stage = [&](int kt) {
    const int t0 = w.t_begin + kt * TP, st = kt & 1;
    if constexpr (MODE == 0) {
      paged::stage_fp<TP>(sK + st * TP * LD, sV + st * TP * LD, LD, a, w,
                          t0, a.d, tid, kThreads);
    } else {
      paged::stage_quant<TP>(raw_k + st * TP * L.rs, raw_v + st * TP * L.rs,
                             sc_k + st * TP * L.sw, sc_v + st * TP * L.sw,
                             offs + st * TP, a, w, L, t0, tid, kThreads);
    }
  };
  stage(0);
  cp_async_commit();

  // warp w: the online state of rows w + 4k (the same in every lane)
  float m[ROWS_A_WARP], l[ROWS_A_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_A_WARP; ++k) {
    m[k] = apex::kNegInf;
    l[k] = 0.f;
  }
  // thread: the accumulators of pairs e = tid + kThreads * k, row e / D,
  // channel e % D
  float acc[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) acc[k] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();  // every thread is done with the stage refilled next
    if (kt + 1 < ntiles) stage(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and q) have landed
    __syncthreads();
    const int t0 = w.t_begin + kt * TP;
    const float* cK = sK;
    const float* cV = sV;
    if constexpr (MODE == 0) {
      cK += (kt & 1) * TP * LD;
      cV += (kt & 1) * TP * LD;
    } else {
      const int st = kt & 1;
      paged::dequant<4>(sK, LD, raw_k + st * TP * L.rs,
                        sc_k + st * TP * L.sw, offs + st * TP, a, w, L, t0,
                        a.d, 0, TP, tid, kThreads);
      paged::dequant<4>(sV, LD, raw_v + st * TP * L.rs,
                        sc_v + st * TP * L.sw, offs + st * TP, a, w, L, t0,
                        a.d, 0, TP, tid, kThreads);
      __syncthreads();
    }

    // scores and the online-softmax update, a warp per row
#pragma unroll
    for (int k = 0; k < ROWS_A_WARP; ++k) {
      const int r = warp + 4 * k;
      if (r >= w.rows) continue;
      const float* qr = sQ + r * D;
      const float* kr = cK + lane * LD;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        if (c < a.d) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + c);
          const float4 kv = *reinterpret_cast<const float4*>(kr + c);
          dot = fmaf(qv.x, kv.x, dot);
          dot = fmaf(qv.y, kv.y, dot);
          dot = fmaf(qv.z, kv.z, dot);
          dot = fmaf(qv.w, kv.w, dot);
        }
      }
      const bool live = t0 + lane < s_ctx[r];
      const float sv = live ? dot * a.scale : apex::kNegInf;
      const float m_new = fmaxf(m[k], apex::warp_max(sv));
      const float corr = expf(m[k] - m_new);
      const float p = live ? expf(sv - m_new) : 0.f;
      l[k] = l[k] * corr + apex::warp_sum(p);
      m[k] = m_new;
      sP[r][lane] = p;
      if (lane == 0) sCorr[r] = corr;
    }
    __syncthreads();
    // acc = acc * corr + sum_i p_i v_i, positions in order
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int e = tid + kThreads * k, r = e / D, c = e % D;
      if (r < w.rows && c < a.d) {
        float v = acc[k] * sCorr[r];
#pragma unroll 8
        for (int i = 0; i < TP; ++i) v = fmaf(sP[r][i], cV[i * LD + c], v);
        acc[k] = v;
      }
    }
  }

  const int parts = a.splits;
  float* ml = a.part + static_cast<long>(a.n) * a.heads * parts * a.d;
  auto part_of = [&](int r) {
    return ((w.row0 + r) * a.heads + blockIdx.y) * parts + blockIdx.x;
  };
#pragma unroll
  for (int k = 0; k < ROWS_A_WARP; ++k) {
    const int r = warp + 4 * k;
    if (r < w.rows && lane == 0) {
      ml[2 * part_of(r)] = m[k];
      ml[2 * part_of(r) + 1] = l[k];
    }
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int e = tid + kThreads * k, r = e / D, c = e % D;
    if (r < w.rows && c < a.d) a.part[part_of(r) * a.d + c] = acc[k];
  }
}

template <int D, int MODE>
cudaError_t launch_walk(const Args& a, cudaStream_t s) {
  // code rows laid out for the instantiated D, scale rows for the true d
  const Layout L = paged::make_layout(
      kRows * D * 4, kTP * (D + 4) * 4, kTP, MODE,
      paged::code_row_bytes(MODE, D),
      MODE == 0 ? 0 : paged::scale_row_bytes(MODE, a.d, a.group));
  auto kernel = paged_fp32_kernel<D, MODE>;
  cudaError_t err = paged::allow_dynamic_smem(kernel, L.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<paged::walk_grid(a, kRows), kThreads, L.bytes, s>>>(a, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return paged::launch_merge<float>(a, s);
}

template <int MODE>
cudaError_t launch_mode(const Args& a, cudaStream_t s) {
  switch (paged::paged_head_dim(a.d)) {
    case 32: return launch_walk<32, MODE>(a, s);
    case 64: return launch_walk<64, MODE>(a, s);
    case 128: return launch_walk<128, MODE>(a, s);
    case 256: return launch_walk<256, MODE>(a, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// the wide walk: d > 256, fp32 or bf16 q, the head dim in chunks

constexpr int kWideChunk = 128;  // channels of a staged chunk
constexpr int kWideTP = 32;      // positions of a tile: one a lane
constexpr int kWideRows = 8;     // rows of a group a block takes

// channels [c, c + 8) of position t's K or V row (the pool's row of token
// `tok`) as fp32; a quantized pool's values rounded to T first
template <typename T, int MODE>
__device__ __forceinline__ void load8(const Args& a, const void* pool,
                                      const void* scales, long tok, int c,
                                      float* f) {
  if constexpr (MODE == 0) {
    const T* row = static_cast<const T*>(pool) + tok * a.d + c;
    if constexpr (sizeof(T) == 4) {
      apex::load_vec(row, f);
      apex::load_vec(row + 4, f + 4);
    } else {
      apex::load_vec(row, f);
    }
  } else {
    if constexpr (MODE == 1) {
      const uint2 b = *reinterpret_cast<const uint2*>(
          static_cast<const signed char*>(pool) + tok * a.d + c);
      const float s = static_cast<const float*>(scales)[tok];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = static_cast<float>(static_cast<signed char>(
                   ((i < 4 ? b.x : b.y) >> (8 * (i % 4))) & 0xFFu)) *
               s;
    } else {
      const unsigned bits = *reinterpret_cast<const uint32_t*>(
          static_cast<const unsigned char*>(pool) + tok * (a.d / 2) + c / 2);
      const __nv_bfloat16* sr = static_cast<const __nv_bfloat16*>(scales) +
                                tok * (a.d / a.group);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = static_cast<float>(paged::nibble(bits >> (4 * i))) *
               __bfloat162float(sr[(c + i) / a.group]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      T r;
      apex::from_f(f[i], &r);
      f[i] = apex::to_f(r);
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    paged_wide_kernel(const Args a) {
  constexpr int TP = kWideTP, DC = kWideChunk, LD = DC + 4, R = kWideRows;
  constexpr int ROWS_A_WARP = R / (kThreads / 32);
  constexpr int ITEMS = R * DC / kThreads;  // (row, channel) pairs a thread
  __shared__ __align__(16) float sQ[R][DC];
  __shared__ __align__(16) float sKV[TP][LD];
  __shared__ int s_ctx[paged::kMaxRows];
  __shared__ int s_max;
  __shared__ float sP[R][TP];
  __shared__ float sCorr[R];
  paged::let_merge_launch();
  const Walk w = paged::walk_of(a, R, s_ctx, &s_max);
  if (w.t_begin >= w.t_end) return;  // past every row's context
  const int ntiles = (w.t_end - w.t_begin + TP - 1) / TP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int parts = a.splits;
  auto part_of = [&](int r) {
    return ((w.row0 + r) * a.heads + blockIdx.y) * parts + blockIdx.x;
  };
  const T* q = static_cast<const T*>(a.q);

  // positions [t0, t0 + TP) x channels [c0, c0 + DC) of K or V into sKV,
  // zeros past the head dim and from t_end on
  auto stage = [&](const void* pool, const void* scales, int t0, int c0) {
    for (int u = tid; u < TP * DC / 8; u += kThreads) {
      const int p = u / (DC / 8), c = (u % (DC / 8)) * 8;
      float f[8];
      if (t0 + p < w.t_end && c0 + c < a.d) {
        load8<T, MODE>(a, pool, scales, w.tok(t0 + p, a.bs), c0 + c, f);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = 0.f;
      }
      *reinterpret_cast<float4*>(&sKV[p][c]) =
          make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(&sKV[p][c + 4]) =
          make_float4(f[4], f[5], f[6], f[7]);
    }
  };

  float m[ROWS_A_WARP], l[ROWS_A_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_A_WARP; ++k) {
    m[k] = apex::kNegInf;
    l[k] = 0.f;
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    const int t0 = w.t_begin + kt * TP;
    // scores: one chain a (row, position) through the chunks in order
    float dot[ROWS_A_WARP];
#pragma unroll
    for (int k = 0; k < ROWS_A_WARP; ++k) dot[k] = 0.f;
    for (int c0 = 0; c0 < a.d; c0 += DC) {
      __syncthreads();  // the previous chunk's readers are done
      for (int u = tid; u < R * DC / 8; u += kThreads) {
        const int r = u / (DC / 8), c = (u % (DC / 8)) * 8;
        float f[8];
        if (r < w.rows && c0 + c < a.d) {
          const T* src = q + ((w.row0 + r) * a.heads + blockIdx.y) * a.d +
                         c0 + c;
          if constexpr (sizeof(T) == 4) {
            apex::load_vec(src, f);
            apex::load_vec(src + 4, f + 4);
          } else {
            apex::load_vec(src, f);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] = 0.f;
        }
        *reinterpret_cast<float4*>(&sQ[r][c]) =
            make_float4(f[0], f[1], f[2], f[3]);
        *reinterpret_cast<float4*>(&sQ[r][c + 4]) =
            make_float4(f[4], f[5], f[6], f[7]);
      }
      stage(a.k_pool, a.k_scale, t0, c0);
      __syncthreads();
      const int cols = min(DC, a.d - c0);
#pragma unroll
      for (int k = 0; k < ROWS_A_WARP; ++k) {
        const int r = warp + 4 * k;
        if (r >= w.rows) continue;
        float v = dot[k];
#pragma unroll 4
        for (int c = 0; c < cols; c += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(&sQ[r][c]);
          const float4 kv = *reinterpret_cast<const float4*>(&sKV[lane][c]);
          v = fmaf(qv.x, kv.x, v);
          v = fmaf(qv.y, kv.y, v);
          v = fmaf(qv.z, kv.z, v);
          v = fmaf(qv.w, kv.w, v);
        }
        dot[k] = v;
      }
    }
    // the online-softmax update, a warp per row
#pragma unroll
    for (int k = 0; k < ROWS_A_WARP; ++k) {
      const int r = warp + 4 * k;
      if (r >= w.rows) continue;
      const bool live = t0 + lane < s_ctx[r];
      const float sv = live ? dot[k] * a.scale : apex::kNegInf;
      const float m_new = fmaxf(m[k], apex::warp_max(sv));
      const float corr = expf(m[k] - m_new);
      const float p = live ? expf(sv - m_new) : 0.f;
      l[k] = l[k] * corr + apex::warp_sum(p);
      m[k] = m_new;
      sP[r][lane] = p;
      if (lane == 0) sCorr[r] = corr;
    }
    // acc = acc * corr + sum_i p_i v_i, positions in order, a chunk of
    // channels at a time
    for (int c0 = 0; c0 < a.d; c0 += DC) {
      __syncthreads();  // sP / sCorr written; the previous chunk read
      stage(a.v_pool, a.v_scale, t0, c0);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int e = tid + kThreads * k, r = e / DC, c = e % DC;
        if (r < w.rows && c0 + c < a.d) {
          float* at = a.part + part_of(r) * a.d + c0 + c;
          float v = kt == 0 ? 0.f : *at * sCorr[r];
#pragma unroll 8
          for (int i = 0; i < TP; ++i) v = fmaf(sP[r][i], sKV[i][c], v);
          *at = v;
        }
      }
    }
  }
  float* ml = a.part + static_cast<long>(a.n) * a.heads * parts * a.d;
#pragma unroll
  for (int k = 0; k < ROWS_A_WARP; ++k) {
    const int r = warp + 4 * k;
    if (r < w.rows && lane == 0) {
      ml[2 * part_of(r)] = m[k];
      ml[2 * part_of(r) + 1] = l[k];
    }
  }
}

template <typename T, int MODE>
cudaError_t launch_wide(const Args& a, cudaStream_t s) {
  paged_wide_kernel<T, MODE><<<paged::walk_grid(a, kWideRows), kThreads, 0,
                               s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return paged::launch_merge<T>(a, s);
}

template <typename T>
cudaError_t launch_wide_mode(const Args& a, cudaStream_t s) {
  switch (a.mode) {
    case 0: return launch_wide<T, 0>(a, s);
    case 1: return launch_wide<T, 1>(a, s);
    case 2: return launch_wide<T, 2>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// On CUDA device `device`, on `stream`:
// q, out: (n, heads, head_dim) fp32, 16-byte aligned. One layer's pools,
// pool_blocks blocks of block_size tokens:
//   kv_mode 0: k_pool, v_pool (heads, pool_blocks, bs, head_dim) fp32;
//              k_scale, v_scale unused;
//   kv_mode 1: int8 codes of that shape + fp32 scales (heads, pool_blocks,
//              bs);
//   kv_mode 2: uint8 nibble pairs (heads, pool_blocks, bs, head_dim / 2) +
//              bf16 scales (heads, pool_blocks, bs, head_dim / group).
// block_tables: (n, max_blocks) int32 of ids < pool_blocks, read at the
// first row of each group of rows_per_table rows (n % rows_per_table ==
// 0); ctx_lens: (n,) int32. part: fp32 scratch of n * heads * splits *
// (head_dim + 2) floats. splits * split_len covers max_blocks * block_size,
// split_len a multiple of 64. head_dim % 8 == 0, 8 <= head_dim <= 256.
extern "C" int paged_attention_fwd(int device, const void* q,
                                   const void* k_pool, const void* v_pool,
                                   const void* k_scale, const void* v_scale,
                                   const void* block_tables,
                                   const void* ctx_lens, void* out,
                                   void* part, int n, int heads,
                                   int head_dim, int pool_blocks,
                                   int block_size, int max_blocks,
                                   int kv_mode, int group,
                                   int rows_per_table, int splits,
                                   int split_len, float scale,
                                   void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (head_dim % 8 || rows_per_table <= 0 || n % rows_per_table ||
      split_len % kB || splits <= 0 || splits > paged::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, k_scale, v_scale,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(ctx_lens), out,
               static_cast<float*>(part), n, heads, head_dim, pool_blocks,
               block_size, max_blocks, kv_mode, group, rows_per_table,
               splits, split_len, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kv_mode) {
    case 0: err = launch_mode<0>(a, s); break;
    case 1: err = launch_mode<1>(a, s); break;
    case 2: err = launch_mode<2>(a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// As paged_attention_fwd, for head_dim % 8 == 0 above 256 (any size; the
// head dim goes in chunks), q and out fp32 (q_bf16 0) or bf16 (q_bf16 1),
// a full-precision pool in q's type.
extern "C" int paged_wide_fwd(int device, const void* q, const void* k_pool,
                              const void* v_pool, const void* k_scale,
                              const void* v_scale, const void* block_tables,
                              const void* ctx_lens, void* out, void* part,
                              int n, int heads, int head_dim,
                              int pool_blocks, int block_size,
                              int max_blocks, int kv_mode, int group,
                              int rows_per_table, int splits, int split_len,
                              float scale, int q_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  if (head_dim % 8 || head_dim <= 256 || rows_per_table <= 0 ||
      n % rows_per_table || split_len % kB || splits <= 0 ||
      splits > paged::kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, k_scale, v_scale,
               static_cast<const int*>(block_tables),
               static_cast<const int*>(ctx_lens), out,
               static_cast<float*>(part), n, heads, head_dim, pool_blocks,
               block_size, max_blocks, kv_mode, group, rows_per_table,
               splits, split_len, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = q_bf16 ? launch_wide_mode<__nv_bfloat16>(a, s)
                                 : launch_wide_mode<float>(a, s);
  return static_cast<int>(err);
}
