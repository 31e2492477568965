// The split walk of paged attention, shared by csrc/paged_attention.cu
// (fp32 on the CUDA cores, and both types above head dim 256),
// csrc/paged_mma.cu (bf16 on the tensor cores) and the fused decode/verify
// layer csrc/megakernel.cu (its attention phase walks the same items with
// the bodies of paged_walks.cuh, and its merge phase runs merge_row): the
// geometry, the copies of one tile of pool positions into shared memory,
// the dequantization of int8 / int4 tiles, and the merge of the partials
// (a second launch for the per-op kernels, a later phase of the fused
// layer's launch).
//
// Geometry. Rows are flat (slots * q). The rows [i*g, (i+1)*g) of a group
// (g = rows_per_table; q in the serve programs) share block-table row i*g,
// so a block reads each K/V tile once for a tile of up to 32 rows of one
// group (32 on the tensor cores, 8 on the CUDA cores, whose products cost
// more a row; the fused layer's block tables have one row a group: `gtab`,
// the table rows a group spans, is g for the per-op kernels and 1 there). One owner block per (context split, head, row tile). Split
// s covers positions [s*split_len, (s+1)*split_len); split_len is a
// multiple of 64 and a function of the table's capacity (max_blocks * bs)
// alone (serve/decode.py `_paged_splits`), so a token's splits, and the
// tiles inside them, start at the same positions whatever the row count.
// A block walks its split up to the largest context of its rows; a split
// past all of them returns at once and writes nothing.
//
// Partials. Each block writes, per row, the running max m of its split,
// the sum l of exp(s - m) and the unnormalized fp32 accumulator acc[d]
// (the tensor-core kernel first merges its four warps' in a fixed order):
//   acc at part[((row * heads + h) * splits + s) * d + c],
//   (m, l) at ml[((row * heads + h) * splits + s) * 2], ml = part + n *
//   heads * splits * d.
// The merge (one warp per (row, head)) reads the row's live splits only
// (s * split_len < ctx): M = max m_s, L = sum l_s exp(m_s - M), o = sum
// acc_s exp(m_s - M) / L with the splits added in order, and zeros where
// ctx == 0. A split with no live position of its row holds (NEG_INF, 0,
// 0) and adds nothing. So a row's bits depend on its own context and the
// split geometry, never on its group or on the other rows of the launch.
//
// Pools (serve/kv_cache.py): full-precision (H, B, bs, d) in the model
// dtype; int8 codes (H, B, bs, d) + one fp32 scale per token (H, B, bs);
// int4 nibble pairs (H, B, bs, d / 2), the even channel in the low nibble,
// + bf16 scales (H, B, bs, d / group). A token's row is 2d or 4d bytes
// (16-byte chunks), d bytes (int8: 8- or 16-byte chunks) or d / 2 bytes
// (int4: 4, 8 or 16), so codes are copied in the widest chunk the row
// length allows. An int4 scale row is 2 * d / group bytes, only 2-byte
// aligned when d / group is odd (the default group = d gives one scale a
// token): it is copied as the 4-byte aligned windows covering it, its
// offset in the first window kept beside the tile, and the last window of
// the tensor is cut short (cp.async's src-size), so nothing is read past
// the scales. Dequantizing is code * scale in fp32, rounded to the tile's
// type: the plain version's gather into the model dtype.
#pragma once

#include "flash_mma.cuh"

namespace paged {

constexpr int kMaxRows = 32;  // rows of one group a block takes, at most

struct Args {
  const void* q;  // (n, heads, d)
  const void* k_pool;
  const void* v_pool;
  const void* k_scale;
  const void* v_scale;
  const int* bt;   // (n, mb)
  const int* ctx;  // (n,)
  void* out;       // (n, heads, d)
  float* part;     // partials, as above
  int n, heads, d, pool_blocks, bs, mb, mode, group, g, splits, split_len;
  float scale;
  int gtab;  // block-table rows a group spans (its first is read)
};

// byte offsets of a kernel's dynamic shared memory
struct Layout {
  int q, k, v, raw_k, raw_v, sc_k, sc_v, offs, bytes;
  int rs;  // bytes a staged code row takes
  int sw;  // bytes a staged scale row takes
};

// bytes a token's staged scales take: its scale row, or for a row only
// 2-byte aligned the 4-byte windows that cover it from either offset
__host__ __device__ inline int scale_window_bytes(int sb) {
  return sb % 4 ? (sb + 2 + 3) / 4 * 4 : sb;
}

// q rows of q_bytes; K and V tiles of tile_bytes, `ring` stages each for
// full-precision pools; for quantized pools one dequantized stage each and
// `ring` stages of codes, scales and scale offsets (the per-op kernels
// take 2; the fused layer more, where its shared memory allows)
inline Layout make_layout(int q_bytes, int tile_bytes, int tp, int mode,
                          int code_row_bytes, int scale_row_bytes,
                          int ring = 2) {
  Layout L{};
  const int stages = mode == 0 ? ring : 1;
  L.q = 0;
  L.k = q_bytes;
  L.v = L.k + stages * tile_bytes;
  int at = L.v + stages * tile_bytes;
  if (mode != 0) {
    L.rs = (code_row_bytes + 15) / 16 * 16;
    L.sw = scale_window_bytes(scale_row_bytes);
    L.raw_k = at;
    at += ring * tp * L.rs;
    L.raw_v = at;
    at += ring * tp * L.rs;
    L.sc_k = at;
    at += ring * tp * L.sw;
    L.sc_v = at;
    at += ring * tp * L.sw;
    at = (at + 15) / 16 * 16;
    L.offs = at;
    at += ring * tp * 4;
  }
  L.bytes = at;
  return L;
}

// the code bytes of a token's row: d of int8, d / 2 nibble pairs
__host__ __device__ inline int code_row_bytes(int mode, int d) {
  return mode == 1 ? d : d / 2;
}

// the scale bytes of a token: one fp32, or d / group bf16
__host__ __device__ inline int scale_row_bytes(int mode, int d, int group) {
  return mode == 1 ? 4 : 2 * (d / group);
}

// What a block owns: its rows, their block-table row, its span of
// positions [t_begin, t_end) (t_end: the split's end or the rows' largest
// context) and each row's context (s_ctx, 0 past the rows). Every thread
// calls it; it ends in a barrier.
struct Walk {
  int split, head;     // the item's context split and head
  long row0;           // first row
  int rows;            // rows of the tile (<= tile_rows)
  const int* bt;       // the group's block-table row
  long head_tok0;      // the head's first token row of the pools
  int t_begin, t_end;  // t_begin >= t_end: nothing to do

  __device__ __forceinline__ long tok(int t, int bs) const {
    return head_tok0 + static_cast<long>(__ldg(bt + t / bs)) * bs + t % bs;
  }
};

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// tile_rows (<= kMaxRows): the rows of one group a block takes; item:
// (split, head, group x row tile), the per-op kernels' blockIdx
__device__ __forceinline__ Walk walk_of(const Args& a, int tile_rows,
                                        uint3 item, int* s_ctx, int* s_max) {
  const int tiles_per_group = (a.g + tile_rows - 1) / tile_rows;
  const int group = item.z / tiles_per_group;
  const int rtile = item.z % tiles_per_group;
  Walk w;
  w.split = item.x;
  w.head = item.y;
  w.row0 = static_cast<long>(group) * a.g + rtile * tile_rows;
  w.rows = min(tile_rows, a.g - rtile * tile_rows);
  w.bt = a.bt + static_cast<long>(group) * a.gtab * a.mb;
  w.head_tok0 = static_cast<long>(item.y) * a.pool_blocks * a.bs;
  if (threadIdx.x < 32) {
    // a context past the row's blocks attends to the blocks it has
    const int c = threadIdx.x < w.rows
                      ? min(max(a.ctx[w.row0 + threadIdx.x], 0), a.mb * a.bs)
                      : 0;
    s_ctx[threadIdx.x] = c;
    int mx = c;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (threadIdx.x == 0) *s_max = mx;
  } else {
    // meanwhile, the split's block-table entries into L1: one address
    // every 128 bytes and the last, so every line they span
    const int t0 = item.x * a.split_len;
    const int e0 = t0 / a.bs;
    const int e1 = min((t0 + a.split_len - 1) / a.bs, a.mb - 1);
    const int e = e0 + 32 * (threadIdx.x - 32);
    if (e <= e1) prefetch_l1(w.bt + e);
    if (threadIdx.x == 32 && e0 <= e1) prefetch_l1(w.bt + e1);
  }
  __syncthreads();
  w.t_begin = item.x * a.split_len;
  w.t_end = min(w.t_begin + a.split_len, *s_max);
  return w;
}

// ---------------------------------------------------------------------------
// copies into shared memory (the caller commits the group)

// 8 bytes from device to shared memory through L1; src and dst 8-byte
// aligned
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// 4 bytes, of which the first src_bytes (0-4) are read and the rest zeroed
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// The q rows of the tile, d of T each, into tile_rows rows of `ld`
// elements; columns [d, cols) and the rows past `rows` are zeros (cols a
// multiple of 16 bytes of T)
template <typename T>
__device__ __forceinline__ void stage_q(T* dst, int ld, int tile_rows,
                                        const Args& a, const Walk& w,
                                        int cols, int tid, int nthreads) {
  constexpr int E = 16 / sizeof(T);
  const int chunks = cols / E;
  const T* q = static_cast<const T*>(a.q);
  for (int u = tid; u < tile_rows * chunks; u += nthreads) {
    const int r = u / chunks, c = (u % chunks) * E;
    const T* src = q + ((w.row0 + min(r, w.rows - 1)) * a.heads + w.head) *
                           a.d +
                   min(c, a.d - E);
    cp_async16(dst + r * ld + c, src, r < w.rows && c < a.d);
  }
}

// The stagers and the dequantization give each position of a tile to
// nthreads / TP threads of neighbouring ranks (TP divides nthreads): a
// thread finds its position's token once (one division by the block size)
// and copies its share of the position's chunks, for K and V; the threads
// of a position take neighbouring chunks, so a warp's copies fill whole
// 32-byte sectors.

// A full-precision tile of K and V: positions [t0, t0 + TP) into rows of
// `ld` elements, columns [d, cols) and the positions from t_end on zeros
// (read from the tile's first position, which is live)
template <int TP, typename T>
__device__ __forceinline__ void stage_fp(T* dk, T* dv, int ld,
                                         const Args& a, const Walk& w,
                                         int t0, int cols, int tid,
                                         int nthreads) {
  constexpr int E = 16 / sizeof(T);
  const int parts = nthreads / TP, p = tid / parts, step = parts * E;
  const int t = t0 + p;
  const bool live = t < w.t_end;
  const long row = w.tok(live ? t : t0, a.bs) * a.d;
  const T* kp = static_cast<const T*>(a.k_pool) + row;
  const T* vp = static_cast<const T*>(a.v_pool) + row;
  for (int c = tid % parts * E; c < cols; c += step) {
    const int from = min(c, a.d - E);
    cp_async16(dk + p * ld + c, kp + from, live && c < a.d);
    cp_async16(dv + p * ld + c, vp + from, live && c < a.d);
  }
}

// A quantized tile's K and V codes (rows of L.rs bytes) and scales (rows of
// L.sw bytes, each token's offset into its first window in `offs`);
// positions from t_end on are not copied (the dequantization writes their
// zeros)
template <int TP>
__device__ __forceinline__ void stage_quant(unsigned char* ck,
                                            unsigned char* cv,
                                            unsigned char* sk,
                                            unsigned char* sv, int* offs,
                                            const Args& a, const Walk& w,
                                            const Layout& L, int t0,
                                            int tid, int nthreads) {
  const int parts = nthreads / TP, p = tid / parts, part = tid % parts;
  const int t = t0 + p;
  if (t >= w.t_end) return;
  const long tok = w.tok(t, a.bs);
  const int rb = code_row_bytes(a.mode, a.d);
  const int cb = rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : 4;
  const unsigned char* kc =
      static_cast<const unsigned char*>(a.k_pool) + tok * rb;
  const unsigned char* vc =
      static_cast<const unsigned char*>(a.v_pool) + tok * rb;
  for (int c = part * cb; c < rb; c += parts * cb) {
    if (cb == 16) {
      cp_async16(ck + p * L.rs + c, kc + c, true);
      cp_async16(cv + p * L.rs + c, vc + c, true);
    } else if (cb == 8) {
      cp_async8(ck + p * L.rs + c, kc + c);
      cp_async8(cv + p * L.rs + c, vc + c);
    } else {
      cp_async4(ck + p * L.rs + c, kc + c, 4);
      cp_async4(cv + p * L.rs + c, vc + c, 4);
    }
  }
  const long sb = scale_row_bytes(a.mode, a.d, a.group);
  const long total = static_cast<long>(a.heads) * a.pool_blocks * a.bs * sb;
  const long b0 = tok * sb, w0 = b0 & ~3L;
  if (part == 0) offs[p] = static_cast<int>(b0 - w0);
  const unsigned char* ks = static_cast<const unsigned char*>(a.k_scale);
  const unsigned char* vs = static_cast<const unsigned char*>(a.v_scale);
  for (long at = w0 + 4 * part; at < b0 + sb; at += 4 * parts) {
    const int bytes = static_cast<int>(min(4L, total - at));
    const int o = static_cast<int>(at - w0);
    cp_async4(sk + p * L.sw + o, ks + at, bytes);
    cp_async4(sv + p * L.sw + o, vs + at, bytes);
  }
}

__device__ __forceinline__ float bf16_at(const unsigned char* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

__device__ __forceinline__ int nibble(unsigned v) {
  const int c = static_cast<int>(v & 0xFu);
  return c > 7 ? c - 16 : c;
}

// Dequantize positions [p0, p0 + np) of a staged tile into rows of `ld`
// elements of Out, VEC (4 or 8) channels an item (np divides nthreads):
// code * scale in fp32, rounded to Out; columns [d, cols) and the
// positions from t_end on are zeros
template <int VEC, typename Out>
__device__ __forceinline__ void dequant(
    Out* __restrict__ dst, int ld, const unsigned char* __restrict__ codes,
    const unsigned char* __restrict__ scales, const int* __restrict__ offs,
    const Args& a, const Walk& w, const Layout& L, int t0, int cols, int p0,
    int np, int tid, int nthreads) {
  const int parts = nthreads / np, p = p0 + tid / parts;
  const int step = parts * VEC;
  const bool live = t0 + p < w.t_end;
  const unsigned char* row = codes + p * L.rs;
  const unsigned char* srow = scales + p * L.sw;
  if (a.mode == 2) srow += offs[p];
#pragma unroll 2
  for (int c = tid % parts * VEC; c < cols; c += step) {
    float f[VEC];
    if (live && c < a.d) {
      if (a.mode == 1) {
        const float s = *reinterpret_cast<const float*>(srow);
        uint32_t b[2];
        if constexpr (VEC == 8) {
          const uint2 v = *reinterpret_cast<const uint2*>(row + c);
          b[0] = v.x;
          b[1] = v.y;
        } else {
          b[0] = *reinterpret_cast<const uint32_t*>(row + c);
          b[1] = 0;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          f[i] = static_cast<float>(static_cast<signed char>(
                     (b[i / 4] >> (8 * (i % 4))) & 0xFFu)) *
                 s;
      } else {
        unsigned bits;
        if constexpr (VEC == 8) {
          bits = *reinterpret_cast<const uint32_t*>(row + c / 2);
        } else {
          bits = *reinterpret_cast<const uint16_t*>(row + c / 2);
        }
        if (a.group % VEC == 0) {  // one scale for the item's channels
          const float s = bf16_at(srow + 2 * (c / a.group));
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            f[i] = static_cast<float>(nibble(bits >> (4 * i))) * s;
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            f[i] = static_cast<float>(nibble(bits >> (4 * i))) *
                   bf16_at(srow + 2 * ((c + i) / a.group));
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = 0.f;
    }
    Out* o = dst + p * ld + c;
    if constexpr (VEC == 8) {
      apex::store_vec(o, f);  // 8 bf16
    } else {
      store4(o, f);           // 4 fp32
    }
  }
}

// ---------------------------------------------------------------------------
// the merge: one warp per (row, head), 8 a block. Lane i holds the (m, l)
// of parts i and i + 32 (kMaxSplits = 64); M and L over the lanes by the
// xor trees; the output channels, in chunks of 256 (d > 256 takes more
// than one): lane i owns channels i, i + 32, ... of the chunk,
// adding the parts in order with their weights passed by shuffles, the
// loads of kMergeBatch parts in flight at once.

constexpr int kMergeWarps = 8;
constexpr int kMaxSplits = 64;
constexpr int kMergeBatch = 8;

// The merge of (row, head) pair idx by one warp into out[idx * d ..]. kCg
// reads the partials through L2 (ld.global.cg): the fused layer's merge
// phase reads what other blocks of its launch wrote, and L1 is not coherent
// across SMs.
template <typename Out, bool kCg>
__device__ __forceinline__ void merge_row(const float* __restrict__ part,
                                          const int* __restrict__ ctx,
                                          Out* __restrict__ out, int n,
                                          int heads, int d, int splits,
                                          int split_len, int cap, long idx,
                                          int lane) {
  auto ld = [](const float* p) {
    if constexpr (kCg) return __ldcg(p);
    return *p;
  };
  // every load below is issued before the row's context arrives: the
  // (m, l) and partials of all splits the scratch holds, the dead ones
  // (never written) read but masked out by value
  int cv;
  if constexpr (kCg) {
    cv = __ldcg(ctx + idx / heads);
  } else {
    cv = ctx[idx / heads];
  }
  const int c = min(max(cv, 0), cap);
  const float2* ml = reinterpret_cast<const float2*>(
                         part + static_cast<long>(n) * heads * splits * d) +
                     idx * splits;
  const float* pr = part + idx * splits * d;
  constexpr int PL = kMaxSplits / 32;  // parts a lane
  float2 raw[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    if (lane + 32 * j < splits) {
      if constexpr (kCg) {
        raw[j] = __ldcg(ml + lane + 32 * j);
      } else {
        raw[j] = ml[lane + 32 * j];
      }
    } else {
      raw[j] = make_float2(0.f, 0.f);
    }
  }
  const int live = (c + split_len - 1) / split_len;
  float pm[PL], pl[PL], wl[PL];
  float mx = apex::kNegInf;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const bool on = lane + 32 * j < live;
    pm[j] = on ? raw[j].x : apex::kNegInf;
    pl[j] = on ? raw[j].y : 0.f;
    mx = fmaxf(mx, pm[j]);
  }
  mx = apex::warp_max(mx);
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    wl[j] = expf(pm[j] - mx);
    l += pl[j] * wl[j];
  }
  l = apex::warp_sum(l);
  constexpr int PER = 256 / 32;  // channels a lane of a 256-channel chunk
  // the channels in chunks of 256 (one chunk up to d = 256), each the
  // same sum over the splits in order
  for (int c0 = 0; c0 < d; c0 += 256) {
    float acc[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) acc[k] = 0.f;
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const int cnt = min(32, splits - 32 * j);
      for (int i0 = 0; i0 < cnt; i0 += kMergeBatch) {
        float v[kMergeBatch][PER];
#pragma unroll
        for (int i = 0; i < kMergeBatch; ++i) {
          const float* row = pr + static_cast<long>(32 * j + i0 + i) * d;
#pragma unroll
          for (int k = 0; k < PER; ++k) {
            const int cc = c0 + lane + 32 * k;
            v[i][k] = i0 + i < cnt && cc < d ? ld(row + cc) : 0.f;
          }
        }
#pragma unroll
        for (int i = 0; i < kMergeBatch; ++i) {
          const float wgt = __shfl_sync(0xffffffffu, wl[j], (i0 + i) & 31);
          if (32 * j + i0 + i < live) {
#pragma unroll
            for (int k = 0; k < PER; ++k) acc[k] += v[i][k] * wgt;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int cc = c0 + lane + 32 * k;
      if (cc < d)
        apex::from_f(l > 0.f ? acc[k] / l : 0.f, out + idx * d + cc);
    }
  }
}

template <typename Out>
__global__ void __launch_bounds__(32 * kMergeWarps)
    paged_merge_kernel(const float* __restrict__ part,
                       const int* __restrict__ ctx, Out* __restrict__ out,
                       int n, int heads, int d, int splits, int split_len,
                       int cap) {
  // launched early (programmatic dependent launch): wait for the walk's
  // grid to finish and its partials to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long idx = static_cast<long>(blockIdx.x) * kMergeWarps +
                   threadIdx.x / 32;
  if (idx >= static_cast<long>(n) * heads) return;
  merge_row<Out, false>(part, ctx, out, n, heads, d, splits, split_len, cap,
                        idx, threadIdx.x % 32);
}

template <typename Out>
cudaError_t launch_merge(const Args& a, cudaStream_t s) {
  const long pairs = static_cast<long>(a.n) * a.heads;
  const unsigned blocks =
      static_cast<unsigned>((pairs + kMergeWarps - 1) / kMergeWarps);
  // a programmatic dependent launch: the merge is launched while the walk
  // runs (every walk block lets it, at its start) and waits inside for the
  // walk's grid, so the launch latency overlaps the walk
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(32 * kMergeWarps);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_merge_kernel<Out>,
                            static_cast<const float*>(a.part), a.ctx,
                            static_cast<Out*>(a.out), a.n, a.heads, a.d,
                            a.splits, a.split_len, a.mb * a.bs);
}

// Called first by every walk block: the merge may be launched once every
// walk block has started (it waits for the grid's end itself)
__device__ __forceinline__ void let_merge_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Let `kernel` take `bytes` of dynamic shared memory. Always set: the
// opt-in is needed once static and dynamic memory together pass 48 KB,
// which the dynamic bytes alone do not show.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the grid of the walk: (splits, heads, groups x row tiles of a group)
inline dim3 walk_grid(const Args& a, int tile_rows) {
  const int tiles_per_group = (a.g + tile_rows - 1) / tile_rows;
  return dim3(a.splits, a.heads, (a.n / a.g) * tiles_per_group);
}

// the instantiated head dim that runs head dim d (0: none)
inline int paged_head_dim(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : 0;
}

}  // namespace paged
