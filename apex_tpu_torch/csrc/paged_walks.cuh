// The walk bodies of paged attention, one item (context split, head, row
// tile) each: the tensor-core walk (bf16 or fp16, head dim up to 256), the
// CUDA-core walk (fp32, up to 256) and the wide walk (d > 256, the head
// dim in kWideChunk-channel chunks). csrc/paged_mma.cu and
// csrc/paged_attention.cu run one item a block (blockIdx); the fused layer
// (csrc/megakernel.cu) loops its blocks over the items in its attention
// phase. The designs are in those files' header notes.
#pragma once

#include "paged_split.cuh"

namespace paged {

constexpr int kFpTP = 32;   // CUDA-core walk: positions of a tile, one a lane
constexpr int kFpRows = 8;  // ... rows of a group a block takes
constexpr int kWideChunk = 128;  // wide walk: channels of a staged chunk
constexpr int kWideTP = 32;      // ... positions of a tile: one a lane
constexpr int kWideRows = 8;     // ... rows of a group a block takes
// the wide walk's dynamic shared memory: q and one K or V chunk, fp32
constexpr int kWideSmemBytes =
    (kWideRows * kWideChunk + kWideTP * (kWideChunk + 4)) * 4;

// The fp32 q rows of the tile as two terms of E (bf16 or fp16) each, hi =
// round(q) and lo = round(q - hi), into tile_rows rows of `ld` elements;
// columns [d, cols) and the rows past `rows` are zeros (q was written
// earlier in the fused layer's launch: read through L2). The loads go first and
// `between` runs before their values are used (the walk issues its first
// K/V tiles there, so q does not queue behind them).
template <int D, typename E, class Between>
__device__ __forceinline__ void stage_q_split(E* hi, E* lo, int ld,
                                              const Args& a, const Walk& w,
                                              int cols, int tid,
                                              int nthreads,
                                              const Between& between) {
  const float* q = static_cast<const float*>(a.q);
  const int chunks = cols / 4;
  // the loads a thread holds (256 threads: the fused layer's blocks; more
  // units, if any, go after `between`, loaded and stored at once)
  constexpr int kPer = (kMaxRows * (D / 4) + 255) / 256;
  float4 ld4[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int u = tid + i * nthreads;
    const int r = u / chunks, c = (u % chunks) * 4;
    ld4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < kMaxRows * chunks && r < w.rows && c < a.d)
      ld4[i] = __ldcg(reinterpret_cast<const float4*>(
          q + ((w.row0 + r) * a.heads + w.head) * a.d + c));
  }
  between();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int u = tid + i * nthreads;
    if (u >= kMaxRows * chunks) continue;
    const int r = u / chunks, c = (u % chunks) * 4;
    const float4 v = ld4[i];
    const float f[4] = {v.x, v.y, v.z, v.w};
    float rest[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) rest[e] = f[e] - round_to<E>(f[e]);
    *reinterpret_cast<uint2*>(hi + r * ld + c) =
        make_uint2(pack2<E>(f[0], f[1]), pack2<E>(f[2], f[3]));
    *reinterpret_cast<uint2*>(lo + r * ld + c) = make_uint2(
        pack2<E>(rest[0], rest[1]), pack2<E>(rest[2], rest[3]));
  }
  for (int u = tid + kPer * nthreads; u < kMaxRows * chunks; u += nthreads) {
    const int r = u / chunks, c = (u % chunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < w.rows && c < a.d)
      v = __ldcg(reinterpret_cast<const float4*>(
          q + ((w.row0 + r) * a.heads + w.head) * a.d + c));
    const float f[4] = {v.x, v.y, v.z, v.w};
    float rest[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) rest[e] = f[e] - round_to<E>(f[e]);
    *reinterpret_cast<uint2*>(hi + r * ld + c) =
        make_uint2(pack2<E>(f[0], f[1]), pack2<E>(f[2], f[3]));
    *reinterpret_cast<uint2*>(lo + r * ld + c) = make_uint2(
        pack2<E>(rest[0], rest[1]), pack2<E>(rest[2], rest[3]));
  }
}

// The tensor-core walk of one item, tiles of E (bf16 or fp16: the model
// type; mma.sync .bf16 or .f16). QSPLIT: q is fp32 (the fused layer keeps
// it unrounded) and enters S = Q K^T as two E terms, hi = round(q) and lo =
// round(q - hi), like p in P V; else q is E and copied as it is. NS:
// stages of the K/V ring (the layout's `ring`). Every thread of the block
// calls it (128 or 256 threads); the caller separates two items by a
// barrier.
template <int D, int MODE, bool QSPLIT, int NS = 2, typename E = bf16>
__device__ __forceinline__ void mma_walk(const Args& a, const Layout& L,
                                         uint3 item, unsigned char* smem) {
  constexpr int S = kStride<D>, TP = kB, ND = D / 8;
  __shared__ int s_ctx[kMaxRows];
  __shared__ int s_max;
  const Walk w = walk_of(a, kMaxRows, item, s_ctx, &s_max);
  if (w.t_begin >= w.t_end) return;  // past every row's context
  const int ntiles = (w.t_end - w.t_begin + TP - 1) / TP;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int d16 = (a.d + 15) & ~15;

  E* sQ = reinterpret_cast<E*>(smem + L.q);
  E* sQlo = sQ + kMaxRows * S;  // QSPLIT only
  E* sK = reinterpret_cast<E*>(smem + L.k);
  E* sV = reinterpret_cast<E*>(smem + L.v);
  unsigned char* raw_k = smem + L.raw_k;
  unsigned char* raw_v = smem + L.raw_v;
  unsigned char* sc_k = smem + L.sc_k;
  unsigned char* sc_v = smem + L.sc_v;
  int* offs = reinterpret_cast<int*>(smem + L.offs);

  auto stage = [&](int kt) {
    const int t0 = w.t_begin + kt * TP, st = kt % NS;
    if constexpr (MODE == 0) {
      stage_fp<TP>(sK + st * TP * S, sV + st * TP * S, S, a, w, t0, d16,
                   tid, nthreads);
    } else {
      stage_quant<TP>(raw_k + st * TP * L.rs, raw_v + st * TP * L.rs,
                      sc_k + st * TP * L.sw, sc_v + st * TP * L.sw,
                      offs + st * TP, a, w, L, t0, tid, nthreads);
    }
  };
  // q first, then the first K/V tile (fp32 q: its loads issued before the
  // tile's copies, its values split and stored after); then the ring's
  // other stages
  if constexpr (QSPLIT) {
    stage_q_split<D>(sQ, sQlo, S, a, w, d16, tid, nthreads,
                     [&] { stage(0); });
  } else {
    stage_q(sQ, S, kMaxRows, a, w, d16, tid, nthreads);
    stage(0);
  }
  cp_async_commit();
#pragma unroll 1
  for (int kt = 1; kt < NS - 1; ++kt) {
    if (kt < ntiles) stage(kt);
    cp_async_commit();
  }

  // this warp: rows 16 half + (g, g + 8) of the tile, positions [16 slice,
  // 16 slice + 16) of every K/V tile
  const int half = warp / 4, slice = warp % 4;
  const bool active = half * 16 < w.rows;
  const int r[2] = {half * 16 + g, half * 16 + g + 8};
  const int ctx[2] = {s_ctx[r[0]], s_ctx[r[1]]};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {apex::kNegInf, apex::kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();  // every warp is done with the stage refilled next
    if (kt + NS - 1 < ntiles) stage(kt + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // this tile (and q) have landed
    __syncthreads();
    const int t0 = w.t_begin + kt * TP;
    const E* cK = sK;
    const E* cV = sV;
    if constexpr (MODE == 0) {
      cK += (kt % NS) * TP * S;
      cV += (kt % NS) * TP * S;
    } else {
      // each slice's warps (one per half) dequantize the 16 positions
      // they read, then meet at the slice's own barrier
      const int st = kt % NS, sid = lane + 32 * half, sn = nthreads / 4;
      dequant<8>(sK, S, raw_k + st * TP * L.rs, sc_k + st * TP * L.sw,
                 offs + st * TP, a, w, L, t0, d16, slice * 16, 16, sid, sn);
      dequant<8>(sV, S, raw_v + st * TP * L.rs, sc_v + st * TP * L.sw,
                 offs + st * TP, a, w, L, t0, d16, slice * 16, 16, sid, sn);
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slice), "r"(sn)
                   : "memory");
    }
    if (!active) continue;

    // S = Q K^T over this warp's 16 positions
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 16) {
      if (c < d16) {
        uint32_t af[4], b[4];
        load_a<D>(af, sQ, half * 16, c, lane);
        load_bt<D>(b, cK, slice * 16, c, lane);
        mma16<E>(s[0], af, b[0], b[1]);
        mma16<E>(s[1], af, b[2], b[3]);
        if constexpr (QSPLIT) {
          load_a<D>(af, sQlo, half * 16, c, lane);
          mma16<E>(s[0], af, b[0], b[1]);
          mma16<E>(s[1], af, b[2], b[3]);
        }
      }
    }
    // scale and mask by value; the row max over the 4 lanes of a row
    float mx[2] = {apex::kNegInf, apex::kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = t0 + slice * 16 + j * 8 + 2 * t + (e & 1);
        const float sv =
            pos < ctx[e >> 1] ? s[j][e] * a.scale : apex::kNegInf;
        s[j][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
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
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = t0 + slice * 16 + j * 8 + 2 * t + (e & 1);
        const float p =
            pos < ctx[e >> 1] ? expf(s[j][e] - m[e >> 1]) : 0.f;
        l[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    // O += P V over the same 16 positions, p as two E terms: hi =
    // round(p), lo = round(p - hi) (p - hi is exact), so the products keep
    // about 16 bits of p
    float lo[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        lo[j][e] = s[j][e] - round_to<E>(s[j][e]);
    uint32_t pa[4], pb[4];
    acc_to_a<2, E>(pa, s, 0);
    acc_to_a<2, E>(pb, lo, 0);
#pragma unroll
    for (int c = 0; c < ND; c += 2) {
      if (c * 8 < d16) {
        uint32_t b[4];
        load_b<D>(b, cV, slice * 16, c * 8, lane);
        mma16<E>(acc[c], pa, b[0], b[1]);
        mma16<E>(acc[c + 1], pa, b[2], b[3]);
        mma16<E>(acc[c], pb, b[0], b[1]);
        mma16<E>(acc[c + 1], pb, b[2], b[3]);
      }
    }
  }

  // the four slices' (m, l, acc) of each row merged in slice order, one
  // half of the rows at a time through the freed tile memory, into the
  // split's partial
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  constexpr int RS = D + 2;  // a row of a slice: acc, m, l
  float* red = reinterpret_cast<float*>(smem + L.k);
  float* ml = a.part + static_cast<long>(a.n) * a.heads * a.splits * a.d;
  for (int hh = 0; hh * 16 < w.rows; ++hh) {
    __syncthreads();  // the tiles, or the previous half, are consumed
    if (half == hh) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* row = red + (slice * 16 + g + 8 * i) * RS;
        if (t == 0) {
          row[D] = m[i];
          row[D + 1] = l[i];
        }
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const int col = j * 8 + 2 * t;
          if (col < a.d)
            *reinterpret_cast<float2*>(row + col) =
                make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
        }
      }
    }
    __syncthreads();
    const int rows = min(16, w.rows - hh * 16);
    for (int u = tid; u < rows * (a.d + 1); u += nthreads) {
      const int rr = u / (a.d + 1), c = u % (a.d + 1);
      float mw[4], mx = apex::kNegInf;
#pragma unroll
      for (int sl = 0; sl < 4; ++sl) {
        mw[sl] = red[(sl * 16 + rr) * RS + D];
        mx = fmaxf(mx, mw[sl]);
      }
      const long pi = (w.row0 + hh * 16 + rr) * a.heads * a.splits +
                      static_cast<long>(w.head) * a.splits + w.split;
      float sum = 0.f;
#pragma unroll
      for (int sl = 0; sl < 4; ++sl) {
        const float* row = red + (sl * 16 + rr) * RS;
        sum += (c < a.d ? row[c] : row[D + 1]) * expf(mw[sl] - mx);
      }
      if (c < a.d) {
        a.part[pi * a.d + c] = sum;
      } else {
        ml[2 * pi] = mx;
        ml[2 * pi + 1] = sum;
      }
    }
  }
}

// The CUDA-core walk of one item (fp32): THREADS threads (128 for the
// per-op kernel, 256 in the fused layer), kFpRows rows a tile, NS stages
// of the K/V ring (the layout's `ring`).
template <int D, int MODE, int THREADS, int NS = 2>
__device__ __forceinline__ void fp32_walk(const Args& a, const Layout& L,
                                          uint3 item, unsigned char* smem) {
  constexpr int TP = kFpTP, LD = D + 4, R = kFpRows, WARPS = THREADS / 32;
  constexpr int ROWS_A_WARP = R / WARPS;
  constexpr int ITEMS = R * D / THREADS;  // (row, channel) pairs a thread
  static_assert(ROWS_A_WARP >= 1 && ITEMS >= 1, "fp32 walk geometry");
  __shared__ int s_ctx[kMaxRows];
  __shared__ int s_max;
  __shared__ float sP[R][TP];
  __shared__ float sCorr[R];
  const Walk w = walk_of(a, R, item, s_ctx, &s_max);
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

  stage_q(sQ, D, R, a, w, a.d, tid, THREADS);
  auto stage = [&](int kt) {
    const int t0 = w.t_begin + kt * TP, st = kt % NS;
    if constexpr (MODE == 0) {
      stage_fp<TP>(sK + st * TP * LD, sV + st * TP * LD, LD, a, w, t0, a.d,
                   tid, THREADS);
    } else {
      stage_quant<TP>(raw_k + st * TP * L.rs, raw_v + st * TP * L.rs,
                      sc_k + st * TP * L.sw, sc_v + st * TP * L.sw,
                      offs + st * TP, a, w, L, t0, tid, THREADS);
    }
  };
  stage(0);
  cp_async_commit();
#pragma unroll 1
  for (int kt = 1; kt < NS - 1; ++kt) {
    if (kt < ntiles) stage(kt);
    cp_async_commit();
  }

  // warp w: the online state of rows w + 4k (the same in every lane)
  float m[ROWS_A_WARP], l[ROWS_A_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_A_WARP; ++k) {
    m[k] = apex::kNegInf;
    l[k] = 0.f;
  }
  // thread: the accumulators of pairs e = tid + THREADS * k, row e / D,
  // channel e % D
  float acc[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) acc[k] = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    __syncthreads();  // every thread is done with the stage refilled next
    if (kt + NS - 1 < ntiles) stage(kt + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // this tile (and q) have landed
    __syncthreads();
    const int t0 = w.t_begin + kt * TP;
    const float* cK = sK;
    const float* cV = sV;
    if constexpr (MODE == 0) {
      cK += (kt % NS) * TP * LD;
      cV += (kt % NS) * TP * LD;
    } else {
      const int st = kt % NS;
      dequant<4>(sK, LD, raw_k + st * TP * L.rs, sc_k + st * TP * L.sw,
                 offs + st * TP, a, w, L, t0, a.d, 0, TP, tid, THREADS);
      dequant<4>(sV, LD, raw_v + st * TP * L.rs, sc_v + st * TP * L.sw,
                 offs + st * TP, a, w, L, t0, a.d, 0, TP, tid, THREADS);
      __syncthreads();
    }

    // scores and the online-softmax update, a warp per row
#pragma unroll
    for (int k = 0; k < ROWS_A_WARP; ++k) {
      const int r = warp + WARPS * k;
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
      const int e = tid + THREADS * k, r = e / D, c = e % D;
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
    return ((w.row0 + r) * a.heads + w.head) * parts + w.split;
  };
#pragma unroll
  for (int k = 0; k < ROWS_A_WARP; ++k) {
    const int r = warp + WARPS * k;
    if (r < w.rows && lane == 0) {
      ml[2 * part_of(r)] = m[k];
      ml[2 * part_of(r) + 1] = l[k];
    }
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int e = tid + THREADS * k, r = e / D, c = e % D;
    if (r < w.rows && c < a.d) a.part[part_of(r) * a.d + c] = acc[k];
  }
}

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
        f[i] = static_cast<float>(nibble(bits >> (4 * i))) *
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

// The wide walk of one item: q of type QT (fp32 in the fused layer), a
// pool of type T; THREADS threads (128 per-op, 256 fused); sQ and sKV in
// `smem` (kWideSmemBytes).
template <typename QT, typename T, int MODE, int THREADS>
__device__ __forceinline__ void wide_walk(const Args& a, uint3 item,
                                          unsigned char* smem) {
  constexpr int TP = kWideTP, DC = kWideChunk, LD = DC + 4, R = kWideRows;
  constexpr int WARPS = THREADS / 32;
  constexpr int ROWS_A_WARP = R / WARPS;
  constexpr int ITEMS = R * DC / THREADS;  // (row, channel) pairs a thread
  static_assert(ROWS_A_WARP >= 1 && ITEMS >= 1, "wide walk geometry");
  auto sQ = reinterpret_cast<float (*)[DC]>(smem);
  auto sKV = reinterpret_cast<float (*)[LD]>(smem + R * DC * 4);
  __shared__ int s_ctx[kMaxRows];
  __shared__ int s_max;
  __shared__ float sP[R][TP];
  __shared__ float sCorr[R];
  const Walk w = walk_of(a, R, item, s_ctx, &s_max);
  if (w.t_begin >= w.t_end) return;  // past every row's context
  const int ntiles = (w.t_end - w.t_begin + TP - 1) / TP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int parts = a.splits;
  auto part_of = [&](int r) {
    return ((w.row0 + r) * a.heads + w.head) * parts + w.split;
  };
  const QT* q = static_cast<const QT*>(a.q);

  // positions [t0, t0 + TP) x channels [c0, c0 + DC) of K or V into sKV,
  // zeros past the head dim and from t_end on
  auto stage = [&](const void* pool, const void* scales, int t0, int c0) {
    for (int u = tid; u < TP * DC / 8; u += THREADS) {
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
      for (int u = tid; u < R * DC / 8; u += THREADS) {
        const int r = u / (DC / 8), c = (u % (DC / 8)) * 8;
        float f[8];
        if (r < w.rows && c0 + c < a.d) {
          const QT* src = q + ((w.row0 + r) * a.heads + w.head) * a.d +
                          c0 + c;
          if constexpr (sizeof(QT) == 4) {
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
        const int r = warp + WARPS * k;
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
      const int r = warp + WARPS * k;
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
        const int e = tid + THREADS * k, r = e / DC, c = e % DC;
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
    const int r = warp + WARPS * k;
    if (r < w.rows && lane == 0) {
      ml[2 * part_of(r)] = m[k];
      ml[2 * part_of(r) + 1] = l[k];
    }
  }
}

}  // namespace paged
