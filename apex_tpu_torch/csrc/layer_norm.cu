// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of apex_tpu/ops/layer_norm.py:
//   * `_ln_fwd_kernel` (reached through `_ln_fwd`, pallas_call at :191);
//   * `_ln_bwd_kernel` (reached through `_layer_norm_affine_bwd`,
//     pallas_call at :224);
//   * `_rms_fwd_kernel` (reached through `_rms_fwd`, pallas_call at :262);
//   * `_rms_bwd_kernel` (reached through `_rms_norm_affine_bwd`,
//     pallas_call at :292).
//
// Types: x, y, dy and dx are T; the weight, the bias, dw and db are TW; T
// fp32, bf16 or fp16 and TW T's type or the other of fp32 and bf16 for fp32
// and bf16 x, fp32 for fp16 x (JAX's `FusedLayerNorm` and `MixedFused*` make
// fp32 params for a half model). Everything is computed in fp32.
//
// LayerNorm forward: exactly `layer_norm_reference` (layer_norm.py:46-58),
// not Welford: fp32 sums of x and x*x, mean = sum/h, var = max(E[x^2] -
// mean^2, 0), rstd = rsqrt(var + eps), y = ((x - mean) * rstd) * w + b.
// RMSNorm forward (`_rms_fwd_kernel`, :115-121): rstd = rsqrt(sum(x*x)/h +
// eps), y = (x * rstd) * w. The fp32 row statistics (mean and rstd, or
// rstd) are written only when the caller passes pointers for them
// (training); serving passes null.
//
// Backward, all in fp32, from the saved statistics: xhat = (x - mean) *
// rstd (LayerNorm) or x * rstd (RMSNorm), g = dy * w,
//   LayerNorm (`_ln_bwd_kernel`, :87-112):
//     dx = rstd * (g - mean(g) - xhat * mean(g * xhat)), db = sum dy;
//   RMSNorm (`_rms_bwd_kernel`, :124-138):
//     dx = rstd * (g - xhat * mean(g * xhat));
//   both: dw = sum over rows of dy * xhat.
//
// Bound on this card: device memory. Forward: read x, write y (2 * rows *
// hidden * sizeof(T)); backward: read dy and x, write dx (3 * rows *
// hidden * sizeof(T)). The arithmetic is a few operations per element.
//
// Forward (`norm_fwd_kernel`): x is read from device memory once, and a
// row's sum order is a function of hidden alone. The geometry is
// ops/layer_norm.py `_fwd_plan(hidden)`'s, passed in: a row is cut into
// chunks of 4 columns (16 B of fp32, 8 B of bf16 or fp16, so a warp's
// loads of consecutive chunks are consecutive bytes whatever the type) and
// belongs to a team of `team_warps` warps, thread tt of a team owning the
// chunks tt + j * (32 * team_warps), j < C, of every row. A thread holds its
// chunks of a row in registers, packed, from the load to the store of y,
// and issues all their loads before the row's first sum, so the row's
// bytes are in flight together.
//   * Up to 12,288 columns (narrow: one warp of up to 6 chunks to 768
//     columns, eight such teams a block; up to 16 warps of up to 6) the
//     block copies w and b once into shared memory, behind its first rows'
//     loads, and its teams read them there, and a team issues the next
//     row's loads before the current row's sums. The grid holds as many
//     blocks as the card keeps resident (fewer when the rows are fewer),
//     and team k of the grid walks rows k, k + (teams in the grid), ...
//   * Above that (wide: up to 32 warps of 12 chunks, 49,152 columns as the
//     backward; JAX's widest gated row, 37,376, takes 30 warps of 10) a
//     team is one block of up to 1,024 threads, whose 64 registers a thread
//     hold one row and no more: w and b are read per row from the cache,
//     and the rows in flight are the other SMs'. No cluster is needed.
// Measured on an H100 (chip_norm_compare.py beside the earlier kernel;
// PERF.md §6): keeping w and b, or the next row, in registers took 80-128
// registers a thread at GPT-2's 768 columns, too few warps an SM; a ring
// of rows in shared memory filled by cp.async.bulk added its latency to
// every short call; 8-column chunks of fp32 (two 16-byte loads 32 bytes
// apart) used half of every sector a warp's load touched.
// A row's two sums go in one order: a thread's chunks in order (4 columns
// each in order), the warp's xor tree, then the team's warps in order
// (through shared memory, slots by row parity, one named barrier a row).
// Nothing of that order depends on the grid, the row count, the row's
// place or the type, so y, mean and rstd repeat bitwise and a row's bits
// do not depend on the call that holds it (the engine's `spec_k` streams
// and the remat replay rest on that). `norm_fwd_split_reference` is the
// plain emulation of this order.
//
// Backward: one pass over dy and x and one ordered sum, two launches
// (`norm_bwd_pass_kernel`, `norm_bwd_sum_kernel`). The TPU kernel summed dw/db
// across its sequential grid into one output block; blocks here run in
// parallel, so the sum is two-stage and deterministic. The pass: a block (or a
// cluster of blocks) owns a fixed, contiguous part of the rows; its threads
// keep the same 8-column chunks in every row, so w is loaded once and dy *
// xhat (and dy) sum in registers; each thread copies its own chunks of the
// rows ahead with cp.async into its own slots of a ring in shared memory (3
// stages of bf16 or fp16, 2 of fp32), so the next rows' bytes are in flight
// while a row is reduced, and dy and x are read from device memory once. A row
// belongs to one warp up to 768 columns (eight such teams a block, walking the
// part's rows in turn), to a team of up to eight warps above, and past 8
// warps' registers (3 chunks a thread: at 4, LayerNorm's 170 registers left
// one block an SM) to a cluster of blocks, each owning every cluster-th chunk,
// its row sums exchanged through distributed shared memory. The row's sums go
// in a fixed order (a thread's chunks, the warp's xor tree, the team's warps,
// the cluster's ranks), so dx repeats bitwise. The block adds its teams' sums
// in team order and writes one fp32 partial row: parts * hidden * 4 B each for
// dw and db, at least 16 rows a part, so the partials stay under 8.3 % of the
// bound's bytes. The sum: a second launch, a programmatic dependent of the
// pass (its launch latency hides behind the pass), parallel over columns and
// over 32 slices of the parts, each slice in part order and the slices in a
// fixed tree; dw/db are written in the weight's type. The geometry is a
// function of (rows, hidden) alone (ops/layer_norm.py `_bwd_plan`, which also
// sizes the workspace), never of the SM count or the stream, so dx/dw/db are
// bitwise the same for the same inputs on every run. No shared memory or
// register grows with hidden beyond the plan's chunks, so every width JAX's
// gate admits runs (37,376 at 8-row blocks: a cluster of 7).

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// forward

constexpr int kFwdUnit = 4;         // columns of a chunk
constexpr int kFwdTeamWarps = 16;   // warps of a narrow team, at most
constexpr int kFwdTeamChunks = 6;   // chunks a thread there
constexpr int kFwdWideChunks = 12;  // and in a wide (up to 32-warp) team
constexpr int kFwdBlockWarps = 32;
constexpr int kFwdMaxDevices = 16;

// 4 consecutive values of T as loaded: 16 B of fp32, 8 B of bf16 or fp16,
// so a warp's loads of consecutive chunks are consecutive bytes
template <typename T>
struct Chunk {
  using Raw = typename std::conditional<sizeof(T) == 4, uint4, uint2>::type;
  Raw v;
};

// chunk u of a row of T at p (zeros at u == units: past the row)
template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& c, const T* p, int u,
                                           int units) {
  using Raw = typename Chunk<T>::Raw;
  c.v = u < units ? *reinterpret_cast<const Raw*>(p + u * kFwdUnit) : Raw{};
}

// chunk u (inside the row) of the weight or bias through the read-only
// cache; volatile, so the wide kernel reads it per row where it is used and
// the compiler does not hoist a row's weights into registers
template <typename TW>
__device__ __forceinline__ void load_vec_chunk(Chunk<TW>& c, const TW* p,
                                               int u) {
  if constexpr (sizeof(TW) == 4) {
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(c.v.x), "=r"(c.v.y), "=r"(c.v.z), "=r"(c.v.w)
                 : "l"(p + u * kFwdUnit));
  } else {
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(c.v.x), "=r"(c.v.y)
                 : "l"(p + u * kFwdUnit));
  }
}

// a chunk as fp32; bf16 widens through opaque instructions, so the compiler
// widens a chunk again where it is used rather than keep the fp32 copy of
// a row live beside the packed one
__device__ __forceinline__ void unpack(const Chunk<float>& c, float* f) {
  f[0] = __uint_as_float(c.v.x);
  f[1] = __uint_as_float(c.v.y);
  f[2] = __uint_as_float(c.v.z);
  f[3] = __uint_as_float(c.v.w);
}
__device__ __forceinline__ void unpack(const Chunk<__nv_bfloat16>& c,
                                       float* f) {
  const uint32_t v[2] = {c.v.x, c.v.y};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    uint32_t lo, hi;
    asm volatile("shl.b32 %0, %2, 16;\n and.b32 %1, %2, 0xffff0000;\n"
                 : "=r"(lo), "=r"(hi)
                 : "r"(v[k]));
    f[2 * k] = __uint_as_float(lo);
    f[2 * k + 1] = __uint_as_float(hi);
  }
}

__device__ __forceinline__ void unpack(const Chunk<__half>& c, float* f) {
  const uint32_t v[2] = {c.v.x, c.v.y};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float2 t = __half22float2(*reinterpret_cast<const __half2*>(&v[k]));
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

// 4 values to a chunk of y (round to nearest even for bf16 and fp16)
__device__ __forceinline__ void store_chunk(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float* o) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ void store_chunk(__half* p, const float* o) {
  const __half2 lo = __floats2half2_rn(o[0], o[1]);
  const __half2 hi = __floats2half2_rn(o[2], o[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// A team's geometry within its block
struct Team {
  int team_warps, team, tt, tw, lane;
};

// The statistics of one row from the thread's chunks c (zeros past the
// row) in the fixed order: the thread's chunks in order, the warp's xor
// tree, the team's warps in order (`slots`: the team's warps' sums in
// shared memory, one set a row parity, so one barrier a row suffices).
// Returns (mean, rstd) (mean 0 for RMSNorm).
template <typename T, bool RMS, int C>
__device__ __forceinline__ float2 row_stats(const Chunk<T> (&c)[C],
                                            const Team& t, float2* slots,
                                            int hidden, float eps) {
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    float f[kFwdUnit];
    unpack(c[j], f);
#pragma unroll
    for (int e = 0; e < kFwdUnit; ++e) {
      if (!RMS) s += f[e];
      ss += f[e] * f[e];
    }
  }
  ss = apex::warp_sum(ss);
  if (!RMS) s = apex::warp_sum(s);
  if (t.team_warps > 1) {
    if (t.lane == 0) slots[t.tw] = make_float2(s, ss);
    asm volatile("bar.sync %0, %1;\n" ::"r"(t.team + 1),
                 "r"(t.team_warps * 32)
                 : "memory");
    s = ss = 0.f;
    for (int k = 0; k < t.team_warps; ++k) {
      const float2 v = slots[k];
      s += v.x;
      ss += v.y;
    }
  }
  if constexpr (RMS) return make_float2(0.f, rsqrtf(ss / hidden + eps));
  const float mean = s / hidden;
  const float var = fmaxf(ss / hidden - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// The kernel. A team walks the rows first, first + stride, ... (stride:
// the teams in the grid) in order; the thread's C chunks of a row are in
// registers from the load to the store, all their loads issued before the
// row's first sum.
//   NARROW (teams of up to 16 warps, up to 6 chunks a thread): the block
//     copies w and b once into shared memory (`vecs`: hidden values of TW
//     each, behind the first row's loads; the teams of a block share it),
//     and a team issues the next row's loads before this row's sums.
//   wide (one team of up to 32 warps a block, up to 12 chunks): one row in
//     the 64 registers a thread has; w and b are read per row from the
//     cache.
template <typename T, typename TW, bool RMS, int C, bool NARROW>
__global__ void __launch_bounds__(NARROW ? 32 * kFwdTeamWarps
                                         : 32 * kFwdBlockWarps)
    norm_fwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                    const TW* __restrict__ b, T* __restrict__ y,
                    float* __restrict__ mean_out,
                    float* __restrict__ rstd_out, int rows, int hidden,
                    float eps, int team_warps, int teams) {
  using RawW = typename Chunk<TW>::Raw;
  extern __shared__ __align__(16) unsigned char vecs[];
  __shared__ float2 red[2][kFwdBlockWarps];  // [row parity][warp]: sums
  const int team_threads = team_warps * 32;
  const Team t{team_warps, static_cast<int>(threadIdx.x) / team_threads,
               static_cast<int>(threadIdx.x) % team_threads,
               static_cast<int>(threadIdx.x % team_threads) / 32,
               static_cast<int>(threadIdx.x) % 32};
  const int units = hidden / kFwdUnit;
  const long stride = static_cast<long>(gridDim.x) * teams;
  long row = static_cast<long>(blockIdx.x) * teams + t.team;
  auto load_row = [&](Chunk<T>(&c)[C], long r) {
#pragma unroll
    for (int j = 0; j < C; ++j)
      load_chunk(c[j], x + r * hidden, min(t.tt + j * team_threads, units),
                 units);
  };
  Chunk<T> cur[C], nxt[NARROW ? C : 1];
  if (row < rows) load_row(cur, row);
  RawW* sw = reinterpret_cast<RawW*>(vecs);  // [units] w, then [units] b
  if constexpr (NARROW) {
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      Chunk<TW> c;
      load_vec_chunk(c, w, u);
      sw[u] = c.v;
      if constexpr (!RMS) {
        load_vec_chunk(c, b, u);
        sw[units + u] = c.v;
      }
    }
    __syncthreads();
  }
  if (row >= rows) return;  // the whole team: it has no row

  for (int par = 0;; par ^= 1) {
    const long next = row + stride;
    if constexpr (NARROW) {
      if (next < rows) load_row(nxt, next);
      asm volatile("" ::: "memory");  // issued before this row's sums
    }
    const float2 st = row_stats<T, RMS, C>(
        cur, t, &red[par][t.team * team_warps], hidden, eps);
    if (t.tt == 0 && rstd_out != nullptr) {
      if (!RMS) mean_out[row] = st.x;
      rstd_out[row] = st.y;
    }
    T* yr = y + row * hidden;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int u = t.tt + j * team_threads;
      if (u < units) {
        Chunk<TW> cw, cb;
        if constexpr (NARROW) {
          cw.v = sw[u];
          if constexpr (!RMS) cb.v = sw[units + u];
        } else {
          load_vec_chunk(cw, w, u);
          if constexpr (!RMS) load_vec_chunk(cb, b, u);
        }
        float f[kFwdUnit], wf[kFwdUnit], bf[kFwdUnit], o[kFwdUnit];
        unpack(cur[j], f);
        unpack(cw, wf);
        if constexpr (!RMS) unpack(cb, bf);
#pragma unroll
        for (int e = 0; e < kFwdUnit; ++e)
          o[e] = RMS ? (f[e] * st.y) * wf[e]
                     : (f[e] - st.x) * st.y * wf[e] + bf[e];
        store_chunk(yr + u * kFwdUnit, o);
      }
    }
    if (next >= rows) break;
    row = next;
    if constexpr (NARROW) {
#pragma unroll
      for (int j = 0; j < C; ++j) cur[j] = nxt[j];
    } else {
      load_row(cur, row);
    }
  }
}

// The blocks the card keeps resident for `kernel` at this block size and
// dynamic shared memory (the grid's most), found once a device, kernel and
// shape.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int smem, int* blocks) {
  struct Entry {
    const void* fn;
    int threads, smem, blocks;
  };
  constexpr int kEntries = 32;
  static Entry cache[kFwdMaxDevices][kEntries];
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Entry* row = dev < kFwdMaxDevices ? cache[dev] : nullptr;
  for (int i = 0; row != nullptr && i < kEntries && row[i].blocks; ++i)
    if (row[i].fn == fn && row[i].threads == threads &&
        row[i].smem == smem) {
      *blocks = row[i].blocks;
      return cudaSuccess;
    }
  // the kernel's dynamic shared memory only grows, so every shape found
  // before still launches
  cudaFuncAttributes attr;
  int per_sm = 0, sms = 0;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && smem > attr.maxDynamicSharedSizeBytes)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *blocks = (per_sm > 0 ? per_sm : 1) * sms;
  for (int i = 0; row != nullptr && i < kEntries; ++i)
    if (!row[i].blocks) {
      row[i] = Entry{fn, threads, smem, *blocks};
      break;
    }
  return cudaSuccess;
}

template <typename T, typename TW, bool RMS, int C, bool NARROW>
cudaError_t launch_fwd_c(const void* x, const void* w, const void* b,
                         void* y, void* mean, void* rstd, int rows,
                         int hidden, float eps, int team_warps, int teams,
                         cudaStream_t s) {
  auto kernel = norm_fwd_kernel<T, TW, RMS, C, NARROW>;
  const int threads = teams * team_warps * 32;
  const int smem =
      NARROW ? (RMS ? 1 : 2) * hidden * static_cast<int>(sizeof(TW)) : 0;
  int blocks = 0;
  const cudaError_t err = resident_blocks(kernel, threads, smem, &blocks);
  if (err != cudaSuccess) return err;
  const long need = (static_cast<long>(rows) + teams - 1) / teams;
  kernel<<<static_cast<int>(need < blocks ? need : blocks), threads, smem,
           s>>>(static_cast<const T*>(x), static_cast<const TW*>(w),
                static_cast<const TW*>(b), static_cast<T*>(y),
                static_cast<float*>(mean), static_cast<float*>(rstd), rows,
                hidden, eps, team_warps, teams);
  return cudaGetLastError();
}

template <typename T, typename TW, bool RMS>
int launch_fwd(const void* x, const void* w, const void* b, void* y,
               void* mean, void* rstd, int rows, int hidden, float eps,
               int team_warps, int teams, int chunks, cudaStream_t s) {
  // the plan's own rules (ops/layer_norm.py `_fwd_plan`)
  const bool narrow = team_warps <= kFwdTeamWarps;
  if (hidden < 1 || hidden % apex::Vec<T>::N || rows < 0 ||
      team_warps < 1 || team_warps > kFwdBlockWarps || teams < 1 ||
      teams * team_warps > (narrow ? kFwdTeamWarps : kFwdBlockWarps) ||
      (team_warps > 8 && teams > 1) || chunks < (team_warps == 1 ? 1 : 4) ||
      chunks > (narrow ? kFwdTeamChunks : kFwdWideChunks) ||
      static_cast<long>(chunks) * team_warps * 32 * kFwdUnit <
          static_cast<long>(hidden))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err;
  switch (chunks * 2 + narrow) {
#define APEX_FWD(C, NARROW)                                                  \
  case C * 2 + NARROW:                                                       \
    err = launch_fwd_c<T, TW, RMS, C, NARROW>(x, w, b, y, mean, rstd, rows,  \
                                              hidden, eps, team_warps,       \
                                              teams, s);                     \
    break;
    APEX_FWD(1, true)
    APEX_FWD(2, true)
    APEX_FWD(3, true)
    APEX_FWD(4, true)
    APEX_FWD(5, true)
    APEX_FWD(6, true)
    APEX_FWD(4, false)
    APEX_FWD(5, false)
    APEX_FWD(6, false)
    APEX_FWD(7, false)
    APEX_FWD(8, false)
    APEX_FWD(9, false)
    APEX_FWD(10, false)
    APEX_FWD(11, false)
    APEX_FWD(12, false)
#undef APEX_FWD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// backward: one pass over dy and x, then the ordered sum of the partials

constexpr int kUnit = 8;       // elements of a chunk: 16 B half, 32 B fp32
constexpr int kSlices = 32;     // part slices (warps) of a sum block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 values of T at p (aligned to 8 * sizeof(T)) as fp32
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out) {
#pragma unroll
  for (int h = 0; h < 8; h += apex::Vec<T>::N) apex::load_vec(p + h, out + h);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* in) {
#pragma unroll
  for (int h = 0; h < 8; h += apex::Vec<T>::N) apex::store_vec(p + h, in + h);
}

// cp.async stages in flight per thread: the same bytes either way
template <typename T>
constexpr int kStages = sizeof(T) == 2 ? 3 : 2;

// The pass. Geometry (ops/layer_norm.py `_bwd_plan`, a function of rows
// and hidden alone): part p = blockIdx.x / cluster owns rows [p * rpp,
// min((p + 1) * rpp, rows)). A row belongs to a team of `team_warps`
// warps of each of the `cluster` blocks of a cluster; a block holds
// `teams` teams (cluster == 1) and team k walks the part's rows k, k +
// teams, ... in order. Thread tt of a team (tt = rank * team_warps * 32 +
// lane index in its block's share) owns the chunks u = tt + j * (cluster *
// team_warps * 32), j < V, of every row: the same columns in every row,
// so its slice of w is loaded once and its dw/db sums stay in registers.
// Each thread copies its own chunks (and the row's statistics) with
// cp.async into its own slots of a kStages ring, so the rows ahead are in
// flight while a row is reduced and no barrier guards the ring. A row's
// two sums: the thread's chunks in order, the warp's xor tree, then the
// team's warps in order (and the cluster's blocks in rank order, through
// distributed shared memory), slots double-buffered by row parity so one
// barrier a row suffices. At the end a block adds its teams' sums in team
// order (shared memory) and writes one fp32 partial row of its columns.
template <typename T, typename TW, bool RMS, int V>
__global__ void __launch_bounds__(256)
    norm_bwd_pass_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const TW* __restrict__ w, T* __restrict__ dx,
                         float* __restrict__ part_dw,
                         float* __restrict__ part_db, int rows, int hidden,
                         int rows_per_part, int team_warps, int teams,
                         int cluster) {
  constexpr int S = kStages<T>;
  constexpr int H = 8 / apex::Vec<T>::N;  // 16-byte pieces of a chunk
  // the sum launch may start; it waits for this grid's end itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 red[2][8][8];  // [parity][team][warp]: a row's sums
  namespace cg = cooperative_groups;
  const int nthreads = blockDim.x, tid = threadIdx.x;
  const int team_threads = team_warps * 32;
  const int team = tid / team_threads, tw = (tid % team_threads) / 32;
  const int rank = cluster > 1 ? static_cast<int>(
                                     cg::this_cluster().block_rank())
                               : 0;
  const int tt = rank * team_threads + tid % team_threads;
  const int stride = cluster * team_threads;  // between a thread's chunks
  const int units = hidden / kUnit;
  const long part = blockIdx.x / cluster;
  const long first = part * rows_per_part;
  const long last = min(first + rows_per_part, static_cast<long>(rows));
  const long mine = last - first - team;
  const int cnt = mine > 0 ? static_cast<int>((mine + teams - 1) / teams) : 0;

  // a 16-byte slot of this thread: stage s, array a (0 dy, 1 x), chunk j,
  // piece h
  uint4* slots = reinterpret_cast<uint4*>(smem);
  auto slot = [&](int s, int a, int j, int h) {
    return slots + ((((s * 2 + a) * V + j) * H + h) * nthreads + tid);
  };
  float2* stats = reinterpret_cast<float2*>(smem + S * 2 * V * H *
                                                       nthreads * 16) +
                  tid;  // [s * nthreads]: (mean, rstd) of stage s's row

  float wf[V][kUnit], aw[V][kUnit], ab[V][kUnit];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int u = tt + j * stride;
#pragma unroll
    for (int e = 0; e < kUnit; ++e) wf[j][e] = aw[j][e] = ab[j][e] = 0.f;
    if (u < units) load8(w + u * kUnit, wf[j]);
  }

  auto issue = [&](int i) {
    const long row = first + team + static_cast<long>(i) * teams;
    const int s = i % S;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int u = tt + j * stride;
      if (u < units) {
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const long at = row * hidden + u * kUnit + h * apex::Vec<T>::N;
          cp_async16(slot(s, 0, j, h), dy + at);
          cp_async16(slot(s, 1, j, h), x + at);
        }
      }
    }
    if (!RMS) cp_async4(&stats[s * nthreads].x, mean + row);
    cp_async4(&stats[s * nthreads].y, rstd + row);
  };
  auto load_chunk = [&](int s, int a, int j, float* f) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const uint4 raw = *slot(s, a, j, h);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < apex::Vec<T>::N; ++k)
        f[h * apex::Vec<T>::N + k] = apex::to_f(e[k]);
    }
  };

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < cnt) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < cnt; ++i) {
    if (i + S - 1 < cnt) issue(i + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();  // this thread's copies of row i have landed
    const int s = i % S, par = i & 1;
    const long row = first + team + static_cast<long>(i) * teams;
    const float2 st = stats[s * nthreads];
    const float mu = RMS ? 0.f : st.x, rs = st.y;
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (tt + j * stride < units) {
        float fdy[kUnit], fx[kUnit];
        load_chunk(s, 0, j, fdy);
        load_chunk(s, 1, j, fx);
#pragma unroll
        for (int e = 0; e < kUnit; ++e) {
          const float g = fdy[e] * wf[j][e];
          if (!RMS) c1 += g;
          c2 += g * ((fx[e] - mu) * rs);
        }
      }
    }
    c2 = apex::warp_sum(c2);
    if (!RMS) c1 = apex::warp_sum(c1);
    if (team_warps > 1 || cluster > 1) {
      if (tid % 32 == 0) red[par][team][tw] = make_float2(c1, c2);
      if (cluster > 1) {
        cg::this_cluster().sync();
      } else {
        asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1),
                     "r"(team_threads)
                     : "memory");
      }
      c1 = c2 = 0.f;
      for (int r = 0; r < cluster; ++r) {
        const float2* src =
            cluster > 1 ? cg::this_cluster().map_shared_rank(&red[par][0][0],
                                                             r)
                        : &red[par][team][0];
        for (int k = 0; k < team_warps; ++k) {
          const float2 v = src[k];
          c1 += v.x;
          c2 += v.y;
        }
      }
    }
    c1 /= hidden;
    c2 /= hidden;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int u = tt + j * stride;
      if (u < units) {
        float fdy[kUnit], fx[kUnit], o[kUnit];
        load_chunk(s, 0, j, fdy);
        load_chunk(s, 1, j, fx);
#pragma unroll
        for (int e = 0; e < kUnit; ++e) {
          const float xhat = (fx[e] - mu) * rs;
          const float g = fdy[e] * wf[j][e];
          o[e] = RMS ? (g - xhat * c2) * rs : (g - c1 - xhat * c2) * rs;
          aw[j][e] += fdy[e] * xhat;
          if (!RMS) ab[j][e] += fdy[e];
        }
        store8(dx + row * hidden + u * kUnit, o);
      }
    }
  }
  cp_async_wait<0>();

  // the block's partial row: its teams' sums added in team order
  float* pdw = part_dw + part * hidden;
  float* pdb = RMS ? nullptr : part_db + part * hidden;
  if (teams > 1) {
    __syncthreads();  // every team is done with the ring
    float* bw = reinterpret_cast<float*>(smem);
    float* bb = bw + teams * hidden;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int u = tt + j * stride;
      if (u < units) {
#pragma unroll
        for (int e = 0; e < kUnit; e += 4) {
          *reinterpret_cast<float4*>(bw + team * hidden + u * kUnit + e) =
              make_float4(aw[j][e], aw[j][e + 1], aw[j][e + 2], aw[j][e + 3]);
          if (!RMS)
            *reinterpret_cast<float4*>(bb + team * hidden + u * kUnit + e) =
                make_float4(ab[j][e], ab[j][e + 1], ab[j][e + 2],
                            ab[j][e + 3]);
        }
      }
    }
    __syncthreads();
    for (int c = tid * 4; c < hidden; c += nthreads * 4) {
      float4 sw = *reinterpret_cast<const float4*>(bw + c);
      float4 sb = RMS ? sw : *reinterpret_cast<const float4*>(bb + c);
      for (int k = 1; k < teams; ++k) {
        const float4 vw = *reinterpret_cast<const float4*>(bw + k * hidden + c);
        sw.x += vw.x; sw.y += vw.y; sw.z += vw.z; sw.w += vw.w;
        if (!RMS) {
          const float4 vb =
              *reinterpret_cast<const float4*>(bb + k * hidden + c);
          sb.x += vb.x; sb.y += vb.y; sb.z += vb.z; sb.w += vb.w;
        }
      }
      *reinterpret_cast<float4*>(pdw + c) = sw;
      if (!RMS) *reinterpret_cast<float4*>(pdb + c) = sb;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int u = tt + j * stride;
      if (u < units) {
#pragma unroll
        for (int e = 0; e < kUnit; e += 4) {
          *reinterpret_cast<float4*>(pdw + u * kUnit + e) =
              make_float4(aw[j][e], aw[j][e + 1], aw[j][e + 2], aw[j][e + 3]);
          if (!RMS)
            *reinterpret_cast<float4*>(pdb + u * kUnit + e) = make_float4(
                ab[j][e], ab[j][e + 1], ab[j][e + 2], ab[j][e + 3]);
        }
      }
    }
  }
  // no block leaves while another may still read its row sums
  if (cluster > 1) cg::this_cluster().sync();
}

// The final sum, launched as a programmatic dependent of the pass: block
// b takes columns [32 b, 32 b + 32), lane = column; warp s adds the parts
// [s * per, (s + 1) * per) in order (per = ceil(parts / 32): at most 8,
// every load in flight at once), and the 32 slice sums are combined in a
// fixed tree, slice s += slice s + w for w = 16, 8, 4, 2, 1, then written
// in the weight's type (db too unless null).
template <typename TW>
__global__ void __launch_bounds__(32 * kSlices)
    norm_bwd_sum_kernel(const float* __restrict__ part_dw,
                        const float* __restrict__ part_db,
                        TW* __restrict__ dw, TW* __restrict__ db, int parts,
                        int hidden) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float red[2][kSlices][33];
  const int lane = threadIdx.x % 32, sl = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const int per = (parts + kSlices - 1) / kSlices;
  const int p0 = sl * per, p1 = min(p0 + per, parts);
  float sw = 0.f, sb = 0.f;
  if (c < hidden) {
    for (int p = p0; p < p1; p += 8) {
      float vw[8], vb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long at = static_cast<long>(p + i) * hidden + c;
        vw[i] = p + i < p1 ? part_dw[at] : 0.f;
        vb[i] = p + i < p1 && part_db != nullptr ? part_db[at] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (p + i < p1) {
          sw += vw[i];
          sb += vb[i];
        }
      }
    }
  }
  red[0][sl][lane] = sw;
  red[1][sl][lane] = sb;
#pragma unroll
  for (int w = kSlices / 2; w > 0; w /= 2) {
    __syncthreads();
    if (sl < w) {
      red[0][sl][lane] += red[0][sl + w][lane];
      red[1][sl][lane] += red[1][sl + w][lane];
    }
  }
  __syncthreads();
  if (sl < 2 && c < hidden && (sl == 0 || part_db != nullptr))
    apex::from_f(red[sl][0][lane], (sl == 0 ? dw : db) + c);
}

// the pass's dynamic shared memory: the ring and the statistics, or the
// teams' sums at the end, whichever is larger
template <typename T, bool RMS>
int pass_smem_bytes(int threads, int V, int teams, int hidden) {
  const int S = kStages<T>, H = 8 / apex::Vec<T>::N;
  const int ring = S * 2 * V * H * threads * 16 + S * threads * 8;
  const int sums = teams > 1 ? (RMS ? 1 : 2) * teams * hidden * 4 : 0;
  return ring > sums ? ring : sums;
}

template <typename T, typename TW, bool RMS, int V>
cudaError_t launch_pass(const void* dy, const void* x, const void* mean,
                        const void* rstd, const void* w, void* dx,
                        float* part_dw, float* part_db, int rows, int hidden,
                        int parts, int rows_per_part, int cluster,
                        int team_warps, int teams, cudaStream_t s) {
  auto kernel = norm_bwd_pass_kernel<T, TW, RMS, V>;
  const int threads = teams * team_warps * 32;
  const int bytes = pass_smem_bytes<T, RMS>(threads, V, teams, hidden);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;  // a plain launch without a cluster
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const TW*>(w), static_cast<T*>(dx), part_dw, part_db, rows,
      hidden, rows_per_part, team_warps, teams, cluster);
}

template <typename T, typename TW, bool RMS>
int launch_bwd(const void* dy, const void* x, const void* mean,
               const void* rstd, const void* w, void* dx, void* dw, void* db,
               void* workspace, int rows, int hidden, int parts,
               int rows_per_part, int cluster, int team_warps, int teams,
               int chunks, cudaStream_t s) {
  // the plan's own rules (ops/layer_norm.py `_bwd_plan`)
  if (hidden % kUnit || rows < 0 || parts < 1 || rows_per_part < 1 ||
      static_cast<long>(parts) * rows_per_part < rows || cluster < 1 ||
      cluster > 8 || team_warps < 1 || teams < 1 ||
      teams * team_warps > 8 || (cluster > 1 && teams > 1) ||
      static_cast<long>(chunks) * cluster * team_warps * 32 * kUnit <
          hidden)
    return static_cast<int>(cudaErrorInvalidValue);
  float* part_dw = static_cast<float*>(workspace);
  float* part_db = RMS ? nullptr : part_dw + static_cast<long>(parts) * hidden;
  cudaError_t err;
  switch (chunks) {
#define APEX_PASS(V)                                                        \
  case V:                                                                   \
    err = launch_pass<T, TW, RMS, V>(dy, x, mean, rstd, w, dx, part_dw,     \
                                     part_db, rows, hidden, parts,          \
                                     rows_per_part, cluster, team_warps,    \
                                     teams, s);                             \
    break;
    APEX_PASS(1)
    APEX_PASS(2)
    APEX_PASS(3)
#undef APEX_PASS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // the ordered sum, launched while the pass runs (it waits for the pass's
  // grid inside)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((hidden + 31) / 32);
  cfg.blockDim = dim3(32 * kSlices);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, norm_bwd_sum_kernel<TW>, static_cast<const float*>(part_dw),
      static_cast<const float*>(part_db), static_cast<TW*>(dw),
      static_cast<TW*>(db), parts, hidden));
}

}  // namespace

// runs the call given with T (x's type) and TW (the weight's) bound: fp32
// x with an fp32 or bf16 weight, bf16 x with a bf16 or fp32 weight, fp16 x
// with an fp16 or fp32 weight (apex::kF32, kBF16, kF16 codes)
#define APEX_NORM_CASE(XC, WC, TX, TWX, ...)                          \
  if (x_type == XC && w_type == WC) {                                  \
    using T = TX; using TW = TWX; return __VA_ARGS__;                  \
  }
#define APEX_NORM_DISPATCH(...)                                        \
  do {                                                                 \
    using bf16 = __nv_bfloat16;                                        \
    APEX_NORM_CASE(apex::kF32, apex::kF32, float, float, __VA_ARGS__)  \
    APEX_NORM_CASE(apex::kF32, apex::kBF16, float, bf16, __VA_ARGS__)  \
    APEX_NORM_CASE(apex::kBF16, apex::kBF16, bf16, bf16, __VA_ARGS__)  \
    APEX_NORM_CASE(apex::kBF16, apex::kF32, bf16, float, __VA_ARGS__)  \
    APEX_NORM_CASE(apex::kF16, apex::kF16, __half, __half, __VA_ARGS__) \
    APEX_NORM_CASE(apex::kF16, apex::kF32, __half, float, __VA_ARGS__) \
    return static_cast<int>(cudaErrorInvalidValue);                    \
  } while (0)

// On CUDA device `device`, on `stream`:
// x, y: (rows, hidden) contiguous, T = x's type (x_type); w, b:
// (hidden,), TW = their type (w_type), a pair APEX_NORM_DISPATCH takes;
// 16-byte aligned, hidden % (16/sizeof(T)) == 0. mean, rstd: (rows,) fp32, or
// both null when the statistics are not needed. The geometry is
// ops/layer_norm.py `_fwd_plan(hidden)`'s: teams of `team_warps` warps,
// `teams` a block, `chunks` chunks of 8 columns a thread.
extern "C" int layer_norm_fwd(int device, const void* x, const void* w,
                              const void* b, void* y, void* mean, void* rstd,
                              int rows, int hidden, float eps,
                              int team_warps, int teams, int chunks,
                              int x_type, int w_type, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_NORM_DISPATCH(launch_fwd<T, TW, false>(x, w, b, y, mean, rstd, rows,
                                              hidden, eps, team_warps, teams,
                                              chunks, s));
}

// As layer_norm_fwd, without a bias; rstd: (rows,) fp32 or null.
extern "C" int rms_norm_fwd(int device, const void* x, const void* w,
                            void* y, void* rstd, int rows, int hidden,
                            float eps, int team_warps, int teams, int chunks,
                            int x_type, int w_type, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_NORM_DISPATCH(launch_fwd<T, TW, true>(x, w, nullptr, y, nullptr, rstd,
                                             rows, hidden, eps, team_warps,
                                             teams, chunks, s));
}

// dy, x, dx: (rows, hidden) of T; w, dw, db: (hidden,) of TW; 16-byte
// aligned, hidden % 8 == 0. mean, rstd: (rows,) fp32 from the forward.
// The geometry is ops/layer_norm.py `_bwd_plan(rows, hidden)`'s: `parts`
// parts of `rows_per_part` rows, each `cluster` blocks of `teams` teams of
// `team_warps` warps, `chunks` chunks of 8 columns a thread. workspace: 2
// * parts * hidden fp32 (the partial dw and db rows).
extern "C" int layer_norm_bwd(int device, const void* dy, const void* x,
                              const void* mean, const void* rstd,
                              const void* w, void* dx, void* dw, void* db,
                              void* workspace, int rows, int hidden,
                              int parts, int rows_per_part, int cluster,
                              int team_warps, int teams, int chunks,
                              int x_type, int w_type, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_NORM_DISPATCH(launch_bwd<T, TW, false>(
      dy, x, mean, rstd, w, dx, dw, db, workspace, rows, hidden, parts,
      rows_per_part, cluster, team_warps, teams, chunks, s));
}

// As layer_norm_bwd without mean, db and db's half of the workspace
// (parts * hidden fp32).
extern "C" int rms_norm_bwd(int device, const void* dy, const void* x,
                            const void* rstd, const void* w, void* dx,
                            void* dw, void* workspace, int rows, int hidden,
                            int parts, int rows_per_part, int cluster,
                            int team_warps, int teams, int chunks,
                            int x_type, int w_type, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  APEX_NORM_DISPATCH(launch_bwd<T, TW, true>(
      dy, x, nullptr, rstd, w, dx, dw, nullptr, workspace, rows, hidden,
      parts, rows_per_part, cluster, team_warps, teams, chunks, s));
}
