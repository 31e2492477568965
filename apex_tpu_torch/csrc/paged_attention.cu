// Paged attention on the CUDA cores, for Hopper (sm_90a): fp32 queries at
// head dim d % 8 == 0 up to 256 (`paged_attention_fwd`), and fp32, bf16 or
// fp16 queries at every d % 8 == 0 above 256 (`paged_wide_fwd`), over
// full-precision, int8 and int4 pools.
//
// Replaces, for fp32 queries, the TPU kernel apex_tpu/serve/decode.py
// `_paged_kernel` (reached through `_paged_pallas`, pallas_call at
// decode.py:228), for full-precision, int8 and int4 pools (its `quantized`
// / `kv_bits` branches, decode.py:146-151); bf16 and fp16 queries run on
// the tensor cores (paged_mma.cu). The tensor cores would take fp32 as
// TF32, which the fp32 gates (2e-5 a kernel, equal streams) would not
// survive.
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
// Design: the walk of paged_split.cuh, as paged_mma.cu's (its bodies,
// fp32_walk and wide_walk, in paged_walks.cuh). One owner block of 128
// threads per (context split, head, tile of up to 8 rows of one group: a
// prefill chunk's 32 rows make 4 tiles, so the chunk has enough blocks for
// the card), the splits merged in order by a second launch, counted once
// with this one. K/V tiles of 32 positions through a two-stage cp.async ring
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

// The wide walk (`paged_wide_fwd`, d > 256, fp32, bf16 or fp16 q). Neither
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

#include "paged_walks.cuh"

namespace {

using paged::Args;
using paged::Layout;

constexpr int kThreads = 128;
constexpr int kTP = paged::kFpTP;     // positions of a tile: one a lane
constexpr int kRows = paged::kFpRows;  // rows of a group a block takes

template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
    paged_fp32_kernel(const Args a, const Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  paged::let_merge_launch();
  paged::fp32_walk<D, MODE, kThreads>(a, L, blockIdx, smem);
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
// the wide walk: d > 256, fp32, bf16 or fp16 q, the head dim in chunks

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    paged_wide_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  paged::let_merge_launch();
  paged::wide_walk<T, T, MODE, kThreads>(a, blockIdx, smem);
}

template <typename T, int MODE>
cudaError_t launch_wide(const Args& a, cudaStream_t s) {
  paged_wide_kernel<T, MODE><<<paged::walk_grid(a, paged::kWideRows),
                               kThreads, paged::kWideSmemBytes, s>>>(a);
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
               splits, split_len, scale, rows_per_table};
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
// head dim goes in chunks), q and out of the type `dtype` names (common.cuh's
// code: 0 fp32, 1 bf16, 2 fp16), a full-precision pool in q's type.
extern "C" int paged_wide_fwd(int device, const void* q, const void* k_pool,
                              const void* v_pool, const void* k_scale,
                              const void* v_scale, const void* block_tables,
                              const void* ctx_lens, void* out, void* part,
                              int n, int heads, int head_dim,
                              int pool_blocks, int block_size,
                              int max_blocks, int kv_mode, int group,
                              int rows_per_table, int splits, int split_len,
                              float scale, int dtype, void* stream) {
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
               splits, split_len, scale, rows_per_table};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  APEX_TYPE_SWITCH(dtype, T, err = cudaErrorInvalidValue,
                   err = launch_wide_mode<T>(a, s));
  return static_cast<int>(err);
}
