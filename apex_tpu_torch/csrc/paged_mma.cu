// Paged attention on the tensor cores, bf16 or fp16 (E below), head dim
// d % 8 == 0 up to 256, full-precision, int8 and int4 pools, for Hopper
// (sm_90a).
//
// Replaces, for bf16 and fp16 queries, the TPU kernel
// apex_tpu/serve/decode.py `_paged_kernel` (reached through
// `_paged_pallas`, pallas_call at decode.py:228). Per flat row n and head h: softmax(q . K^T * scale) V
// over the row's first ctx[n] positions, position t in pool block
// block_tables[n, t / bs] at offset t % bs; fp32 scores, positions >= ctx
// masked, an online softmax, zeros where ctx == 0, a ctx past the row's
// blocks attending to the blocks it has. JAX's kernel forms the scores and
// P V as dots with fp32 results; so does this one, with mma.sync.m16n8k16
// (flash_mma.cuh). JAX rounds p to the pool type before P V
// (`p.astype(v.dtype)`); the plain version keeps it fp32, and one bf16
// rounding of a dominant p moves o by 2^-9 |v|, past the bf16 gate (atol
// 1e-3), so p enters P V as two E terms, hi = round(p) and lo = round(p -
// hi): about 16 bits of p in bf16 (22 in fp16, where one rounding alone
// would stay inside the gate) for twice the P V products; one code path
// for both types. int8 / int4 codes are dequantized to E in shared memory,
// the plain version's gather into the model dtype (paged_split.cuh).
//
// Bound on this card: device memory. Every live K and V vector is read
// once per group of rows sharing a block table: sum over groups of the
// group's largest ctx * H * d * 2 * elem_bytes (2; 1 + 4/d int8; 0.5 +
// 2/group int4) + q and o over 3.35 TB/s; the products are 4 * sum(ctx) *
// H * d operations.
//
// Design. The walk of paged_split.cuh (its body, mma_walk, is in
// paged_walks.cuh, shared with the fused layer): one owner block per
// (context split, head, tile of up to 32 rows of one group), the splits
// merged in order by a second launch, counted once with this one. So 8
// decode rows x 12 heads give 96 * (live splits) blocks, where one block per
// (row, head) gave 96 on 132 SMs, and a prefill chunk's 32 rows read the
// slot's K/V once, not 32 times. Inside a block, K/V tiles of 64 positions
// arrive through a two-stage cp.async ring (codes and scales for quantized
// pools, dequantized into one E tile after they land, each warp's 16
// positions by the warps that read them, behind their own barrier). Layout:
// rows on M, positions on N, as flash_mma.cu's forward: S = Q K^T, then O +=
// P V with S's C fragments as P's A operand and V through ldmatrix.trans, so
// nothing moves between lanes or through shared memory between the two
// products. A 16-row tile wastes 15/16 of the products at q = 1 and 11/16 at
// q = 5, against 7/8 with positions on M, but the kernel is bound by its
// bytes by two orders of magnitude, and this layout reuses the forward's
// fragments unchanged. The 32 rows of a tile are two 16-row halves; each
// half has four warps, warp w taking positions [16w, 16w + 16) of every tile
// with its own (m, l, acc), the four merged in slice order through shared
// memory at the end. A launch runs 128 threads when its groups have at most
// 16 rows, 256 otherwise: one code path for every group size, the thread
// count only deciding whether the second half has warps. D is padded to the
// next 16 (zeros in shared memory) for the mma depth; the instantiations are
// D = 32, 64, 128 and 256, and the products stop at the true d rounded up to
// 16. Masks by value (p = 0 at a dead position, so a tile past a row's
// context leaves its state as it was), loads from clamped addresses, no
// atomics: a row's bits are the same whatever its group size and whatever
// else is in the launch, and over repeated launches.
//
// Shared memory (D = 256): q 16.5 KB; full-precision K and V, two stages,
// 132 KB; quantized: one E stage of K and V 66 KB + two stages of codes
// (int8 64 KB, int4 32 KB) and scales.

#include "paged_walks.cuh"

namespace {

using paged::Args;
using paged::Layout;

template <int D, int MODE, typename E>
__global__ void __launch_bounds__(256)
    paged_mma_kernel(const Args a, const Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  paged::let_merge_launch();
  paged::mma_walk<D, MODE, false, 2, E>(a, L, blockIdx, smem);
}

template <int D, int MODE, typename E>
cudaError_t launch_walk(const Args& a, cudaStream_t s) {
  // code rows laid out for the instantiated D (a narrower d fills part of
  // each), scale rows for the true d
  const Layout L = paged::make_layout(
      paged::kMaxRows * kStride<D> * 2, kB * kStride<D> * 2, kB, MODE,
      paged::code_row_bytes(MODE, D),
      MODE == 0 ? 0 : paged::scale_row_bytes(MODE, a.d, a.group));
  auto kernel = paged_mma_kernel<D, MODE, E>;
  cudaError_t err = paged::allow_dynamic_smem(kernel, L.bytes);
  if (err != cudaSuccess) return err;
  const int threads = a.g > 16 ? 256 : 128;  // a second half of rows
  kernel<<<paged::walk_grid(a, paged::kMaxRows), threads, L.bytes, s>>>(a,
                                                                        L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return paged::launch_merge<E>(a, s);
}

template <int MODE, typename E>
cudaError_t launch_mode(const Args& a, cudaStream_t s) {
  switch (paged::paged_head_dim(a.d)) {
    case 32: return launch_walk<32, MODE, E>(a, s);
    case 64: return launch_walk<64, MODE, E>(a, s);
    case 128: return launch_walk<128, MODE, E>(a, s);
    case 256: return launch_walk<256, MODE, E>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename E>
cudaError_t launch_type(const Args& a, cudaStream_t s) {
  switch (a.mode) {
    case 0: return launch_mode<0, E>(a, s);
    case 1: return launch_mode<1, E>(a, s);
    case 2: return launch_mode<2, E>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// On CUDA device `device`, on `stream`:
// q, out: (n, heads, head_dim) of the type `dtype` names (common.cuh's
// code: 1 bf16, 2 fp16), 16-byte aligned. One layer's pools, pool_blocks
// blocks of block_size tokens:
//   kv_mode 0: k_pool, v_pool (heads, pool_blocks, bs, head_dim) in q's
//              type;
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
extern "C" int paged_mma_fwd(int device, const void* q, const void* k_pool,
                             const void* v_pool, const void* k_scale,
                             const void* v_scale, const void* block_tables,
                             const void* ctx_lens, void* out, void* part,
                             int n, int heads, int head_dim,
                             int pool_blocks, int block_size, int max_blocks,
                             int kv_mode, int group, int rows_per_table,
                             int splits, int split_len, float scale,
                             int dtype, void* stream) {
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
  switch (dtype) {
    case apex::kBF16: err = launch_type<__nv_bfloat16>(a, s); break;
    case apex::kF16: err = launch_type<__half>(a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
