// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel apex_tpu/serve/decode.py `_paged_kernel`
// (reached through `_paged_pallas`, pallas_call at decode.py:228), for
// full-precision, int8 and int4 pools (its `quantized` / `kv_bits`
// branches, decode.py:146-151).
//
// Computes, per row n and head h: softmax(q . K^T * scale) V over the
// first ctx_lens[n] positions of the row's paged context, where position t
// lives in pool block block_tables[n, t / bs] at offset t % bs. Scores are
// fp32, positions >= ctx are masked with NEG_INF, the softmax is online
// (running max, running sum, fp32 accumulator), and a row with ctx == 0
// writes zeros (decode.py:172-174). Quantized pools are dequantized (code x
// scale, fp32) into the same fp32 shared-memory tile the full-precision
// pools fill (paged_attend.cuh).
//
// Bound on this card: device memory. Every live K and V vector is read
// once: sum(ctx) * H * D * 2 * elem_bytes over 3.35 TB/s, with elem_bytes
// sizeof(T), 1 + 4/D (int8 + fp32 scale) or 0.5 + 2/group (int4 + bf16
// group scale); the arithmetic is 4 operations per K/V element pair.
//
// Design (simple first):
// * One 128-thread block per (head, row). The block reads its own
//   block-table row and context length and walks tiles of NT = 4096 / D
//   positions up to ctx only (paged_attend.cuh). That loop takes the place
//   of the TPU's scalar prefetch, its dead-block clamp (decode.py:185-189)
//   and its `pl.when(j * bs < ctx)` skip (decode.py:141).
// * p stays fp32 (the TPU cast p to the pool type for its matrix unit).
// * Rows are flat (slots * q), so the decode, verify and prefill-chunk
//   programs all launch this one kernel.
// Later work: TMA, split-K over the context, wgmma.

#include "paged_attend.cuh"

namespace {

constexpr int kThreads = 128;

template <typename Q, typename Pool, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_fwd_kernel(
    const Q* __restrict__ q,               // (N, H, D)
    const Pool kp, const Pool vp,          // one layer's pools
    const int* __restrict__ block_tables,  // (N, mb)
    const int* __restrict__ ctx_lens,      // (N,)
    Q* __restrict__ out,                   // (N, H, D)
    int heads, int pool_blocks, int bs, int mb, float scale) {
  __shared__ float qs[D];
  __shared__ float smem[apex::AttendSmem<kThreads, D>::kFloats];
  const int h = blockIdx.x;
  const long n = blockIdx.y;
  const int tid = threadIdx.x;
  // a context past the row's blocks attends to the blocks it has (the
  // gathered reference's mask covers exactly mb * bs positions)
  const int ctx = min(max(ctx_lens[n], 0), mb * bs);
  const Q* qr = q + (n * heads + h) * D;
  for (int d = tid; d < D; d += kThreads) qs[d] = apex::to_f(qr[d]);
  const float o = apex::attend_row<kThreads, D>(
      qs, kp, vp, block_tables + n * mb, ctx,
      static_cast<long>(h) * pool_blocks * bs, bs, scale, smem);
  if (tid < D) apex::from_f(o, &out[(n * heads + h) * D + tid]);
}

template <typename Q, typename Pool>
cudaError_t launch_pool(const Q* q, const Pool& kp, const Pool& vp,
                        const int* block_tables, const int* ctx_lens, Q* out,
                        int n, int heads, int head_dim, int pool_blocks,
                        int bs, int mb, float scale, cudaStream_t stream) {
  const dim3 grid(heads, n), block(kThreads);
#define APEX_PAGED_CASE(DIM)                                                 \
  case DIM:                                                                  \
    paged_attention_fwd_kernel<Q, Pool, DIM><<<grid, block, 0, stream>>>(    \
        q, kp, vp, block_tables, ctx_lens, out, heads, pool_blocks, bs, mb,  \
        scale);                                                              \
    break;
  switch (head_dim) {
    APEX_PAGED_CASE(32)
    APEX_PAGED_CASE(64)
    APEX_PAGED_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef APEX_PAGED_CASE
  return cudaGetLastError();
}

template <typename Q>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const int* block_tables, const int* ctx_lens, void* out,
                   int n, int heads, int head_dim, int pool_blocks, int bs,
                   int mb, int kv_mode, int group, float scale,
                   cudaStream_t s) {
  const Q* qp = static_cast<const Q*>(q);
  Q* op = static_cast<Q*>(out);
  switch (kv_mode) {
    case 0: {
      const apex::FpPool<Q, false> kp{static_cast<const Q*>(k_pool)};
      const apex::FpPool<Q, false> vp{static_cast<const Q*>(v_pool)};
      return launch_pool(qp, kp, vp, block_tables, ctx_lens, op, n, heads,
                         head_dim, pool_blocks, bs, mb, scale, s);
    }
    case 1: {
      const apex::Int8Pool<false> kp{static_cast<const int8_t*>(k_pool),
                                     static_cast<const float*>(k_scale)};
      const apex::Int8Pool<false> vp{static_cast<const int8_t*>(v_pool),
                                     static_cast<const float*>(v_scale)};
      return launch_pool(qp, kp, vp, block_tables, ctx_lens, op, n, heads,
                         head_dim, pool_blocks, bs, mb, scale, s);
    }
    case 2: {
      const apex::Int4Pool<false> kp{
          static_cast<const uint8_t*>(k_pool),
          static_cast<const __nv_bfloat16*>(k_scale), group};
      const apex::Int4Pool<false> vp{
          static_cast<const uint8_t*>(v_pool),
          static_cast<const __nv_bfloat16*>(v_scale), group};
      return launch_pool(qp, kp, vp, block_tables, ctx_lens, op, n, heads,
                         head_dim, pool_blocks, bs, mb, scale, s);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// On CUDA device `device`, on `stream`:
// q, out: (n, heads, head_dim) of q's type (is_bf16 ? bf16 : fp32), 16-byte
// aligned. One layer's pools, pool_blocks blocks of block_size tokens:
//   kv_mode 0: k_pool, v_pool (heads, pool_blocks, bs, head_dim) of q's
//              type; k_scale, v_scale unused;
//   kv_mode 1: int8 codes of that shape + fp32 scales (heads, pool_blocks,
//              bs);
//   kv_mode 2: uint8 nibble pairs (heads, pool_blocks, bs, head_dim / 2) +
//              bf16 scales (heads, pool_blocks, bs, head_dim / group).
// block_tables: (n, max_blocks) int32 of ids < pool_blocks; ctx_lens: (n,)
// int32. head_dim in {32, 64, 128}; n <= 65535.
extern "C" int paged_attention_fwd(int device, const void* q,
                                   const void* k_pool, const void* v_pool,
                                   const void* k_scale, const void* v_scale,
                                   const void* block_tables,
                                   const void* ctx_lens, void* out, int n,
                                   int heads, int head_dim, int pool_blocks,
                                   int block_size, int max_blocks,
                                   int kv_mode, int group, float scale,
                                   int is_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(ctx_lens);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                      bt, lens, out, n, heads, head_dim,
                                      pool_blocks, block_size, max_blocks,
                                      kv_mode, group, scale, s)
              : launch<float>(q, k_pool, v_pool, k_scale, v_scale, bt, lens,
                              out, n, heads, head_dim, pool_blocks,
                              block_size, max_blocks, kv_mode, group, scale,
                              s);
  return static_cast<int>(err);
}
