// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel apex_tpu/serve/decode.py `_paged_kernel`
// (reached through `_paged_pallas`, pallas_call at decode.py:228), for
// full-precision pools (the int8/int4 dequant branches come with the
// quantized KV cache).
//
// Computes, per row n and head h: softmax(q . K^T * scale) V over the
// first ctx_lens[n] positions of the row's paged context, where position t
// lives in pool block block_tables[n, t / bs] at offset t % bs. Scores are
// fp32, positions >= ctx are masked with NEG_INF, the softmax is online
// (running max, running sum, fp32 accumulator), and a row with ctx == 0
// writes zeros (decode.py:172-174).
//
// Bound on this card: device memory. Every live K and V vector is read
// once: sum(ctx) * H * D * 2 * sizeof(T) bytes over 3.35 TB/s; the
// arithmetic is 4 operations per K/V element pair.
//
// Design (simple first):
// * One 128-thread block per (head, row). The block reads its own
//   block-table row and context length and loops over tiles of
//   NT = 4096 / D positions up to ctx only. That loop takes the place of
//   the TPU's scalar prefetch, its dead-block clamp (decode.py:185-189)
//   and its `pl.when(j * bs < ctx)` skip (decode.py:141).
// * Each tile of K and V is copied to shared memory as fp32 with 16-byte
//   coalesced loads (one pool block of bs positions is contiguous), rows
//   padded to D + 1 floats so the per-position dot products hit distinct
//   banks.
// * Thread i < NT scores position i of the tile; block reductions give the
//   tile max and the sum of p; thread (part, d) accumulates output dim d
//   over the positions of its part, and the parts are summed at the end.
// * p stays fp32 (the TPU cast p to the pool type for its matrix unit).
// * Rows are flat (slots * q), so the decode, verify and prefill-chunk
//   programs all launch this one kernel.
// Later work: TMA, split-K over the context, wgmma.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_fwd_kernel(
    const T* __restrict__ q,               // (N, H, D)
    const T* __restrict__ k_pool,          // (H, B, bs, D)
    const T* __restrict__ v_pool,          // (H, B, bs, D)
    const int* __restrict__ block_tables,  // (N, mb)
    const int* __restrict__ ctx_lens,      // (N,)
    T* __restrict__ out,                   // (N, H, D)
    int heads, int pool_blocks, int bs, int mb, float scale) {
  constexpr int NT = 4096 / D;       // positions per tile
  constexpr int VEC = apex::Vec<T>::N;
  constexpr int CPR = D / VEC;       // 16-byte chunks per K/V vector
  constexpr int LD = D + 1;          // padded shared-memory row
  constexpr int PARTS = kThreads / D;
  static_assert(NT <= kThreads && kThreads % D == 0 && D % VEC == 0, "D");

  __shared__ float qs[D];
  __shared__ float ks[NT * LD];
  __shared__ float vs[NT * LD];
  __shared__ float ps[NT];
  __shared__ float red[kThreads / 32];
  __shared__ float part_acc[kThreads];

  const int h = blockIdx.x;
  const long n = blockIdx.y;
  const int tid = threadIdx.x;
  // a context past the row's blocks attends to the blocks it has (the
  // gathered reference's mask covers exactly mb * bs positions)
  const int ctx = min(max(ctx_lens[n], 0), mb * bs);
  const int* bt = block_tables + n * mb;
  const long head_off = static_cast<long>(h) * pool_blocks * bs * D;
  const T* qr = q + (n * heads + h) * D;
  for (int d = tid; d < D; d += kThreads) qs[d] = apex::to_f(qr[d]);

  const int d_own = tid % D, part = tid / D;
  float m = apex::kNegInf, l = 0.f, acc = 0.f;
  for (int t0 = 0; t0 < ctx; t0 += NT) {
    __syncthreads();  // q staged; the previous tile fully consumed
    for (int c = tid; c < NT * CPR; c += kThreads) {
      const int i = c / CPR, d0 = (c % CPR) * VEC;
      const int t = t0 + i;
      float fk[VEC], fv[VEC];
      if (t < ctx) {
        const long off =
            head_off + (static_cast<long>(bt[t / bs]) * bs + t % bs) * D + d0;
        apex::load_vec(k_pool + off, fk);
        apex::load_vec(v_pool + off, fv);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) fk[j] = fv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ks[i * LD + d0 + j] = fk[j];
        vs[i * LD + d0 + j] = fv[j];
      }
    }
    __syncthreads();

    float s = apex::kNegInf;
    if (tid < NT && t0 + tid < ctx) {
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += qs[d] * ks[tid * LD + d];
      s = dot * scale;
    }
    const float m_new = fmaxf(m, apex::block_max<kThreads / 32>(s, red));
    const float corr = expf(m - m_new);
    float p = 0.f;
    if (tid < NT) {
      p = expf(s - m_new);  // masked: exp(-1e30 - m_new) == 0
      ps[tid] = p;
    }
    // block_sum's barriers also publish ps to every thread
    l = corr * l + apex::block_sum<kThreads / 32>(p, red);
    m = m_new;
    acc *= corr;
    for (int i = part; i < NT; i += PARTS) acc += ps[i] * vs[i * LD + d_own];
  }

  __syncthreads();
  part_acc[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float a = 0.f;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) a += part_acc[p * D + tid];
    apex::from_f(l == 0.f ? 0.f : a / l, &out[(n * heads + h) * D + tid]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* block_tables, const int* ctx_lens, void* out,
                   int n, int heads, int head_dim, int pool_blocks, int bs,
                   int mb, float scale, cudaStream_t stream) {
  const dim3 grid(heads, n), block(kThreads);
#define APEX_PAGED_CASE(DIM)                                                 \
  case DIM:                                                                  \
    paged_attention_fwd_kernel<T, DIM><<<grid, block, 0, stream>>>(          \
        static_cast<const T*>(q), static_cast<const T*>(k_pool),             \
        static_cast<const T*>(v_pool), block_tables, ctx_lens,               \
        static_cast<T*>(out), heads, pool_blocks, bs, mb, scale);            \
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

}  // namespace

// On CUDA device `device`, on `stream`:
// q, out: (n, heads, head_dim); k_pool, v_pool: (heads, pool_blocks, bs,
// head_dim), one layer, same type as q (is_bf16 ? bf16 : fp32), 16-byte
// aligned; block_tables: (n, mb) int32 of ids < pool_blocks; ctx_lens:
// (n,) int32. head_dim in {32, 64, 128}; n <= 65535.
extern "C" int paged_attention_fwd(int device, const void* q,
                                   const void* k_pool,
                                   const void* v_pool,
                                   const void* block_tables,
                                   const void* ctx_lens, void* out, int n,
                                   int heads, int head_dim, int pool_blocks,
                                   int block_size, int max_blocks, float scale,
                                   int is_bf16, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(ctx_lens);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k_pool, v_pool, bt, lens, out, n,
                                      heads, head_dim, pool_blocks,
                                      block_size, max_blocks, scale, s)
              : launch<float>(q, k_pool, v_pool, bt, lens, out, n, heads,
                              head_dim, pool_blocks, block_size, max_blocks,
                              scale, s);
  return static_cast<int>(err);
}
