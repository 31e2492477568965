// The Adam / LAMB update tail of one parameter leaf, for Hopper (sm_90a).
//
// Replaces the TPU kernel of apex_tpu/ops/fused_update.py: `_tail_kernel`
// (reached through `_tail_pallas`, pallas_call at :160), in both decay modes
// and with the LAMB sums (`with_norms`).
//
// Math, exactly the JAX kernel's, in fp32 with IEEE division and square
// root (the `__f*_rn` intrinsics also keep nvcc from contracting a multiply
// and an add into one FMA, so the rounding is the plain op chain's):
//   g += wd * p                          (L2 mode: adam_w == 0 and wd != 0)
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   u  = (m' / c1) / (sqrt(v' / c2) + eps)
//   u += wd * p                          (decoupled: adam_w and wd != 0)
// g and p are read in their own type (fp32, bf16 or fp16), m and v in fp32; u
// is written in fp32 and m', v' overwrite m and v in place. The constants (1 -
// b1), (1 - b2), c1 and c2 come from the host as fp32.
//
// Two optional device pointers keep a step on the card (JAX's always
// capturable FusedAdam, and amp's overflow guard): `corr` holds (c1, c2),
// computed on the card from a device step count, in place of the host's
// values; `found_inf` is an fp32 flag: when it is nonzero the kernel leaves
// m and v unwritten and writes u = 0 (and LAMB sums of 0), so the caller's
// p + (-lr * u) leaves p as it was. Null pointers are the host path.
//
// Bound on this card: bytes. Per element it reads g, p, m, v and writes u,
// m', v': 24 bytes with bf16 g and p, so GPT-2-124M's 124,475,904 elements
// need 2.99 GB, 0.892 ms at 3.35 TB/s; the arithmetic is a few flops.
//
// Design: one pass per leaf, a grid-stride loop over the flat leaf, no
// padding (the loop bound masks the tail). The TPU kernel summed the LAMB
// norms across its sequential grid into one (1, 1) block; here each block
// writes its partial sum of p^2 and u^2 (a fixed-order block reduction over
// a grid that depends on the element count alone), and a second launch of
// one block sums the partials in order: the sums repeat bitwise, no atomics.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1056;  // 8 blocks on each of the 132 SMs

struct Adam {
  float b1, omb1, b2, omb2, eps, wd, c1, c2;
  int adam_w;
};

template <typename TG, typename TP, bool kNorms>
__global__ void __launch_bounds__(kThreads)
    adam_tail_kernel(const TG* __restrict__ g, const TP* __restrict__ p,
                     float* __restrict__ m, float* __restrict__ v,
                     float* __restrict__ u, long long n, Adam a,
                     float* __restrict__ wsq_part,
                     float* __restrict__ usq_part,
                     const float* __restrict__ corr,
                     const float* __restrict__ found_inf) {
  __shared__ float red[kThreads / 32];
  float wsq = 0.f, usq = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (found_inf != nullptr && *found_inf != 0.f) {
    // a skipped step: m and v stay, u = 0, the LAMB partials 0
    for (long long i = first; i < n; i += stride) u[i] = 0.f;
    if (kNorms && threadIdx.x == 0) {
      wsq_part[blockIdx.x] = 0.f;
      usq_part[blockIdx.x] = 0.f;
    }
    return;
  }
  const float c1 = corr != nullptr ? corr[0] : a.c1;
  const float c2 = corr != nullptr ? corr[1] : a.c2;
  for (long long i = first; i < n; i += stride) {
    float gi = apex::to_f(g[i]);
    const float pi = apex::to_f(p[i]);
    if (!a.adam_w && a.wd != 0.f) gi = __fadd_rn(gi, __fmul_rn(a.wd, pi));
    const float mi = __fadd_rn(__fmul_rn(a.b1, m[i]), __fmul_rn(a.omb1, gi));
    const float vi = __fadd_rn(__fmul_rn(a.b2, v[i]),
                               __fmul_rn(__fmul_rn(a.omb2, gi), gi));
    float ui = __fdiv_rn(__fdiv_rn(mi, c1),
                         __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, c2)), a.eps));
    if (a.adam_w && a.wd != 0.f) ui = __fadd_rn(ui, __fmul_rn(a.wd, pi));
    m[i] = mi;
    v[i] = vi;
    u[i] = ui;
    if (kNorms) {
      wsq = __fadd_rn(wsq, __fmul_rn(pi, pi));
      usq = __fadd_rn(usq, __fmul_rn(ui, ui));
    }
  }
  if (kNorms) {
    wsq = apex::block_sum<kThreads / 32>(wsq, red);
    usq = apex::block_sum<kThreads / 32>(usq, red);
    if (threadIdx.x == 0) {
      wsq_part[blockIdx.x] = wsq;
      usq_part[blockIdx.x] = usq;
    }
  }
}

// One block: sums[0] = sum of wsq_part, sums[1] = sum of usq_part, each
// thread over a fixed strided subset, then the fixed-order block reduction.
__global__ void __launch_bounds__(kThreads)
    sum_parts_kernel(const float* __restrict__ wsq_part,
                     const float* __restrict__ usq_part, int parts,
                     float* __restrict__ sums) {
  __shared__ float red[kThreads / 32];
  float w = 0.f, s = 0.f;
  for (int i = threadIdx.x; i < parts; i += kThreads) {
    w += wsq_part[i];
    s += usq_part[i];
  }
  w = apex::block_sum<kThreads / 32>(w, red);
  s = apex::block_sum<kThreads / 32>(s, red);
  if (threadIdx.x == 0) {
    sums[0] = w;
    sums[1] = s;
  }
}

template <typename TG, typename TP>
void launch(const void* g, const void* p, void* m, void* v, void* u,
            long long n, const Adam& a, void* wsq_part, void* usq_part,
            void* sums, const float* corr, const float* found_inf,
            int blocks, cudaStream_t s) {
  if (wsq_part == nullptr) {
    adam_tail_kernel<TG, TP, false><<<blocks, kThreads, 0, s>>>(
        static_cast<const TG*>(g), static_cast<const TP*>(p),
        static_cast<float*>(m), static_cast<float*>(v),
        static_cast<float*>(u), n, a, nullptr, nullptr, corr, found_inf);
    return;
  }
  adam_tail_kernel<TG, TP, true><<<blocks, kThreads, 0, s>>>(
      static_cast<const TG*>(g), static_cast<const TP*>(p),
      static_cast<float*>(m), static_cast<float*>(v), static_cast<float*>(u),
      n, a, static_cast<float*>(wsq_part), static_cast<float*>(usq_part),
      corr, found_inf);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  sum_parts_kernel<<<1, kThreads, 0, s>>>(
      static_cast<const float*>(wsq_part),
      static_cast<const float*>(usq_part), blocks,
      static_cast<float*>(sums));
}

}  // namespace

// Blocks of the first launch for n elements: a function of n alone, so the
// LAMB partial sums (and their in-order total) repeat bitwise.
extern "C" int fused_update_blocks(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < 1 ? 1 : (want > kMaxBlocks ? kMaxBlocks
                                                            : want));
}

// On CUDA device `device`, on `stream`. g, p: n elements of fp32, bf16 or fp16
// (g_type, p_type: 0, 1 or 2); m, v, u: n fp32, m and v updated in place; all
// contiguous. With wsq_part non-null (LAMB): wsq_part and usq_part hold
// fused_update_blocks(n) floats each, and sums[0], sums[1] receive the sums of
// p^2 and u^2. corr (2 fp32: c1, c2, read in place of the c1 and c2 arguments)
// and found_inf (1 fp32) are device pointers or null.
extern "C" int fused_adam_tail(int device, const void* g, const void* p,
                               void* m, void* v, void* u, long long n,
                               float b1, float omb1, float b2, float omb2,
                               float eps, float wd, int adam_w, float c1,
                               float c2, int g_type, int p_type,
                               void* wsq_part, void* usq_part, void* sums,
                               const void* corr, const void* found_inf,
                               void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Adam a{b1, omb1, b2, omb2, eps, wd, c1, c2, adam_w};
  const int blocks = fused_update_blocks(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cr = static_cast<const float*>(corr);
  const float* fi = static_cast<const float*>(found_inf);
  constexpr int bad = static_cast<int>(cudaErrorInvalidValue);
  APEX_TYPE_SWITCH(g_type, TG, return bad,
                   APEX_TYPE_SWITCH(p_type, TP, return bad,
                                    launch<TG, TP>(g, p, m, v, u, n, a,
                                                   wsq_part, usq_part, sums,
                                                   cr, fi, blocks, s)));
  return static_cast<int>(cudaGetLastError());
}
