#!/usr/bin/env python3
"""Split a checkout's fused-layer launch into its phases, on the card.

    python3 chip_megakernel_phases.py --root PATH [--work DIR] [--stream]

Copies the ``apex_tpu_torch`` package of the checkout at PATH (this repo,
or an unpacked earlier commit of it) into a scratch directory (``--work``,
by default a fresh temporary one), and in that copy only stamps
``%globaltimer`` from block 0 at the start of ``fused_layer_kernel``,
after each of its grid syncs and at its end (``csrc/megakernel.cu``: a
device array and one ``extern "C"`` reader added to the copy; the
checkout is not touched and carries no switch for it). The copy is built
and run at the megakernel phase's GPT-2-124M cases (this directory's
``chip_smoke.py``: decode 8 rows and verify 8 x 5, fp32 and bf16, fp and
int8 pools), 20 launches each with the L2 flushed before each, and one
JSON line a case gives the mean microseconds from each stamp to the next
(``phase_us``, keyed by the stamp's order: ``s1`` the first phase, ...),
the launch's event time (``event_ms``, one launch at a time: it includes
the launch) and the kernel's phase names as the source gives them where it
can (``phases``). ``--stream`` also builds and runs a streaming probe: one
256-thread block an SM pulling a GPT-2 layer's 14.2 MB of bf16 weights
through a cp.async ring of 4 KB stages (4, 8, 12 stages; contiguous, and as
a 16-column weight tile's 32-byte rows), the L2 flushed by a write before
each launch, printing GB/s. Then the card's name and power limit.
"""

import argparse
import ctypes
import importlib.util
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

STAMPS = r'''
__device__ unsigned long long g_phase_stamp[32];
__device__ __forceinline__ void phase_stamp(int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (i == 0)
      for (int j = 1; j < 32; ++j) g_phase_stamp[j] = 0;
    g_phase_stamp[i] = t;
  }
}
'''

READER = r'''
extern "C" int fused_layer_phase_stamps(void* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_phase_stamp, sizeof(g_phase_stamp)));
}
'''

STREAM = r'''
#include <cstdio>
#include <cuda_runtime.h>
__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
template <int STAGES, bool TILE>
__global__ void __launch_bounds__(256, 1)
    ring(const char* src, size_t per_block, int stride, float* sink) {
  extern __shared__ __align__(16) char sm[];
  const int tid = threadIdx.x;
  const size_t nst = per_block / 4096;
  const char* base = src + blockIdx.x * (TILE ? 32 : per_block);
  auto addr = [&](size_t st) -> const char* {
    if (TILE) return base + (st * 128 + tid / 2) * stride + (tid % 2) * 16;
    return base + st * 4096 + tid * 16;
  };
  auto copy = [&](size_t st) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     saddr(sm + (st % STAGES) * 4096 + tid * 16)),
                 "l"(addr(st)));
  };
  float acc = 0.f;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < static_cast<int>(nst)) copy(s);
    asm volatile("cp.async.commit_group;\n");
  }
  for (size_t s = 0; s < nst; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    if (s + STAGES - 1 < nst) copy(s + STAGES - 1);
    asm volatile("cp.async.commit_group;\n");
    acc += *reinterpret_cast<float*>(sm + (s % STAGES) * 4096 + tid * 16);
  }
  if (acc == 12345.f) *sink = acc;
}
template <int STAGES, bool TILE>
void run(const char* buf, char* flush, float* sink, size_t total) {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const size_t per = total / sms / 4096 * 4096;
  auto k = ring<STAGES, TILE>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       STAGES * 4096);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float sum = 0.f;
  const int n = 10;
  for (int i = 0; i < n + 2; ++i) {
    cudaMemset(flush, i, 64 << 20);
    cudaEventRecord(a);
    k<<<sms, 256, STAGES * 4096>>>(buf, per, 32 * sms, sink);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    if (i >= 2) sum += ms;
  }
  const double bytes = static_cast<double>(per) * sms, s = sum / n * 1e-3;
  printf("{\"stream\": \"%s\", \"stages\": %d, \"bytes\": %.0f, "
         "\"us\": %.2f, \"GB_per_s\": %.0f, \"GB_per_s_an_SM\": %.2f, "
         "\"error\": \"%s\"}\n",
         TILE ? "tile32B" : "contiguous", STAGES, bytes, s * 1e6,
         bytes / s / 1e9, bytes / s / 1e9 / sms,
         cudaGetErrorString(cudaGetLastError()));
}
int main() {
  char *buf, *flush;
  float* sink;
  cudaMalloc(&buf, 64 << 20);
  cudaMalloc(&flush, 64 << 20);
  cudaMalloc(&sink, 4);
  cudaMemset(buf, 1, 64 << 20);
  const size_t total = 14200000;  // one GPT-2 layer's bf16 weights
  run<4, false>(buf, flush, sink, total);
  run<8, false>(buf, flush, sink, total);
  run<12, false>(buf, flush, sink, total);
  run<12, true>(buf, flush, sink, total);
  return 0;
}
'''


def stamped_copy(root: pathlib.Path, work: pathlib.Path) -> list:
    """Copy the package into ``work`` with the stamps added to its fused
    kernel; returns the comments naming each phase, in source order."""
    shutil.copytree(root / "apex_tpu_torch", work / "apex_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = work / "apex_tpu_torch" / "csrc" / "megakernel.cu"
    src = path.read_text()
    src = src.replace("namespace cg = cooperative_groups;\n",
                      "namespace cg = cooperative_groups;\n" + STAMPS, 1)
    start = src.index("fused_layer_kernel(const Args a")
    body_end = src.index("cudaError_t launch_", start)
    body = src[start:body_end]
    opened = body.index("{") + 1
    body = body[:opened] + "\n  phase_stamp(0);" + body[opened:]
    count = [0]

    def stamp(match):
        count[0] += 1
        return f"{match.group(0)}\n  phase_stamp({count[0]});"

    body = re.sub(r"grid_sync\(grid\);", stamp, body)
    close = body.rstrip().rfind("}", 0, body.rstrip().rfind("template"))
    body = body[:close] + "  __syncthreads();\n  phase_stamp(31);\n" + \
        body[close:]
    names = re.findall(r"\n  // (\d+b?)\. ([^\n]*)", body)
    path.write_text(src[:start] + body + src[body_end:] + READER)
    return [f"{n}. {t}" for n, t in names]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--work")
    ap.add_argument("--stream", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_megakernel_phases: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    work = pathlib.Path(args.work or tempfile.mkdtemp()).resolve()
    work.mkdir(parents=True, exist_ok=True)
    shutil.rmtree(work / "apex_tpu_torch", ignore_errors=True)
    names = stamped_copy(root, work)
    sys.path.insert(0, str(work))
    here = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  here / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from apex_tpu_torch.ops import _kernel_util as ku
    from apex_tpu_torch.serve import megakernel as mk

    dev = torch.device("cuda", 0)
    lib = ku.load_kernel("megakernel", mk._SIGNATURES)
    lib.fused_layer_phase_stamps.argtypes = [ctypes.c_void_p]
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    for dname in ("bfloat16", "float32"):
        for mode in ("none", "int8"):
            for what, q in (("decode", 1), ("verify", 5)):
                cfg, kv, lp, layer, x, bt, start, n_fed, active = \
                    cs.megakernel_case(torch, dev, getattr(torch, dname),
                                       mode, q)
                nv = None if q == 1 else n_fed
                acc, total, iters = {}, 0.0, 20
                for it in range(iters + 3):
                    flush.zero_()
                    torch.cuda.synchronize()
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    mk.fused_layer_fwd(x, lp, layer, cfg, kv, bt, start, nv,
                                       active)
                    b.record()
                    torch.cuda.synchronize()
                    buf = (ctypes.c_ulonglong * 32)()
                    status = lib.fused_layer_phase_stamps(
                        ctypes.addressof(buf))
                    ku.check_status(lib, status, "phase stamps")
                    if it < 3:
                        continue
                    total += a.elapsed_time(b)
                    ids = [i for i in range(32) if buf[i]]
                    for k, (i, j) in enumerate(zip(ids, ids[1:])):
                        key = f"s{k + 1}"
                        acc[key] = acc.get(key, 0.0) + (buf[j] - buf[i]) / 1e3
                print(json.dumps({
                    "root": args.root, "case": what, "dtype": dname,
                    "kv": mode, "event_ms": total / iters,
                    "phase_us": {k: v / iters for k, v in acc.items()},
                    "phases": names}), flush=True)
                del layer, lp, x
    if args.stream:
        src = work / "stream_probe.cu"
        src.write_text(STREAM)
        exe = work / "stream_probe"
        subprocess.run([ku.nvcc_path(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-o",
                        str(exe), str(src)], check=True, capture_output=True)
        print(subprocess.run([str(exe)], check=True, capture_output=True,
                             text=True).stdout, end="", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
