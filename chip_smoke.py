#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

1. Builds every kernel of the serving path from ``apex_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all at once).
2. Kernel phase: each kernel against its plain PyTorch version on the card
   at the serving path's shapes, fp32 and bf16, with the tolerance stated;
   times of kernel, plain version and the nearest library call
   (``F.layer_norm``; SDPA over pre-gathered K/V), and each kernel's bound.
3. Engine phase: GPT-2-124M at full width (random weights from a numpy
   seed), ``ServeConfig(num_slots=8, prefill_chunk=32)``, 16 requests of
   64-512 prompt tokens (several sharing a 64-token prefix, one exactly
   that prefix) generating 32 tokens greedily:
   * fp32 through the kernels vs fp32 with the plain versions forced:
     equal streams, and logits that agree on a small input;
   * bf16 with ``spec_k=0`` (the main path: launch counts are reset just
     before it and read just after) and with ``spec_k=4``: equal streams;
   * where a steady-state bf16 step's time goes (torch.profiler): the
     card's busy share and the top kernels.
4. Prints a detail line, the card's ``nvidia-smi`` name and power limit,
   the ``{"kernels": [...]}`` line, and last
   ``{"ok": true, "device": {...}}``. Any failed phase raises: the exit
   code is then nonzero and the last line is not printed.

Needs one CUDA device and ``nvcc``; exits nonzero without printing a result
when CUDA is absent or the package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
KERNEL_ITERS = 50
SLEEP_CYCLES_PER_S = 2.0e9         # above the H100's SM clock: sleeps long


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(torch, fn, iters: int = KERNEL_ITERS, flush=None) -> float:
    """Mean device time of one call of ``fn`` over ``iters`` calls: CUDA
    events around each call, ``flush`` (evicting the L2 cache where the
    real caller finds it cold) between calls outside the events. A
    sleeping kernel holds the stream while the host enqueues every call,
    so the card runs them back to back and the events see device time,
    not the host's launch latency."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if flush is not None:
        flush()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    torch.cuda._sleep(int((2 * iters * host_s + 2e-3) * SLEEP_CYCLES_PER_S))
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound_ms(bytes_moved: float, ops: float, dtype_name: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_close(name, got, want, atol, rtol):
    """Max abs error of ``got`` vs ``want``; raises unless every element is
    finite and within ``atol + rtol * |want|``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool(got.isfinite().all()) or bool(
            (err > atol + rtol * want.abs()).any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs err "
            f"{float(err.max()):.3e} (atol {atol}, rtol {rtol})")
    return float(err.max())


# ---------------------------------------------------------------------------
# kernel phase


def layer_norm_phase(torch, dev):
    import torch.nn.functional as F

    from apex_tpu_torch.ops.layer_norm import (layer_norm_fwd,
                                               layer_norm_reference)

    hidden, eps = 768, 1e-5
    tol = {"float32": (1e-5, 1e-5), "bfloat16": (1e-3, 8e-3)}
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for rows in (4, 8, 32, 8 * 32):
            x = torch.randn(rows, hidden, device=dev, generator=gen).to(dt)
            w = (1 + 0.1 * torch.randn(hidden, device=dev,
                                       generator=gen)).to(dt)
            b = (0.1 * torch.randn(hidden, device=dev, generator=gen)).to(dt)
            got = layer_norm_fwd(x, w, b, eps)
            want = layer_norm_reference(x, w, b, eps)
            torch.cuda.synchronize()
            atol, rtol = tol[dname]
            err = check_close(f"layer_norm_fwd {dname} rows={rows}", got,
                              want, atol, rtol)
            esz = x.element_size()
            bms, by = bound_ms((2 * rows * hidden + 2 * hidden) * esz,
                               8.0 * rows * hidden, dname)
            cases.append({
                "dtype": dname, "rows": rows, "hidden": hidden,
                "max_abs_err": err, "atol": atol, "rtol": rtol,
                "ms": time_ms(torch, lambda: layer_norm_fwd(x, w, b, eps)),
                "plain_ms": time_ms(
                    torch, lambda: layer_norm_reference(x, w, b, eps)),
                "library_ms": time_ms(
                    torch, lambda: F.layer_norm(x, (hidden,), w, b, eps)),
                "bound_ms": bms, "bound_by": by})
    return cases


def paged_attention_phase(torch, dev):
    import numpy as np
    import torch.nn.functional as F

    from apex_tpu_torch.serve.decode import (paged_attention_fwd,
                                             paged_attention_reference)
    from apex_tpu_torch.serve.kv_cache import KVCacheConfig, gather_kv

    heads, hd, bs, max_ctx = 12, 64, 16, 1024
    mb = max_ctx // bs
    scale = 1.0 / math.sqrt(hd)
    tol = {"float32": (2e-5, 1e-4), "bfloat16": (1e-3, 8e-3)}
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for n in (8, 32):
            blocks = n * mb
            cfg = KVCacheConfig(num_layers=1, num_heads=heads, head_dim=hd,
                                num_blocks=blocks, block_size=bs, dtype=dt)
            ctx = rng.integers(1, max_ctx + 1, n)
            ctx[0] = 0                  # an idle row: zeros
            ctx[1] = max_ctx            # a full row
            bt = rng.permutation(blocks).reshape(n, mb).astype(np.int32)
            pools = {k: torch.randn(heads, blocks + 1, bs, hd, device=dev,
                                    generator=gen).to(dt) for k in "kv"}
            q = torch.randn(n, heads, hd, device=dev, generator=gen).to(dt)
            bt_t = torch.from_numpy(bt).to(dev)
            ctx_t = torch.from_numpy(ctx.astype(np.int32)).to(dev)
            got = paged_attention_fwd(q, pools, cfg, bt_t, ctx_t, scale)
            want = paged_attention_reference(q, pools, cfg, bt_t, ctx_t,
                                             scale=scale)
            torch.cuda.synchronize()
            atol, rtol = tol[dname]
            err = check_close(f"paged_attention_fwd {dname} n={n}", got,
                              want, atol, rtol)
            if bool(got[0].abs().max() != 0):
                raise AssertionError("paged_attention_fwd: ctx == 0 row is "
                                     "not zeros")
            # library yardstick: SDPA over K/V gathered beforehand
            k_all, v_all = gather_kv(pools, cfg, bt_t)
            kpos = torch.arange(max_ctx, device=dev)
            keep = (kpos[None, None, None, :] < ctx_t[:, None, None, None])
            qs = q[:, :, None]
            esz = q.element_size()
            live = int(ctx.sum())
            bms, by = bound_ms(
                live * heads * hd * 2 * esz + 2 * n * heads * hd * esz
                + n * mb * 4 + n * 4, 4.0 * live * heads * hd, dname)
            cases.append({
                "dtype": dname, "rows": n, "heads": heads, "head_dim": hd,
                "block_size": bs, "ctx_sum": live, "ctx_max": int(ctx.max()),
                "max_abs_err": err, "atol": atol, "rtol": rtol,
                "ms": time_ms(torch, lambda: paged_attention_fwd(
                    q, pools, cfg, bt_t, ctx_t, scale),
                    flush=flush_buf.zero_),
                "plain_ms": time_ms(torch, lambda: paged_attention_reference(
                    q, pools, cfg, bt_t, ctx_t, scale=scale),
                    flush=flush_buf.zero_),
                "library_ms": time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qs, k_all, v_all, attn_mask=keep, scale=scale),
                    flush=flush_buf.zero_),
                "bound_ms": bms, "bound_by": by})
            del pools, k_all, v_all
    return cases


# ---------------------------------------------------------------------------
# engine phase


def make_requests(vocab: int, seed: int = 1):
    import numpy as np

    from apex_tpu_torch.serve import Request

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 64).tolist()
    lens = rng.integers(64, 513, 16)
    reqs = []
    for i, n in enumerate(lens):
        if i == 13:
            toks = list(prefix)            # a full-prefix hit (CoW)
        elif i % 2 == 0:
            toks = prefix + rng.integers(0, vocab, int(n) - 64).tolist()
        else:
            toks = rng.integers(0, vocab, int(n)).tolist()
        reqs.append(Request(f"r{i:02d}", toks, max_new_tokens=32))
    return reqs


def serve(torch, params, cfg, dev, spec_k: int, requests):
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    eng = InferenceEngine(params, cfg, ServeConfig(
        num_slots=8, prefill_chunk=32, spec_k=spec_k), device=dev)
    t0 = time.perf_counter()
    streams = eng.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    for r in requests:
        s = streams[r.uid]
        if len(s) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in s):
            raise AssertionError(f"{r.uid}: bad stream {s}")
    keep = ("completed", "steps", "generated_tokens", "tokens_per_s",
            "ttft_ms_p50", "ttft_ms_p99", "decode_step_ms_p50",
            "decode_step_ms_p99", "prefix_cache", "speculative")
    out = {k: st.get(k) for k in keep}
    out["wall_s"] = wall
    return streams, out


def last_logits(torch, params, cfg, dev, tokens):
    """Next-token logits after ``tokens``, through chunked prefill into a
    fresh one-slot cache."""
    from apex_tpu_torch.serve import (KVCacheConfig, gpt_prefill_chunk,
                                      init_kv_cache)

    bs, chunk = 16, 32
    mb = -(-cfg.max_seq // bs)
    kv = KVCacheConfig(num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                       head_dim=cfg.head_dim, num_blocks=mb, block_size=bs,
                       dtype=cfg.dtype)
    cache = init_kv_cache(kv, dev)
    row = torch.arange(mb, dtype=torch.int32, device=dev)
    logits = None
    for c in range(0, len(tokens), chunk):
        part = tokens[c:c + chunk]
        t = torch.zeros(chunk, dtype=torch.int32, device=dev)
        t[:len(part)] = torch.tensor(part, dtype=torch.int32, device=dev)
        cache, logits = gpt_prefill_chunk(params, t, c, len(part), cache,
                                          row, cfg, kv)
    return logits


def profile_decode(torch, params, cfg, dev, requests, steps: int = 20):
    """Where a steady-state engine step's time goes: the wall time of
    ``steps`` steps without the profiler, then the same number of steps
    under torch.profiler for the device's busy time (union of its
    kernel and copy intervals) and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    eng = InferenceEngine(params, cfg, ServeConfig(
        num_slots=8, prefill_chunk=32), device=dev)
    for r in requests:
        eng.submit(r)
    for _ in range(40):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"steps": steps, "wall_ms": wall_ms,
            "profiled_wall_ms": profiled_wall_ms,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / profiled_wall_ms,
            "device_busy_share_of_unprofiled_wall": busy_us / 1e3 / wall_ms,
            "top": [{"name": k[:80], "count": n, "device_ms": us / 1e3}
                    for k, (n, us) in top]}


def first_mismatch(a, b):
    for uid in sorted(a):
        for j, (x, y) in enumerate(zip(a[uid], b[uid])):
            if x != y:
                return uid, j
    return None


def top2_gap(torch, logits) -> float:
    v = torch.topk(logits.float(), 2).values
    return float(v[0] - v[1])


def engine_phase(torch, dev, ku):
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    result = {}
    cfg32 = GPTConfig(dtype=torch.float32)
    params32 = init_gpt_params(cfg32, seed=0, device=dev)
    requests = make_requests(cfg32.vocab_size)

    # logits on a small input: kernels vs plain versions
    probe = requests[1].tokens[:40]
    lk = last_logits(torch, params32, cfg32, dev, probe)
    with ku.force_plain():
        lp = last_logits(torch, params32, cfg32, dev, probe)
    err = float((lk - lp).abs().max())
    if not bool(torch.isfinite(lk).all()) or err > 1e-3:
        raise AssertionError(f"fp32 logits: kernels vs plain max abs err "
                             f"{err:.3e} (limit 1e-3)")
    result["fp32_logits_max_abs_err"] = err

    ku.reset_launch_counts()
    s_kernel, result["fp32_kernels"] = serve(torch, params32, cfg32, dev, 0,
                                             requests)
    result["fp32_kernels"]["launches"] = ku.launch_counts()
    with ku.force_plain():
        before = ku.launch_counts()
        s_plain, result["fp32_plain"] = serve(torch, params32, cfg32, dev, 0,
                                              requests)
        if ku.launch_counts() != before:
            raise AssertionError("force_plain run launched a kernel")
    miss = first_mismatch(s_kernel, s_plain)
    if miss is not None:
        uid, j = miss
        req = next(r for r in requests if r.uid == uid)
        ctx = list(req.tokens) + s_kernel[uid][:j]
        gap = top2_gap(torch, last_logits(torch, params32, cfg32, dev, ctx))
        raise AssertionError(
            f"fp32 streams differ (kernels vs plain) at {uid} token {j}: "
            f"{s_kernel[uid][j]} vs {s_plain[uid][j]}; top-2 logit gap "
            f"there {gap:.3e}")
    del params32

    cfg16 = GPTConfig(dtype=torch.bfloat16)
    params16 = init_gpt_params(cfg16, seed=0, device=dev)
    ku.reset_launch_counts()
    s16, result["bf16_spec0"] = serve(torch, params16, cfg16, dev, 0,
                                      requests)
    launches = ku.launch_counts()
    result["bf16_spec0"]["launches"] = launches
    for name in ("layer_norm_fwd", "paged_attention_fwd"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"the main path never launched {name}")
    s16k, result["bf16_spec4"] = serve(torch, params16, cfg16, dev, 4,
                                       requests)
    miss = first_mismatch(s16, s16k)
    if miss is not None:
        uid, j = miss
        raise AssertionError(
            f"bf16 speculative stream differs from plain decode at {uid} "
            f"token {j}: {s16k[uid][j]} vs {s16[uid][j]}")
    result["bf16_profile"] = profile_decode(torch, params16, cfg16, dev,
                                            requests)
    return result, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full JSON record here")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        return _fail("torch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: this script measures the port on a GPU")
    try:
        from apex_tpu_torch.ops import _kernel_util as ku
    except ImportError as e:
        return _fail(f"the apex_tpu_torch package is not beside this script "
                     f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    t0 = time.perf_counter()
    logs = ku.build()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"[nvcc {name}] {line.strip()}", file=sys.stderr)

    t0 = time.perf_counter()
    ln_cases = layer_norm_phase(torch, dev)
    pa_cases = paged_attention_phase(torch, dev)
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine, launches = engine_phase(torch, dev, ku)
    engine_s = time.perf_counter() - t0

    def pick(cases, **where):
        return next(c for c in cases
                    if all(c[k] == v for k, v in where.items()))

    # the main path's shapes: bf16, 8 decode rows
    ln = pick(ln_cases, dtype="bfloat16", rows=8)
    pa = pick(pa_cases, dtype="bfloat16", rows=8)
    kernels = [
        {"name": "layer_norm_fwd", "route": "cuda",
         "source": "apex_tpu_torch/csrc/layer_norm.cu",
         "replaces": "apex_tpu/ops/layer_norm.py:191",
         "launches": launches.get("layer_norm_fwd", 0),
         "max_abs_err": max(c["max_abs_err"] for c in ln_cases),
         "ms": ln["ms"], "plain_ms": ln["plain_ms"],
         "bound_ms": ln["bound_ms"], "bound_by": ln["bound_by"],
         "library_ms": ln["library_ms"]},
        {"name": "paged_attention_fwd", "route": "cuda",
         "source": "apex_tpu_torch/csrc/paged_attention.cu",
         "replaces": "apex_tpu/serve/decode.py:228",
         "launches": launches.get("paged_attention_fwd", 0),
         "max_abs_err": max(c["max_abs_err"] for c in pa_cases),
         "ms": pa["ms"], "plain_ms": pa["plain_ms"],
         "bound_ms": pa["bound_ms"], "bound_by": pa["bound_by"],
         "library_ms": pa["library_ms"]},
    ]
    name = torch.cuda.get_device_name(0)
    record = {"card": card, "build_s": build_s, "kernel_phase_s": kernel_s,
              "engine_phase_s": engine_s, "layer_norm": ln_cases,
              "paged_attention": pa_cases, "engine": engine}
    for run in ("fp32_kernels", "fp32_plain", "bf16_spec0", "bf16_spec4"):
        e = engine[run]
        print(f"{run}: tokens/s {e['tokens_per_s']} ttft_ms_p50 "
              f"{e['ttft_ms_p50']} decode_step_ms_p50 "
              f"{e['decode_step_ms_p50']} on {card}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
