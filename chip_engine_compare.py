#!/usr/bin/env python3
"""Time the serving engine's host cost with its telemetry on and off, and
against an earlier commit's engine, in one process.

    python3 chip_engine_compare.py [--parent PATH] [--rounds N] [--out FILE]

Serves GPT-2-124M (``GPTConfig()``, bf16, random weights from seed 0) with
``ServeConfig(num_slots=8, prefill_chunk=32)`` (the default fused decode
path, per-op prefill chunks) on ``chip_smoke.py``'s traffic
(``make_requests``: 16 requests of 64-512 prompt tokens, 32 new tokens),
one fresh engine a run, in variants:

* ``off``: this checkout's engine with every telemetry argument ``None``;
* ``on``: the same with a ``JsonlSink`` (in a temporary directory), an
  ``EventLog``, an ``SloSpec``, a ``Meter`` and ``peak_flops_per_s``;
* ``parent`` (with ``--parent``): an earlier commit's serving host code,
  ``PATH/apex_tpu_torch/serve/`` ``engine.py`` with its ``decode.py`` and
  ``megakernel.py`` (the per-op and fused serve programs), loaded beside
  this checkout's and run over its kernels, ops and KV cache.

Each round runs every variant once, the order rotated round by round; a
variant's run gives its wall ms a step (host clock, the card synchronized
before and after the run) and the engine's ``decode_step_ms_p50``. The
card's host is shared, so times move between processes by up to 2x: the
variants are compared only within this one process. Prints one JSON line
a run, one with the medians, then the card's name and power limit.
"""

import argparse
import importlib.util
import json
import pathlib
import statistics
import sys
import tempfile
import time


def load_module(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod            # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def load_parent_engine(root: pathlib.Path):
    """The engine module of the checkout at ``root``, importing that
    checkout's serve programs (``decode``, ``megakernel``) and this one's
    everything else."""
    serve = root / "apex_tpu_torch" / "serve"
    names = ("apex_tpu_torch.serve.decode", "apex_tpu_torch.serve.megakernel")
    saved = {k: sys.modules[k] for k in names}
    try:
        for k in names:
            short = k.rsplit(".", 1)[1]
            sys.modules[k] = load_module(f"parent_{short}",
                                         serve / f"{short}.py")
        return load_module("parent_engine", serve / "engine.py")
    finally:
        sys.modules.update(saved)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    here = pathlib.Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import torch

    if not torch.cuda.is_available():
        print("chip_engine_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from apex_tpu_torch.monitor import EventLog, JsonlSink, Meter, SloSpec
    from apex_tpu_torch.ops import _kernel_util as ku
    from apex_tpu_torch.serve import engine as this_engine
    from apex_tpu_torch.serve import ServeConfig
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ku.build(["layer_norm", "paged_attention", "paged_mma", "megakernel"])
    cfg = GPTConfig()
    params = init_gpt_params(cfg, seed=0, device=dev)
    scfg = ServeConfig(num_slots=8, prefill_chunk=32)
    requests = cs.make_requests(cfg.vocab_size)
    tmp = tempfile.TemporaryDirectory()
    sinks = []

    def telemetry():
        sinks.append(JsonlSink(f"{tmp.name}/s{len(sinks)}.jsonl"))
        return dict(sink=sinks[-1], events=EventLog(),
                    slo=SloSpec(ttft_ms=2000.0), meter=Meter(),
                    peak_flops_per_s=cs.PEAK_OPS_PER_S["bfloat16"])

    variants = {"off": (this_engine, dict), "on": (this_engine, telemetry)}
    if args.parent:
        variants["parent"] = (load_parent_engine(
            pathlib.Path(args.parent).resolve()), dict)

    def run(name):
        mod, kw = variants[name]
        eng = mod.InferenceEngine(params, cfg, scfg, device=dev, **kw())
        reqs = [mod.Request(r.uid, r.tokens, r.max_new_tokens)
                for r in requests]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        return streams, {"host_ms_per_step": wall * 1e3 / st["steps"],
                         "decode_step_ms_p50": st["decode_step_ms_p50"],
                         "steps": st["steps"]}

    names = list(variants)
    want = None
    for name in names:                         # warm-up, streams checked
        streams, _ = run(name)
        want = want or streams
        if streams != want:
            raise AssertionError(f"variant {name}: streams differ")
    results = {name: [] for name in names}
    for r in range(args.rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            rec = run(name)[1]
            results[name].append(rec)
            print(json.dumps({"round": r, "variant": name, **rec}),
                  flush=True)
    summary = {name: {k: statistics.median(x[k] for x in recs)
                      for k in ("host_ms_per_step", "decode_step_ms_p50")}
               for name, recs in results.items()}
    print(json.dumps({"medians": summary, "rounds": args.rounds}))
    print(cs.card_line())
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": results, "medians": summary}, f, indent=1)
    for sink in sinks:
        sink.close()
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
