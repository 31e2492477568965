#!/usr/bin/env python3
"""Time GPT-2-124M's train step under each remat policy with dropout, and
without dropout, in one process on one GPU.

    python3 chip_remat_compare.py [--rounds N] [--steps N] [--profile]

Variants, each a ``build_train_step(cfg, 8, 1024)`` from seed 0 (bf16,
fused LM-head loss, ``FusedAdam``): ``rates0`` (``GPTConfig()``, full
remat, no key), then ``full``, ``dots`` and ``dots_attn`` with GPT-2's
dropout (attention and hidden 0.1), step i's key ``fold_in(prng_key(0),
i)``. Each round runs every variant for ``--steps`` steps, the order
rotated round by round; a step's wall ms is the host clock around the
step and a ``torch.cuda.synchronize()``, and its host ms the clock until
``step()`` returns (the host's own work, while the card's queue has
room). The card's host is shared, so times move between processes: the
variants are compared only within this one. Prints one JSON line a
round and variant, one with each variant's medians and quartiles, then
the card's name and power limit. ``--profile`` adds each variant's host
functions over 3 steps (``cProfile``): the port's by cumulative time,
then all by their own time.
"""

import argparse
import cProfile
import io
import json
import pstats
import statistics
import subprocess
import sys
import time


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"p25": q[0], "p50": statistics.median(xs), "p75": q[2]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_remat_compare: no CUDA device", file=sys.stderr)
        return 2
    from apex_tpu_torch.transformer.tensor_parallel import fold_in, prng_key
    from apex_tpu_torch.transformer.testing import GPTConfig, build_train_step

    dev = torch.device("cuda", 0)
    rates = dict(attention_dropout=0.1, hidden_dropout=0.1)
    configs = {"rates0": (GPTConfig(), False)}
    for policy in ("full", "dots", "dots_attn"):
        configs[policy] = (GPTConfig(remat_policy=policy, **rates), True)
    steps = {name: build_train_step(cfg, 8, 1024, device=dev, seed=0)[0]
             for name, (cfg, _) in configs.items()}
    base, counter = prng_key(0), {name: 0 for name in configs}

    def run(name):
        key = None
        if configs[name][1]:
            key = fold_in(base, counter[name])
            counter[name] += 1
        t0 = time.perf_counter()
        steps[name](key)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, host * 1e3

    for name in configs:                     # warm up
        for _ in range(2):
            run(name)
    walls = {name: [] for name in configs}
    hosts = {name: [] for name in configs}
    names = list(configs)
    for r in range(args.rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for name in order:
            got = [run(name) for _ in range(args.steps)]
            walls[name] += [w for w, _ in got]
            hosts[name] += [h for _, h in got]
            print(json.dumps({"round": r, "variant": name,
                              "wall_ms": [round(w, 3) for w, _ in got],
                              "host_ms": [round(h, 3) for _, h in got]}))
    print(json.dumps({"summary": {
        name: {"wall_ms": quartiles(walls[name]),
               "host_ms": quartiles(hosts[name]), "steps": len(walls[name])}
        for name in configs}}))
    if args.profile:
        for name in configs:
            prof = cProfile.Profile()
            prof.enable()
            for _ in range(3):
                run(name)
            prof.disable()
            out = io.StringIO()
            stats = pstats.Stats(prof, stream=out)
            stats.sort_stats("cumulative").print_stats("apex_tpu_torch", 25)
            stats.sort_stats("tottime").print_stats(25)
            print(f"--- {name}: host functions over 3 steps (the port's by "
                  f"cumulative time, then all by own time)")
            print(out.getvalue())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
