#!/usr/bin/env python3
"""Time the packed varlen attention kernels for one checkout.

    python3 chip_varlen_compare.py --root PATH [--out FILE]

Imports ``apex_tpu_torch`` from the checkout at PATH (this repo, or an
unpacked earlier commit of it) and times its varlen forward, dQ and dK/dV
(``ops.attention_varlen``'s wrappers, each on the checkout's own route) at
``chip_smoke.py``'s varlen cases: the packed row of ``PACK_T`` tokens (the
documents of ``packed_lengths()``) at 12 heads of 64, causal and
bidirectional, and at 4 heads of 256, causal, in bf16; and the first two
in fp32. The tile tables are built once beforehand and shared by the three
kernels, as the packed path runs them, and the L2 is flushed between
calls (the shapes and the timing are this directory's ``chip_smoke.py``'s).
Each case prints one JSON line (the tree, the case, the entries launched,
the forward's largest error against the plain version, each kernel's mean
ms) and the card's name and power limit. To compare two commits, run it
for each in one call on one card, in turns (parent, change, change,
parent).
"""

import argparse
import importlib
import importlib.util
import json
import math
import pathlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("chip_varlen_compare: no CUDA device", file=sys.stderr)
        return 2
    here = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  here / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ku = importlib.import_module("apex_tpu_torch.ops._kernel_util")
    vl = importlib.import_module("apex_tpu_torch.ops.attention_varlen")
    # the checkout's route: one for all three kernels, or (earlier
    # commits) dK/dV's alone
    route = getattr(vl, "_varlen_route", None) or vl._varlen_dkv_route

    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    t = cs.PACK_T
    lens = cs.packed_lengths()
    seg = cs.packed_segments(torch, dev, lens, t)
    lines = []
    for dname, heads, d, causal in (
            ("bfloat16", cs.PACK_HEADS, cs.PACK_D, True),
            ("bfloat16", cs.PACK_HEADS, cs.PACK_D, False),
            ("bfloat16", cs.PACK_D256_HEADS, 256, True),
            ("float32", cs.PACK_HEADS, cs.PACK_D, True),
            ("float32", cs.PACK_HEADS, cs.PACK_D, False)):
        dt = getattr(torch, dname)
        q, k, v, do = (torch.randn(1, heads, t, d, device=dev,
                                   generator=gen).to(dt) for _ in range(4))
        a = (q, k, v, seg, seg)
        sc = (1.0 / math.sqrt(d), causal)
        tabs = vl._tables(seg, seg, causal,
                          route(dt, d) == "tensor_core")
        before = ku.launch_counts()
        o, lse = vl.flash_varlen_fwd(*a, *sc, tables=tabs)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        vl.flash_varlen_bwd_dq(*a, do, lse, delta, *sc, tables=tabs)
        vl.flash_varlen_bwd_dkv(*a, do, lse, delta, *sc, tables=tabs)
        after = ku.launch_counts()
        o_p, _ = vl.flash_varlen_fwd_reference(*a, *sc)
        err = float((o.float() - o_p.float()).abs().max())
        del o_p

        def timed(fn):
            return cs.time_ms(torch, fn, iters=20, flush=flush.zero_)
        rec = {"root": args.root, "dtype": dname, "heads": heads,
               "head_dim": d, "causal": causal, "tokens": t,
               "entries": sorted(n for n in after
                                 if after[n] != before.get(n, 0)),
               "fwd_o_max_abs_err": err,
               "fwd_ms": timed(lambda: vl.flash_varlen_fwd(*a, *sc,
                                                           tables=tabs)),
               "dq_ms": timed(lambda: vl.flash_varlen_bwd_dq(
                   *a, do, lse, delta, *sc, tables=tabs)),
               "dkv_ms": timed(lambda: vl.flash_varlen_bwd_dkv(
                   *a, do, lse, delta, *sc, tables=tabs))}
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        del q, k, v, do, o, lse, delta, tabs
    card = cs.card_line()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "cases": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
