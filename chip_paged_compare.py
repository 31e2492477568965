#!/usr/bin/env python3
"""Time paged attention at the serve programs' calls for one checkout.

    python3 chip_paged_compare.py --root PATH [--out FILE]

Imports ``apex_tpu_torch`` from the checkout at PATH (this repo, or an
unpacked earlier commit of it) and times its ``paged_attention_fwd`` at
``chip_smoke.py``'s paged cases: decode (8 rows), verify (8 slots x 5
rows) and a prefill chunk (1 slot x 32 rows), bf16 and fp32 queries,
full-precision, int8 and int4 pools, the L2 flushed between calls (the
cases and the timing are this directory's ``chip_smoke.py``'s). A
checkout whose wrapper takes ``rows_per_table`` gets each call's group;
an older one gets the same rows flat, as its serve programs passed them.
Each case prints one JSON line (the tree, the case, the error against
the plain version, the kernel's mean ms) and the card's name and power
limit. To compare two commits, run it for each in one call on one card,
in turns (parent, change, change, parent).
"""

import argparse
import importlib.util
import inspect
import json
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
        print("chip_paged_compare: no CUDA device", file=sys.stderr)
        return 2
    here = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  here / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from apex_tpu_torch.serve.decode import (paged_attention_fwd,
                                             paged_attention_reference)

    grouped = "rows_per_table" in inspect.signature(
        paged_attention_fwd).parameters
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    lines = []
    for kind in ("decode", "verify", "prefill"):
        for dt in (torch.bfloat16, torch.float32):
            for mode in ("none", "int8", "int4"):
                q, pools, cfg, bt, ctx, g, _ = cs.paged_case(
                    torch, dev, dt, mode, kind)
                kw = {"rows_per_table": g} if grouped else {}

                def call():
                    return paged_attention_fwd(q, pools, cfg, bt, ctx,
                                               0.125, **kw)
                err = float((call().float() - paged_attention_reference(
                    q, pools, cfg, bt, ctx, scale=0.125).float())
                    .abs().max())
                rec = {"root": args.root, "grouped": grouped, "kind": kind,
                       "dtype": str(dt).split(".")[1], "kv": mode,
                       "rows": q.shape[0], "max_abs_err": err,
                       "ms": cs.time_ms(torch, call, flush=flush.zero_)}
                lines.append(rec)
                print(json.dumps(rec), flush=True)
    card = cs.card_line()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "cases": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
