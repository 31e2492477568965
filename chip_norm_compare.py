#!/usr/bin/env python3
"""Time the LayerNorm and RMSNorm forward and backward kernels for one
checkout.

    python3 chip_norm_compare.py --root PATH [--out FILE]

Imports ``apex_tpu_torch`` from the checkout at PATH (this repo, or an
unpacked earlier commit of it) and times its ``layer_norm_fwd`` /
``rms_norm_fwd`` and ``layer_norm_bwd`` / ``rms_norm_bwd`` at
``chip_smoke.py``'s shapes: LayerNorm at the ``layer_norm`` phase's
(the serving path's ``LN_SERVE_ROWS`` rows of 768, forward alone without
statistics; GPT-2's 8192 rows of 768, T5-small's 4096 and 1024 rows of
512, with statistics; fp32 and bf16) and both kinds at the ``norm``
phase's ``NORM_SHAPES`` in their (x, weight) types (GPT-3's 2048 rows of
12,288 among them), the L2 flushed between calls where the phase flushes
it (the shapes and the timing are this directory's ``chip_smoke.py``'s).
Beside each forward, one ``F.layer_norm`` / ``F.rms_norm`` call on the
same x (the weight cast to x's type beforehand, which those calls need).
The backward's statistics come from the checkout's own forward. Each case
prints one JSON line (the tree, the case, the kernel's mean ms and its
largest error against the plain version, forward and backward, the
library's ms) and the card's name and power limit. To compare two
commits, run it for each in one call on one card, in turns (parent,
change, change, parent).
"""

import argparse
import importlib
import importlib.util
import json
import pathlib
import sys


def cases(cs):
    """(kind, rows, hidden, x type, weight type, training) of both phases;
    a training case has statistics, a flushed L2 and a backward."""
    out = []
    for rows in cs.LN_SERVE_ROWS:
        for dt in ("float32", "bfloat16"):
            out.append(("ln", rows, 768, dt, dt, False))
    for rows, hidden in ((cs.TRAIN_ROWS, 768),
                         *((r, cs.T5_HIDDEN) for r in cs.T5_LN_ROWS)):
        for dt in ("float32", "bfloat16"):
            out.append(("ln", rows, hidden, dt, dt, True))
    for name, rows, hidden, types in cs.NORM_SHAPES:
        for kind in ("rms", "ln"):
            for xt, wt in types:
                if (kind, rows, hidden, xt, wt, True) not in out:
                    out.append((kind, rows, hidden, xt, wt, True))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_norm_compare: no CUDA device", file=sys.stderr)
        return 2
    here = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  here / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

    dev = torch.device("cuda", 0)
    eps = 1e-5
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    dt_of = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device=dev).manual_seed(2)

    def err(got, want):
        return max(float((g.float() - c.float()).abs().max())
                   for g, c in zip(got, want))

    lines = []
    for kind, rows, hidden, xt, wt, train in cases(cs):
        x = (torch.randn(rows, hidden, device=dev, generator=gen) * 2
             + 1).to(dt_of[xt])
        w = (1 + 0.1 * torch.randn(hidden, device=dev,
                                   generator=gen)).to(dt_of[wt])
        b = (0.1 * torch.randn(hidden, device=dev,
                               generator=gen)).to(dt_of[wt])
        dy = torch.randn(rows, hidden, device=dev,
                         generator=gen).to(dt_of[xt])
        wl, bl = w.to(x.dtype), b.to(x.dtype)
        if kind == "ln":
            def fwd():
                return ln.layer_norm_fwd(x, w, b, eps, stats=train)
            want = ln.layer_norm_fwd_reference(x, w, b, eps)

            def lib():
                return F.layer_norm(x, (hidden,), wl, bl, eps)
        else:
            def fwd():
                return ln.rms_norm_fwd(x, w, eps, stats=train)
            want = ln.rms_norm_fwd_reference(x, w, eps)

            def lib():
                return F.rms_norm(x, (hidden,), wl, eps)
        got = fwd()
        flush = flush_buf.zero_ if train else None
        rec = {"root": args.root, "kind": kind, "rows": rows,
               "hidden": hidden, "x_dtype": xt, "w_dtype": wt,
               "stats": train,
               "fwd_max_abs_err": err(got if train else (got,), want),
               "fwd_ms": cs.time_ms(torch, fwd, flush=flush),
               "library_ms": cs.time_ms(torch, lib, flush=flush)}
        if train:
            stats = got[1:]
            if kind == "ln":
                def bwd():
                    return ln.layer_norm_bwd(dy, x, *stats, w)
                want = ln.layer_norm_bwd_reference(dy, x, *stats, w)
            else:
                def bwd():
                    return ln.rms_norm_bwd(dy, x, *stats, w)
                want = ln.rms_norm_bwd_reference(dy, x, *stats, w)
            rec.update(bwd_max_abs_err=err(bwd(), want),
                       bwd_ms=cs.time_ms(torch, bwd, flush=flush))
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        del x, w, b, dy, wl, bl, got, want
    card = cs.card_line()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "cases": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
