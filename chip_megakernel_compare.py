#!/usr/bin/env python3
"""Time the fused decode/verify layer (``fused_layer_fwd``) for one
checkout.

    python3 chip_megakernel_compare.py --root PATH [--out FILE]

Imports ``apex_tpu_torch`` from the checkout at PATH (this repo, or an
unpacked earlier commit of it) and times its ``fused_layer_fwd`` at the
megakernel phase's cases (this directory's ``chip_smoke.py``:
``megakernel_cases()`` built by ``megakernel_case``, GPT-2-124M decode
and verify in both types and every pool format, head_dim 80 and 320, a
32-slot verify call), the L2 flushed between calls as twelve layers in a
row find it, with ``chip_smoke.time_ms``. A case the checkout's gate
refuses prints its reason instead of a time. Each case prints one JSON
line (the tree, the case, the kernel's mean ms, its largest error against
the checkout's plain version, the bound); then the card's name and power
limit. To compare two commits, run it for each in one call on one card,
in turns (parent, change, change, parent).
"""

import argparse
import importlib.util
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
        print("chip_megakernel_compare: no CUDA device", file=sys.stderr)
        return 2
    here = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  here / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from apex_tpu_torch.serve.megakernel import (fused_layer_fwd,
                                                 fused_layer_reference,
                                                 megakernel_refusal)

    dev = torch.device("cuda", 0)
    dt_of = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    lines = []
    for dname, mode, what, q, hd, n in cs.megakernel_cases():
        cfg, kv, lp, layer, x, bt, start, n_fed, active = \
            cs.megakernel_case(torch, dev, dt_of[dname], mode, q, hd, n)
        rec = {"root": args.root, "case": what, "dtype": dname, "kv": mode,
               "head_dim": hd, "slots": n, "rows": n * q}
        reason = megakernel_refusal(cfg, kv, allow_interpret=False, q=q,
                                    slots=n)
        if reason is not None:
            rec["refused"] = reason
        else:
            nv = None if q == 1 else n_fed
            call = (cfg, kv, bt, start, nv, active)
            got = fused_layer_fwd(x, lp, {k: v.clone() for k, v in
                                          layer.items()}, *call)
            want = fused_layer_reference(x, lp, {k: v.clone() for k, v in
                                                 layer.items()}, *call)
            timed = {k: v.clone() for k, v in layer.items()}
            bms, by = cs.megakernel_bound(cfg, kv, start, active, q, dname)
            rec.update(
                max_abs_err=float((got[0].float() - want[0].float())
                                  .abs().max()),
                ms=cs.time_ms(torch, lambda: fused_layer_fwd(
                    x, lp, timed, *call), flush=flush_buf.zero_),
                bound_ms=bms, bound_by=by)
            del got, want, timed
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        del layer, lp, x
    card = cs.card_line()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "cases": lines}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
