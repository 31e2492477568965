#!/usr/bin/env python3
"""Time the codec's quantize and dequantize kernels for one checkout.

    python3 chip_codec_compare.py --root PATH [--out FILE]

Imports ``apex_tpu_torch`` from the checkout at PATH (this repo, or an
unpacked earlier commit of it) and times its ``comm.quantize`` at
``chip_smoke.py``'s cells: GPT-2-124M's gradient as one flat buffer
(``padded_size(CODEC_GRAD_ELEMS, 256 · 32)`` elements, random values from
torch seed 11, as the codec phase makes them), fp32 and bf16, int8
(block 256) and int4 (group 128), nearest and stochastic
(``CODEC_SEED``). Per cell: the
quantize kernel alone (``quantize_blocks``; at int4 with ``packed=True``
where the checkout's wrapper takes it, else its int8 codes), its public
entry point (``quantize_blockwise`` / ``_int4``, which adds any reshape or
pack), at nearest the dequantize kernel alone and through its public
entry point (which adds any unpack), and the public pair (quantize then
dequantize) the codec's main path runs; each kernel's output held bitwise
against the checkout's own plain version. Last, as yardsticks of the
card's streaming rate, PyTorch's own ``fill_`` and ``clone`` of the
buffer (fp32, and bf16 for the copy). Each cell prints one JSON line
(the tree, the cell, mean ms over 20 calls by CUDA events, and the byte
bound of the packed format at 3.35 TB/s), then the card's name and power
limit. To compare two commits, run it for each in one call on one card, in
turns (parent, change, change, parent).
"""

import argparse
import importlib
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
        print("chip_codec_compare: no CUDA device", file=sys.stderr)
        return 2
    here = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  here / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    pq = importlib.import_module("apex_tpu_torch.comm.quantize")
    takes_packed = "packed" in inspect.signature(
        pq.quantize_blocks).parameters

    dev = torch.device("cuda", 0)
    n = pq.padded_size(cs.CODEC_GRAD_ELEMS, 256 * pq._ROWS_PER_STEP)
    gen = torch.Generator(device=dev).manual_seed(11)
    base = torch.randn(n, device=dev, generator=gen) * 1e-3
    public = {8: (pq.quantize_blockwise, pq.dequantize_blockwise),
              4: (pq.quantize_blockwise_int4, pq.dequantize_blockwise_int4)}

    def ms(fn):
        return cs.time_ms(torch, fn, iters=20)

    lines = []
    for dt in (torch.float32, torch.bfloat16):
        x = base.to(dt)
        for bits, block in ((8, 256), (4, 128)):
            qmax = pq.qmax_for_bits(bits)
            packed = bits == 4 and takes_packed
            extra = {"packed": True} if packed else {}
            quant, dequant = public[bits]
            x2d = x.view(-1, block)
            code_bytes = n / 2 if bits == 4 else n
            for seed in (None, cs.CODEC_SEED):
                stoch = seed is not None
                q, s = pq.quantize_blocks(x2d, qmax, seed, **extra)
                q_p, s_p = pq.quantize_blocks_reference(x2d, qmax, seed,
                                                        **extra)
                bitwise = bool(torch.equal(q, q_p) and torch.equal(s, s_p))
                del q_p, s_p
                rec = {"root": args.root, "dtype": str(dt).split(".")[1],
                       "bits": bits, "block": block,
                       "mode": "stochastic" if stoch else "nearest",
                       "elements": n, "kernel_packs": packed,
                       "quantize_bitwise": bitwise,
                       "quantize_bound_ms": (n * x.element_size()
                                             + code_bytes + 4 * n / block)
                       / cs.HBM_BYTES_PER_S * 1e3,
                       "quantize_ms": ms(lambda: pq.quantize_blocks(
                           x2d, qmax, seed, **extra)),
                       "quantize_public_ms": ms(lambda: quant(
                           x, block, stoch, seed))}
                if not stoch:
                    y = pq.dequantize_blocks(q, s, **extra)
                    want = pq.dequantize_blocks_reference(q, s, **extra)
                    flat = (q if packed or bits == 8
                            else pq.pack_int4(q)).reshape(-1)
                    rec.update(
                        dequantize_bitwise=bool(torch.equal(y, want)),
                        dequantize_bound_ms=(code_bytes + 4 * n / block
                                             + 4 * n)
                        / cs.HBM_BYTES_PER_S * 1e3,
                        dequantize_ms=ms(lambda: pq.dequantize_blocks(
                            q, s, **extra)),
                        dequantize_public_ms=ms(lambda: dequant(
                            flat, s, block)))
                    del y, want, flat
                rec["pair_ms"] = ms(lambda: dequant(
                    *quant(x, block, stoch, seed), block))
                lines.append(rec)
                print(json.dumps(rec), flush=True)
                del q, s
        del x, x2d
    # the card's streaming rate by the library's own kernels, no arithmetic:
    # what a byte-bound cell can hope for on this card
    xb = base.to(torch.bfloat16)
    rates = {"fill_fp32": (lambda: torch.empty_like(base).fill_(1.0), 4 * n),
             "copy_fp32": (lambda: base.clone(), 8 * n),
             "copy_bf16": (lambda: xb.clone(), 4 * n)}
    rec = {"root": args.root, "yardsticks": {
        k: {"ms": ms(fn), "bytes": b} for k, (fn, b) in rates.items()}}
    for v in rec["yardsticks"].values():
        v["tb_per_s"] = v["bytes"] / v["ms"] / 1e9
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
