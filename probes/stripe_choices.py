"""Stripe width of ``ata_apply``'s kernel (row 1) on the GPU.

    python3 probes/stripe_choices.py [--batch 256] [--m 1024] [--n 2048]

Times ``ata_apply`` (bf16 A, CUDA events) with 16- and 32-column stripes,
and says whether y has the same bits as with the wrapper's own width
(``stripe_cols``, the reference row; the f64 sums meet in another
association, rounded once to f32).  One JSON line per
choice; the card's name and power limit are in the first.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ipx_torch.devinfo import nvidia_smi_line, time_ms
from ipx_torch.kernels import fused as fk


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--n", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("stripe_choices: no CUDA device\n")
        return 2
    B, m, n = args.batch, args.m, args.n
    print(json.dumps({"card": nvidia_smi_line(), "batch": B, "m": m, "n": n}),
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(2)
    kw = dict(generator=g, device="cuda", dtype=torch.float32)
    A = (torch.randn(B, m, n, **kw) / n ** 0.5).to(torch.bfloat16)
    v, w, beta = (torch.randn(B, k, **kw) for k in (m, n, n))
    alpha = torch.exp(3.0 * torch.randn(B, n, **kw))
    ref = fk.ata_apply(A, v, alpha, w, beta=beta)[0]
    cols = fk.stripe_cols

    def row(tag: str) -> dict:
        y = fk.ata_apply(A, v, alpha, w, beta=beta)[0]
        return {"choice": tag,
                "ata_apply_ms": time_ms(
                    lambda: fk.ata_apply(A, v, alpha, w, beta=beta)),
                "y_same_bits": bool(torch.equal(y, ref))}

    try:
        print(json.dumps(row(f"wrappers' own (W={cols(m, 2)})")), flush=True)
        for W in (16, 32):
            fk.stripe_cols = lambda m_, isz, W=W: W
            print(json.dumps(row(f"W={W}")), flush=True)
    finally:
        fk.stripe_cols = cols
    return 0


if __name__ == "__main__":
    sys.exit(main())
