#!/usr/bin/env python3
"""The augmented routes' matrix-vector products on the card: rows 2 and 3
(``a_matvec`` / ``at_matvec``, what the routes take on the card) beside the
library products they replaced, and how each sums.

    python3 probes/rescue_matvecs.py [B]

At B lanes (default 40: the lanes the main path's batch of 256 leaves
STALLED) of the contract shape (m=1024, n=2048, A stored bf16, seed 0):

- the time of A @ w and A^T @ v through ``numerics.mv`` (a float32 copy of
  A), ``numerics.mv_wide`` (a float64 copy, what the augmented routes took
  before rows 2 and 3) and the kernels ``a_matvec`` / ``at_matvec`` (no
  copy, float64 sums);
- the error of each against a float64 product, relative to its largest
  entry, beside the error of one float32 chain an entry;
- on the Schur-form route (``throughput(linsys="augmented_schur")``): the
  products with A one Mehrotra step makes (counted with the row kernels'
  wrappers wrapped; the squared stream of the reduced factor's Jacobi scale
  not counted), the step's time on rows 2 and 3 and with the route forced
  back to ``mv_wide`` (``products.on_card`` patched), and the
  products' share of each.

Prints one JSON line, the card's name and power limit in it.
"""
from __future__ import annotations

import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import ipx_torch                                          # noqa: E402
from ipx_torch import numerics                            # noqa: E402
from ipx_torch.devinfo import nvidia_smi_line, time_ms    # noqa: E402
from ipx_torch.ipm import batched, mehrotra               # noqa: E402
from ipx_torch.kernels import fused as fk                 # noqa: E402
from ipx_torch.linsys import products                     # noqa: E402
from ipx_torch.problem.generate import random_feasible_batch_device  # noqa

M, N = 1024, 2048


def _rel(got, ref) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max())


def _one_chain(A, w) -> torch.Tensor:
    """A @ w summed in one float32 chain an entry, column by column."""
    acc = torch.zeros(A.shape[0], A.shape[1], device=A.device)
    for j in range(A.shape[2]):
        acc = acc + A[:, :, j].float() * w[:, j:j + 1]
    return acc


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("rescue_matvecs: needs a CUDA device\n")
        return 2
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    gb = random_feasible_batch_device(B, M, N, g, a_storage="bfloat16",
                                      device=dev)
    A = gb.lp.A
    w = torch.randn(B, N, device=dev, generator=g)
    v = torch.randn(B, M, device=dev, generator=g)
    A64 = A.double()
    ref_fwd = torch.matmul(A64, w.double().unsqueeze(-1)).squeeze(-1)
    ref_tr = torch.matmul(A64.mT, v.double().unsqueeze(-1)).squeeze(-1)
    del A64
    ways = {
        "mv": (lambda: numerics.mv(A, w), lambda: numerics.mv(A.mT, v)),
        "mv_wide": (lambda: numerics.mv_wide(A, w),
                    lambda: numerics.mv_wide(A.mT, v)),
        "kernels": (lambda: fk.a_matvec(A, w), lambda: fk.at_matvec(A, v)),
    }
    out = {}
    for name, (fwd, tr) in ways.items():
        out[name] = {"a_w_ms": time_ms(fwd, reps=20, warm=3),
                     "at_v_ms": time_ms(tr, reps=20, warm=3),
                     "a_w_rel_err": _rel(fwd(), ref_fwd),
                     "at_v_rel_err": _rel(tr(), ref_tr)}
    out["one_float32_chain_a_w_rel_err"] = _rel(_one_chain(A, w), ref_fwd)

    # one Mehrotra step on the Schur-form route, its products with A
    # counted
    opts = ipx_torch.SolverOptions.throughput(
        a_storage="bfloat16", linsys="augmented_schur",
        augmented_fallback=False)
    lp = gb.lp
    st, fac_aat = batched.batch_starting_state(lp, opts)
    calls = {"n": 0}
    a_mv, at_mv = fk.a_matvec, fk.at_matvec

    def a_counted(A_, w_, square=False, out_dtype=torch.float32):
        calls["n"] += not square
        return a_mv(A_, w_, square, out_dtype)

    def at_counted(A_, v_, out_dtype=torch.float32):
        calls["n"] += 1
        return at_mv(A_, v_, out_dtype)

    fk.a_matvec, fk.at_matvec = a_counted, at_counted
    try:
        mehrotra.mehrotra_step(lp, st, opts, fac_aat)
        torch.cuda.synchronize()
    finally:
        fk.a_matvec, fk.at_matvec = a_mv, at_mv
    step = lambda: mehrotra.mehrotra_step(lp, st, opts, fac_aat)  # noqa
    step_ms = time_ms(step, reps=3, warm=1)
    on_card = products.on_card
    products.on_card = lambda A_: False
    try:
        library_step_ms = time_ms(step, reps=3, warm=1)
    finally:
        products.on_card = on_card
    wide = (out["mv_wide"]["a_w_ms"] + out["mv_wide"]["at_v_ms"]) / 2
    kern = (out["kernels"]["a_w_ms"] + out["kernels"]["at_v_ms"]) / 2
    out["schur_step"] = {
        "products": calls["n"], "step_ms": step_ms,
        "products_ms": calls["n"] * kern,
        "products_share": calls["n"] * kern / step_ms,
        "library_step_ms": library_step_ms,
        "library_products_ms": calls["n"] * wide,
        "library_products_share": calls["n"] * wide / library_step_ms}
    print(json.dumps({"probe": "rescue_matvecs", "batch": B, "m": M, "n": N,
                      "card": nvidia_smi_line(), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
