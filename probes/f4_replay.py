#!/usr/bin/env python3
"""Row 10's forward error on an ill-conditioned matrix, step by step (the
F4 candidate of ROADMAP.md): which rounding makes the kernel factor's
distance from the float64 factor larger than its plain version's.

    python3 probes/f4_replay.py [--m 8192]

Solves ``chip_smoke.py``'s ``large_f32`` LP (m=8192, n=2m, A float32,
seed 1, default options), replays the last ``schur.factor`` call of the run
through the path's own code and factors that scaled, regularized matrix
four ways:

  kernel              row 10 with the diagonal kernel (row 5b), as the path;
  plain               row 10's plain version (library products of a whole
                      prior panel, the plain diagonal factor);
  plain_kernel_order  the plain version summed in the kernel's order: each
                      prior panel's product as chunks of 16 contraction
                      rows added in turn, the panels' runs into one total,
                      the total off the start tile in one subtraction, and
                      the row panel W_k C_k in chunks of 16 too;
  kernel_plain_5b     row 10 with row 5b swapped for its plain version.

For each: the distance from the float64 Cholesky factor over its largest
entry, the backward error ||L L^T - M|| / ||M|| and ||W L - I|| (each from
``chip_smoke._hold_factor``).  One JSON line per way, then the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs                                   # noqa: E402
import ipx_torch                                          # noqa: E402
from ipx_torch.devinfo import nvidia_smi_line             # noqa: E402
from ipx_torch.kernels import _build                      # noqa: E402
from ipx_torch.kernels import cholesky as pk              # noqa: E402
from ipx_torch.problem.generate import (  # noqa: E402
    random_feasible_large_device)

NB = pk.NB
CHUNK = 16      # contraction rows a chunk, as the kernel's copies take them


def _chunked(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """X @ Y, (B, r, NB) @ (B, NB, c), as chunk products of CHUNK
    contraction rows added in turn."""
    acc = None
    for c in range(0, X.shape[-1], CHUNK):
        prod = torch.bmm(X[:, :, c:c + CHUNK], Y[:, c:c + CHUNK])
        acc = prod if acc is None else acc + prod
    return acc


def factor_kernel_order_plain(M: torch.Tensor):
    """Row 10's plain version summed in the kernel's order (module
    docstring) -> (LT, W)."""
    B, m, _ = M.shape
    nb = m // NB
    LT = torch.zeros_like(M)
    W = torch.empty(B, nb, NB, NB, dtype=M.dtype, device=M.device)
    for k in range(nb):
        o = k * NB
        total = None
        for j in range(k):
            P = LT[:, j * NB:(j + 1) * NB]
            run = _chunked(P[:, :, o:o + NB].mT, P[:, :, o:])
            total = run if total is None else total + run
        C = M[:, o:o + NB, o:] if total is None else M[:, o:o + NB, o:] - total
        LTkk, Wk = pk.diag_factor_inv_plain(C[:, :, :NB].contiguous())
        LT[:, o:o + NB, o:o + NB] = LTkk
        W[:, k] = Wk
        if o + NB < m:
            LT[:, o:o + NB, o + NB:] = _chunked(Wk, C[:, :, NB:])
    return LT, W


def _kernel_plain_5b(M: torch.Tensor):
    """Row 10 with the diagonal factor's plain version in place of row
    5b."""
    kernel = pk.diag_factor_inv

    def plain(CD, out_lt=None, out_w=None, lower_out=False):
        pk._diag_plain_into(CD, out_lt, out_w, lower_out)
        return out_lt, out_w
    pk.diag_factor_inv = plain
    try:
        return pk.factor_lt_batched(M)
    finally:
        pk.diag_factor_inv = kernel


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=cs.M_LARGE_F32)
    a = ap.parse_args()
    _build.build_all()
    g = torch.Generator(device="cuda").manual_seed(1)
    lp, star = random_feasible_large_device(a.m, 2 * a.m, g, torch.float32,
                                            device="cuda")
    with cs.FactorCalls() as fc:
        sol = ipx_torch.solve_large(lp, options=ipx_torch.SolverOptions(
            dtype="float32"), device="cuda")
    print(json.dumps({"solve": sol.status_name, "iterations": sol.iterations,
                      "objective_err": abs(sol.objective - star)
                      / (1 + abs(star))}), flush=True)
    got = cs._replay_factor(fc.calls["last"], None)
    M, LT, W = got["factor"]
    del got, fc
    ways = {"kernel": lambda: (LT, W),
            "plain": lambda: pk.factor_lt_batched_plain(M),
            "plain_kernel_order": lambda: factor_kernel_order_plain(M),
            "kernel_plain_5b": lambda: _kernel_plain_5b(M)}
    for name, way in ways.items():
        LTv, Wv = way()
        r = cs._hold_factor(M, LTv, Wv, timing=False)
        print(json.dumps({"way": name, "m": a.m, **{
            k: r[k] for k in ("vs_f64", "backward", "w_inverse", "finite",
                              "f64_not_pd_at")}}), flush=True)
        del LTv, Wv
        torch.cuda.empty_cache()
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
