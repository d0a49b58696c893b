#!/usr/bin/env python3
"""The large single LP's pieces on one GPU, at config 4's size by default.

    python3 probes/large_times.py [--m 32768] [--n 65536] [--iters 2]
                                  [--f32]

Generates the LP on the card (A stored bf16 with its values rounded before b
and c are formed, or float32 with ``--f32``), then times one call of each
piece of a ``linsys="sharded"`` iteration at p = 1 (CUDA events): the Jacobi
diagonal, the assembly (row 4), the factor (row 10 with the diagonal
kernel), one preconditioner apply (the W-substitutions), one product A w and
A^T v rounded to float32 and in float64 (the route's, ``products.pair``
with sums ``"working"`` and ``"f64"``: rows 2 and 3 on the card), the same
products through the
library route they replaced (a float32 or float64 copy of A a block of rows
at a time, then a library product: ``numerics.mv``, ``mv64``), and then
``solve_large`` capped at ``--iters`` iterations with the endgame off, its
seconds, peak memory and launches.  One JSON line a step, the card's name
and power limit first.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import ipx_torch  # noqa: E402
from ipx_torch import mesh as meshlib  # noqa: E402
from ipx_torch.devinfo import nvidia_smi_line, time_ms  # noqa: E402
from ipx_torch.kernels import _build  # noqa: E402
from ipx_torch.kernels import cholesky as pk  # noqa: E402
from ipx_torch.kernels import fused as fk  # noqa: E402
from ipx_torch.linsys import products, schur  # noqa: E402
from ipx_torch.numerics import mv, mv64  # noqa: E402
from ipx_torch.problem.generate import random_feasible_large_device  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=32768)
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--f32", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("large_times: needs a GPU\n")
        return 2
    print(json.dumps({"card": nvidia_smi_line(), "m": a.m, "n": a.n}),
          flush=True)
    _build.build_all()
    a_dtype = torch.float32 if a.f32 else torch.bfloat16
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(0)
    lp, star = random_feasible_large_device(a.m, a.n, g, a_dtype)
    torch.cuda.synchronize()
    out = {"generate_s": time.perf_counter() - t0}
    A = lp.A.unsqueeze(0)
    d2 = torch.rand(1, a.n, device="cuda") + 0.5
    w = torch.randn(1, a.n, device="cuda")
    v = torch.randn(1, a.m, device="cuda")
    mesh = meshlib.make_mesh()
    with schur.use_mesh(mesh):
        out["diag_ms"] = time_ms(lambda: schur._diag_scan(A, d2),
                                 reps=2, warm=1)
        out["assemble_ms"] = time_ms(lambda: pk.assemble_sym_batched(A, d2),
                                     reps=2, warm=1)
        j = torch.rsqrt(schur._diag_scan(A, d2))
        M = pk.assemble_sym_batched(A, d2)
        M.mul_(j[:, :, None]).mul_(j[:, None, :])
        M.diagonal(dim1=1, dim2=2).add_(ipx_torch.SolverOptions().reg)
        out["factor_ms"] = time_ms(lambda: pk.factor_lt_batched(M), reps=2,
                                   warm=0)
        LT, W = pk.factor_lt_batched(M)
        del M
        fac = schur.SchurFactor(L=LT, W=W, j=j, d2=d2,
                                ok=torch.ones(1, dtype=torch.bool,
                                              device="cuda"))
        row = schur._row()
        out["precond_ms"] = time_ms(lambda: schur._precond(fac, v, row),
                                    reps=3, warm=1)
        del fac, LT, W
        for tag, sums in (("", "working"), ("_f64", "f64")):
            fwd, tr = products.pair(A, sums)
            out[f"a_w{tag}_ms"] = time_ms(lambda: fwd(w))
            out[f"at_v{tag}_ms"] = time_ms(lambda: tr(v))
        for tag, fn in (("", mv), ("_f64", mv64)):
            out[f"library_a_w{tag}_ms"] = time_ms(lambda: fn(A, w), reps=3,
                                                  warm=1)
            out[f"library_at_v{tag}_ms"] = time_ms(lambda: fn(A.mT, v),
                                                   reps=3, warm=1)
    print(json.dumps(out), flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sol = ipx_torch.solve_large(
        lp, options=ipx_torch.SolverOptions(
            a_storage="float32" if a.f32 else "bfloat16",
            augmented_fallback=False, max_iter=a.iters))
    torch.cuda.synchronize()
    print(json.dumps({
        "solve_s": time.perf_counter() - t0, "iters": sol.iterations,
        "status": sol.status_name, "rel_gap": sol.rel_gap,
        "rp_rel": sol.rp_rel, "rd_rel": sol.rd_rel,
        "obj_err": abs(sol.objective - star) / (1 + abs(star)),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": {k: v for k, v in {**fk.LAUNCHES, **pk.LAUNCHES}.items()
                     if v}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
