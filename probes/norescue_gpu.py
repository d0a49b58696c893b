"""No-rescue convergence probe of the main path on the GPU.

    python3 probes/norescue_gpu.py [--batch 64] [--m 1024] [--n 2048]
                                   [--root CHECKOUT]

How many lanes of a batch end OPTIMAL without the rescue ladder, and what
moves that count.  Runs ``ipx_torch.solve_batch`` on the same instances under
a list of variants and prints one JSON line per variant with the status
counts, the OPTIMAL count per 16 lanes and the quartiles of the best-iterate
gap (and, for the factor routes, the seconds of the whole solve_batch, host
work included):

  baseline            throughput options on the library Cholesky
                      (chol_backend="xla"), this package's kernels
  pallas_left         the same lanes under throughput() as it stands: the
                      panel-major factor and pair-solve kernels
  pallas_left/plain   that route with its factor and solve kernels replaced
                      by their plain versions (float32 library sums)
  pallas, blocked_left   the same lanes on two backends that keep a full L^T:
                      the right-looking kernel factor, and the left-looking
                      factor from library products, both solved by the
                      full-L^T pair-solve kernel
  throughput_f32      throughput() as defined, A stored float32: the
                      assembly's float32 kernel and the panel-major factor
                      from the assembled matrix; and, where the package has
                      it, the same with the assembly by library matmuls
                      (throughput_f32/library_assembly)
  plain_kernels       the four kernel wrappers replaced by their plain versions
  chol_f64+trsm_f64   library factor and triangular solves done in float64
  asm_f64, matvec_f64, asm_f64+matvec_f64   the assembly / the A products
                      computed in float64 and rounded once (what exact sums
                      would give)
  asm_f64+plain_matvecs, plain_asm+matvec_f64   one of the two exact, the
                      other the plain version (one float32 chain per sum)
  chunks_of_16        the same lanes solved as separate batches of 16
  refine_solve_cg=-1, robust_fused_bf16, robust_xla_f32   other options
  numpy_instances     instances drawn on the host with numpy (seeds 100..)
  firstN_gpu / firstN_cpu   the first N lanes alone (--cpu-lanes, default
                      16), on the card and on the host's CPU (plain versions),
                      for a like-for-like pair

``--routes-only`` stops after the first six (the factor routes side by
side).  ``--assembled`` then runs ``cg_operator="assembled"`` on ``xla``,
``pallas_left`` and ``pallas``, and on ``pallas`` once more with that
operator's product in float64 (``pallas/assembled_f64``), and stops: with
the first five as the control, whether the operator's extra iterations
belong to one route.  ``--alone K`` then solves the first K lanes that the kernel route
left short of OPTIMAL in the batch and its first K OPTIMAL lanes each as a
batch of one on both routes, prints one line per lane with its four ends
(batch and alone, either route) and a summary: how often a lane alone ends
as it did in the batch, and how the two routes compare alone.  The variants
patch module attributes for the length of one run; nothing of the package
depends on this file.  ``--root`` imports ``ipx_torch`` from another
checkout (a parent exported with ``git archive``), so that two trees run on
one card in one call.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

_root = next((sys.argv[i + 1] for i, a in enumerate(sys.argv[:-1])
              if a == "--root"),
             os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, _root)

import ipx_torch
from ipx_torch.devinfo import nvidia_smi_line
from ipx_torch.ipm.batched import stack_lps
from ipx_torch.kernels import cholesky as pk
from ipx_torch.kernels import fused as fk
from ipx_torch.linsys import normal_eq as ne
from ipx_torch.problem.generate import random_feasible_batch_device
from ipx_torch.problem.lp import LP, make_lp


def numpy_instance(m: int, n: int, seed: int):
    """One instance of the device generator's construction, drawn with
    numpy: A rounded to bf16, b and c formed in f32 from the rounded A."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    A = torch.from_numpy(A).to(torch.bfloat16).float().numpy()
    perm = rng.permutation(n)
    x = np.zeros(n, np.float32)
    x[perm[:m]] = rng.uniform(0.5, 2.0, m)
    s = np.zeros(n, np.float32)
    s[perm[m:]] = rng.uniform(0.5, 2.0, n - m)
    y = rng.standard_normal(m).astype(np.float32)
    c = (A.T @ y + s).astype(np.float32)
    return c, A, (A @ x).astype(np.float32), float(c.astype(np.float64) @ x)


def report(tag: str, sols, seconds=None) -> None:
    status: dict = {}
    for s in sols:
        status[s.status_name] = status.get(s.status_name, 0) + 1
    gaps = sorted(s.rel_gap for s in sols)
    q = len(gaps) // 4
    print(json.dumps({
        "variant": tag, "lanes": len(sols), "status": status,
        "median_iterations": float(np.median([s.iterations for s in sols])),
        "optimal_per_16": [sum(s.optimal for s in sols[i:i + 16])
                           for i in range(0, len(sols), 16)],
        "gap_quartiles": [gaps[q], gaps[2 * q], gaps[min(3 * q, len(gaps) - 1)]],
        **({} if seconds is None else {"seconds": seconds}),
    }), flush=True)


def alone(lp, routes: dict, batch_sols: dict, k: int) -> None:
    """Lanes of ``lp`` solved as batches of one on each route of ``routes``
    (name -> options), beside what ``batch_sols`` (name -> solutions of the
    whole batch) made of them."""
    ref = batch_sols["pallas_left"]
    stalled = [i for i, s in enumerate(ref) if not s.optimal][:k]
    optimal = [i for i, s in enumerate(ref) if s.optimal][:k]
    end = lambda s: {"status": s.status_name, "rel_gap": s.rel_gap,
                     "iterations": s.iterations}
    rows = []
    for kind, lanes in (("stalled_in_batch", stalled),
                        ("optimal_in_batch", optimal)):
        for i in lanes:
            cut = lambda t: t[i:i + 1].contiguous()
            one = LP(c=cut(lp.c), A=cut(lp.A), b=cut(lp.b),
                     obj_offset=cut(lp.obj_offset))
            row = {"lane": i, "kind": kind}
            for name, o in routes.items():
                row[f"batch/{name}"] = end(batch_sols[name][i])
                row[f"alone/{name}"] = end(
                    ipx_torch.solve_batch(one, options=o)[0])
            rows.append(row)
            print(json.dumps({"variant": "alone", **row}), flush=True)
    summary = {"variant": "alone/summary", "k": k}
    for kind in ("stalled_in_batch", "optimal_in_batch"):
        sel = [r for r in rows if r["kind"] == kind]
        gaps = lambda key: [r[key]["rel_gap"] for r in sel]
        summary[kind] = {
            "lanes": len(sel),
            **{f"optimal_{key}": sum(r[key]["status"] == "OPTIMAL"
                                     for r in sel)
               for key in ("batch/pallas_left", "batch/xla",
                           "alone/pallas_left", "alone/xla")},
            "alone_gap_pallas_left": sorted(gaps("alone/pallas_left")),
            "alone_gap_xla": sorted(gaps("alone/xla")),
            # per lane: the kernel route's end alone over the library's
            "alone_gap_ratio_left_over_xla": sorted(
                a / b for a, b in zip(gaps("alone/pallas_left"),
                                      gaps("alone/xla"))),
        }
    print(json.dumps(summary), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", default=_root,
                    help="checkout whose ipx_torch is measured")
    ap.add_argument("--cpu-lanes", type=int, default=16,
                    help="lanes of the card-against-CPU pair (0: skip it)")
    ap.add_argument("--routes-only", action="store_true",
                    help="only baseline, pallas_left, pallas_left/plain, "
                         "pallas, blocked_left, throughput_f32")
    ap.add_argument("--assembled", action="store_true",
                    help="after the routes, cg_operator='assembled' on three "
                         "of them, then stop")
    ap.add_argument("--alone", type=int, default=0, metavar="K",
                    help="solve K stalled and K OPTIMAL lanes as batches of "
                         "one on both routes (0: skip)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("norescue_gpu: no CUDA device\n")
        return 2
    print(json.dumps({"card": nvidia_smi_line(), "batch": args.batch, "m": args.m,
                      "n": args.n, "seed": args.seed, "root": args.root}),
          flush=True)

    opts = ipx_torch.SolverOptions.throughput(
        chol_backend="xla", a_storage="bfloat16", augmented_fallback=False,
        max_iter=64)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    lp = random_feasible_batch_device(args.batch, args.m, args.n, gen,
                                      a_storage="bfloat16").lp
    took = {}

    def run(o=opts, p=lp):
        """solve_batch, its seconds (host work included) in took["s"]"""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sols = ipx_torch.solve_batch(p, options=o)
        torch.cuda.synchronize()
        took["s"] = time.perf_counter() - t0
        return sols

    batch_sols = {"xla": run()}
    report("baseline", batch_sols["xla"], took["s"])

    left = opts.replace(chol_backend="pallas_left")
    batch_sols["pallas_left"] = run(left)
    report("pallas_left", batch_sols["pallas_left"], took["s"])
    if args.alone > 0:
        alone(lp, {"pallas_left": left, "xla": opts}, batch_sols, args.alone)
    saved = (pk.factor_fused_panels, pk.chol_solve_batched_panels)
    pk.factor_fused_panels = pk.factor_fused_panels_plain
    pk.chol_solve_batched_panels = pk.chol_solve_batched_panels_plain
    try:
        report("pallas_left/plain", run(left), took["s"])
    finally:
        pk.factor_fused_panels, pk.chol_solve_batched_panels = saved
    for backend in ("pallas", "blocked_left"):
        report(backend, run(opts.replace(chol_backend=backend)), took["s"])
    f32 = ipx_torch.SolverOptions.throughput(augmented_fallback=False,
                                             max_iter=64)
    report("throughput_f32", run(f32), took["s"])
    if hasattr(ne, "_assemble_blocks"):
        # the same with the float32 A assembled by library matmuls (one
        # float32 chain an entry), as before the card's f32 A took row 4's
        # float32 kernel
        asm = ne.assemble
        ne.assemble = lambda A, d2: ne._assemble_blocks(A, d2)
        try:
            report("throughput_f32/library_assembly", run(f32), took["s"])
        finally:
            ne.assemble = asm
    if args.assembled:
        for backend in ("xla", "pallas_left", "pallas"):
            report(f"{backend}/assembled", run(opts.replace(
                chol_backend=backend, cg_operator="assembled")))
        mv = ne.mv

        def mv_f64(a, x):
            # the (B, m, m) operator's product in float64, rounded once
            if a.dtype == torch.float32 and a.shape[-2] == a.shape[-1]:
                return torch.matmul(a.double(), x.double().unsqueeze(-1)
                                    ).squeeze(-1).float()
            return mv(a, x)

        ne.mv = mv_f64
        try:
            report("pallas/assembled_f64", run(opts.replace(
                chol_backend="pallas", cg_operator="assembled")))
        finally:
            ne.mv = mv
        return 0
    if args.routes_only:
        return 0

    kernels = (fk.ata_apply, fk.a_matvec, fk.at_matvec,
               pk.assemble_sym_batched)
    fk.ata_apply = lambda A, v, alpha, w, beta=None: fk.ata_apply_plain(
        A, v, alpha, w, beta)
    fk.a_matvec, fk.at_matvec = fk.a_matvec_plain, fk.at_matvec_plain
    pk.assemble_sym_batched = pk.assemble_sym_batched_plain
    try:
        report("plain_kernels", run())
    finally:
        (fk.ata_apply, fk.a_matvec, fk.at_matvec,
         pk.assemble_sym_batched) = kernels

    chol_ex, chol_solve = torch.linalg.cholesky_ex, ne._chol_solve

    def chol64(Ms, check_errors=False):
        L, info = chol_ex(Ms.double(), check_errors=False)
        return L.to(Ms.dtype), info

    def trsm64(fac, rhs):
        L = fac.L.double()
        t = torch.linalg.solve_triangular(L, rhs.double().unsqueeze(-1),
                                          upper=False)
        return torch.linalg.solve_triangular(
            L.mT, t, upper=True).squeeze(-1).to(rhs.dtype)

    torch.linalg.cholesky_ex, ne._chol_solve = chol64, trsm64
    try:
        report("chol_f64+trsm_f64", run())
    finally:
        torch.linalg.cholesky_ex, ne._chol_solve = chol_ex, chol_solve

    def asm64(A, d2):
        Ad = A.double()
        M = torch.matmul(Ad * d2.double().unsqueeze(1), Ad.mT).float()
        return 0.5 * (M + M.mT)

    def a64(A, w):
        return torch.matmul(A.double(), w.double().unsqueeze(-1)
                            ).squeeze(-1).float()

    def at64(A, v):
        return torch.matmul(v.double().unsqueeze(1), A.double()
                            ).squeeze(1).float()

    def ata64(A, v, alpha, w, beta=None):
        t = at64(A, v)
        zero = torch.zeros_like(t)
        e = t + (zero if beta is None else beta)
        u = (zero if alpha is None else alpha) * e + (zero if w is None else w)
        return a64(A, u), t

    plain_mvs = (fk.ata_apply_plain, fk.a_matvec_plain, fk.at_matvec_plain)
    for tag, asm, mvs in (
            ("asm_f64", asm64, None),
            ("matvec_f64", None, (ata64, a64, at64)),
            ("asm_f64+matvec_f64", asm64, (ata64, a64, at64)),
            ("asm_f64+plain_matvecs", asm64, plain_mvs),
            ("plain_asm+matvec_f64", pk.assemble_sym_batched_plain,
             (ata64, a64, at64))):
        if asm:
            pk.assemble_sym_batched = asm
        if mvs:
            fk.ata_apply, fk.a_matvec, fk.at_matvec = mvs
        try:
            report(tag, run())
        finally:
            (fk.ata_apply, fk.a_matvec, fk.at_matvec,
             pk.assemble_sym_batched) = kernels

    sols = []
    for i in range(0, args.batch, 16):
        cut = lambda t: t[i:i + 16].contiguous()
        sols += run(p=LP(c=cut(lp.c), A=cut(lp.A), b=cut(lp.b),
                         obj_offset=cut(lp.obj_offset)))
    report("chunks_of_16", sols)

    report("refine_solve_cg=-1", run(opts.replace(refine_solve_cg=-1)))
    report("robust_fused_bf16", run(ipx_torch.SolverOptions(
        augmented_fallback=False, a_storage="bfloat16",
        matvec_backend="fused")))
    report("robust_xla_f32", run(ipx_torch.SolverOptions(
        augmented_fallback=False)))

    host = stack_lps([make_lp(*numpy_instance(args.m, args.n, 100 + i)[:3],
                              device="cuda") for i in range(args.batch)])
    report("numpy_instances", run(p=host))

    for tag, src in (("device_made", lp), ("numpy_made", host)):
        k = args.cpu_lanes
        if k <= 0:
            break
        cut = lambda t: t[:k].contiguous()
        first = LP(c=cut(src.c), A=cut(src.A), b=cut(src.b),
                   obj_offset=cut(src.obj_offset))
        report(f"first{k}_gpu/{tag}", run(p=first))
        report(f"first{k}_cpu/{tag}", ipx_torch.solve_batch(
            first.to("cpu"), options=opts, device="cpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
