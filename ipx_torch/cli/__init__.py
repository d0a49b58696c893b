"""Command-line interface.

    python -m ipx_torch solve problem.mps [--tol 1e-6] [--dtype float32] ...
    python -m ipx_torch random --m 50 --n 100 [--batch 8]

The flags and the JSON output are ``ipx``'s (``python -m ipx``), with
``--device cuda|cpu`` (default ``cuda``) in place of ``--platform``.  There
is no ``bench`` counterpart yet: ``bench`` exits with code 2.
"""
from __future__ import annotations

import argparse
import json
import sys


def _add_solver_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the solve runs (default: the card)")
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--dtype", choices=["float32", "float64"], default=None)
    # choice lists from the options module, so they cannot go stale against
    # SolverOptions' validation
    from ipx_torch.options import CHOL_BACKEND_CHOICES, LINSYS_CHOICES
    p.add_argument("--chol-backend", choices=list(CHOL_BACKEND_CHOICES),
                   default=None)
    p.add_argument("--matvec-backend", choices=["xla", "fused"],
                   default=None)
    p.add_argument("--a-storage", choices=["float32", "bfloat16"],
                   default=None)
    p.add_argument("--linsys", choices=list(LINSYS_CHOICES), default=None)
    p.add_argument("--cg-operator", choices=["matrix_free", "assembled"],
                   default=None)
    p.add_argument("--refine-steps", type=int, default=None)
    p.add_argument("--kkt-refine-steps", type=int, default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--checkpoint-to", default=None)
    p.add_argument("--json", action="store_true",
                   help="machine-readable one-line JSON result")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the iteration table")


def _build_options(args):
    from ipx_torch.options import SolverOptions
    kw = {}
    for flag, field in [("tol", "tol"), ("max_iter", "max_iter"),
                        ("dtype", "dtype"), ("chol_backend", "chol_backend"),
                        ("matvec_backend", "matvec_backend"),
                        ("a_storage", "a_storage"),
                        ("linsys", "linsys"),
                        ("cg_operator", "cg_operator"),
                        ("refine_steps", "refine_steps"),
                        ("kkt_refine_steps", "kkt_refine_steps")]:
        v = getattr(args, flag)
        if v is not None:
            kw[field] = v
    return SolverOptions(**kw)


def _report(sol, args, extra=None) -> int:
    if args.json:
        out = {"status": sol.status_name, "objective": sol.objective,
               "iterations": sol.iterations, "rel_gap": sol.rel_gap,
               "rp_rel": sol.rp_rel, "rd_rel": sol.rd_rel}
        out.update(extra or {})
        print(json.dumps(out))
    else:
        if extra:
            for k, v in extra.items():
                print(f"{k}: {v}")
        if not args.quiet:
            print(sol.iteration_table())
        print(f"status     : {sol.status_name}")
        print(f"objective  : {sol.objective:.10g}")
        print(f"iterations : {sol.iterations}")
        print(f"rel gap    : {sol.rel_gap:.3e}   "
              f"rp {sol.rp_rel:.3e}  rd {sol.rd_rel:.3e}")
    return 0 if sol.optimal else 1


def cmd_solve(args) -> int:
    import ipx_torch
    sol = ipx_torch.solve_mps(args.file, _build_options(args),
                              device=args.device)
    return _report(sol, args, {"file": args.file})


def cmd_random(args) -> int:
    import ipx_torch
    from ipx_torch.problem.generate import random_feasible_lp
    from ipx_torch.problem.lp import make_lp
    opts = _build_options(args)
    if args.batch > 1:
        gs = [random_feasible_lp(args.m, args.n, seed=args.seed + i)
              for i in range(args.batch)]
        sols = ipx_torch.solve_batch(
            [make_lp(g.c, g.A, g.b, device=args.device) for g in gs],
            options=opts, device=args.device)
        worst = 0
        for i, (g, s) in enumerate(zip(gs, sols)):
            rel = abs(s.objective - g.obj_star) / (1 + abs(g.obj_star))
            print(f"seed {args.seed + i}: {s.status_name:10s} "
                  f"iters {s.iterations:3d}"
                  f"  obj {s.objective: .6e}  vs-known {rel:.2e}")
            worst = max(worst, 0 if s.optimal else 1)
        return worst
    g = random_feasible_lp(args.m, args.n, seed=args.seed)
    sol = ipx_torch.solve(g.c, g.A, g.b, options=opts,
                          resume_from=args.resume_from,
                          checkpoint_to=args.checkpoint_to,
                          device=args.device)
    rel = abs(sol.objective - g.obj_star) / (1 + abs(g.obj_star))
    return _report(sol, args, {"known_optimum_rel_err": f"{rel:.3e}"})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ipx_torch",
        description="interior-point LP solver on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_solve = sub.add_parser("solve", help="solve an MPS file")
    p_solve.add_argument("file")
    _add_solver_flags(p_solve)

    p_rand = sub.add_parser("random", help="solve random feasible LP(s)")
    p_rand.add_argument("--m", type=int, default=50)
    p_rand.add_argument("--n", type=int, default=100)
    p_rand.add_argument("--batch", type=int, default=1)
    p_rand.add_argument("--seed", type=int, default=0)
    _add_solver_flags(p_rand)

    sub.add_parser("bench", help="not available: there is no benchmark "
                                 "harness for this package yet")

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "bench":
        sys.stderr.write(
            "ipx_torch: there is no bench counterpart yet (ROADMAP.md, "
            "module 2: the bench); run `python -m ipx bench` for the JAX "
            "package's harness\n")
        return 2
    args = parser.parse_args(argv)
    if args.cmd == "solve":
        return cmd_solve(args)
    return cmd_random(args)
