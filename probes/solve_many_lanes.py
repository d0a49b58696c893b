#!/usr/bin/env python3
"""``ipx_torch.solve_many`` lane by lane on ``chip_smoke.py``'s mixed-size
workload: which lanes miss the constructed optimum, and why.

    python3 probes/solve_many_lanes.py [N_LPS] [--device cpu]
        [--m-lo 320 --m-hi 1024] [--worst 5e-6] [--m-seed 0 --seed0 0]
        [--sets 1]

The workload is ``chip_smoke.py``'s ``solve_many`` phase: N_LPS (default
48) LPs ``random_feasible_lp(m, 2m, seed=seed0 + i)``, m drawn from
320-1024 with ``np.random.default_rng(m_seed)``, under
``SolverOptions.throughput()``.  ``--sets K`` runs K such workloads, the
k-th with m_seed + k and seed0 + 1000 k, and ends with a summary over all
of them.
Printed, one JSON line each:

- every device run (stage 1 of each bucket, the rescue's rungs): route,
  lanes in and lanes OPTIMAL out;
- per lane: m, bucket, status, iterations, reported gap and residuals, the
  objective's error against the constructed optimum and its two exact
  parts (primal infeasibility, optimality), and the status the lane ends
  with when the rescue ladder is off (``augmented_fallback=False``: which
  lanes the ladder finished);
- for the lanes off by more than ``--worst`` (default 5e-6): the same LP
  solved alone, unpadded, through ``solve(presolve=False)`` and through
  ``solve`` with its default presolve (polish included), same options.

Ends with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import ipx_torch                                          # noqa: E402
import ipx_torch.api                                      # noqa: E402
from ipx_torch.devinfo import nvidia_smi_line             # noqa: E402
from ipx_torch.kernels import _build                      # noqa: E402
from ipx_torch.problem.batching import bucket_shape       # noqa: E402
from ipx_torch.problem.generate import random_feasible_lp  # noqa: E402


def _rel(a: float, b: float) -> float:
    return abs(a - b) / (1 + abs(b))


def _row(sol, g) -> dict:
    """The lane's reported quality, and its objective error split by
    c@x - c@x* = y*@(A x - b) + s*@x (c = A^T y* + s*, b = A x*): the
    primal infeasibility's part and the optimality part.  Exact where the
    objective is taken from the float64 data (``solve_many``, the
    presolved ``solve``); ``solve(presolve=False)`` reports c@x with c in
    the compute dtype."""
    scale = 1 + abs(g.obj_star)
    return dict(status=sol.status_name, iterations=sol.iterations,
                rel_gap=sol.rel_gap, rp_rel=sol.rp_rel, rd_rel=sol.rd_rel,
                obj_rel_err=_rel(sol.objective, g.obj_star),
                infeasibility_part=float(g.y_star @ (g.A @ sol.x - g.b))
                / scale,
                optimality_part=float(g.s_star @ sol.x) / scale)


class Runs:
    """While active, records every run of ``ipx_torch.api._run_batch``
    (stage 1 of each bucket, then the rescue's rungs): route,
    warm-started or not, lanes in and lanes OPTIMAL out."""

    def __enter__(self):
        self.calls, self._orig = [], ipx_torch.api._run_batch

        def run(lp, opts, state0=None):
            st = self._orig(lp, opts, state0)
            self.calls.append(dict(
                linsys=opts.linsys, warm=state0 is not None,
                lanes=int(lp.A.shape[0]), m=int(lp.A.shape[1]),
                optimal=int((st.status == int(ipx_torch.Status.OPTIMAL))
                            .sum())))
            return st

        ipx_torch.api._run_batch = run
        return self

    def __exit__(self, *exc):
        ipx_torch.api._run_batch = self._orig


def run_set(args, m_seed: int, seed0: int) -> dict:
    ms = np.random.default_rng(m_seed).integers(args.m_lo, args.m_hi + 1,
                                                args.n_lps)
    gens = [random_feasible_lp(int(m), 2 * int(m), seed=seed0 + i)
            for i, m in enumerate(ms)]
    probs = [(g.c, g.A, g.b) for g in gens]
    opts = ipx_torch.SolverOptions.throughput()
    with Runs() as runs:
        sols = ipx_torch.solve_many(probs, options=opts, device=args.device)
    for call in runs.calls:
        print(json.dumps(dict(run=call)), flush=True)
    stage1 = ipx_torch.solve_many(
        probs, options=opts.replace(augmented_fallback=False),
        device=args.device)
    worst = []
    for i, (g, s, s1) in enumerate(zip(gens, sols, stage1)):
        row = dict(lane=i, seed=seed0 + i, m=int(ms[i]),
                   bucket=list(bucket_shape(int(ms[i]), 2 * int(ms[i]))),
                   **_row(s, g), without_ladder=s1.status_name)
        print(json.dumps(row), flush=True)
        if s.optimal and row["obj_rel_err"] > args.worst:
            worst.append(i)
    for i in worst:
        g = gens[i]
        alone = ipx_torch.solve(g.c, g.A, g.b, options=opts, presolve=False,
                                device=args.device)
        pre = ipx_torch.solve(g.c, g.A, g.b, options=opts,
                              device=args.device)
        print(json.dumps(dict(lane=i, alone_unpadded=_row(alone, g),
                              alone_presolved=_row(pre, g))), flush=True)
    opt = [(s, s1, g) for s, s1, g in zip(sols, stage1, gens) if s.optimal]
    rescued = [_rel(s.objective, g.obj_star) for s, s1, g in opt
               if not s1.optimal]
    summary = dict(
        m_seed=m_seed, seed0=seed0, lps=args.n_lps, optimal=len(opt),
        optimal_without_ladder=sum(s.optimal for s in stage1),
        rescued=len(rescued),
        max_obj_rel_err=max((_rel(s.objective, g.obj_star)
                             for s, _, g in opt), default=None),
        max_obj_rel_err_rescued=max(rescued, default=None),
        over_1e5=sum(_rel(s.objective, g.obj_star) > 1e-5
                     for s, _, g in opt),
        lanes_over=worst, over=args.worst)
    print(json.dumps(summary), flush=True)
    return summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_lps", nargs="?", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worst", type=float, default=5e-6)
    ap.add_argument("--m-lo", type=int, default=320)
    ap.add_argument("--m-hi", type=int, default=1024)
    ap.add_argument("--m-seed", type=int, default=0)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    args = ap.parse_args()
    if args.device != "cpu":
        _build.build_all()          # every kernel source at once
    sums = [run_set(args, args.m_seed + k, args.seed0 + 1000 * k)
            for k in range(args.sets)]
    if args.sets > 1:
        print(json.dumps(dict(
            sets=args.sets, lps=sum(s["lps"] for s in sums),
            optimal=sum(s["optimal"] for s in sums),
            optimal_without_ladder=sum(s["optimal_without_ladder"]
                                       for s in sums),
            rescued=sum(s["rescued"] for s in sums),
            over_1e5=sum(s["over_1e5"] for s in sums))), flush=True)
    if args.device != "cpu":
        print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
