#!/usr/bin/env python3
"""``solve_batch``'s in-batch Schur rung in ``ipx`` and in the port, each
started from the same stage-1 best iterate, on the CPU: where a rescued
lane ends, and how far its objective is from the constructed optimum.

    JAX_PLATFORMS=cpu python probes/schur_rung_cpu.py [--m-lo 320]
        [--m-seed 0] [--seed0 0] [--n-lps 48] [--lanes 46,35]
        [--route xla|throughput] [--trace] [--save FILE.npz]

The LPs are ``chip_smoke.py``'s ``solve_many`` workload (``--m-lo 320
--m-seed 0 --seed0 0``) or another set of it: ``random_feasible_lp(m, 2m,
seed=seed0 + i)``, m drawn from m_lo-1024 with
``np.random.default_rng(m_seed)``.  Every lane of the 1024 x 2048 bucket
(or those of ``--lanes``) is padded as ``solve_many`` pads it and run
alone, float32, under ``SolverOptions.throughput()`` (``--route xla``, the
default, with the library routes ``chol_backend="xla",
matvec_backend="xla"``; ``throughput`` takes the Pallas kernels, which the
CPU interprets, minutes a lane).  For each lane ``ipx``'s stage 1 ends
STALLED: its best iterate is warm-started on ``linsys="augmented_schur"``,
``refactor_period=1`` in both packages (``ipx``'s ``vmap`` of
``warm_start_state`` and ``_run_batch_resumed``, the port's
``warm_start_state`` and ``_run_batch``), as ``solve_batch`` does.  One
JSON line per such lane: per package the rung's status, iterations, gap,
and in float64 on the original LP the primal residual, the objective's
error against the constructed optimum and its residual part
y*ᵀ(Ax − b).  A summary line ends it.  Seconds per lane.  ``--save``
writes each such lane's seed, m and stage-1 best iterate (float32) to an
``.npz`` that ``probes/schur_rung_card.py`` runs the port's rung from on
the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(3)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import ipx  # noqa: E402
import ipx.api  # noqa: E402
import ipx_torch  # noqa: E402
import ipx_torch.api  # noqa: E402
from ipx.ipm import batched as jbatched  # noqa: E402
from ipx.ipm import mehrotra as jmehrotra  # noqa: E402
from ipx.problem.batching import bucket_shape, pad_lp  # noqa: E402
from ipx.problem.generate import random_feasible_lp  # noqa: E402
from ipx_torch.ipm import mehrotra as tmehrotra  # noqa: E402
from ipx_torch.problem.lp import LP  # noqa: E402

BUCKET = (1024, 2048)
STALLED = int(ipx.Status.STALLED)


def _end(x, it, status, gap, trace, g, with_trace: bool) -> dict:
    """A rung's end, measured in float64 on the original (unpadded) LP."""
    x = np.asarray(x, np.float64)[: g.A.shape[1]]
    scale = 1 + abs(g.obj_star)
    row = dict(status=ipx.Status(int(status)).name, iterations=int(it),
               rel_gap=float(gap),
               rp_rel=float(np.abs(g.A @ x - g.b).max()
                            / (1 + np.abs(g.b).max())),
               obj_rel_err=float(abs(g.c @ x - g.obj_star) / scale),
               residual_part=float(g.y_star @ (g.A @ x - g.b)) / scale)
    if with_trace:    # mu, rp_rel, rd_rel, rel_gap, alpha_p, alpha_d
        row["trace"] = [[float(f"{v:.3g}") for v in r[:6]]
                        for r in np.asarray(trace, np.float64)[: int(it)]]
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--m-lo", type=int, default=320)
    ap.add_argument("--m-seed", type=int, default=0)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--n-lps", type=int, default=48)
    ap.add_argument("--lanes", default=None)
    ap.add_argument("--route", choices=("xla", "throughput"), default="xla")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--save", default=None)
    args = ap.parse_args()
    ms = np.random.default_rng(args.m_seed).integers(args.m_lo, 1025,
                                                     args.n_lps)
    lanes = ([int(v) for v in args.lanes.split(",")] if args.lanes else
             [i for i, m in enumerate(ms)
              if bucket_shape(int(m), 2 * int(m)) == BUCKET])
    extra = (dict(chol_backend="xla", matvec_backend="xla")
             if args.route == "xla" else {})
    jopts = ipx.SolverOptions.throughput(**extra)
    jsch = jopts.replace(linsys="augmented_schur", refactor_period=1)
    tsch = ipx_torch.SolverOptions.throughput(**extra).replace(
        linsys="augmented_schur", refactor_period=1)
    ends, saved = [], {}
    for lane in lanes:
        g = random_feasible_lp(int(ms[lane]), 2 * int(ms[lane]),
                               seed=args.seed0 + lane)
        blp = jbatched.stack_lps([pad_lp(g.c, g.A, g.b, *BUCKET).lp]
                                 ).astype(jnp.float32)
        st = ipx.api._run_batch(blp, jopts)
        if int(st.status[0]) != STALLED:
            continue
        best = [np.asarray(v) for v in (st.best_x, st.best_y, st.best_s)]
        for name, v in zip("xys", best):
            saved[f"{lane}_{name}"] = v[0]
        saved[f"{lane}_a_sum"] = np.float64(g.A.sum())
        state0 = jax.vmap(lambda lp, x, y, s: jmehrotra.warm_start_state(
            lp, x, y, s, jsch))(blp, *map(jnp.asarray, best))
        r = ipx.api._run_batch_resumed(blp, jsch, state0)
        tlp = LP(**{f: torch.from_numpy(np.array(getattr(blp, f)))
                    for f in ("c", "A", "b")}, obj_offset=torch.zeros(1))
        tr = ipx_torch.api._run_batch(tlp, tsch, tmehrotra.warm_start_state(
            tlp, *map(torch.from_numpy, best), tsch))
        row = dict(lane=lane, seed=args.seed0 + lane, m=int(ms[lane]),
                   stage1_iterations=int(st.it[0]),
                   ipx=_end(r.x[0], r.it[0], r.status[0], r.rel_gap[0],
                            r.trace[0], g, args.trace),
                   port=_end(tr.x[0].numpy(), tr.it[0], tr.status[0],
                             tr.rel_gap[0], tr.trace[0].numpy(), g,
                             args.trace))
        ends.append(row)
        print(json.dumps(row), flush=True)

    if args.save:
        np.savez(args.save, lanes=np.array([e["lane"] for e in ends]),
                 seeds=np.array([e["seed"] for e in ends]),
                 ms=np.array([e["m"] for e in ends]),
                 ipx_obj_rel_err=np.array([e["ipx"]["obj_rel_err"]
                                           for e in ends]),
                 **saved)

    def summary(pkg):
        opt = [e[pkg] for e in ends if e[pkg]["status"] == "OPTIMAL"]
        return dict(optimal=len(opt),
                    optimal_over_1e5=sum(o["obj_rel_err"] > 1e-5
                                         for o in opt),
                    max_obj_rel_err_optimal=max(
                        (o["obj_rel_err"] for o in opt), default=None),
                    max_rp_rel_optimal=max((o["rp_rel"] for o in opt),
                                           default=None),
                    # ended with the gap met but its residual over 1e-5 in
                    # the objective, whatever the status
                    gap_met_over_1e5=sum(
                        e[pkg]["rel_gap"] <= 1e-6
                        and e[pkg]["obj_rel_err"] > 1e-5 for e in ends))
    print(json.dumps(dict(m_seed=args.m_seed, seed0=args.seed0,
                          m_lo=args.m_lo, route=args.route,
                          lanes=len(lanes), stalled=len(ends),
                          ipx=summary("ipx"), port=summary("port"))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
