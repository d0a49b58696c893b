#!/usr/bin/env python3
"""The port's in-batch Schur rung on the card, started from the stage-1
best iterates that ``probes/schur_rung_cpu.py --save`` wrote (``ipx``'s,
on the CPU), on the kernel route and on the library route: how much of
where a rescued lane ends is the route's.

    python3 probes/schur_rung_card.py FILE.npz [FILE.npz ...] [--device cpu]

Each saved lane's LP is made again (``random_feasible_lp(m, 2m,
seed)``; the script stops if its A's sum is not the saved one),
padded to 1024 x 2048 as ``solve_many`` pads it, and warm-started alone
(B=1, float32) from the saved iterate on ``linsys="augmented_schur"``,
``refactor_period=1``, under ``SolverOptions.throughput()`` (the kernel
route: the reduced factor on rows 4, 5b, 6 and 7) and under it with
``chol_backend="xla", matvec_backend="xla"`` (the library route).  One
JSON line per lane: per route the status, iterations, gap, primal residual
and the objective's error against the constructed optimum, both in float64
on the original LP; then a summary per route and the card's name and power
limit.
"""
from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import ipx_torch                                          # noqa: E402
import ipx_torch.api                                      # noqa: E402
from ipx_torch.devinfo import nvidia_smi_line             # noqa: E402
from ipx_torch.ipm import mehrotra                        # noqa: E402
from ipx_torch.kernels import _build                      # noqa: E402
from ipx_torch.problem.batching import pad_lp             # noqa: E402
from ipx_torch.problem.generate import random_feasible_lp  # noqa: E402
from ipx_torch.problem.lp import LP                       # noqa: E402

BUCKET = (1024, 2048)
ROUTES = {"kernels": {},
          "library": dict(chol_backend="xla", matvec_backend="xla")}


def _end(st, g) -> dict:
    x = st.x[0].double().cpu().numpy()[: g.A.shape[1]]
    scale = 1 + abs(g.obj_star)
    return dict(status=ipx_torch.Status(int(st.status[0])).name,
                iterations=int(st.it[0]), rel_gap=float(st.rel_gap[0]),
                rp_rel=float(np.abs(g.A @ x - g.b).max()
                             / (1 + np.abs(g.b).max())),
                obj_rel_err=float(abs(g.c @ x - g.obj_star) / scale))


def main() -> int:
    args = sys.argv[1:]
    dev = "cpu" if "--device" in args and args[args.index("--device") + 1] \
        == "cpu" else "cuda"
    files = [a for a in args if a.endswith(".npz")]
    if dev == "cuda":
        if not torch.cuda.is_available():
            sys.exit("schur_rung_card: no GPU")
        _build.build_all()
    ends = []
    for path in files:
        with np.load(path) as z:
            saved = {k: z[k] for k in z.files}
        for lane, seed, m in zip(saved["lanes"], saved["seeds"],
                                 saved["ms"]):
            g = random_feasible_lp(int(m), 2 * int(m), seed=int(seed))
            # a sum's last bits move with the host's SIMD width; another
            # LP moves it by O(1)
            if abs(g.A.sum() - saved[f"{lane}_a_sum"]) > 1e-9:
                sys.exit(f"{path} lane {lane}: the LP made here differs "
                         f"({g.A.sum()!r} against {saved[f'{lane}_a_sum']!r})")
            pad = pad_lp(g.c, g.A, g.b, *BUCKET)
            lp = LP(**{f: torch.as_tensor(getattr(pad, f)[None],
                                          dtype=torch.float32).to(dev)
                       for f in ("c", "A", "b")},
                    obj_offset=torch.zeros(1, device=dev))
            best = [torch.from_numpy(saved[f"{lane}_{v}"][None]).to(dev)
                    for v in "xys"]
            row = dict(file=pathlib.Path(path).name, lane=int(lane),
                       seed=int(seed), m=int(m))
            for route, extra in ROUTES.items():
                opts = ipx_torch.SolverOptions.throughput(**extra).replace(
                    linsys="augmented_schur", refactor_period=1)
                st = ipx_torch.api._run_batch(
                    lp, opts, mehrotra.warm_start_state(lp, *best, opts))
                row[route] = _end(st, g)
            ends.append(row)
            print(json.dumps(row), flush=True)
    for route in ROUTES:
        rows = [e[route] for e in ends]
        opt = [r for r in rows if r["status"] == "OPTIMAL"]
        print(json.dumps(dict(
            route=route, lanes=len(rows), optimal=len(opt),
            optimal_over_1e5=sum(r["obj_rel_err"] > 1e-5 for r in opt),
            optimal_rp_over_1e6=sum(r["rp_rel"] > 1e-6 for r in opt),
            max_obj_rel_err_optimal=max((r["obj_rel_err"] for r in opt),
                                        default=None))), flush=True)
    if dev == "cuda":
        print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
