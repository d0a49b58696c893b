"""Iterations of ``cg_operator="assembled"`` in ipx and ipx_torch on the same
instances, on the CPU, with the default operator as the control.

    python probes/assembled_cg_cpu.py [m [n [B [seed0 [routes]]]]]
                                      (256 512 16 200 xla)

Each instance comes from ``ipx.problem.generate.random_feasible_lp`` (seeds
seed0..), its A rounded to bf16 and b, c rebuilt so the constructed optimum
is exact.  Both packages solve the batch in float32 under
``throughput(chol_backend="xla", a_storage="bfloat16",
augmented_fallback=False, max_iter=64)`` with each operator, and the port
once more with the assembled operator's product taken in float64
(``f64_operator``: what float64 sums in that operator would give).
``routes`` (comma-separated) adds the port's runs on other factor routes,
both operators each (``pallas``: the right-looking factor's plain version on
the CPU); the JAX side runs ``xla`` only, since its Pallas kernels would run
in interpret mode.  One JSON line per run: OPTIMAL count, median and
per-lane iterations.  The JAX side runs on the CPU.  Takes a few minutes at
the default size, about half an hour at m=1024, n=2048, B=16.
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import torch  # noqa: E402

import ipx  # noqa: E402
import ipx_torch  # noqa: E402
import ipx_torch.linsys.normal_eq as ne  # noqa: E402
from ipx.problem.generate import random_feasible_lp  # noqa: E402
from ipx.problem.lp import make_lp as jmake_lp  # noqa: E402
from ipx_torch.problem.lp import make_lp as tmake_lp  # noqa: E402


def instances(B: int, m: int, n: int, seed0: int):
    out = []
    for i in range(B):
        g = random_feasible_lp(m, n, seed=seed0 + i)
        A = torch.from_numpy(g.A).to(torch.bfloat16).double().numpy()
        out.append((A.T @ g.y_star + g.s_star, A, A @ g.x_star))
    return out


def solve(package: str, insts, cg_operator: str, route: str = "xla"):
    kw = dict(chol_backend=route, a_storage="bfloat16",
              augmented_fallback=False, max_iter=64, cg_operator=cg_operator)
    if package == "ipx":
        return ipx.solve_batch([jmake_lp(c, A, b) for c, A, b in insts],
                               options=ipx.SolverOptions.throughput(**kw))
    return ipx_torch.solve_batch(
        [tmake_lp(c, A, b, device="cpu") for c, A, b in insts],
        options=ipx_torch.SolverOptions.throughput(**kw), device="cpu")


def mv_f64(a, x):
    """``normal_eq.mv`` with the (B, m, m) operator's product in float64,
    rounded once; every other product as before."""
    if a.dtype == torch.float32 and a.shape[-2] == a.shape[-1]:
        return torch.matmul(a.double(), x.double().unsqueeze(-1)).squeeze(
            -1).float()
    return MV(a, x)


MV = ne.mv


def main() -> int:
    args = sys.argv[1:]
    m, n, B, seed0 = [int(a) for a in (args[:4] + ["256", "512", "16",
                                                    "200"][len(args):])][:4]
    routes = [r for r in (args[4] if len(args) > 4 else "xla").split(",")
              if r != "xla"]
    torch.set_num_threads(4)
    insts = instances(B, m, n, seed0)
    runs = [(op, package, "xla") for op in ("matrix_free", "assembled")
            for package in ("ipx", "ipx_torch")]
    runs += [("assembled", "f64_operator", "xla")]
    runs += [(op, "ipx_torch", r) for r in routes
             for op in ("matrix_free", "assembled")]
    for op, package, route in runs:
        t0 = time.time()
        if package == "f64_operator":
            saved, ne.mv = ne.mv, mv_f64
            try:
                sols = solve("ipx_torch", insts, op)
            finally:
                ne.mv = saved
        else:
            sols = solve(package, insts, op, route)
        its = [int(s.iterations) for s in sols]
        print(json.dumps({
            "package": package, "cg_operator": op, "chol_backend": route,
            "m": m, "n": n, "B": B,
            "seed0": seed0, "seconds": round(time.time() - t0, 1),
            "optimal": sum(bool(s.optimal) for s in sols),
            "median_iterations": statistics.median(its),
            "iterations": its}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
