"""OPTIMAL counts of the augmented routes on degenerate LPs, on the CPU: ipx,
the port as it ships (its library products on these routes summed in
float64, ``numerics.mv_wide``), and the port with one-chain float32 products
(``numerics.mv``) in their place.

    JAX_PLATFORMS=cpu python probes/rescue_sums_cpu.py [B]

B instances (default 16) of m=40, n=80 with an optimal support of 20 (the
degenerate battery of ``tests/test_degenerate.py``, seeds 0..B-1), float32,
``augmented_fallback=False``, on ``linsys="augmented"`` and
``"augmented_schur"``.  Prints one JSON line per route and variant: OPTIMAL
count and summed iterations.  About a minute.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)    # the CPU's batched LU may hang on more threads

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import ipx  # noqa: E402
import ipx_torch  # noqa: E402
from ipx.problem.generate import random_feasible_lp  # noqa: E402
from ipx.problem.lp import make_lp as jmake_lp  # noqa: E402
from ipx_torch import numerics  # noqa: E402
from ipx_torch.linsys import augmented  # noqa: E402
from ipx_torch.problem.lp import make_lp as tmake_lp  # noqa: E402


def main() -> int:
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    gs = [random_feasible_lp(40, 80, seed=s, support=20) for s in range(B)]
    for linsys in ("augmented", "augmented_schur"):
        kw = dict(dtype="float32", linsys=linsys, augmented_fallback=False)
        rows = {"ipx": ipx.solve_batch(
            [jmake_lp(g.c, g.A, g.b) for g in gs],
            options=ipx.SolverOptions(**kw))}
        for variant, prod in (("port", numerics.mv_wide),
                              ("port_one_chain_sums", numerics.mv)):
            augmented.mv_wide = prod
            try:
                rows[variant] = ipx_torch.solve_batch(
                    [tmake_lp(g.c, g.A, g.b, device="cpu") for g in gs],
                    options=ipx_torch.SolverOptions(**kw), device="cpu")
            finally:
                augmented.mv_wide = numerics.mv_wide
        print(json.dumps({"linsys": linsys, "instances": B, **{
            k: {"optimal": sum(s.optimal for s in v),
                "iterations": sum(s.iterations for s in v)}
            for k, v in rows.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
