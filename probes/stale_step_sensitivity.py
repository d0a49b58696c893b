"""How far one stale step of ``ipx`` (``refactor_period=2``) moves when its
input moves by one rounding, with and without the KKT refinement sweeps.

    JAX_PLATFORMS=cpu python probes/stale_step_sensitivity.py

f64, the two instances of ``tests/test_torch_step.py`` (m=64, n=128): the
starting state, one fresh step with its factor, then the block's stale
step from that state and from the same state with x scaled by (1 + 1e-15).
Prints the relative change of the stale step's x (inf-norm) under the
default sweeps and with ``kkt_refine_steps = predictor_refine_steps = 0``:
how far apart two implementations' stale steps may land that differ in
rounding only.  A few seconds.
"""
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import ipx  # noqa: E402
from ipx.ipm import batched as jb, mehrotra as jm  # noqa: E402
from ipx.linsys import normal_eq as jne  # noqa: E402
from ipx.problem.generate import random_feasible_lp  # noqa: E402
from ipx.problem.lp import LP  # noqa: E402


def _lp():
    gs = [random_feasible_lp(64, 128, seed=20 + i) for i in range(2)]
    A = np.stack([g.A for g in gs])
    b = np.einsum("bmn,bn->bm", A, np.stack([g.x_star for g in gs]))
    c = (np.einsum("bmn,bm->bn", A, np.stack([g.y_star for g in gs]))
         + np.stack([g.s_star for g in gs]))
    return LP(c=jnp.asarray(c), A=jnp.asarray(A), b=jnp.asarray(b),
              obj_offset=jnp.zeros(2))


def main() -> int:
    lp = _lp()
    for name, extra in (("default_sweeps", {}),
                        ("no_sweeps", dict(kkt_refine_steps=0,
                                           predictor_refine_steps=0))):
        opts = ipx.SolverOptions(dtype="float64", augmented_fallback=False,
                                 max_iter=16, refactor_period=2, **extra)
        stale = opts.replace(refine_steps=opts.stale_solve_cg)
        st, fac_aat = jb.batch_starting_state(lp, opts)
        fac = jax.vmap(lambda a, d, rb: jne.factor(a, d, opts, reg_scale=rb))(
            lp.A, st.x / st.s, st.reg_boost)
        st1 = jax.vmap(lambda l, s_, f, fc: jm.step_masked(
            l, s_, opts, f, fc))(lp, st, fac_aat, fac)
        step = jax.vmap(lambda l, s_, f, fc, b0: jm.step_masked_stale(
            l, s_, stale, f, fc, b0))
        a = np.asarray(step(lp, st1, fac_aat, fac, st.reg_boost).x)
        moved = dataclasses.replace(st1, x=st1.x * (1 + 1e-15))
        b = np.asarray(step(lp, moved, fac_aat, fac, st.reg_boost).x)
        print(json.dumps({"case": name, "stale_step_x_rel_change":
                          float(np.abs(b - a).max() / np.abs(a).max())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
