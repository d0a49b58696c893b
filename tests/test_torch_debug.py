"""``ipx_torch.obs.debug_mode`` and ``checked_solve`` on the CPU against
``ipx``'s.

A healthy LP and the same LP with one row of A zeroed: there ``ipx``'s
``checked_solve`` reports a NaN (its ``checkify`` float checks) and the
port's checks name the first non-finite value, at iteration 0 in the
direction, where the normal matrix's zero row meets the Jacobi scale.  On
the healthy LP the checks stay quiet and change no bit."""
import numpy as np
import pytest
import torch

import ipx_torch
from ipx_torch import obs
from ipx_torch.problem.generate import random_feasible_lp

torch.set_num_threads(1)

SHAPE = dict(m=8, n=16, seed=0)


def _lps():
    """(the healthy LP, the LP with row 2 of A zeroed) as host arrays."""
    g = random_feasible_lp(**SHAPE)
    A = g.A.copy()
    A[2] = 0.0
    return (g.c, g.A, g.b), (g.c, A, g.b)


def _torch_lp(arrays):
    return ipx_torch.make_lp(*arrays, device="cpu")


def test_debug_mode_quiet_on_a_healthy_solve():
    """Under debug_mode a healthy LP solves to OPTIMAL with the bits of a
    plain solve, and the flag is off again after the block."""
    healthy, _ = _lps()
    plain = ipx_torch.solve(_torch_lp(healthy), presolve=False, device="cpu")
    with obs.debug_mode():
        got = ipx_torch.solve(_torch_lp(healthy), presolve=False,
                              device="cpu")
    assert got.status_name == plain.status_name == "OPTIMAL"
    assert got.iterations == plain.iterations
    for f in ("x", "y", "s", "trace"):
        assert np.array_equal(getattr(got, f), getattr(plain, f)), f
    from ipx_torch.ipm import batched
    assert batched.FINITE_CHECK.get() is None


def test_debug_mode_raises_where_ipx_reports_nan():
    """The zeroed-row LP: ``ipx``'s checked_solve reports a NaN; under the
    port's debug_mode the solve raises FloatingPointError naming the
    iteration, the lane and the field, where without it the solver's own
    recovery ends the lane NUMERICAL_FAILURE."""
    import ipx
    from ipx import obs as jobs

    _, bad = _lps()
    err, _ = jobs.checked_solve(ipx.make_lp(*bad))
    assert err.get() is not None and "nan" in err.get()
    plain = ipx_torch.solve(_torch_lp(bad), presolve=False, device="cpu")
    assert plain.status_name == "NUMERICAL_FAILURE"
    with pytest.raises(FloatingPointError,
                       match=r"iteration 0, lane 0: non-finite dx"):
        with obs.debug_mode():
            ipx_torch.solve(_torch_lp(bad), presolve=False, device="cpu")


def test_checked_solve_clean_bits_and_throw():
    """checked_solve on the healthy LP: no error (``throw`` returns), the
    state of a plain run bit for bit; on the zeroed-row LP the first
    failure recorded, ``throw`` raising it, the run ended as without the
    checks."""
    healthy, bad = _lps()
    lp = _torch_lp(healthy)
    err, st = obs.checked_solve(lp)
    assert err.get() is None
    err.throw()
    from ipx_torch.api import _prepare, _run_batch
    opts = ipx_torch.SolverOptions()
    ref = _run_batch(_prepare([lp], opts, "cpu"), opts)
    for f in ("x", "y", "s", "best_x", "status", "it", "trace"):
        assert torch.equal(getattr(st, f), getattr(ref, f)), f
    err, st = obs.checked_solve(_torch_lp(bad))
    assert err.get() == "iteration 0, lane 0: non-finite dx"
    with pytest.raises(FloatingPointError, match="non-finite dx"):
        err.throw()
    assert int(st.status[0]) == int(ipx_torch.Status.NUMERICAL_FAILURE)
