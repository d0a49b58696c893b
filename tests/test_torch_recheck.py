"""The float64 re-check that turns a batch's final state into Solutions
(``api._states_to_solutions``; ``api._sharded_solutions`` on the
one-process mesh) against the host loop it replaced, kept here as the
reference: A copied to the host in its stored dtype, each lane widened to
float64, two numpy products per lane.

The iterates, trace, status and iterations are copies, and the dot
products are the host's own, so those fields are held bit for bit.  Only
the two residuals are sums taken elsewhere, in float64 in another order:
each is held to 1e-12 of the magnitude of what it sums (|A||x| + |b| over
1 + |b|_inf for the primal one), the most two float64 summation orders of
a few thousand terms can differ by.  No JAX, no GPU.
"""
import numpy as np
import pytest
import torch

import ipx_torch
from ipx_torch import api
from ipx_torch import mesh as meshlib
from ipx_torch.linsys import schur
from ipx_torch.problem.generate import random_feasible_lp

torch.set_num_threads(1)

B, M, N = 3, 48, 96
# A's storage -> the solve's options
CASES = {"bf16": (torch.bfloat16, dict(dtype="float32",
                                       a_storage="bfloat16")),
         "f32": (torch.float32, dict(dtype="float32")),
         "f64": (torch.float64, dict(dtype="float64"))}
EXACT = ("objective", "dual_objective", "rel_gap", "status", "iterations")


def _batch(a_dtype, opts):
    """B instances with A as stored in ``a_dtype`` (b and c formed from
    the stored A, so the constructed optimum is exact), an objective offset
    per lane, prepared as the entries prepare them."""
    lps = []
    for i in range(B):
        g = random_feasible_lp(M, N, seed=70 + i)
        A = torch.from_numpy(g.A).to(a_dtype)
        A64 = A.double().numpy()
        lps.append(ipx_torch.make_lp(
            A64.T @ g.y_star + g.s_star, A, A64 @ g.x_star,
            obj_offset=0.5 * i - 1.0, device="cpu"))
    blp = api._prepare(lps, opts, "cpu")
    assert blp.A.dtype == a_dtype
    return blp


def _host_loop(lp, st) -> list:
    """The re-check as the host made it: every field copied once, A in its
    stored dtype, each lane's A widened to float64 and two numpy products
    per lane; with the magnitudes the residuals sum."""
    h = api._host64
    X, Y, S = h(st.best_x), h(st.best_y), h(st.best_s)
    C, Bv = h(lp.c), h(lp.b)
    off = h(lp.obj_offset)
    A_h = lp.A.detach().to("cpu")
    status = st.status.to("cpu").numpy()
    its = st.it.to("cpu").numpy()
    trace = h(st.trace)
    out = []
    for i in range(X.shape[0]):
        x, y, s, c, b = X[i], Y[i], S[i], C[i], Bv[i]
        A = A_h[i].to(torch.float64).numpy()
        pobj = float(c @ x)
        bn = 1 + np.abs(b).max(initial=0.0)
        cn = 1 + np.abs(c).max(initial=0.0)
        out.append(dict(
            x=x, y=y, s=s, objective=pobj + float(off[i]),
            dual_objective=float(b @ y) + float(off[i]),
            status=int(status[i]), iterations=int(its[i]),
            rel_gap=float((x @ s) / (1 + abs(pobj))),
            rp_rel=float(np.abs(A @ x - b).max(initial=0.0) / bn),
            rd_rel=float(np.abs(A.T @ y + s - c).max(initial=0.0) / cn),
            trace=trace[i],
            rp_scale=float((np.abs(A) @ np.abs(x) + np.abs(b)).max() / bn),
            rd_scale=float((np.abs(A.T) @ np.abs(y) + np.abs(s)
                            + np.abs(c)).max() / cn)))
    return out


def _check(sols, want):
    assert len(sols) == len(want)
    for sol, w in zip(sols, want):
        for f in ("x", "y", "s", "trace"):
            got = getattr(sol, f)
            assert got.dtype == np.float64 and np.array_equal(got, w[f]), f
        for f in EXACT:
            got = getattr(sol, f)
            assert type(got) is type(w[f]) and got == w[f], (f, got, w[f])
        for f in ("rp_rel", "rd_rel"):
            got = getattr(sol, f)
            assert type(got) is float, f
            scale = w[f.replace("_rel", "_scale")]
            assert abs(got - w[f]) <= 1e-12 * scale, (f, got, w[f])


@pytest.mark.parametrize("max_iter", [3, None])
@pytest.mark.parametrize("case", sorted(CASES))
def test_recheck_matches_the_host_loop(case, max_iter):
    """After three steps (MAX_ITER, large residuals) and after a whole
    solve (OPTIMAL), A stored as ``case`` says."""
    a_dtype, kw = CASES[case]
    opts = ipx_torch.SolverOptions(**kw)
    blp = _batch(a_dtype, opts)
    st = api._run_batch(blp, opts.replace(max_iter=max_iter or opts.max_iter))
    sols = api._states_to_solutions(blp, st)
    assert all(s.optimal for s in sols) == (max_iter is None), case
    _check(sols, _host_loop(blp, st))


@pytest.mark.parametrize("case", ["bf16", "f64"])
def test_sharded_recheck_matches_the_host_loop(case):
    """The sharded routes' Solutions are built by the same function,
    through ``schur.matvecs(wide=True)`` on the one-process mesh."""
    a_dtype, kw = CASES[case]
    opts = ipx_torch.SolverOptions(**kw)
    blp = _batch(a_dtype, opts)
    st = api._run_batch(blp, opts)
    with schur.use_mesh(meshlib.make_mesh()):
        sols = api._sharded_solutions(blp, st)
    _check(sols, _host_loop(blp, st))
