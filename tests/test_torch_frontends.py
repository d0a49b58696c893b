"""The port's front ends on the CPU: ``solve_general`` on the Netlib-style
suite against HiGHS, ``solve_mps`` on the committed fixtures, ``solve``
with its default presolve, ``solve_many`` on mixed sizes, and two suite
instances through both packages."""
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

import ipx
import ipx_torch
from ipx.problem.generate import random_general_lp as j_random_general_lp
from ipx_torch.problem.generate import random_feasible_lp, random_general_lp
from ipx_torch.problem.mps import read_mps

from test_mps_fixtures import CLASSIC, FIXTURES, _path
from test_netlib_suite import SUITE

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _numpy_blas_on_one_thread():
    """numpy's BLAS spins its threads against the other test workers' (the
    presolve QR, the polish's lstsq); one thread for this module's tests,
    where threadpoolctl is installed."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1):
        yield


def _highs(glp):
    return linprog(glp.c, A_ub=glp.A_ub, b_ub=glp.b_ub,
                   A_eq=glp.A_eq, b_eq=glp.b_eq,
                   bounds=list(zip(glp.lb, glp.ub)), method="highs")


def _check_general(glp, sol, ref_fun):
    """``tests/test_netlib_suite.py``'s limits: OPTIMAL, 1e-6 relative
    objective, rows and bounds feasible to 1e-5 in original units."""
    assert sol.optimal, (sol.status_name, sol.iteration_table())
    rel = abs(sol.objective - ref_fun) / (1 + abs(ref_fun))
    assert rel <= 1e-6, f"rel obj err {rel:.2e}"
    viol_ub = (glp.A_ub @ sol.x - glp.b_ub).max(initial=0.0)
    viol_eq = np.abs(glp.A_eq @ sol.x - glp.b_eq).max(initial=0.0)
    scale = 1 + max(np.abs(glp.b_ub).max(initial=0.0),
                    np.abs(glp.b_eq).max(initial=0.0))
    assert viol_ub <= 1e-5 * scale
    assert viol_eq <= 1e-5 * scale
    assert np.all(sol.x >= glp.lb - 1e-5)
    assert np.all(sol.x <= glp.ub + 1e-5)


@pytest.mark.parametrize("cfg", SUITE, ids=lambda c: f"synth{c['seed']}")
def test_solve_general_suite_vs_highs(cfg):
    glp = random_general_lp(**cfg)
    ref = _highs(glp)
    assert ref.status == 0
    sol = ipx_torch.solve_general(
        glp, ipx_torch.SolverOptions(dtype="float32", tol=5e-7), device="cpu")
    _check_general(glp, sol, ref.fun)
    assert sol.y.shape == (glp.A_eq.shape[0] + glp.A_ub.shape[0],)
    assert sol.s.shape == (glp.n,)


@pytest.mark.parametrize("name", FIXTURES)
def test_solve_mps_fixtures_vs_highs(name):
    glp = read_mps(_path(name))
    ref = _highs(glp)
    assert ref.status == 0
    ref_obj = ref.fun + glp.obj_offset
    if getattr(glp, "maximize", False):
        ref_obj = -ref_obj
    sol = ipx_torch.solve_mps(_path(name), device="cpu")
    assert sol.optimal, sol.status_name
    assert abs(sol.objective - ref_obj) <= 1e-6 * (1 + abs(ref_obj))


@pytest.mark.parametrize("name,obj,xstar", CLASSIC)
def test_solve_mps_classic_pinned_optimum(name, obj, xstar):
    sol = ipx_torch.solve_mps(_path(name), ipx_torch.SolverOptions(
        dtype="float64", tol=1e-11, max_iter=128), device="cpu")
    assert sol.optimal, sol.status_name
    assert abs(sol.objective - obj) <= 1e-9 * (1 + abs(obj)), sol.objective
    np.testing.assert_allclose(sol.x, xstar, atol=1e-7)


def test_solve_default_presolve_rank_deficient():
    """``solve(c, A, b)`` with its default presolve survives dependent rows
    and bad scaling (``ipx``'s
    ``test_solve_presolve_flag_rank_deficient``, same instance)."""
    rng = np.random.default_rng(3)
    m, n = 25, 50
    A = rng.standard_normal((m, n))
    A[m - 1] = A[0] + 0.5 * A[1]
    A *= 10.0 ** rng.uniform(-2, 2, size=(m, 1))
    x0 = np.abs(rng.standard_normal(n)) + 0.1
    b = A @ x0
    c = np.abs(rng.standard_normal(n)) + 0.1
    ref = linprog(c, A_eq=A, b_eq=b, method="highs")
    sol = ipx_torch.solve(c, A, b, device="cpu")
    assert sol.optimal, sol.status_name
    assert abs(sol.objective - ref.fun) <= 2e-6 * (1 + abs(ref.fun))
    assert np.abs(A @ sol.x - b).max() <= 1e-4 * (1 + np.abs(b).max())
    assert sol.y.shape == (m,) and sol.x.shape == (n,)


def test_solve_presolve_settles_without_a_solve():
    """An LP that presolve settles alone: every variable fixed (OPTIMAL,
    no iteration) and an inconsistent one (PRIMAL_INFEASIBLE)."""
    A = np.array([[1.0, 2.0], [2.0, 4.0], [1.0, 0.0]])
    sol = ipx_torch.solve(np.ones(2), A, np.array([3.0, 6.0, 1.0]),
                          device="cpu")
    assert sol.optimal and sol.iterations == 0
    np.testing.assert_allclose(sol.x, [1.0, 1.0])
    assert sol.objective == 2.0 and sol.rel_gap == 0.0
    bad = ipx_torch.solve(np.ones(2), A[:2], np.array([3.0, 7.0]),
                          device="cpu")
    assert bad.status == int(ipx_torch.Status.PRIMAL_INFEASIBLE)


def test_solve_many_mixed_sizes_match_own_solves():
    """Mixed sizes in two buckets: each lane as its own solve (no
    presolve, same options) reaches the same objective, and the reported
    quantities are those of the original, unpadded LP."""
    shapes = [(10, 25), (12, 30), (40, 90), (11, 28), (36, 80)]
    gs = [random_feasible_lp(m, n, seed=i) for i, (m, n) in enumerate(shapes)]
    opts = ipx_torch.SolverOptions(dtype="float64", tol=1e-9, tol_feas=1e-9)
    sols = ipx_torch.solve_many([(g.c, g.A, g.b) for g in gs], options=opts,
                                m_multiple=8, n_multiple=16, device="cpu")
    for g, s, (m, n) in zip(gs, sols, shapes):
        own = ipx_torch.solve(g.c, g.A, g.b, options=opts, presolve=False,
                              device="cpu")
        assert s.optimal and own.optimal
        assert s.x.shape == (n,) and s.y.shape == (m,) and s.s.shape == (n,)
        assert abs(s.objective - own.objective) <= 1e-7 * (1 + abs(own.objective))
        assert abs(s.objective - g.obj_star) <= 1e-7 * (1 + abs(g.obj_star))
        assert s.objective == float(g.c @ s.x)


@pytest.mark.parametrize("seed", [1, 18])
def test_solve_general_both_packages(seed):
    """One suite instance through both packages' ``solve_general``: the
    same status, objectives within 1e-6 relative."""
    cfg = next(c for c in SUITE if c["seed"] == seed)
    opts = dict(dtype="float32", tol=5e-7)
    j = ipx.solve_general(j_random_general_lp(**cfg), ipx.SolverOptions(**opts))
    t = ipx_torch.solve_general(random_general_lp(**cfg),
                                ipx_torch.SolverOptions(**opts), device="cpu")
    assert t.status == j.status == int(ipx_torch.Status.OPTIMAL)
    assert abs(t.objective - j.objective) <= 1e-6 * (1 + abs(j.objective))
    assert t.x.shape == j.x.shape and t.y.shape == j.y.shape
