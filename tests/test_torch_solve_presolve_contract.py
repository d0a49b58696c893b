"""``ipx_torch.solve(c, A, b)`` with its default presolve, on the
benchmark's single-LP instances (``lpbench/gen_host.py``: badly scaled
float64 data with redundant rows and a known optimum), held to the
contract in the user's units: x >= 0 and s >= 0, the gap x.s / (1 + |c.x|)
within ``tol``, both relative residuals within the solver's feasibility
tolerance, the objective at the constructed optimum and at HiGHS's.  Also
the generator's invariants, presolve's dropped rows and counters, the
spans of presolve and postsolve, ``solve_general`` on the same LPs,
the continued solve where the polished answer falls short, and the
polishes from one LU of the support's square system against the least
squares they replace."""
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

import ipx_torch
from ipx_torch import api, obs
from ipx_torch.problem.lp import GeneralLP
from ipx_torch.problem import presolve as presolve_mod
from ipx_torch.problem.presolve import presolve
from lpbench import gen_host, harness

torch.set_num_threads(1)

CFG = harness.load_config("dense_lp_presolve")
TOL = 1e-6
TOL_FEAS = 16 * float(np.finfo(np.float32).eps)     # 1.9073486328125e-06
OBJ = CFG["limits"]["obj"]
# (m, n, redundant rows of each kind)
SHAPES = {"96x192": (96, 192, 2), "256x512": (256, 512, 4)}
# seeds whose answer before the dual polish had a user-unit gap above tol
CASES = [(shape, seed) for shape in SHAPES for seed in (2, 3, 6)]


@pytest.fixture(autouse=True, scope="module")
def _numpy_blas_on_one_thread():
    """numpy's BLAS spins its threads against the other test workers'; one
    thread for this module's tests, where threadpoolctl is installed."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1):
        yield


def _cfg(shape):
    m, n, k = SHAPES[shape]
    return dict(CFG, m=m, n=n, duplicate_rows=k, combined_rows=k)


def _lp(shape, seed):
    return gen_host.instance(_cfg(shape), seed, 0)


_SOLVED = {}


def _solved(shape, seed):
    """The CPU solve of one instance, shared by the tests that judge it."""
    if (shape, seed) not in _SOLVED:
        lp = _lp(shape, seed)
        _SOLVED[shape, seed] = lp, ipx_torch.solve(lp["c"], lp["A"], lp["b"],
                                                   device="cpu")
    return _SOLVED[shape, seed]


@pytest.mark.parametrize("shape", [*SHAPES, "1024x2048"])
def test_generator_invariants(shape):
    cfg = (_cfg(shape) if shape in SHAPES else CFG)
    lp = gen_host.instance(cfg, 2 ** 31 + 7, 5)
    A, b, c = lp["A"], lp["b"], lp["c"]
    x, y, s = lp["x_star"], lp["y_star"], lp["s_star"]
    m, n = cfg["m"], cfg["n"]
    k = cfg["duplicate_rows"] + cfg["combined_rows"]
    assert A.shape == (m, n) and A.dtype == np.float64
    u = np.finfo(np.float64).eps
    assert np.abs(A @ x - b).max() <= 4 * n * u * (np.abs(A) @ x).max()
    assert np.abs(A.T @ y + s - c).max() \
        <= 4 * m * u * (np.abs(A.T) @ np.abs(y) + s).max()
    assert (x >= 0).all() and (s >= 0).all() and x @ s == 0
    assert ((x > 0).sum(), (s > 0).sum()) == (m - k, n - m + k)
    assert (y[lp["redundant"]] == 0).all() and lp["redundant"].sum() == k
    # three decades of scale spread in rows and columns
    rows = np.abs(A).max(axis=1)
    assert rows.max() / rows.min() > 100
    assert np.linalg.matrix_rank(A) == m - k


@pytest.mark.parametrize("shape,seed", CASES)
def test_solve_meets_the_contract_in_user_units(shape, seed):
    lp, sol = _solved(shape, seed)
    c, A, b = lp["c"], lp["A"], lp["b"]
    assert sol.optimal, (sol.status_name, sol.iteration_table())
    assert (sol.x >= 0).all() and (sol.s >= 0).all()
    rp = np.abs(A @ sol.x - b).max() / (1 + np.abs(b).max())
    rd = np.abs(A.T @ sol.y + sol.s - c).max() / (1 + np.abs(c).max())
    assert rp <= TOL_FEAS and rd <= TOL_FEAS
    star = float(c @ lp["x_star"])
    for got in (sol.objective, float(c @ sol.x)):
        assert abs(got - star) <= OBJ * (1 + abs(star))
    ref = linprog(c, A_eq=A, b_eq=b, method="highs")
    assert ref.status == 0
    assert abs(sol.objective - ref.fun) <= TOL * (1 + abs(ref.fun))


@pytest.mark.parametrize("shape,seed", CASES)
def test_reported_gap_is_the_user_unit_gap(shape, seed):
    """The gap of the returned x and of s cut at 0, in the user's units,
    is within ``tol``, and ``rel_gap``, ``rp_rel``, ``rd_rel`` report that
    answer's own measures."""
    lp, sol = _solved(shape, seed)
    c, A, b = lp["c"], lp["A"], lp["b"]
    cx = float(c @ sol.x)
    gap = float(sol.x @ np.maximum(sol.s, 0)) / (1 + abs(cx))
    assert gap <= TOL
    assert sol.rel_gap == pytest.approx(gap, rel=1e-9, abs=1e-15)
    assert sol.rp_rel == pytest.approx(
        np.abs(A @ sol.x - b).max() / (1 + np.abs(b).max()), abs=1e-15)
    cut = np.maximum(A.T @ sol.y - c, 0).max() / (1 + np.abs(c).max())
    assert sol.rd_rel == pytest.approx(cut, abs=1e-15)


@pytest.mark.parametrize("shape", SHAPES)
def test_presolve_drops_the_redundant_rows(shape):
    """Presolve keeps a set of rows of full rank m - k and drops k: the
    duplicates by the reduction loop or the QR, the combinations by the
    QR; the counters say how many each dropped."""
    cfg = _cfg(shape)
    lp = _lp(shape, 3)
    k = cfg["duplicate_rows"] + cfg["combined_rows"]
    with obs.tracing() as t:
        with obs.span(obs.CALL):
            pres = presolve(lp["c"], lp["A"], lp["b"])
    cnt = t.summary()["counters"]
    assert pres.status == "ok" and pres.A.shape == (cfg["m"] - k, cfg["n"])
    assert np.linalg.matrix_rank(lp["A"][pres.kept_rows]) == cfg["m"] - k
    dropped = (cnt["api.presolve.rows_dropped"]
               + cnt["api.presolve.rank_dropped"])
    assert dropped == k
    assert cnt["api.presolve.rank_dropped"] >= cfg["combined_rows"]
    assert cnt["api.presolve.cols_fixed"] == 0


@pytest.mark.parametrize("seed", range(3))
def test_equal_rows_found_as_a_sort_finds_them(seed):
    """Each row's first equal row, by hash, is the one ``np.unique``'s sort
    names, and ``-0.0`` equals ``0.0``."""
    rng = np.random.default_rng(seed)
    R = np.round(rng.standard_normal((40, 7)), 1)
    R[rng.choice(40, 12)] = R[rng.choice(40, 12)]
    R[:, 0] = np.where(rng.random(40) < 0.5, 0.0, -0.0)
    rep = presolve_mod._first_equal_rows(R)
    _, first, inv = np.unique(R, axis=0, return_index=True,
                              return_inverse=True)
    np.testing.assert_array_equal(rep, first[inv.ravel()])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("shift", [0.0, 1e-3, -1e-2])
def test_dropped_rows_are_tested_for_consistency(shape, shift):
    """The QR's dependent rows are fitted by the kept ones: a consistent
    right-hand side passes, and a combined row's b moved makes the LP
    infeasible."""
    lp = _lp(shape, 3)
    A, b = lp["A"], lp["b"].copy()
    rep = presolve_mod._first_equal_rows(
        np.round(A / np.abs(A).max(axis=1, keepdims=True), 12))
    alone = np.bincount(rep, minlength=len(rep)) == 1
    # a redundant row that no other row equals: the QR, not the reduction
    # loop, drops it
    i = np.flatnonzero(lp["redundant"] & alone & (rep == np.arange(len(rep))))[0]
    b[i] += shift * (1.0 + np.abs(b).max())
    pres = presolve(lp["c"], lp["A"], b)
    assert pres.status == ("ok" if shift == 0.0 else "infeasible")


def test_spans_nest_under_the_call():
    lp = _lp("96x192", 2)
    with obs.tracing() as t:
        sol = ipx_torch.solve(lp["c"], lp["A"], lp["b"], device="cpu")
    assert sol.optimal
    names = [r.name for r in t.spans]
    parent = {r.name: t.spans[r.parent].name if r.parent >= 0 else None
              for r in t.spans}
    assert parent["api.call"] is None
    assert parent["api.presolve"] == "api.call"
    for stage in ("reduce", "scale", "rank"):
        assert parent["api.presolve." + stage] == "api.presolve"
    assert parent["api.postsolve"] == "api.call"
    assert parent["api.polish"] == "api.postsolve"
    assert parent["api.postsolve.certify"] == "api.postsolve"
    assert names.index("api.presolve") < names.index("ipm.start") \
        < names.index("api.postsolve")
    assert all(r.call == 0 for r in t.spans)
    cnt = t.summary()["counters"]
    assert cnt["api.polish.accepted"] in (0, 1)
    assert cnt["api.polish.lu"] == 2
    assert cnt["api.postsolve.dual_accepted"] == 1
    assert cnt["api.postsolve.resumes"] == 0
    assert cnt["api.presolve.rows_dropped"] \
        + cnt["api.presolve.rank_dropped"] == 4


@pytest.mark.parametrize("seed", [3, 6])
def test_solve_general_meets_the_contract(seed):
    """The same LP as a GeneralLP: its standard form is the LP itself, so
    the answer is held to the same contract there."""
    lp = _lp("96x192", seed)
    c, A, b = lp["c"], lp["A"], lp["b"]
    sol = ipx_torch.solve_general(GeneralLP(c=c, A_eq=A, b_eq=b),
                                  device="cpu")
    assert sol.optimal, sol.status_name
    s = c - A.T @ sol.y
    cx = float(c @ sol.x)
    assert (sol.x >= 0).all()
    assert float(sol.x @ np.maximum(s, 0)) / (1 + abs(cx)) <= TOL
    assert np.abs(A @ sol.x - b).max() / (1 + np.abs(b).max()) <= TOL_FEAS
    assert np.maximum(-s, 0).max() / (1 + np.abs(c).max()) <= TOL_FEAS
    assert max(sol.rel_gap, sol.rp_rel / TOL_FEAS * TOL,
               sol.rd_rel / TOL_FEAS * TOL) <= TOL
    star = float(c @ lp["x_star"])
    assert abs(sol.objective - star) <= OBJ * (1 + abs(star))


def _loose_stage_1(monkeypatch, factor):
    """Stage 1 (no start state) stops at ``factor`` times the gap
    tolerance, as a reduced solve whose OPTIMAL answer falls short of the
    contract once unscaled; a continued solve runs as asked."""
    run = api._run_batch

    def loose(lp, opts, state0=None):
        if state0 is None:
            opts = opts.replace(tol=opts.tol * factor)
        return run(lp, opts, state0)
    monkeypatch.setattr(api, "_run_batch", loose)


def test_a_short_answer_continues_the_reduced_solve(monkeypatch):
    lp = _lp("256x512", 6)
    _loose_stage_1(monkeypatch, 20.0)
    with obs.tracing() as t:
        sol = ipx_torch.solve(lp["c"], lp["A"], lp["b"], device="cpu")
    cnt = t.summary()["counters"]
    assert cnt["api.postsolve.resumes"] == 1
    assert "api.postsolve.resume" in t.summary()["spans"]
    assert sol.optimal and sol.rel_gap <= TOL and (sol.s >= 0).all()
    assert max(sol.rp_rel, sol.rd_rel) <= TOL_FEAS
    star = float(lp["c"] @ lp["x_star"])
    assert abs(sol.objective - star) <= OBJ * (1 + abs(star))


def test_a_suite_lp_needs_the_continued_solve():
    """A Netlib-style suite LP (``tests/test_netlib_suite.py``'s seed 12)
    at ``tol`` 5e-7: the reduced solve meets it in scaled units, the
    polished answer misses it in the standard form's (x.s at about 5.1e-7),
    and one continued solve brings it within."""
    from ipx_torch.problem.generate import random_general_lp
    glp = random_general_lp(seed=12, n=35, m_eq=8, m_ub=18, scale_spread=2.0)
    opts = ipx_torch.SolverOptions(dtype="float32", tol=5e-7)
    with obs.tracing() as t:
        sol = ipx_torch.solve_general(glp, opts, device="cpu")
    assert t.summary()["counters"]["api.postsolve.resumes"] == 1
    assert sol.optimal and sol.rel_gap <= 5e-7
    assert max(sol.rp_rel, sol.rd_rel) <= TOL_FEAS


def test_an_answer_that_stays_short_is_not_optimal(monkeypatch):
    """Where the continued solve cannot help (here: it returns the state it
    was given), the answer is reported STALLED, not OPTIMAL."""
    lp = _lp("256x512", 6)
    _loose_stage_1(monkeypatch, 20.0)
    monkeypatch.setattr(api, "_continue_reduced",
                        lambda blp, st, opts, tol: st)
    sol = ipx_torch.solve(lp["c"], lp["A"], lp["b"], device="cpu")
    assert sol.status == int(ipx_torch.Status.STALLED)
    assert sol.rel_gap > TOL and (sol.s >= 0).all()


def _degenerate(lp):
    """The LP with one column of x*'s support set to 0 and b = A x* made
    again: x* stays optimal, on one column fewer than the rows presolve
    keeps, so the support the polishes find is not square."""
    x = lp["x_star"].copy()
    x[np.flatnonzero(x > 0)[0]] = 0.0
    return dict(lp, x_star=x, b=lp["A"] @ x)


def _both_ways(lp):
    """``_postsolve_answer`` of the CPU reduced solve of ``lp``, as it runs
    and with the LU refused (the least squares alone): each answer with
    its counters."""
    c, A, b = lp["c"], lp["A"], lp["b"]
    opts = ipx_torch.SolverOptions()
    pres = presolve(c, A, b)
    red = api._states_to_solutions(*api._solve_reduced(pres, opts, "cpu"))[0]
    assert red.optimal
    out = []
    for refused in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if refused:
                mp.setattr(api._SupportLU, "_lu", lambda self, S: None)
            with obs.tracing() as t:
                ans = api._postsolve_answer(pres, red, c, A, b, opts,
                                            polish=True, device="cpu")
        out.append((ans, t.summary()["counters"]))
    return out


@pytest.mark.parametrize("shape,seed", CASES)
def test_the_lu_polishes_answer_as_the_least_squares_ones(shape, seed):
    """Where the support is the optimal basis, B = A[kept rows, S] is
    square: one LU serves both polishes, and x, s, b.y and the three
    measures (each already relative) agree with the least squares' to
    1e-10; both answers meet the contract."""
    lp = _lp(shape, seed)
    (lu, cnt_lu), (ls, cnt_ls) = _both_ways(lp)
    assert (cnt_lu["api.polish.lu"], cnt_ls["api.polish.lu"]) == (2, 0)
    b = lp["b"]

    def close(u, v):
        return np.abs(u - v).max() <= 1e-10 * (1 + np.abs(v).max())
    assert close(lu.x, ls.x) and close(lu.s, ls.s)
    assert close(b @ lu.y, b @ ls.y)
    for f in ("rel_gap", "rp_rel", "rd_rel"):
        assert abs(getattr(lu, f) - getattr(ls, f)) <= 1e-10
    for ans in (lu, ls):
        assert ans.merit <= 1.0
        assert (ans.x >= 0).all() and (ans.s >= 0).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_a_support_that_is_not_square_takes_the_least_squares(shape):
    """A degenerate optimum: the LU serves neither polish, and the answer
    is the least squares' own, bit for bit."""
    (lu, cnt_lu), (ls, _) = _both_ways(_degenerate(_lp(shape, 3)))
    assert cnt_lu["api.polish.lu"] == 0
    np.testing.assert_array_equal(lu.x, ls.x)
    np.testing.assert_array_equal(lu.y, ls.y)
    assert lu.merit <= 1.0


def test_a_view_of_A_with_negative_strides_polishes_from_the_lu():
    """The user's A as a reversed view (torch takes no negative strides):
    the LU still serves both polishes."""
    lp = _lp("96x192", 2)
    A = lp["A"][::-1].copy()[::-1]
    assert A.strides[0] < 0
    with obs.tracing() as t:
        sol = ipx_torch.solve(lp["c"], A, lp["b"], device="cpu")
    assert sol.optimal
    assert t.summary()["counters"]["api.polish.lu"] == 2


@pytest.fixture
def card():
    """Skips a test that needs the card where there is none (decided in the
    test, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")


def test_card_polishes_from_one_lu_at_the_cell_shape(card, monkeypatch):
    """One LP of the configuration, m=1024, n=2048, through ``solve`` on
    the card: both polishes from LUs factored there, and the answer within
    the configuration's limits as the benchmark's reference reads them."""
    lp = gen_host.instance(CFG, 2 ** 31 + 11, 0)
    c, A, b = lp["c"], lp["A"], lp["b"]
    factored_on = []
    lu_factor_ex = torch.linalg.lu_factor_ex

    def spy(B, *args, **kwargs):
        factored_on.append(B.device.type)
        return lu_factor_ex(B, *args, **kwargs)
    monkeypatch.setattr(torch.linalg, "lu_factor_ex", spy)
    with obs.tracing() as t:
        sol = ipx_torch.solve(c, A, b)
    assert t.summary()["counters"]["api.polish.lu"] == 2
    assert factored_on and set(factored_on) == {"cuda"}
    lim = CFG["limits"]
    assert sol.optimal and (sol.x >= 0).all() and (sol.s >= 0).all()
    cx = float(c @ sol.x)
    assert float(sol.x @ sol.s) / (1 + abs(cx)) <= lim["gap"]
    assert np.abs(A @ sol.x - b).max() / (1 + np.abs(b).max()) <= lim["rp"]
    assert np.abs(A.T @ sol.y + sol.s - c).max() / (1 + np.abs(c).max()) \
        <= lim["rd"]
    star = float(c @ lp["x_star"])
    for got in (sol.objective, cx):
        assert abs(got - star) <= lim["obj"] * (1 + abs(star))
