"""The rescue ladder, the augmented routes, warm start and refactor_period of
ipx_torch against ipx, on the CPU at small sizes.

f64 parity: one Newton direction on each augmented route and
``warm_start_state`` from the same seeded inputs.  Control flow: both
packages' run functions replaced by scripts that return set statuses and
iteration counts, so the rung sequence, the state returned and the
cumulative iterations of ``solve`` and ``solve_batch`` are compared rung by
rung, the reference's choices pinned (which lanes are rescued, which
iterations count).  f32: the degenerate batches of ``tests/test_degenerate.py``
through ``ipx_torch.solve_batch(device="cpu")`` with default options, OPTIMAL
counts held to at least ipx's (never lane by lane).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ipx
import ipx.api
import ipx_torch
import ipx_torch.api
from ipx.ipm import mehrotra as jm
from ipx.linsys import augmented as jaug
from ipx.problem.generate import random_feasible_lp
from ipx.problem.lp import LP as JLP, make_lp as jmake_lp
from ipx_torch import convert
from ipx_torch.ipm import mehrotra as tm
from ipx_torch.linsys import augmented as taug
from ipx_torch.problem.lp import make_lp as tmake_lp
from ipx_torch.status import Status

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _numpy_blas_on_one_thread():
    """numpy's BLAS on one thread beside the other test workers, where
    threadpoolctl is installed."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1):
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _obj_rel(sol, obj):
    return abs(sol.objective - obj) / (1 + abs(obj))


# --------------------------------------------------------------------------
# f64 parity of the augmented routes' pieces
# --------------------------------------------------------------------------

def _newton_inputs(B=2, m=40, n=80, support=20):
    """A degenerate instance per lane and a point near its optimum, with
    seeded residuals."""
    rng = np.random.default_rng(7)
    gs = [random_feasible_lp(m, n, seed=i, support=support) for i in range(B)]
    A = np.stack([g.A for g in gs])
    x = np.stack([g.x_star for g in gs]) + 1e-3 * rng.uniform(0.5, 1.5, (B, n))
    s = np.stack([g.s_star for g in gs]) + 1e-3 * rng.uniform(0.5, 1.5, (B, n))
    e_p = rng.standard_normal((B, m))
    e_d = rng.standard_normal((B, n))
    e_xs = x * s * rng.uniform(0.5, 1.5, (B, n))
    return A, x, s, e_p, e_d, e_xs


@pytest.mark.parametrize("linsys", ["augmented", "augmented_schur"])
def test_newton_direction_f64_matches_ipx(linsys):
    A, x, s, e_p, e_d, e_xs = _newton_inputs()
    kw = dict(dtype="float64", linsys=linsys, augmented_fallback=False)
    oj, ot = ipx.SolverOptions(**kw), ipx_torch.SolverOptions(**kw)
    if linsys == "augmented":
        jf, jsolve = jaug.factor, jaug.solve_newton
        tf, tsolve = taug.factor, taug.solve_newton
    else:
        jf, jsolve = jaug.factor_schur, jaug.solve_newton_schur
        tf, tsolve = taug.factor_schur, taug.solve_newton_schur

    def jdir(a, x_, s_, p, d, xs):
        return jsolve(jf(a, x_ / s_, oj), a, x_, s_, p, d, xs, oj)

    want = jax.jit(jax.vmap(jdir))(*(jnp.asarray(v) for v in
                                     (A, x, s, e_p, e_d, e_xs)))
    t = [torch.from_numpy(v) for v in (A, x, s, e_p, e_d, e_xs)]
    fac = tf(t[0], t[1] / t[2], ot)
    assert fac.ok.all()
    got = tsolve(fac, *t, ot)
    for name, g, w in zip(("dx", "dy", "ds"), got, want):
        assert _rel(g.numpy(), w) <= 1e-9, name


def test_warm_start_state_f64_matches_ipx():
    A, x, s, _, _, _ = _newton_inputs()
    rng = np.random.default_rng(3)
    y = rng.standard_normal((A.shape[0], A.shape[1]))
    # one lane converged (products ~0, so warm_start_mu sets the shift),
    # one not
    x[0] = np.where(x[0] > 0.01, x[0], 1e-9)
    c = np.ones((A.shape[0], A.shape[2]))
    b = np.ones((A.shape[0], A.shape[1]))
    kw = dict(dtype="float64", max_iter=12)
    oj, ot = ipx.SolverOptions(**kw), ipx_torch.SolverOptions(**kw)
    jlp = JLP(c=jnp.asarray(c), A=jnp.asarray(A), b=jnp.asarray(b),
              obj_offset=jnp.zeros(A.shape[0]))
    want = jax.vmap(lambda lp, a, b_, c_: jm.warm_start_state(
        lp, a, b_, c_, oj))(jlp, x, y, s)
    tlp = convert.lp_from_numpy(c, A, b, device="cpu", dtype=torch.float64)
    got = convert.state_to_numpy(tm.warm_start_state(
        tlp, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(s),
        ot))
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        if f.name in ("rp", "rd"):      # placeholders in both, refreshed
            continue                     # by every run entry point
        if np.isinf(w).any():
            assert np.array_equal(got[f.name], w), f.name
        else:
            assert _rel(got[f.name], w) <= 1e-12, f.name


# --------------------------------------------------------------------------
# The ladder's control flow, with scripted rung outcomes
# --------------------------------------------------------------------------

S, M, N, O = (int(Status.STALLED), int(Status.MAX_ITER),
              int(Status.NUMERICAL_FAILURE), int(Status.OPTIMAL))
NEAR, FAR = 1e-5, 1e-2      # stage-1 rel_gap: inside / outside 16 x tol

# case -> rung -> (status, iterations[, rel_gap]); a rung left out must not
# run
SCRIPT = {
    "in_batch": {"stage1": (S, 20), "in_batch": (O, 5),
                 "lu_warm": (O, 6)},
    "lu_warm": {"stage1": (S, 20), "in_batch": (S, 7), "lu_warm": (O, 6)},
    "lu_cold": {"stage1": (S, 20), "in_batch": (S, 7), "lu_warm": (S, 9),
                "lu_cold": (O, 11)},
    "schur": {"stage1": (S, 20), "in_batch": (S, 7), "lu_warm": (S, 9),
              "lu_cold": (S, 11), "schur": (O, 4)},
    "none": {"stage1": (S, 20), "in_batch": (S, 7), "lu_warm": (S, 9),
             "lu_cold": (N, 11), "schur": (S, 4)},
    "numerical_failure": {"stage1": (N, 13), "in_batch": (S, 7),
                          "lu_warm": (O, 6)},
    "near_miss": {"stage1": (M, 64, NEAR), "in_batch": (S, 7),
                  "lu_warm": (S, 9), "lu_cold": (O, 12)},
    "far_max_iter": {"stage1": (M, 64, FAR)},
}
CASES = list(SCRIPT)
STAGE = ["stage1", "in_batch", "lu_warm", "lu_cold", "schur"]

# entry -> case -> (rungs run, status, iterations, rung whose state is
# returned): the reference's behaviour, pinned
EXPECTED = {
    "solve_batch": {
        "in_batch": (["stage1", "in_batch"], O, 25, "in_batch"),
        # the failed in-batch rung's 7 iterations are not counted
        "lu_warm": (["stage1", "in_batch", "lu_warm"], O, 26, "lu_warm"),
        "lu_cold": (["stage1", "in_batch", "lu_warm", "lu_cold"], O, 40,
                    "lu_cold"),
        "schur": (STAGE, O, 44, "schur"),
        "none": (STAGE, S, 20, "stage1"),
        "numerical_failure": (["stage1", "in_batch", "lu_warm"], O, 19,
                              "lu_warm"),
        "near_miss": (["stage1"], M, 64, "stage1"),
        "far_max_iter": (["stage1"], M, 64, "stage1"),
    },
    "solve": {
        "in_batch": (["stage1", "lu_warm"], O, 26, "lu_warm"),
        "lu_warm": (["stage1", "lu_warm"], O, 26, "lu_warm"),
        "lu_cold": (["stage1", "lu_warm", "lu_cold"], O, 40, "lu_cold"),
        "schur": (["stage1", "lu_warm", "lu_cold", "schur"], O, 44, "schur"),
        "none": (["stage1", "lu_warm", "lu_cold", "schur"], S, 20, "stage1"),
        "numerical_failure": (["stage1", "lu_warm"], O, 19, "lu_warm"),
        "near_miss": (["stage1", "lu_warm", "lu_cold"], O, 85, "lu_cold"),
        "far_max_iter": (["stage1"], M, 64, "stage1"),
    },
}
# (entry, case) -> the port's behaviour where its contract differs from
# ``ipx``'s: its ``solve_batch`` rescues a near-miss MAX_ITER, as both
# packages' ``solve`` do, through the in-batch rung first
PORT_EXPECTED = {
    ("solve_batch", "near_miss"): (["stage1", "in_batch", "lu_warm",
                                    "lu_cold"], O, 85, "lu_cold"),
}
M_SC, N_SC, MAX_IT = 4, 8, 64


def _marker(lane: int, rung: str) -> float:
    """The value a scripted run fills its best_x with: which lane, which
    rung."""
    return 100.0 * (lane + 1) + STAGE.index(rung) + 1


class Script:
    """Scripted stand-in for every run function of one package.  A lane is
    told by its ``obj_offset`` (its index in ``CASES``); each call records
    the rung per lane and returns the scripted status, iterations and gap,
    with best_x filled by :func:`_marker`."""

    def __init__(self, entry: str):
        self.entry = entry
        self.rungs = {i: [] for i in range(len(CASES))}

    def rung(self, lane, linsys, warm, single) -> str:
        if not self.rungs[lane]:
            return "stage1"
        if linsys == "augmented":
            return "lu_warm" if warm else "lu_cold"
        in_batch = (self.entry == "solve_batch" and not single
                    and "in_batch" not in self.rungs[lane])
        return "in_batch" if in_batch else "schur"

    def fields(self, lanes, linsys, x0, single=False) -> dict:
        """IPMState fields, numpy, one row per lane."""
        rows = []
        for k, lane in enumerate(lanes):
            rung = self.rung(lane, linsys, x0 is not None, single)
            if x0 is not None:
                # every warm rung starts from the stage-1 best iterate
                assert x0[k] == _marker(lane, "stage1"), (lane, rung, x0[k])
            self.rungs[lane].append(rung)
            status, it, *gap = SCRIPT[CASES[lane]][rung]
            val = _marker(lane, rung)
            rows.append(dict(
                x=np.full(N_SC, val), y=np.zeros(M_SC), s=np.ones(N_SC),
                it=np.int32(it), status=np.int32(status), mu=1.0, mu0=1.0,
                rp_rel=0.0, rd_rel=0.0, rel_gap=gap[0] if gap else 0.5,
                best_x=np.full(N_SC, val), best_y=np.zeros(M_SC),
                best_s=np.ones(N_SC), best_merit=1.0, reg_boost=1.0,
                reg_floor=1.0, trace=np.zeros((MAX_IT, 8)),
                rp=np.zeros(M_SC), rd=np.zeros(N_SC)))
        return {k: np.stack([np.asarray(r[k], np.float32)
                             if k not in ("it", "status") else r[k]
                             for r in rows]) for k in rows[0]}

    def install_ipx(self, mp):
        from ipx.ipm.state import IPMState

        def state(lp, opts, state0, single):
            lanes = np.atleast_1d(np.asarray(lp.obj_offset)).astype(int)
            x0 = (None if state0 is None
                  else np.atleast_2d(np.asarray(state0.x))[:, 0])
            f = self.fields(lanes.tolist(), opts.linsys, x0, single)
            if single:
                f = {k: v[0] for k, v in f.items()}
            return IPMState(**{k: jnp.asarray(v) for k, v in f.items()})

        mp.setattr(ipx.api, "_run_batch",
                   lambda lp, o: state(lp, o, None, False))
        mp.setattr(ipx.api, "_run_batch_resumed",
                   lambda lp, o, s0: state(lp, o, s0, False))
        mp.setattr(ipx.api, "_run_single",
                   lambda lp, o: state(lp, o, None, True))
        mp.setattr(ipx.api, "_run_single_resumed",
                   lambda lp, o, s0: state(lp, o, s0, True))

    def install_port(self, mp):
        def run(lp, opts, state0=None):
            lanes = lp.obj_offset.to(torch.int64).tolist()
            x0 = None if state0 is None else state0.x[:, 0].tolist()
            return convert.state_from_numpy(
                self.fields(lanes, opts.linsys, x0), device="cpu",
                dtype=torch.float32)

        mp.setattr(ipx_torch.api, "_run_batch", run)


def _scripted_problem(lane: int):
    rng = np.random.default_rng(lane)
    A = rng.standard_normal((M_SC, N_SC))
    return A.T @ np.ones(M_SC) + 1.0, A, A @ np.ones(N_SC)


def _run_scripted(entry, pkg, mp):
    script = Script(entry)
    probs = [_scripted_problem(i) for i in range(len(CASES))]
    opts = pkg.SolverOptions(max_iter=MAX_IT)
    if pkg is ipx:
        script.install_ipx(mp)
        lps = [jmake_lp(c, A, b, obj_offset=float(i))
               for i, (c, A, b) in enumerate(probs)]
    else:
        script.install_port(mp)
        lps = [tmake_lp(c, A, b, obj_offset=float(i), device="cpu")
               for i, (c, A, b) in enumerate(probs)]
    if entry == "solve_batch":
        kw = {} if pkg is ipx else dict(device="cpu")
        sols = pkg.solve_batch(lps, options=opts, **kw)
    else:
        kw = dict(presolve=False) if pkg is ipx else dict(presolve=False,
                                                           device="cpu")
        sols = [pkg.solve(lp, options=opts, **kw) for lp in lps]
    return script.rungs, sols


@pytest.mark.parametrize("entry", ["solve_batch", "solve"])
def test_ladder_control_flow_matches_ipx(entry, monkeypatch):
    """Rung sequence, state returned and cumulative iterations per lane,
    each package held to its own contract: as pinned in EXPECTED, the same
    in both packages but where PORT_EXPECTED gives the port's.  ``ipx``'s
    ``solve_batch`` rescues STALLED and NUMERICAL_FAILURE only, the port's
    a near-miss MAX_ITER too, as ``solve`` does in both; a far MAX_ITER
    stays unrescued in both; a lane that leaves the in-batch rung unfixed
    counts stage 1 and its ladder rungs but not that rung."""
    with monkeypatch.context() as mp:
        rj, sj = _run_scripted(entry, ipx, mp)
    with monkeypatch.context() as mp:
        rt, st = _run_scripted(entry, ipx_torch, mp)
    for lane, case in enumerate(CASES):
        want = EXPECTED[entry][case]
        port = PORT_EXPECTED.get((entry, case), want)
        for got, sol, (rungs, status, its, source) in (
                (rj[lane], sj[lane], want), (rt[lane], st[lane], port)):
            assert got == rungs, (case, got)
            assert (sol.status, sol.iterations) == (status, its), case
            assert (sol.x == _marker(lane, source)).all(), case
        if port == want:
            assert np.array_equal(sj[lane].x, st[lane].x)


def test_ladder_off_route_or_option_rescues_nothing(monkeypatch):
    """Only the dense route with augmented_fallback rescues."""
    for kw in (dict(augmented_fallback=False), dict(linsys="augmented")):
        with monkeypatch.context() as mp:
            script = Script("solve_batch")
            script.install_port(mp)
            lps = [tmake_lp(*_scripted_problem(i), obj_offset=float(i),
                            device="cpu") for i in range(len(CASES))]
            sols = ipx_torch.solve_batch(
                lps, options=ipx_torch.SolverOptions(max_iter=MAX_IT, **kw),
                device="cpu")
        assert all(len(r) == 1 for r in script.rungs.values()), kw
        assert [s.status for s in sols] == \
            [SCRIPT[c]["stage1"][0] for c in CASES]


# the script's rungs -> the port's rung spans
RUNG_SPANS = {"in_batch": "api.rung.schur_batch",
              "lu_warm": "api.rung.aug_warm",
              "lu_cold": "api.rung.aug_cold",
              "schur": "api.rung.schur_warm"}


@pytest.mark.parametrize("entry", ["solve_batch", "solve"])
def test_rescue_counters_match_ladder(entry, monkeypatch):
    """``api.rescue.lanes_in`` counts the lanes the ladder took,
    ``api.rescue.near_miss_in`` the near-miss MAX_ITER lanes among them,
    ``api.rescue.lanes_fixed`` those it ended OPTIMAL; a rung span for
    each batch a rung ran (one a lane under ``solve``), inside
    ``api.rescue``."""
    from ipx_torch import obs
    with monkeypatch.context() as mp, obs.tracing() as t:
        rungs, sols = _run_scripted(entry, ipx_torch, mp)
    took = [lane for lane, r in rungs.items() if len(r) > 1]
    fixed = [lane for lane in took if sols[lane].optimal]
    got = t.summary()
    assert got["calls"] == (1 if entry == "solve_batch" else len(CASES))
    near = [lane for lane in took if CASES[lane] == "near_miss"]
    assert got["counters"] == {"api.rescue.lanes_in": len(took),
                               "api.rescue.near_miss_in": len(near),
                               "api.rescue.lanes_fixed": len(fixed),
                               "api.recheck.lanes_checked": len(CASES)}
    assert (len(took), len(near), len(fixed)) == (7, 1, 6)
    for rung, name in RUNG_SPANS.items():
        lanes = sum(rung in r for r in rungs.values())
        want = min(lanes, 1) if entry == "solve_batch" else lanes
        assert got["spans"].get(name, {}).get("calls", 0) == want, name
    for r in t.spans:
        if r.name.startswith("api.rung."):
            assert t.spans[r.parent].name == "api.rescue"


# --------------------------------------------------------------------------
# The degenerate batches of tests/test_degenerate.py, f32, default options
# --------------------------------------------------------------------------

def _solve_both(gs, **kw):
    sj = ipx.solve_batch([jmake_lp(g.c, g.A, g.b) for g in gs],
                         options=ipx.SolverOptions(dtype="float32", **kw))
    st = ipx_torch.solve_batch(
        [tmake_lp(g.c, g.A, g.b, device="cpu") for g in gs],
        options=ipx_torch.SolverOptions(dtype="float32", **kw), device="cpu")
    return sj, st


def test_batch_with_degenerate_member_rescued():
    gs = [random_feasible_lp(40, 80, seed=1),
          random_feasible_lp(40, 80, seed=0, support=20)]
    sols = ipx_torch.solve_batch(
        [tmake_lp(g.c, g.A, g.b, device="cpu") for g in gs], device="cpu")
    for g, s in zip(gs, sols):
        assert s.optimal, s.status_name
        assert _obj_rel(s, g.obj_star) <= 5e-6


def test_batch_rescue_is_on_device():
    """A healthy lane and three degenerate ones: every lane OPTIMAL, and no
    fewer than ipx brings there."""
    gs = [random_feasible_lp(40, 80, seed=1),
          random_feasible_lp(40, 80, seed=0, support=20),
          random_feasible_lp(40, 80, seed=2, support=20),
          random_feasible_lp(40, 80, seed=3, support=20)]
    sj, st = _solve_both(gs)
    assert sum(s.optimal for s in st) >= sum(s.optimal for s in sj)
    for i, (g, s) in enumerate(zip(gs, st)):
        assert s.optimal, (i, s.status_name)
        assert _obj_rel(s, g.obj_star) <= 5e-6, i


def test_degenerate_f32_augmented_schur_batched():
    gs = [random_feasible_lp(40, 80, seed=s, support=20) for s in range(4)]
    sj, st = _solve_both(gs, linsys="augmented_schur",
                         augmented_fallback=False)
    assert sum(s.optimal for s in st) >= sum(s.optimal for s in sj)
    for seed, (g, s) in enumerate(zip(gs, st)):
        if s.optimal:
            assert s.rel_gap <= 1e-6, (seed, s.rel_gap)
            assert _obj_rel(s, g.obj_star) <= 5e-6, seed


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def _tiny_lp():
    return tmake_lp([1.0, 1.0, 1.0], [[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]],
                    [1.0, 1.0], device="cpu")


@pytest.mark.parametrize("kw", [dict(linsys="augmented"),
                                dict(linsys="augmented_schur"),
                                dict(refactor_period=2)],
                         ids=["augmented", "augmented_schur", "refactor2"])
def test_check_ported_accepts_the_ladder_options(kw):
    ipx_torch.options.check_ported(ipx_torch.SolverOptions(**kw))
    sol = ipx_torch.solve(_tiny_lp(), presolve=False, device="cpu",
                          options=ipx_torch.SolverOptions(**kw))
    assert sol.optimal and abs(sol.objective - 1.0) <= 1e-5


@pytest.mark.parametrize("linsys", ["sharded", "sharded_schur"])
def test_sharded_routes_still_refused(linsys):
    """The sharded routes were refused until module 5 carried them (the
    name is the earlier contract's, kept so that the test's history reads
    on under one name).  ``check_ported`` accepts them; without an active
    mesh a batched entry point raises ``ipx``'s RuntimeError, and
    ``solve_large``, which makes the mesh, solves the tiny LP."""
    opts = ipx_torch.SolverOptions(linsys=linsys, augmented_fallback=False)
    ipx_torch.options.check_ported(opts)
    with pytest.raises(RuntimeError, match="requires an active mesh"):
        ipx_torch.solve_batch([_tiny_lp()], options=opts, device="cpu")
    sol = ipx_torch.solve_large(_tiny_lp(), options=opts, device="cpu")
    assert sol.optimal and abs(sol.objective - 1.0) <= 1e-5


def test_presolve_refused_unless_warm_start():
    """The default presolve=True solves (it was refused before the problem
    layer was carried); a warm start skips presolve, as in ``ipx``.  The
    name is the earlier contract's, kept so that the test's history reads
    on under one name."""
    pre = ipx_torch.solve(_tiny_lp(), device="cpu")
    assert pre.optimal and abs(pre.objective - 1.0) <= 1e-5
    cold = ipx_torch.solve(_tiny_lp(), presolve=False, device="cpu")
    warm = ipx_torch.solve(_tiny_lp(), device="cpu",
                           warm_start=(cold.x, cold.y, cold.s))
    assert warm.optimal and abs(warm.objective - 1.0) <= 1e-5


def test_warm_start_reduces_iterations():
    g = random_feasible_lp(60, 120, seed=0)
    opts = ipx_torch.SolverOptions(dtype="float32")
    kw = dict(options=opts, device="cpu")
    cold = ipx_torch.solve(g.c, g.A, g.b, presolve=False, **kw)
    assert cold.optimal
    rng = np.random.default_rng(1)
    c2 = g.c * (1 + 0.01 * rng.standard_normal(g.c.shape))
    cold2 = ipx_torch.solve(c2, g.A, g.b, presolve=False, **kw)
    warm2 = ipx_torch.solve(c2, g.A, g.b, warm_start=(cold.x, cold.y, cold.s),
                            **kw)
    assert warm2.optimal
    assert _obj_rel(warm2, cold2.objective) <= 2e-6
    assert warm2.iterations <= cold2.iterations


def test_warm_start_exact_same_problem():
    g = random_feasible_lp(40, 80, seed=2)
    kw = dict(options=ipx_torch.SolverOptions(dtype="float32"), device="cpu")
    cold = ipx_torch.solve(g.c, g.A, g.b, presolve=False, **kw)
    warm = ipx_torch.solve(g.c, g.A, g.b, warm_start=(cold.x, cold.y, cold.s),
                           **kw)
    assert warm.optimal
    assert warm.iterations <= max(6, cold.iterations // 2)
