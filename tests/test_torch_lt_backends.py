"""chol_backend in {"pallas", "hybrid", "blocked", "blocked_left", "panels"}
and cg_operator="assembled" in ipx_torch against ipx on the same numpy
inputs: the blocked factors of the linear-system layer, factor + PCG solve on
each backend, and the slice as a whole.

The JAX side runs its Pallas kernels in interpret mode, the port its plain
versions (CPU tensors).  Tolerances.  LT (or the panels), W and j against
ipx: 1e-5 of the largest entry (two f32 blocked factors of one well
conditioned matrix, differing in summation order; measured at most 5.8e-7);
"hybrid" 1e-4, where the two libraries' own Cholesky routines meet (measured
5.5e-7).  Solutions of the linear system 1e-4 relative, as
tests/test_torch_normal_eq.py (measured at most 4.2e-7).  Mehrotra steps 1e-3
relative to the JAX step (a step amplifies those differences through
d2 = x/s; measured at most 2.7e-6 on x, y, s, mu over three steps).
Objectives
5e-6 of the constructed optimum, as tests/test_pallas_backend.py.  f32
iteration counts are never compared lane by lane.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ipx
import ipx_torch
from ipx.ipm import batched as jb, mehrotra as jm
from ipx.linsys import normal_eq as jne
from ipx.problem.generate import random_feasible_lp
from ipx.problem.lp import LP as JLP
from ipx_torch import convert
from ipx_torch.ipm import batched as tb, mehrotra as tm
from ipx_torch.kernels import cholesky as tpk
from ipx_torch.linsys import normal_eq as tne
from ipx_torch.problem.lp import make_lp as tmake_lp

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _numpy_blas_on_one_thread():
    """numpy's BLAS spins its eight threads against the other test workers'
    (a 384 x 384 QR takes 9 s instead of 0.03 s on a busy machine); one
    thread for this module's tests, where threadpoolctl is installed."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1):
        yield

NB = tpk.NB
LT_BACKENDS = ["pallas", "hybrid", "blocked", "blocked_left"]
BACKENDS = LT_BACKENDS + ["panels"]


def _rand_spd(m, seed, cond=1e3):
    """As tests/test_blocked_backend.py builds it."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    return (Q * np.logspace(0, -np.log10(cond), m)) @ Q.T


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _check_w(W, L):
    for k in range(L.shape[-1] // NB):
        blk = L[:, k * NB:(k + 1) * NB, k * NB:(k + 1) * NB]
        assert np.abs(W[:, k] @ blk - np.eye(NB)).max() <= 5e-4, k


# --------------------------------------------------------------------------
# the blocked factors of the linear-system layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fn,m", [("_blocked_potrf", 128),
                                  ("_blocked_potrf", 256),
                                  ("_blocked_potrf_left", 384),
                                  ("_blocked_potrf_left_panels", 256)])
def test_blocked_factors_match_ipx_and_numpy(fn, m):
    """Batch of 3 against ipx's function under vmap and numpy's f64 factor
    (rtol 2e-4, atol 2e-5 of the largest entry, the reference test's).  One
    to three panels over the three functions: the JAX side traces its
    unrolled diagonal-block factor once a panel, which is this test's time."""
    Ms = np.stack([_rand_spd(m, seed=7 + m + b) for b in range(3)]
                  ).astype(np.float32)
    got, W = getattr(tne, fn)(torch.from_numpy(Ms))
    ref_fn = getattr(jne, fn)
    refj, Wj = jax.vmap(lambda M: ref_fn(M, NB))(jnp.asarray(Ms))
    L64 = np.linalg.cholesky(Ms.astype(np.float64))
    if fn.endswith("panels"):
        assert len(got) == m // NB
        for k, (a, b) in enumerate(zip(got, refj)):
            assert tuple(a.shape) == (3, NB, m - k * NB)
            assert _rel(a.numpy(), b) <= 1e-5, k
        L = tpk.lt_of_panels(got).mT.double().numpy()
    else:
        assert _rel(got.numpy(), refj) <= 1e-5
        L = got.double().numpy()
        if fn.endswith("left"):
            assert np.all(np.tril(L, -1) == 0)
            L = L.swapaxes(1, 2)
        else:
            assert np.all(np.triu(L, 1) == 0)
    assert _rel(W.numpy(), Wj) <= 1e-5
    np.testing.assert_allclose(L, L64, rtol=2e-4,
                               atol=2e-5 * np.abs(L64).max())
    _check_w(W.double().numpy(), L)


@pytest.mark.parametrize("bad_panel", [0, 2], ids=["first", "last"])
@pytest.mark.parametrize("fn", ["_blocked_potrf", "_blocked_potrf_left"])
def test_blocked_potrf_lanes_are_independent(fn, bad_panel):
    """A lane that is not positive definite (in its first or its last panel)
    raises nothing and shows on its own diagonal; its neighbour's factor is
    bit for bit the factor it gets alone."""
    m = 384
    Ms = np.stack([_rand_spd(m, seed=31 + b) for b in range(2)]
                  ).astype(np.float32)
    i = bad_panel * NB + 5
    Ms[1, i, i] = -1.0
    f = getattr(tne, fn)
    F, W = f(torch.from_numpy(Ms))
    F0, W0 = f(torch.from_numpy(Ms[:1]))
    assert torch.equal(F[:1], F0) and torch.equal(W[:1], W0)
    assert tuple(W.shape) == (2, m // NB, NB, NB)
    d = torch.diagonal(F, dim1=1, dim2=2)
    assert bool(((d[0] > 0) & torch.isfinite(d[0])).all())
    assert not bool(((d[1] > 0) & torch.isfinite(d[1])).all())


def test_invert_lower_blocks_matches_ipx():
    rng = np.random.default_rng(3)
    blocks = np.tril(rng.standard_normal((4, NB, NB)) * 0.1) \
        + 2 * np.eye(NB)
    blocks = blocks.astype(np.float32)
    got = tne._invert_lower_blocks(torch.from_numpy(blocks)).numpy()
    ref = np.asarray(jne._invert_lower_blocks(jnp.asarray(blocks)))
    assert _rel(got, ref) <= 1e-5
    assert np.abs(got.astype(np.float64) @ blocks - np.eye(NB)).max() <= 1e-5
    assert np.all(np.triu(got, 1) == 0)


# --------------------------------------------------------------------------
# factor + solve on each backend
# --------------------------------------------------------------------------

def _inputs(B, m, n, seed):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, m, n)) / np.sqrt(n)).astype(np.float32)
    A = torch.from_numpy(A).to(torch.bfloat16).float().numpy()   # bf16 values
    d2 = (np.abs(rng.standard_normal((B, n))) + 0.1).astype(np.float32)
    rhs = rng.standard_normal((B, m)).astype(np.float32)
    return A, d2, rhs


def _oracle(A, d2, rhs):
    A, d2 = A.astype(np.float64), d2.astype(np.float64)
    return np.stack([np.linalg.solve((a * d) @ a.T, r)
                     for a, d, r in zip(A, d2, rhs)])


def _both(kw, A, d2, rhs, bf16):
    """factor and solve in ipx (under vmap) and in the port."""
    oj, ot = ipx.SolverOptions(**kw), ipx_torch.SolverOptions(**kw)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    if bf16:
        Aj, At = Aj.astype(jnp.bfloat16), At.to(torch.bfloat16)

    def one(a, d, r):
        fac = jne.factor(a, d, oj)
        return fac, jne.solve(fac, a, r, oj)

    facj, yj = jax.vmap(one)(Aj, jnp.asarray(d2), jnp.asarray(rhs))
    fact = tne.factor(At, torch.from_numpy(d2), ot)
    yt = tne.solve(fact, At, torch.from_numpy(rhs), ot).numpy()
    return facj, np.asarray(yj), fact, yt, (At, ot)


@pytest.mark.parametrize(
    "backend,bf16", [(b, False) for b in BACKENDS]
    + [("pallas", True), ("panels", True)],
    ids=[f"{b}-f32" for b in BACKENDS] + ["pallas-bf16", "panels-bf16"])
def test_factor_solve_matches_ipx(backend, bf16):
    """m = 200 pads to 256, as tests/test_blocked_backend.py.  A stored in
    bf16 on one full-LT backend and on the panel one: the assembly it changes
    is shared by all five."""
    B, m, n = 2, 200, 400
    A, d2, rhs = _inputs(B, m, n, 11)
    kw = dict(dtype="float32", chol_backend=backend, refine_steps=2,
              a_storage="bfloat16" if bf16 else "float32")
    facj, yj, fact, yt, _ = _both(kw, A, d2, rhs, bf16)
    tol = 1e-4 if backend == "hybrid" else 1e-5
    assert fact.L.numel() == 0 and fact.M is None
    assert fact.ok.tolist() == np.asarray(facj.ok).tolist() == [True] * B
    assert _rel(fact.j.numpy(), facj.j) <= 1e-5
    assert tuple(fact.W.shape) == (B, 2, NB, NB)
    assert _rel(fact.W.numpy(), facj.W) <= tol
    if backend == "panels":
        assert fact.LT is None and len(fact.LTp) == 2
        for a, b in zip(fact.LTp, facj.LTp):
            assert _rel(a.numpy(), b) <= tol
        LT = tpk.lt_of_panels(fact.LTp)
    else:
        assert fact.LTp == () and tuple(fact.LT.shape) == (B, 256, 256)
        assert _rel(fact.LT.numpy(), facj.LT) <= tol
        LT = fact.LT
    # the identity extension: rows 200.. of L^T are the identity's
    assert torch.equal(LT[:, m:, m:], torch.eye(56).expand(B, 56, 56))
    assert float(LT[:, :m, m:].abs().max()) == 0.0
    assert tuple(yt.shape) == (B, m)
    assert np.abs(yt - yj).max() <= 1e-4 * np.abs(yj).max()
    y64 = _oracle(A, d2, rhs)
    assert np.abs(yt - y64).max() <= 1e-4 * np.abs(y64).max()


@pytest.mark.parametrize("backend", ["pallas", "pallas_left", "xla"])
def test_assembled_cg_operator_matches_ipx(backend):
    """cg_operator="assembled": the factor keeps the unscaled M, CG streams
    it, and pallas_left leaves its fused branch for the assembled one."""
    B, m, n = 2, 128, 256
    A, d2, rhs = _inputs(B, m, n, 12)
    bf16 = backend == "pallas_left"     # fused-eligible, were it not for M
    kw = dict(dtype="float32", chol_backend=backend, refine_steps=3,
              cg_operator="assembled",
              a_storage="bfloat16" if bf16 else "float32")
    facj, yj, fact, yt, (At, ot) = _both(kw, A, d2, rhs, bf16)
    assert tuple(fact.M.shape) == (B, m, m)
    assert _rel(fact.M.numpy(), facj.M) <= 1e-5
    M64 = np.einsum("bij,bj,bkj->bik", A.astype(np.float64),
                    d2.astype(np.float64), A.astype(np.float64))
    assert _rel(fact.M.numpy(), M64) <= 1e-5        # unscaled, unregularized
    assert np.abs(yt - yj).max() <= 1e-4 * np.abs(yj).max()
    y64 = _oracle(A, d2, rhs)
    assert np.abs(yt - y64).max() <= 1e-4 * np.abs(y64).max()
    # the CG operator is M: with M = 0 every p^T M p is 0, the iteration
    # freezes, and what is left is the one preconditioner apply
    off = dataclasses.replace(fact, M=torch.zeros_like(fact.M))
    y_off = tne.solve(off, At, torch.from_numpy(rhs), ot)
    y_direct = tne.solve(fact, At, torch.from_numpy(rhs),
                         ot.replace(refine_steps=0))
    assert torch.equal(y_off, y_direct)
    assert not np.array_equal(y_off.numpy(), yt)
    # matrix-free options carry no M
    free = tne.factor(At, torch.from_numpy(d2),
                      ot.replace(cg_operator="matrix_free"))
    assert free.M is None


@pytest.mark.parametrize("backend", ["pallas", "blocked_left"])
def test_ipx_factor_solves_in_the_port(backend):
    """Factor in ipx, carry the full-LT NormalEqFactor across, run the port's
    PCG solve on it: same solution as ipx's own solve."""
    A, d2, rhs = _inputs(2, 200, 400, 15)
    kw = dict(dtype="float32", chol_backend=backend, refine_steps=2,
              cg_operator="assembled")
    oj, ot = ipx.SolverOptions(**kw), ipx_torch.SolverOptions(**kw)
    Aj = jnp.asarray(A)
    fj = jax.vmap(lambda a, d: jne.factor(a, d, oj))(Aj, jnp.asarray(d2))
    yj = np.asarray(jax.vmap(lambda f, a, r: jne.solve(f, a, r, oj))(
        fj, Aj, jnp.asarray(rhs)))
    fac = convert.factor_from_ipx(
        (), np.asarray(fj.W), np.asarray(fj.j), np.asarray(fj.d2),
        np.asarray(fj.ok), device="cpu", LT=np.asarray(fj.LT),
        M=np.asarray(fj.M))
    assert fac.LTp == () and tuple(fac.LT.shape) == (2, 256, 256)
    assert tuple(fac.M.shape) == (2, 200, 200)
    yt = tne.solve(fac, torch.from_numpy(A), torch.from_numpy(rhs), ot).numpy()
    assert np.abs(yt - yj).max() <= 1e-4 * np.abs(yj).max()


def test_factor_from_ipx_full_lt_layouts():
    W = np.zeros((2, NB, NB), np.float32)
    one = convert.factor_from_ipx((), W, np.ones(200), np.ones(300), True,
                                  device="cpu", LT=np.eye(256))
    assert tuple(one.LT.shape) == (1, 256, 256) and one.M is None
    assert tuple(one.W.shape) == (1, 2, NB, NB)
    with pytest.raises(ValueError, match="one of the two"):
        convert.factor_from_ipx([np.zeros((NB, NB))], W[:1], np.ones(100),
                                np.ones(300), True, device="cpu",
                                LT=np.eye(128))
    with pytest.raises(ValueError, match="multiple"):
        convert.factor_from_ipx((), W, np.ones(200), np.ones(300), True,
                                device="cpu", LT=np.eye(200))
    with pytest.raises(ValueError, match="order 256"):
        convert.factor_from_ipx((), W[:1], np.ones(200), np.ones(300), True,
                                device="cpu", LT=np.eye(256))


@pytest.mark.parametrize("backend", BACKENDS)
def test_bad_lane_reports_not_ok(backend):
    """A lane whose matrix is not positive definite (negative d2) comes back
    ok=False without raising and the other lane stays ok."""
    A, d2, rhs = _inputs(2, 100, 256, 13)
    d2[1] = -np.abs(d2[1])
    d2[1, :4] = 1e-3
    ot = ipx_torch.SolverOptions(dtype="float32", chol_backend=backend)
    fac = tne.factor(torch.from_numpy(A), torch.from_numpy(d2), ot)
    assert fac.ok.tolist() == [True, False]
    y = tne.solve(fac, torch.from_numpy(A), torch.from_numpy(rhs), ot)
    assert bool(torch.isfinite(y[0]).all())


@pytest.mark.parametrize("backend", BACKENDS)
def test_factor_refuses_m_over_the_solve_limit_before_any_work(backend,
                                                               monkeypatch):
    def no_work(*a, **kw):
        raise AssertionError("factor work started")
    monkeypatch.setattr(tne, "assemble", no_work)
    A = torch.zeros(1, tpk.MAX_M + 1, 128)
    opts = ipx_torch.SolverOptions(dtype="float32", chol_backend=backend)
    with pytest.raises(ValueError, match=backend):
        tne.factor(A, torch.ones(1, 128), opts)


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

def _instances(B, m, n, seed0):
    return [random_feasible_lp(m, n, seed=seed0 + i) for i in range(B)]


@pytest.mark.parametrize("backend", ["pallas", "blocked_left"])
def test_first_three_steps_follow_the_jax_step(backend):
    gs = _instances(3, 96, 192, 20)
    c, A, b = (np.stack([getattr(g, f) for g in gs]) for f in "cAb")
    kw = dict(dtype="float32", chol_backend=backend,
              augmented_fallback=False, max_iter=16)
    oj, ot = ipx.SolverOptions(**kw), ipx_torch.SolverOptions(**kw)
    f32 = jnp.float32
    lpj = JLP(c=jnp.asarray(c, f32), A=jnp.asarray(A, f32),
              b=jnp.asarray(b, f32), obj_offset=jnp.zeros((3,), f32))
    s0, facj = jax.jit(lambda l: jb.batch_starting_state(l, oj))(lpj)
    step = jax.jit(jax.vmap(
        lambda lp_i, st_i, f: jm.mehrotra_step(lp_i, st_i, oj, f)))
    js = [s0]
    for _ in range(3):
        js.append(step(lpj, js[-1], facj))
    js = [{f.name: np.asarray(getattr(s_, f.name))
           for f in dataclasses.fields(s_)} for s_ in js]

    lpt = convert.lp_from_numpy(c, A, b, device="cpu", dtype=torch.float32)
    st_own, fact = tb.batch_starting_state(lpt, ot)
    assert tuple(fact.LT.shape) == (3, 128, 128) and fact.ok.all()
    for f in ("x", "y", "s"):
        assert _rel(getattr(st_own, f).numpy(), js[0][f]) <= 1e-3, f
    st = convert.state_from_numpy(js[0], device="cpu", dtype=torch.float32)
    for k in (1, 2, 3):
        st = tm.mehrotra_step(lpt, st, ot, fact)
        got = convert.state_to_numpy(st)
        for f in ("x", "y", "s", "mu"):
            assert _rel(got[f], js[k][f]) <= 1e-3, (k, f)
        assert (got["it"] == k).all()
        assert (got["status"] == js[k]["status"]).all()


@pytest.mark.parametrize("kw", [dict(chol_backend=b) for b in BACKENDS]
                         + [dict(chol_backend="pallas",
                                 cg_operator="assembled"),
                            dict(chol_backend="blocked",
                                 matvec_backend="fused")],
                         ids=BACKENDS + ["pallas-assembled", "blocked-fused"])
def test_solve_batch_reaches_the_constructed_optimum(kw):
    """Three (96, 192) instances, as tests/test_blocked_backend.py and
    tests/test_pallas_backend.py: every lane OPTIMAL, objective within 5e-6."""
    gs = _instances(3, 96, 192, 20)
    opts = ipx_torch.SolverOptions(dtype="float32", augmented_fallback=False,
                                   **kw)
    sols = ipx_torch.solve_batch(
        [tmake_lp(g.c, g.A, g.b, device="cpu") for g in gs], options=opts,
        device="cpu")
    for g, s in zip(gs, sols):
        assert s.optimal, s.iteration_table()
        assert abs(s.objective - g.obj_star) / (1 + abs(g.obj_star)) <= 5e-6
        assert s.rel_gap <= 1e-6 and s.x.shape == (192,)


@pytest.mark.parametrize("m,n", [(50, 100), (128, 256)])
def test_single_solve_pallas_backend_agrees_with_ipx(m, n):
    """As tests/test_pallas_backend.py: one LP alone, m off and on the 128
    grid; both packages OPTIMAL with objectives within 5e-6 of the optimum."""
    g = random_feasible_lp(m, n, seed=0)
    kw = dict(dtype="float32", chol_backend="pallas")
    st = ipx_torch.solve(g.c, g.A, g.b, presolve=False, device="cpu",
                         options=ipx_torch.SolverOptions(
                             augmented_fallback=False, **kw))
    sj = ipx.solve(g.c, g.A, g.b, options=ipx.SolverOptions(**kw))
    for s in (st, sj):
        assert s.optimal, s.status_name
        assert abs(s.objective - g.obj_star) / (1 + abs(g.obj_star)) <= 5e-6


def test_f64_is_refused_on_the_family_in_both_packages():
    for backend in BACKENDS:
        for pkg in (ipx, ipx_torch):
            with pytest.raises(ValueError):
                pkg.SolverOptions(dtype="float64", chol_backend=backend)
