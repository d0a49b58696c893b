"""chol_backend="pallas_left" in ipx_torch against ipx on the same numpy
inputs: the linear-system layer (factor + PCG solve) on each of its branches,
and the slice as a whole under SolverOptions.throughput() as it stands.

The JAX side runs its Pallas kernels in interpret mode, the port its plain
versions (CPU tensors).  Tolerances: solutions of the linear system 1e-4
relative (the f32 cases of tests/test_torch_normal_eq.py: two CG recurrences
rounding in different orders); Mehrotra steps 1e-3 relative to the JAX step
(a step amplifies those differences through d2 = x/s); objectives 1e-5 of
the constructed optimum.  f32 iteration counts are never compared lane by
lane.
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
from ipx.problem.lp import LP as JLP, make_lp as jmake_lp
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

PL = dict(chol_backend="pallas_left", matvec_backend="fused", refine_steps=1)


def _inputs(B, m, n, seed):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, m, n)) / np.sqrt(n)).astype(np.float32)
    A = torch.from_numpy(A).to(torch.bfloat16).float().numpy()   # bf16 values
    d2 = np.exp(rng.standard_normal((B, n))).astype(np.float32)
    rhs = rng.standard_normal((B, m)).astype(np.float32)
    return A, d2, rhs


def _oracle(A, d2, rhs):
    A, d2 = A.astype(np.float64), d2.astype(np.float64)
    return np.stack([np.linalg.solve((a * d) @ a.T, r)
                     for a, d, r in zip(A, d2, rhs)])


@pytest.mark.parametrize("m,bf16,branch", [
    (128, True, "fused"), (256, False, "assembled"), (200, True, "padded"),
], ids=["bf16-aligned", "f32-aligned", "bf16-m200"])
def test_factor_solve_matches_ipx(m, bf16, branch):
    n = 2 * m if m > 128 else 256       # keep A D^2 A^T well conditioned
    A, d2, rhs = _inputs(2, m, n, 11)
    kw = dict(PL, a_storage="bfloat16" if bf16 else "float32")
    oj, ot = ipx.SolverOptions(**kw), ipx_torch.SolverOptions(**kw)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    if bf16:
        Aj, At = Aj.astype(jnp.bfloat16), At.to(torch.bfloat16)

    def one(a, d, r):
        fac = jne.factor(a, d, oj)
        return jne.solve(fac, a, r, oj), fac.ok

    yj, okj = jax.vmap(one)(Aj, jnp.asarray(d2), jnp.asarray(rhs))
    fac = tne.factor(At, torch.from_numpy(d2), ot)
    yt = tne.solve(fac, At, torch.from_numpy(rhs), ot).numpy()

    m_pad = -(-m // 128) * 128
    assert fac.L.numel() == 0 and len(fac.LTp) == m_pad // 128
    assert tuple(fac.W.shape) == (2, m_pad // 128, 128, 128)
    assert tuple(fac.LTp[0].shape) == (2, 128, m_pad)
    assert tuple(fac.j.shape) == (2, m) and tuple(yt.shape) == (2, m)
    assert tpk.fused_factor_fits(m, n, At.dtype) == (branch == "fused")
    assert fac.ok.all() and np.asarray(okj).all()
    scale = np.abs(np.asarray(yj)).max()
    assert np.abs(yt - np.asarray(yj)).max() <= 1e-4 * scale
    y64 = _oracle(A, d2, rhs)
    assert np.abs(yt - y64).max() <= 1e-4 * np.abs(y64).max()


def test_padded_factor_is_the_identity_extension():
    """m = 200 pads to 256: the padding rows of L^T are the identity's, the
    padded part of W's last block too, and a solve ignores them."""
    A, d2, rhs = _inputs(1, 200, 256, 12)
    ot = ipx_torch.SolverOptions(**PL)
    fac = tne.factor(torch.from_numpy(A), torch.from_numpy(d2), ot)
    last = fac.LTp[1][0]                       # rows 128..255 of L^T
    assert torch.equal(last[72:, 72:], torch.eye(56))
    assert float(last[:72, 72:].abs().max()) == 0.0
    y = tne._chol_solve(fac, torch.from_numpy(rhs))
    assert tuple(y.shape) == (1, 200)
    M = tne.assemble(torch.from_numpy(A), torch.from_numpy(d2)).double()
    j = fac.j.double()
    Ms = M * j[:, :, None] * j[:, None, :] + ot.reg * torch.eye(200)
    ref = torch.linalg.solve(Ms, torch.from_numpy(rhs).double().unsqueeze(-1))
    assert float((y.double() - ref.squeeze(-1)).abs().max()) \
        <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("m,bf16", [(128, True), (128, False), (100, True)],
                         ids=["fused", "assembled", "padded"])
def test_bad_lane_reports_not_ok_and_leaves_the_other_alone(m, bf16):
    """A lane whose matrix is not positive definite (negative d2), or whose
    d2 holds a NaN, comes back ok=False without raising; the healthy lane's
    factor is the one it gets alone (to rounding: the CPU's batched matmul
    sums in another order at another batch size)."""
    A, d2, rhs = _inputs(2, m, 256, 13)
    At = torch.from_numpy(A).to(torch.bfloat16 if bf16 else torch.float32)
    ot = ipx_torch.SolverOptions(**PL)
    good = tne.factor(At[:1], torch.from_numpy(d2[:1]), ot)
    for poison in ("negative", "nan"):
        bad = d2.copy()
        if poison == "negative":
            bad[1] = -np.abs(bad[1])
            bad[1, :4] = 1e-3
        else:
            bad[1, 0] = np.nan
        fac = tne.factor(At, torch.from_numpy(bad), ot)
        assert fac.ok.tolist() == [True, False], poison
        for p, q in zip(fac.LTp, good.LTp):
            assert torch.allclose(p[:1], q, rtol=1e-4, atol=1e-6), poison
        y = tne.solve(fac, At, torch.from_numpy(rhs), ot)     # must not raise
        assert bool(torch.isfinite(y[0]).all())


@pytest.mark.parametrize("bf16", [True, False], ids=["fused", "assembled"])
def test_reg_scale_is_per_lane(bf16):
    A, d2, _ = _inputs(2, 128, 256, 14)
    At = torch.from_numpy(A).to(torch.bfloat16 if bf16 else torch.float32)
    ot = ipx_torch.SolverOptions(**PL).replace(reg=1e-3)
    fac = tne.factor(At, torch.from_numpy(d2), ot,
                     reg_scale=torch.tensor([1.0, 100.0]))
    LT = fac.LTp[0].double()                   # m = 128: one panel, all of L^T
    diag = torch.diagonal(LT.mT @ LT, dim1=-2, dim2=-1)
    assert torch.allclose(diag[0], torch.full((128,), 1 + 1e-3,
                                              dtype=torch.float64), atol=1e-5)
    assert torch.allclose(diag[1], torch.full((128,), 1 + 1e-1,
                                              dtype=torch.float64), atol=1e-5)


def test_ipx_factor_solves_in_the_port():
    """Factor in ipx, carry the NormalEqFactor across, run the port's PCG
    solve on it: same solution as ipx's own solve."""
    A, d2, rhs = _inputs(2, 128, 256, 15)
    kw = dict(PL, a_storage="bfloat16")
    oj, ot = ipx.SolverOptions(**kw), ipx_torch.SolverOptions(**kw)
    Aj = jnp.asarray(A).astype(jnp.bfloat16)
    fj = jax.vmap(lambda a, d: jne.factor(a, d, oj))(Aj, jnp.asarray(d2))
    yj = jax.vmap(lambda f, a, r: jne.solve(f, a, r, oj))(
        fj, Aj, jnp.asarray(rhs))
    fac = convert.factor_from_ipx([np.asarray(p) for p in fj.LTp],
                                  np.asarray(fj.W), np.asarray(fj.j),
                                  np.asarray(fj.d2), np.asarray(fj.ok),
                                  device="cpu")
    At = torch.from_numpy(A).to(torch.bfloat16)
    yt = tne.solve(fac, At, torch.from_numpy(rhs), ot).numpy()
    assert np.abs(yt - np.asarray(yj)).max() <= 1e-4 * np.abs(np.asarray(yj)).max()


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

SLICE = dict(a_storage="bfloat16", augmented_fallback=False)


def _bf16_instances(B, m, n, seed0):
    """Instances whose A is bf16-representable, b and c rebuilt from the
    rounded A so the constructed optimum is exact."""
    out = []
    for i in range(B):
        g = random_feasible_lp(m, n, seed=seed0 + i)
        A = torch.from_numpy(g.A).to(torch.bfloat16).double().numpy()
        out.append((A.T @ g.y_star + g.s_star, A, A @ g.x_star,
                    float((A.T @ g.y_star + g.s_star) @ g.x_star)))
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_throughput_options_unchanged_solve_batch():
    insts = _bf16_instances(3, 128, 256, 70)
    oj = ipx.SolverOptions.throughput(**SLICE)
    ot = ipx_torch.SolverOptions.throughput(**SLICE)
    assert ot.chol_backend == oj.chol_backend == "pallas_left"
    sj = ipx.solve_batch([jmake_lp(c, A, b) for c, A, b, _ in insts],
                         options=oj)
    st = ipx_torch.solve_batch(
        [tmake_lp(c, A, b, device="cpu") for c, A, b, _ in insts],
        options=ot, device="cpu")
    assert len(st) == len(sj) == 3
    # lane 0 is a hard instance at these options (it stalls in ipx too);
    # lanes are only compared where both packages finish
    assert sum(a.optimal and b_.optimal for a, b_ in zip(st, sj)) >= 2
    for a, b_, (_, _, _, obj) in zip(st, sj, insts):
        if a.optimal and b_.optimal:
            assert a.status == b_.status
            assert abs(a.objective - obj) <= 1e-5 * (1 + abs(obj))
            assert abs(b_.objective - obj) <= 1e-5 * (1 + abs(obj))
            assert a.rel_gap <= 1e-6
        assert a.x.shape == (256,) and a.y.shape == (128,)


def test_first_two_steps_follow_the_jax_step():
    insts = _bf16_instances(3, 128, 256, 70)
    c = np.stack([i[0] for i in insts])
    A = np.stack([i[1] for i in insts])
    b = np.stack([i[2] for i in insts])
    kw = dict(SLICE, max_iter=16)
    oj = ipx.SolverOptions.throughput(**kw)
    ot = ipx_torch.SolverOptions.throughput(**kw)
    f32 = jnp.float32
    lpj = JLP(c=jnp.asarray(c, f32), A=jnp.asarray(A, f32),
              b=jnp.asarray(b, f32),
              obj_offset=jnp.zeros((3,), f32)).with_a_storage(oj)
    s0, facj = jax.jit(lambda l: jb.batch_starting_state(l, oj))(lpj)
    step = jax.jit(jax.vmap(
        lambda lp_i, st_i, f: jm.mehrotra_step(lp_i, st_i, oj, f)))
    js = [s0]
    for _ in range(2):
        js.append(step(lpj, js[-1], facj))
    js = [{f.name: np.asarray(getattr(s_, f.name))
           for f in dataclasses.fields(s_)} for s_ in js]

    lpt = convert.lp_from_numpy(c, A, b, device="cpu",
                                dtype=torch.float32).with_a_storage(ot)
    assert lpt.A.dtype == torch.bfloat16
    st_own, fact = tb.batch_starting_state(lpt, ot)
    assert len(fact.LTp) == 1 and fact.ok.all()
    for f in ("x", "y", "s"):
        assert _rel(getattr(st_own, f).numpy(), js[0][f]) <= 1e-3, f
    st = convert.state_from_numpy(js[0], device="cpu", dtype=torch.float32)
    for k in (1, 2):
        st = tm.mehrotra_step(lpt, st, ot, fact)
        got = convert.state_to_numpy(st)
        for f in ("x", "y", "s", "mu"):
            assert _rel(got[f], js[k][f]) <= 1e-3, (k, f)
        assert (got["it"] == k).all()
        assert (got["status"] == js[k]["status"]).all()


def test_f32_stored_A_and_ragged_m_solve_end_to_end():
    """pallas_left on its assembled branches: f32-stored A, and an m off
    the 128 grid (padded)."""
    insts = _bf16_instances(2, 100, 200, 80)
    for extra in (dict(), dict(a_storage="bfloat16")):
        opts = ipx_torch.SolverOptions.throughput(augmented_fallback=False,
                                                  **extra)
        sols = ipx_torch.solve_batch(
            [tmake_lp(c, A, b, device="cpu") for c, A, b, _ in insts],
            options=opts, device="cpu")
        for s, (_, _, _, obj) in zip(sols, insts):
            assert s.optimal, s.iteration_table()
            assert abs(s.objective - obj) <= 1e-5 * (1 + abs(obj))


def test_single_solve_on_pallas_left():
    (c, A, b, obj), = _bf16_instances(1, 128, 256, 90)
    sol = ipx_torch.solve(c, A, b, presolve=False, device="cpu",
                          options=ipx_torch.SolverOptions.throughput(**SLICE))
    assert sol.optimal and abs(sol.objective - obj) <= 1e-5 * (1 + abs(obj))


@pytest.mark.parametrize("m", [tpk.MAX_M + 1, tpk.MAX_M + tpk.NB])
def test_factor_refuses_m_over_the_solve_limit_before_any_work(m, monkeypatch):
    """An m whose padded size the pair-solve cannot take is refused by
    ``factor`` itself, not by the first preconditioner apply."""
    def no_work(*a, **kw):
        raise AssertionError("factor work started")
    for mod, name in ((tne, "assemble"), (tpk, "factor_fused_panels"),
                      (tpk, "factor_lt_panels")):
        monkeypatch.setattr(mod, name, no_work)
    A = torch.zeros(1, m, 128, dtype=torch.bfloat16)
    opts = ipx_torch.SolverOptions(**PL, augmented_fallback=False)
    with pytest.raises(ValueError, match="pallas_left"):
        tne.factor(A, torch.ones(1, 128), opts)
