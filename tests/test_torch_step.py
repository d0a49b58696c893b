"""Mehrotra steps of ipx_torch step-locked against ipx from ONE shared state.

The JAX package computes the starting state; its leaves cross to the port as
numpy arrays through ipx_torch.convert, and both packages then step on their
own.  f64: five steps, x / y / s / mu equal to 1e-9 relative (inf-norm per
field).  f32 on the fused route with bf16-stored A: one step to 1e-4
relative; the two differ in rounding order only (Pallas interpret-mode
kernels on one side, plain torch matmuls on the other).
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
from ipx_torch.linsys import normal_eq as tne

torch.set_num_threads(1)


def _instances(B, m, n, bf16=False):
    gs = [random_feasible_lp(m, n, seed=20 + i) for i in range(B)]
    A = np.stack([g.A for g in gs])
    if bf16:    # bf16-representable data, so storage is lossless on both sides
        A = torch.from_numpy(A).to(torch.bfloat16).double().numpy()
    x = np.stack([g.x_star for g in gs])
    y = np.stack([g.y_star for g in gs])
    s = np.stack([g.s_star for g in gs])
    b = np.einsum("bmn,bn->bm", A, x)
    c = np.einsum("bmn,bm->bn", A, y) + s
    return c, A, b


def _jax_side(c, A, b, opts, dtype, steps, factors=None):
    """``steps`` steps from the starting state; with refactor_period > 1
    the steps of ipx's batched loop body: a fresh factor and step, then
    stale steps, each block's factor appended to ``factors``."""
    lp = JLP(c=jnp.asarray(c, dtype), A=jnp.asarray(A, dtype),
             b=jnp.asarray(b, dtype),
             obj_offset=jnp.zeros((A.shape[0],), dtype)).with_a_storage(opts)
    st, fac_aat = jax.jit(lambda l: jb.batch_starting_state(l, opts))(lp)
    out = [st]
    if opts.refactor_period == 1:
        step = jax.jit(jax.vmap(
            lambda lp_i, st_i, f: jm.mehrotra_step(lp_i, st_i, opts, f)))
        for _ in range(steps):
            out.append(step(lp, out[-1], fac_aat))
    else:
        stale = opts.replace(refine_steps=opts.stale_solve_cg)
        factor = jax.jit(jax.vmap(
            lambda a, d, rb: jne.factor(a, d, opts, reg_scale=rb)))
        fresh = jax.jit(jax.vmap(lambda lp_i, st_i, f, fc: jm.step_masked(
            lp_i, st_i, opts, f, fc)))
        stale_step = jax.jit(jax.vmap(
            lambda lp_i, st_i, f, fc, b0: jm.step_masked_stale(
                lp_i, st_i, stale, f, fc, b0)))
        for k in range(steps):
            st = out[-1]
            if k % opts.refactor_period == 0:
                boost0 = st.reg_boost
                fac = factor(lp.A, st.x / st.s, st.reg_boost)
                factors.append(fac)
                out.append(fresh(lp, st, fac_aat, fac))
            else:
                out.append(stale_step(lp, st, fac_aat, fac, boost0))
    return [{f.name: np.asarray(getattr(s_, f.name))
             for f in dataclasses.fields(s_)} for s_ in out]


def _factor_of_ipx(fac) -> tne.NormalEqFactor:
    """ipx's library-route factor as the port's, values unchanged (ipx
    assembles and factors an f64 run's preconditioner in float32: a
    deliberate difference, ROADMAP.md section 3)."""
    f64 = lambda a: torch.tensor(np.asarray(a, np.float64))
    return tne.NormalEqFactor(L=f64(fac.L), j=f64(fac.j), d2=f64(fac.d2),
                              ok=torch.tensor(np.asarray(fac.ok)))


def _torch_side(c, A, b, opts, dtype, state0, steps, factors=()):
    """The port's steps from ``state0``.  With refactor_period > 1 each
    block takes ipx's factor from ``factors``: two stale CG iterations
    leave the preconditioner's float32 roundings in the step, where a fresh
    step's converged CG removes them."""
    factors = list(factors)
    lp = convert.lp_from_numpy(c, A, b, device="cpu", dtype=dtype)
    lp = lp.with_a_storage(opts)
    _, fac_aat = tb.batch_starting_state(lp, opts)
    st = convert.state_from_numpy(state0, device="cpu", dtype=dtype)
    out = [st]
    stale = opts.replace(refine_steps=opts.stale_solve_cg)
    for k in range(steps):
        st = out[-1]
        if opts.refactor_period == 1:
            out.append(tm.mehrotra_step(lp, st, opts, fac_aat))
        elif k % opts.refactor_period == 0:
            boost0 = st.reg_boost
            fac = _factor_of_ipx(factors.pop(0))
            out.append(tm.step_masked(lp, st, opts, fac_aat, fac))
        else:
            out.append(tm.step_masked_stale(lp, st, stale, fac_aat, fac,
                                            boost0))
    return [convert.state_to_numpy(s_) for s_ in out]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


KW = dict(augmented_fallback=False, max_iter=16)


@pytest.mark.parametrize("extra", [
    dict(), dict(gondzio_correctors=1), dict(linsys="augmented"),
    dict(linsys="augmented_schur"),
    # a stale step's refinement sweeps solve through a factor one iterate
    # old with two CG iterations, and amplify roundings: in ipx itself a
    # 1e-15 relative change of x moves the next x by 8.0e-9 with the
    # default sweeps and by 2.2e-12 without them
    # (probes/stale_step_sensitivity.py).  So the case steps without
    # sweeps, where a step is a function of its inputs to 1e-9
    dict(refactor_period=2, kkt_refine_steps=0, predictor_refine_steps=0)],
    ids=["default", "gondzio", "augmented", "augmented_schur", "refactor2"])
def test_five_f64_steps_step_locked(extra):
    c, A, b = _instances(2, 64, 128)
    kw = dict(dtype="float64", **KW, **extra)
    factors = []
    js = _jax_side(c, A, b, ipx.SolverOptions(**kw), jnp.float64, 5,
                   factors)
    ts = _torch_side(c, A, b, ipx_torch.SolverOptions(**kw), torch.float64,
                     js[0], 5, factors)
    for k in range(1, 6):
        for f in ("x", "y", "s", "mu", "rp", "rd", "best_x"):
            assert _rel(ts[k][f], js[k][f]) <= 1e-9, (k, f)
        for f in ("it", "status"):
            assert (ts[k][f] == js[k][f]).all(), (k, f)
        # the trace rows written so far: mu, residuals, gap, steps, sigma
        assert _rel(ts[k]["trace"][:, :k], js[k]["trace"][:, :k]) <= 1e-8


def test_starting_point_matches_f64():
    c, A, b = _instances(2, 64, 128)
    kw = dict(dtype="float64", **KW)
    js = _jax_side(c, A, b, ipx.SolverOptions(**kw), jnp.float64, 0)[0]
    lp = convert.lp_from_numpy(c, A, b, device="cpu", dtype=torch.float64)
    st, _ = tb.batch_starting_state(lp, ipx_torch.SolverOptions(**kw))
    tsn = convert.state_to_numpy(st)
    for f in ("x", "y", "s", "mu", "mu0", "rp", "rd"):
        assert _rel(tsn[f], js[f]) <= 1e-9, f
    assert (tsn["x"] > 0).all() and (tsn["s"] > 0).all()


def test_one_f32_fused_step_bf16_storage():
    c, A, b = _instances(2, 64, 128, bf16=True)
    kw = dict(chol_backend="xla", a_storage="bfloat16", **KW)
    oj = ipx.SolverOptions.throughput(**kw)
    ot = ipx_torch.SolverOptions.throughput(**kw)
    js = _jax_side(c, A, b, oj, jnp.float32, 1)
    ts = _torch_side(c, A, b, ot, torch.float32, js[0], 1)
    for f in ("x", "y", "s", "mu"):
        assert _rel(ts[1][f], js[1][f]) <= 1e-4, f
    assert (ts[1]["it"] == 1).all() and (ts[1]["status"] == js[1]["status"]).all()


def test_step_masked_freezes_finished_lanes():
    c, A, b = _instances(2, 64, 128)
    opts = ipx_torch.SolverOptions(dtype="float64", **KW)
    lp = convert.lp_from_numpy(c, A, b, device="cpu", dtype=torch.float64)
    st, fac = tb.batch_starting_state(lp, opts)
    frozen = dataclasses.replace(
        st, status=torch.tensor([0, int(ipx_torch.Status.OPTIMAL)],
                                dtype=torch.int32))
    new = tm.step_masked(lp, frozen, opts, fac)
    assert new.it.tolist() == [1, 0]
    assert torch.equal(new.x[1], st.x[1]) and not torch.equal(new.x[0], st.x[0])
    assert torch.equal(new.trace[1], st.trace[1])
    capped = dataclasses.replace(
        st, it=torch.tensor([0, opts.max_iter], dtype=torch.int32))
    new = tm.step_masked(lp, capped, opts, fac)
    assert new.it.tolist() == [1, opts.max_iter]
    assert tm.finalize_status(new, opts).status.tolist() == \
        [0, int(ipx_torch.Status.MAX_ITER)]


def test_convert_round_trip_and_shapes():
    c, A, b = _instances(1, 64, 128)
    lp = convert.lp_from_numpy(c[0], A[0], b[0], device="cpu",
                               dtype=torch.float64)
    assert tuple(lp.A.shape) == (1, 64, 128) and tuple(lp.obj_offset.shape) == (1,)
    st, _ = tb.batch_starting_state(lp, ipx_torch.SolverOptions(dtype="float64", **KW))
    d = convert.state_to_numpy(st)
    back = convert.state_from_numpy({k: v[0] for k, v in d.items()}, device="cpu")
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(back, f.name), getattr(st, f.name)), f.name
    with pytest.raises(ValueError):
        convert.state_from_numpy({"x": d["x"]}, device="cpu")
    with pytest.raises(ValueError):
        convert.lp_from_numpy(c[0], A[0], b[0][:-1], device="cpu")
