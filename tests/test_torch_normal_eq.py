"""ipx_torch.linsys.normal_eq factor + solve against ipx.linsys.normal_eq on
the same A, d2 and right-hand sides (numpy, seeded).

f64: 1e-10 relative.  ``ipx`` assembles and factors its preconditioner in
f32 even for f64 input, the port in f64; three CG steps on the true f64
operator bring both to the same solution.  f32: 1e-4 relative: the two
CG recurrences round in different orders.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ipx
import ipx_torch
from ipx.linsys import normal_eq as jne
from ipx_torch.linsys import normal_eq as tne
from ipx_torch.linsys import products

torch.set_num_threads(1)


def _inputs(B, m, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n)) / np.sqrt(n)
    d2 = np.exp(rng.standard_normal((B, n)))
    rhs = rng.standard_normal((B, m))
    return A, d2, rhs


def _both(A, d2, rhs, np_dtype, a_bf16=False, **kw):
    oj = ipx.SolverOptions(**kw)
    ot = ipx_torch.SolverOptions(**kw)
    Aj = jnp.asarray(A.astype(np_dtype))
    At = torch.from_numpy(A.astype(np_dtype))
    if a_bf16:
        Aj, At = Aj.astype(jnp.bfloat16), At.to(torch.bfloat16)
    d2n, rn = d2.astype(np_dtype), rhs.astype(np_dtype)

    def one(a, d, r):
        fac = jne.factor(a, d, oj)
        return jne.solve(fac, a, r, oj), fac.ok

    yj, okj = jax.vmap(one)(Aj, jnp.asarray(d2n), jnp.asarray(rn))
    fac = tne.factor(At, torch.from_numpy(d2n), ot)
    yt = tne.solve(fac, At, torch.from_numpy(rn), ot)
    return yt.numpy(), np.asarray(yj), fac.ok.numpy(), np.asarray(okj), At


def _oracle(A, d2, rhs):
    return np.stack([np.linalg.solve((a * d) @ a.T, r)
                     for a, d, r in zip(A, d2, rhs)])


def test_factor_solve_f64_matches_ipx():
    A, d2, rhs = _inputs(2, 64, 128, 0)
    yt, yj, okt, okj, _ = _both(A, d2, rhs, np.float64, dtype="float64")
    assert okt.all() and okj.all()
    scale = np.abs(yj).max()
    assert np.abs(yt - yj).max() <= 1e-10 * scale
    assert np.abs(yt - _oracle(A, d2, rhs)).max() <= 1e-10 * scale


@pytest.mark.parametrize("kw,bf16", [
    (dict(), False),
    (dict(matvec_backend="fused"), False),
    (dict(matvec_backend="fused", a_storage="bfloat16", refine_steps=1), True),
    (dict(refine_steps=0), False),
], ids=["xla", "fused", "fused-bf16-cg1", "cg0"])
def test_factor_solve_f32_matches_ipx(kw, bf16):
    A, d2, rhs = _inputs(3, 64, 128, 1)
    yt, yj, okt, okj, At = _both(A, d2, rhs, np.float32, a_bf16=bf16,
                                 dtype="float32", **kw)
    assert okt.all() and okj.all()
    scale = np.abs(yj).max()
    assert np.abs(yt - yj).max() <= 1e-4 * scale
    if kw.get("refine_steps", 3) > 0:
        y64 = _oracle(At.double().numpy(), d2.astype(np.float32), rhs)
        assert np.abs(yt - y64).max() <= 1e-4 * np.abs(y64).max()


def test_non_pd_input_reports_not_ok_without_raising():
    """A lane whose scaled matrix is not positive definite (here: d2 with
    negative entries) must come back ok=False, the healthy lane ok=True;
    torch.linalg.cholesky would raise."""
    A, d2, rhs = _inputs(2, 32, 64, 2)
    d2[1] = -np.abs(d2[1])
    d2[1, :4] = 1e-3
    opts = ipx_torch.SolverOptions(dtype="float64")
    At = torch.from_numpy(A)
    fac = tne.factor(At, torch.from_numpy(d2), opts)
    assert fac.ok.tolist() == [True, False]
    y = tne.solve(fac, At, torch.from_numpy(rhs), opts)    # must not raise
    assert tuple(y.shape) == (2, 32)
    assert np.abs(y[0].numpy() - _oracle(A[:1], d2[:1], rhs[:1])[0]).max() \
        <= 1e-9 * np.abs(y[0].numpy()).max()


def test_nan_input_reports_not_ok():
    A, d2, rhs = _inputs(2, 32, 64, 3)
    d2[0, 0] = np.nan
    fac = tne.factor(torch.from_numpy(A), torch.from_numpy(d2),
                     ipx_torch.SolverOptions(dtype="float64"))
    assert fac.ok.tolist() == [False, True]


def test_reg_scale_is_per_lane():
    A, d2, _ = _inputs(2, 32, 64, 4)
    opts = ipx_torch.SolverOptions(dtype="float64", reg=1e-3)
    At, dt = torch.from_numpy(A), torch.from_numpy(d2)
    f1 = tne.factor(At, dt, opts, reg_scale=torch.tensor([1.0, 100.0]))
    LLt = f1.L @ f1.L.mT
    diag = torch.diagonal(LLt, dim1=-2, dim2=-1)
    assert torch.allclose(diag[0], torch.full((32,), 1 + 1e-3, dtype=torch.float64))
    assert torch.allclose(diag[1], torch.full((32,), 1 + 1e-1, dtype=torch.float64))


def test_use_fused_matvec_gate():
    A32 = torch.zeros(1, 64, 128)
    fused = ipx_torch.SolverOptions(matvec_backend="fused")
    assert products.use_fused_matvec(fused, A32)
    assert products.use_fused_matvec(fused, A32.to(torch.bfloat16))
    assert not products.use_fused_matvec(fused, A32.double())
    assert not products.use_fused_matvec(ipx_torch.SolverOptions(), A32)
