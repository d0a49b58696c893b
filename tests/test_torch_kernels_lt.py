"""The factors and solves of ipx_torch.kernels.cholesky that keep a full
(B, m, m) matrix (cholesky_batched, factor_lt_batched, chol_solve_batched_lt,
solve_triangular_batched) against ipx.kernels.cholesky (Pallas kernels in
interpret mode on the CPU) and numpy float64, on the same numpy inputs.  The
port side runs the plain versions: its tensors are on the CPU.

Tolerances.  L, LT and W against ipx elementwise: rtol 2e-4 with atol 2e-5 of
the factor's largest entry (W: of W's largest); both sides are f32 blocked
factors of one matrix of condition 100 and differ in summation order only
(measured over the cases below: at most 2.4e-7 of the largest entry for L
and LT, 5.2e-7 for W).  Reconstruction L L^T against M: 1e-4 of M's largest
entry, the reference test's own bound (measured 2.9e-7).  Solutions against
ipx and against a numpy f64 solve: 1e-4 of the solution's largest entry
(measured 6.6e-7 and 1.6e-6 for the pair-solve, 4.7e-7 for one sweep).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ipx.kernels import cholesky as jpk
from ipx_torch.kernels import cholesky as tpk

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
# every m and every B, not every pair: each (B, m) is one more trace and
# compile of the interpret-mode kernels on the JAX side, which is nearly all
# of this file's time
SHAPES = [(1, 128), (3, 128), (3, 256), (1, 384)]
# the solves reuse the factors compiled for SHAPES
SOLVE_SHAPES = [(1, 128), (3, 256), (1, 384)]


def _random_spd(B, m, seed, cond=100.0):
    """SPD matrices with a geometric spectrum, as tests/test_kernels_cholesky
    builds them; float64."""
    rng = np.random.default_rng(seed)
    out = np.empty((B, m, m))
    for i in range(B):
        Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
        out[i] = (Q * np.geomspace(1.0, 1.0 / cond, m)) @ Q.T
    return out


def _close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=2e-4,
                               atol=2e-5 * np.abs(ref).max(), err_msg=what)


def _w_inverts(W, L):
    """W[:, k] inverts the k-th diagonal block of L: 5e-4, the reference
    test's bound."""
    for k in range(L.shape[1] // NB):
        blk = L[:, k * NB:(k + 1) * NB, k * NB:(k + 1) * NB]
        assert np.abs(W[:, k] @ blk - np.eye(NB)).max() <= 5e-4, k


@pytest.mark.parametrize("B,m", SHAPES)
def test_cholesky_batched_matches_ipx_and_numpy(B, m):
    M = _random_spd(B, m, seed=m + B)
    M32 = M.astype(np.float32)
    Lj, Wj = jpk.cholesky_batched(jnp.asarray(M32))
    Lt, Wt = tpk.cholesky_batched(torch.from_numpy(M32))
    assert tuple(Lt.shape) == (B, m, m)
    assert tuple(Wt.shape) == (B, m // NB, NB, NB)
    _close(Lt.numpy(), Lj, "L against ipx")
    _close(Wt.numpy(), Wj, "W against ipx")
    L = Lt.double().numpy()
    _close(L, np.linalg.cholesky(M32.astype(np.float64)), "L against numpy")
    assert np.abs(L @ L.swapaxes(1, 2) - M).max() <= 1e-4 * np.abs(M).max()
    assert np.all(np.triu(L, 1) == 0)          # strict upper exactly zero
    _w_inverts(Wt.double().numpy(), L)


@pytest.mark.parametrize("B,m", SHAPES)
def test_factor_lt_batched_matches_ipx_and_numpy(B, m):
    M = _random_spd(B, m, seed=2 * m + B)
    M32 = M.astype(np.float32)
    LTj, Wj = jpk.factor_lt_batched(jnp.asarray(M32))
    LTt, Wt = tpk.factor_lt_batched(torch.from_numpy(M32))
    assert tuple(LTt.shape) == (B, m, m)
    _close(LTt.numpy(), LTj, "LT against ipx")
    _close(Wt.numpy(), Wj, "W against ipx")
    LT = LTt.double().numpy()
    _close(LT.swapaxes(1, 2), np.linalg.cholesky(M32.astype(np.float64)),
           "LT against numpy")
    assert np.abs(LT.swapaxes(1, 2) @ LT - M).max() <= 1e-4 * np.abs(M).max()
    assert np.all(np.tril(LT, -1) == 0)        # strict lower exactly zero
    _w_inverts(Wt.double().numpy(), LT.swapaxes(1, 2))


def test_factor_lt_batched_rows_are_the_panel_factor():
    """The plain full-matrix factor is the plain panel factor laid into a
    matrix, bit for bit, and its W the same."""
    M32 = torch.from_numpy(_random_spd(2, 384, seed=5).astype(np.float32))
    LT, W = tpk.factor_lt_batched(M32)
    panels, Wp = tpk.factor_lt_panels(M32)
    assert torch.equal(W, Wp)
    assert torch.equal(LT, tpk.lt_of_panels(panels))
    for a, b in zip(tpk.panels_of_lt(LT), panels):
        assert torch.equal(a, b)


def test_factor_lt_ill_conditioned_stays_finite():
    """An endgame-style spectrum (condition 1e6): finite factor that gives
    the matrix back to 1e-4 of its largest entry, as the reference test."""
    M = _random_spd(2, 256, seed=22, cond=1e6)
    for fn, lower in ((tpk.factor_lt_batched, False),
                      (tpk.cholesky_batched, True)):
        F, W = fn(torch.from_numpy(M.astype(np.float32)))
        assert bool(torch.isfinite(F).all()) and bool(torch.isfinite(W).all())
        L = F.double().numpy() if lower else F.double().numpy().swapaxes(1, 2)
        assert np.abs(L @ L.swapaxes(1, 2) - M).max() <= 1e-4 * np.abs(M).max()


@pytest.mark.parametrize("B,m", SOLVE_SHAPES)
def test_chol_solve_batched_lt_matches_ipx_on_the_same_factor(B, m):
    rng = np.random.default_rng(3 * m + B)
    M = _random_spd(B, m, seed=3 * m + B, cond=50.0)
    b = rng.standard_normal((B, m)).astype(np.float32)
    LTj, Wj = jpk.factor_lt_batched(jnp.asarray(M, jnp.float32))
    xj = np.asarray(jpk.chol_solve_batched_lt(LTj, Wj, jnp.asarray(b)))
    LT = torch.from_numpy(np.asarray(LTj).copy())
    W = torch.from_numpy(np.asarray(Wj).copy())
    xt = tpk.chol_solve_batched_lt(LT, W, torch.from_numpy(b)).numpy()
    ref = np.linalg.solve(M, b.astype(np.float64)[..., None])[..., 0]
    scale = np.abs(ref).max()
    assert np.abs(xt - xj).max() <= 1e-4 * scale
    assert np.abs(xt - ref).max() <= 1e-4 * scale


@pytest.mark.parametrize("B,m", [(1, 128), (3, 256), (2, 384)])
def test_lt_solve_is_the_panel_solve_and_reads_only_the_stripes(B, m):
    """The full-LT solve on panels scattered into a matrix gives the panel
    solve's bits, and NaN everywhere on and below the diagonal changes
    nothing: only the strict-suffix stripes are read."""
    rng = np.random.default_rng(m)
    M32 = torch.from_numpy(_random_spd(B, m, seed=m).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((B, m)).astype(np.float32))
    panels, W = tpk.factor_lt_panels(M32)
    x6 = tpk.chol_solve_batched_panels(panels, W, b)
    LT = tpk.lt_of_panels(panels)
    x8 = tpk.chol_solve_batched_lt(LT, W, b)
    assert torch.equal(x8, x6)
    LT[torch.ones(m, m, dtype=torch.bool).tril().expand(B, m, m)] = np.nan
    assert torch.equal(tpk.chol_solve_batched_lt(LT, W, b), x6)


@pytest.mark.parametrize("B,m", SOLVE_SHAPES)
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_solve_triangular_batched_matches_ipx_and_numpy(B, m, lower):
    rng = np.random.default_rng(4 * m + B)
    M = _random_spd(B, m, seed=4 * m + B)
    b = rng.standard_normal((B, m)).astype(np.float32)
    Lj, Wj = jpk.cholesky_batched(jnp.asarray(M, jnp.float32))
    yj = np.asarray(jpk.solve_triangular_batched(Lj, Wj, jnp.asarray(b),
                                                 lower=lower))
    L = torch.from_numpy(np.asarray(Lj).copy())
    W = torch.from_numpy(np.asarray(Wj).copy())
    yt = tpk.solve_triangular_batched(L, W, torch.from_numpy(b),
                                      lower=lower).numpy()
    L64 = np.asarray(Lj, np.float64)
    tri = L64 if lower else L64.swapaxes(1, 2)
    ref = np.linalg.solve(tri, b.astype(np.float64)[..., None])[..., 0]
    scale = np.abs(ref).max()
    assert np.abs(yt - yj).max() <= 1e-4 * scale
    assert np.abs(yt - ref).max() <= 1e-4 * scale


def test_two_sweeps_agree_with_the_pair_solve():
    """cholesky_batched -> solve_triangular_batched forward then backward is
    the pair-solve on L^T, to rounding (the forward sweep is left-looking
    here, right-looking there): 1e-5 of the solution's largest entry."""
    rng = np.random.default_rng(9)
    M = _random_spd(2, 384, seed=9, cond=50.0)
    b = torch.from_numpy(rng.standard_normal((2, 384)).astype(np.float32))
    L, W = tpk.cholesky_batched(torch.from_numpy(M.astype(np.float32)))
    y = tpk.solve_triangular_batched(L, W, b, lower=True)
    x = tpk.solve_triangular_batched(L, W, y, lower=False)
    x8 = tpk.chol_solve_batched_lt(L.mT.contiguous(), W, b)
    ref = np.linalg.solve(M, b.double().numpy()[..., None])[..., 0]
    assert float((x - x8).abs().max()) <= 1e-5 * np.abs(ref).max()
    assert np.abs(x.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_cholesky_single_matrix():
    M = _random_spd(1, 256, seed=13)[0]
    M32 = torch.from_numpy(M.astype(np.float32))
    L = tpk.cholesky(M32)
    assert tuple(L.shape) == (256, 256)
    assert torch.equal(L, tpk.cholesky_batched(M32[None])[0][0])
    _close(L.numpy(), np.asarray(jpk.cholesky(jnp.asarray(M32.numpy()))),
           "L against ipx")


def test_non_pd_lane_shows_on_its_own_diagonal_only():
    """A lane that is not positive definite gets a non-positive or
    non-finite diagonal entry and nothing raises; the healthy lane's factor
    is the one it gets alone (to rounding: the CPU's batched matmul sums in
    another order at another batch size)."""
    M = _random_spd(2, 256, seed=17).astype(np.float32)
    M[1, 130, 130] = -1.0
    Mt = torch.from_numpy(M)
    for fn in (tpk.cholesky_batched, tpk.factor_lt_batched):
        F, _ = fn(Mt)
        alone, _ = fn(Mt[:1].contiguous())
        d = torch.diagonal(F, dim1=1, dim2=2)
        assert bool((d[0] > 0).all()) and bool(torch.isfinite(F[0]).all())
        assert not bool(((d[1] > 0) & torch.isfinite(d[1])).all())
        assert torch.allclose(F[:1], alone, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["cholesky_batched", "factor_lt_batched",
                                  "chol_solve_batched_lt",
                                  "solve_triangular_batched"])
def test_bad_shapes_and_types_are_refused(name):
    """m off the 128 grid, m over the blocked routes' limit, float64 and a
    non-contiguous matrix raise before any work.  ``factor_lt_batched``, the
    large single LP's factor, takes m over that limit (shapes only here;
    ``tests/test_torch_sharded.py`` factors such an m)."""
    fn = getattr(tpk, name)
    solve = name.startswith(("chol_solve", "solve_"))

    def call(B, m, dtype=torch.float32, transposed=False):
        F = torch.zeros(B, m, m, dtype=dtype)
        if transposed:
            F = F.mT
        if not solve:
            return fn(F)
        return fn(F, torch.zeros(B, max(m // NB, 1), NB, NB, dtype=dtype),
                  torch.zeros(B, m, dtype=dtype))

    over = tpk.MAX_M + NB
    for m in (200, 64) + (() if name == "factor_lt_batched" else (over,)):
        with pytest.raises(ValueError, match=str(m)):
            call(1, m)
    if name == "factor_lt_batched":
        tpk._check_panel_dims(name, 1, over, capped=False)
    with pytest.raises(TypeError):
        call(1, 128, dtype=torch.float64)
    F = torch.zeros(1, 256, 256).mT
    assert not F.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        call(1, 256, transposed=True)
    # the largest m is taken (checked on shapes only: no work is done here)
    tpk._check_panel_dims(name, 1, tpk.MAX_M)
