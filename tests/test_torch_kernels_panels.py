"""The panel-major factor and pair-solve of ipx_torch.kernels.cholesky against
ipx.kernels.cholesky (Pallas kernels in interpret mode on the CPU, the XLA
glue as it is) and f64 oracles, on the same numpy inputs.  The port side
runs the plain versions: its tensors are on the CPU.

Tolerances.  Panels and W against ipx: 1e-5 of each panel's (W's) largest
entry; both sides are f32 left-looking factors of the same matrix and differ
in summation order only.  Panels against the f64 Cholesky of the f64 scaled
regularised matrix: 5e-4 absolute, the reference test's own tolerance
(tests/test_kernels_cholesky.py).  Solutions against ipx: 1e-4 of the
largest entry, as the reference test of its pair-solves.  On the
ill-conditioned diagonal block (entries spanning 1e8) the inverse is held to
1e-3: two f32 inversions of a factor of condition 1e4 differ by
condition x eps, and what counts there is the residual W L - I.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ipx.kernels import cholesky as jpk
from ipx.numerics import mv as jmv
from ipx_torch import convert
from ipx_torch.kernels import cholesky as tpk, fused as tfk

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


def _fused_inputs(seed=31, B=2, m=256, n=384):
    rng = np.random.default_rng(seed)
    A32 = (rng.standard_normal((B, m, n)) / np.sqrt(n)).astype(np.float32)
    At = torch.from_numpy(A32).to(torch.bfloat16)
    d2 = rng.uniform(0.01, 100.0, (B, n)).astype(np.float32)
    Af = At.to(torch.float64).numpy()
    M = np.einsum("bij,bj,bkj->bik", Af, d2.astype(np.float64), Af)
    j = 1.0 / np.sqrt(np.einsum("bii->bi", M))
    # distinct per-instance regs: reg_boost differs across a batch
    regs = np.array([1e-8, 1e-4])[:B]
    Ms = M * j[:, :, None] * j[:, None, :] + regs[:, None, None] * np.eye(m)
    return At, d2, j.astype(np.float32), regs.astype(np.float32), Ms


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_factor_fused_panels_matches_ipx_and_oracle():
    At, d2, j, regs, Ms = _fused_inputs()
    m = At.shape[1]
    pj, Wj = jpk.factor_fused_panels(
        jnp.asarray(At.float().numpy()).astype(jnp.bfloat16), jnp.asarray(d2),
        jnp.asarray(j), jnp.asarray(regs))
    pt, Wt = tpk.factor_fused_panels(At, torch.from_numpy(d2),
                                     torch.from_numpy(j),
                                     torch.from_numpy(regs))
    assert len(pt) == len(pj) == m // NB
    assert tuple(Wt.shape) == (2, m // NB, NB, NB) and Wt.dtype == torch.float32
    Lref = np.linalg.cholesky(Ms)
    for k, (a, b) in enumerate(zip(pt, pj)):
        o = k * NB
        assert tuple(a.shape) == (2, NB, m - o) and a.is_contiguous()
        assert _rel(a.numpy(), b) <= 1e-5, k
        ref = Lref[:, o:, o:o + NB].swapaxes(1, 2)
        assert np.abs(a.double().numpy() - ref).max() < 5e-4, k
    assert _rel(Wt.numpy(), Wj) <= 1e-5
    # instance 1 carries ITS reg (1e-4), not instance 0's: L00 = sqrt(1 + reg)
    l00 = pt[0][:, 0, 0].double().numpy()
    assert abs(l00[1] ** 2 - (1 + 1e-4)) <= 2e-6 < abs(l00[0] ** 2 - (1 + 1e-4))


def test_factor_lt_panels_matches_ipx_and_reconstructs():
    *_, Ms = _fused_inputs(seed=33)
    M32 = Ms.astype(np.float32)
    pj, Wj = jpk.factor_lt_panels(jnp.asarray(M32))
    pt, Wt = tpk.factor_lt_panels(torch.from_numpy(M32))
    m = M32.shape[1]
    LT = np.zeros_like(Ms)
    for k, (a, b) in enumerate(zip(pt, pj)):
        assert _rel(a.numpy(), b) <= 1e-5, k
        LT[:, k * NB:(k + 1) * NB, k * NB:] = a.double().numpy()
    assert _rel(Wt.numpy(), Wj) <= 1e-5
    # L L^T gives the matrix back, and W inverts the diagonal blocks
    rec = np.einsum("bki,bkj->bij", LT, LT)
    assert np.abs(rec - Ms).max() <= 1e-5 * np.abs(Ms).max()
    for k in range(m // NB):
        Ld = LT[:, k * NB:(k + 1) * NB, k * NB:(k + 1) * NB].swapaxes(1, 2)
        assert np.abs(Wt[:, k].double().numpy() @ Ld - np.eye(NB)).max() <= 1e-5


def _ill_conditioned_block():
    """SPD block with diagonal entries spanning 1e8 of dynamic range (the f32
    endgame regime), as tests/test_kernels_cholesky.py builds it."""
    rng = np.random.default_rng(0)
    d = 10.0 ** rng.uniform(-4, 4, NB)
    R = rng.standard_normal((NB, NB)) * 0.1 + np.eye(NB)
    M = (R @ R.T) * np.outer(np.sqrt(d), np.sqrt(d))
    return 0.5 * (M + M.T) + 1e-6 * np.diag(d)


@pytest.mark.parametrize("case,w_tol", [("scaled", 1e-5),
                                        ("ill_conditioned", 1e-3)])
def test_diag_factor_inv_matches_ipx(case, w_tol):
    if case == "scaled":
        *_, Ms = _fused_inputs(seed=35)
        blk = Ms[:, :NB, :NB]
    else:
        blk = _ill_conditioned_block()[None]
    blk32 = blk.astype(np.float32)
    Lj, Wj = jpk._factor_block_twolevel(jnp.asarray(blk32), mosaic=False)
    LT, W = tpk.diag_factor_inv(torch.from_numpy(blk32))
    scale = np.abs(np.asarray(Lj)).max()
    assert np.abs(LT.mT.numpy() - np.asarray(Lj)).max() <= 1e-5 * scale
    assert _rel(W.numpy(), Wj) <= w_tol
    assert float(LT.tril(-1).abs().max()) == 0.0       # L^T is upper
    # W inverts the f32 factor to near-eps relative residual (5e-4 is the
    # reference test's bound on the ill-conditioned block)
    resid = np.abs(W.double().numpy() @ LT.mT.double().numpy() - np.eye(NB)).max()
    assert resid < 5e-4, resid


def test_diag_factor_inv_reads_the_lower_triangle_only_and_writes_views():
    *_, Ms = _fused_inputs(seed=37)
    blk = torch.from_numpy(Ms[:, :NB, :NB].astype(np.float32))
    LT0, W0 = tpk.diag_factor_inv(blk)
    junk = blk + torch.triu(torch.full((NB, NB), 7.0), diagonal=1)
    wide = torch.zeros(2, NB, 3 * NB)
    wide[:, :, NB:2 * NB] = junk
    Wout = torch.zeros(2, 2, NB, NB)
    # in: a slice of a wider panel; out: the same slice, and one W slot
    tpk.diag_factor_inv(wide[:, :, NB:2 * NB], out_lt=wide[:, :, NB:2 * NB],
                        out_w=Wout[:, 1])
    assert torch.equal(wide[:, :, NB:2 * NB], LT0)
    assert torch.equal(Wout[:, 1], W0) and float(Wout[:, 0].abs().max()) == 0.0
    assert float(wide[:, :, :NB].abs().max()) == 0.0


def test_non_pd_block_gives_a_non_positive_diagonal_not_an_error():
    *_, Ms = _fused_inputs(seed=39)
    blk = Ms[:, :NB, :NB].astype(np.float32)
    blk[1, 5, 5] = -1.0
    LT, _ = tpk.diag_factor_inv(torch.from_numpy(blk))
    d = torch.diagonal(LT, dim1=1, dim2=2)
    assert bool((d[0] > 0).all()) and bool(torch.isfinite(LT[0]).all())
    assert not bool(((d[1] > 0) & torch.isfinite(d[1])).all())


@pytest.mark.parametrize("B", [1, 3, 5])
def test_pair_solve_matches_ipx_on_the_same_factor(B):
    """Factor in ipx, carry the factor across with convert.factor_from_ipx,
    solve in both."""
    rng = np.random.default_rng(7 + B)
    m = 256
    G = rng.standard_normal((B, m, m)).astype(np.float32) / 16
    M = G @ G.swapaxes(1, 2) + 2 * np.eye(m, dtype=np.float32)
    b = rng.standard_normal((B, m)).astype(np.float32)
    pj, Wj = jpk.factor_lt_panels(jnp.asarray(M))
    xj = np.asarray(jpk.chol_solve_batched_panels(pj, Wj, jnp.asarray(b)))
    fac = convert.factor_from_ipx(
        [np.asarray(p) for p in pj], np.asarray(Wj), np.ones((B, m)),
        np.ones((B, m)), np.ones(B, bool), device="cpu")
    assert fac.ok.tolist() == [True] * B and len(fac.LTp) == m // NB
    xt = tpk.chol_solve_batched_panels(fac.LTp, fac.W, torch.from_numpy(b))
    ref = np.linalg.solve(M.astype(np.float64), b[..., None])[..., 0]
    scale = np.abs(ref).max()
    assert np.abs(xt.numpy() - xj).max() <= 1e-4 * scale
    assert np.abs(xt.numpy() - ref).max() <= 1e-4 * scale


def test_factor_from_ipx_single_instance_and_bad_layout():
    pj = [np.zeros((NB, 2 * NB), np.float32), np.zeros((NB, NB), np.float32)]
    fac = convert.factor_from_ipx(pj, np.zeros((2, NB, NB)), np.ones(200),
                                  np.ones(300), True, device="cpu")
    assert tuple(fac.LTp[0].shape) == (1, NB, 2 * NB)
    assert tuple(fac.W.shape) == (1, 2, NB, NB) and tuple(fac.j.shape) == (1, 200)
    with pytest.raises(ValueError):
        convert.factor_from_ipx(pj[:1], np.zeros((2, NB, NB)), np.ones(200),
                                np.ones(300), True, device="cpu")
    with pytest.raises(ValueError):
        convert.factor_from_ipx([], np.zeros((0, NB, NB)), np.ones(200),
                                np.ones(300), True, device="cpu")


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_squared_a_matvec_is_the_jacobi_diagonal(bf16):
    """a_matvec(A, d2, square=True) = diag(A D^2 A^T), the matvec ipx takes
    its Jacobi scale from on the fused route; 2e-6 of the largest entry as
    the other matvec tests (f32 sums in different orders)."""
    At, d2, *_ = _fused_inputs(seed=41)
    if not bf16:
        At = At.float()
    got = tfk.a_matvec(At, torch.from_numpy(d2), square=True).numpy()
    Af = At.double().numpy()
    ref = np.einsum("bij,bj->bi", Af * Af, d2.astype(np.float64))
    via_ipx = np.stack([np.asarray(jmv(jnp.square(jnp.asarray(a, jnp.float32)),
                                       jnp.asarray(d), "highest"))
                        for a, d in zip(Af, d2)])
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()
    assert np.abs(got - via_ipx).max() <= 2e-6 * np.abs(ref).max()


def test_fused_factor_fits_gate():
    assert tpk.fused_factor_fits(256, 384, torch.bfloat16)
    assert not tpk.fused_factor_fits(256, 384, torch.float32)
    assert not tpk.fused_factor_fits(200, 384, torch.bfloat16)
    assert not tpk.fused_factor_fits(256, 200, torch.bfloat16)


A = torch.zeros(2, 256, 384, dtype=torch.bfloat16)
D2, J, REG = torch.zeros(2, 384), torch.zeros(2, 256), torch.zeros(2)
M2 = torch.zeros(2, 256, 256)
PANELS = (torch.zeros(2, NB, 256), torch.zeros(2, NB, NB))
W2, B2 = torch.zeros(2, 2, NB, NB), torch.zeros(2, 256)
CD = torch.zeros(2, NB, NB)

BAD_CALLS = [
    ("fused f32 A", lambda: tpk.factor_fused_panels(A.float(), D2, J, REG), TypeError),
    ("fused f64 d2", lambda: tpk.factor_fused_panels(A, D2.double(), J, REG), TypeError),
    ("fused j shape", lambda: tpk.factor_fused_panels(A, D2, D2, REG), ValueError),
    ("fused reg shape", lambda: tpk.factor_fused_panels(A, D2, J, REG[:1]), ValueError),
    ("fused rank", lambda: tpk.factor_fused_panels(A[0], D2[0], J[0], REG[0]), ValueError),
    ("fused m off grid", lambda: tpk.factor_fused_panels(
        A[:, :200].contiguous(), D2, J[:, :200].contiguous(), REG), ValueError),
    ("fused n off grid", lambda: tpk.factor_fused_panels(
        A[:, :, :200].contiguous(), D2[:, :200].contiguous(), J, REG), ValueError),
    ("fused strided A", lambda: tpk.factor_fused_panels(
        A.mT.contiguous().mT[:, :256, :384], D2, J, REG), ValueError),
    ("fused strided j", lambda: tpk.factor_fused_panels(
        A, D2, torch.zeros(2, 512)[:, ::2], REG), ValueError),
    ("fused d2 elsewhere", lambda: tpk.factor_fused_panels(
        A, D2.to("meta"), J, REG), ValueError),
    ("lt f64 M", lambda: tpk.factor_lt_panels(M2.double()), TypeError),
    ("lt not square", lambda: tpk.factor_lt_panels(M2[:, :, :128]), ValueError),
    ("lt m off grid", lambda: tpk.factor_lt_panels(torch.zeros(1, 200, 200)), ValueError),
    ("lt strided", lambda: tpk.factor_lt_panels(M2.mT), ValueError),
    ("lt too many panels", lambda: tpk.factor_lt_panels(
        torch.zeros(1, 1, 1).expand(1, 65 * NB, 65 * NB)), ValueError),
    ("lt m over the solve's limit", lambda: tpk.factor_lt_panels(
        torch.zeros(1, 1, 1).expand(1, tpk.MAX_M + NB, tpk.MAX_M + NB)),
     ValueError),
    ("fused m over the solve's limit", lambda: tpk.factor_fused_panels(
        torch.zeros(1, tpk.MAX_M + NB, NB, dtype=torch.bfloat16),
        torch.zeros(1, NB), torch.zeros(1, tpk.MAX_M + NB), torch.zeros(1)),
     ValueError),
    ("solve m over its limit", lambda: tpk.chol_solve_batched_panels(
        PANELS, W2, torch.zeros(1, tpk.MAX_M + NB)), ValueError),
    ("solve f64 b", lambda: tpk.chol_solve_batched_panels(PANELS, W2, B2.double()), TypeError),
    ("solve bf16 panel", lambda: tpk.chol_solve_batched_panels(
        (PANELS[0].to(torch.bfloat16), PANELS[1]), W2, B2), TypeError),
    ("solve panel count", lambda: tpk.chol_solve_batched_panels(PANELS[:1], W2, B2), ValueError),
    ("solve panel shape", lambda: tpk.chol_solve_batched_panels(PANELS[::-1], W2, B2), ValueError),
    ("solve W shape", lambda: tpk.chol_solve_batched_panels(PANELS, W2[:, :1], B2), ValueError),
    ("solve m off grid", lambda: tpk.chol_solve_batched_panels(
        PANELS, W2, torch.zeros(2, 200)), ValueError),
    ("solve rank", lambda: tpk.chol_solve_batched_panels(PANELS, W2, B2[0]), ValueError),
    ("solve strided b", lambda: tpk.chol_solve_batched_panels(
        PANELS, W2, torch.zeros(2, 512)[:, ::2]), ValueError),
    ("solve W elsewhere", lambda: tpk.chol_solve_batched_panels(
        PANELS, W2.to("meta"), B2), ValueError),
    ("diag out elsewhere", lambda: tpk.diag_factor_inv(
        CD, out_lt=CD.to("meta")), ValueError),
    ("diag f64", lambda: tpk.diag_factor_inv(CD.double()), TypeError),
    ("diag shape", lambda: tpk.diag_factor_inv(torch.zeros(2, 64, 64)), ValueError),
    ("diag rank", lambda: tpk.diag_factor_inv(CD[0]), ValueError),
    ("diag strided rows", lambda: tpk.diag_factor_inv(CD.mT), ValueError),
    ("diag out_w strided", lambda: tpk.diag_factor_inv(
        CD, out_w=torch.zeros(2, NB, 2 * NB)[:, :, :NB]), ValueError),
]


@pytest.mark.parametrize("name,call,exc", BAD_CALLS, ids=[c[0] for c in BAD_CALLS])
def test_panel_wrappers_refuse_wrong_inputs(name, call, exc):
    with pytest.raises(exc):
        call()


def test_panel_wrappers_count_no_launch_on_cpu():
    before = dict(tpk.LAUNCHES)
    eye = torch.eye(256).expand(2, 256, 256).contiguous()
    panels, W = tpk.factor_lt_panels(eye)
    tpk.chol_solve_batched_panels(panels, W, B2)
    tpk.diag_factor_inv(eye[:, :NB, :NB])
    assert dict(tpk.LAUNCHES) == before


def test_one_m_limit_for_factor_and_solve():
    """The factor takes no m the pair-solve refuses: one limit, the one the
    kernels are compiled with."""
    from ipx_torch.kernels import _build
    assert tpk.MAX_M == _build.PANEL_MAX_M and tpk.MAX_M % NB == 0
    assert f"-DIPX_PANEL_MAX_M={tpk.MAX_M}" in _build.NVCC_FLAGS
    for name in ("factor_fused_panels", "factor_lt_panels",
                 "chol_solve_batched_panels"):
        tpk._check_panel_dims(name, 1, tpk.MAX_M)
        with pytest.raises(ValueError, match=str(tpk.MAX_M)):
            tpk._check_panel_dims(name, 1, tpk.MAX_M + NB)
