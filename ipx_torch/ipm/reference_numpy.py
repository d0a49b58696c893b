"""Float64 numpy Mehrotra predictor-corrector solver.

This module *is* the reference capability (BASELINE.json config 1: "single
small dense LP ... solved on CPU via numpy reference path").  The reference
mount was empty at survey time (SURVEY.md §0), so this file implements the
canonical Mehrotra (1992) algorithm exactly as specified in SURVEY.md
§2.1/§3.1 [evidence tier B: Mehrotra 1992; Nocedal & Wright, Numerical
Optimization, ch. 14, eqs. 14.35-14.37] and stands in for the reference
solver in every oracle role (SURVEY.md §7 fidelity contract).

It is also the float64 step-lock oracle for the JAX solver's unit tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ipx_torch.status import Status


@dataclass
class NumpySolution:
    x: np.ndarray
    y: np.ndarray
    s: np.ndarray
    objective: float
    dual_objective: float
    status: int
    iterations: int
    rel_gap: float
    rp_rel: float
    rd_rel: float
    trace: list = field(default_factory=list)   # per-iter dicts (reference R14)


def starting_point(A: np.ndarray, b: np.ndarray, c: np.ndarray):
    """Mehrotra's least-squares starting point (reference R3).

    x~ = A^T (A A^T)^-1 b,  y~ = (A A^T)^-1 A c,  s~ = c - A^T y~,
    then shift into the positive orthant (Nocedal & Wright 14.35-14.37).
    """
    m, n = A.shape
    M = A @ A.T
    M[np.diag_indices(m)] += 1e-12 * max(1.0, np.trace(M) / m)
    L = np.linalg.cholesky(M)

    def solve(rhs):
        return np.linalg.solve(L.T, np.linalg.solve(L, rhs))

    x = A.T @ solve(b)
    y = solve(A @ c)
    s = c - A.T @ y

    dx = max(-1.5 * x.min(), 0.0)
    ds = max(-1.5 * s.min(), 0.0)
    x = x + dx
    s = s + ds
    xs = x @ s
    if xs <= 0:
        return np.ones(n), y, np.ones(n)
    x = x + 0.5 * xs / s.sum()
    s = s + 0.5 * xs / x.sum()
    return x, y, s


def _max_step(v: np.ndarray, dv: np.ndarray) -> float:
    """alpha_max = min over dv<0 of -v/dv  (reference R9 ratio test)."""
    neg = dv < 0
    if not np.any(neg):
        return np.inf
    return float(np.min(-v[neg] / dv[neg]))


def solve(
    c: np.ndarray,
    A: np.ndarray,
    b: np.ndarray,
    tol: float = 1e-9,
    tol_feas: float = 1e-9,
    max_iter: int = 100,
    damping_floor: float = 0.995,
    sigma_power: float = 3.0,
    verbose: bool = False,
) -> NumpySolution:
    """Canonical Mehrotra predictor-corrector on standard form (R3-R11).

    min c@x  s.t.  A@x = b, x >= 0.  Normal-equations KKT reduction
    (A D^2 A^T, D^2 = x/s) with a dense Cholesky, factor reused between the
    affine (predictor) and corrector solves — the call stack in SURVEY.md §3.1.
    """
    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    m, n = A.shape

    x, y, s = starting_point(A, b, c)
    bnorm = 1.0 + np.abs(b).max(initial=0.0)
    cnorm = 1.0 + np.abs(c).max(initial=0.0)

    status = Status.MAX_ITER
    trace = []
    it = 0
    for it in range(max_iter):
        rp = A @ x - b                    # primal residual (R4)
        rd = A.T @ y + s - c              # dual residual (R4)
        mu = (x @ s) / n
        pobj = c @ x
        dobj = b @ y
        rel_gap = abs(pobj - dobj) / (1.0 + abs(pobj))
        rp_rel = np.abs(rp).max(initial=0.0) / bnorm
        rd_rel = np.abs(rd).max(initial=0.0) / cnorm

        trace.append(dict(iter=it, mu=mu, rp=rp_rel, rd=rd_rel, gap=rel_gap))
        if verbose:
            print(f"iter {it:3d}  mu={mu:9.2e} rp={rp_rel:9.2e} "
                  f"rd={rd_rel:9.2e} gap={rel_gap:9.2e}")

        if rel_gap <= tol and rp_rel <= tol_feas and rd_rel <= tol_feas:
            status = Status.OPTIMAL
            break

        # --- normal equations factorization (R5, R6) ------------------------
        d2 = x / s
        M = (A * d2) @ A.T
        M[np.diag_indices(m)] += 1e-12 * (1.0 + d2.max())
        try:
            L = np.linalg.cholesky(M)
        except np.linalg.LinAlgError:
            status = Status.NUMERICAL_FAILURE
            break

        def kkt_solve(r_xs):
            """Newton direction given complementarity rhs r_xs (R5)."""
            rhs = -rp - A @ (d2 * rd - r_xs / s)
            dy = np.linalg.solve(L.T, np.linalg.solve(L, rhs))
            ds = -rd - A.T @ dy
            dx = -(r_xs / s) - d2 * ds
            return dx, dy, ds

        # --- predictor / affine step (R7) -----------------------------------
        dx_a, dy_a, ds_a = kkt_solve(x * s)
        ap_a = min(1.0, _max_step(x, dx_a))
        ad_a = min(1.0, _max_step(s, ds_a))
        mu_aff = ((x + ap_a * dx_a) @ (s + ad_a * ds_a)) / n

        # --- centering (R8) --------------------------------------------------
        sigma = min(1.0, max(0.0, (mu_aff / mu))) ** sigma_power

        # --- corrector, factor reused (R10) ----------------------------------
        dx, dy, ds = kkt_solve(x * s + dx_a * ds_a - sigma * mu)

        # --- damped step lengths (R9) ----------------------------------------
        eta = max(damping_floor, 1.0 - mu)
        alpha_p = min(1.0, eta * _max_step(x, dx))
        alpha_d = min(1.0, eta * _max_step(s, ds))

        x = x + alpha_p * dx
        y = y + alpha_d * dy
        s = s + alpha_d * ds
        trace[-1].update(alpha_p=alpha_p, alpha_d=alpha_d, sigma=sigma)

        if not (np.all(np.isfinite(x)) and np.all(np.isfinite(s))):
            status = Status.NUMERICAL_FAILURE
            break
    else:
        it = max_iter

    pobj = float(c @ x)
    dobj = float(b @ y)
    rp_rel = float(np.abs(A @ x - b).max(initial=0.0) / bnorm)
    rd_rel = float(np.abs(A.T @ y + s - c).max(initial=0.0) / cnorm)
    rel_gap = abs(pobj - dobj) / (1.0 + abs(pobj))
    return NumpySolution(
        x=x, y=y, s=s, objective=pobj, dual_objective=dobj,
        status=int(status), iterations=it, rel_gap=rel_gap,
        rp_rel=rp_rel, rd_rel=rd_rel, trace=trace,
    )
