"""Host-side presolve + Ruiz equilibration (SURVEY.md component N2).

The reference repo has no presolve (SURVEY.md §2.1); the capability contract
adds it explicitly: "presolve/scaling -> host-side preprocessing"
(BASELINE.json:5) and config 2 requires "standard-form conversion + presolve"
for the Netlib-style suite.  Everything here is numpy float64 on the host —
it runs once per problem, before the device ever sees data.

Pipeline: standard-form (m, n) arrays in ->
  1. drop zero rows (0 = 0 feasible, else report infeasible)
  2. eliminate fixed variables created by zero columns (c_j decides:
     c_j >= 0 -> x_j = 0 droppable; c_j < 0 -> unbounded certificate)
  3. remove duplicate rows (exact duplicates after normalization)
  4. singleton rows  a_ij x_j = b_i  ->  fix x_j = b_i / a_ij, substitute
  5. Ruiz equilibration: iterate row/col inf-norm scaling to unit norms
The record of applied transforms supports exact postsolve (unscaling + fixed
variable re-insertion) so solutions are reported in original units.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ipx_torch import obs


@dataclass
class PresolveResult:
    """Reduced standard-form problem + everything needed for postsolve."""

    c: np.ndarray            # (n_red,)
    A: np.ndarray            # (m_red, n_red)
    b: np.ndarray            # (m_red,)
    obj_offset: float        # constant objective from fixed variables
    # postsolve data
    row_scale: np.ndarray    # (m_red,) Ruiz row scaling  (A_scaled = R A C)
    col_scale: np.ndarray    # (n_red,) Ruiz col scaling
    kept_cols: np.ndarray    # indices into original n for reduced columns
    fixed_vals: np.ndarray   # (n_orig,) values of eliminated variables (0 elsewhere)
    fixed_mask: np.ndarray   # (n_orig,) True where variable was eliminated
    kept_rows: np.ndarray    # indices into original m for reduced rows
    n_orig: int
    m_orig: int
    status: str = "ok"       # "ok" | "infeasible" | "unbounded"

    def postsolve_x(self, x_red: np.ndarray) -> np.ndarray:
        """Reduced scaled solution -> original-units primal x."""
        x = np.zeros(self.n_orig)
        x[self.fixed_mask] = self.fixed_vals[self.fixed_mask]
        x[self.kept_cols] = self.col_scale * np.asarray(x_red, np.float64)
        return x

    def postsolve_y(self, y_red: np.ndarray) -> np.ndarray:
        """Reduced scaled duals -> original-units duals for kept rows."""
        y = np.zeros(self.m_orig)
        y[self.kept_rows] = self.row_scale * np.asarray(y_red, np.float64)
        return y


def ruiz_equilibrate(A: np.ndarray, iters: int = 10, tol: float = 1e-2):
    """Ruiz scaling: returns (r, c) with  diag(r) A diag(c)  near-unit
    row/col inf-norms.  Standard iterative sqrt scaling (Ruiz 2001)."""
    m, n = A.shape
    r = np.ones(m)
    c = np.ones(n)
    As = np.abs(A)          # |A| scaled as A would be: the same norms
    for _ in range(iters):
        rn = np.sqrt(As.max(axis=1))
        cn = np.sqrt(As.max(axis=0))
        rn[rn == 0] = 1.0
        cn[cn == 0] = 1.0
        As /= rn[:, None]
        As /= cn[None, :]
        r /= rn
        c /= cn
        if (np.abs(1 - rn).max() < tol and np.abs(1 - cn).max() < tol):
            break
    return r, c


def _pow2_round(v: np.ndarray) -> np.ndarray:
    """Snap positive scale factors to the nearest power of two.

    Power-of-2 scaling is EXACT in binary floating point: it changes only
    the exponent, so a bf16-representable A stays bf16-representable after
    row/col scaling.  Needed when the solve stores A in bf16
    (SolverOptions.a_storage): arbitrary Ruiz factors would silently round
    the scaled instance by ~2^-9 relative — measured 1.3e-3 objective
    error on a bf16-exact instance that solves to 3.6e-7 unscaled.  Cost:
    equilibration quality within 2x of optimal per row/col — irrelevant to
    the f32 IPM's conditioning."""
    return np.exp2(np.round(np.log2(np.maximum(v, np.finfo(float).tiny))))


def presolve(c: np.ndarray, A: np.ndarray, b: np.ndarray,
             ruiz_iters: int = 10, feas_tol: float = 1e-9,
             pow2_scales: bool = False) -> PresolveResult:
    """Reduce and equilibrate a standard-form LP (host, float64).

    ``pow2_scales`` rounds every scale factor to a power of two (exact in
    binary FP) — set when the downstream solve stores A in bf16.

    Spans (``obs.span``): ``api.presolve`` around the whole, with
    ``api.presolve.reduce`` (the reduction loop), ``api.presolve.scale``
    (Ruiz and the cost scaling) and ``api.presolve.rank`` (the pivoted QR
    and the consistency test of the rows it drops); counters
    ``api.presolve.rows_dropped`` (by the loop), ``api.presolve.cols_fixed``
    and ``api.presolve.rank_dropped`` (by the QR)."""
    with obs.span("api.presolve"):
        c = np.asarray(c, np.float64).copy()
        A = np.asarray(A, np.float64).copy()
        b = np.asarray(b, np.float64).copy()
        m0, n0 = A.shape
        with obs.span("api.presolve.reduce"):
            red = _reduce(c, A, b, feas_tol)
        keep_rows, keep_cols, fixed_vals, fixed_mask, obj_offset, status = red
        obs.count("api.presolve.rows_dropped", m0 - int(keep_rows.sum()))
        obs.count("api.presolve.cols_fixed", int(fixed_mask.sum()))

        kept_rows = np.flatnonzero(keep_rows)
        kept_cols = np.flatnonzero(keep_cols)
        Ar = A[np.ix_(kept_rows, kept_cols)]
        with obs.span("api.presolve.scale"):
            A_sc, b_sc, c_sc, r, s = _scale(Ar, b[kept_rows], c[kept_cols],
                                            status == "ok", ruiz_iters,
                                            pow2_scales)
        if status == "ok" and A_sc.shape[0] > 1 and A_sc.size:
            with obs.span("api.presolve.rank"):
                keep_i = _independent_rows(A_sc, b_sc)
            if keep_i is None:
                status = "infeasible"
            else:
                obs.count("api.presolve.rank_dropped",
                          A_sc.shape[0] - keep_i.size)
                A_sc, b_sc = A_sc[keep_i], b_sc[keep_i]
                r, kept_rows = r[keep_i], kept_rows[keep_i]

        return PresolveResult(
            c=c_sc, A=A_sc, b=b_sc, obj_offset=obj_offset,
            row_scale=r, col_scale=s,
            kept_cols=kept_cols, fixed_vals=fixed_vals, fixed_mask=fixed_mask,
            kept_rows=kept_rows, n_orig=n0, m_orig=m0, status=status,
        )


def _reduce(c: np.ndarray, A: np.ndarray, b: np.ndarray, feas_tol: float):
    """Steps 1-4 of the pipeline, repeated until none applies; ``b`` is
    updated in place by the singleton substitutions.  Returns
    ``(keep_rows, keep_cols, fixed_vals, fixed_mask, obj_offset,
    status)``."""
    m0, n0 = A.shape
    fixed_vals = np.zeros(n0)
    fixed_mask = np.zeros(n0, bool)
    keep_rows = np.ones(m0, bool)
    keep_cols = np.ones(n0, bool)
    obj_offset = 0.0
    status = "ok"

    def bnorm():
        return 1.0 + np.abs(b).max(initial=0.0)

    changed = True
    while changed and status == "ok":
        changed = False
        Av = A[np.ix_(keep_rows, keep_cols)]
        bv = b[keep_rows]
        row_idx = np.flatnonzero(keep_rows)
        col_idx = np.flatnonzero(keep_cols)

        # 1. zero rows
        zr = np.abs(Av).max(axis=1, initial=0.0) == 0
        if zr.any():
            if np.abs(bv[zr]).max(initial=0.0) > feas_tol * bnorm():
                status = "infeasible"
                break
            keep_rows[row_idx[zr]] = False
            changed = True
            continue

        # 2. zero columns
        zc = np.abs(Av).max(axis=0, initial=0.0) == 0
        if zc.any():
            cj = c[col_idx[zc]]
            if (cj < -feas_tol).any():
                status = "unbounded"   # can push x_j -> +inf
                break
            # optimal at x_j = 0
            keep_cols[col_idx[zc]] = False
            fixed_mask[col_idx[zc]] = True
            changed = True
            continue

        # 3. singleton rows: one nonzero in the row -> variable fixed
        nnz = (Av != 0).sum(axis=1)
        singles = np.flatnonzero(nnz == 1)
        if singles.size:
            i = singles[0]
            jloc = np.flatnonzero(Av[i])[0]
            jglob = col_idx[jloc]
            val = bv[i] / Av[i, jloc]
            if val < -feas_tol:
                status = "infeasible"   # x >= 0 violated
                break
            val = max(val, 0.0)
            # substitute: b -= A[:, j] * val, drop row i and column j
            b[keep_rows] = bv - Av[:, jloc] * val
            obj_offset += c[jglob] * val
            fixed_vals[jglob] = val
            fixed_mask[jglob] = True
            keep_cols[jglob] = False
            keep_rows[row_idx[i]] = False
            changed = True
            continue

        # 4. duplicate rows (exact after max-normalization)
        if Av.shape[0] > 1:
            norms = np.abs(Av).max(axis=1)
            R = Av / norms[:, None]
            bn = bv / norms
            rep = _first_equal_rows(np.round(R, 12))
            drop = rep != np.arange(R.shape[0])
            if drop.any():
                for i in np.flatnonzero(drop):
                    if abs(bn[i] - bn[rep[i]]) > feas_tol * bnorm():
                        status = "infeasible"
                        break
                else:
                    keep_rows[row_idx[drop]] = False
                    changed = True
                    continue
                break
    return keep_rows, keep_cols, fixed_vals, fixed_mask, obj_offset, status


def _first_equal_rows(R: np.ndarray) -> np.ndarray:
    """For each row of ``R``, the index of the first row equal to it in
    value (``-0.0`` equal to ``0.0``): the row's own index where it is the
    first.  One hash of each row's bytes, where a lexicographic sort of
    the rows costs O(m log m) comparisons of n entries."""
    R = np.ascontiguousarray(R + 0.0)        # -0.0 + 0.0 is +0.0
    first: dict = {}
    return np.array([first.setdefault(row.tobytes(), i)
                     for i, row in enumerate(R)], dtype=np.int64)


def _scale(Ar: np.ndarray, br: np.ndarray, cr: np.ndarray, ok: bool,
           ruiz_iters: int, pow2_scales: bool):
    """Step 5 and the cost scaling: ``(A_sc, b_sc, c_sc, r, s)`` with
    ``A_sc = diag(r) Ar diag(s)``; unit scales where the reductions
    already settled the LP (``ok`` false)."""
    if ok and Ar.size:
        r, s = ruiz_equilibrate(Ar, iters=ruiz_iters)
        if pow2_scales:
            r = _pow2_round(r)
            s = _pow2_round(s)
    else:
        r = np.ones(Ar.shape[0])
        s = np.ones(Ar.shape[1])

    # scaled problem:  min (s*c) @ z  s.t.  (R A S) z = R b,  x = S z
    A_sc = (Ar * r[:, None]) * s[None, :]
    b_sc = br * r
    c_sc = cr * s

    # Cost-aware column scaling: Ruiz equilibrates
    # A's entries but cannot see c — objective coefficients spanning 1e5 vs
    # 1e-5 leave the vertex geometry ill-conditioned for the f32 IPM
    # (measured: 4/6 of a mixed-cost battery STALLED).  Columns whose
    # POST-RUIZ cost magnitude exceeds 1 are shrunk by 1/sqrt(|c_j|),
    # halving c's log-range without inflating any A column; small-c columns
    # are left alone — scaling them UP is what made the full [[A,b],[c,0]]
    # equilibration regress the netlib suite in round 1 (battery: 6/6 with
    # this form, 5/6 with the symmetric form).
    if ok and c_sc.size:
        cost_fix = 1.0 / np.sqrt(np.maximum(np.abs(c_sc), 1.0))
        if pow2_scales:
            cost_fix = _pow2_round(cost_fix)
        A_sc = A_sc * cost_fix[None, :]
        c_sc = c_sc * cost_fix
        s = s * cost_fix
    return A_sc, b_sc, c_sc, r, s


def _independent_rows(A_sc: np.ndarray, b_sc: np.ndarray):
    """Dependent-row elimination (rank-revealing QR on the equilibrated
    matrix): the rows to keep, sorted, or None where a dropped row is
    inconsistent and the LP infeasible.

    Netlib-class LPs routinely carry linearly dependent rows, which make
    A A^T exactly singular and break the normal-equations IPM;
    exact-duplicate removal above does not catch general combinations.
    Dropped rows must be CONSISTENT (b in the row space) or the problem is
    infeasible.  Dual postsolve reports y = 0 on dropped rows (a valid dual
    completion for a consistent dependent row)."""
    from scipy.linalg import qr, solve_triangular
    R, piv = qr(A_sc.T, mode="r", pivoting=True)     # Q is not needed
    diag = np.abs(np.diag(R))
    if diag.size:
        tol_r = max(A_sc.shape) * np.finfo(float).eps * diag[0]
        rank = int((diag > tol_r).sum())
    else:
        rank = 0
    if rank == A_sc.shape[0]:
        return np.arange(rank)
    # A_sc^T[:, piv] = Q [R11 R12; 0 R22] with R22 negligible: each dropped
    # row is the kept rows' combination W = R11^-1 R12, which is also the
    # least-squares fit of the dropped rows by the kept ones (the part R22
    # that it leaves is orthogonal to them)
    W = solve_triangular(R[:rank, :rank], R[:rank, rank:])
    b_pred = W.T @ b_sc[piv[:rank]]
    bscale = 1.0 + np.abs(b_sc).max(initial=0.0)
    if np.abs(b_pred - b_sc[piv[rank:]]).max(initial=0.0) > 1e-7 * bscale:
        return None
    return np.sort(piv[:rank])
