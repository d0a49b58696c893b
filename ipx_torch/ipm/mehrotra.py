"""Mehrotra predictor-corrector step on a batch of LPs.

Every function takes tensors with a leading batch dimension B (a single
solve is a batch of one); per-instance scalars are (B,).  Per-instance
convergence is a masked state freeze (``step_masked``), so lanes that have
finished ride along unchanged until the slowest one is done.

Algorithm (Mehrotra 1992; Nocedal & Wright ch. 14):
  predictor:  solve with r_xs = X S e           -> affine direction
  centering:  sigma = (mu_aff / mu) ** 3
  corrector:  solve with r_xs = X S e + dX_a dS_a e - sigma mu e  (factor reused)
  step:       damped fraction-to-boundary ratio tests.
"""
from __future__ import annotations

import contextvars
import dataclasses

import torch

from ipx_torch.ipm.state import IPMState, init_state, select_lanes
from ipx_torch.kernels import fused as fk
from ipx_torch.linsys import augmented, normal_eq, products, schur
from ipx_torch.numerics import inf_norm, lane_sum, vdot
from ipx_torch.options import SolverOptions
from ipx_torch.problem.lp import LP
from ipx_torch.status import Status


# A dict into which each step puts its named values (``obs.debug_mode``,
# ``obs.checked_solve``, read by ``batched.run_batch``), or None, the
# default: nothing is kept.
STEP_VALUES: contextvars.ContextVar = contextvars.ContextVar(
    "ipx_torch_step_values", default=None)


def _factor_diagonal(fac) -> torch.Tensor:
    """(B, k): the diagonal of a step's factor on any route, whole on every
    rank (on the sharded route the diagonals of W, the inverses of L's
    diagonal blocks, which every rank holds)."""
    if isinstance(fac, augmented.AugSchurFactor):
        return _factor_diagonal(fac.ne)
    if isinstance(fac, augmented.AugFactor):
        return torch.diagonal(fac.lu, dim1=-2, dim2=-1)
    if isinstance(fac, schur.SchurFactor):
        return torch.diagonal(fac.W, dim1=-2, dim2=-1).flatten(1)
    if fac.LT is not None:
        return torch.diagonal(fac.LT, dim1=-2, dim2=-1)
    if fac.LTp:
        return torch.cat([torch.diagonal(p[:, :, :p.shape[1]], dim1=-2,
                                         dim2=-1) for p in fac.LTp], dim=-1)
    return torch.diagonal(fac.L, dim1=-2, dim2=-1)


def _col(a: torch.Tensor) -> torch.Tensor:
    """(B,) per-lane scalar -> (B, 1), to scale a (B, k) vector."""
    return a.unsqueeze(-1)


def feas_tolerance(opts: SolverOptions, dtype: torch.dtype) -> float:
    """The feasibility tolerance of the convergence test: ``tol_feas``,
    floored at the dtype's representation limit (an exactly feasible x
    rounded to the working precision shows a residual at the matvec
    rounding floor, ~ c*eps for normalized data)."""
    return max(opts.tol_feas, opts.feas_eps_mult * torch.finfo(dtype).eps)


def max_step(v: torch.Tensor, dv: torch.Tensor) -> torch.Tensor:
    """Fraction-to-boundary ratio test per lane: min over dv<0 of -v/dv
    (else +inf)."""
    neg = dv < 0
    ratios = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                         torch.full_like(v, float("inf")))
    return ratios.amin(dim=-1)


def starting_point(lp: LP, opts: SolverOptions):
    """Mehrotra least-squares starting point.

    Uses the normal-equations machinery with D^2 = I.  Returns the AA^T
    factor as well: it is loop-invariant and reused every iteration to
    project the search direction back onto A dx = -rp.
    """
    A, b, c = lp.A, lp.b, lp.c
    fac = normal_eq.factor(A, torch.ones_like(c), opts)
    fwd, tr = normal_eq.matvecs(A, opts)
    x = tr(normal_eq.solve(fac, A, b, opts))
    y = normal_eq.solve(fac, A, fwd(c), opts)
    s = c - tr(y)

    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    dx = torch.maximum(-1.5 * x.amin(dim=-1), zero)
    ds = torch.maximum(-1.5 * s.amin(dim=-1), zero)
    x = x + _col(dx)
    s = s + _col(ds)
    xs = vdot(x, s)
    # Degenerate fallback (xs <= 0 can only happen for pathological data):
    bad = _col(~(xs > 0))
    x_new = torch.where(bad, torch.ones_like(x),
                        x + _col(0.5 * xs / s.sum(dim=-1)))
    s_new = torch.where(bad, torch.ones_like(s),
                        s + _col(0.5 * xs / x_new.sum(dim=-1)))
    return x_new, y, s_new, fac


def _scalars(lp: LP, x, y, s, opts: SolverOptions):
    """Residuals, duality measure, relative gap, per lane.

    The gap criterion is the COMPLEMENTARITY gap x@s/(1+|c@x|), not the
    objective gap |c@x - b@y|: x@s is a sum of positives (no cancellation),
    so f32 can measure it down to eps*mu, whereas c@x - b@y has an absolute
    noise floor of ~eps*|c@x| that would make a 1e-6 relative-gap
    certificate unreliable.  The two coincide to second order once
    rp, rd <= tol_feas.
    """
    n = lp.n
    if products.use_fused_matvec(opts, lp.A):
        # A@x and A^T y are an independent pair: one A stream
        ax, aty = fk.ata_apply(lp.A, y, None, x)
        rp = ax - lp.b
        rd = aty + s - lp.c
    else:
        fwd, tr = normal_eq.matvecs(lp.A, opts)
        rp = fwd(x) - lp.b
        rd = tr(y) + s - lp.c
    mu = vdot(x, s) / n
    pobj = vdot(lp.c, x)
    rp_rel = inf_norm(rp) / (1 + inf_norm(lp.b))
    rd_rel = inf_norm(rd) / (1 + inf_norm(lp.c))
    rel_gap = (mu * n) / (1 + pobj.abs())
    return rp, rd, mu, rp_rel, rd_rel, rel_gap, pobj


def refresh_residuals(lp: LP, state: IPMState, opts: SolverOptions
                      ) -> IPMState:
    """Fill the carried residual fields (rp, rd, mu) from the iterate.

    The step reads residuals from the state instead of streaming A again at
    entry: the previous step's exit already measured them on the same
    iterate.  Every run entry point calls this once outside the loop."""
    rp, rd, mu, *_ = _scalars(lp, state.x, state.y, state.s, opts)
    return dataclasses.replace(state, rp=rp, rd=rd, mu=mu)


def mehrotra_step(lp: LP, state: IPMState, opts: SolverOptions,
                  fac_aat=None, fac=None) -> IPMState:
    """One predictor-corrector iteration for every lane (no masking).

    ``fac_aat`` is the loop-invariant Cholesky factor of A A^T (from the
    starting point); when given, each direction is projected back onto the
    null-space condition A dx = -rp, canceling the f32 feasibility drift
    that the ill-conditioned D^2 injects near convergence.

    ``fac`` injects a precomputed normal-equations factor (the
    ``refactor_period`` lever): the step then skips its own factorization
    and uses the given, possibly stale, factor as the CG preconditioner.
    Its ``d2`` is replaced with this iterate's, so the matrix-free operator
    and every refinement residual target the current system; only the
    preconditioner lags.
    """
    A = lp.A
    x, y, s = state.x, state.y, state.s
    dtype = x.dtype
    n = lp.n
    fuse = products.use_fused_matvec(opts, A)

    # Residuals are CARRIED: the previous step's exit measured them on this
    # exact iterate (refresh_residuals seeds the first iteration).
    rp, rd, mu = state.rp, state.rd, state.mu
    mu_safe = torch.clamp(mu, min=1e-30)

    # The projection is a normal-equations fix: the augmented routes (and
    # "sharded_schur", the Schur form across ranks) satisfy the primal row
    # directly, and projecting through the AA^T factor puts back the
    # squared conditioning they exist to avoid (in ipx it flips degenerate
    # lanes from OPTIMAL to STALLED).
    do_project = (opts.project_feasibility
                  and not opts.linsys.startswith("augmented")
                  and opts.linsys != "sharded_schur")

    # --- factor A D^2 A^T once, reuse for both solves ------------------------
    # d2 is deliberately NOT range-clipped: huge x/s entries are tamed by
    # the Jacobi scaling inside factor(), and clipping them makes those dual
    # directions spuriously mobile.  f32 PSD loss near convergence is handled
    # by the cross-iteration regularization escalation (state.reg_boost).
    d2 = x / s
    if fac is None:
        fac = normal_eq.factor(A, d2, opts, reg_scale=state.reg_boost)
    else:
        fac = dataclasses.replace(fac, d2=d2)

    # Options for the normal-eq solves INSIDE refinement sweeps: the sweep
    # rhs is an already-small KKT residual, so a cheaper solve perturbs the
    # correction only at second order.  -1 keeps the main solve's CG count.
    ref_opts = (opts if opts.refine_solve_cg < 0
                else opts.replace(refine_steps=opts.refine_solve_cg))

    a_mv, at_mv = normal_eq.matvecs(A, opts)

    def newton_direction(e_p, e_d, e_xs, sopts=opts):
        """Solve  A dx = -e_p;  A^T dy + ds = -e_d;  S dx + X ds = -e_xs
        via the normal equations, or the augmented system on its routes."""
        if opts.linsys == "augmented":
            return augmented.solve_newton(fac, A, x, s, e_p, e_d, e_xs, opts)
        if opts.linsys in ("augmented_schur", "sharded_schur"):
            return augmented.solve_newton_schur(fac, A, x, s, e_p, e_d, e_xs,
                                                opts)
        rhs = -e_p - a_mv(d2 * e_d - e_xs / s)
        dy = normal_eq.solve(fac, A, rhs, sopts)
        ds = -e_d - at_mv(dy)
        dx = -(e_xs / s) - d2 * ds
        return dx, dy, ds

    def kkt_solve_plain(r_xs, refines, project):
        """Newton direction + full-KKT iterative refinement.

        The normal-equations route satisfies the complementarity row exactly
        but A dx = -rp only to working accuracy, and the error is amplified
        by D^2 ~ 1/mu near convergence.  Refinement re-solves the SAME
        factored system with the measured KKT residuals as rhs.
        """
        dx, dy, ds = newton_direction(rp, rd, r_xs)
        for _ in range(refines):
            e_p = rp + a_mv(dx)
            e_d = rd + at_mv(dy) + ds
            e_xs = r_xs + s * dx + x * ds
            ddx, ddy, dds = newton_direction(e_p, e_d, e_xs, sopts=ref_opts)
            dx, dy, ds = dx + ddx, dy + ddy, dds + ds
        if fac_aat is not None and project:
            # cond(AA^T) is mu-independent, so this pins the primal row at
            # fixed accuracy for the whole run
            e_p = rp + a_mv(dx)
            proj_opts = opts.replace(refine_steps=opts.proj_cg_iters)
            dx = dx - at_mv(normal_eq.solve(fac_aat, A, e_p, proj_opts))
        return dx, dy, ds

    def kkt_solve_fused(r_xs, refines, project):
        """Stream-fused version of ``kkt_solve_plain``: identical refinement
        algebra, but each sweep's THREE A streams (e_p, e_d, rhs) collapse
        into one ``ata_apply`` call, and the final sweep's ``ds`` update
        shares a stream with the projection's ``e_p``.  The
        cancellation-sensitive elementwise residuals (e_d, e_xs) are
        computed OUTSIDE the kernel in the same order as the plain form.
        """
        do_proj = fac_aat is not None and project
        rhs = -rp - fk.a_matvec(A, d2 * rd - r_xs / s)
        dy = normal_eq.solve(fac, A, rhs, opts)
        if refines == 0 and do_proj:
            # fold ds/dx construction with the projection's e_p stream:
            # y = A @ (d2 (A^T dy + rd) - r_xs/s) = A @ dx_new
            yv, t = fk.ata_apply(A, dy, d2, -(r_xs / s), beta=rd)
            ds = -rd - t
            dx = -(r_xs / s) - d2 * ds
            e_p = rp + yv
        else:
            ds = -rd - fk.at_matvec(A, dy)
            dx = -(r_xs / s) - d2 * ds
            for k in range(refines):
                last = k == refines - 1
                e_xs = r_xs + s * dx + x * ds
                # beta carries the cancellation-critical residual sum:
                # w = d2 * ((A^T dy) + (rd + ds)) + wn = d2 * e_d + wn,
                # with e_d's near-total cancellation done BEFORE the d2
                # scaling
                beta = rd + ds
                yv, t = fk.ata_apply(A, dy, d2, dx - e_xs / s, beta=beta)
                # e_d MUST reproduce the kernel's fl(t + beta) bit for bit:
                # the rhs the kernel built and the dds update below must
                # see the SAME rounded e_d, else the ~eps discrepancy is
                # amplified by d2 * dds
                e_d = t + beta
                ddy = normal_eq.solve(fac, A, -rp - yv, ref_opts)
                if last and do_proj:
                    # one stream: A @ dx_new and A^T ddy together
                    y2, t2 = fk.ata_apply(A, ddy, d2, dx - e_xs / s,
                                          beta=e_d)
                    dds = -e_d - t2
                    e_p = rp + y2
                else:
                    dds = -e_d - fk.at_matvec(A, ddy)
                ddx = -(e_xs / s) - d2 * dds
                dx, dy, ds = dx + ddx, dy + ddy, ds + dds
        if do_proj:
            proj_opts = opts.replace(refine_steps=opts.proj_cg_iters)
            dx = dx - fk.at_matvec(
                A, normal_eq.solve(fac_aat, A, e_p, proj_opts))
        return dx, dy, ds

    kkt_solve = kkt_solve_fused if fuse else kkt_solve_plain

    # --- predictor -----------------------------------------------------------
    dx_a, dy_a, ds_a = kkt_solve(x * s, opts.predictor_refine_steps,
                                 project=do_project)
    one = torch.ones((), dtype=dtype, device=x.device)
    ap_a = torch.minimum(one, max_step(x, dx_a))
    ad_a = torch.minimum(one, max_step(s, ds_a))
    mu_aff = vdot(x + _col(ap_a) * dx_a, s + _col(ad_a) * ds_a) / n

    # --- centering -----------------------------------------------------------
    ratio = torch.clamp(mu_aff / mu_safe, 0.0, 1.0)
    sigma = ratio ** opts.sigma_power

    # --- corrector, factor reused --------------------------------------------
    dx, dy, ds = kkt_solve(x * s + dx_a * ds_a - _col(sigma * mu),
                           opts.kkt_refine_steps, project=do_project)

    # --- Gondzio multiple centrality correctors (optional) -------------------
    # Each corrector reuses the factorization: push the trial point's
    # outlier complementarity products x_j s_j back toward the central path
    # [0.1 mu, 10 mu], accept the corrected direction only where it
    # lengthens the step (per-lane select).
    for _ in range(opts.gondzio_correctors):
        a_p = torch.minimum(one, max_step(x, dx))
        a_d = torch.minimum(one, max_step(s, ds))
        a_pt = torch.minimum(one, a_p + 0.1)
        a_dt = torch.minimum(one, a_d + 0.1)
        x_t = x + _col(a_pt) * dx
        s_t = s + _col(a_dt) * ds
        v = x_t * s_t
        mu_t = vdot(x_t, s_t) / n
        r_xs = v - torch.clamp(v, min=_col(0.1 * mu_t), max=_col(10.0 * mu_t))
        ddx, ddy, dds = newton_direction(
            torch.zeros_like(rp), torch.zeros_like(rd), r_xs)
        # refine the correction itself (one sweep): the unrefined
        # correction degrades the refined+projected base direction in f32
        if fuse:
            e_p2, t_g = fk.ata_apply(A, ddy, None, ddx)  # A@ddx, A^T ddy
            e_d2 = t_g + dds
        else:
            e_p2 = a_mv(ddx)
            e_d2 = at_mv(ddy) + dds
        e_xs2 = r_xs + s * ddx + x * dds
        d3x, d3y, d3s = newton_direction(e_p2, e_d2, e_xs2)
        ddx, ddy, dds = ddx + d3x, ddy + d3y, dds + d3s
        dx_c, dy_c, ds_c = dx + ddx, dy + ddy, ds + dds
        a_p_c = torch.minimum(one, max_step(x, dx_c))
        a_d_c = torch.minimum(one, max_step(s, ds_c))
        # accept only a MATERIAL step gain (margin 0.01) and only OUTSIDE
        # the endgame (mu still > 1e-4 mu0)
        endgame = mu < 1e-4 * state.mu0
        better_c = _col((~endgame) & ((a_p_c + a_d_c) > (a_p + a_d + 0.01)))
        dx = torch.where(better_c, dx_c, dx)
        dy = torch.where(better_c, dy_c, dy)
        ds = torch.where(better_c, ds_c, ds)

    # --- damped steps --------------------------------------------------------
    if opts.adaptive_damping:
        eta = torch.clamp(one - mu, opts.damping_floor, opts.alpha_damping)
    else:
        eta = torch.full_like(mu, opts.damping_floor)
    alpha_p = torch.minimum(one, eta * max_step(x, dx))
    alpha_d = torch.minimum(one, eta * max_step(s, ds))

    # Centrality backoff (N_-inf neighborhood): a full Mehrotra step can
    # crash an individual product x_j s_j orders of magnitude below mu.  In
    # f32 the resulting d2 = x/s spread breaks the normal-matrix
    # factorization well before convergence.  Guard: scan alpha backoff
    # factors 1, 1/2, 1/4, ... and take the largest whose post-step
    # min(x_j s_j) >= gamma * mu; elementwise work, no extra solves.
    if opts.backoff_candidates > 0:
        K = opts.backoff_candidates
        scales = (0.5 ** torch.arange(K, device=x.device)).to(dtype)
        sc = scales.reshape(1, K, 1)
        xs_all = ((x.unsqueeze(1) + sc * alpha_p.reshape(-1, 1, 1)
                   * dx.unsqueeze(1))
                  * (s.unsqueeze(1) + sc * alpha_d.reshape(-1, 1, 1)
                     * ds.unsqueeze(1)))                         # (B, K, n)
        mu_all = lane_sum(xs_all) / n
        ok = xs_all.amin(dim=2) >= opts.neighborhood_gamma * mu_all
        # first True per lane (argmax of a 0/1 tensor returns the first
        # maximal index); K - 1 where none holds
        first = torch.argmax(ok.to(torch.int8), dim=1)
        idx = torch.where(ok.any(dim=1), first, torch.full_like(first, K - 1))
        backoff = scales[idx]
        alpha_p = alpha_p * backoff
        alpha_d = alpha_d * backoff

    x_new = torch.clamp(x + _col(alpha_p) * dx, min=opts.pos_floor)
    y_new = y + _col(alpha_d) * dy
    s_new = torch.clamp(s + _col(alpha_d) * ds, min=opts.pos_floor)
    kept = STEP_VALUES.get()
    if kept is not None:
        # in the order they are made; the iterate before the recovery
        # below puts back the last good one
        kept.update(factor_diagonal=_factor_diagonal(fac), dx=dx, dy=dy,
                    ds=ds, alpha_p=alpha_p, alpha_d=alpha_d, x=x_new,
                    y=y_new, s=s_new)

    # --- convergence / failure bookkeeping -----------------------------------
    rp_n, rd_n, mu_n, rp_rel, rd_rel, rel_gap, pobj = _scalars(
        lp, x_new, y_new, s_new, opts)

    finite = (torch.isfinite(x_new).all(-1) & torch.isfinite(y_new).all(-1)
              & torch.isfinite(s_new).all(-1) & torch.isfinite(rel_gap)
              & fac.ok)
    tol_feas = feas_tolerance(opts, dtype)
    converged = ((rel_gap <= opts.tol) & (rp_rel <= tol_feas)
                 & (rd_rel <= tol_feas))
    # mu floor: below this, f32 conditioning degrades instead of improving.
    stalled = mu_n < opts.mu_floor_rel * state.mu0
    # Windowed progress stall: compare against mu from `stall_window`
    # iterations ago, read per lane from the trace (frozen lanes keep an
    # older `it`, so this is a gather on each lane's own counter).
    K = opts.stall_window
    lanes = torch.arange(x.shape[0], device=x.device)
    it = state.it.long()
    if K > 0:
        mu_old = state.trace[lanes, torch.clamp(it - K, min=0), 0]
        no_progress = (state.it >= K) & (mu_n > 0.5 * mu_old)
        if opts.stall_gap_guard > 0:
            # Endgame patience: a near-converged crawl must run toward
            # max_iter; within the guard band the test loosens from
            # "halved over the window" to "shrank >= 2% over the window".
            near = rel_gap <= opts.stall_gap_guard * opts.tol
            crawl_stuck = (state.it >= K) & (mu_n > 0.98 * mu_old)
            no_progress = torch.where(near, crawl_stuck, no_progress)
        stalled = stalled | no_progress
    # Non-finite step (f32 PSD loss in the endgame): keep the previous
    # iterate, escalate the Tikhonov regularization, and keep RUNNING; the
    # next factor uses reg * reg_boost.  Only when the boost is exhausted
    # does the lane report NUMERICAL_FAILURE.
    boost_cap = opts.reg_boost_cap
    exhausted = ~finite & (state.reg_boost >= boost_cap)
    # Every failure raises the decay floor to 10x the boost that just
    # FAILED, so a decaying boost never revisits a level the problem has
    # already broken at.  The boost decays by reg_boost_decay on the sharded
    # routes (a sticky boost there left large solves crawling) and by
    # reg_boost_decay_dense (1.0 = sticky) elsewhere, where for degenerate
    # LPs it acts as a needed proximal term.
    decay = (opts.reg_boost_decay if opts.linsys.startswith("sharded")
             else opts.reg_boost_decay_dense)
    reg_floor = torch.where(
        finite, state.reg_floor,
        torch.clamp(torch.maximum(state.reg_floor, state.reg_boost * 10.0),
                    max=boost_cap))
    reg_boost = torch.where(
        finite,
        torch.maximum(reg_floor, state.reg_boost * decay),
        torch.clamp(state.reg_boost * opts.reg_boost_step, max=boost_cap))
    # Divergence-based infeasibility certificates (heuristic).  Primal
    # infeasible: y diverges along a Farkas ray (b@y > 0, rd bounded).
    # Dual infeasible: x diverges along a recession ray.  Residuals are
    # scaled by the diverging iterate's norm.
    thresh = opts.infeas_diverge_thresh
    ctol = 1e-4
    ynorm = inf_norm(y_new)
    xnorm = inf_norm(x_new)
    by = vdot(lp.b, y_new)
    cx = vdot(lp.c, x_new)
    one_b = 1 + inf_norm(lp.b)
    one_c = 1 + inf_norm(lp.c)
    primal_infeas = ((ynorm > thresh) & (by > ctol * ynorm * one_b)
                     & (rd_rel * one_c <= ctol * ynorm))
    dual_infeas = ((xnorm > thresh) & (cx < -ctol * xnorm * one_c)
                   & (rp_rel * one_b <= ctol * xnorm))

    def code(st: Status) -> torch.Tensor:
        return torch.full_like(state.status, int(st))

    status = torch.where(
        exhausted, code(Status.NUMERICAL_FAILURE),
        torch.where(finite & converged, code(Status.OPTIMAL),
        torch.where(finite & primal_infeas, code(Status.PRIMAL_INFEASIBLE),
        torch.where(finite & dual_infeas, code(Status.DUAL_INFEASIBLE),
        torch.where(finite & stalled, code(Status.STALLED),
                    code(Status.RUNNING))))))

    # On numerical failure keep the last good iterate.
    keep = finite
    kc = _col(keep)
    x_new = torch.where(kc, x_new, x)
    y_new = torch.where(kc, y_new, y)
    s_new = torch.where(kc, s_new, s)

    # Best-iterate tracking: merit normalizes each criterion by its tolerance
    # so "best" agrees with the convergence test (merit <= 1 iff converged).
    merit = torch.maximum(rel_gap / opts.tol,
                          torch.maximum(rp_rel, rd_rel) / tol_feas)
    better = keep & (merit < state.best_merit)
    bc = _col(better)
    best_x = torch.where(bc, x_new, state.best_x)
    best_y = torch.where(bc, y_new, state.best_y)
    best_s = torch.where(bc, s_new, state.best_s)
    best_merit = torch.where(better, merit, state.best_merit)

    # trace row at each lane's own `it` (clamped like a dynamic update slice,
    # so an unmasked step past the cap rewrites the last row)
    row = torch.stack([mu_n, rp_rel, rd_rel, rel_gap,
                       alpha_p, alpha_d, sigma, pobj], dim=-1).to(dtype)
    trace = state.trace.clone()
    trace[lanes, torch.clamp(it, max=trace.shape[1] - 1)] = row

    return IPMState(
        x=x_new, y=y_new, s=s_new,
        it=state.it + 1, status=status,
        mu=torch.where(keep, mu_n, state.mu), mu0=state.mu0,
        rp_rel=torch.where(keep, rp_rel, state.rp_rel),
        rd_rel=torch.where(keep, rd_rel, state.rd_rel),
        rel_gap=torch.where(keep, rel_gap, state.rel_gap),
        best_x=best_x, best_y=best_y, best_s=best_s, best_merit=best_merit,
        reg_boost=reg_boost, reg_floor=reg_floor,
        trace=trace,
        # carried residuals follow the same keep-select as the iterate
        rp=torch.where(kc, rp_n, state.rp),
        rd=torch.where(kc, rd_n, state.rd),
    )


def step_masked(lp: LP, state: IPMState, opts: SolverOptions,
                fac_aat=None, fac=None) -> IPMState:
    """Step only lanes that are RUNNING and under the iteration cap; the
    others keep their state.  The explicit ``it < max_iter`` guard keeps any
    lane from overshooting the cap while OTHER lanes (or the trailing steps
    of a ``refactor_period`` block) keep the loop alive."""
    new = mehrotra_step(lp, state, opts, fac_aat, fac)
    active = ((state.status == int(Status.RUNNING))
              & (state.it < opts.max_iter))
    return select_lanes(active, new, state)


def step_masked_stale(lp: LP, state: IPMState, opts: SolverOptions,
                      fac_aat, fac, boost0: torch.Tensor) -> IPMState:
    """A trailing stale step of a ``refactor_period`` block.

    On top of :func:`step_masked`'s freeze, a lane is skipped once its
    ``reg_boost`` has risen above ``boost0``, the level the block's factor
    was built with.  The boost rises only on a non-finite step, so a lane
    skipped here already failed in this block: its remaining stale steps
    would revert to the same iterate and fail the same way, raising the
    boost toward the cap without a fresh factor ever testing it.  The next
    block's fresh factor uses the escalated reg."""
    new = mehrotra_step(lp, state, opts, fac_aat, fac)
    active = ((state.status == int(Status.RUNNING))
              & (state.it < opts.max_iter)
              & (state.reg_boost <= boost0))
    return select_lanes(active, new, state)


def warm_start_state(lp: LP, x, y, s, opts: SolverOptions) -> IPMState:
    """An initial state from a previous, related solution, per lane.

    A converged point is badly centered for a new run (complementarity
    products near 0), so both x and s are shifted off their bounds by
    sqrt(mu_seed), mu_seed = max(x@s/n, warm_start_mu): the first
    iterations re-center instead of stalling on zero ratio tests (the
    warm-start recipe of Gondzio & Grothey, Skajaa et al.)."""
    dtype = lp.c.dtype
    x, y, s = (torch.as_tensor(v, dtype=dtype, device=lp.c.device)
               for v in (x, y, s))
    mu_seed = torch.clamp(vdot(x, s) / lp.n, min=opts.warm_start_mu)
    shift = _col(torch.sqrt(mu_seed))
    x = torch.maximum(x, shift)
    s = torch.maximum(s, shift)
    return init_state(x, y, s, vdot(x, s) / lp.n, opts.max_iter)


def finalize_status(state: IPMState, opts: SolverOptions) -> IPMState:
    """RUNNING after the loop means the iteration cap was hit."""
    hit_cap = ((state.status == int(Status.RUNNING))
               & (state.it >= opts.max_iter))
    status = torch.where(hit_cap,
                         torch.full_like(state.status, int(Status.MAX_ITER)),
                         state.status)
    return dataclasses.replace(state, status=status)
