"""Public API: solve / solve_batch / solve_general / solve_mps /
solve_many / solve_large -> Solution."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ipx_torch import obs
from ipx_torch.ipm import batched, mehrotra
from ipx_torch.ipm.state import (IPMState, put_lanes, select_lanes,
                                 take_lanes)
from ipx_torch.linsys import products, schur
from ipx_torch.numerics import dtype_of, inf_norm
from ipx_torch.options import DEFAULT_OPTIONS, SolverOptions, check_ported
from ipx_torch.problem.batching import bucket_lps
from ipx_torch.problem.lp import LP, GeneralLP, make_lp, to_standard_form
from ipx_torch.problem.mps import read_mps
from ipx_torch.problem.presolve import presolve as _presolve
from ipx_torch.status import STATUS_NAMES, Status


@dataclass
class Solution:
    """Host-side solve result (original problem units).

    For :func:`solve_general` / :func:`solve_mps`: ``y`` holds the duals of
    the original rows, equality duals first then inequality duals
    (``m_eq + m_ub`` entries, scipy sign convention: <=-row marginals are
    <= 0 at optimality of a minimize problem); ``s = c - A_eq^T y_eq -
    A_ub^T y_ub`` are reduced costs over the original variables; for
    maximize problems all duals are reported in maximize sense.

    ``rel_gap``, ``rp_rel`` and ``rd_rel`` are measured in float64 from the
    returned answer: in the user's units (the standard form's for
    :func:`solve_general`) after presolve, of the solver's iterate on the
    device path.
    """

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
    trace: np.ndarray   # (max_iter, 8): mu, rp, rd, gap, a_p, a_d, sigma, pobj

    @property
    def status_name(self) -> str:
        return STATUS_NAMES.get(self.status, str(self.status))

    @property
    def optimal(self) -> bool:
        return self.status == int(Status.OPTIMAL)

    def iteration_table(self) -> str:
        """Classic IPM iteration log rendered from the trace."""
        lines = ["iter        mu     rp_rel     rd_rel    rel_gap  alpha_p  alpha_d    sigma"]
        for i in range(min(self.iterations, len(self.trace))):
            mu, rp, rd, gap, ap, ad, sg, _ = self.trace[i]
            if mu == 0.0 and rp == 0.0 and gap == 0.0:
                break
            lines.append(f"{i:4d}  {mu:9.2e}  {rp:9.2e}  {rd:9.2e}  "
                         f"{gap:9.2e}  {ap:7.4f}  {ad:7.4f}  {sg:7.4f}")
        return "\n".join(lines)


def _host64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").to(torch.float64).numpy()


def _solutions(lp: LP, st: IPMState, fwd, tr) -> list:
    """One Solution per lane, for every route.  The best-merit iterate
    visited is reported (equals the final iterate on a clean OPTIMAL exit;
    shields MAX_ITER / STALLED / failed exits from late f32 degradation),
    and its quality metrics are recomputed in f64.  The residuals are
    measured where A lives, for the whole batch at once: ``fwd`` (w -> A w)
    and ``tr`` (v -> A^T v) take and return float64, and their
    infinity-norms are reduced there; the dot products run on the host per
    lane.  Only the iterates, c, b and per-lane numbers cross to the host,
    once for the batch; A never does.  Spans: ``api.recheck``, around
    ``api.recheck.device`` (the products and norms, with CUDA events),
    ``api.recheck.to_host`` (the copies) and ``api.recheck.lanes`` (the
    Solutions built, spanned once); counter ``api.recheck.lanes_checked``."""
    f64 = torch.float64
    with obs.span("api.recheck"):
        obs.count("api.recheck.lanes_checked", st.it.shape[0])
        with obs.span("api.recheck.device", device=True):
            x, y, s = (t.to(f64) for t in (st.best_x, st.best_y, st.best_s))
            c, b = lp.c.to(f64), lp.b.to(f64)
            norms = torch.stack([inf_norm(fwd(x) - b),
                                 inf_norm(tr(y) + s - c),
                                 inf_norm(b), inf_norm(c)])
        with obs.span("api.recheck.to_host"):
            rp, rd, bmax, cmax = norms.to("cpu").numpy()
            X, Y, S = (_host64(st.best_x), _host64(st.best_y),
                       _host64(st.best_s))
            C, Bv = _host64(lp.c), _host64(lp.b)
            off = _host64(lp.obj_offset)
            status = st.status.to("cpu").numpy()
            its = st.it.to("cpu").numpy()
            trace = _host64(st.trace)
        with obs.span("api.recheck.lanes"):
            sols = []
            for i in range(X.shape[0]):
                x, y, s, c, b = X[i], Y[i], S[i], C[i], Bv[i]
                pobj = float(c @ x)
                sols.append(Solution(
                    x=x, y=y, s=s,
                    objective=pobj + float(off[i]),
                    dual_objective=float(b @ y) + float(off[i]),
                    status=int(status[i]), iterations=int(its[i]),
                    rel_gap=float((x @ s) / (1 + abs(pobj))),
                    rp_rel=float(rp[i] / (1 + bmax[i])),
                    rd_rel=float(rd[i] / (1 + cmax[i])), trace=trace[i]))
    return sols


def _states_to_solutions(lp: LP, st: IPMState) -> list:
    """The Solutions of the routes without a mesh (:func:`_solutions`),
    the products summed in float64 (``linsys.products``)."""
    A = lp.A.contiguous()       # rows 2 and 3 read A as stored, row-major
    return _solutions(lp, st, *products.pair(A, "f64"))


def _sharded_solutions(lp: LP, st: IPMState) -> list:
    """The Solutions of the sharded routes (:func:`_solutions`), one a lane,
    the same on every rank of a row group: the products are the ranks'
    (``schur.matvecs(wide=True)``: f64 sums through the all-reduce)."""
    return _solutions(lp, st, *schur.matvecs(lp.A, wide=True))


# the statuses the ladder rescues in both entry points, besides a near-miss
# MAX_ITER (see _rescue)
_RESCUE = (int(Status.STALLED), int(Status.NUMERICAL_FAILURE))


def _run_batch(lp: LP, opts: SolverOptions,
               state0: Optional[IPMState] = None) -> IPMState:
    """Every run of the entry points, stage 1 and each rung of the rescue
    ladder, goes through here."""
    return batched.run_batch(lp, opts, state0)


def _warm(lp: LP, st: IPMState, opts: SolverOptions) -> IPMState:
    """A rung's warm start: each lane's best iterate, re-centered."""
    return mehrotra.warm_start_state(lp, st.best_x, st.best_y, st.best_s,
                                     opts)


def _ladder(lp: LP, st: IPMState, opts: SolverOptions) -> IPMState:
    """The per-LP rescue ladder over every lane of ``lp``, ``st`` being
    their stage-1 states.

    Three rungs, each with ``refactor_period=1`` (a dense-route lever):
    the augmented LU warm-started from the stage-1 best iterate, the
    augmented LU cold (the warm seed can itself be too decentered), the
    Schur form warm-started from the stage-1 best iterate.  A lane leaves at
    the first rung that ends it OPTIMAL, with that rung's state and the
    iterations of stage 1 and of every rung it ran; a lane no rung fixes
    keeps its stage-1 state unchanged.  Each rung runs as one batch over the
    lanes still failing: the step masks keep lanes independent, and the
    lanes enter the rungs in the order ``ipx``'s loop over single LPs
    gives.  Reading which lanes a rung fixed is that rung's one host read
    beyond its loop's."""
    aug = opts.replace(linsys="augmented", refactor_period=1)
    asch = opts.replace(linsys="augmented_schur", refactor_period=1)
    out = st
    spent = st.it.clone()
    todo = torch.arange(st.it.shape[0], device=st.it.device)
    for name, rung, warm in (("aug_warm", aug, True), ("aug_cold", aug, False),
                             ("schur_warm", asch, True)):
        if todo.numel() == 0:
            break
        with obs.span("api.rung." + name):
            sub_lp = take_lanes(lp, todo)
            state0 = (_warm(sub_lp, take_lanes(st, todo), rung) if warm
                      else None)
            res = _run_batch(sub_lp, rung, state0)
            spent[todo] += res.it
            res = dataclasses.replace(res, it=spent[todo])
            fixed = res.status == int(Status.OPTIMAL)
            out = put_lanes(out, todo[fixed], take_lanes(res, fixed))
            todo = todo[~fixed]
    obs.count("api.rescue.lanes_fixed", st.it.shape[0] - todo.numel())
    return out


def _rescue(lp: LP, st: IPMState, opts: SolverOptions,
            in_batch: bool) -> IPMState:
    """The rescue of both entry points, on the dense route with
    ``augmented_fallback`` only.  It takes the lanes that ended STALLED or
    NUMERICAL_FAILURE, and a near-miss MAX_ITER: within ``stall_gap_guard
    * tol`` of the gap tolerance, where the guard loosened the stall test.
    A far MAX_ITER is the caller's iteration budget and stays as it is.
    (``ipx``'s ``solve_batch`` leaves a near-miss as it is too.)

    ``solve`` sends them to :func:`_ladder`.  ``solve_batch``
    (``in_batch``) first runs them in one batch: gathered into a
    sub-batch, warm-started from their best iterates, on
    ``augmented_schur``; a lane it ends OPTIMAL reports the iterations of
    stage 1 and of this rung.  The lanes it leaves go through the ladder
    from their stage-1 states, so their count leaves this rung out, as
    ``ipx``'s does.  Spans ``api.rescue`` and ``api.rung.schur_batch``;
    counters ``api.rescue.lanes_in``, ``api.rescue.near_miss_in`` and
    ``api.rescue.lanes_fixed``."""
    if not opts.augmented_fallback or opts.linsys != "dense":
        return st
    with obs.span("api.rescue"):
        near = st.status == int(Status.MAX_ITER)
        near = (near & (st.rel_gap <= opts.stall_gap_guard * opts.tol)
                if opts.stall_gap_guard > 0 else torch.zeros_like(near))
        failed = torch.isin(st.status, torch.tensor(
            _RESCUE, dtype=st.status.dtype, device=st.status.device))
        take, near = torch.stack([near | failed, near]).tolist()
        bad = [i for i, t in enumerate(take) if t]
        obs.count("api.rescue.lanes_in", len(bad))
        obs.count("api.rescue.near_miss_in", sum(near))
        if not bad:
            return st
        out, left = st, torch.tensor(bad, device=st.it.device)
        if in_batch:
            with obs.span("api.rung.schur_batch"):
                sub_lp, sub_st = take_lanes(lp, left), take_lanes(st, left)
                asch = opts.replace(linsys="augmented_schur",
                                    refactor_period=1)
                res = _run_batch(sub_lp, asch, _warm(sub_lp, sub_st, asch))
                res = dataclasses.replace(res, it=res.it + sub_st.it)
                fixed = res.status == int(Status.OPTIMAL)
                out = put_lanes(st, left[fixed], take_lanes(res, fixed))
                left = left[~fixed]
            obs.count("api.rescue.lanes_fixed", len(bad) - left.numel())
        if left.numel():
            out = put_lanes(out, left, _ladder(take_lanes(lp, left),
                                               take_lanes(st, left), opts))
        return out


def _prepare(lps, opts: SolverOptions, device, p: int = 1) -> LP:
    """The batched LP on ``device``: a bf16-stored A stays as stored (its
    values are exact in f32, and a round trip through f32 would cost a
    transient copy twice its size); the rest takes the compute dtype.  Each
    A holds n / p of its LP's n columns: p > 1 for a row-sharded share, and
    a column block given as a whole A is refused (a dense route would solve
    another LP).  Span ``api.prepare``."""
    with obs.span("api.prepare"):
        check_ported(opts)
        if isinstance(lps, LP):
            blp = lps
            if blp.A.ndim != 3:
                raise ValueError("batched LP must have A of rank 3 (B, m, n)")
        else:
            blp = batched.stack_lps(lps)
        n = blp.c.shape[-1]
        if blp.A.shape[-1] * p != n:
            raise ValueError(
                f"A holds {blp.A.shape[-1]} columns of an LP with n={n}: "
                + ("a column block (a row-sharded share) is solved with its "
                   "mesh, solve_batch(share, mesh=mesh)" if p == 1 else
                   f"a share of a mesh with {p} row shards holds n/{p}"))
        blp = blp.to(device)
        dtype = dtype_of(opts.dtype)
        keep_a = blp.A.dtype == torch.bfloat16 and opts.a_storage == "bfloat16"
        return LP(c=blp.c.to(dtype), A=blp.A if keep_a else blp.A.to(dtype),
                  b=blp.b.to(dtype), obj_offset=blp.obj_offset.to(dtype))


@obs.entry
def solve_batch(lps, options: Optional[SolverOptions] = None,
                device="cuda", *, mesh=None) -> list:
    """Solve a batch of same-shape LPs in one batched run on ``device``.

    ``lps`` is a sequence of single-instance :class:`LP` or an already
    batched LP (A of rank 3).  Returns one :class:`Solution` per instance,
    in input order.  With ``augmented_fallback`` (the default) on the dense
    route, lanes that end STALLED or NUMERICAL_FAILURE, or MAX_ITER within
    ``stall_gap_guard * tol`` of the gap tolerance, are rescued
    (:func:`_rescue`).

    With a ``mesh`` whose "row" axis has p > 1 (config 5), ``lps`` is this
    rank's ``mesh.batch_lp_sharding`` share: its lanes, each A's column
    block.  The lanes run together on the sharded Schur route (``"sharded"``
    unless ``"sharded_schur"`` is asked for), the normal equations across
    the row group's ranks, and a STALLED, MAX_ITER or NUMERICAL_FAILURE
    lane gets :func:`solve_large`'s endgame (:func:`_sharded_endgame`).
    Every rank of a row group returns the same Solutions of its lanes; the
    caller gathers them over the "batch" group.  At p = 1 the mesh plays a part
    only when a sharded ``linsys`` is asked for (the same route in one
    process); without a mesh a sharded route raises, as it needs one.
    """
    opts = options or DEFAULT_OPTIONS
    if mesh is not None:
        from ipx_torch import mesh as meshlib
        p = mesh.shape[meshlib.ROW_AXIS]
        if p > 1 or opts.linsys.startswith("sharded"):
            return _solve_row_sharded(lps, opts, device, mesh, p)
    blp = _prepare(lps, opts, device)
    # run_batch applies a_storage itself; the reported metrics are taken
    # against the instance as given, as in ``ipx``
    st = _rescue(blp, _run_batch(blp, opts), opts, in_batch=True)
    return _states_to_solutions(blp, st)


def _sharded_route(opts: SolverOptions) -> SolverOptions:
    """The options of the sharded Schur route: ``"sharded"`` unless
    ``"sharded_schur"`` is asked for."""
    if opts.linsys not in ("sharded", "sharded_schur"):
        opts = opts.replace(linsys="sharded")
    check_ported(opts)
    return opts


def _solve_row_sharded(lps, opts: SolverOptions, device, mesh,
                       p: int) -> list:
    """:func:`solve_batch` of this rank's share on the sharded route of a
    mesh with p row shards (its column blocks made contiguous once: the
    products and the assembly read them every step)."""
    opts = _sharded_route(opts)
    blp = _prepare(lps, opts, device, p=p)
    blp = LP(c=blp.c, A=blp.A.contiguous(), b=blp.b,
             obj_offset=blp.obj_offset)
    if blp.m % p:
        raise ValueError(f"m={blp.m} is not divisible by the mesh's {p} row "
                         "shards")
    with schur.use_mesh(mesh):
        st = _sharded_endgame(blp, _run_batch(blp, opts), opts)
        return _sharded_solutions(blp, st)


@obs.entry
def solve(c, A=None, b=None, options: Optional[SolverOptions] = None,
          resume_from: Optional[str] = None,
          checkpoint_to: Optional[str] = None,
          presolve: bool = True,
          warm_start=None, device="cuda") -> Solution:
    """Solve one standard-form LP ``min c@x s.t. A@x=b, x>=0`` on
    ``device``, as a batch of one.

    Accepts ``solve(lp)`` with an :class:`LP` or ``solve(c, A, b)`` with
    array-likes.

    ``presolve=True`` (the default, like scipy.optimize.linprog) routes
    through the host-side presolve (reductions, dependent-row elimination,
    Ruiz equilibration) and postsolves back: raw real-world data needs the
    equilibration to reach 1e-6 in f32.  Its OPTIMAL answer holds in the
    user's units, as measured in float64 on the host from ``(x, y, s)``
    alone: x >= 0 and s >= 0 (s is ``c - A^T y`` cut at 0, the part cut
    away counted as dual infeasibility), ``rel_gap`` = x.s / (1 + |c.x|)
    <= ``tol``, and ``rp_rel`` = |A x - b|_inf / (1 + |b|_inf) and
    ``rd_rel`` = |A^T y + s - c|_inf / (1 + |c|_inf) within
    max(``tol_feas``, ``feas_eps_mult`` eps of the compute dtype); those
    three fields report that answer's own measures.  The reduced solve's
    answer is unscaled and polished (primal and dual) to get there, and
    continued once at a tighter gap tolerance where that falls short; an
    answer that still misses is STALLED (:func:`_solve_and_postsolve`).
    ``presolve=False`` keeps the pure device path for already-clean inputs
    (no host-side O(m^2 n) work).
    ``resume_from`` / ``checkpoint_to`` / ``warm_start`` always use the
    device path (their state lives in solver units).

    ``resume_from`` continues from an :func:`ipx_torch.obs.save_state`
    snapshot (one written by ``ipx`` too); ``checkpoint_to`` writes the
    final state there (chunked solving: cap ``max_iter``, checkpoint,
    resume).

    ``warm_start=(x, y, s)`` seeds the run from a previous, related
    solution, re-centered off the bounds (``mehrotra.warm_start_state``).
    As in ``ipx`` it skips presolve and the rescue ladder, as does
    ``resume_from``.
    """
    opts = options or DEFAULT_OPTIONS
    if (presolve and resume_from is None and checkpoint_to is None
            and warm_start is None):
        return _solve_presolved(c, A, b, opts, device)
    lp = c if isinstance(c, LP) else make_lp(c, A, b, device=device)
    blp = _prepare([lp], opts, device)
    if resume_from is not None:
        state0 = obs.resume_state(obs.load_state(resume_from, device),
                                  opts.max_iter)
        st = _run_batch(blp, opts, state0)
    elif warm_start is not None:
        x, y, s = (torch.as_tensor(v).reshape(1, -1) for v in warm_start)
        st = _run_batch(blp, opts,
                        mehrotra.warm_start_state(blp, x, y, s, opts))
    else:
        st = _rescue(blp, _run_batch(blp, opts), opts, in_batch=False)
    if checkpoint_to is not None:
        obs.save_state(checkpoint_to, st)
    return _states_to_solutions(blp, st)[0]


# the most rows an LP may have for the host-side float64 polishes (their
# least squares cost O(m^2 n) on the host)
POLISH_MAX_M = 8192


class _SupportLU:
    """Both polishes' corrections from one float64 LU of B = A[rows][:, S]
    on ``device``, ``rows`` the rows presolve kept.

    On the columns presolve kept, every row of A is a combination of the
    kept rows (a dropped row is zero there, a multiple of a kept row, or
    dependent on them).  So where B is square and nonsingular, as at the
    optimal basis of a non-degenerate LP, B dx = r[rows] gives the
    least-squares correction of A[:, S] dx = r, and B^T w = s_S with w
    zero off ``rows`` gives the same A^T w there as the minimum-norm one.
    The LU serves where B is square, ``info`` is 0 and its smallest pivot
    passes the polishes' rank cutoff, |rows| eps times the largest; a
    factor is kept while the support stays the same.  ``served`` counts
    the solves it gave."""

    def __init__(self, A: np.ndarray, rows: np.ndarray, device):
        self.A, self.rows, self.device = A, rows, device
        self.served = 0
        self._Ad = None
        self._S = None
        self._factor = None

    def solve(self, S: np.ndarray, rhs: np.ndarray, adjoint: bool = False):
        """dx on S with B dx = ``rhs[rows]`` (rhs over every row), or with
        ``adjoint`` w over every row, zero off ``rows``, with
        B^T w[rows] = ``rhs`` (rhs over S); None where the LU does not
        serve."""
        if self._S is None or not np.array_equal(S, self._S):
            self._S, self._factor = S, self._lu(S)
        if self._factor is None:
            return None
        lu, piv = self._factor
        if not adjoint:
            rhs = rhs[self.rows]
        z = torch.linalg.lu_solve(
            lu, piv, torch.as_tensor(rhs, device=lu.device)[:, None],
            adjoint=adjoint)
        self.served += 1
        if not adjoint:
            return _host64(z[:, 0])
        w = np.zeros(self.A.shape[0])
        w[self.rows] = _host64(z[:, 0])
        return w

    def _lu(self, S: np.ndarray):
        k = self.rows.size
        if int(S.sum()) != k:
            return None
        if self._Ad is None:
            # the user's A on the device once (a view of it on the CPU,
            # where it is contiguous); B is gathered there
            self._Ad = torch.as_tensor(np.ascontiguousarray(self.A),
                                       dtype=torch.float64,
                                       device=self.device)
        dev = self._Ad.device
        B = self._Ad[torch.as_tensor(self.rows, device=dev)][
            :, torch.as_tensor(np.flatnonzero(S), device=dev)]
        lu, piv, info = torch.linalg.lu_factor_ex(B)
        d = lu.diagonal().abs()
        ok = (info == 0) & (d.min() > k * np.finfo(np.float64).eps * d.max())
        return (lu, piv) if bool(ok) else None


def _primal_polish(A, b, x, s, c=None, support_mask=None, lu=None):
    """Host-side f64 primal polish (crossover-lite, SURVEY.md §7 hard
    part 1).

    The f32 IPM's primal residual floors near eps*sqrt(n)*|x|; on
    DEGENERATE instances with spread-out Ruiz scales the postsolved
    objective error is ~|y| * ||Ax-b||, which can sit 2-4x above the
    contract tolerance even when the rel-gap contract is met.  One f64
    least-squares correction restricted to the estimated support
    S = {x > s} (the complementarity partition) removes it: solve
    A_S dx = b - A x, leaving off-support zeros untouched so no clipping
    fights the projection.

    Returns the polished x only when it strictly improves ||Ax-b||_inf,
    keeps x >= 0, and moves the duality/complementarity gap by at most a
    negligible amount: the polish changes x@s by exactly s_S @ dx_S, which
    is ~0 for a CORRECT support (s_S ~ 0 by complementarity) and material
    precisely when the support estimate is wrong (degenerate x_j ~ s_j).
    ``support_mask`` excludes columns (e.g. presolve-fixed variables) from
    the support regardless of x/s.  Otherwise the input x.  The correction
    comes from ``lu`` (:class:`_SupportLU`) where it serves, else from a
    host least squares.  Skipped for m > ``POLISH_MAX_M`` (host lstsq
    cost)."""
    if A.shape[0] > POLISH_MAX_M:
        return x
    S = x > np.maximum(s, 0.0)
    if support_mask is not None:
        S = S & support_mask
    if not S.any():
        return x
    r = b - A @ x
    dxS = None if lu is None else lu.solve(S, r)
    if dxS is None:
        from scipy.linalg import lstsq
        AS = A[:, S]
        try:
            # the complete orthogonal factorization (pivoted QR), which
            # gives the SVD's minimum-norm answer at about half its cost;
            # numpy's rank cutoff
            dxS = lstsq(AS, r, cond=np.finfo(float).eps * max(AS.shape),
                        lapack_driver="gelsy")[0]
        except (np.linalg.LinAlgError, ValueError):
            return x
    xp = x.copy()
    xp[S] = xp[S] + dxS
    # tiny negatives from the correction are rounding; anything material
    # means the support estimate was wrong — reject
    if xp.min() < -1e-8 * (1.0 + float(np.abs(x).max())):
        return x
    xp = np.maximum(xp, 0.0)
    if not (np.abs(A @ xp - b).max(initial=0.0) < np.abs(r).max(initial=0.0)):
        return x
    # complementarity-change guard (see docstring): |s_S @ dx_S| is the
    # polish's exact x@s change; cap it at 1e-7 relative so an accepted
    # polish can never move the reported rel_gap materially against the
    # 1e-6 contract.  c only refines the normalization when available.
    gap_move = abs(float(s[S] @ dxS))
    denom = 1.0 + (abs(float(c @ x)) if c is not None else 0.0)
    if gap_move > 1e-7 * denom:
        return x
    return xp


def _empty_solution(x: np.ndarray, m: int, n_s: int, obj: float,
                    status: int) -> Solution:
    """The result of an LP that presolve settled alone: no iteration ran.
    OPTIMAL (every variable fixed) reports zero gap and residuals, the
    certificates infinite ones."""
    done = 0.0 if status == int(Status.OPTIMAL) else np.inf
    return Solution(x=x, y=np.zeros(m), s=np.zeros(n_s), objective=obj,
                    dual_objective=obj, status=status, iterations=0,
                    rel_gap=done, rp_rel=done, rd_rel=done,
                    trace=np.zeros((0, 8)))


_PRESOLVE_STATUS = {"infeasible": int(Status.PRIMAL_INFEASIBLE),
                    "unbounded": int(Status.DUAL_INFEASIBLE),
                    "ok": int(Status.OPTIMAL)}


def _solve_reduced(pres, opts: SolverOptions, device):
    """The presolved, scaled LP on ``device`` as a batch of one, with the
    ladder: the batched LP and its final state, in solver units."""
    lp = make_lp(pres.c, pres.A, pres.b, dtype=dtype_of(opts.dtype),
                 device=device)
    blp = _prepare([lp], opts, device)
    return blp, _rescue(blp, _run_batch(blp, opts), opts, in_batch=False)


def _continue_reduced(blp: LP, st: IPMState, opts: SolverOptions,
                      tol: float) -> IPMState:
    """The reduced solve continued from its last iterate with the gap
    tolerance ``tol``, for at most ``opts.max_iter`` more iterations.  The
    best iterate is tracked afresh, against ``tol``."""
    cap = int(st.it.max()) + opts.max_iter
    st0 = obs.resume_state(dataclasses.replace(
        st, status=torch.full_like(st.status, int(Status.RUNNING))), cap)
    st0 = dataclasses.replace(
        st0, best_merit=torch.full_like(st0.best_merit, float("inf")))
    return _run_batch(blp, opts.replace(tol=tol, max_iter=cap), st0)


@dataclass
class _UserAnswer:
    """An answer in the units of the standard-form LP ``(c, A, b)`` that
    presolve took, measured there in float64: ``s = max(c - A^T y, 0)``,
    the part cut away counted in ``rd_rel``; ``merit`` is the solver's
    (each measure over its tolerance, the largest), so the answer meets
    the contract exactly when ``merit <= 1``."""
    x: np.ndarray
    y: np.ndarray
    s: np.ndarray
    rel_gap: float
    rp_rel: float
    rd_rel: float
    merit: float


def _measure(A, b, c, x, y, opts: SolverOptions) -> _UserAnswer:
    s = c - A.T @ y
    sp = np.maximum(s, 0.0)
    gap = float(x @ sp) / (1.0 + abs(float(c @ x)))
    rp = float(np.abs(A @ x - b).max(initial=0.0)
               / (1.0 + np.abs(b).max(initial=0.0)))
    rd = float(np.maximum(-s, 0.0).max(initial=0.0)
               / (1.0 + np.abs(c).max(initial=0.0)))
    tol_feas = mehrotra.feas_tolerance(opts, dtype_of(opts.dtype))
    merit = max(gap / opts.tol, max(rp, rd) / tol_feas)
    return _UserAnswer(x, y, sp, gap, rp, rd, merit)


def _dual_polish(A, y, s, support, lu=None):
    """Host-side f64 dual polish, the mirror of :func:`_primal_polish`.

    ``s = c - A^T y`` of a float32 solve is at rounding size on the
    support S = ``support`` (the columns where x > s), on either side of
    0, and that rounding sums into x.s once the negative part is cut away.
    One least-squares correction A_S^T dy = s_S (rank-revealing: A's
    dependent rows are allowed) makes s vanish on S to float64 rounding.
    It comes from ``lu`` (:class:`_SupportLU`) where it serves, else from
    a host least squares.  Returns y + dy, or y where the correction
    fails; the caller keeps whichever answer measures better.  Skipped for
    m > ``POLISH_MAX_M`` (host cost)."""
    if A.shape[0] > POLISH_MAX_M or not support.any():
        return y
    dy = None if lu is None else lu.solve(support, s[support], adjoint=True)
    if dy is None:
        from scipy.linalg import lstsq
        try:
            dy = lstsq(A[:, support].T, s[support],
                       lapack_driver="gelsy")[0]
        except (np.linalg.LinAlgError, ValueError):
            return y
    yp = y + dy
    return yp if np.isfinite(yp).all() else y


def _postsolve_answer(pres, red: Solution, c, A, b, opts: SolverOptions,
                      polish: bool, device) -> _UserAnswer:
    """The reduced answer ``red`` in the units of ``(c, A, b)``: x and y
    unscaled and re-inserted, and with ``polish`` (an answer at or past an
    OPTIMAL reduced iterate) the primal polish (span ``api.polish``,
    counter ``api.polish.accepted``) and the dual polish (span
    ``api.postsolve.certify``, counter ``api.postsolve.dual_accepted``),
    the primal one kept by its own tests, the dual one where it lowers
    the answer's merit.  Both solve from one LU of the support's square
    system on ``device`` where it serves (:class:`_SupportLU`; counter
    ``api.polish.lu``, the polishes it served)."""
    x = pres.postsolve_x(red.x)
    y = pres.postsolve_y(red.y)
    if not polish:
        return _measure(A, b, c, x, y, opts)
    s = c - A.T @ y
    lu = _SupportLU(A, pres.kept_rows, device)
    with obs.span("api.polish"):
        xp = _primal_polish(A, b, x, s, c=c, support_mask=~pres.fixed_mask,
                            lu=lu)
        obs.count("api.polish.accepted", int(xp is not x))
    with obs.span("api.postsolve.certify"):
        ans = _measure(A, b, c, xp, y, opts)
        # the support: where x > s, and every variable presolve fixed at a
        # positive value (its row is gone, so y never priced it)
        support = (xp > np.maximum(s, 0.0)) | (pres.fixed_mask & (xp > 0))
        polished = _measure(A, b, c, xp,
                            _dual_polish(A, y, s, support, lu=lu), opts)
        take = polished.merit < ans.merit
        obs.count("api.postsolve.dual_accepted", int(take))
    obs.count("api.polish.lu", lu.served)
    return polished if take else ans


def _solve_and_postsolve(pres, c, A, b, opts: SolverOptions, device):
    """The reduced solve of ``pres`` and its answer in the units of
    ``(c, A, b)``: ``(answer, status, iterations, trace)``.

    OPTIMAL only for an answer that meets the contract there
    (``merit <= 1``: the gap within ``tol``, both residuals within the
    solver's feasibility tolerance).  Where the reduced solve met its
    tolerances and the polished answer does not, the reduced solve is
    continued once from its last iterate with the gap tolerance tightened
    by the ratio measured (span ``api.postsolve.resume``, counter
    ``api.postsolve.resumes``); an answer that still misses the contract
    is reported STALLED.  Span ``api.postsolve`` around all of it after the
    reduced solve returns."""
    blp, st = _solve_reduced(pres, opts, device)
    red = _states_to_solutions(blp, st)[0]
    status, its, trace = red.status, red.iterations, red.trace
    with obs.span("api.postsolve"):
        ans = _postsolve_answer(pres, red, c, A, b, opts,
                                polish=red.optimal, device=device)
        resumed = red.optimal and ans.merit > 1.0
        obs.count("api.postsolve.resumes", int(resumed))
        if resumed:
            with obs.span("api.postsolve.resume"):
                # the reduced gap reached, over the measured ratio, halved
                # for room
                reached = min(opts.tol, red.rel_gap) or opts.tol
                tol = 0.5 * reached / ans.merit
                red2 = _states_to_solutions(
                    blp, _continue_reduced(blp, st, opts, tol))[0]
                # its best iterate is polished whatever its status: the run
                # started from an OPTIMAL one
                ans2 = _postsolve_answer(pres, red2, c, A, b, opts,
                                         polish=True, device=device)
                if ans2.merit < ans.merit:
                    ans, its, trace = ans2, red2.iterations, red2.trace
            if ans.merit > 1.0:
                status = int(Status.STALLED)
    return ans, status, its, trace


def _solve_presolved(c, A, b, opts: SolverOptions, device) -> Solution:
    """Standard-form solve through presolve + postsolve (host reductions,
    dependent-row elimination, Ruiz scaling), answered in the user's
    units (:func:`_solve_and_postsolve`)."""
    if isinstance(c, LP):
        c, A, b = _host64(c.c), _host64(c.A), _host64(c.b)
    else:
        c = np.asarray(c, np.float64)
        A = np.asarray(A, np.float64)
        b = np.asarray(b, np.float64)
    # bf16 A-storage composes with scaling only if every scale factor is a
    # power of two (exact in binary FP); arbitrary Ruiz factors would round
    # the scaled instance to bf16 while the reduced solve reports OPTIMAL
    pres = _presolve(c, A, b, pow2_scales=(opts.a_storage == "bfloat16"))

    if pres.status != "ok" or pres.A.size == 0 or pres.A.shape[0] == 0:
        x = np.zeros(A.shape[1])
        x[pres.fixed_mask] = pres.fixed_vals[pres.fixed_mask]
        return _empty_solution(x, A.shape[0], A.shape[1], float(c @ x),
                               _PRESOLVE_STATUS[pres.status])

    ans, status, its, trace = _solve_and_postsolve(pres, c, A, b, opts,
                                                   device)
    return Solution(
        x=ans.x, y=ans.y, s=ans.s, objective=float(c @ ans.x),
        dual_objective=float(b @ ans.y), status=status, iterations=its,
        rel_gap=ans.rel_gap, rp_rel=ans.rp_rel, rd_rel=ans.rd_rel,
        trace=trace)


@obs.entry
def solve_general(glp, options: Optional[SolverOptions] = None,
                  device="cuda") -> Solution:
    """Solve a :class:`GeneralLP` (inequalities + bounds) end to end.

    Host pipeline: standard-form conversion -> presolve + Ruiz
    equilibration -> IPM solve on ``device`` of the scaled reduced problem
    -> postsolve back to original variables and units.  This is the path
    BASELINE config 2 (Netlib-style suite) exercises.  OPTIMAL, ``rel_gap``,
    ``rp_rel`` and ``rd_rel`` are :func:`solve`'s contract, held and
    measured in the standard form's units (the LP the user's one is
    equivalent to); ``s`` stays the reduced costs over the original
    variables, of either sign where bounds allow it.
    """
    opts = options or DEFAULT_OPTIONS
    if not isinstance(glp, GeneralLP):
        raise TypeError(f"solve_general expects GeneralLP, got {type(glp)}")

    c_s, A_s, b_s, _, post = to_standard_form(glp)
    pres = _presolve(c_s, A_s, b_s,
                     pow2_scales=(opts.a_storage == "bfloat16"))
    off = float(getattr(glp, "obj_offset", 0.0))
    maximize = bool(getattr(glp, "maximize", False))

    if pres.status != "ok" or pres.A.size == 0 or pres.A.shape[0] == 0:
        # a certificate from presolve, or every variable fixed
        z = np.zeros(post.n_std)
        z[pres.fixed_mask] = pres.fixed_vals[pres.fixed_mask]
        x = post.x_orig(z)
        obj = float(np.asarray(glp.c) @ x) + off
        return _empty_solution(x, glp.A_eq.shape[0] + glp.A_ub.shape[0],
                               glp.n, -obj if maximize else obj,
                               _PRESOLVE_STATUS[pres.status])

    # the answer in the standard form's units, polished and held to the
    # contract there
    ans, status, its, trace = _solve_and_postsolve(pres, c_s, A_s, b_s,
                                                   opts, device)
    x = post.x_orig(ans.x)

    # duals in ORIGINAL problem units: std-form rows are [A_eq | A_ub |
    # appended bound rows]; bound-row duals are dropped from y (their
    # contribution stays in the dual objective via b_s@y_std), and reduced
    # costs are recomputed against the original gradient.
    m_eq = glp.A_eq.shape[0]
    m_ub = glp.A_ub.shape[0]
    y = ans.y[:m_eq + m_ub].copy()
    s = glp.c - glp.A_eq.T @ y[:m_eq] - glp.A_ub.T @ y[m_eq:]
    obj = float(np.asarray(glp.c) @ x) + off
    # std form: min c_s@z + conv_offset, A_s z = b_s  =>  dual obj in
    # original (minimize) units is b_s@y + conv_offset (+ file constant)
    dual_obj = float(b_s @ ans.y) + post.obj_offset + off
    if maximize:
        obj, dual_obj = -obj, -dual_obj
        y, s = -y, -s
    return Solution(
        x=x, y=y, s=s,
        objective=obj, dual_objective=dual_obj,
        status=status, iterations=its,
        rel_gap=ans.rel_gap, rp_rel=ans.rp_rel, rd_rel=ans.rd_rel,
        trace=trace)


@obs.entry
def solve_mps(path: str, options: Optional[SolverOptions] = None,
              device="cuda") -> Solution:
    """Read an MPS file and solve it on ``device``."""
    return solve_general(read_mps(path), options, device)


@obs.entry
def solve_many(problems, options: Optional[SolverOptions] = None,
               m_multiple: int = 32, n_multiple: int = 64,
               device="cuda") -> list:
    """Solve a MIXED-SIZE collection of standard-form LPs.

    ``problems`` is a sequence of ``(c, A, b)`` triples or :class:`LP`
    objects of arbitrary (m, n).  Instances are grouped into geometric shape
    buckets (``ipx_torch/problem/batching.py``), padded solution-invariantly
    on the host, each bucket moved to ``device`` whole and solved as one
    batch by :func:`solve_batch`, unpadded, and returned as a list of
    :class:`Solution` in input order.
    """
    opts = options or DEFAULT_OPTIONS
    probs = []
    for p in problems:
        if isinstance(p, LP):
            probs.append((_host64(p.c), _host64(p.A), _host64(p.b)))
        else:
            probs.append(tuple(np.asarray(v, np.float64) for v in p))

    dtype = dtype_of(opts.dtype)
    out: list = [None] * len(probs)
    for shape, items in sorted(bucket_lps(probs, m_multiple,
                                          n_multiple).items()):
        def stack(field):
            return torch.as_tensor(
                np.stack([getattr(pad, field) for _, pad in items]),
                dtype=dtype).to(device)
        blp = LP(c=stack("c"), A=stack("A"), b=stack("b"),
                 obj_offset=torch.zeros(len(items), dtype=dtype,
                                        device=device))
        sols = solve_batch(blp, options=opts, device=device)
        for (idx, padded), sol in zip(items, sols):
            c, A, b = probs[idx]
            # strip padding and re-derive every reported quantity from the
            # ORIGINAL problem: the padded dead columns carry c_j = 1 and
            # x_j ~ mu, which must not leak into the objective
            x = padded.unpad_x(sol.x)
            y = padded.unpad_y(sol.y)
            s = sol.s[: padded.n_orig]
            pobj = float(c @ x)
            out[idx] = Solution(
                x=x, y=y, s=s,
                objective=pobj, dual_objective=float(b @ y),
                status=sol.status, iterations=sol.iterations,
                rel_gap=float(abs(x @ s) / (1 + abs(pobj))),
                rp_rel=float(np.abs(A @ x - b).max(initial=0.0)
                             / (1 + np.abs(b).max(initial=0.0))),
                rd_rel=float(np.abs(A.T @ y + s - c).max(initial=0.0)
                             / (1 + np.abs(c).max(initial=0.0))),
                trace=sol.trace)
    return out


@obs.entry
def solve_large(c, A=None, b=None, mesh=None,
                options: Optional[SolverOptions] = None,
                exec_chunk_iters: int = 0, device="cuda") -> Solution:
    """Solve one LARGE standard-form LP with its normal equations across the
    ranks of ``mesh``'s "row" axis (config 4: m=32k, n=64k).

    Rank i holds A's i-th column block on ``device``; c, b and every
    iterate are whole on every rank.  The normal matrix is assembled as row
    panels (a reduce-scatter of the ranks' partial products) and factored by
    the distributed blocked Cholesky (``ipx_torch/linsys/schur.py``); at
    p = 1 that is the whole matrix through the kernel factor.  Without a
    mesh the mesh is every rank of the default process group, or this
    process alone when there is none.  Every rank returns the same
    :class:`Solution`.

    The endgame: when the normal-equations stage ends STALLED, MAX_ITER or
    NUMERICAL_FAILURE, the solve is retried once, warm-started from its best
    iterate, on ``linsys="sharded_schur"`` (the augmented system's Schur form
    on the distributed factor); that stage is kept if its best merit is
    lower, with the iterations of both.  ``options.augmented_fallback=False``
    turns it off; ``options.linsys="sharded_schur"`` runs that route alone.

    ``exec_chunk_iters > 0`` caps each run at that many iterations and
    resumes from its state (``obs.resume_state``) until ``max_iter`` or an
    end, in both stages: a continuation of the same iteration, each run
    recomputing the starting point's AA^T factor and the carried residuals
    from the iterate.
    """
    from ipx_torch import mesh as meshlib

    opts = _sharded_route(options or DEFAULT_OPTIONS)
    if mesh is None:
        world = (torch.distributed.get_world_size()
                 if torch.distributed.is_available()
                 and torch.distributed.is_initialized() else 1)
        mesh = meshlib.make_mesh(batch=1, row=world)
    lp = _large_share(c, A, b, mesh, opts, device)
    with schur.use_mesh(mesh):
        st = _sharded_endgame(lp, _run_stage(lp, opts, exec_chunk_iters),
                              opts, exec_chunk_iters)
        return _sharded_solutions(lp, st)[0]


# the statuses after which the sharded routes run their endgame: the dense
# route's rescue statuses and MAX_ITER, where stage 1 on "sharded" crawls
_ENDGAME = _RESCUE + (int(Status.MAX_ITER),)


def _sharded_endgame(lp: LP, st: IPMState, opts: SolverOptions,
                     chunk: int = 0) -> IPMState:
    """The sharded routes' rescue: the lanes that ended STALLED, MAX_ITER
    or NUMERICAL_FAILURE run again as one batch on ``"sharded_schur"`` (the
    augmented system's Schur form on the distributed factor), warm-started
    from their best iterates, and each keeps that stage if its best merit is
    lower, with the iterations of both.  Only after ``"sharded"`` with
    ``augmented_fallback``.  Every rank of a row group reads the same
    statuses, so they run the same stage."""
    if not (opts.augmented_fallback and opts.linsys == "sharded"):
        return st
    bad = [i for i, code in enumerate(st.status.tolist()) if code in _ENDGAME]
    if not bad:
        return st
    whole = len(bad) == st.status.shape[0]
    idx = torch.tensor(bad, device=st.it.device)
    # all lanes: no gather (at config 4 a copy of A's block is 4.3 GB)
    sub_lp, sub_st = ((lp, st) if whole
                      else (take_lanes(lp, idx), take_lanes(st, idx)))
    sch = opts.replace(linsys="sharded_schur")
    state0 = mehrotra.warm_start_state(sub_lp, sub_st.best_x, sub_st.best_y,
                                       sub_st.best_s, sch)
    res = _run_stage(sub_lp, sch, chunk, state0)
    res = dataclasses.replace(res, it=sub_st.it + res.it)
    keep = res.best_merit < sub_st.best_merit
    if whole:
        return select_lanes(keep, res, st)
    return put_lanes(st, idx[keep], take_lanes(res, keep))


def _large_share(c, A, b, mesh, opts: SolverOptions, device) -> LP:
    """This rank's part of the large LP as a batch of one on ``device``: its
    column block of A (bf16 kept as stored with ``a_storage="bfloat16"``,
    never through a float32 copy of the whole), c and b whole in the compute
    dtype.  Only the block moves to the device."""
    from ipx_torch import mesh as meshlib
    if isinstance(c, LP):
        c, A, b, off = c.c, c.A, c.b, c.obj_offset
    else:
        off = 0.0
    A = A if isinstance(A, torch.Tensor) else torch.as_tensor(np.asarray(A))
    m, n = A.shape
    p = mesh.shape[meshlib.ROW_AXIS]
    if n % p or m % p:
        raise ValueError(
            f"sharded solve needs m ({m}) and n ({n}) divisible by the "
            f"row-shard count p={p}; pad the problem first")
    dtype = dtype_of(opts.dtype)
    # the block takes its storage dtype where A lives (a host A never
    # reaches the device in float64), then moves
    block = A[meshlib.large_lp_sharding(mesh, n)["A"]]
    if not (block.dtype == torch.bfloat16 and opts.a_storage == "bfloat16"):
        block = block.to(dtype)
        if opts.a_storage == "bfloat16":
            block = block.to(torch.bfloat16)
    block = block.to(device).contiguous()

    def whole(v):
        return torch.as_tensor(v).to(device=device, dtype=dtype)
    return LP(c=whole(c).reshape(1, n), A=block.unsqueeze(0),
              b=whole(b).reshape(1, m), obj_offset=whole(off).reshape(1))


def _run_stage(lp: LP, opts: SolverOptions, chunk: int,
               state0: Optional[IPMState] = None) -> IPMState:
    """One stage of :func:`solve_large`; ``chunk > 0`` caps each run at
    ``chunk`` iterations and resumes until ``max_iter`` or an end."""
    if chunk <= 0:
        return _run_batch(lp, opts, state0)
    caps = list(range(chunk, opts.max_iter + 1, chunk))
    if not caps or caps[-1] != opts.max_iter:
        caps.append(opts.max_iter)
    st = None
    for cap in caps:
        s0 = state0 if st is None else obs.resume_state(st, cap)
        st = _run_batch(lp, opts.replace(max_iter=cap), s0)
        if int(st.status) not in (int(Status.RUNNING), int(Status.MAX_ITER)):
            break
    return st
