"""Batch-of-LPs solve loop.

The whole Mehrotra step is written with a leading batch dimension, and ONE
Python loop drives the entire batch: every instance advances in lock-step,
instances that have converged or failed are frozen by ``step_masked``'s
per-lane select; once at most half the lanes stepped still run, the loop
goes on with those alone; it exits when no instance is still RUNNING.  B
independent m x m Cholesky factorizations and (m, n) x (n, m) assemblies
become single batched device calls.

A "batched LP" is an :class:`ipx_torch.problem.lp.LP` whose fields carry a
leading batch dimension.  All instances in a batch share (m, n).
"""
from __future__ import annotations

import contextvars

import torch

from ipx_torch import obs
from ipx_torch.ipm import mehrotra
from ipx_torch.ipm.state import (IPMState, init_state, put_lanes,
                                 select_lanes, take_lanes)
from ipx_torch.linsys import normal_eq
from ipx_torch.numerics import vdot
from ipx_torch.options import SolverOptions, check_ported
from ipx_torch.problem.lp import LP
from ipx_torch.status import Status


# ``obs.debug_mode`` sets "raise", ``obs.checked_solve`` a list that takes
# the first failure's message; None (the default) tests nothing.
FINITE_CHECK: contextvars.ContextVar = contextvars.ContextVar(
    "ipx_torch_finite_check", default=None)


def _step(lp: LP, st: IPMState, opts: SolverOptions, fac_aat, fac=None,
          boost0=None, lanes=None) -> IPMState:
    """One masked step (``mehrotra.step_masked``, or with ``boost0`` a
    refactor block's trailing stale step) and, under FINITE_CHECK, the test
    of its named values (``mehrotra.STEP_VALUES``) on the lanes it steps:
    one host read.  The first non-finite value, in the order the step makes
    them, lowest lane first, raises FloatingPointError naming the
    iteration, the lane (the caller's: ``lanes`` maps a narrowed batch's
    lanes to them) and the field, or is recorded (the first only)."""
    def step():
        if boost0 is None:
            return mehrotra.step_masked(lp, st, opts, fac_aat, fac)
        return mehrotra.step_masked_stale(lp, st, opts, fac_aat, fac, boost0)

    mode = FINITE_CHECK.get()
    if mode is None or (isinstance(mode, list) and mode):
        return step()
    kept = {}
    tok = mehrotra.STEP_VALUES.set(kept)
    try:
        new = step()
    finally:
        mehrotra.STEP_VALUES.reset(tok)
    active = (st.status == int(Status.RUNNING)) & (st.it < opts.max_iter)
    if boost0 is not None:
        active &= st.reg_boost <= boost0
    finite = torch.stack([torch.isfinite(v.reshape(v.shape[0], -1)).all(-1)
                          for v in kept.values()])          # (fields, B)
    bad = (~finite & active).cpu()
    if bad.any():
        f, lane = (int(i) for i in torch.nonzero(bad)[0])
        caller = lane if lanes is None else int(lanes[lane])
        msg = (f"iteration {int(st.it[lane])}, lane {caller}: non-finite "
               f"{list(kept)[f]}")
        if mode == "raise":
            raise FloatingPointError(msg)
        mode.append(msg)
    return new


def stack_lps(lps) -> LP:
    """Stack a sequence of same-shape single-instance LPs into one batched
    LP."""
    lps = list(lps)
    if not lps:
        raise ValueError("empty LP batch")
    if any(lp.A.ndim != 2 for lp in lps):
        raise ValueError("stack_lps takes single-instance LPs (A of rank 2)")
    shapes = {(lp.m, lp.n) for lp in lps}
    if len(shapes) != 1:
        raise ValueError(f"batch mixes LP shapes: {sorted(shapes)}")
    return LP(c=torch.stack([lp.c for lp in lps]),
              A=torch.stack([lp.A for lp in lps]),
              b=torch.stack([lp.b for lp in lps]),
              obj_offset=torch.stack([lp.obj_offset for lp in lps]))


def batch_starting_state(lp: LP, opts: SolverOptions):
    """Mehrotra starting point of every instance -> (IPMState, AA^T
    factor).  The factor is loop-invariant and reused every iteration for
    the feasibility projection."""
    check_ported(opts)
    lp = lp.with_a_storage(opts)
    x0, y0, s0, fac = mehrotra.starting_point(lp, opts)
    mu0 = vdot(x0, s0) / lp.n
    st = init_state(x0, y0, s0, mu0, opts.max_iter)
    return mehrotra.refresh_residuals(lp, st, opts), fac


def _narrows(n_live: int, width: int) -> bool:
    """The batch narrows to its running lanes once they are at most half
    the width stepped: a gather of the running lanes against the steps
    that stop stepping the ended ones, at most log2 B times a run."""
    return 2 * n_live <= width


def run_batch(lp: LP, opts: SolverOptions,
              state0: IPMState | None = None) -> IPMState:
    """Solve a batch of LPs.

    The count of lanes RUNNING and under the cap is the one device-to-host
    read per loop body.  ``state0`` resumes or warm-starts the whole batch
    (the rescue ladder's warm rungs); its residual fields are refreshed
    here.  The starting point is computed all the same: its AA^T factor is
    the projection's.

    Once the running lanes are at most half the width stepped
    (:func:`_narrows`), the loop goes on with those lanes alone: the LP,
    the state and the starting point's factor gathered by lane (a lane's
    step reads only its own lane), the lanes that ended left as they were.
    At the end the narrow state is put back, so the result has the
    caller's width and order.  The sharded routes keep every lane: their
    steps run collectives across a row group's ranks.

    With ``refactor_period = k > 1`` a body factors once and takes k steps:
    the first fresh, the k - 1 trailing ones with that factor as a stale
    preconditioner and ``stale_solve_cg`` CG iterations.  The batch narrows
    only at a body's start.

    Under ``obs.debug_mode`` or ``obs.checked_solve`` each step's values
    are tested for non-finite entries (:func:`_step`).

    Spans (``obs.span``, with their device time): ``ipm.start``, the
    starting point and ``state0``'s residuals; ``ipm.step``, each step (a
    block's factor with its first step); ``ipm.compact``, each narrowing.
    Counters: ``ipm.compact.shrinks``, the narrowings; ``ipm.lane_steps``,
    the width stepped summed over the steps.
    """
    check_ported(opts)
    lp = lp.with_a_storage(opts)
    with obs.span("ipm.start", device=True):
        start, fac_aat = batch_starting_state(lp, opts)
        if state0 is None:
            st = start
        else:
            st = mehrotra.refresh_residuals(lp, state0, opts)
    stale = opts.replace(refine_steps=opts.stale_solve_cg)
    running = int(Status.RUNNING)
    narrow = not opts.linsys.startswith("sharded")
    full = lanes = None         # lanes: narrow lane -> the caller's lane
    shrinks = lane_steps = 0
    while True:
        live = (st.status == running) & (st.it < opts.max_iter)
        n_live = int(live.sum())
        if not n_live:
            break
        if narrow and _narrows(n_live, live.shape[0]):
            with obs.span("ipm.compact", device=True):
                keep = torch.nonzero(live).squeeze(1)
                if lanes is None:
                    full, lanes = st, keep
                else:
                    full, lanes = put_lanes(full, lanes, st), lanes[keep]
                lp, st, fac_aat = (take_lanes(v, keep)
                                   for v in (lp, st, fac_aat))
            shrinks += 1
        lane_steps += st.it.shape[0] * opts.refactor_period
        if opts.refactor_period == 1:
            with obs.span("ipm.step", device=True):
                st = _step(lp, st, opts, fac_aat, lanes=lanes)
            continue
        boost0 = st.reg_boost
        with obs.span("ipm.step", device=True):
            fac = normal_eq.factor(lp.A, st.x / st.s, opts,
                                   reg_scale=st.reg_boost)
            st = _step(lp, st, opts, fac_aat, fac, lanes=lanes)
        for _ in range(opts.refactor_period - 1):
            with obs.span("ipm.step", device=True):
                st = _step(lp, st, stale, fac_aat, fac, boost0, lanes)
    if lanes is not None:
        st = put_lanes(full, lanes, st)
    obs.count("ipm.compact.shrinks", shrinks)
    obs.count("ipm.lane_steps", lane_steps)
    return mehrotra.finalize_status(st, opts)


def run_batch_fixed_iters(lp: LP, state: IPMState, num_iters: int,
                          opts: SolverOptions, fac_aat=None) -> IPMState:
    """Advance the whole batch exactly ``num_iters`` steps (no masking, no
    host reads): the steady-state cost of one batched Mehrotra iteration,
    for rate measurements.

    With ``refactor_period = k > 1`` and ``fac_aat`` given, one factor
    serves k steps, so ``num_iters`` must be a multiple of k.  A trailing
    stale step leaves a lane whose boost rose in the block as it was (status
    and the cap are not looked at here): the lane would fail again the same
    way under the same factor."""
    check_ported(opts)
    lp = lp.with_a_storage(opts)
    period = opts.refactor_period if fac_aat is not None else 1
    if num_iters % period:
        raise ValueError(f"num_iters={num_iters} is not a multiple of "
                         f"refactor_period={period}")
    if period == 1:
        for _ in range(num_iters):
            state = mehrotra.mehrotra_step(lp, state, opts, fac_aat)
        return state
    stale = opts.replace(refine_steps=opts.stale_solve_cg)
    for _ in range(num_iters // period):
        boost0 = state.reg_boost
        fac = normal_eq.factor(lp.A, state.x / state.s, opts,
                               reg_scale=state.reg_boost)
        state = mehrotra.mehrotra_step(lp, state, opts, fac_aat, fac)
        for _ in range(period - 1):
            new = mehrotra.mehrotra_step(lp, state, stale, fac_aat, fac)
            state = select_lanes(state.reg_boost <= boost0, new, state)
    return state
