"""Public API: solve / solve_batch -> Solution."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ipx_torch.ipm import batched, mehrotra
from ipx_torch.ipm.state import IPMState
from ipx_torch.numerics import dtype_of
from ipx_torch.options import DEFAULT_OPTIONS, SolverOptions, check_ported
from ipx_torch.problem.lp import LP, make_lp
from ipx_torch.status import STATUS_NAMES, Status


@dataclass
class Solution:
    """Host-side solve result (original problem units)."""

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


def _states_to_solutions(lp: LP, st: IPMState) -> list:
    """One Solution per lane.  The best-merit iterate visited is reported
    (equals the final iterate on a clean OPTIMAL exit; shields MAX_ITER /
    STALLED / failed exits from late f32 degradation), and its quality
    metrics are recomputed in f64 on the host.  Each field crosses to the
    host ONCE for the whole batch; A crosses in its stored dtype and is
    widened lane by lane, so the host never holds the batch's A in f64."""
    X, Y, S = _host64(st.best_x), _host64(st.best_y), _host64(st.best_s)
    C, Bv = _host64(lp.c), _host64(lp.b)
    off = _host64(lp.obj_offset)
    A_h = lp.A.detach().to("cpu")
    status = st.status.to("cpu").numpy()
    its = st.it.to("cpu").numpy()
    trace = _host64(st.trace)
    sols = []
    for i in range(X.shape[0]):
        x, y, s, c, b = X[i], Y[i], S[i], C[i], Bv[i]
        A = A_h[i].to(torch.float64).numpy()
        pobj = float(c @ x)
        rp_rel = float(np.abs(A @ x - b).max(initial=0.0)
                       / (1 + np.abs(b).max(initial=0.0)))
        rd_rel = float(np.abs(A.T @ y + s - c).max(initial=0.0)
                       / (1 + np.abs(c).max(initial=0.0)))
        sols.append(Solution(
            x=x, y=y, s=s,
            objective=pobj + float(off[i]),
            dual_objective=float(b @ y) + float(off[i]),
            status=int(status[i]), iterations=int(its[i]),
            rel_gap=float((x @ s) / (1 + abs(pobj))),
            rp_rel=rp_rel, rd_rel=rd_rel, trace=trace[i]))
    return sols


# the statuses the ladder rescues in both entry points; ``solve`` adds a
# near-miss MAX_ITER (see _maybe_augmented_fallback)
_RESCUE = (int(Status.STALLED), int(Status.NUMERICAL_FAILURE))


def _run_batch(lp: LP, opts: SolverOptions,
               state0: Optional[IPMState] = None) -> IPMState:
    """Every run of the entry points, stage 1 and each rung of the rescue
    ladder, goes through here."""
    return batched.run_batch(lp, opts, state0)


def _lanes(obj, idx: torch.Tensor):
    """Lanes ``idx`` of a batched LP or IPMState, each field gathered by
    index as stored (a bf16 A stays bf16)."""
    return type(obj)(**{f.name: getattr(obj, f.name)[idx]
                        for f in dataclasses.fields(obj)})


def _put(st: IPMState, idx: torch.Tensor, sub: IPMState) -> IPMState:
    """``st`` with lanes ``idx`` replaced by the lanes of ``sub``."""
    out = {}
    for f in dataclasses.fields(st):
        a = getattr(st, f.name).clone()
        a[idx] = getattr(sub, f.name)
        out[f.name] = a
    return IPMState(**out)


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
    for rung, warm in ((aug, True), (aug, False), (asch, True)):
        if todo.numel() == 0:
            break
        sub_lp = _lanes(lp, todo)
        state0 = _warm(sub_lp, _lanes(st, todo), rung) if warm else None
        res = _run_batch(sub_lp, rung, state0)
        spent[todo] += res.it
        res = dataclasses.replace(res, it=spent[todo])
        fixed = res.status == int(Status.OPTIMAL)
        out = _put(out, todo[fixed], _lanes(res, fixed))
        todo = todo[~fixed]
    return out


def _rescue_batch(blp: LP, st: IPMState, opts: SolverOptions) -> IPMState:
    """``solve_batch``'s rescue of its STALLED and NUMERICAL_FAILURE lanes
    (a near-miss MAX_ITER is not rescued here, as in ``ipx``).

    First in one batch: the failing lanes gathered into a sub-batch,
    warm-started from their best iterates and run on ``augmented_schur``;
    a lane it ends OPTIMAL reports the iterations of stage 1 and of this
    rung.  The lanes it leaves go through :func:`_ladder` from their
    stage-1 states, so their count leaves this rung out, as ``ipx``'s
    does."""
    bad = [i for i, code in enumerate(st.status.tolist()) if code in _RESCUE]
    if not bad:
        return st
    idx = torch.tensor(bad, device=st.it.device)
    sub_lp, sub_st = _lanes(blp, idx), _lanes(st, idx)
    asch = opts.replace(linsys="augmented_schur", refactor_period=1)
    res = _run_batch(sub_lp, asch, _warm(sub_lp, sub_st, asch))
    res = dataclasses.replace(res, it=res.it + sub_st.it)
    fixed = res.status == int(Status.OPTIMAL)
    out = _put(st, idx[fixed], _lanes(res, fixed))
    left = idx[~fixed]
    if left.numel():
        out = _put(out, left, _ladder(_lanes(blp, left), _lanes(st, left),
                                      opts))
    return out


def _maybe_augmented_fallback(lp: LP, st: IPMState,
                              opts: SolverOptions) -> IPMState:
    """``solve``'s rescue: the ladder on a lane that ended STALLED or
    NUMERICAL_FAILURE, or MAX_ITER within ``stall_gap_guard * tol`` of the
    gap tolerance (a near-miss; ``solve_batch`` does not rescue it, as in
    ``ipx``).  Only the dense route rescues.  A far MAX_ITER is the
    caller's iteration budget and stays as it is."""
    if not opts.augmented_fallback or opts.linsys != "dense":
        return st
    near_miss = ((st.status == int(Status.MAX_ITER))
                 & (st.rel_gap <= opts.stall_gap_guard * opts.tol)
                 if opts.stall_gap_guard > 0
                 else torch.zeros_like(st.status, dtype=torch.bool))
    rescue = near_miss | torch.isin(st.status, torch.tensor(
        _RESCUE, dtype=st.status.dtype, device=st.status.device))
    idx = torch.nonzero(rescue).flatten()
    if not idx.numel():
        return st
    return _put(st, idx, _ladder(_lanes(lp, idx), _lanes(st, idx), opts))


def _prepare(lps, opts: SolverOptions, device) -> LP:
    """The batched LP on ``device``: a bf16-stored A stays as stored (its
    values are exact in f32, and a round trip through f32 would cost a
    transient copy twice its size); the rest takes the compute dtype."""
    check_ported(opts)
    if isinstance(lps, LP):
        blp = lps
        if blp.A.ndim != 3:
            raise ValueError("batched LP must have A of rank 3 (B, m, n)")
    else:
        blp = batched.stack_lps(lps)
    blp = blp.to(device)
    dtype = dtype_of(opts.dtype)
    keep_a = blp.A.dtype == torch.bfloat16 and opts.a_storage == "bfloat16"
    return LP(c=blp.c.to(dtype), A=blp.A if keep_a else blp.A.to(dtype),
              b=blp.b.to(dtype), obj_offset=blp.obj_offset.to(dtype))


def solve_batch(lps, options: Optional[SolverOptions] = None,
                device="cuda") -> list:
    """Solve a batch of same-shape LPs in one batched run on ``device``.

    ``lps`` is a sequence of single-instance :class:`LP` or an already
    batched LP (A of rank 3).  Returns one :class:`Solution` per instance,
    in input order.  With ``augmented_fallback`` (the default) on the dense
    route, lanes that end STALLED or NUMERICAL_FAILURE are rescued
    (:func:`_rescue_batch`).
    """
    opts = options or DEFAULT_OPTIONS
    blp = _prepare(lps, opts, device)
    # run_batch applies a_storage itself; the reported metrics are taken
    # against the instance as given, as in ``ipx``
    st = _run_batch(blp, opts)
    if opts.augmented_fallback and opts.linsys == "dense":
        st = _rescue_batch(blp, st, opts)
    return _states_to_solutions(blp, st)


def solve(c, A=None, b=None, options: Optional[SolverOptions] = None,
          presolve: bool = True, device="cuda",
          warm_start=None) -> Solution:
    """Solve one standard-form LP ``min c@x s.t. A@x=b, x>=0`` on
    ``device``, as a batch of one.

    Accepts ``solve(lp)`` with an :class:`LP` or ``solve(c, A, b)`` with
    array-likes.  ``presolve`` defaults to True as in ``ipx``; the host-side
    presolve is not ported yet, so callers pass ``presolve=False``.

    ``warm_start=(x, y, s)`` seeds the run from a previous, related
    solution, re-centered off the bounds (``mehrotra.warm_start_state``).
    As in ``ipx`` it skips presolve and the rescue ladder.
    """
    opts = options or DEFAULT_OPTIONS
    if presolve and warm_start is None:
        raise NotImplementedError(
            "presolve=True is not ported yet (ROADMAP.md: problem layer and "
            "front ends); pass presolve=False")
    lp = c if isinstance(c, LP) else make_lp(c, A, b, device=device)
    blp = _prepare([lp], opts, device)
    if warm_start is not None:
        x, y, s = (torch.as_tensor(v).reshape(1, -1) for v in warm_start)
        st = _run_batch(blp, opts,
                        mehrotra.warm_start_state(blp, x, y, s, opts))
    else:
        st = _maybe_augmented_fallback(blp, _run_batch(blp, opts), opts)
    return _states_to_solutions(blp, st)[0]
