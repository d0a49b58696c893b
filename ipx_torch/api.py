"""Public API: solve / solve_batch -> Solution."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ipx_torch.ipm import batched
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


def _check_entry(opts: SolverOptions) -> None:
    check_ported(opts)
    if opts.augmented_fallback:
        raise NotImplementedError(
            "augmented_fallback=True needs the rescue ladder, which is not "
            "ported yet (ROADMAP.md: rescue ladder); pass "
            "augmented_fallback=False")


def solve_batch(lps, options: Optional[SolverOptions] = None,
                device="cuda") -> list:
    """Solve a batch of same-shape LPs in one batched run on ``device``.

    ``lps`` is a sequence of single-instance :class:`LP` or an already
    batched LP (A of rank 3).  Returns one :class:`Solution` per instance,
    in input order.
    """
    opts = options or DEFAULT_OPTIONS
    _check_entry(opts)
    if isinstance(lps, LP):
        blp = lps
        if blp.A.ndim != 3:
            raise ValueError("batched LP must have A of rank 3 (B, m, n)")
    else:
        blp = batched.stack_lps(lps)
    blp = blp.to(device)
    dtype = dtype_of(opts.dtype)
    # a bf16-stored A stays as stored (its values are exact in f32, and a
    # round trip through f32 would cost a transient copy twice its size);
    # the rest of the instance takes the compute dtype
    keep_a = blp.A.dtype == torch.bfloat16 and opts.a_storage == "bfloat16"
    blp = LP(c=blp.c.to(dtype), A=blp.A if keep_a else blp.A.to(dtype),
             b=blp.b.to(dtype), obj_offset=blp.obj_offset.to(dtype))
    # run_batch applies a_storage itself; the reported metrics are taken
    # against the instance as given, as in ``ipx``
    st = batched.run_batch(blp, opts)
    return _states_to_solutions(blp, st)


def solve(c, A=None, b=None, options: Optional[SolverOptions] = None,
          presolve: bool = True, device="cuda") -> Solution:
    """Solve one standard-form LP ``min c@x s.t. A@x=b, x>=0`` on
    ``device``, as a batch of one.

    Accepts ``solve(lp)`` with an :class:`LP` or ``solve(c, A, b)`` with
    array-likes.  ``presolve`` defaults to True as in ``ipx``; the host-side
    presolve is not ported yet, so callers pass ``presolve=False``.
    """
    if presolve:
        raise NotImplementedError(
            "presolve=True is not ported yet (ROADMAP.md: problem layer and "
            "front ends); pass presolve=False")
    opts = options or DEFAULT_OPTIONS
    lp = c if isinstance(c, LP) else make_lp(c, A, b, device=device)
    return solve_batch([lp], options=opts, device=device)[0]
