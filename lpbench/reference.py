"""The plain reference: what a solve returned, judged against the LP itself.

For every LP of a call it takes the inputs the benchmark made (c, A as
stored, b, the objective offset and the constructed optimum x*) and the
answer the entry returned (x, y, s, the objective, and what its status
claims: an optimum, infeasibility, or neither), and works out in float64
what it judges.  Every LP of the traffic has an optimum, so:

- ``missing``: no answer, a misshapen one, or one with a non-finite entry
  (a count, limit 0);
- ``wrong_status``: the answer claims the LP infeasible or unbounded (a
  count, limit 0);
- ``unsolved``: the share of LPs whose answer claims no optimum (MAX_ITER,
  STALLED, NUMERICAL_FAILURE: the solver gave up, honestly), in percent;

and of each answer that claims an optimum:

- ``negative``: an entry of x or s below zero (a count, limit 0);
- ``gap``: x.s / (1 + |c.x|), the complementarity gap the solver stops on;
- ``rp``: |A x - b|_inf / (1 + |b|_inf), primal infeasibility;
- ``rd``: |A^T y + s - c|_inf / (1 + |c|_inf), dual infeasibility;
- ``obj``: the farther of the reported objective and c.x + offset from the
  optimum c.x* + offset, over 1 + |optimum|.

An LP fails unless its answer claims an optimum and meets every limit.
The solver's own fields (its gap, residuals and status code) are never
read as true: the status is judged, the rest recomputed.  Imports torch and
numpy only, nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

COUNTS = ("missing", "wrong_status", "negative")
VALUES = ("gap", "rp", "rd", "obj")
NUMBERS = ("missing", "wrong_status", "unsolved", "negative") + VALUES
PER_LP = COUNTS + ("optimal",) + VALUES


def _inf(t: torch.Tensor) -> torch.Tensor:
    return t.abs().amax(-1)


def judge(inputs: dict, answers: dict, device, block: int = 32) -> dict:
    """Per-LP readings of one call: name -> float64 array over its N LPs
    (``missing``, ``wrong_status``, ``negative`` 0 or 1, ``optimal`` 1 for
    an answer that claims an optimum, the values nan where there is no
    answer).

    ``inputs`` holds c (N, n), A (N, m, n), b (N, m), obj_offset (N,) and
    x_star (N, n) as tensors; ``answers`` holds x (K, n), y (K, m), s (K,
    n), objective (K,), optimal (K,) and infeasible (K,) bool for the first
    K LPs, K <= N (a misshapen x, y or s may stay a list)."""
    f64 = torch.float64
    N, m, n = inputs["A"].shape
    K = len(answers["objective"])
    out = {k: np.zeros(N) for k in PER_LP}
    for k in VALUES:
        out[k][:] = np.nan
    out["missing"][min(K, N):] = 1.0
    for lo in range(0, min(K, N), block):
        hi = min(N, K, lo + block)
        j = hi - lo
        sl = slice(lo, hi)
        try:
            x, y, s = (torch.as_tensor(np.asarray(answers[k][sl],
                                                  dtype=np.float64),
                                       device=device) for k in "xys")
        except ValueError:          # ragged: some answer is misshapen
            x = y = s = None
        if x is None or x.shape != (j, n) or y.shape != (j, m) \
                or s.shape != (j, n):
            out["missing"][sl] = 1.0
            continue
        get = lambda k: inputs[k][sl].to(device=device, dtype=f64)
        A, c, b, off, xs = (get(k) for k in ("A", "c", "b", "obj_offset",
                                             "x_star"))
        obj = torch.as_tensor(np.asarray(answers["objective"][sl],
                                         dtype=np.float64), device=device)
        star = (c * xs).sum(-1) + off
        cx = (c * x).sum(-1)
        rp = _inf(torch.matmul(A, x.unsqueeze(-1)).squeeze(-1) - b)
        rd = _inf(torch.matmul(y.unsqueeze(1), A).squeeze(1) + s - c)
        vals = {
            "gap": (x * s).sum(-1).abs() / (1 + cx.abs()),
            "rp": rp / (1 + _inf(b)),
            "rd": rd / (1 + _inf(c)),
            "obj": torch.maximum((obj - star).abs(),
                                 (cx + off - star).abs()) / (1 + star.abs()),
        }
        finite = (torch.isfinite(x).all(-1) & torch.isfinite(y).all(-1)
                  & torch.isfinite(s).all(-1) & torch.isfinite(obj))
        for k, v in vals.items():
            out[k][sl] = v.cpu().numpy()
        out["missing"][sl] = (~finite).cpu().numpy()
        out["negative"][sl] = ((x.amin(-1) < 0) | (s.amin(-1) < 0)
                               ).cpu().numpy()
        out["optimal"][sl] = np.asarray(answers["optimal"][sl], dtype=bool)
        out["wrong_status"][sl] = np.asarray(answers["infeasible"][sl],
                                             dtype=bool)
    return out


def merge(readings: list) -> dict:
    """The per-LP readings of several calls, end to end."""
    return {k: np.concatenate([r[k] for r in readings]) for k in PER_LP}


def verdict(per_lp: dict, limits: dict) -> tuple:
    """``(failed, checks)``: the LPs that fail (no optimum claimed, or a
    limit missed), and each number's reading beside its limit: the counts
    summed, ``unsolved`` in percent of the LPs, each value the largest over
    the answers that claim an optimum."""
    claimed = (per_lp["optimal"] > 0) & (per_lp["missing"] == 0)
    fails = ~claimed | (per_lp["wrong_status"] > 0)
    checks = {}
    for k in NUMBERS:
        if k == "unsolved":
            v = 100.0 * float((~claimed).sum()) / max(len(claimed), 1)
        elif k in COUNTS:
            vals = per_lp[k] if k != "negative" else per_lp[k][claimed]
            v = float(vals.sum())
            if k == "negative":
                fails[claimed] |= per_lp[k][claimed] > 0
        else:
            vals = per_lp[k][claimed]
            fails[claimed] |= ~(vals <= limits[k])
            v = float(vals.max(initial=0.0)) if not np.isnan(vals).any() \
                else float("nan")
        checks[k] = {"value": v, "limit": limits[k]}
    return int(fails.sum()), checks


def correct(checks: dict) -> bool:
    """Every number within its limit (a nan is not)."""
    return all(c["value"] <= c["limit"] for c in checks.values())
