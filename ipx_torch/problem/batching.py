"""Shape-bucketed batching of heterogeneous LPs (SURVEY.md §2.2 "EP" row,
§7 hard part 3).

A batch shares one (m, n); a mixed-size workload is padded to a small set of
(m, n) buckets, each solved as one batch.  Padding is host (numpy) work: a
bucket's arrays are stacked and moved to the device whole by the caller
(``ipx_torch.api.solve_many``).  Padding must be solution-invariant:

  * extra COLUMN j: c_j = 1, A[:, j] = 0  ->  x_j = 0 at any optimum
    (never enters the basis; strictly feasible interior still exists).
  * extra ROW i: a fresh slack column s_i with A[i, :] = e_{s_i}, b_i = 1,
    c_{s_i} = 0  ->  the row reads  s_i = 1: always feasible, never binds
    the original variables, keeps A full row rank.

Instances are grouped to buckets by geometric rounding, so an arbitrary
workload makes at most O(log(max/min)) batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class PaddedLP:
    """One padded instance (float64 numpy) + the recipe to strip the
    padding."""
    c: np.ndarray
    A: np.ndarray
    b: np.ndarray
    m_orig: int
    n_orig: int

    def unpad_x(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x)[: self.n_orig]

    def unpad_y(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y)[: self.m_orig]


def _round_up(v: int, multiple: int) -> int:
    return -(-v // multiple) * multiple


def bucket_shape(m: int, n: int, m_multiple: int = 32,
                 n_multiple: int = 64) -> tuple[int, int]:
    """Geometric-ish bucket: round each dim up to its multiple, then to the
    next power-of-two-ish step above 4x the multiple (1.5x steps)."""
    def dim(v, mult):
        # smallest grid point >= v on the geometric grid {4*mult * 1.5^k}
        v = _round_up(v, mult)
        step = 4 * mult
        while step < v:
            step = _round_up(int(step * 1.5), mult)
        return step
    return dim(m, m_multiple), dim(n, n_multiple)


def pad_lp(c, A, b, m_pad: int, n_pad: int) -> PaddedLP:
    """Pad one standard-form LP to (m_pad, n_pad), solution-invariant."""
    c = np.asarray(c, np.float64)
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    m, n = A.shape
    extra_rows = m_pad - m
    if extra_rows < 0 or n_pad < n + extra_rows:
        raise ValueError(
            f"bucket ({m_pad},{n_pad}) too small for LP ({m},{n}): "
            f"needs n_pad >= n + (m_pad - m) for the row slacks")

    n_slack = extra_rows                 # one fresh slack per padded row
    n_zero = n_pad - n - n_slack         # dead columns
    A_p = np.zeros((m_pad, n_pad))
    A_p[:m, :n] = A
    # padded rows: s_i = 1
    for i in range(extra_rows):
        A_p[m + i, n + i] = 1.0
    b_p = np.concatenate([b, np.ones(extra_rows)])
    c_p = np.concatenate([c, np.zeros(n_slack), np.ones(n_zero)])
    return PaddedLP(c=c_p, A=A_p, b=b_p, m_orig=m, n_orig=n)


def bucket_lps(problems: Sequence[tuple], m_multiple: int = 32,
               n_multiple: int = 64) -> dict:
    """Group (c, A, b) triples into shape buckets of padded LPs.

    Returns {(m_pad, n_pad): [(orig_index, PaddedLP), ...]} — each bucket's
    instances can be stacked and solved as one batch.
    """
    buckets: dict = {}
    for idx, (c, A, b) in enumerate(problems):
        m, n = np.asarray(A).shape
        mb, nb = bucket_shape(m, n, m_multiple, n_multiple)
        # ensure room for row slacks
        while nb < n + (mb - m):
            nb = _round_up(nb + n_multiple, n_multiple)
        buckets.setdefault((mb, nb), []).append(
            (idx, pad_lp(c, A, b, mb, nb)))
    return buckets
