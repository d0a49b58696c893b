"""The single-LP cell's instances, made on the host in float64 from a seed.

The known-optimum construction of ``gen.batch`` at one LP, with the two
features that make presolve necessary on Netlib-class data:

1. a base LP on ``m0 = m - duplicate_rows - combined_rows`` independent
   rows: A0 ~ N(0, 1/n), x0* uniform in [0.5, 2] on a random support of m0
   columns, s0* uniform in [0.5, 2] on the other n - m0, y0* ~ N(0, 1);
2. redundant equality rows appended to it: ``duplicate_rows`` copies of
   distinct base rows times 2^k, k in [-3, 3], and ``combined_rows`` rows
   w1 A0[i] + w2 A0[j] (i != j, w ~ N(0, 1)), each with y* = 0; the m rows
   then permuted;
3. rows and columns scaled: A = D_r A D_c, D_r and D_c = 10^U(-d, d) with
   d = ``scale_log10``, and the optimum carried along: x* = D_c^-1 x0*,
   s* = D_c s0*, y* = D_r^-1 y0*;
4. b = A x* and c = A^T y* + s*, in float64.

c.x* is then the LP's optimum, unique, and non-degenerate once the
redundant rows are dropped (x* and s* strictly complementary on m0 = rank
columns).  Imports numpy and torch only: the yardstick takes nothing from
the program.
"""
from __future__ import annotations

import numpy as np
import torch

from lpbench import gen


def instance(cfg: dict, seed: int, call: int) -> dict:
    """One LP of ``cfg``'s shape as float64 numpy arrays: c (n,), A (m, n),
    b (m,), x_star (n,), y_star (m,), s_star (n,), and ``redundant`` (m,)
    True on the appended rows."""
    m, n = cfg["m"], cfg["n"]
    n_dup, n_comb = cfg["duplicate_rows"], cfg["combined_rows"]
    m0 = m - n_dup - n_comb
    if not 0 < m0 <= n:
        raise ValueError(f"{n_dup} + {n_comb} redundant rows of m={m} leave "
                         f"no base LP of n={n} columns")
    rng = np.random.default_rng(gen.call_seed(seed, call))
    A0 = rng.standard_normal((m0, n)) / np.sqrt(n)
    perm = rng.permutation(n)
    x0 = np.zeros(n)
    x0[perm[:m0]] = rng.uniform(0.5, 2.0, m0)
    s0 = np.zeros(n)
    s0[perm[m0:]] = rng.uniform(0.5, 2.0, n - m0)
    y0 = rng.standard_normal(m0)

    dup = rng.choice(m0, n_dup, replace=False)
    twos = np.exp2(rng.integers(-3, 4, n_dup).astype(np.float64))
    pairs = np.array([rng.choice(m0, 2, replace=False)
                      for _ in range(n_comb)], dtype=np.int64).reshape(-1, 2)
    w = rng.standard_normal((n_comb, 2))
    A = np.vstack([A0, twos[:, None] * A0[dup],
                   w[:, :1] * A0[pairs[:, 0]] + w[:, 1:] * A0[pairs[:, 1]]])
    y = np.concatenate([y0, np.zeros(m - m0)])
    redundant = np.arange(m) >= m0
    rows = rng.permutation(m)
    A, y, redundant = A[rows], y[rows], redundant[rows]

    d = cfg["scale_log10"]
    dr = 10.0 ** rng.uniform(-d, d, m)
    dc = 10.0 ** rng.uniform(-d, d, n)
    A = dr[:, None] * A * dc[None, :]
    x, s, y = x0 / dc, s0 * dc, y / dr
    return dict(c=A.T @ y + s, A=A, b=A @ x, x_star=x, y_star=y, s_star=s,
                redundant=redundant)


def batch_of_one(cfg: dict, seed: int, call: int) -> dict:
    """:func:`instance` as the reference takes a call's inputs: float64 CPU
    tensors with a leading batch axis of 1, and ``obj_offset`` 0."""
    lp = instance(cfg, seed, call)
    one = lambda a: torch.from_numpy(a).unsqueeze(0)
    return dict(c=one(lp["c"]), A=one(lp["A"]), b=one(lp["b"]),
                obj_offset=torch.zeros(1, dtype=torch.float64),
                x_star=one(lp["x_star"]), y_star=one(lp["y_star"]),
                s_star=one(lp["s_star"]))
