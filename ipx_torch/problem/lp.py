"""LP problem container on torch tensors.

``LP`` is the standard-form problem ``min c@x  s.t.  A@x = b, x >= 0``.  A
single instance has ``c (n,)``, ``A (m, n)``, ``b (m,)``; a batch carries a
leading dimension on every field (``c (B, n)``, ``A (B, m, n)``, ``b (B, m)``,
``obj_offset (B,)``).  The solver works on batches only: a single solve is a
batch of one (see ``ipx_torch.ipm.batched.stack_lps``).

``GeneralLP`` is the host-side (numpy) general form with inequalities and
bounds; ``to_standard_form`` converts it and records the ``Postsolve`` that
maps a standard-form solution back.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class LP:
    c: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    obj_offset: torch.Tensor    # added to c@x when reporting objectives

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    @property
    def n(self) -> int:
        # c's width, not A's: on the sharded route a rank holds a column
        # block of A and the whole of c (``ipx_torch.mesh``)
        return self.c.shape[-1]

    def astype(self, dtype: torch.dtype) -> "LP":
        return LP(c=self.c.to(dtype), A=self.A.to(dtype), b=self.b.to(dtype),
                  obj_offset=self.obj_offset.to(dtype))

    def to(self, device) -> "LP":
        return LP(c=self.c.to(device), A=self.A.to(device),
                  b=self.b.to(device), obj_offset=self.obj_offset.to(device))

    def with_a_storage(self, opts) -> "LP":
        """Apply ``SolverOptions.a_storage``: store A in bf16.

        The cast is the only place the storage dtype enters: b, c, the
        iterates and every contraction stay f32, and the kernels upcast A in
        registers.  Idempotent; a no-op for ``a_storage='float32'``.
        """
        if opts.a_storage == "bfloat16" and self.A.dtype != torch.bfloat16:
            return dataclasses.replace(self, A=self.A.to(torch.bfloat16))
        return self


def make_lp(c, A, b, obj_offset=0.0, dtype: torch.dtype | None = None,
            device="cuda") -> LP:
    """Build a single-instance ``LP`` from array-likes on ``device``."""
    c = torch.as_tensor(c, dtype=dtype, device=device)
    A = torch.as_tensor(A, dtype=dtype, device=device)
    b = torch.as_tensor(b, dtype=dtype, device=device)
    if A.ndim != 2 or c.ndim != 1 or b.ndim != 1:
        raise ValueError(f"bad LP shapes: c{tuple(c.shape)} "
                         f"A{tuple(A.shape)} b{tuple(b.shape)}")
    if tuple(A.shape) != (b.shape[0], c.shape[0]):
        raise ValueError(f"inconsistent LP shapes: c{tuple(c.shape)} "
                         f"A{tuple(A.shape)} b{tuple(b.shape)}")
    off = torch.as_tensor(obj_offset, dtype=c.dtype, device=device)
    return LP(c=c, A=A, b=b, obj_offset=off)



# ---------------------------------------------------------------------------
# General form (host side, numpy) and standard-form conversion
# ---------------------------------------------------------------------------


@dataclass
class GeneralLP:
    """Host-side general LP:

        min  c@x + obj_offset
        s.t. A_ub @ x <= b_ub
             A_eq @ x == b_eq
             lb <= x <= ub      (entries may be -inf / +inf)

    Defaults follow scipy.optimize.linprog: lb = 0, ub = +inf.
    ``obj_offset`` is a constant term in the minimize-form objective (e.g.
    an RHS entry on an MPS objective row).
    """

    c: np.ndarray
    A_ub: Optional[np.ndarray] = None
    b_ub: Optional[np.ndarray] = None
    A_eq: Optional[np.ndarray] = None
    b_eq: Optional[np.ndarray] = None
    lb: Optional[np.ndarray] = None
    ub: Optional[np.ndarray] = None
    name: str = ""
    obj_offset: float = 0.0

    def __post_init__(self):
        self.c = np.asarray(self.c, np.float64)
        self.obj_offset = float(self.obj_offset)
        n = self.c.shape[0]
        if self.A_ub is None:
            self.A_ub = np.zeros((0, n))
            self.b_ub = np.zeros((0,))
        self.A_ub = np.asarray(self.A_ub, np.float64).reshape(-1, n)
        self.b_ub = np.asarray(self.b_ub, np.float64).reshape(-1)
        if self.A_eq is None:
            self.A_eq = np.zeros((0, n))
            self.b_eq = np.zeros((0,))
        self.A_eq = np.asarray(self.A_eq, np.float64).reshape(-1, n)
        self.b_eq = np.asarray(self.b_eq, np.float64).reshape(-1)
        self.lb = (np.zeros(n) if self.lb is None
                   else np.asarray(self.lb, np.float64).reshape(-1).copy())
        self.ub = (np.full(n, np.inf) if self.ub is None
                   else np.asarray(self.ub, np.float64).reshape(-1).copy())

    @property
    def n(self) -> int:
        return self.c.shape[0]


@dataclass
class Postsolve:
    """Recovers original-variable values from standard-form solutions.

    Conversion recipe recorded by :func:`to_standard_form`:
    original x_j = sign_j * z_{col_j} (+ z_{neg_col_j} * -1 if free split)
                   + shift_j
    """

    n_orig: int
    # per original variable: index of its (primary) standard-form column
    col: np.ndarray
    # for free variables, index of the negative-part column (-1 otherwise)
    neg_col: np.ndarray
    # +1 / -1: whether the column carries x_j or -x_j
    sign: np.ndarray
    # constant shift (finite lower bound, or finite upper bound when flipped)
    shift: np.ndarray
    obj_offset: float
    n_std: int
    m_std: int
    name: str = ""

    def x_orig(self, z: np.ndarray) -> np.ndarray:
        z = np.asarray(z, np.float64)
        x = self.sign * z[self.col] + self.shift
        free = self.neg_col >= 0
        if np.any(free):
            x[free] -= z[self.neg_col[free]]
        return x


def to_standard_form(glp: GeneralLP):
    """Convert a :class:`GeneralLP` to standard form (host-side numpy).

    Per-variable handling (reference component R2, SURVEY.md §2.1):
      * finite lb:            x = z + lb,      z >= 0
      * lb=-inf, finite ub:   x = ub - z,      z >= 0  (column negated)
      * free (both inf):      x = z+ - z-,     z+, z- >= 0
      * finite lb and ub:     shift by lb, extra row  z + w = ub - lb
    Inequalities gain slack columns: ``[A_ub I] [z; w] = b_ub'``.

    Returns ``(c, A, b, obj_offset, Postsolve)`` as numpy float64 arrays.
    """
    n = glp.n
    lb, ub = glp.lb, glp.ub
    if np.any(lb > ub):
        raise ValueError("infeasible bounds: lb > ub")

    # --- variable transforms ------------------------------------------------
    col = np.zeros(n, np.int64)
    neg_col = np.full(n, -1, np.int64)
    sign = np.ones(n, np.float64)
    shift = np.zeros(n, np.float64)

    cols = []          # list of (orig_var_index, sign) building std columns
    ub_rows = []       # (std_col, rhs) upper-bound rows to append
    obj_offset = 0.0

    for j in range(n):
        lo, hi = lb[j], ub[j]
        if np.isfinite(lo):
            # x = z + lo
            col[j] = len(cols)
            sign[j] = 1.0
            shift[j] = lo
            cols.append((j, 1.0))
            obj_offset += glp.c[j] * lo
            if np.isfinite(hi):
                ub_rows.append((col[j], hi - lo))
        elif np.isfinite(hi):
            # x = hi - z
            col[j] = len(cols)
            sign[j] = -1.0
            shift[j] = hi
            cols.append((j, -1.0))
            obj_offset += glp.c[j] * hi
        else:
            # free: x = z+ - z-
            col[j] = len(cols)
            cols.append((j, 1.0))
            neg_col[j] = len(cols)
            cols.append((j, -1.0))
            sign[j] = 1.0
            shift[j] = 0.0

    n_z = len(cols)
    # Column matrix T mapping std z-columns back: x = T-ish; build A_z = A @ T
    # directly by scattering signed original columns.
    def expand(Amat):
        out = np.zeros((Amat.shape[0], n_z))
        for k, (j, sgn) in enumerate(cols):
            out[:, k] += sgn * Amat[:, j]
        return out

    c_z = np.zeros(n_z)
    for k, (j, sgn) in enumerate(cols):
        c_z[k] += sgn * glp.c[j]

    A_ub_z = expand(glp.A_ub)
    A_eq_z = expand(glp.A_eq)
    # rhs adjusted for shifts: A@x = A@(T z) + A@shift
    b_ub_z = glp.b_ub - glp.A_ub @ shift
    b_eq_z = glp.b_eq - glp.A_eq @ shift

    # --- append upper-bound rows as inequalities  z_k <= r ------------------
    if ub_rows:
        rows = np.zeros((len(ub_rows), n_z))
        rhs = np.zeros(len(ub_rows))
        for i, (k, r) in enumerate(ub_rows):
            rows[i, k] = 1.0
            rhs[i] = r
        A_ub_z = np.vstack([A_ub_z, rows])
        b_ub_z = np.concatenate([b_ub_z, rhs])

    m_ub, m_eq = A_ub_z.shape[0], A_eq_z.shape[0]
    m = m_ub + m_eq
    n_std = n_z + m_ub

    A = np.zeros((m, n_std))
    A[:m_eq, :n_z] = A_eq_z
    A[m_eq:, :n_z] = A_ub_z
    A[m_eq:, n_z:] = np.eye(m_ub)   # slack columns
    b = np.concatenate([b_eq_z, b_ub_z])
    c = np.concatenate([c_z, np.zeros(m_ub)])

    post = Postsolve(
        n_orig=n, col=col, neg_col=neg_col, sign=sign, shift=shift,
        obj_offset=float(obj_offset), n_std=n_std, m_std=m, name=glp.name,
    )
    return c, A, b, float(obj_offset), post
