"""Augmented-system KKT solves, batched: the robustness routes of the rescue
ladder.

The normal-equations route squares the condition number: on primal-degenerate
problems (optimal support < m) cond(A D^2 A^T) ~ 1/mu^2, and the attainable
relative gap floors near sqrt(eps).  The quasi-definite augmented system

    K = [[-(S/X) - reg_p I,  A^T],
         [A,                 reg_d I]]

keeps cond ~ 1/mu.  Two routes solve it:

    "augmented"        an (n+m) LU of K per lane (``torch.linalg.lu_factor_ex``)
                       and ``refine_steps`` refinement sweeps against the
                       unregularized operator
    "augmented_schur"  the diagonal (1,1) block eliminated analytically:
                       H = S/X + reg_p I, dx = H^-1 (A^T dy - r1) and
                       (A H^-1 A^T + reg I) dy = r2 + A H^-1 r1, the reduced
                       m x m matrix factored by ``normal_eq.factor`` on the
                       dense route with the caller's ``chol_backend``, and
                       ``aug_schur_refine`` sweeps against the true augmented
                       operator

    "sharded_schur"    the Schur form of one large LP whose A the ranks hold
                       by columns: the reduced matrix assembled and factored
                       across ranks by ``linsys.schur`` (config 4's endgame)

H^-1 = x / (s + reg_p x) is capped at 1/reg_p, so the reduced matrix never
conditions like the raw x/s normal equations.  Every tensor has a leading
batch dimension; ``reg_scale`` is a per-lane (B,) tensor or a float.  The
products with A are summed in float64 and rounded once, as are the
residuals ``ipm.mehrotra`` measures on these routes (``normal_eq.matvecs``;
``linsys.products`` gives the rule).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ipx_torch.linsys import normal_eq
from ipx_torch.linsys.normal_eq import NormalEqFactor
from ipx_torch.options import SolverOptions


@dataclass(frozen=True)
class AugFactor:
    """LU factorization of the regularized augmented matrix, per lane."""
    lu: torch.Tensor    # (B, n+m, n+m) packed LU
    piv: torch.Tensor   # (B, n+m) int32 pivots
    d2: torch.Tensor    # (B, n) the X/S scaling the factor was built with
    ok: torch.Tensor    # (B,) bool


def factor(A: torch.Tensor, d2: torch.Tensor, opts: SolverOptions,
           reg_scale=1.0) -> AugFactor:
    """Build K in the compute dtype and LU-factor it.  A bf16-stored A is
    upcast: the LU and its right-hand sides must agree, and a bf16 K would
    be useless."""
    if A.dtype == torch.bfloat16:
        A = A.to(d2.dtype)
    B, m, n = A.shape
    dt = A.dtype
    reg = (torch.as_tensor(opts.aug_reg, dtype=dt, device=A.device)
           * torch.as_tensor(reg_scale, dtype=dt, device=A.device)
           ).expand(B).unsqueeze(-1)
    tiny = torch.finfo(dt).tiny
    inv_d2 = 1.0 / torch.clamp(d2, min=tiny)          # = s/x
    K = torch.zeros(B, n + m, n + m, dtype=dt, device=A.device)
    torch.diagonal(K[:, :n, :n], dim1=-2, dim2=-1).copy_(-inv_d2 - reg)
    K[:, :n, n:] = A.mT
    K[:, n:, :n] = A
    torch.diagonal(K[:, n:, n:], dim1=-2, dim2=-1).copy_(reg.expand(B, m))
    # the _ex form reports a singular pivot in its info instead of raising,
    # so no host read waits on it; ok is taken from the factor itself
    lu, piv, _ = torch.linalg.lu_factor_ex(K)
    ok = (torch.isfinite(lu).all(-1).all(-1)
          & (torch.diagonal(lu, dim1=-2, dim2=-1).abs() > tiny).all(-1))
    return AugFactor(lu=lu, piv=piv, d2=d2, ok=ok)


def _apply_unreg(A, d2, dx, dy, opts: SolverOptions):
    """The true (unregularized) augmented operator applied to (dx, dy)."""
    fwd, tr = normal_eq.matvecs(A, opts)
    tiny = torch.finfo(d2.dtype).tiny
    inv_d2 = 1.0 / torch.clamp(d2, min=tiny)
    return -inv_d2 * dx + tr(dy), fwd(dx)


def _lu_solve(fac: AugFactor, rhs: torch.Tensor) -> torch.Tensor:
    return torch.linalg.lu_solve(fac.lu, fac.piv,
                                 rhs.unsqueeze(-1)).squeeze(-1)


def _solve_refined(fac: AugFactor, A, r1, r2, opts: SolverOptions):
    """LU solve + ``refine_steps`` sweeps against the unregularized
    operator."""
    n = A.shape[-1]
    sol = _lu_solve(fac, torch.cat([r1, r2], dim=-1))
    for _ in range(opts.refine_steps):
        a1, a2 = _apply_unreg(A, fac.d2, sol[:, :n], sol[:, n:], opts)
        sol = sol + _lu_solve(fac, torch.cat([r1 - a1, r2 - a2], dim=-1))
    return sol[:, :n], sol[:, n:]


def _newton(solve_refined, fac, A, x, s, e_p, e_d, e_xs, opts):
    """Newton direction (dx, dy, ds) for residuals (e_p, e_d, e_xs) through
    either route's refined solve."""
    xs = torch.clamp(x, min=torch.finfo(x.dtype).tiny)
    dx, dy = solve_refined(fac, A, -e_d + e_xs / xs, -e_p, opts)
    ds = (-e_xs - s * dx) / xs
    return dx, dy, ds


def solve_newton(fac: AugFactor, A, x, s, e_p, e_d, e_xs,
                 opts: SolverOptions):
    """Newton direction through the LU route."""
    return _newton(_solve_refined, fac, A, x, s, e_p, e_d, e_xs, opts)


def normal_solve(fac: AugFactor, A, rhs, opts: SolverOptions):
    """Solve (A D^2 A^T) y = rhs through the augmented factor: with r1 = 0,
    row 1 gives dx = D^2 A^T dy, row 2 then A D^2 A^T dy = rhs."""
    zeros = rhs.new_zeros(fac.d2.shape)
    return _solve_refined(fac, A, zeros, rhs, opts)[1]


# --------------------------------------------------------------------------
# Schur form ("augmented_schur")
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class AugSchurFactor:
    """Factor of the reduced matrix A H^-1 A^T + reg I."""
    ne: NormalEqFactor  # the reduced system's normal-equations factor
    d2p: torch.Tensor   # (B, n) H^-1 = x / (s + reg_p x), the capped scaling
    d2: torch.Tensor    # (B, n) true x/s (refinement operator)
    ok: torch.Tensor    # (B,)


def _inner_opts(opts: SolverOptions) -> SolverOptions:
    """The route the reduced m x m system runs on: the batched dense
    machinery for ``"augmented_schur"``, the distributed factor
    (``linsys.schur``) for ``"sharded_schur"``."""
    return opts.replace(
        linsys="sharded" if opts.linsys == "sharded_schur" else "dense")


def factor_schur(A: torch.Tensor, d2: torch.Tensor, opts: SolverOptions,
                 reg_scale=1.0) -> AugSchurFactor:
    """H^-1 = 1 / (1/d2 + reg_p) = d2 / (1 + reg_p d2), and the reduced
    matrix factored with the dense route's small relative reg: the capped
    d2p already bounds the conditioning, and a large inner reg cripples the
    inner PCG."""
    # reg_p is formed in A's stored dtype, as ipx forms it (bf16 rounds the
    # 1e-6 to 9.98e-7), then meets d2 in the compute dtype
    dt = A.dtype
    reg_p = (torch.as_tensor(opts.aug_reg, dtype=dt, device=A.device)
             * torch.as_tensor(reg_scale, dtype=dt, device=A.device))
    if reg_p.ndim:
        reg_p = reg_p.unsqueeze(-1)
    d2p = d2 / (1.0 + reg_p * d2)
    ne = normal_eq.factor(A, d2p, _inner_opts(opts), reg_scale=reg_scale)
    return AugSchurFactor(ne=ne, d2p=d2p, d2=d2, ok=ne.ok)


def _schur_apply(fac: AugSchurFactor, A, r1, r2, opts: SolverOptions):
    """One pass through the reduced system for the right-hand side
    (r1, r2)."""
    fwd, tr = normal_eq.matvecs(A, opts)
    dy = normal_eq.solve(fac.ne, A, r2 + fwd(fac.d2p * r1),
                         _inner_opts(opts))
    return fac.d2p * (tr(dy) - r1), dy


def _schur_solve_refined(fac: AugSchurFactor, A, r1, r2,
                         opts: SolverOptions):
    """Reduced-system solve + ``aug_schur_refine`` sweeps against the true
    augmented operator (no reg_p, no reg_d)."""
    dx, dy = _schur_apply(fac, A, r1, r2, opts)
    for _ in range(opts.aug_schur_refine):
        a1, a2 = _apply_unreg(A, fac.d2, dx, dy, opts)
        ddx, ddy = _schur_apply(fac, A, r1 - a1, r2 - a2, opts)
        dx, dy = dx + ddx, dy + ddy
    return dx, dy


def solve_newton_schur(fac: AugSchurFactor, A, x, s, e_p, e_d, e_xs,
                       opts: SolverOptions):
    """Newton direction through the reduced quasi-definite system."""
    return _newton(_schur_solve_refined, fac, A, x, s, e_p, e_d, e_xs, opts)


def normal_solve_schur(fac: AugSchurFactor, A, rhs, opts: SolverOptions):
    zeros = rhs.new_zeros(fac.d2.shape)
    return _schur_solve_refined(fac, A, zeros, rhs, opts)[1]
