"""Normal-equations linear-system layer, batched.

Per Mehrotra iteration the KKT system is reduced to

    (A D^2 A^T + reg I) dy = rhs,   D^2 = diag(x/s)

Assembly forms the lower triangle only; the Jacobi-scaled regularized matrix
is factored by the library Cholesky (``chol_backend="xla"``); the factor is
reused for the predictor and corrector solves, each a preconditioned CG
whose operator is applied matrix-free through A.  Every tensor has a leading
batch dimension.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ipx_torch.kernels import cholesky as pk
from ipx_torch.kernels import fused as fk
from ipx_torch.numerics import mm, mv, vdot
from ipx_torch.options import SolverOptions


@dataclass(frozen=True)
class NormalEqFactor:
    """Cholesky factor of the Jacobi-scaled normal matrix.

    L is the Cholesky factor of  J (A D^2 A^T) J + reg I  with
    J = diag(1/sqrt(diag(A D^2 A^T))).  The diagonal scaling removes the
    basic-vs-nonbasic scale disparity, so the factored matrix has unit
    diagonal: the Cholesky stays stable far deeper into the ill-conditioned
    endgame, and ``reg`` is meaningfully relative to 1.
    """
    L: torch.Tensor     # (B, m, m) lower-triangular factor
    j: torch.Tensor     # (B, m) Jacobi scale 1/sqrt(diag M)
    d2: torch.Tensor    # (B, n)
    ok: torch.Tensor    # (B,) bool: factorization succeeded per instance


def assemble(A: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """M = (A * d2) @ A^T per instance, exploiting symmetry.

    A bf16-stored A goes through the hand-written tile kernel
    (``kernels.cholesky.assemble_sym_batched``).  Any other A takes the
    block-syrk recursion below, which forms only the lower triangle with
    library matmuls and mirrors the rest.
    """
    if A.dtype == torch.bfloat16:
        return pk.assemble_sym_batched(A, d2.to(torch.float32).contiguous())
    m = A.shape[-2]

    def blk_mm(alo, ahi, blo, bhi):
        # (A*d2)[alo:ahi] @ A[blo:bhi]^T
        return mm(A[:, alo:ahi] * d2.unsqueeze(1), A[:, blo:bhi].mT)

    if m < 256:
        M = blk_mm(0, m, 0, m)
        return 0.5 * (M + M.mT)

    def sym(lo, hi):
        r = hi - lo
        if r <= 128:
            Mr = blk_mm(lo, hi, lo, hi)
            return 0.5 * (Mr + Mr.mT)
        h = r // 2
        C11 = sym(lo, lo + h)
        C22 = sym(lo + h, hi)
        C21 = blk_mm(lo + h, hi, lo, lo + h)
        return torch.cat([torch.cat([C11, C21.mT], dim=2),
                          torch.cat([C21, C22], dim=2)], dim=1)

    return sym(0, m)


def factor(A: torch.Tensor, d2: torch.Tensor, opts: SolverOptions,
           reg_scale=1.0) -> NormalEqFactor:
    """Assemble, Jacobi-scale, and factor the regularized normal matrix.

    The Tikhonov term is added AFTER scaling (unit diagonal), so ``opts.reg``
    is a clean relative perturbation that the CG refinement, whose operator
    is the true unscaled, unregularized one, then removes.  ``reg_scale``
    ((B,) tensor or float) is the per-lane escalation factor
    (``IPMState.reg_boost``) raised after a non-finite step.
    """
    M = assemble(A, d2)
    m = M.shape[-1]
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    tiny = torch.finfo(M.dtype).tiny
    j = torch.rsqrt(torch.clamp(diag, min=tiny))
    Ms = M * j.unsqueeze(2) * j.unsqueeze(1)
    reg = opts.reg * torch.as_tensor(reg_scale, dtype=M.dtype, device=M.device)
    eye = torch.eye(m, dtype=M.dtype, device=M.device)
    Ms = Ms + reg.reshape(-1, 1, 1) * eye
    # cholesky_ex does not raise on a non-PD element: it reports it in
    # ``info`` and leaves garbage (not NaN) in that element's factor, so
    # ``ok`` has to carry the failure.
    if Ms.is_cuda and Ms.shape[0] == 1:
        # A batch of one takes the library's unbatched factor routine, which
        # on the card is measurably less accurate in float32 than its batched
        # one: the same instance needs up to twice the iterations alone, or
        # stalls, and behaves as in a batch once its factor is made in
        # float64 or as one of two.  So a lone matrix is factored as a batch
        # of two views of itself.
        L, info = torch.linalg.cholesky_ex(Ms.expand(2, -1, -1),
                                           check_errors=False)
        L, info = L[:1], info[:1]
    else:
        L, info = torch.linalg.cholesky_ex(Ms, check_errors=False)
    ldiag = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = (torch.isfinite(ldiag).all(-1) & (ldiag > 0).all(-1)
          & torch.isfinite(j).all(-1) & (info == 0))
    return NormalEqFactor(L=L, j=j, d2=d2, ok=ok)


def use_fused_matvec(opts: SolverOptions, A: torch.Tensor) -> bool:
    """Whether A's products go through ``kernels.fused``: asked for by
    ``matvec_backend``, A stored f32 or bf16, dense route.  The shape plays
    no part: an A on the card whose rows the kernels cannot hold is refused
    by their wrapper, never handed to library matmuls instead."""
    if opts.matvec_backend != "fused":
        return False
    if A.dtype not in (torch.float32, torch.bfloat16):
        return False
    return opts.linsys == "dense"


def _chol_solve(fac: NormalEqFactor, rhs: torch.Tensor) -> torch.Tensor:
    t = torch.linalg.solve_triangular(fac.L, rhs.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(fac.L.mT, t, upper=True).squeeze(-1)


def solve(fac: NormalEqFactor, A: torch.Tensor, rhs: torch.Tensor,
          opts: SolverOptions) -> torch.Tensor:
    """Solve (A D^2 A^T) dy = rhs: preconditioned CG on the TRUE operator.

    The Cholesky factor of the Jacobi-scaled, regularized matrix is the
    preconditioner; the Krylov operator is applied matrix-free as
    ``A @ (d2 * (A^T @ v))``, bypassing both the Tikhonov perturbation and
    the assembled-M rounding.  ``opts.refine_steps`` is the CG iteration
    count, a fixed trip count with no convergence control flow.
    """
    tiny = torch.finfo(rhs.dtype).tiny

    if use_fused_matvec(opts, A):
        def op(v):
            # one A stream: stripe-fused A (d2 (A^T v))
            return fk.ata_apply(A, v, fac.d2, None)[0]
    else:
        def op(v):
            return mv(A, fac.d2 * mv(A.mT, v))

    def precond(r):
        # (J M J + reg I)^-1 in the original variables: J L^-T L^-1 J r
        return fac.j * _chol_solve(fac, fac.j * r)

    y = precond(rhs)
    if opts.refine_steps <= 0:
        return y
    r = rhs - op(y)
    z = precond(r)
    p = z
    rz = vdot(r, z)
    one = torch.ones_like(rz)
    zero = torch.zeros_like(rz)
    for i in range(opts.refine_steps):
        Ap = op(p)
        pAp = vdot(p, Ap)
        # pAp <= 0 only from rounding at exact convergence: freeze the
        # iteration there instead of dividing by ~0
        ok = pAp > tiny
        alpha = torch.where(ok, rz / torch.where(ok, pAp, one), zero)
        y = y + alpha.unsqueeze(-1) * p
        if i == opts.refine_steps - 1:
            # the remaining recurrences feed only a next iteration that
            # does not exist
            break
        r = r - alpha.unsqueeze(-1) * Ap
        z = precond(r)
        rz_new = vdot(r, z)
        ok_b = rz.abs() > tiny
        beta = torch.where(ok_b, rz_new / torch.where(ok_b, rz, one), zero)
        p = z + beta.unsqueeze(-1) * p
        rz = rz_new
    return y
