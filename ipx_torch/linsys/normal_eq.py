"""Normal-equations linear-system layer, batched.

Per Mehrotra iteration the KKT system is reduced to

    (A D^2 A^T + reg I) dy = rhs,   D^2 = diag(x/s)

Assembly forms the lower triangle only.  The Jacobi-scaled regularized
matrix is factored either by the library Cholesky (``chol_backend="xla"``)
or by the panel-major factor of ``kernels.cholesky``
(``chol_backend="pallas_left"``), which for a 128-aligned bf16-stored A
assembles the matrix inside the factor kernels and never writes it.  The
factor is reused for the predictor and corrector solves, each a
preconditioned CG whose operator is applied matrix-free through A.  Every
tensor has a leading batch dimension.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

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

    With ``chol_backend="pallas_left"`` the factor is panel-major: ``LTp``
    holds suffix-only rows of L^T of the matrix padded to a multiple of 128
    by an identity block, ``W`` the inverses of L's diagonal blocks (which
    turn the triangular solves into products), and ``L`` is empty.
    """
    L: torch.Tensor     # xla: (B, m, m) lower-triangular factor; empty for
                        # pallas_left
    j: torch.Tensor     # (B, m) Jacobi scale 1/sqrt(diag M)
    d2: torch.Tensor    # (B, n)
    ok: torch.Tensor    # (B,) bool: factorization succeeded per instance
    W: torch.Tensor | None = None   # pallas_left: (B, m_pad/128, 128, 128)
    LTp: tuple = ()     # pallas_left: LTp[k] (B, 128, m_pad - 128 k), rows
                        # 128 k .. 128 (k+1) of L^T from the diagonal on;
                        # m_pad (m_pad + 128) / 2 entries an instance, no
                        # (m, m) factor exists


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
    if opts.chol_backend == "pallas_left":
        return _factor_pallas_left(A, d2, opts, reg_scale)
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


def _factor_pallas_left(A: torch.Tensor, d2: torch.Tensor,
                        opts: SolverOptions, reg_scale) -> NormalEqFactor:
    """``factor`` on the panel-major route (float32 only).

    A 128-aligned bf16-stored A takes the fused assemble + factor: the
    Jacobi scale comes from diag(M) = (A o A) d2, one stream of A, and the
    scaled regularized matrix is assembled panel by panel inside the factor
    kernels.  Any other A is assembled, scaled and regularized here, padded
    to a multiple of 128 with an identity block (blkdiag(Ms, I) factors to
    blkdiag(L, I), and a zero-padded right-hand side round-trips exactly),
    and factored from the assembled matrix.
    """
    B, m, n = A.shape
    m_pad = -(-m // pk.NB) * pk.NB
    if m_pad > pk.MAX_M:
        # refused here, before any factor work: the factor kernels would take
        # it and the first preconditioner apply would not
        raise ValueError(
            f'chol_backend="pallas_left": m={m} (padded {m_pad}) exceeds '
            f"{pk.MAX_M}, the most the pair-solve kernel holds in shared "
            "memory (larger m needs a solve that tiles r and x: ROADMAP.md, "
            'large single LP); use chol_backend="xla"')
    f32 = torch.float32
    tiny = torch.finfo(f32).tiny
    d2f = d2.to(f32).contiguous()
    reg = (opts.reg * torch.as_tensor(reg_scale, dtype=f32, device=A.device)
           ).expand(B).contiguous()
    if pk.fused_factor_fits(m, n, A.dtype):
        diag = fk.a_matvec(A, d2f, square=True)
        j = torch.rsqrt(torch.clamp(diag, min=tiny))
        panels, W = pk.factor_fused_panels(A, d2f, j, reg)
    else:
        M = assemble(A, d2f).to(f32)
        diag = torch.diagonal(M, dim1=-2, dim2=-1)
        j = torch.rsqrt(torch.clamp(diag, min=tiny))
        Ms = M * j.unsqueeze(2) * j.unsqueeze(1)
        # reg I, added in place on the diagonal (M is this function's own)
        torch.diagonal(Ms, dim1=-2, dim2=-1).add_(reg.unsqueeze(-1))
        if m_pad != m:
            Mp = torch.zeros(B, m_pad, m_pad, dtype=f32, device=A.device)
            Mp[:, :m, :m] = Ms
            torch.diagonal(Mp, dim1=-2, dim2=-1)[:, m:] = 1.0
            Ms = Mp
        panels, W = pk.factor_lt_panels(Ms)
    ldiag = torch.cat([torch.diagonal(p[:, :, :pk.NB], dim1=-2, dim2=-1)
                       for p in panels], dim=-1)
    # a lane whose matrix is not positive definite shows here (the diagonal
    # kernel never raises); its panels are garbage of its own, no other
    # lane reads them
    ok = (torch.isfinite(ldiag).all(-1) & (ldiag > 0).all(-1)
          & torch.isfinite(j).all(-1))
    return NormalEqFactor(L=torch.zeros(0, dtype=f32, device=A.device), j=j,
                          d2=d2, ok=ok, W=W, LTp=panels)


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
    if fac.LTp:
        m, m_pad = rhs.shape[-1], fac.LTp[0].shape[-1]
        r = rhs if m_pad == m else F.pad(rhs, (0, m_pad - m))
        y = pk.chol_solve_batched_panels(fac.LTp, fac.W, r.contiguous())
        return y[:, :m]
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
