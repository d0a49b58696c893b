"""Normal-equations linear-system layer, batched.

Per Mehrotra iteration the KKT system is reduced to

    (A D^2 A^T + reg I) dy = rhs,   D^2 = diag(x/s)

Assembly forms the lower triangle only.  The Jacobi-scaled regularized
matrix is factored by the backend ``opts.chol_backend`` names:

    "xla"           the library Cholesky, solved by two triangular solves
    "pallas_left"   the panel-major factor of ``kernels.cholesky``, which for
                    a 128-aligned bf16-stored A assembles the matrix inside
                    the factor kernels and never writes it
    "panels"        the same panel layout from library products between
                    diagonal-block kernels (:func:`_blocked_potrf_left_panels`)
    "pallas"        the right-looking kernel factor ``cholesky_batched``
    "blocked"       right-looking, library products (:func:`_blocked_potrf`)
    "blocked_left"  left-looking into a full L^T (:func:`_blocked_potrf_left`)
    "hybrid"        the library Cholesky with the diagonal blocks inverted
                    afterwards (:func:`_invert_lower_blocks`)

The last four keep a full ``LT = L^T`` of the matrix padded to a multiple of
128 and solve with ``chol_solve_batched_lt``; the panel layouts solve with
``chol_solve_batched_panels``.  The factor is reused for the predictor and
corrector solves, each a preconditioned CG whose operator is applied
matrix-free through A, or, with ``cg_operator="assembled"``, by streaming
the assembled matrix.  Every tensor has a leading batch dimension.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ipx_torch.kernels import cholesky as pk
from ipx_torch.kernels import fused as fk
from ipx_torch.linsys import products, schur
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

    Every backend but ``"xla"`` factors the matrix padded to a multiple of
    128 by an identity block and carries ``W``, the inverses of L's diagonal
    blocks (which turn the triangular solves into products), with either
    ``LTp``, suffix-only rows of L^T, or ``LT``, the full transposed factor;
    ``L`` is then empty.
    """
    L: torch.Tensor     # xla: (B, m, m) lower-triangular factor; else empty
    j: torch.Tensor     # (B, m) Jacobi scale 1/sqrt(diag M)
    d2: torch.Tensor    # (B, n)
    ok: torch.Tensor    # (B,) bool: factorization succeeded per instance
    W: torch.Tensor | None = None   # (B, m_pad/128, 128, 128), not on xla
    LTp: tuple = ()     # pallas_left, panels: LTp[k] (B, 128, m_pad - 128 k),
                        # rows 128 k .. 128 (k+1) of L^T from the diagonal
                        # on; m_pad (m_pad + 128) / 2 entries an instance, no
                        # (m, m) factor exists
    LT: torch.Tensor | None = None  # pallas, hybrid, blocked, blocked_left:
                        # (B, m_pad, m_pad) transposed factor L^T, the one
                        # stored layout: both sweeps of the pair-solve read
                        # its strict-suffix row stripes
    M: torch.Tensor | None = None   # (B, m, m) assembled matrix, unscaled and
                        # unregularized: the CG operator under
                        # cg_operator="assembled", else absent


def _augmented():
    """``linsys.augmented``, imported at first use: it builds its reduced
    system on this module, which imports it only to dispatch."""
    from ipx_torch.linsys import augmented
    return augmented


def assemble(A: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """M = (A * d2) @ A^T per instance, exploiting symmetry.

    A bf16-stored A, and an f32 A on the card, go through the hand-written
    tile kernels (``kernels.cholesky.assemble_sym_batched``: the tensor
    cores on exact bf16 splits, of the row operand for bf16 and of both
    operands for f32, summed in two levels as the summation rule asks, the
    diagonal on the CUDA cores; a library matmul sums each entry in one
    float32 chain).  Any other A takes :func:`_assemble_blocks`.
    """
    if A.dtype == torch.bfloat16 or (A.is_cuda and A.dtype == torch.float32):
        return pk.assemble_sym_batched(A.contiguous(),
                                       d2.to(torch.float32).contiguous())
    return _assemble_blocks(A, d2)


def _assemble_blocks(A: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """:func:`assemble` as a block-syrk recursion that forms only the lower
    triangle with library matmuls and mirrors the rest."""
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


def _library_cholesky(Ms: torch.Tensor):
    """``torch.linalg.cholesky_ex`` -> (L, info).  It does not raise on an
    element that is not positive definite: it reports it in ``info`` and
    leaves garbage (not NaN) in that element's factor, so ``ok`` has to
    carry the failure."""
    if Ms.is_cuda and Ms.shape[0] == 1:
        # A batch of one takes the library's unbatched factor routine, which
        # on the card is measurably less accurate in float32 than its batched
        # one: the same instance needs up to twice the iterations alone, or
        # stalls, and behaves as in a batch once its factor is made in
        # float64 or as one of two.  So a lone matrix is factored as a batch
        # of two views of itself.
        L, info = torch.linalg.cholesky_ex(Ms.expand(2, -1, -1),
                                           check_errors=False)
        return L[:1], info[:1]
    return torch.linalg.cholesky_ex(Ms, check_errors=False)


def factor(A: torch.Tensor, d2: torch.Tensor, opts: SolverOptions,
           reg_scale=1.0) -> NormalEqFactor:
    """Assemble, Jacobi-scale, and factor the regularized normal matrix.

    The Tikhonov term is added AFTER scaling (unit diagonal), so ``opts.reg``
    is a clean relative perturbation that the CG refinement, whose operator
    is the true unscaled, unregularized one, then removes.  ``reg_scale``
    ((B,) tensor or float) is the per-lane escalation factor
    (``IPMState.reg_boost``) raised after a non-finite step.

    On ``linsys="augmented"``, ``"augmented_schur"`` and ``"sharded_schur"``
    the factor is that route's (``linsys.augmented``), on ``"sharded"`` the
    distributed one (``linsys.schur``), so every caller, the starting point
    included, factors the system its route solves.
    """
    if opts.linsys == "sharded":
        return schur.factor(A, d2, opts, reg_scale)
    if opts.linsys == "augmented":
        return _augmented().factor(A, d2, opts, reg_scale)
    if opts.linsys in ("augmented_schur", "sharded_schur"):
        return _augmented().factor_schur(A, d2, opts, reg_scale)
    if opts.chol_backend != "xla":
        return _factor_blocked(A, d2, opts, reg_scale)
    M = assemble(A, d2)
    m = M.shape[-1]
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    tiny = torch.finfo(M.dtype).tiny
    j = torch.rsqrt(torch.clamp(diag, min=tiny))
    Ms = M * j.unsqueeze(2) * j.unsqueeze(1)
    reg = opts.reg * torch.as_tensor(reg_scale, dtype=M.dtype, device=M.device)
    eye = torch.eye(m, dtype=M.dtype, device=M.device)
    Ms = Ms + reg.reshape(-1, 1, 1) * eye
    L, info = _library_cholesky(Ms)
    ldiag = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = (torch.isfinite(ldiag).all(-1) & (ldiag > 0).all(-1)
          & torch.isfinite(j).all(-1) & (info == 0))
    return NormalEqFactor(L=L, j=j, d2=d2, ok=ok,
                          M=M if opts.cg_operator == "assembled" else None)


def _factor_blocked(A: torch.Tensor, d2: torch.Tensor, opts: SolverOptions,
                    reg_scale) -> NormalEqFactor:
    """``factor`` on every backend that carries W (float32 only).

    ``pallas_left`` with a 128-aligned bf16-stored A takes the fused assemble
    + factor: the Jacobi scale comes from diag(M) = (A o A) d2, one stream of
    A, and the scaled regularized matrix is assembled panel by panel inside
    the factor kernels (not under ``cg_operator="assembled"``, which needs
    the matrix).  Anything else is assembled, scaled and regularized here,
    padded to a multiple of 128 with an identity block (blkdiag(Ms, I)
    factors to blkdiag(L, I), and a zero-padded right-hand side round-trips
    exactly), and handed to the backend's factor.
    """
    backend = opts.chol_backend
    B, m, n = A.shape
    m_pad = -(-m // pk.NB) * pk.NB
    if m_pad > pk.MAX_M:
        # refused here, before any factor work: the factors would take it
        # and the first preconditioner apply would not
        raise ValueError(
            f'chol_backend="{backend}": m={m} (padded {m_pad}) exceeds '
            f"{pk.MAX_M}, the most the pair-solve kernel holds in shared "
            "memory (larger m needs a solve that tiles r and x: ROADMAP.md, "
            'large single LP); use chol_backend="xla"')
    f32 = torch.float32
    tiny = torch.finfo(f32).tiny
    d2f = d2.to(f32).contiguous()
    reg = (opts.reg * torch.as_tensor(reg_scale, dtype=f32, device=A.device)
           ).expand(B).contiguous()
    keep_m = opts.cg_operator == "assembled"
    M = LT = None
    info = 0
    if (backend == "pallas_left" and not keep_m
            and pk.fused_factor_fits(m, n, A.dtype)):
        diag = fk.a_matvec(A, d2f, square=True)
        j = torch.rsqrt(torch.clamp(diag, min=tiny))
        panels, W = pk.factor_fused_panels(A, d2f, j, reg)
    else:
        M = assemble(A, d2f).to(f32)
        diag = torch.diagonal(M, dim1=-2, dim2=-1)
        j = torch.rsqrt(torch.clamp(diag, min=tiny))
        Ms = M * j.unsqueeze(2) * j.unsqueeze(1)
        # reg I, added in place on the diagonal (Ms is this function's own)
        torch.diagonal(Ms, dim1=-2, dim2=-1).add_(reg.unsqueeze(-1))
        if m_pad != m:
            Mp = torch.zeros(B, m_pad, m_pad, dtype=f32, device=A.device)
            Mp[:, :m, :m] = Ms
            torch.diagonal(Mp, dim1=-2, dim2=-1)[:, m:] = 1.0
            Ms = Mp
        panels = ()
        if backend == "pallas_left":
            panels, W = pk.factor_lt_panels(Ms)
        elif backend == "panels":
            panels, W = _blocked_potrf_left_panels(Ms)
        elif backend == "blocked_left":
            LT, W = _blocked_potrf_left(Ms)
        else:
            if backend == "pallas":
                Lp, W = pk.cholesky_batched(Ms)
            elif backend == "blocked":
                Lp, W = _blocked_potrf(Ms)
            else:
                # hybrid: the library's factor; the inverses of its diagonal
                # blocks by the recursive combine below
                Lp, info = _library_cholesky(Ms)
                W = _w_of(lambda o: Lp[:, o:o + pk.NB, o:o + pk.NB], B, m_pad)
            # one transpose at factor time, none per solve
            LT = Lp.mT.contiguous()
    if LT is not None:
        ldiag = torch.diagonal(LT, dim1=-2, dim2=-1)
    else:
        ldiag = torch.cat([torch.diagonal(p[:, :, :pk.NB], dim1=-2, dim2=-1)
                           for p in panels], dim=-1)
    # a lane whose matrix is not positive definite shows here (the diagonal
    # kernel never raises); its factor is garbage of its own, no other lane
    # reads it
    ok = (torch.isfinite(ldiag).all(-1) & (ldiag > 0).all(-1)
          & torch.isfinite(j).all(-1) & (info == 0))
    return NormalEqFactor(L=torch.zeros(0, dtype=f32, device=A.device), j=j,
                          d2=d2, ok=ok, W=W, LTp=panels, LT=LT,
                          M=M if keep_m else None)


def _w_of(ldiag, B: int, m: int) -> torch.Tensor:
    """The (B, m / 128, 128, 128) inverses of the 128-blocks on the diagonal
    of a lower factor, ``ldiag(o)`` being the (B, 128, 128) block at offset
    o."""
    nblk = m // pk.NB
    blocks = torch.stack([ldiag(o) for o in range(0, m, pk.NB)], dim=1)
    return _invert_lower_blocks(blocks.reshape(B * nblk, pk.NB, pk.NB)
                                ).reshape(B, nblk, pk.NB, pk.NB)


def _blocked_potrf(Ms: torch.Tensor):
    """Right-looking blocked Cholesky with library products, panels of 128:
    Ms (B, m, m) -> (L, W), W the (B, m/128, 128, 128) inverses of L's
    diagonal blocks, a by-product of the panel steps.  Per panel: the
    diagonal block's factor and inverse, the panel TRSM as a product with
    the inverse, the trailing update."""
    B, m, _ = Ms.shape
    nb = pk.NB
    L = torch.zeros(B, m, m, dtype=Ms.dtype, device=Ms.device)
    W = torch.empty(B, m // nb, nb, nb, dtype=Ms.dtype, device=Ms.device)
    T = Ms
    for k, o in enumerate(range(0, m, nb)):
        e = o + nb
        pk.diag_factor_inv(T[:, :nb, :nb], L[:, o:e, o:e], W[:, k],
                           lower_out=True)
        if e < m:
            P = torch.bmm(T[:, nb:, :nb], W[:, k].mT)
            L[:, e:, o:e] = P
            T = T[:, nb:, nb:] - torch.bmm(P, P.mT)
    return L, W


def _blocked_potrf_left(Ms: torch.Tensor):
    """Left-looking blocked Cholesky returning the TRANSPOSED factor:
    Ms (B, m, m) -> (LT, W) with ``LT = L^T``, the layout the pair-solve
    consumes.  Updates are deferred: each panel reads the original row panel
    of Ms and the rows of LT already written,

        C^T = Ms[o:o+nb, o:] - LT[:o, o:o+nb]^T @ LT[:o, o:]
        P^T = inv(L_kk) @ C^T[:, nb:]

    so every product lands in LT's row panel with no transposition (Ms is
    symmetric: its row panel is the column panel transposed)."""
    B, m, _ = Ms.shape
    nb = pk.NB
    LT = torch.zeros(B, m, m, dtype=Ms.dtype, device=Ms.device)
    W = torch.empty(B, m // nb, nb, nb, dtype=Ms.dtype, device=Ms.device)
    for k, o in enumerate(range(0, m, nb)):
        e = o + nb
        Ct = Ms[:, o:e, o:]
        if o:
            Ct = Ct - torch.bmm(LT[:, :o, o:e].mT, LT[:, :o, o:])
        pk.diag_factor_inv(Ct[:, :, :nb], LT[:, o:e, o:e], W[:, k])
        if e < m:
            torch.bmm(W[:, k], Ct[:, :, nb:], out=LT[:, o:e, e:])
    return LT, W


def _blocked_potrf_left_panels(Ms: torch.Tensor):
    """Left-looking blocked Cholesky emitting the suffix-only transposed row
    panels directly: Ms (B, m, m) -> (panels, W), ``panels[k]`` (B, 128,
    m - 128 k), the layout ``chol_solve_batched_panels`` consumes.  The
    algebra of :func:`_blocked_potrf_left` without the (m, m) buffer: panel
    k's deferred accumulation reads each prior panel's aligned column slice,

        C^T = Ms[o:o+nb, o:] - sum_{i<k} P_i[:, o-i nb : o-i nb+nb]^T
                                         @ P_i[:, o-i nb:]
    """
    B, m, _ = Ms.shape
    nb = pk.NB
    kw = dict(dtype=Ms.dtype, device=Ms.device)
    W = torch.empty(B, m // nb, nb, nb, **kw)
    panels = []
    for k, o in enumerate(range(0, m, nb)):
        Ct = Ms[:, o:o + nb, o:]
        for i, p in enumerate(panels):
            off = o - i * nb
            Ct = Ct - torch.bmm(p[:, :, off:off + nb].mT, p[:, :, off:])
        P = torch.empty(B, nb, m - o, **kw)
        pk.diag_factor_inv(Ct[:, :, :nb], P[:, :, :nb], W[:, k])
        if m - o > nb:
            torch.bmm(W[:, k], Ct[:, :, nb:], out=P[:, :, nb:])
        panels.append(P)
    return tuple(panels), W


def _invert_lower_blocks(blocks: torch.Tensor, base: int = 32) -> torch.Tensor:
    """Inverse of (K, q, q) lower-triangular blocks by recursive 2 x 2
    splitting,  inv([[A,0],[B,C]]) = [[iA,0],[-iC B iA, iC]],  with a
    backward-stable library triangular solve at the base size."""
    K, q, _ = blocks.shape
    kw = dict(dtype=blocks.dtype, device=blocks.device)
    if q <= base:
        eye = torch.eye(q, **kw).expand(K, q, q)
        return torch.linalg.solve_triangular(blocks, eye, upper=False)
    h = q // 2
    iA = _invert_lower_blocks(blocks[:, :h, :h], base)
    iC = _invert_lower_blocks(blocks[:, h:, h:], base)
    off = -torch.bmm(iC, torch.bmm(blocks[:, h:, :h], iA))
    top = torch.cat([iA, torch.zeros(K, h, q - h, **kw)], dim=2)
    return torch.cat([top, torch.cat([off, iC], dim=2)], dim=1)


def matvecs(A: torch.Tensor, opts: SolverOptions):
    """(w -> A w, v -> A^T v) on the route ``opts.linsys``: through the
    ranks on the sharded routes (``schur.matvecs``), else this A's pair
    (``linsys.products``, which holds the rule), summed wide on the
    augmented routes."""
    if opts.linsys.startswith("sharded"):
        return schur.matvecs(A, wide=opts.linsys == "sharded_schur")
    return products.pair(
        A, "wide" if opts.linsys.startswith("augmented") else "working",
        products.use_fused_matvec(opts, A))


def _chol_solve(fac: NormalEqFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Dispatches on what the factor carries, not on the backend's name."""
    if fac.LTp or fac.LT is not None:
        m = rhs.shape[-1]
        m_pad = fac.LTp[0].shape[-1] if fac.LTp else fac.LT.shape[-1]
        r = (rhs if m_pad == m else F.pad(rhs, (0, m_pad - m))).contiguous()
        if fac.LTp:
            y = pk.chol_solve_batched_panels(fac.LTp, fac.W, r)
        else:
            y = pk.chol_solve_batched_lt(fac.LT, fac.W, r)
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

    With ``cg_operator="assembled"`` only the INITIAL residual is computed
    matrix-free (it sets the accuracy floor); the CG recurrences then stream
    the assembled m x m matrix ``fac.M``, a quarter of the bytes per
    iteration.

    On the augmented and sharded routes the solve goes through that route's
    factor.
    """
    if opts.linsys == "sharded":
        return schur.solve(fac, A, rhs, opts)
    if opts.linsys == "augmented":
        return _augmented().normal_solve(fac, A, rhs, opts)
    if opts.linsys in ("augmented_schur", "sharded_schur"):
        return _augmented().normal_solve_schur(fac, A, rhs, opts)
    tiny = torch.finfo(rhs.dtype).tiny

    if products.use_fused_matvec(opts, A):
        def op_true(v):
            # one A stream: stripe-fused A (d2 (A^T v))
            return fk.ata_apply(A, v, fac.d2, None)[0]
    else:
        fwd, tr = products.pair(A)

        def op_true(v):
            return fwd(fac.d2 * tr(v))

    if opts.cg_operator == "assembled":
        def op(v):
            return mv(fac.M, v)
    else:
        op = op_true

    def precond(r):
        # (J M J + reg I)^-1 in the original variables: J L^-T L^-1 J r
        return fac.j * _chol_solve(fac, fac.j * r)

    y = precond(rhs)
    if opts.refine_steps <= 0:
        return y
    r = rhs - op_true(y)
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
