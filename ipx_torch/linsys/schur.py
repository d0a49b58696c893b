"""Normal equations of one large LP across ranks (config 4: m=32k, n=64k).

  * A is held by COLUMNS: rank i of the mesh's "row" axis holds the column
    block A_i (m, n/p); every n-vector (x, s, c, d2) is whole on every rank.
    A.w is each rank's A_i w_i, all-reduced; A^T v is each rank's A_i^T v,
    all-gathered (:func:`matvecs`).
  * Each rank assembles its partial  (A_i o d2_i) A_i^T  (the assembly kernel
    on the card) and a reduce-scatter leaves it the sum's ROW PANEL (m/p
    rows); the Jacobi scale comes from the all-reduced diagonal
    (:func:`_diag_scan`).  M is never formed on one rank when p > 1.
  * A right-looking blocked Cholesky across ranks (:func:`_dist_cholesky`):
    step k broadcasts the diagonal block, every rank factors it, the ranks
    below solve their block of column k through W, the block column is
    all-gathered and each rank updates its own rows.  At p = 1 the whole
    matrix is one diagonal block, factored by the left-looking kernel factor
    into L^T.
  * Every triangular solve is a substitution through W, the inverses of the
    factor's 128-blocks on the diagonal (the whole mp block when mp is not a
    multiple of 128): p outer steps, each broadcasting one rank's m/p
    entries.
  * The direction solve is preconditioned CG on the true operator through
    the column-held A, the distributed factor the preconditioner: the
    structure of ``normal_eq.solve``.

Each rank runs the same program on its own shard, with explicit collectives
on the "row" group where ``ipx`` has ``shard_map`` and ``psum``.  Every value
that steers control flow (the loop's exit, ``ok``) is replicated, so every
rank takes the same branches.  The route is selected with
``SolverOptions(linsys="sharded")``; the mesh is the one :func:`use_mesh`
makes active.  The LP is a batch of one.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ipx_torch.kernels import cholesky as pk
from ipx_torch.mesh import ROW_AXIS, Mesh
from ipx_torch.numerics import COPY_BYTES, mv, mv64
from ipx_torch.options import SolverOptions

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "ipx_torch_schur_mesh", default=None)

_NB = pk.NB     # diagonal blocking of the factor (W's blocks)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the one the sharded factor, solve and products use."""
    tok = _ACTIVE_MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.reset(tok)


def active_mesh() -> Mesh:
    mesh = _ACTIVE_MESH.get()
    if mesh is None:
        raise RuntimeError(
            "linsys='sharded' requires an active mesh: wrap the call in "
            "ipx_torch.linsys.schur.use_mesh(mesh) (ipx_torch.api.solve_large "
            "does).")
    return mesh


@dataclass(frozen=True)
class _Row:
    """This rank's place on the "row" axis: p ranks, index i, the group
    (None in a one-process mesh: no collective runs)."""
    p: int
    i: int
    group: object


def _row() -> _Row:
    mesh = active_mesh()
    return _Row(mesh.shape[ROW_AXIS], mesh.coords[ROW_AXIS],
                mesh.groups[ROW_AXIS])


def _all_reduce(t: torch.Tensor, row: _Row) -> torch.Tensor:
    """The sum of ``t`` over the row group, on every rank (in place)."""
    if row.group is not None:
        dist.all_reduce(t, group=row.group)
    return t


def _all_gather_rows(t: torch.Tensor, row: _Row) -> torch.Tensor:
    """(r, k) on each rank -> (p r, k), the ranks' blocks in rank order."""
    if row.group is None:
        return t
    out = torch.empty((row.p * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=row.group)
    return out


def _broadcast(t: torch.Tensor, k: int, row: _Row) -> torch.Tensor:
    """Rank k's ``t`` on every rank (in place)."""
    if row.group is not None:
        dist.broadcast(t, dist.get_global_rank(row.group, k), group=row.group)
    return t


def matvecs(A: torch.Tensor, wide: bool = False):
    """(w -> A w, v -> A^T v) for the LP whose column block ``A`` (B, m,
    n/p) this rank holds, every vector whole on every rank: the local
    product, then an all-reduce (an m-vector) or an all-gather (an
    n-vector).  ``wide`` sums in float64 (``"sharded_schur"``, as the
    augmented routes sum) through the all-reduce, and rounds once."""
    row = _row()
    nl = A.shape[-1]
    lo = row.i * nl
    prod = mv64 if wide else mv

    def fwd(w):
        y = prod(A, w[..., lo:lo + nl])
        return _all_reduce(y, row).to(w.dtype)

    def tr(v):
        t = prod(A.mT, v).to(v.dtype)
        if row.group is None:
            return t
        B = t.shape[0]
        g = _all_gather_rows(t, row)                    # (p B, nl)
        return g.view(row.p, B, nl).transpose(0, 1).reshape(B, row.p * nl)

    return fwd, tr


@dataclass(frozen=True)
class SchurFactor:
    """Distributed Cholesky factor of  J (A D^2 A^T) J + reg I.

    ``L`` is, at p = 1, the transposed factor L^T (m, m); at p > 1 this
    rank's row panel of L (m/p, m), zeros right of its diagonal block.
    ``W`` holds the inverses of the factor's diagonal blocks (m / w, w, w),
    w = 128 when m/p allows, else m/p, on every rank.  ``j`` is the Jacobi
    scale, ``d2`` the scaling (whole on every rank), ``ok`` per lane (a
    batch of one)."""
    L: torch.Tensor
    W: torch.Tensor
    j: torch.Tensor     # (1, m)
    d2: torch.Tensor    # (1, n)
    ok: torch.Tensor    # (1,) bool


def _dblk(mp: int) -> int:
    """W's block width: 128 when mp allows, else the whole mp block."""
    return _NB if mp % _NB == 0 else mp


def _diag_scan(A_loc: torch.Tensor, d2_loc: torch.Tensor) -> torch.Tensor:
    """(A_loc o A_loc) d2_loc, (m,), in A's compute dtype (f32 for a bf16
    A), a block of A's columns at a time (no (m, n) temporary)."""
    m, nl = A_loc.shape
    dt = d2_loc.dtype
    w = max(1, min(nl, COPY_BYTES // (m * dt.itemsize)))
    acc = torch.zeros(m, dtype=dt, device=A_loc.device)
    for c in range(0, nl, w):
        Ab = A_loc[:, c:c + w].to(dt)
        acc += torch.mv(Ab * Ab, d2_loc[c:c + w])
    return acc


def _factor_block(Mkk: torch.Tensor):
    """Cholesky of one (mp, mp) SPD block -> (L^T, W, ok): the kernel
    factor (row 10 with the diagonal kernel; its plain version on the CPU)
    for a float32 block of 128-multiple width, else the library Cholesky
    and the inverses of its diagonal blocks."""
    from ipx_torch.linsys.normal_eq import _invert_lower_blocks
    mp = Mkk.shape[0]
    w = _dblk(mp)
    if Mkk.dtype == torch.float32 and w == _NB:
        LT, W = pk.factor_lt_batched(Mkk.unsqueeze(0))
        LT, W = LT[0], W[0]
        ok = torch.ones((), dtype=torch.bool, device=Mkk.device)
    else:
        L, info = torch.linalg.cholesky_ex(Mkk)
        LT = L.mT.contiguous()
        blocks = torch.stack([L[o:o + w, o:o + w] for o in range(0, mp, w)])
        W = _invert_lower_blocks(blocks, base=min(32, w))
        ok = info == 0
    ld = torch.diagonal(LT)
    return LT, W, ok & torch.isfinite(ld).all() & (ld > 0).all()


def _blk_trisolve_right(Bm: torch.Tensor, LTkk: torch.Tensor,
                        Wb: torch.Tensor) -> torch.Tensor:
    """X = Bm inv(L_kk)^T for (r, mp) Bm, from L_kk's transposed factor and
    its block inverses, in ascending column blocks:

        X_j = (Bm_j - X[:, :oj] LT[:oj, j-block]) W_j^T
    """
    w = Wb.shape[-1]
    X = torch.empty_like(Bm)
    for jb in range(Wb.shape[0]):
        o, e = jb * w, jb * w + w
        acc = Bm[:, o:e]
        if o:
            acc = acc - X[:, :o] @ LTkk[:o, o:e]
        torch.matmul(acc, Wb[jb].mT, out=X[:, o:e])
    return X


def _dist_cholesky(panel: torch.Tensor, row: _Row, mp: int):
    """Right-looking blocked Cholesky of the row-panel-distributed matrix:
    ``panel`` is this rank's (mp, m) rows of the SPD matrix (overwritten).
    Returns (L, W, ok): at p = 1 the factor transposed, else this rank's
    rows of L; W and ok are the same on every rank (every rank factors
    every diagonal block from the same broadcast bits)."""
    p, i = row.p, row.i
    m = panel.shape[1]
    if p == 1:
        return _factor_block(panel)
    Lp = torch.zeros_like(panel)
    ws, ok = [], None
    for k in range(p):
        o, e = k * mp, (k + 1) * mp
        blk = panel[:, o:e]
        Mkk = blk.contiguous() if i == k else torch.empty_like(blk)
        LTkk, Wb, ok_k = _factor_block(_broadcast(Mkk, k, row))
        ws.append(Wb)
        ok = ok_k if ok is None else ok & ok_k
        if i > k:
            Lik = _blk_trisolve_right(blk, LTkk, Wb)
        elif i == k:
            Lik = LTkk.mT
        else:
            Lik = torch.zeros_like(blk)
        col = _all_gather_rows(Lik, row)                 # (m, mp)
        if i > k:
            # the trailing update of this rank's rows, lower blocks only
            hi = (i + 1) * mp
            panel[:, e:hi] -= Lik @ col[e:hi].mT
        Lp[:, o:e] = Lik
    return Lp, torch.cat(ws), ok


def _lower_block(Lkk, rk, Wk):
    """Solve L_kk y = rk by substitution through the block inverses Wk."""
    w = Wk.shape[-1]
    y = torch.empty_like(rk)
    for jb in range(Wk.shape[0]):
        o, e = jb * w, jb * w + w
        acc = rk[o:e] - Lkk[o:e, :o] @ y[:o] if o else rk[o:e]
        torch.mv(Wk[jb], acc, out=y[o:e])
    return y


def _upper_block(Lkk, rk, Wk):
    """Solve L_kk^T x = rk by substitution through the block inverses Wk."""
    w = Wk.shape[-1]
    mp = rk.shape[0]
    x = torch.empty_like(rk)
    for jb in reversed(range(Wk.shape[0])):
        o, e = jb * w, jb * w + w
        acc = rk[o:e] - Lkk[e:, o:e].mT @ x[e:] if e < mp else rk[o:e]
        torch.mv(Wk[jb].mT, acc, out=x[o:e])
    return x


def _dist_solve_lower(Lp, r, row: _Row, mp: int, Wd):
    """L y = r across ranks: step k, rank k solves its block from the
    prefix it holds and broadcasts it.  r and y whole on every rank."""
    nb = Wd.shape[0] // row.p
    y = torch.empty_like(r)
    for k in range(row.p):
        o, e = k * mp, (k + 1) * mp
        if row.i == k:
            rk = r[o:e] - Lp[:, :o] @ y[:o] if o else r[o:e]
            yk = _lower_block(Lp[:, o:e], rk, Wd[k * nb:(k + 1) * nb])
        else:
            yk = torch.empty(mp, dtype=r.dtype, device=r.device)
        y[o:e] = _broadcast(yk, k, row)
    return y


def _dist_solve_upper(Lp, r, row: _Row, mp: int, Wd):
    """L^T x = r across ranks: block row k of L^T is column block k of L,
    spread over the ranks below k; their contributions are all-reduced,
    then rank k solves its block and broadcasts it."""
    nb = Wd.shape[0] // row.p
    i = row.i
    x = torch.empty_like(r)
    for k in reversed(range(row.p)):
        o, e = k * mp, (k + 1) * mp
        rk = r[o:e]
        if k < row.p - 1:
            s = (Lp[:, o:e].mT @ x[i * mp:(i + 1) * mp] if i > k
                 else torch.zeros(mp, dtype=r.dtype, device=r.device))
            rk = rk - _all_reduce(s, row)
        if i == k:
            xk = _upper_block(Lp[:, o:e], rk, Wd[k * nb:(k + 1) * nb])
        else:
            xk = torch.empty(mp, dtype=r.dtype, device=r.device)
        x[o:e] = _broadcast(xk, k, row)
    return x


def _solve_lower_lt(LT, r, W):
    """L y = r from the transposed factor (p = 1): y_j = W_j r_j, then the
    rows below take L[e:, j] y_j = LT[j, e:]^T y_j, LT's own row panel."""
    w = W.shape[-1]
    m = r.shape[0]
    r = r.clone()
    y = torch.empty_like(r)
    for jb in range(W.shape[0]):
        o, e = jb * w, jb * w + w
        torch.mv(W[jb], r[o:e], out=y[o:e])
        if e < m:
            r[e:].addmv_(LT[o:e, e:].mT, y[o:e], alpha=-1.0)
    return y


def _solve_upper_lt(LT, r, W):
    """L^T x = r from the transposed factor (p = 1): x_j = W_j^T (r_j -
    LT[j, e:] x[e:]), LT's row panel again."""
    w = W.shape[-1]
    m = r.shape[0]
    x = torch.empty_like(r)
    for jb in reversed(range(W.shape[0])):
        o, e = jb * w, jb * w + w
        acc = torch.addmv(r[o:e], LT[o:e, e:], x[e:], alpha=-1.0) \
            if e < m else r[o:e]
        torch.mv(W[jb].mT, acc, out=x[o:e])
    return x


def factor(A: torch.Tensor, d2: torch.Tensor, opts: SolverOptions,
           reg_scale=1.0) -> SchurFactor:
    """Assembly across ranks and the distributed Cholesky of the scaled,
    regularized normal matrix.  ``A`` (1, m, n/p) is this rank's column
    block, ``d2`` (1, n) whole."""
    row = _row()
    B, m, nl = A.shape
    if B != 1:
        raise ValueError(f"linsys='sharded' solves one LP, got a batch of {B}")
    if m % row.p:
        raise ValueError(f"m={m} must be divisible by row-shards p={row.p}")
    mp = m // row.p
    fdt = d2.dtype
    d2_loc = d2[0, row.i * nl:(row.i + 1) * nl].contiguous()
    diag = _all_reduce(_diag_scan(A[0], d2_loc), row)
    j = torch.rsqrt(torch.clamp(diag, min=torch.finfo(fdt).tiny))
    reg = (opts.reg * torch.as_tensor(reg_scale, dtype=fdt, device=A.device)
           ).reshape(())

    from ipx_torch.linsys.normal_eq import assemble
    partial = assemble(A, d2_loc.unsqueeze(0))[0].to(fdt)   # (m, m)
    if row.group is None:
        panel = partial
    else:
        panel = torch.empty(mp, m, dtype=fdt, device=A.device)
        dist.reduce_scatter_tensor(panel, partial, group=row.group)
        del partial
    lo = row.i * mp
    panel.mul_(j[lo:lo + mp, None]).mul_(j[None, :])
    torch.diagonal(panel[:, lo:lo + mp]).add_(reg)
    L, W, ok = _dist_cholesky(panel, row, mp)
    ok = ok & torch.isfinite(j).all()
    return SchurFactor(L=L, W=W, j=j.unsqueeze(0), d2=d2, ok=ok.reshape(1))


def _precond(fac: SchurFactor, r: torch.Tensor, row: _Row) -> torch.Tensor:
    """z = J (L L^T)^-1 J r through the distributed solves; r (m,)."""
    m = r.shape[0]
    j = fac.j[0]
    t = j * r
    if row.p == 1:
        z = _solve_upper_lt(fac.L, _solve_lower_lt(fac.L, t, fac.W), fac.W)
    else:
        mp = m // row.p
        y = _dist_solve_lower(fac.L, t, row, mp, fac.W)
        z = _dist_solve_upper(fac.L, y, row, mp, fac.W)
    return j * z


def solve(fac: SchurFactor, A: torch.Tensor, rhs: torch.Tensor,
          opts: SolverOptions) -> torch.Tensor:
    """Preconditioned CG on the true operator A D^2 A^T, applied through the
    column-held A; the exact distributed factor of the regularized scaled
    matrix is the preconditioner.  ``opts.refine_steps`` CG iterations, as
    on the dense route.  rhs (1, m) -> (1, m)."""
    row = _row()
    fwd, tr = matvecs(A)
    dt = rhs.dtype
    tiny = torch.finfo(dt).tiny

    def op(v):
        return fwd(fac.d2 * tr(v.unsqueeze(0)))[0]

    b = rhs[0]
    y = _precond(fac, b, row)
    if opts.refine_steps <= 0:
        return y.unsqueeze(0)
    r = b - op(y)
    z = _precond(fac, r, row)
    p_ = z
    rz = torch.dot(r, z)
    one = torch.ones((), dtype=dt, device=b.device)
    zero = torch.zeros((), dtype=dt, device=b.device)
    for k in range(opts.refine_steps):
        Ap = op(p_)
        pAp = torch.dot(p_, Ap)
        ok = pAp > tiny
        alpha = torch.where(ok, rz / torch.where(ok, pAp, one), zero)
        y = y + alpha * p_
        if k == opts.refine_steps - 1:
            # the remaining recurrences feed only a next iteration that
            # does not exist
            break
        r = r - alpha * Ap
        z = _precond(fac, r, row)
        rz_new = torch.dot(r, z)
        ok_b = rz.abs() > tiny
        beta = torch.where(ok_b, rz_new / torch.where(ok_b, rz, one), zero)
        p_ = z + beta * p_
        rz = rz_new
    return y.unsqueeze(0)
