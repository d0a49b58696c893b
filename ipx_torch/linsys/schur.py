"""Normal equations of LPs whose A the ranks hold by columns: one large LP
(config 4: m=32k, n=64k) or a batch of lanes (config 5, each A split over
the mesh's "row" axis).

  * A is held by COLUMNS: rank i of the mesh's "row" axis holds the column
    block A_i (B, m, n/p) of every lane; every n-vector (x, s, c, d2) is
    whole on every rank.  A.w is each rank's A_i w_i, all-reduced; A^T v is
    each rank's A_i^T v, all-gathered (:func:`matvecs`), each rank's own
    product being the one ``linsys.products`` decides.
  * Each rank assembles its partial  (A_i o d2_i) A_i^T  (the assembly kernel
    on the card), lanes in chunks of at most ``COPY_BYTES``, and a
    reduce-scatter per lane leaves it the sum's ROW PANEL (m/p rows); the
    Jacobi scale comes from the all-reduced diagonal (:func:`_diag_scan`).
    M is never formed on one rank when p > 1.
  * A right-looking blocked Cholesky across ranks (:func:`_dist_cholesky`):
    step k broadcasts the diagonal blocks, every rank factors them, the
    ranks below solve their blocks of column k through W, the block column
    is all-gathered and each rank updates its own rows.  At p = 1 the whole
    matrix is one diagonal block, factored by the left-looking kernel factor
    into L^T, the lanes its batch.
  * Every triangular solve is a substitution through W, the inverses of the
    factor's 128-blocks on the diagonal (the whole mp block when mp is not a
    multiple of 128): p outer steps, each broadcasting one rank's m/p
    entries of every lane.
  * The direction solve is preconditioned CG on the true operator through
    the column-held A, the distributed factor the preconditioner, per lane:
    the structure of ``normal_eq.solve``.

Each rank runs the same program on its own shard, with explicit collectives
on the "row" group where ``ipx`` has ``shard_map`` and ``psum``.  Every value
that steers control flow (the loop's exit, ``ok``) is replicated over the
row group, so its ranks take the same branches; no collective spans the
"batch" axis, whose groups run their own iteration counts.  Nothing mixes
lanes: a lane's values are its own at any B (rows 2 and 3 give a lane the
same bits at any B; on the CPU, at B = 1 each product is the unbatched
library call, so the single LP keeps its bits, and a batched library
product may round a lane differently at another B).  The route is selected
with ``SolverOptions(linsys="sharded")``; the mesh is the one
:func:`use_mesh` makes active.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ipx_torch.kernels import cholesky as pk
from ipx_torch.kernels import fused as fk
from ipx_torch.linsys import products
from ipx_torch.mesh import ROW_AXIS, Mesh
from ipx_torch.numerics import COPY_BYTES
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
    (None in a one-process mesh: no collective runs), and whether the group
    is gloo's (:func:`_collective`)."""
    p: int
    i: int
    group: object
    gloo: bool = False


def _row() -> _Row:
    mesh = active_mesh()
    group = mesh.groups[ROW_AXIS]
    return _Row(mesh.shape[ROW_AXIS], mesh.coords[ROW_AXIS], group,
                group is not None and dist.get_backend(group) == "gloo")


def _collective(row: _Row, op, out: torch.Tensor,
                inp: torch.Tensor | None = None) -> torch.Tensor:
    """``op(out)`` (in place) or ``op(out, inp)`` on the row group.  On a
    gloo group a CUDA tensor goes through host memory: two ranks that share
    one card cannot take NCCL, and gloo's CUDA forms do not cover every
    collective.  Only how the data moves changes (gloo sums on the host
    either way); an error raises as it is."""
    if not (row.gloo and out.is_cuda):
        if inp is None:
            op(out)
        else:
            op(out, inp)
        return out
    if inp is None:
        host = out.cpu()
        op(host)
    else:
        host = torch.empty(out.shape, dtype=out.dtype)
        op(host, inp.cpu())
    return out.copy_(host)


def _all_reduce(t: torch.Tensor, row: _Row) -> torch.Tensor:
    """The sum of ``t`` over the row group, on every rank (in place)."""
    if row.group is not None:
        _collective(row, lambda o: dist.all_reduce(o, group=row.group), t)
    return t


def _all_gather_rows(t: torch.Tensor, row: _Row) -> torch.Tensor:
    """(B, r, ...) on each rank -> (B, p r, ...): every lane's blocks in
    rank order."""
    if row.group is None:
        return t
    B = t.shape[0]
    g = torch.empty((row.p * B,) + tuple(t.shape[1:]), dtype=t.dtype,
                    device=t.device)
    _collective(row, lambda o, i: dist.all_gather_into_tensor(
        o, i, group=row.group), g, t.contiguous())
    g = g.view((row.p, B) + tuple(t.shape[1:])).transpose(0, 1)
    return g.reshape((B, row.p * t.shape[1]) + tuple(t.shape[2:]))


def _reduce_scatter_rows(out: torch.Tensor, t: torch.Tensor,
                         row: _Row) -> torch.Tensor:
    """``out`` (r, k) = this rank's r rows of the sum of ``t`` (p r, k) over
    the row group."""
    return _collective(row, lambda o, i: dist.reduce_scatter_tensor(
        o, i, group=row.group), out, t)


def _broadcast(t: torch.Tensor, k: int, row: _Row) -> torch.Tensor:
    """Rank k's ``t`` on every rank (in place; ``t`` contiguous)."""
    if row.group is not None:
        src = dist.get_global_rank(row.group, k)
        _collective(row, lambda o: dist.broadcast(o, src, group=row.group), t)
    return t


# Per-lane products.  At B = 1 each is the unbatched library call the single
# LP has always made (on the CPU a batched product of one lane rounds
# differently from it at some shapes).

def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, r, k) @ (B, k) -> (B, r)."""
    if M.shape[0] == 1:
        return torch.mv(M[0], v[0]).unsqueeze(0)
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _sub_mv(r: torch.Tensor, M: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
    """r - M v in one fused library call (``addmv``), per lane."""
    if M.shape[0] == 1:
        return torch.addmv(r[0], M[0], v[0], alpha=-1.0).unsqueeze(0)
    return torch.baddbmm(r.unsqueeze(-1), M, v.unsqueeze(-1),
                         alpha=-1.0).squeeze(-1)


def _mm(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """(B, r, k) @ (B, k, c) -> (B, r, c)."""
    if X.shape[0] == 1:
        return torch.matmul(X[0], Y[0]).unsqueeze(0)
    return torch.matmul(X, Y)


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, k), (B, k) -> (B,)."""
    if x.shape[0] == 1:
        return torch.dot(x[0], y[0]).unsqueeze(0)
    return (x * y).sum(dim=-1)


def matvecs(A: torch.Tensor, wide: bool = False):
    """(w -> A w, v -> A^T v) for the LPs whose column blocks ``A`` (B, m,
    n/p) this rank holds, every vector whole on every rank: the local
    product (``linsys.products``), then an all-reduce (an m-vector) or an
    all-gather (an n-vector).  ``wide`` keeps the local sums in float64
    (``"sharded_schur"``, as the augmented routes sum) through the
    all-reduce, and rounds once."""
    row = _row()
    nl = A.shape[-1]
    lo = row.i * nl
    loc_fwd, loc_tr = products.pair(A, "f64" if wide else "working")

    def fwd(w):
        y = loc_fwd(w[..., lo:lo + nl])
        return _all_reduce(y, row).to(w.dtype)

    def tr(v):
        return _all_gather_rows(loc_tr(v).to(v.dtype), row)

    return fwd, tr


@dataclass(frozen=True)
class SchurFactor:
    """Distributed Cholesky factor of  J (A D^2 A^T) J + reg I, per lane.

    ``L`` is, at p = 1, the transposed factor L^T (B, m, m); at p > 1 this
    rank's row panel of L (B, m/p, m), zeros right of its diagonal block.
    ``W`` holds the inverses of the factor's diagonal blocks (B, m / w, w,
    w), w = 128 when m/p allows, else m/p, on every rank.  ``j`` is the
    Jacobi scale, ``d2`` the scaling (whole on every rank), ``ok`` per
    lane."""
    L: torch.Tensor
    W: torch.Tensor
    j: torch.Tensor     # (B, m)
    d2: torch.Tensor    # (B, n)
    ok: torch.Tensor    # (B,) bool


def _dblk(mp: int) -> int:
    """W's block width: 128 when mp allows, else the whole mp block."""
    return _NB if mp % _NB == 0 else mp


def _diag_scan(A_loc: torch.Tensor, d2_loc: torch.Tensor) -> torch.Tensor:
    """(A_loc o A_loc) d2_loc per lane, (B, m), in d2's dtype: row 2's
    squared stream on the card (float64 sums rounded once), else library
    products a block of A's columns at a time (no (B, m, n) temporary)."""
    if products.on_card(A_loc):
        return fk.a_matvec(A_loc, d2_loc.contiguous(), square=True)
    B, m, nl = A_loc.shape
    dt = d2_loc.dtype
    w = max(1, min(nl, COPY_BYTES // (B * m * dt.itemsize)))
    acc = torch.zeros(B, m, dtype=dt, device=A_loc.device)
    for c in range(0, nl, w):
        Ab = A_loc[:, :, c:c + w].to(dt)
        acc += _mv(Ab * Ab, d2_loc[:, c:c + w])
    return acc


def _factor_block(Mkk: torch.Tensor):
    """Cholesky of (B, mp, mp) SPD blocks -> (L^T, W, ok): the kernel
    factor (row 10 with the diagonal kernel; its plain version on the CPU)
    for float32 blocks of 128-multiple width, the lanes its batch, else the
    library Cholesky and the inverses of its diagonal blocks."""
    from ipx_torch.linsys.normal_eq import _invert_lower_blocks
    B, mp, _ = Mkk.shape
    w = _dblk(mp)
    if Mkk.dtype == torch.float32 and w == _NB:
        LT, W = pk.factor_lt_batched(Mkk)
        ok = torch.ones(B, dtype=torch.bool, device=Mkk.device)
    else:
        L, info = torch.linalg.cholesky_ex(Mkk)
        LT = L.mT.contiguous()
        blocks = torch.stack([L[:, o:o + w, o:o + w]
                              for o in range(0, mp, w)], dim=1)
        W = _invert_lower_blocks(blocks.reshape(-1, w, w), base=min(32, w)
                                 ).reshape(B, mp // w, w, w)
        ok = info == 0
    ld = torch.diagonal(LT, dim1=-2, dim2=-1)
    return LT, W, ok & torch.isfinite(ld).all(-1) & (ld > 0).all(-1)


def _blk_trisolve_right(Bm: torch.Tensor, LTkk: torch.Tensor,
                        Wb: torch.Tensor) -> torch.Tensor:
    """X = Bm inv(L_kk)^T for (B, r, mp) Bm, from L_kk's transposed factor
    and its block inverses, in ascending column blocks:

        X_j = (Bm_j - X[:, :oj] LT[:oj, j-block]) W_j^T
    """
    w = Wb.shape[-1]
    X = torch.empty_like(Bm)
    for jb in range(Wb.shape[1]):
        o, e = jb * w, jb * w + w
        acc = Bm[:, :, o:e]
        if o:
            acc = acc - _mm(X[:, :, :o], LTkk[:, :o, o:e])
        X[:, :, o:e] = _mm(acc, Wb[:, jb].mT)
    return X


def _dist_cholesky(panel: torch.Tensor, row: _Row, mp: int):
    """Right-looking blocked Cholesky of the row-panel-distributed matrices:
    ``panel`` is this rank's (B, mp, m) rows of each lane's SPD matrix
    (overwritten).  Returns (L, W, ok): at p = 1 the factor transposed, else
    this rank's rows of L; W and ok are the same on every rank (every rank
    factors every diagonal block from the same broadcast bits)."""
    p, i = row.p, row.i
    m = panel.shape[-1]
    if p == 1:
        return _factor_block(panel)
    Lp = torch.zeros_like(panel)
    ws, ok = [], None
    for k in range(p):
        o, e = k * mp, (k + 1) * mp
        blk = panel[:, :, o:e]
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
        col = _all_gather_rows(Lik, row)                 # (B, m, mp)
        if i > k:
            # the trailing update of this rank's rows, lower blocks only
            hi = (i + 1) * mp
            panel[:, :, e:hi] -= _mm(Lik, col[:, e:hi].mT)
        Lp[:, :, o:e] = Lik
    return Lp, torch.cat(ws, dim=1), ok


def _lower_block(Lkk, rk, Wk):
    """Solve L_kk y = rk per lane by substitution through the block
    inverses Wk."""
    w = Wk.shape[-1]
    y = torch.empty_like(rk)
    for jb in range(Wk.shape[1]):
        o, e = jb * w, jb * w + w
        acc = rk[:, o:e] - _mv(Lkk[:, o:e, :o], y[:, :o]) if o \
            else rk[:, o:e]
        y[:, o:e] = _mv(Wk[:, jb], acc)
    return y


def _upper_block(Lkk, rk, Wk):
    """Solve L_kk^T x = rk per lane by substitution through the block
    inverses Wk."""
    w = Wk.shape[-1]
    mp = rk.shape[-1]
    x = torch.empty_like(rk)
    for jb in reversed(range(Wk.shape[1])):
        o, e = jb * w, jb * w + w
        acc = rk[:, o:e] - _mv(Lkk[:, e:, o:e].mT, x[:, e:]) if e < mp \
            else rk[:, o:e]
        x[:, o:e] = _mv(Wk[:, jb].mT, acc)
    return x


def _dist_solve_lower(Lp, r, row: _Row, mp: int, Wd):
    """L y = r across ranks: step k, rank k solves its block from the
    prefix it holds and broadcasts it.  r and y (B, m) whole on every
    rank."""
    nb = Wd.shape[1] // row.p
    B = r.shape[0]
    y = torch.empty_like(r)
    for k in range(row.p):
        o, e = k * mp, (k + 1) * mp
        if row.i == k:
            rk = r[:, o:e] - _mv(Lp[:, :, :o], y[:, :o]) if o else r[:, o:e]
            yk = _lower_block(Lp[:, :, o:e], rk,
                              Wd[:, k * nb:(k + 1) * nb]).contiguous()
        else:
            yk = torch.empty(B, mp, dtype=r.dtype, device=r.device)
        y[:, o:e] = _broadcast(yk, k, row)
    return y


def _dist_solve_upper(Lp, r, row: _Row, mp: int, Wd):
    """L^T x = r across ranks: block row k of L^T is column block k of L,
    spread over the ranks below k; their contributions are all-reduced,
    then rank k solves its block and broadcasts it."""
    nb = Wd.shape[1] // row.p
    i = row.i
    B = r.shape[0]
    x = torch.empty_like(r)
    for k in reversed(range(row.p)):
        o, e = k * mp, (k + 1) * mp
        rk = r[:, o:e]
        if k < row.p - 1:
            s = (_mv(Lp[:, :, o:e].mT, x[:, i * mp:(i + 1) * mp]) if i > k
                 else torch.zeros(B, mp, dtype=r.dtype, device=r.device))
            rk = rk - _all_reduce(s, row)
        if i == k:
            xk = _upper_block(Lp[:, :, o:e], rk,
                              Wd[:, k * nb:(k + 1) * nb]).contiguous()
        else:
            xk = torch.empty(B, mp, dtype=r.dtype, device=r.device)
        x[:, o:e] = _broadcast(xk, k, row)
    return x


def _solve_lower_lt(LT, r, W):
    """L y = r from the transposed factor (p = 1): y_j = W_j r_j, then the
    rows below take L[e:, j] y_j = LT[j, e:]^T y_j, LT's own row panel."""
    w = W.shape[-1]
    m = r.shape[-1]
    r = r.clone()
    y = torch.empty_like(r)
    for jb in range(W.shape[1]):
        o, e = jb * w, jb * w + w
        y[:, o:e] = _mv(W[:, jb], r[:, o:e])
        if e < m:
            r[:, e:] = _sub_mv(r[:, e:], LT[:, o:e, e:].mT, y[:, o:e])
    return y


def _solve_upper_lt(LT, r, W):
    """L^T x = r from the transposed factor (p = 1): x_j = W_j^T (r_j -
    LT[j, e:] x[e:]), LT's row panel again."""
    w = W.shape[-1]
    m = r.shape[-1]
    x = torch.empty_like(r)
    for jb in reversed(range(W.shape[1])):
        o, e = jb * w, jb * w + w
        acc = _sub_mv(r[:, o:e], LT[:, o:e, e:], x[:, e:]) if e < m \
            else r[:, o:e]
        x[:, o:e] = _mv(W[:, jb].mT, acc)
    return x


def factor(A: torch.Tensor, d2: torch.Tensor, opts: SolverOptions,
           reg_scale=1.0) -> SchurFactor:
    """Assembly across ranks and the distributed Cholesky of the scaled,
    regularized normal matrices.  ``A`` (B, m, n/p) is this rank's column
    block of every lane, ``d2`` (B, n) whole; ``reg_scale`` a float or (B,)
    per lane."""
    row = _row()
    B, m, nl = A.shape
    if m % row.p:
        raise ValueError(f"m={m} must be divisible by row-shards p={row.p}")
    mp = m // row.p
    fdt = d2.dtype
    d2_loc = d2[:, row.i * nl:(row.i + 1) * nl].contiguous()
    diag = _all_reduce(_diag_scan(A, d2_loc), row)
    j = torch.rsqrt(torch.clamp(diag, min=torch.finfo(fdt).tiny))
    reg = (opts.reg * torch.as_tensor(reg_scale, dtype=fdt, device=A.device)
           ).expand(B)

    from ipx_torch.linsys.normal_eq import assemble
    if row.group is None:
        panel = assemble(A, d2_loc).to(fdt)                 # (B, m, m)
    else:
        # lanes in chunks: no rank holds more than COPY_BYTES of partial
        # products besides its panels
        panel = torch.empty(B, mp, m, dtype=fdt, device=A.device)
        q = max(1, COPY_BYTES // (m * m * fdt.itemsize))
        for b0 in range(0, B, q):
            partial = assemble(A[b0:b0 + q], d2_loc[b0:b0 + q]).to(fdt)
            for b in range(partial.shape[0]):
                _reduce_scatter_rows(panel[b0 + b], partial[b], row)
            del partial
    lo = row.i * mp
    panel.mul_(j[:, lo:lo + mp, None]).mul_(j[:, None, :])
    torch.diagonal(panel[:, :, lo:lo + mp], dim1=-2, dim2=-1).add_(
        reg.unsqueeze(-1))
    L, W, ok = _dist_cholesky(panel, row, mp)
    ok = ok & torch.isfinite(j).all(-1)
    return SchurFactor(L=L, W=W, j=j, d2=d2, ok=ok)


def _precond(fac: SchurFactor, r: torch.Tensor, row: _Row) -> torch.Tensor:
    """z = J (L L^T)^-1 J r through the distributed solves; r (B, m)."""
    m = r.shape[-1]
    t = fac.j * r
    if row.p == 1:
        z = _solve_upper_lt(fac.L, _solve_lower_lt(fac.L, t, fac.W), fac.W)
    else:
        mp = m // row.p
        y = _dist_solve_lower(fac.L, t, row, mp, fac.W)
        z = _dist_solve_upper(fac.L, y, row, mp, fac.W)
    return fac.j * z


def solve(fac: SchurFactor, A: torch.Tensor, rhs: torch.Tensor,
          opts: SolverOptions) -> torch.Tensor:
    """Preconditioned CG on the true operator A D^2 A^T, applied through the
    column-held A; the exact distributed factor of the regularized scaled
    matrix is the preconditioner.  ``opts.refine_steps`` CG iterations, as
    on the dense route, with per-lane step lengths and its guards.  rhs
    (B, m) -> (B, m)."""
    row = _row()
    fwd, tr = matvecs(A)
    tiny = torch.finfo(rhs.dtype).tiny

    def op(v):
        return fwd(fac.d2 * tr(v))

    b = rhs
    y = _precond(fac, b, row)
    if opts.refine_steps <= 0:
        return y
    r = b - op(y)
    z = _precond(fac, r, row)
    p_ = z
    rz = _dot(r, z)
    one = torch.ones_like(rz)
    zero = torch.zeros_like(rz)
    for k in range(opts.refine_steps):
        Ap = op(p_)
        pAp = _dot(p_, Ap)
        ok = pAp > tiny
        alpha = torch.where(ok, rz / torch.where(ok, pAp, one), zero)
        y = y + alpha.unsqueeze(-1) * p_
        if k == opts.refine_steps - 1:
            # the remaining recurrences feed only a next iteration that
            # does not exist
            break
        r = r - alpha.unsqueeze(-1) * Ap
        z = _precond(fac, r, row)
        rz_new = _dot(r, z)
        ok_b = rz.abs() > tiny
        beta = torch.where(ok_b, rz_new / torch.where(ok_b, rz, one), zero)
        p_ = z + beta.unsqueeze(-1) * p_
        rz = rz_new
    return y
