"""Normal-matrix assembly, the blocked Cholesky factors and the blocked
triangular solves (counterpart of ``ipx/kernels/cholesky.py``).

``assemble_sym_batched`` computes ``M[b] = (A[b] * d2[b]) @ A[b]^T`` over the
lower triangle of 128 x 128 tiles only, symmetrises the diagonal tiles and
mirrors the rest, so M is exactly symmetric (``csrc/assemble_sym.cu``: the
tensor cores, for a bf16 A as the fused panel stage, for an f32 A
warp-specialised as the accumulation of ``factor_lt_panels``).

The factor of ``chol_backend="pallas_left"`` is left-looking over 128-row
panels and comes out as ``(panels, W)``: ``panels[k]`` is ``(B, NB, m - k NB)``,
rows ``k NB .. (k+1) NB`` of ``L^T`` from the diagonal on, and ``W`` is
``(B, m / NB, NB, NB)``, the inverses of L's diagonal blocks.  Per panel:

    C_k = start tile row - sum_{j<k} P_j[:, o-jNB : o-jNB+NB]^T P_j[:, o-jNB:]
    L_D^T, W_D = diag_factor_inv(C_k[:, :, :NB])
    panels[k] = [L_D^T | W_D @ C_k[:, :, NB:]]

``factor_fused_panels`` assembles the start tiles from a bf16-stored A inside
the panel kernel (Jacobi scale and reg included), so the normal matrix is
never written; its products run on the tensor cores with an exact 3-way bf16
split of the f32 row operand (``csrc/fused_panel.cu``).  ``factor_lt_panels``
reads the start tiles from an assembled matrix; its accumulation runs on the
tensor cores with an exact split of both f32 operands, warp-specialised
(``csrc/accum_panel.cu``).
``W_D @ C_k[:, :, NB:]`` is a library product, as it is outside the kernels
in ``ipx``.  ``chol_solve_batched_panels`` is
the pair-solve ``L L^T x = b`` in one launch (``csrc/solve_panels.cu``).

The factors that keep a full (B, m, m) matrix: ``factor_lt_batched`` is the
same left-looking factor written into an upper-triangular ``LT = L^T`` (the
prior rows are read from LT itself by the same accumulation, and the panel
TRSM is a hand-written tensor-core product, ``csrc/accum_panel.cu``);
``cholesky_batched`` is right-looking in
a copy of M and returns the lower-triangular L (``csrc/cholesky_right.cu``).
``chol_solve_batched_lt`` is the pair-solve from a full ``LT``: the kernel of
``chol_solve_batched_panels`` over another address map, so the two give the
same bits for the same factor.  ``solve_triangular_batched`` is one sweep
from the untransposed L.

For a CUDA tensor each wrapper launches its hand-written kernel or raises;
for a CPU tensor, and only then, it evaluates the ``*_plain`` version beside
it, which is also what the kernels are held against on the card.
``LAUNCHES`` counts kernel launches per wrapper (one per panel for the
panel-major factors, two per panel for ``factor_lt_batched`` and
``cholesky_batched``, the diagonal kernel's counted apart).  Every blocked
factor and solve takes m up to ``MAX_M`` on any device, but for
``factor_lt_batched``, which takes any multiple of 128 (the large single LP's
factor).
"""
from __future__ import annotations

import ctypes

import torch

from ipx_torch.kernels import _build

NB = 128    # tile edge of the symmetric structure (same as the kernel's TILE)

LAUNCHES = {"assemble_sym_batched": 0, "factor_fused_panels": 0,
            "factor_lt_panels": 0, "diag_factor_inv": 0,
            "chol_solve_batched_panels": 0, "chol_solve_batched_lt": 0,
            "cholesky_batched": 0, "factor_lt_batched": 0,
            "solve_triangular_batched": 0}


def assemble_sym_batched_plain(A: torch.Tensor, d2: torch.Tensor
                               ) -> torch.Tensor:
    """The same function with library matmuls: tiles strictly below the
    block diagonal are taken from the product, diagonal tiles are
    ``0.5 * (T + T^T)``, tiles above are the mirror."""
    Af = A if A.dtype == torch.float32 else A.to(torch.float32)
    T = torch.matmul(Af * d2.unsqueeze(1), Af.mT)
    m = A.shape[1]
    blk = torch.arange(m, device=A.device) // NB
    lower = blk[:, None] > blk[None, :]
    upper = blk[:, None] < blk[None, :]
    return torch.where(lower, T, torch.where(upper, T.mT, 0.5 * (T + T.mT)))


_fns: dict = {}


def _entry(lib: str, name: str, argtypes):
    """The C entry point ``name`` of ``csrc/<lib>.cu`` with its argument
    types set (a bare ctypes call would cut pointers to 32 bits)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _launched(name: str, rc: int, what: str) -> None:
    """Raise on a launch the C entry point reports as failed, else count it."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (code {rc}) "
                           f"at {what}")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# argument types of ``csrc/assemble_sym.cu``'s C entry point
ASSEMBLE_ENTRY_ARGS = {"ipx_assemble_sym": [_P, _I, _P, _P, _I, _I, _I, _P]}


def assemble_sym_batched(A: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """A (B, m, n) f32 or bf16, d2 (B, n) f32 -> M (B, m, m) f32, exactly
    symmetric.  Any m, n: ragged tile edges are masked in the kernel.  Always
    f32-faithful, summed in two levels (64-column chunks, then the chunk
    sums), on the tensor cores with the diagonal of the diagonal tiles
    summed on the CUDA cores: a bf16 A against the exact 3-way split of
    f32(A * d2), every MMA summed alone; an f32 A with both f32(A * d2) and
    A split exactly, six cross products a step, hi.hi summed alone and the
    five smaller ones chained through one accumulator per chunk.  The
    2-term "high" assembly mode of ``ipx`` has no counterpart."""
    if A.ndim != 3:
        raise ValueError(f"A must be (B, m, n), got {tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"A must be float32 or bfloat16, got {A.dtype}")
    if d2.dtype != torch.float32:
        raise TypeError(f"d2 must be float32, got {d2.dtype}")
    B, m, n = A.shape
    if tuple(d2.shape) != (B, n):
        raise ValueError(f"d2 must be {(B, n)}, got {tuple(d2.shape)}")
    if d2.device != A.device:
        raise ValueError(f"d2 is on {d2.device}, A on {A.device}")
    if not (A.is_contiguous() and d2.is_contiguous()):
        raise ValueError("A and d2 must be contiguous")
    if not A.is_cuda:
        return assemble_sym_batched_plain(A, d2)
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535 instances")
    M = torch.empty(B, m, m, dtype=torch.float32, device=A.device)
    fn = _entry("assemble_sym", "ipx_assemble_sym",
                ASSEMBLE_ENTRY_ARGS["ipx_assemble_sym"])
    with torch.cuda.device(A.device):
        rc = fn(A.data_ptr(), int(A.dtype == torch.bfloat16), d2.data_ptr(),
                M.data_ptr(), B, m, n, _stream(A))
    _launched("assemble_sym_batched", rc, f"B={B}, m={m}, n={n}, {A.dtype}")
    return M


# --------------------------------------------------------------------------
# diagonal block: Cholesky factor and its inverse
# --------------------------------------------------------------------------

def _tiny(t: torch.Tensor) -> float:
    return torch.finfo(t.dtype).tiny


def _chol_small_plain(blk: torch.Tensor) -> torch.Tensor:
    """Cholesky of (K, q, q) blocks by rank-1 column elimination; reads the
    lower triangle.  A pivot below ``tiny`` is replaced by ``tiny`` under
    the root, so a block that is not positive definite gets a non-positive
    diagonal entry instead of a NaN."""
    q = blk.shape[-1]
    rows = torch.arange(q, device=blk.device).reshape(1, q, 1)
    zero = torch.zeros((), dtype=blk.dtype, device=blk.device)
    a, cols = blk, []
    for j in range(q):
        inv_piv = torch.rsqrt(torch.clamp(a[:, j:j + 1, j:j + 1],
                                          min=_tiny(blk)))
        col = torch.where(rows >= j, a[:, :, j:j + 1] * inv_piv, zero)
        a = a - col * col.mT
        cols.append(col)
    return torch.cat(cols, dim=2)


def _subst_invert_plain(T: torch.Tensor) -> torch.Tensor:
    """Inverse of (K, h, h) lower-triangular blocks by row-wise forward
    substitution."""
    K, h, _ = T.shape
    rows = []
    for i in range(h):
        r = torch.zeros(K, 1, h, dtype=T.dtype, device=T.device)
        r[:, :, i] = 1.0
        if i:
            above = torch.cat(rows, dim=1)                      # (K, i, h)
            r = r - (T[:, i, :i].unsqueeze(-1) * above).sum(dim=1,
                                                            keepdim=True)
        rows.append(r / torch.clamp(T[:, i:i + 1, i:i + 1], min=_tiny(T)))
    return torch.cat(rows, dim=1)


def _factor_block_plain(blk: torch.Tensor, h: int = 8):
    """Cholesky factor L and W = L^-1 of (K, q, q) SPD blocks by recursive
    halving down to width ``h``:

        L11, W11 = factor(A11)            W = [[ W11,          0 ],
        L21      = A21 @ W11^T                 [-W22 L21 W11, W22]]
        L22, W22 = factor(A22 - L21 L21^T)
    """
    K, q, _ = blk.shape
    if q <= h:
        L = _chol_small_plain(blk)
        return L, _subst_invert_plain(L)
    hh = q // 2
    L11, W11 = _factor_block_plain(blk[:, :hh, :hh], h)
    L21 = torch.bmm(blk[:, hh:, :hh], W11.mT)
    L22, W22 = _factor_block_plain(blk[:, hh:, hh:] - torch.bmm(L21, L21.mT),
                                   h)
    zer = torch.zeros(K, hh, q - hh, dtype=blk.dtype, device=blk.device)
    L = torch.cat([torch.cat([L11, zer], dim=2),
                   torch.cat([L21, L22], dim=2)], dim=1)
    off = -torch.bmm(W22, torch.bmm(L21, W11))
    W = torch.cat([torch.cat([W11, zer], dim=2),
                   torch.cat([off, W22], dim=2)], dim=1)
    return L, W


def diag_factor_inv_plain(CD: torch.Tensor, lower_out: bool = False):
    """(B, NB, NB) SPD blocks, lower triangle read -> ``(L^T, L^-1)``, or
    ``(L, L^-1)`` with ``lower_out``."""
    L, W = _factor_block_plain(CD)
    return (L if lower_out else L.mT.contiguous()), W


def _diag_plain_into(CD, out_lt, out_w, lower_out: bool = False) -> None:
    LT, W = diag_factor_inv_plain(CD, lower_out)
    out_lt.copy_(LT)
    out_w.copy_(W)


def _check_f32(name: str, t: torch.Tensor, shape, like=None) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if like is not None and t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")


def _check_tile_view(name: str, t: torch.Tensor, B: int, like) -> None:
    """A (B, NB, NB) f32 view whose rows are contiguous (a slice of a wider
    panel is fine: the kernel takes the instance and row strides)."""
    _check_f32(name, t, (B, NB, NB), like)
    if t.stride(2) != 1 or t.stride(1) < NB:
        raise ValueError(f"{name} must have contiguous rows, got strides "
                         f"{t.stride()}")


def diag_factor_inv(CD: torch.Tensor, out_lt: torch.Tensor | None = None,
                    out_w: torch.Tensor | None = None,
                    lower_out: bool = False):
    """Cholesky factor and inverse of a batch of 128 x 128 diagonal blocks.

    CD (B, NB, NB) f32, SPD, only its lower triangle is read; returns
    ``(L^T, W)`` with ``W = L^-1``, both (B, NB, NB) f32, written into
    ``out_lt`` / ``out_w`` when given (views with contiguous rows; ``out_lt``
    may be ``CD`` itself).  With ``lower_out`` the first output is L, not
    its transpose.  A block that is not positive definite comes back
    with a non-positive or non-finite diagonal entry of ``L^T``; nothing
    raises.  On the card: one block per instance, blocked over four leaves
    of 32 columns (each factored and inverted by one warp, the products
    between them on all threads); every dot product and update accumulated
    in float64, each entry of L and W rounded to float32 once, and W the
    inverse of the L that is stored."""
    if CD.ndim != 3:
        raise ValueError(f"CD must be (B, {NB}, {NB}), got {tuple(CD.shape)}")
    B = CD.shape[0]
    _check_tile_view("CD", CD, B, None)
    kw = dict(dtype=torch.float32, device=CD.device)
    if out_lt is None:
        out_lt = torch.empty(B, NB, NB, **kw)
    if out_w is None:
        out_w = torch.empty(B, NB, NB, **kw)
    _check_tile_view("out_lt", out_lt, B, CD)
    _check_f32("out_w", out_w, (B, NB, NB), CD)
    if out_w.stride(1) != NB or out_w.stride(2) != 1:
        raise ValueError("out_w must have contiguous (NB, NB) blocks")
    if not CD.is_cuda:
        _diag_plain_into(CD, out_lt, out_w, lower_out)
        return out_lt, out_w
    fn = _entry("factor_panels", "ipx_diag_factor_inv",
                [_P, _L, _I, _P, _L, _I, _P, _L, _I, _I, _P])
    with torch.cuda.device(CD.device):
        rc = fn(CD.data_ptr(), CD.stride(0), CD.stride(1),
                out_lt.data_ptr(), out_lt.stride(0), out_lt.stride(1),
                out_w.data_ptr(), out_w.stride(0), B, int(lower_out),
                _stream(CD))
    _launched("diag_factor_inv", rc, f"B={B}")
    return out_lt, out_w


# --------------------------------------------------------------------------
# panel-major factor
# --------------------------------------------------------------------------

# Largest m of the blocked factors and solves: the solves keep r, x and their
# partial sums in one block's shared memory.  The kernels are compiled with
# this value (``_build.NVCC_FLAGS``), which sizes their panel-pointer array
# and is checked there against the shared-memory size, so the factor refuses
# what the solve could not take.
MAX_M = _build.PANEL_MAX_M


def fused_factor_fits(m: int, n: int, a_dtype) -> bool:
    """Eligibility for :func:`factor_fused_panels`: bf16 A, 128-aligned."""
    return a_dtype == torch.bfloat16 and m % NB == 0 and n % NB == 0


def _prior_sum(prior, k: int):
    """sum_{j<k} P_j[:, :, lo:lo+NB]^T @ P_j[:, :, lo:], lo = (k - j) NB:
    what the k prior panels take from panel k's rows.  0 for k = 0."""
    total = 0
    for jj, P in enumerate(prior[:k]):
        lo = (k - jj) * NB
        total = total + torch.bmm(P[:, :, lo:lo + NB].mT, P[:, :, lo:])
    return total


def _factor_panels(B: int, m: int, device, panel_rows, diag):
    """The left-looking loop both factors share.  ``panel_rows(k, prior, C)``
    fills C (B, NB, m - k NB) with panel k's rows before the diagonal
    factor; ``diag(CD, out_lt, out_w)`` is :func:`diag_factor_inv` or its
    plain version's adapter.  All panels are views of one allocation, made
    once."""
    nb = m // NB
    kw = dict(dtype=torch.float32, device=device)
    widths = [m - k * NB for k in range(nb)]
    flat = torch.empty(B * NB * sum(widths), **kw)
    panels, at = [], 0
    for w in widths:
        panels.append(flat[at:at + B * NB * w].view(B, NB, w))
        at += B * NB * w
    W = torch.empty(B, nb, NB, NB, **kw)
    scratch = torch.empty(B * NB * m, **kw)
    for k, w in enumerate(widths):
        C = scratch[:B * NB * w].view(B, NB, w)
        panel_rows(k, panels[:k], C)
        diag(C[:, :, :NB], panels[k][:, :, :NB], W[:, k])
        if w > NB:
            # panel TRSM as a product with the block inverse: a library
            # matmul, as it is outside the kernels in ``ipx``
            torch.bmm(W[:, k], C[:, :, NB:], out=panels[k][:, :, NB:])
    return tuple(panels), W


def _fused_panel_rows_plain(A, d2, j, reg):
    """:func:`_fused_panel_rows` with library matmuls."""
    B = A.shape[0]
    Af = A if A.dtype == torch.float32 else A.to(torch.float32)
    eye = torch.eye(NB, dtype=torch.float32, device=A.device)

    def rows(k, prior, C):
        o = k * NB
        T = torch.bmm(Af[:, o:o + NB] * d2.unsqueeze(1), Af[:, o:].mT)
        T = (T * j[:, o:o + NB].unsqueeze(2)) * j[:, o:].unsqueeze(1)
        T[:, :, :NB] += reg.reshape(B, 1, 1) * eye
        C.copy_(T - _prior_sum(prior, k))

    return rows


def _lt_panel_rows_plain(M):
    """:func:`_lt_panel_rows` with library matmuls."""
    def rows(k, prior, C):
        o = k * NB
        C.copy_(M[:, o:o + NB, o:] - _prior_sum(prior, k))

    return rows


def factor_fused_panels_plain(A, d2, j, reg):
    """:func:`factor_fused_panels` with library matmuls throughout."""
    return _factor_panels(A.shape[0], A.shape[1], A.device,
                          _fused_panel_rows_plain(A, d2, j, reg),
                          _diag_plain_into)


def factor_lt_panels_plain(M):
    """:func:`factor_lt_panels` with library matmuls throughout."""
    return _factor_panels(M.shape[0], M.shape[1], M.device,
                          _lt_panel_rows_plain(M), _diag_plain_into)


def _panel_ptrs(panels):
    """Host array of the panels' device pointers (None for no panel)."""
    if not panels:
        return None
    return (ctypes.c_void_p * len(panels))(*[p.data_ptr() for p in panels])


def _check_panel_dims(name: str, B: int, m: int, capped: bool = True) -> None:
    """m a positive multiple of NB, and (``capped``) at most ``MAX_M``: the
    cap belongs to what reads a whole panel column or r and x in one block's
    shared memory (the pair-solves, row 11, the panel kernels' pointer
    arrays), not to the full-matrix factor, which indexes in size_t."""
    if m < NB or m % NB:
        raise ValueError(f"{name}: m={m} must be a positive multiple of {NB} "
                         "(the caller pads)")
    if capped and m > MAX_M:
        raise ValueError(
            f"{name}: m={m} exceeds {MAX_M}, the most the blocked solves' shared "
            "memory holds (larger m needs a solve that tiles r and x: "
            "ROADMAP.md, large single LP)")
    if B < 1 or B > 65535:
        raise ValueError(f"{name}: batch {B} outside 1..65535")


def _panel_launcher(name: str, launch, B: int, m: int):
    """``rows(k, prior, C)`` that launches one panel kernel: ``launch(prior
    pointers, C pointer, k)`` returns the C entry point's code."""
    def rows(k, prior, C):
        _launched(name, launch(_panel_ptrs(prior), C.data_ptr(), k),
                  f"B={B}, m={m}, k={k}")

    return rows


def _fused_panel_rows(A: torch.Tensor, d2: torch.Tensor, j: torch.Tensor,
                     reg: torch.Tensor):
    """The panel stage of :func:`factor_fused_panels`: returns
    ``rows(k, prior, C)``, which fills C (B, NB, m - k NB) with

        J_r (A_k * d2) A_{k:}^T J_c  (+ reg on the diagonal of its first tile)
        - sum_{j<k} P_j[:, lo:lo+NB]^T P_j[:, lo:],   lo = (k - j) NB,

    ``prior`` being the k panels before it.  One kernel launch per call on
    the card."""
    if A.ndim != 3:
        raise ValueError(f"A must be (B, m, n), got {tuple(A.shape)}")
    if A.dtype != torch.bfloat16:
        raise TypeError(f"A must be bfloat16, got {A.dtype}")
    B, m, n = A.shape
    _check_panel_dims("factor_fused_panels", B, m)
    if n < NB or n % NB:
        raise ValueError(f"factor_fused_panels: n={n} must be a multiple of "
                         f"{NB}")
    _check_f32("d2", d2, (B, n), A)
    _check_f32("j", j, (B, m), A)
    _check_f32("reg", reg, (B,), A)
    if not all(t.is_contiguous() for t in (A, d2, j, reg)):
        raise ValueError("A, d2, j and reg must be contiguous")
    if not A.is_cuda:
        return _fused_panel_rows_plain(A, d2, j, reg)
    fn = _entry("fused_panel", "ipx_fused_panel",
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])

    def launch(prior, C, k):
        with torch.cuda.device(A.device):
            return fn(A.data_ptr(), d2.data_ptr(), j.data_ptr(),
                      reg.data_ptr(), prior, C, B, m, n, k, _stream(A))

    return _panel_launcher("factor_fused_panels", launch, B, m)


# argument types of csrc/accum_panel.cu's three C entry points
ACCUM_ENTRY_ARGS = {"ipx_accum_panel": [_P, _P, _P, _I, _I, _I, _P],
                    "ipx_accum_panel_lt": [_P, _P, _P, _I, _I, _I, _P],
                    "ipx_lt_rows": [_P, _P, _P, _I, _I, _I, _P]}


def _lt_panel_rows(M: torch.Tensor):
    """The panel stage of :func:`factor_lt_panels`: ``rows(k, prior, C)``
    fills C with ``M[:, o:o+NB, o:]`` less what the k prior panels take
    from it.  One kernel launch per call on the card."""
    if M.ndim != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"M must be (B, m, m), got {tuple(M.shape)}")
    if M.dtype != torch.float32:
        raise TypeError(f"M must be float32, got {M.dtype}")
    B, m, _ = M.shape
    _check_panel_dims("factor_lt_panels", B, m)
    if not M.is_contiguous():
        raise ValueError("M must be contiguous")
    if not M.is_cuda:
        return _lt_panel_rows_plain(M)
    fn = _entry("accum_panel", "ipx_accum_panel",
                ACCUM_ENTRY_ARGS["ipx_accum_panel"])

    def launch(prior, C, k):
        with torch.cuda.device(M.device):
            return fn(M.data_ptr(), prior, C, B, m, k, _stream(M))

    return _panel_launcher("factor_lt_panels", launch, B, m)


def factor_fused_panels(A: torch.Tensor, d2: torch.Tensor, j: torch.Tensor,
                        reg: torch.Tensor):
    """Fused assemble + factor of ``J (A D^2 A^T) J + reg I``.

    A (B, m, n) bf16 with m and n multiples of 128, d2 (B, n), j (B, m) the
    Jacobi scale, reg (B,) the Tikhonov term of each instance, all f32 ->
    ``(panels, W)`` in the layout of :func:`factor_lt_panels`.  The scaled
    regularised matrix is assembled panel by panel inside the kernel and
    never written.  Always f32-faithful: on the card the products are bf16
    tensor-core passes over an exact split of each f32 operand (three for
    the assembly, six for the prior-panel subtraction); the 2-term split
    mode of ``ipx`` has no counterpart."""
    rows = _fused_panel_rows(A, d2, j, reg)
    return _factor_panels(A.shape[0], A.shape[1], A.device, rows,
                          diag_factor_inv)


def factor_lt_panels(M: torch.Tensor):
    """Panel-major Cholesky of an assembled matrix: M (B, m, m) f32, SPD, m
    a multiple of 128 -> ``(panels, W)``: ``panels`` a tuple of suffix-only
    transposed row panels (``panels[k]``: (B, NB, m - k NB), rows
    ``k NB .. (k+1) NB`` of ``L^T`` from the diagonal on, views of one
    allocation) and ``W`` (B, m / NB, NB, NB) the inverses of the diagonal
    blocks.  Consumed by :func:`chol_solve_batched_panels`."""
    rows = _lt_panel_rows(M)
    return _factor_panels(M.shape[0], M.shape[1], M.device, rows,
                          diag_factor_inv)


# --------------------------------------------------------------------------
# pair-solve from the panels
# --------------------------------------------------------------------------

def chol_solve_batched_panels_plain(panels, W, b):
    """:func:`chol_solve_batched_panels` with library matmuls: the same two
    sweeps, float32 throughout."""
    nb = len(panels)
    r = b.clone()
    for k in range(nb):
        o = k * NB
        y = torch.bmm(W[:, k], r[:, o:o + NB].unsqueeze(-1)).squeeze(-1)
        r[:, o:o + NB] = y
        if k < nb - 1:
            r[:, o + NB:] -= torch.bmm(y.unsqueeze(1),
                                       panels[k][:, :, NB:]).squeeze(1)
    x = torch.zeros_like(b)
    for k in range(nb - 1, -1, -1):
        o = k * NB
        t = r[:, o:o + NB]
        if k < nb - 1:
            t = t - torch.bmm(panels[k][:, :, NB:],
                              x[:, o + NB:].unsqueeze(-1)).squeeze(-1)
        x[:, o:o + NB] = torch.bmm(W[:, k].mT, t.unsqueeze(-1)).squeeze(-1)
    return x


def chol_solve_batched_panels(panels, W: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """Solve ``(L L^T) x = b`` from the panel tuple of
    :func:`factor_lt_panels`: panels[k] (B, NB, m - k NB), W (B, m / NB, NB,
    NB), b (B, m), all f32 -> x (B, m) f32.  Forward sweep
    ``y_k = W_k r_k; r[o+NB:] -= P_k[:, NB:]^T y_k``, backward sweep
    ``x_k = W_k^T (r_k - P_k[:, NB:] x[o+NB:])``; on the card one launch,
    any B, float64 sums rounded once per entry."""
    if b.ndim != 2:
        raise ValueError(f"b must be (B, m), got {tuple(b.shape)}")
    if b.dtype != torch.float32:
        raise TypeError(f"b must be float32, got {b.dtype}")
    B, m = b.shape
    _check_panel_dims("chol_solve_batched_panels", B, m)
    nb = m // NB
    panels = tuple(panels)
    if len(panels) != nb:
        raise ValueError(f"expected {nb} panels for m={m}, got {len(panels)}")
    for k, p in enumerate(panels):
        _check_f32(f"panels[{k}]", p, (B, NB, m - k * NB), b)
    _check_f32("W", W, (B, nb, NB, NB), b)
    if not (b.is_contiguous() and W.is_contiguous()
            and all(p.is_contiguous() for p in panels)):
        raise ValueError("panels, W and b must be contiguous")
    if not b.is_cuda:
        return chol_solve_batched_panels_plain(panels, W, b)
    x = torch.empty_like(b)
    fn = _entry("solve_panels", "ipx_solve_pair_panels",
                [_P, _P, _P, _P, _I, _I, _P])
    with torch.cuda.device(b.device):
        rc = fn(_panel_ptrs(panels), W.data_ptr(), b.data_ptr(), x.data_ptr(),
                B, m, _stream(b))
    _launched("chol_solve_batched_panels", rc, f"B={B}, m={m}")
    return x


# --------------------------------------------------------------------------
# factors and solves over a full (B, m, m) matrix
# --------------------------------------------------------------------------

def _check_square(name: str, M: torch.Tensor, capped: bool = True):
    """M (B, m, m) f32 contiguous, m within the blocked routes' range (any
    multiple of NB when not ``capped``)."""
    if M.ndim != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"{name}: expected (B, m, m), got {tuple(M.shape)}")
    if M.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {M.dtype}")
    B, m, _ = M.shape
    _check_panel_dims(name, B, m, capped)
    if not M.is_contiguous():
        raise ValueError(f"{name}: the matrix must be contiguous")
    return B, m


def _check_solve_args(name: str, F: torch.Tensor, W: torch.Tensor,
                      b: torch.Tensor):
    """A factor F (B, m, m), W (B, m / NB, NB, NB) and b (B, m), all f32,
    contiguous, on one device."""
    if b.ndim != 2:
        raise ValueError(f"{name}: b must be (B, m), got {tuple(b.shape)}")
    if b.dtype != torch.float32:
        raise TypeError(f"{name}: b must be float32, got {b.dtype}")
    B, m = b.shape
    _check_panel_dims(name, B, m)
    _check_f32("the factor", F, (B, m, m), b)
    _check_f32("W", W, (B, m // NB, NB, NB), b)
    if not (F.is_contiguous() and W.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: the factor, W and b must be contiguous")
    return B, m


def panels_of_lt(LT: torch.Tensor) -> tuple:
    """The panel-major layout of a full ``LT = L^T`` (B, m, m): contiguous
    copies of ``LT[:, k NB:(k+1) NB, k NB:]``."""
    m = LT.shape[-1]
    return tuple(LT[:, o:o + NB, o:].contiguous() for o in range(0, m, NB))


def lt_of_panels(panels) -> torch.Tensor:
    """The full upper-triangular (B, m, m) ``L^T`` whose rows the panels
    are; zeros elsewhere."""
    B, _, m = panels[0].shape
    LT = torch.zeros(B, m, m, dtype=panels[0].dtype, device=panels[0].device)
    for k, p in enumerate(panels):
        LT[:, k * NB:(k + 1) * NB, k * NB:] = p
    return LT


def chol_solve_batched_lt_plain(LT, W, b):
    """:func:`chol_solve_batched_lt` with library matmuls: the panel
    pair-solve's plain version on the strict-suffix stripes of LT, so the two
    plain versions give the same bits for the same factor."""
    return chol_solve_batched_panels_plain(panels_of_lt(LT), W, b)


def chol_solve_batched_lt(LT: torch.Tensor, W: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """Solve ``(L L^T) x = b`` from the transposed factor: LT (B, m, m) =
    ``L^T``, W (B, m / NB, NB, NB) the inverses of L's diagonal blocks,
    b (B, m), all f32 -> x (B, m) f32.  Only the strict-suffix stripes
    ``LT[:, o:o+NB, o+NB:]`` are read: what LT holds on and below the block
    diagonal plays no part.  The sweeps, the sums and their order are those
    of :func:`chol_solve_batched_panels`; on the card one launch, any B."""
    B, m = _check_solve_args("chol_solve_batched_lt", LT, W, b)
    if not b.is_cuda:
        return chol_solve_batched_lt_plain(LT, W, b)
    x = torch.empty_like(b)
    fn = _entry("solve_panels", "ipx_solve_pair_lt",
                [_P, _P, _P, _P, _I, _I, _P])
    with torch.cuda.device(b.device):
        rc = fn(LT.data_ptr(), W.data_ptr(), b.data_ptr(), x.data_ptr(), B, m,
                _stream(b))
    _launched("chol_solve_batched_lt", rc, f"B={B}, m={m}")
    return x


def _bmv(Mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.bmm(Mat, v.unsqueeze(-1)).squeeze(-1)


def solve_triangular_batched_plain(L, W, b, lower: bool = True):
    """:func:`solve_triangular_batched` with library matmuls, float32
    throughout."""
    m = b.shape[-1]
    x = torch.zeros_like(b)
    offsets = range(0, m, NB)
    for o in (offsets if lower else reversed(offsets)):
        k, t = o // NB, b[:, o:o + NB]
        if lower:
            if o:
                t = t - _bmv(L[:, o:o + NB, :o], x[:, :o])
            x[:, o:o + NB] = _bmv(W[:, k], t)
        else:
            if o + NB < m:
                t = t - _bmv(L[:, o + NB:, o:o + NB].mT, x[:, o + NB:])
            x[:, o:o + NB] = _bmv(W[:, k].mT, t)
    return x


def solve_triangular_batched(L: torch.Tensor, W: torch.Tensor,
                             b: torch.Tensor,
                             lower: bool = True) -> torch.Tensor:
    """One blocked sweep from the untransposed factor: ``L y = b``
    (``lower=True``: ``y_k = W_k (b_k - L[k, :k] y[:k])``) or ``L^T x = b``
    (``lower=False``: ``x_k = W_k^T (b_k - L[k+1:, k]^T x[k+1:])``).  L (B, m,
    m), W (B, m / NB, NB, NB) from :func:`cholesky_batched`, b (B, m), all
    f32 -> (B, m) f32.  On the card one launch, one block per instance,
    float64 sums rounded once per entry."""
    B, m = _check_solve_args("solve_triangular_batched", L, W, b)
    if not b.is_cuda:
        return solve_triangular_batched_plain(L, W, b, lower)
    x = torch.empty_like(b)
    fn = _entry("solve_panels", "ipx_solve_tri",
                [_P, _P, _P, _P, _I, _I, _I, _P])
    with torch.cuda.device(b.device):
        rc = fn(L.data_ptr(), W.data_ptr(), b.data_ptr(), x.data_ptr(), B, m,
                int(bool(lower)), _stream(b))
    _launched("solve_triangular_batched", rc, f"B={B}, m={m}, lower={lower}")
    return x


def factor_lt_batched_plain(M):
    """:func:`factor_lt_batched` with library matmuls: the plain panel-major
    factor, its panels laid into a full matrix."""
    panels, W = factor_lt_panels_plain(M)
    return lt_of_panels(panels), W


def factor_lt_batched(M: torch.Tensor):
    """Left-looking Cholesky with the transposed factor as output: M (B, m,
    m) f32, SPD, m a multiple of 128 -> ``(LT, W)``: LT (B, m, m) upper
    triangular, ``L^T`` (its strict lower triangle exactly zero), and W (B,
    m / NB, NB, NB) the inverses of L's diagonal blocks: the layout
    :func:`chol_solve_batched_lt` consumes.  Per panel k, with o = k NB:

        C = M[o:o+NB, o:] - sum_{j<k} LT[jNB:(j+1)NB, o:o+NB]^T LT[jNB:(j+1)NB, o:]
        L_kk^T, W_k = diag_factor_inv(C[:, :NB])
        LT[o:o+NB, :] = [0 | L_kk^T | W_k C[:, NB:]]

    m may exceed ``MAX_M``: nothing of the factor holds a whole panel
    column in shared memory, and every offset is a size_t.  Three launches a
    panel on the card (accumulate, diagonal, row panel).  The
    accumulation is the kernel of :func:`factor_lt_panels` over another
    address map: on the same prior rows the two give C the same bits."""
    B, m = _check_square("factor_lt_batched", M, capped=False)
    if not M.is_cuda:
        return factor_lt_batched_plain(M)
    nb = m // NB
    kw = dict(dtype=torch.float32, device=M.device)
    LT = torch.empty(B, m, m, **kw)
    W = torch.empty(B, nb, NB, NB, **kw)
    scratch = torch.empty(B * NB * m, **kw)
    with torch.cuda.device(M.device):
        for k in range(nb):
            o, w = k * NB, m - k * NB
            C = scratch[:B * NB * w].view(B, NB, w)
            _lt_accumulate(M, LT, C, k)
            diag_factor_inv(C[:, :, :NB], LT[:, o:o + NB, o:o + NB], W[:, k])
            if nb > 1:
                _lt_row_panel(W, C, LT, k)
    return LT, W



def _lt_accumulate(M: torch.Tensor, LT: torch.Tensor, C: torch.Tensor,
                   k: int) -> None:
    """Panel k's accumulation of :func:`factor_lt_batched`: C (B, NB, m - k
    NB) = ``M[:, o:o+NB, o:]`` less what rows 0 .. k NB of LT take from it,
    o = k NB; M and LT (B, m, m) float32 on the card.  One launch, counted;
    one that fails raises."""
    B, m = M.shape[0], M.shape[1]
    fn = _entry("accum_panel", "ipx_accum_panel_lt",
                ACCUM_ENTRY_ARGS["ipx_accum_panel_lt"])
    _launched("factor_lt_batched",
              fn(M.data_ptr(), LT.data_ptr(), C.data_ptr(), B, m, k,
                 _stream(M)), f"B={B}, m={m}, k={k} (accumulate)")


def _lt_row_panel(W: torch.Tensor, C: torch.Tensor, LT: torch.Tensor,
                  k: int) -> None:
    """Panel k's row panel of :func:`factor_lt_batched`: rows k NB .. (k+1)
    NB of LT outside the diagonal tile, zeros to its left and ``W_k C[:, :,
    NB:]`` to its right, from W (B, m / NB, NB, NB) and the accumulated C.
    One launch, counted; one that fails raises."""
    B, m = LT.shape[0], LT.shape[1]
    fn = _entry("accum_panel", "ipx_lt_rows", ACCUM_ENTRY_ARGS["ipx_lt_rows"])
    _launched("factor_lt_batched",
              fn(W.data_ptr(), C.data_ptr(), LT.data_ptr(), B, m, k,
                 _stream(LT)), f"B={B}, m={m}, k={k} (row panel)")


def cholesky_batched_plain(M):
    """:func:`cholesky_batched` with library matmuls: the same right-looking
    panel steps, float32 throughout."""
    B, m, _ = M.shape
    T = M.clone()
    W = torch.empty(B, m // NB, NB, NB, dtype=M.dtype, device=M.device)
    for k, o in enumerate(range(0, m, NB)):
        e = o + NB
        Lkk, Wk = _factor_block_plain(T[:, o:e, o:e])
        T[:, o:e, o:e] = Lkk
        W[:, k] = Wk
        if e < m:
            T[:, o:e, e:] = 0.0
            P = torch.bmm(T[:, e:, o:e], Wk.mT)
            T[:, e:, o:e] = P
            T[:, e:, e:] -= torch.bmm(P, P.mT)
    return T, W


def cholesky_batched(M: torch.Tensor):
    """Right-looking blocked Cholesky: M (B, m, m) f32, SPD (its lower
    triangle is read), m a multiple of 128 -> ``(L, W)``: L (B, m, m) lower
    triangular with its strict upper triangle exactly zero, W (B, m / NB, NB,
    NB) the inverses of its diagonal blocks, which
    :func:`solve_triangular_batched` consumes.  Per panel k, in a copy T of
    M: the diagonal tile's factor and inverse, ``T[i, k] = T[i, k] W_k^T``
    for the tiles below, ``T[i, j] -= T[i, k] T[j, k]^T`` for the tiles
    ``i >= j > k``: three launches on the card, every product device code
    of this package, the TRSM and the update on the tensor cores over an
    exact bf16 split of both float32 operands (six products, each MMA summed
    alone), the diagonal of the update's diagonal tiles on the CUDA cores.
    Each trailing entry is rounded to float32 once per panel."""
    B, m = _check_square("cholesky_batched", M)
    if not M.is_cuda:
        return cholesky_batched_plain(M)
    nb = m // NB
    T = M.clone()
    W = torch.empty(B, nb, NB, NB, dtype=torch.float32, device=M.device)
    with torch.cuda.device(M.device):
        for k in range(nb):
            o = k * NB
            tile = T[:, o:o + NB, o:o + NB]
            diag_factor_inv(tile, tile, W[:, k], lower_out=True)
            if k < nb - 1:
                _right_panel(T, W, k)
    return T, W


# argument types of csrc/cholesky_right.cu's two C entry points
RIGHT_ENTRY_ARGS = {"ipx_right_trsm": [_P, _P, _I, _I, _I, _P],
                    "ipx_right_update": [_P, _I, _I, _I, _P]}


def _right_panel(T: torch.Tensor, W: torch.Tensor, k: int,
                 entries=None) -> None:
    """Panel k of :func:`cholesky_batched` after its diagonal tile, in place
    on T (B, m, m) float32 on the card with W_k in W (B, m / NB, NB, NB):
    the TRSM ``T[i, k] = T[i, k] W_k^T`` of the tiles below it, then the
    trailing update.  Two launches, each counted; one that fails raises.
    ``entries`` are the two C entry points of another build of the source
    (argument types ``RIGHT_ENTRY_ARGS``), by default this package's."""
    B, m = T.shape[0], T.shape[1]
    trsm, update = entries or (
        _entry("cholesky_right", name, args)
        for name, args in RIGHT_ENTRY_ARGS.items())
    st = _stream(T)
    _launched("cholesky_batched",
              trsm(T.data_ptr(), W.data_ptr(), B, m, k, st),
              f"B={B}, m={m}, k={k} (panel TRSM)")
    _launched("cholesky_batched", update(T.data_ptr(), B, m, k, st),
              f"B={B}, m={m}, k={k} (trailing update)")


def cholesky(M: torch.Tensor) -> torch.Tensor:
    """One (m, m) matrix through :func:`cholesky_batched`; returns L only."""
    return cholesky_batched(M.unsqueeze(0))[0][0]
