"""One-stream A matvecs (counterpart of ``ipx/kernels/fused.py``).

The Mehrotra iteration's floor is set by repeated streams of the batched
(B, m, n) constraint matrix.  ``ata_apply`` evaluates

    y = A @ (alpha * (A^T v + beta) + w),    t = A^T v

in ONE read of A (``csrc/fused_matvec.cu``): with ``alpha = d2, w = 0`` it is
the matrix-free normal operator; with ``alpha = None`` it is an independent
pair ``(A @ w, A^T v)``; with ``alpha = d2`` and a precomputed ``w`` it is a
whole KKT-refinement right-hand side.  ``a_matvec`` and ``at_matvec`` are
the two halves on their own; ``a_matvec(A, w, square=True)`` streams the
elementwise square of A instead, which gives ``diag(A diag(w) A^T)`` without
a squared copy of A in device memory.  Both take ``out_dtype=torch.float64``
for the float64 sums unrounded.

For a CUDA tensor each wrapper launches its hand-written kernel or raises;
for a CPU tensor, and only then, it evaluates the ``*_plain`` version, which
is also what the kernels are held against on the card.  ``LAUNCHES`` counts
wrapper calls that launched their kernel.  The kernels accumulate in float64
and round to float32 once; the plain versions are float32 matmuls (float64
products with ``out_dtype=torch.float64``).

On the card ``ata_apply`` (``csrc/fused_matvec.cu``) copies a column stripe
a block asynchronously, which caps m (:func:`stripe_cols`), and a
thread-block cluster of two stripes sums their partial y before a second,
small launch adds the pairs' sums (``stripe_partials`` per instance).
``a_matvec`` and ``at_matvec`` (``csrc/row_matvec.cu``) stream A's rows with
nothing of A in shared memory, so they take any m and n: row 2 leaves
``a_partials`` float64 partial y a row for a second launch where n is wider
than one span of w, row 3 ``at_partials`` partial t a column, one a tile of
``at_tile`` rows.  Their tiling depends on (m, n, the stored type) alone.
"""
from __future__ import annotations

import ctypes

import torch

from ipx_torch.kernels import _build

LAUNCHES = {"ata_apply": 0, "a_matvec": 0, "at_matvec": 0}

# row 1, csrc/fused_matvec.cu
_SMEM_LIMIT = 227 * 1024     # dynamic shared memory one block may ask for
_THREADS = 256
_CLUSTER = 2                 # stripes a thread-block cluster sums (CLUSTER)
_NCHUNK = 8                  # row chunks of the asynchronous stripe copy
# rows 2 and 3, csrc/row_matvec.cu
_ROW_THREADS = 256
_SPAN_MAX = 4096             # row 2: most columns of w a block stages
_ROWS_A = 32                 # row 2: rows of A a block walks
_TILE_BYTES = 4096           # row 3: rows of a tile x itemsize


def _stripe_smem_bytes(m: int, W: int, itemsize: int) -> int:
    # mirrors stripe_smem_bytes() of csrc/fused_matvec.cu: the copy
    # barriers, the stripe (unpadded rows), the warps' phase-1 column sums,
    # u, and v as doubles
    return (_NCHUNK * 8 + -(-m * W * itemsize // 16) * 16
            + (_THREADS // 32 + 1) * W * 8 + m * 8)


def stripe_partials(n: int, W: int) -> int:
    """Partial sums of y per instance that the stripe kernel leaves for its
    second launch: one per pair of stripes (the grid is rounded up to whole
    pairs)."""
    ns = -(-n // W)
    return -(-ns // _CLUSTER)


def stripe_cols(m: int, itemsize: int) -> int | None:
    """Column-stripe width W of ``ata_apply``'s kernel for an m-row A of
    this item size: the widest of the candidates whose m x W stripe (stored
    type) fits one block's shared memory; ``None`` if even 8 columns do not
    fit (``ata_apply`` then refuses a CUDA tensor of that shape: m above
    9658 for bf16, 5795 for f32).  About 74 KB at m = 1024, so three blocks
    share an SM."""
    for W in ((32, 16, 8) if itemsize == 2 else (16, 8)):
        if _stripe_smem_bytes(m, W, itemsize) <= _SMEM_LIMIT:
            return W
    return None


def _step_cols(itemsize: int) -> int:
    """Columns of 32 granules of 16 bytes: a warp's step along a row."""
    return 32 * (16 // itemsize)


def a_span(n: int, itemsize: int) -> int:
    """Columns of w one block of row 2 stages as doubles: n rounded up to a
    warp's step, at most ``_SPAN_MAX`` (32 KB)."""
    step = _step_cols(itemsize)
    return min(-(-n // step) * step, _SPAN_MAX)


def a_partials(n: int, itemsize: int) -> int:
    """Float64 partial sums of y a row that row 2 leaves for its second
    launch: one a span of columns, 0 where one span covers n (y is written
    at once)."""
    spans = -(-n // a_span(n, itemsize))
    return spans if spans > 1 else 0


def at_tile(itemsize: int) -> int:
    """Rows of a tile of row 3: 2048 bf16, 1024 f32 (4 KB of a column), so
    its partial t is 8 / 4096 of A's bytes."""
    return _TILE_BYTES // itemsize


def at_partials(m: int, itemsize: int) -> int:
    """Float64 partial sums of t a column that row 3 leaves for its second
    launch: one a tile of rows, 0 where one tile covers m."""
    tiles = -(-m // at_tile(itemsize))
    return tiles if tiles > 1 else 0


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _f32(A: torch.Tensor) -> torch.Tensor:
    return A if A.dtype == torch.float32 else A.to(torch.float32)


def a_matvec_plain(A: torch.Tensor, w: torch.Tensor, square: bool = False,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if out_dtype == torch.float64:
        A64 = A.double()
        return torch.matmul(A64.square() if square else A64,
                            w.double().unsqueeze(-1)).squeeze(-1)
    Af = _f32(A)
    return torch.matmul(Af.square() if square else Af,
                        w.unsqueeze(-1)).squeeze(-1)


def at_matvec_plain(A: torch.Tensor, v: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if out_dtype == torch.float64:
        return torch.matmul(A.double().mT, v.double().unsqueeze(-1)).squeeze(-1)
    return torch.matmul(v.unsqueeze(1), _f32(A)).squeeze(1)


def ata_apply_plain(A, v, alpha, w, beta=None):
    Af = _f32(A)
    t = torch.matmul(v.unsqueeze(1), Af).squeeze(1)
    zero = torch.zeros_like(t)
    e = t + (zero if beta is None else beta)      # rounded BEFORE the scale
    u = (zero if alpha is None else alpha) * e + (zero if w is None else w)
    y = torch.matmul(Af, u.unsqueeze(-1)).squeeze(-1)
    return y, t


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _stripe_width(A: torch.Tensor) -> int:
    """``ata_apply``'s stripe width for A, or ValueError where an m x 8
    stripe does not fit one block's shared memory."""
    m = A.shape[1]
    W = stripe_cols(m, A.element_size())
    if W is None:
        raise ValueError(
            f"ata_apply: m={m} rows of {A.dtype} do not fit one block's "
            "shared memory even 8 columns wide (matvec_backend='xla' takes "
            "such an A through library matmuls)")
    return W


def _check_A(A: torch.Tensor) -> tuple[int, int, int]:
    if A.ndim != 3:
        raise ValueError(f"A must be (B, m, n), got {tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"A must be float32 or bfloat16, got {A.dtype}")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    return A.shape[0], A.shape[1], A.shape[2]


def _check_vec(name: str, x, A: torch.Tensor, length: int):
    if x is None:
        return
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != (A.shape[0], length):
        raise ValueError(f"{name} must be {(A.shape[0], length)}, "
                         f"got {tuple(x.shape)}")
    if x.device != A.device:
        raise ValueError(f"{name} is on {x.device}, A on {A.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_out(out_dtype):
    if out_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"out_dtype must be float32 or float64, got {out_dtype}")


_P, _I = ctypes.c_void_p, ctypes.c_int
# (source, C entry, argument types)
_ENTRIES = {
    "ata_apply": ("fused_matvec", "ipx_ata_apply",
                  [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "a_matvec": ("row_matvec", "ipx_rows_a",
                 [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P]),
    "at_matvec": ("row_matvec", "ipx_rows_at",
                  [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
}
_fns: dict = {}


def _entry(name: str):
    fn = _fns.get(name)
    if fn is None:
        source, symbol, argtypes = _ENTRIES[name]
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, A: torch.Tensor, outs, *args):
    """Launch ``name``'s kernel on A's device with ``args`` (tensors as
    pointers, ``None`` as null); returns ``outs``.

    Outputs and scratch come from PyTorch's caching allocator and the kernel
    runs on the current stream, so dropping the scratch (or a caller's
    temporary input) right after the launch is safe: the allocator hands
    that memory out again only to later work on the same stream."""
    B, m, n = A.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535 instances")
    ptrs = [x.data_ptr() if isinstance(x, torch.Tensor) else x
            for x in args]
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(name)(A.data_ptr(), int(A.dtype == torch.bfloat16),
                          *ptrs, B, m, n, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (code {rc}) at "
                           f"B={B}, m={m}, n={n}, {A.dtype}")
    LAUNCHES[name] += 1
    return outs


def _out(A: torch.Tensor, length: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(A.shape[0], length, dtype=dtype, device=A.device)


def _scratch(A: torch.Tensor, parts: int, length: int):
    """The float64 partials a second launch sums, (B, parts, length); None
    where there are none."""
    return torch.empty(A.shape[0], parts, length, dtype=torch.float64,
                       device=A.device) if parts else None


def _split(out: torch.Tensor) -> tuple:
    """(float32 pointer, float64 pointer) of an output, one of them null."""
    return (out, None) if out.dtype == torch.float32 else (None, out)


def a_matvec(A: torch.Tensor, w: torch.Tensor, square: bool = False,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``A @ w`` per instance, or ``(A * A) @ w`` with ``square=True``:
    A (B, m, n) f32 or bf16, w (B, n) f32 -> (B, m), summed in float64 and
    rounded once to ``out_dtype`` (``torch.float64``: not rounded)."""
    _, m, n = _check_A(A)
    _check_vec("w", w, A, n)
    _check_out(out_dtype)
    if not A.is_cuda:
        return a_matvec_plain(A, w, square, out_dtype)
    isz = A.element_size()
    parts = a_partials(n, isz)
    y = _out(A, m, out_dtype)
    return _launch("a_matvec", A, y, w, int(square), *_split(y),
                   _scratch(A, parts, m), a_span(n, isz))


def at_matvec(A: torch.Tensor, v: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``A^T @ v`` per instance: v (B, m) f32 -> (B, n), summed in float64
    and rounded once to ``out_dtype`` (``torch.float64``: not rounded)."""
    _, m, n = _check_A(A)
    _check_vec("v", v, A, m)
    _check_out(out_dtype)
    if not A.is_cuda:
        return at_matvec_plain(A, v, out_dtype)
    isz = A.element_size()
    parts = at_partials(m, isz)
    t = _out(A, n, out_dtype)
    return _launch("at_matvec", A, t, v, *_split(t), _scratch(A, parts, n),
                   at_tile(isz))


def ata_apply(A: torch.Tensor, v: torch.Tensor, alpha, w, beta=None):
    """One-A-stream evaluation of

        y = A @ (alpha * (A^T v + beta) + w),    t = A^T v.

    ``alpha``/``beta``/``w`` are (B, n) f32 or ``None`` (zeros; an
    ``alpha=None`` call is the independent pair ``(A @ w, A^T v)``).
    ``t + beta`` is rounded as an f32 sum BEFORE the ``alpha`` scaling, and
    the returned ``t`` is bit for bit the one that entered ``y``: callers
    rebuild ``t + beta`` outside and need the same rounded value.  Returns
    ``(y, t)`` as (B, m), (B, n) float32.
    """
    _, m, n = _check_A(A)
    _check_vec("v", v, A, m)
    for name, x in (("alpha", alpha), ("w", w), ("beta", beta)):
        _check_vec(name, x, A, n)
    if not A.is_cuda:
        return ata_apply_plain(A, v, alpha, w, beta)
    W = _stripe_width(A)
    y, t = _out(A, m, torch.float32), _out(A, n, torch.float32)
    return _launch("ata_apply", A, (y, t), v, alpha, beta, w, y, t,
                   _scratch(A, stripe_partials(n, W), m), W)
