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
a squared copy of A in device memory.

For a CUDA tensor each wrapper launches its hand-written kernel or raises;
for a CPU tensor, and only then, it evaluates the ``*_plain`` version, which
is also what the kernels are held against on the card.  ``LAUNCHES`` counts
kernel launches per wrapper.  The kernels accumulate in float64 and round to
float32 once; the plain versions are float32 matmuls.  On the card each
block copies its column stripe asynchronously and a thread-block cluster of
two stripes sums their partial y before a second, small launch adds the
pairs' sums (``stripe_partials`` per instance).
"""
from __future__ import annotations

import ctypes

import torch

from ipx_torch.kernels import _build

LAUNCHES = {"ata_apply": 0, "a_matvec": 0, "at_matvec": 0}

_SMEM_LIMIT = 227 * 1024     # dynamic shared memory one block may ask for
_THREADS = 256
_CLUSTER = 2                 # stripes a thread-block cluster sums (CLUSTER)
_NCHUNK = 8                  # row chunks of the asynchronous stripe copy


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
    """Column-stripe width W of the kernels for an m-row A of this item
    size: the widest of the candidates whose m x W stripe (stored type) fits
    one block's shared memory; ``None`` if even 8 columns do not fit (the
    wrappers then refuse a CUDA tensor of that shape: m above 9658 for
    bf16, 5795 for f32).  About 74 KB at m = 1024, so three blocks share an
    SM."""
    for W in ((32, 16, 8) if itemsize == 2 else (16, 8)):
        if _stripe_smem_bytes(m, W, itemsize) <= _SMEM_LIMIT:
            return W
    return None


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _f32(A: torch.Tensor) -> torch.Tensor:
    return A if A.dtype == torch.float32 else A.to(torch.float32)


def a_matvec_plain(A: torch.Tensor, w: torch.Tensor,
                   square: bool = False) -> torch.Tensor:
    Af = _f32(A)
    return torch.matmul(Af.square() if square else Af,
                        w.unsqueeze(-1)).squeeze(-1)


def at_matvec_plain(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
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


_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("fused_matvec").ipx_fused_matvec
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, i, p, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(name: str, mode: int, A, v, alpha, beta, w):
    """Launch one mode of the stripe kernel on A's device; returns (y, t)
    (``None`` for the output the mode does not produce)."""
    B, m, n = A.shape
    W = stripe_cols(m, A.element_size())
    if W is None:
        raise ValueError(
            f"{name}: m={m} rows of {A.dtype} do not fit one block's shared "
            "memory even 8 columns wide; the kernels do not tile rows yet "
            "(matvec_backend='xla' takes such an A through library matmuls)")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535 instances")
    kw = dict(dtype=torch.float32, device=A.device)
    # Outputs and scratch come from PyTorch's caching allocator and the
    # kernel runs on the current stream, so dropping ``ypart`` (or a
    # caller's temporary input) right after the launch is safe: the
    # allocator hands that memory out again only to later work on the same
    # stream.
    y = t = ypart = None
    if mode != 2:                       # 0 ata, 1 a, 2 at, 3 a squared
        y = torch.empty(B, m, **kw)
        ypart = torch.empty(B, stripe_partials(n, W), m, dtype=torch.float64,
                            device=A.device)
    if mode != 1:
        t = torch.empty(B, n, **kw)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry()(mode, A.data_ptr(), int(A.dtype == torch.bfloat16),
                      _ptr(v), _ptr(alpha), _ptr(beta), _ptr(w), _ptr(y),
                      _ptr(t), _ptr(ypart), B, m, n, W, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (code {rc}) at "
                           f"B={B}, m={m}, n={n}, {A.dtype}")
    LAUNCHES[name] += 1
    return y, t


def a_matvec(A: torch.Tensor, w: torch.Tensor,
             square: bool = False) -> torch.Tensor:
    """``A @ w`` per instance, or ``(A * A) @ w`` with ``square=True``:
    A (B, m, n) f32 or bf16, w (B, n) f32 -> (B, m) f32."""
    _check_A(A)
    _check_vec("w", w, A, A.shape[2])
    if not A.is_cuda:
        return a_matvec_plain(A, w, square)
    return _launch("a_matvec", 3 if square else 1, A, None, None, None, w)[0]


def at_matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``A^T @ v`` per instance: v (B, m) f32 -> (B, n) f32."""
    _check_A(A)
    _check_vec("v", v, A, A.shape[1])
    if not A.is_cuda:
        return at_matvec_plain(A, v)
    return _launch("at_matvec", 2, A, v, None, None, None)[1]


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
    return _launch("ata_apply", 0, A, v, alpha, beta, w)
