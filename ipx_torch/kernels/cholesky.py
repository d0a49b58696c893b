"""Normal-matrix assembly kernel (counterpart of the assembly part of
``ipx/kernels/cholesky.py``; the factor and solve kernels of that file are
not in this package yet).

``assemble_sym_batched`` computes ``M[b] = (A[b] * d2[b]) @ A[b]^T`` over the
lower triangle of 128 x 128 tiles only, symmetrises the diagonal tiles and
mirrors the rest, so M is exactly symmetric (``csrc/assemble_sym.cu``).  For
a CUDA tensor the wrapper launches the hand-written kernel or raises; for a
CPU tensor, and only then, it evaluates ``assemble_sym_batched_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from ipx_torch.kernels import _build

NB = 128    # tile edge of the symmetric structure (same as the kernel's TILE)

LAUNCHES = {"assemble_sym_batched": 0}


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


_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("assemble_sym").ipx_assemble_sym
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def assemble_sym_batched(A: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """A (B, m, n) f32 or bf16, d2 (B, n) f32 -> M (B, m, m) f32, exactly
    symmetric.  Any m, n: ragged tile edges are masked in the kernel.  Always
    f32-faithful (A is upcast in registers, the products are f32 FMAs,
    summed in two levels: 64-column chunks, then the chunk sums); the 2-term
    "high" assembly mode of ``ipx`` has no counterpart."""
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
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry()(A.data_ptr(), int(A.dtype == torch.bfloat16),
                      d2.data_ptr(), M.data_ptr(), B, m, n, stream)
    if rc != 0:
        raise RuntimeError(f"assemble_sym_batched: kernel launch failed "
                           f"(code {rc}) at B={B}, m={m}, n={n}, {A.dtype}")
    LAUNCHES["assemble_sym_batched"] += 1
    return M
