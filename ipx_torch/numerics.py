"""Batched linear-algebra helpers.

Every tensor carries a leading batch dimension: matrices are ``(B, r, k)``,
vectors ``(B, k)``, per-instance scalars ``(B,)``.

Float32 products here are IEEE float32: the Mehrotra iteration needs
f32-accurate residuals and refinement matvecs to reach a 1e-6 relative gap,
and TF32 keeps about three decimal digits.  The module refuses to load with
TF32 matmuls switched on and never switches them on.
"""
from __future__ import annotations

import torch

if torch.backends.cuda.matmul.allow_tf32 is not False:
    # an assertion that survives ``python -O``
    raise AssertionError(
        "ipx_torch needs IEEE float32 matmuls: "
        "torch.backends.cuda.matmul.allow_tf32 must stay False")

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _like(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # torch.matmul refuses mixed dtypes.  A bf16-stored A that reaches a
    # library matmul is upcast here: a TRANSIENT copy of A in the vector's
    # dtype (for B=256, m=1024, n=2048 in f32 that is 2 GiB).  The fused
    # kernels exist so that the main path never takes this branch.
    return a if a.dtype == x.dtype else a.to(x.dtype)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix @ matrix."""
    return torch.matmul(_like(a, b), b)


def mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix @ vector: ``(B, r, k) @ (B, k) -> (B, r)``.  Pass
    ``a.mT`` for the transposed product (a view; nothing is copied)."""
    return torch.matmul(_like(a, x), x.unsqueeze(-1)).squeeze(-1)


def mv_wide(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`mv` summed in float64 and rounded once to ``x``'s dtype, as the
    matvec kernels sum.  A library float32 matrix-vector product may sum
    each entry in one float32 chain (torch's on the CPU does), which the
    summation rule does not accept.  The transient copy of ``a`` is
    float64."""
    if x.dtype == torch.float64:
        return mv(a, x)
    f64 = torch.float64
    return torch.matmul(a.to(f64), x.to(f64).unsqueeze(-1)).squeeze(-1).to(
        x.dtype)


def vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-instance dot product ``(B, k), (B, k) -> (B,)``."""
    return (x * y).sum(dim=-1)


def inf_norm(v: torch.Tensor) -> torch.Tensor:
    """Per-instance max-abs ``(B, k) -> (B,)`` (0 for k == 0)."""
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    return v.abs().amax(dim=-1)
