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


# the most a product's transient copy of its matrix may take: a larger
# copy is made and used in blocks of the matrix's rows
COPY_BYTES = 1 << 30


def _mv_as(a: torch.Tensor, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``a @ x`` with ``a`` and ``x`` taken in ``dt``.  Each output entry is
    one library product over all of ``a``'s columns; when ``a`` needs a copy
    of more than ``COPY_BYTES``, the copy is made a block of rows at a time
    (at m=32768, n=65536 a float32 copy of a bf16 A would be 8.6 GB)."""
    xd = x.to(dt).unsqueeze(-1)
    if a.dtype == dt:
        return torch.matmul(a, xd).squeeze(-1)
    r, k = a.shape[-2], a.shape[-1]
    per_row = k * dt.itemsize * max(1, a[..., :1, :1].numel())
    rows = max(1, COPY_BYTES // per_row)
    if rows >= r:
        return torch.matmul(a.to(dt), xd).squeeze(-1)
    out = torch.empty(a.shape[:-1], dtype=dt, device=a.device)
    for r0 in range(0, r, rows):
        out[..., r0:r0 + rows] = torch.matmul(a[..., r0:r0 + rows, :].to(dt),
                                              xd).squeeze(-1)
    return out


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix @ matrix."""
    return torch.matmul(_like(a, b), b)


def mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix @ vector: ``(B, r, k) @ (B, k) -> (B, r)``.  Pass
    ``a.mT`` for the transposed product (a view; nothing is copied)."""
    return _mv_as(a, x, x.dtype)


def mv64(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`mv` summed in float64 and returned in float64."""
    return _mv_as(a, x, torch.float64)


def mv_wide(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """:func:`mv` summed in float64 and rounded once to ``x``'s dtype, as the
    matvec kernels sum.  A library float32 matrix-vector product may sum
    each entry in one float32 chain (torch's on the CPU does), which the
    summation rule does not accept.  The transient copy of ``a`` is
    float64."""
    return mv64(a, x).to(x.dtype)


# the groups of :func:`lane_sum`'s first level on the card: torch's CUDA
# reduction gives each row one warp once it has at least 16 rows to reduce,
# and spreads a row over more threads below that (measured on the H100:
# one sum's bits at widths 1-15 differ from the whole batch's, at 16-255
# they agree)
LANE_GROUPS = 16


def lane_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension ``(..., k) -> (...)``, each lane's sum in
    an order that does not hang on the number of lanes, so that the lanes
    of a narrowed batch (``ipm.batched.run_batch``) get the bits they get
    in the whole batch.  On the card in two levels: ``LANE_GROUPS``
    contiguous parts of k (zero padded), then their partial sums; on the
    CPU, whose reduction already sums a row alike at any count of rows, one
    sum."""
    if not v.is_cuda:
        return v.sum(-1)
    k = v.shape[-1]
    if k % LANE_GROUPS:
        v = torch.nn.functional.pad(v, (0, -k % LANE_GROUPS))
    return v.reshape(*v.shape[:-1], LANE_GROUPS, -1).sum(-1).sum(-1)


def vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-instance dot product ``(B, k), (B, k) -> (B,)``, summed by
    :func:`lane_sum`."""
    return lane_sum(x * y)


def inf_norm(v: torch.Tensor) -> torch.Tensor:
    """Per-instance max-abs ``(B, k) -> (B,)`` (0 for k == 0)."""
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    return v.abs().amax(dim=-1)
