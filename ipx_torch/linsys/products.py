"""Products with A: which code computes A w and A^T v, for every route.

The rule.  On the card, with A stored float32 or bfloat16, every product
with A is a launch of ``kernels.fused``: the fused route's one-stream
``ata_apply`` (row 1) where its algebra asks for it, else ``a_matvec`` /
``at_matvec`` (rows 2 and 3: float64 sums rounded once, or float64 out,
no copy of A, any m and n).  Off the card, and for an A stored float64,
each route keeps the library product it has always had, and only the sums
differ:

    "working"  ``numerics.mv``: the dense route and ``"sharded"``
    "wide"     ``numerics.mv_wide``, float64 sums rounded once to the
               vector's dtype: the augmented routes
    "f64"      ``numerics.mv64``, float64 out: ``"sharded_schur"``'s local
               sums (rounded after the all-reduce) and the re-check of the
               Solutions

The fused route (:func:`use_fused_matvec`) takes the kernels' wrappers on
either device; on the CPU they run their plain versions.

Why.  On the card a library float32 product sums each entry in one float32
chain, which leaves an iterate's dual residual near 1e-6 of its scale
against a tolerance of 1.9e-6, and stage 1 then crawls with short steps;
summed in float64 it sits near 1e-7.  Rows 2 and 3 sum in float64 and read
A as stored, where a library product of a bf16 A needs a transient copy.
On the CPU the library products stay bit for bit, so that the port runs in
step with ``ipx`` there: the augmented routes and ``"sharded_schur"`` sum
in float64 because with one-chain float32 sums the CPU's batches of
degenerate LPs lose lanes on them.

The route-level choice, and the all-reduce of the sharded routes, are
``normal_eq.matvecs`` and ``schur.matvecs``; this module decides for one
A.  Every kernel call resolves ``kernels.fused``'s attribute when it runs,
so a wrapper put on the module sees every product.
"""
from __future__ import annotations

import torch

from ipx_torch.kernels import fused as fk
from ipx_torch.numerics import mv, mv64, mv_wide
from ipx_torch.options import SolverOptions

ROW_DTYPES = (torch.float32, torch.bfloat16)


def use_fused_matvec(opts: SolverOptions, A: torch.Tensor) -> bool:
    """Whether A's products go through ``kernels.fused`` on the fused
    route: asked for by ``matvec_backend``, A stored f32 or bf16, dense
    route.  The shape plays no part: an A on the card whose rows the
    kernels cannot hold is refused by their wrapper, never handed to
    library matmuls instead."""
    return (opts.matvec_backend == "fused" and A.dtype in ROW_DTYPES
            and opts.linsys == "dense")


def on_card(A: torch.Tensor) -> bool:
    """The card test: A stored f32 or bf16 on a CUDA device, whose products
    then run on rows 2 and 3."""
    return A.device.type == "cuda" and A.dtype in ROW_DTYPES


def product(A: torch.Tensor, x: torch.Tensor, tr: bool,
            sums: str = "working", fused: bool = False) -> torch.Tensor:
    """A x, or A^T x with ``tr``, per lane, summed as ``sums`` says: in
    x's dtype for ``"working"`` and ``"wide"``, float64 for ``"f64"``.
    Rows 2 and 3 take float32 vectors: for ``"f64"`` x is rounded to
    float32 first, which is exact for the iterates of a float32 solve, the
    only solve that holds an A stored float32 or bf16."""
    if fused or on_card(A):
        if sums == "f64":
            x, out = x.to(torch.float32).contiguous(), torch.float64
        else:
            x, out = x.contiguous(), torch.float32
        return (fk.at_matvec(A, x, out_dtype=out) if tr
                else fk.a_matvec(A, x, out_dtype=out))
    lib = {"working": mv, "wide": mv_wide, "f64": mv64}[sums]
    return lib(A.mT if tr else A, x)


def pair(A: torch.Tensor, sums: str = "working", fused: bool = False):
    """(w -> A w, v -> A^T v) for this A: :func:`product` both ways."""
    return ((lambda w: product(A, w, False, sums, fused)),
            (lambda v: product(A, v, True, sums, fused)))
