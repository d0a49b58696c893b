"""LP problem container on torch tensors.

``LP`` is the standard-form problem ``min c@x  s.t.  A@x = b, x >= 0``.  A
single instance has ``c (n,)``, ``A (m, n)``, ``b (m,)``; a batch carries a
leading dimension on every field (``c (B, n)``, ``A (B, m, n)``, ``b (B, m)``,
``obj_offset (B,)``).  The solver works on batches only: a single solve is a
batch of one (see ``ipx_torch.ipm.batched.stack_lps``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LP:
    c: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    obj_offset: torch.Tensor    # added to c@x when reporting objectives

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    def astype(self, dtype: torch.dtype) -> "LP":
        return LP(c=self.c.to(dtype), A=self.A.to(dtype), b=self.b.to(dtype),
                  obj_offset=self.obj_offset.to(dtype))

    def to(self, device) -> "LP":
        return LP(c=self.c.to(device), A=self.A.to(device),
                  b=self.b.to(device), obj_offset=self.obj_offset.to(device))

    def with_a_storage(self, opts) -> "LP":
        """Apply ``SolverOptions.a_storage``: store A in bf16.

        The cast is the only place the storage dtype enters: b, c, the
        iterates and every contraction stay f32, and the kernels upcast A in
        registers.  Idempotent; a no-op for ``a_storage='float32'``.
        """
        if opts.a_storage == "bfloat16" and self.A.dtype != torch.bfloat16:
            return dataclasses.replace(self, A=self.A.to(torch.bfloat16))
        return self


def make_lp(c, A, b, obj_offset=0.0, dtype: torch.dtype | None = None,
            device="cuda") -> LP:
    """Build a single-instance ``LP`` from array-likes on ``device``."""
    c = torch.as_tensor(c, dtype=dtype, device=device)
    A = torch.as_tensor(A, dtype=dtype, device=device)
    b = torch.as_tensor(b, dtype=dtype, device=device)
    if A.ndim != 2 or c.ndim != 1 or b.ndim != 1:
        raise ValueError(f"bad LP shapes: c{tuple(c.shape)} "
                         f"A{tuple(A.shape)} b{tuple(b.shape)}")
    if tuple(A.shape) != (b.shape[0], c.shape[0]):
        raise ValueError(f"inconsistent LP shapes: c{tuple(c.shape)} "
                         f"A{tuple(A.shape)} b{tuple(b.shape)}")
    off = torch.as_tensor(obj_offset, dtype=c.dtype, device=device)
    return LP(c=c, A=A, b=b, obj_offset=off)
