"""The benchmark's LPs, made on the device from a seed.

A frozen copy, in plain torch, of the port's two device generators
(``ipx_torch.problem.generate.random_feasible_batch_device`` and
``random_feasible_large_device``): a strictly complementary primal-dual
pair (x*, y*, s*) with support m is drawn, then b = A x* and
c = A^T y* + s*, so c.x* is the known optimum of the LP as handed to the
solver.  A is drawn in float32 and stored in the configuration's dtype; a
bfloat16 A is rounded BEFORE b and c are formed from it, so the stored
values are the LP's own.  Imports torch only: the yardstick takes nothing
from the program.
"""
from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def call_seed(seed: int, call: int) -> int:
    """The generator seed of one call of a run: a 63-bit mix of the run's
    seed (any whole number, also above 2**31) and the call's index."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(call)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(seed: int, call: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(call_seed(seed, call))


def batch(B: int, m: int, n: int, gen: torch.Generator, a_dtype: str,
          device) -> dict:
    """``B`` LPs of shape (m, n), batched on ``device``: c (B, n), A (B, m,
    n) as stored, b (B, m), obj_offset (B,), x_star (B, n), y_star (B, m),
    s_star (B, n), float32 but A."""
    f32 = torch.float32
    kw = dict(generator=gen, device=device, dtype=f32)
    A = torch.randn(B, m, n, **kw) / (n ** 0.5)
    if a_dtype == "bfloat16":
        A = A.to(torch.bfloat16)
    perm = torch.argsort(torch.rand(B, n, **kw), dim=-1)
    x = torch.zeros(B, n, device=device, dtype=f32)
    x.scatter_(1, perm[:, :m], 0.5 + 1.5 * torch.rand(B, m, **kw))
    s = torch.zeros(B, n, device=device, dtype=f32)
    s.scatter_(1, perm[:, m:], 0.5 + 1.5 * torch.rand(B, n - m, **kw))
    y = torch.randn(B, m, **kw)
    Af = A.to(f32)
    b = torch.matmul(Af, x.unsqueeze(-1)).squeeze(-1)
    c = torch.matmul(y.unsqueeze(1), Af).squeeze(1) + s
    del Af
    return dict(c=c, A=A, b=b, obj_offset=torch.zeros(B, device=device),
                x_star=x, y_star=y, s_star=s)


def large(m: int, n: int, gen: torch.Generator, a_dtype: str, device,
          rows: int = 2048) -> dict:
    """One LP of shape (m, n) as a batch of one, A drawn ``rows`` rows at a
    time (a float32 copy of a large A is gigabytes); b and c summed in
    float64 a block of rows at a time and rounded to float32."""
    kw = dict(generator=gen, device=device)
    dt = DTYPES[a_dtype]
    A = torch.empty(m, n, dtype=dt, device=device)
    for r0 in range(0, m, rows):
        r1 = min(m, r0 + rows)
        A[r0:r1] = (torch.randn(r1 - r0, n, **kw) / n ** 0.5).to(dt)
    perm = torch.randperm(n, **kw)
    x = torch.zeros(n, device=device)
    x[perm[:m]] = 0.5 + 1.5 * torch.rand(m, **kw)
    s = torch.zeros(n, device=device)
    s[perm[m:]] = 0.5 + 1.5 * torch.rand(n - m, **kw)
    y = torch.randn(m, **kw)
    f64 = torch.float64
    b = torch.empty(m, dtype=f64, device=device)
    c = s.to(f64)
    for r0 in range(0, m, rows):
        blk = A[r0:r0 + rows].to(f64)
        b[r0:r0 + rows] = blk @ x.to(f64)
        c += y[r0:r0 + rows].to(f64) @ blk
        del blk
    one = lambda t: t.unsqueeze(0)
    return dict(c=one(c.float()), A=one(A), b=one(b.float()),
                obj_offset=torch.zeros(1, device=device), x_star=one(x),
                y_star=one(y), s_star=one(s))

