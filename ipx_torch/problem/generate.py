"""Random feasible LP generation with a known optimal solution.

Sample a strictly complementary primal-dual pair (x*, y*, s*) and construct
(b, c) from it, so the optimal objective c@x* is known by construction and
serves as a test oracle.  ``random_feasible_lp`` is the host (numpy) form,
``random_feasible_batch`` a list of such instances;
``random_feasible_batch_device`` makes a whole batch on the device,
``random_feasible_large_device`` one large LP there (config 4).
``random_general_lp`` makes a general LP (inequalities, bounds, free
variables) that is feasible and bounded by construction.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ipx_torch.problem.lp import LP, GeneralLP


@dataclass
class GeneratedLP:
    c: np.ndarray
    A: np.ndarray
    b: np.ndarray
    x_star: np.ndarray
    y_star: np.ndarray
    s_star: np.ndarray
    obj_star: float


def random_feasible_lp(
    m: int,
    n: int,
    seed: int = 0,
    support: int | None = None,
    scale_spread: float = 0.0,
) -> GeneratedLP:
    """Generate a dense standard-form LP with a known optimum.

    Construction: A ~ N(0, 1/n); pick a support P of size ``support``
    (default m, a nondegenerate vertex); x*_P > 0, x*_N = 0; s*_N > 0,
    s*_P = 0; y* ~ N(0,1). Then b = A x*, c = A^T y* + s*. Strict
    complementarity => c@x* = b@y* is the unique optimal value.

    ``scale_spread`` > 0 multiplies rows/cols by 10**U(-spread, spread) to
    produce badly scaled instances.
    """
    rng = np.random.default_rng(seed)
    if support is None:
        support = m
    support = min(support, n)

    A = rng.standard_normal((m, n)) / np.sqrt(n)
    if scale_spread > 0:
        A *= 10.0 ** rng.uniform(-scale_spread, scale_spread, size=(m, 1))
        A *= 10.0 ** rng.uniform(-scale_spread, scale_spread, size=(1, n))

    perm = rng.permutation(n)
    P = perm[:support]
    N = perm[support:]

    x_star = np.zeros(n)
    x_star[P] = rng.uniform(0.5, 2.0, size=support)
    s_star = np.zeros(n)
    s_star[N] = rng.uniform(0.5, 2.0, size=n - support)
    y_star = rng.standard_normal(m)

    b = A @ x_star
    c = A.T @ y_star + s_star
    obj_star = float(c @ x_star)
    return GeneratedLP(c=c, A=A, b=b, x_star=x_star, y_star=y_star,
                       s_star=s_star, obj_star=obj_star)


def random_feasible_batch(batch: int, m: int, n: int, seed: int = 0,
                          **kw) -> list[GeneratedLP]:
    """A list of independent instances (stacked by the caller)."""
    return [random_feasible_lp(m, n, seed=seed + i, **kw) for i in range(batch)]


def random_general_lp(seed: int = 0, n: int = 40, m_eq: int = 8,
                      m_ub: int = 20, n_free: int = 2,
                      scale_spread: float = 0.0):
    """Netlib-style general LP: inequalities + equalities + finite bounds +
    a few free variables, feasible and bounded by construction.

    Used as the in-repo stand-in for BASELINE config 2's "Netlib-style suite
    of 20 small/medium LPs" (real Netlib files can be fed through
    ipx_torch.solve_mps; the tests need self-contained instances).

    Construction: bounded variables get finite [lb, ub] (=> bounded LP);
    an interior point x0 gives feasible rhs.  Each free variable is pinned by
    one extra equality  f - a @ x_bounded = r  so it stays bounded while
    exercising the free-variable split in to_standard_form.
    """
    rng = np.random.default_rng(seed)
    nb = n - n_free
    lb = rng.uniform(-5.0, 0.0, nb)
    ub = lb + rng.uniform(1.0, 10.0, nb)
    x0b = lb + (ub - lb) * rng.uniform(0.2, 0.8, nb)

    A_eq_b = rng.standard_normal((m_eq, nb))
    A_ub_b = rng.standard_normal((m_ub, nb))
    if scale_spread > 0:
        A_eq_b *= 10.0 ** rng.uniform(-scale_spread, scale_spread, (m_eq, 1))
        A_ub_b *= 10.0 ** rng.uniform(-scale_spread, scale_spread, (m_ub, 1))

    # pin each free var with one equality  f_k - a_k @ x_b = r_k
    pin = rng.standard_normal((n_free, nb))
    f0 = pin @ x0b + rng.standard_normal(n_free)

    A_eq = np.zeros((m_eq + n_free, n))
    A_eq[:m_eq, :nb] = A_eq_b
    A_eq[m_eq:, :nb] = -pin
    A_eq[m_eq:, nb:] = np.eye(n_free)
    b_eq = np.concatenate([A_eq_b @ x0b, f0 - pin @ x0b])

    A_ub = np.zeros((m_ub, n))
    A_ub[:, :nb] = A_ub_b
    b_ub = A_ub_b @ x0b + rng.uniform(0.1, 2.0, m_ub)

    c = rng.standard_normal(n)
    lbv = np.concatenate([lb, np.full(n_free, -np.inf)])
    ubv = np.concatenate([ub, np.full(n_free, np.inf)])
    return GeneralLP(c=c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                     lb=lbv, ub=ubv, name=f"synth{seed}")


@dataclass
class GeneratedBatch:
    """A batched LP with its constructed optimum, all on one device."""
    lp: LP
    x_star: torch.Tensor    # (B, n)
    y_star: torch.Tensor    # (B, m)
    s_star: torch.Tensor    # (B, n)
    obj_star: torch.Tensor  # (B,) float64


def lp_from_optimum(A: torch.Tensor, x_star: torch.Tensor,
                    y_star: torch.Tensor, s_star: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> GeneratedBatch:
    """The batched LP whose optimum is (x*, y*, s*): b = A x*,
    c = A^T y* + s*, both formed in ``dtype`` from A's STORED values (a
    bf16-stored A stays bf16 in the LP; b and c see its exact values).
    ``obj_star = c@x*`` is taken in float64 from the ``dtype`` data, so it
    is the optimum of the instance the solver is given."""
    Ad = A.to(dtype)
    xs, ys, ss = x_star.to(dtype), y_star.to(dtype), s_star.to(dtype)
    b = torch.matmul(Ad, xs.unsqueeze(-1)).squeeze(-1)
    c = torch.matmul(ys.unsqueeze(1), Ad).squeeze(1) + ss
    obj = (c.double() * xs.double()).sum(-1)
    A_lp = A if A.dtype == torch.bfloat16 else Ad
    lp = LP(c=c, A=A_lp, b=b,
            obj_offset=torch.zeros(A.shape[0], dtype=dtype, device=A.device))
    return GeneratedBatch(lp=lp, x_star=xs, y_star=ys, s_star=ss,
                          obj_star=obj)


def random_feasible_batch_device(batch: int, m: int, n: int,
                                 generator: torch.Generator,
                                 a_storage: str = "float32",
                                 dtype: torch.dtype = torch.float32,
                                 device="cuda") -> GeneratedBatch:
    """``batch`` distinct instances of :func:`random_feasible_lp`'s
    construction (support m), drawn on ``device`` from ``generator``.

    With ``a_storage="bfloat16"`` the DATA is rounded to bf16 before b and c
    are computed from it, so bf16 storage is lossless and the constructed
    optimum is exact for the solved instance.  A float32 draw of A for the
    whole batch is a transient ``4*batch*m*n`` bytes.
    """
    if generator.device != torch.device(device):
        raise ValueError(f"generator lives on {generator.device}, "
                         f"batch requested on {device}")
    f32 = torch.float32
    kw = dict(generator=generator, device=device, dtype=f32)
    A = torch.randn(batch, m, n, **kw) / (n ** 0.5)
    if a_storage == "bfloat16":
        A = A.to(torch.bfloat16)
    perm = torch.argsort(torch.rand(batch, n, **kw), dim=-1)
    x_star = torch.zeros(batch, n, device=device, dtype=f32)
    x_star.scatter_(1, perm[:, :m], 0.5 + 1.5 * torch.rand(batch, m, **kw))
    s_star = torch.zeros(batch, n, device=device, dtype=f32)
    s_star.scatter_(1, perm[:, m:],
                    0.5 + 1.5 * torch.rand(batch, n - m, **kw))
    y_star = torch.randn(batch, m, **kw)
    return lp_from_optimum(A, x_star, y_star, s_star, dtype)


def random_feasible_large_device(m: int, n: int, generator: torch.Generator,
                                 a_dtype: torch.dtype = torch.bfloat16,
                                 device="cuda"):
    """One LP of :func:`random_feasible_lp`'s construction (support m) at a
    size where a float32 copy of A is gigabytes (config 4: m=32768,
    n=65536), drawn on ``device`` from ``generator``.  A is drawn in float32
    2048 rows at a time and stored as ``a_dtype`` (bf16: the DATA rounded
    before b and c are formed from it, so the constructed optimum is exact
    for the solved instance); b = A x* and c = A^T y* + s* are summed in
    float64 a block of A's rows at a time and rounded to float32.  Returns
    ``(lp, obj_star)``: a single-instance LP and c.x* in float64 from the
    float32 data."""
    from ipx_torch.numerics import mv64
    if generator.device != torch.device(device):
        raise ValueError(f"generator lives on {generator.device}, "
                         f"LP requested on {device}")
    kw = dict(generator=generator, device=device)
    A = torch.empty(m, n, dtype=a_dtype, device=device)
    for r0 in range(0, m, 2048):
        r1 = min(m, r0 + 2048)
        A[r0:r1] = (torch.randn(r1 - r0, n, **kw) / n ** 0.5).to(a_dtype)
    perm = torch.randperm(n, **kw)
    x = torch.zeros(n, device=device)
    x[perm[:m]] = 0.5 + 1.5 * torch.rand(m, **kw)
    s = torch.zeros(n, device=device)
    s[perm[m:]] = 0.5 + 1.5 * torch.rand(n - m, **kw)
    y = torch.randn(m, **kw)
    b = mv64(A.unsqueeze(0), x.unsqueeze(0))[0].float()
    c = (mv64(A.mT.unsqueeze(0), y.unsqueeze(0))[0] + s.double()).float()
    lp = LP(c=c, A=A, b=b, obj_offset=torch.zeros((), device=device))
    return lp, float((c.double() * x.double()).sum())
