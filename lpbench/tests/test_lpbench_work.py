"""The kernel entries' work functions against operations and bytes counted
by hand at small shapes, and every entry the port's tracer wraps has one."""
from __future__ import annotations

import pytest
import torch

from lpbench import harness, tracing

ENTRIES = ("ata_apply", "a_matvec", "at_matvec", "assemble_sym_batched",
           "factor_fused_panels", "diag_factor_inv",
           "chol_solve_batched_panels", "factor_lt_panels",
           "chol_solve_batched_lt", "cholesky_batched", "factor_lt_batched",
           "solve_triangular_batched")


def w(entry):
    return harness.load_work(entry).work


def t(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype)


def test_the_twelve_entries_have_work_files():
    """Each names the port's module that holds the entry."""
    import importlib
    assert sorted(ENTRIES) == harness.kernel_entries()
    for entry in ENTRIES:
        mod = importlib.import_module(harness.load_work(entry).MODULE)
        assert callable(getattr(mod, entry))


@pytest.mark.parametrize("entry, args, kwargs, ops, nbytes", [
    # A 2x3x5 f32: 2 products of 2*3*5 multiply-adds, 3 elementwise ops on
    # n; A 120 bytes, v 24, alpha/w/beta 3*40, y 24 and t 40
    ("ata_apply", (t(2, 3, 5), t(2, 3), t(2, 5), t(2, 5), t(2, 5)), {},
     4 * 30 + 3 * 10, 120 + 24 + 120 + 24 + 40),
    # the pair (A w, A^T v): no elementwise ops, w alone among the n-vectors
    ("ata_apply", (t(2, 3, 5), t(2, 3), None, t(2, 5)), {},
     4 * 30, 120 + 24 + 40 + 24 + 40),
    ("a_matvec", (t(2, 3, 5), t(2, 5)), {}, 60, 120 + 40 + 24),
    ("a_matvec", (t(2, 3, 5, dtype=torch.bfloat16), t(2, 5)),
     {"square": True, "out_dtype": torch.float64}, 90, 60 + 40 + 48),
    ("at_matvec", (t(2, 3, 5), t(2, 3)), {}, 60, 120 + 24 + 40),
    # M = (A d2) A^T, m=2, n=3: 6 scalings, 3 entries of 3 multiply-adds
    ("assemble_sym_batched", (t(1, 2, 3, dtype=torch.bfloat16), t(1, 3)),
     {}, 6 + 18, 12 + 12 + 16),
])
def test_small_shapes(entry, args, kwargs, ops, nbytes):
    assert w(entry)(*args, **kwargs) == (ops, nbytes)


def test_factors_and_solves_at_m_256():
    m, nb = 256, 128
    chol = m ** 3 / 3 + 2 * nb ** 3 / 3       # factor + two 128 inverses
    tri = m * (m + 1) // 2
    w_tri = 2 * nb * (nb + 1) // 2
    out = 4 * (tri + w_tri)
    M = t(3, m, m)
    for entry in ("factor_lt_panels", "cholesky_batched",
                  "factor_lt_batched"):
        assert w(entry)(M) == (3 * chol, 3 * (4 * tri + out))
    # the pair-solve: 2 m^2 operations; the factor's one off-diagonal
    # 128 x 128 block, W's two triangles, b and x
    b = t(3, m)
    solve = 4 * (nb * nb + w_tri + 2 * m)
    assert w("chol_solve_batched_panels")((t(3, nb, m), t(3, nb, nb)), None,
                                          b) == (3 * 2 * m * m, 3 * solve)
    assert w("chol_solve_batched_lt")(M, None, b) == (3 * 2 * m * m,
                                                      3 * solve)
    assert w("solve_triangular_batched")(M, None, b, lower=False) == (
        3 * m * m, 3 * solve)
    # the diagonal block: factor and inverse, one triangle in, two out
    assert w("diag_factor_inv")(t(5, nb, nb)) == (
        5 * 2 * nb ** 3 / 3, 5 * 3 * 4 * nb * (nb + 1) // 2)
    # the fused factor: row 4's assembly, J M J, the factor
    A = t(2, m, 512, dtype=torch.bfloat16)
    ops = 2 * (m * 512 + 2 * 512 * tri + 2 * tri + chol)
    nbytes = A.numel() * 2 + 2 * 4 * (512 + m + 1) + 2 * out
    assert w("factor_fused_panels")(A, t(2, 512), t(2, m), t(2)) == (
        ops, nbytes)


def test_bound_takes_the_larger_side():
    assert tracing.bound_s(989e12, 0) == pytest.approx(1.0)
    assert tracing.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert tracing.bound_s(989e9, 3.35e12) == pytest.approx(1.0)
