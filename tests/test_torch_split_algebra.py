"""The exact bf16 split that the tensor-core kernels multiply with, modelled
in numpy: ``split2`` / ``split8`` of ``ipx_torch/csrc/mma_common.cuh`` cut a
float32 x into hi + mid + lo, each rounded to the nearest bf16 (ties to
even) of what the parts before it left, the remainders taken by float32
subtractions.  Row 4's float32 kernel splits both operands, the row operand
x = f32(A * d2) and the column operand A, and takes six of the nine cross
products (``csrc/assemble_sym.cu``).  Checked here on the CPU: the parts
add up to x exactly over the range a solve's d2 spans (and down to the
limit the source states), every product of two parts is exact in float32
(what a tensor core multiplies), and the six products come within
3 * 2^-24 of the float64 product."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SIX = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))   # (x part, y part)
EXACT_FROM = -110       # the split is exact for |x| >= 2^EXACT_FROM


def bf16_rn(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16, ties to even, as float32
    (``__floats2bfloat162_rn``)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    up = ((u >> 16) & np.uint32(1)) + np.uint32(0x7FFF)
    return ((u + up) & np.uint32(0xFFFF0000)).view(np.float32)


def split2(x: np.ndarray):
    """hi, mid, lo of float32 x, as ``split2`` computes them."""
    x = np.asarray(x, np.float32)
    hi = bf16_rn(x)
    r = np.subtract(x, hi, dtype=np.float32)
    mid = bf16_rn(r)
    lo = bf16_rn(np.subtract(r, mid, dtype=np.float32))
    return hi, mid, lo


def split8(x: np.ndarray):
    """``split8``: eight floats at a time, each pair by ``split2``; the
    same parts, value by value."""
    x = np.asarray(x, np.float32).reshape(-1, 8)
    parts = [split2(x[:, 2 * i:2 * i + 2]) for i in range(4)]
    return tuple(np.concatenate([p[k] for p in parts], axis=1).reshape(-1)
                 for k in range(3))


def _row_operand(k: int, n: int = 4096, seed: int = 0):
    """A (float32, one row of a scaled normal matrix's factor) and
    x = f32(A * d2) with d2 around 10^k, spread over a decade."""
    rng = np.random.default_rng(seed + 100 * (k + 20))
    A = (rng.standard_normal(n) / np.sqrt(2048)).astype(np.float32)
    d2 = (10.0 ** k * np.exp(rng.standard_normal(n))).astype(np.float32)
    return A, np.multiply(A, d2, dtype=np.float32)


def _sum64(parts) -> np.ndarray:
    hi, mid, lo = (p.astype(np.float64) for p in parts)
    return hi + mid + lo          # exact: the parts span 24 bits


def test_bf16_model_is_torch_rounding():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(1 << 16)
         * 2.0 ** rng.integers(-120, 120, 1 << 16)).astype(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bf16_rn(x), want)


@pytest.mark.parametrize("k", range(-10, 11, 2))
def test_split_of_both_operands_is_exact(k):
    """hi + mid + lo == x for x = f32(A o d2) with d2 from 1e-10 to 1e10,
    and for A itself; each part a bf16; split8 gives split2's parts."""
    A, x = _row_operand(k)
    for v in (x, A):
        parts = split8(v)
        np.testing.assert_array_equal(_sum64(parts), v.astype(np.float64))
        for p in parts:
            assert not np.any(p.view(np.uint32) & np.uint32(0xFFFF))
        for p, q in zip(parts, split2(v)):
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("e", [EXACT_FROM, -100, -40, -1, 0, 30, 126])
def test_split_is_exact_down_to_its_limit(e):
    """Exact for every |x| in [2^e, 2^(e+1)) from 2^-110 up; tiny values
    included (the lo part of x near 2^-110 is a bf16 subnormal)."""
    rng = np.random.default_rng(e + 1000)
    x = (rng.uniform(1.0, 2.0, 1 << 16) * 2.0 ** e
         * rng.choice([-1.0, 1.0], 1 << 16)).astype(np.float32)
    np.testing.assert_array_equal(_sum64(split2(x)), x.astype(np.float64))


def test_split_stops_being_exact_below_its_limit():
    """Below 2^-110 the lo part needs bits finer than bf16's subnormal step
    (2^-133): the limit the source states is the real one."""
    rng = np.random.default_rng(3)
    x = (rng.uniform(1.0, 2.0, 1 << 12) * 2.0 ** (EXACT_FROM - 1)
         ).astype(np.float32)
    assert np.any(_sum64(split2(x)) != x.astype(np.float64))


@pytest.mark.parametrize("k", [-10, -4, 0, 4, 10])
def test_six_cross_products(k):
    """Each product of two parts is exact in float32 (a tensor core's
    products are); the six products the kernel takes come within 3 * 2^-24
    of x * y entry by entry, and their sum over a row within 3 * 2^-24 of
    the sum of |x y|; the three dropped ones are that small."""
    _, x = _row_operand(k)
    y, _ = _row_operand(k, seed=7)      # another row of A: the column operand
    px, py = split8(x), split8(y)
    exact = x.astype(np.float64) * y.astype(np.float64)
    six = np.zeros_like(exact)
    for i, j in SIX:
        prod = px[i].astype(np.float64) * py[j].astype(np.float64)
        np.testing.assert_array_equal(
            np.multiply(px[i], py[j], dtype=np.float32).astype(np.float64),
            prod)
        six += prod
    tol = 3 * 2.0 ** -24
    assert np.all(np.abs(six - exact) <= tol * np.abs(exact))
    assert abs(six.sum() - exact.sum()) <= tol * np.abs(exact).sum()
    dropped = sum(px[i].astype(np.float64) * py[j].astype(np.float64)
                  for i, j in ((1, 2), (2, 1), (2, 2)))
    np.testing.assert_allclose(six + dropped, exact, rtol=2.0 ** -40, atol=0)
