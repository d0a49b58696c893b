"""ipx_torch.kernels.fused against ipx.kernels.fused on the same inputs.

The JAX side runs its Pallas kernels in interpret mode (as its own tests do
on the CPU); the port runs its plain versions on CPU tensors.  Inputs are
made with numpy from a seed.  Tolerance: 2e-6 relative to the inf-norm of an
f64 evaluation; both sides compute in f32 and differ only in summation
order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipx.kernels import fused as jfk
from ipx_torch.kernels import fused as tfk

torch.set_num_threads(1)

TOL = 2e-6
SHAPES = [(2, 64, 128), (1, 128, 256), (3, 64, 384)]


def _inputs(B, m, n, seed, bf16):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, m, n)) / np.sqrt(n)).astype(np.float32)
    v = rng.standard_normal((B, m)).astype(np.float32)
    alpha = np.exp(rng.standard_normal((B, n))).astype(np.float32)
    w = rng.standard_normal((B, n)).astype(np.float32)
    beta = rng.standard_normal((B, n)).astype(np.float32)
    At = torch.from_numpy(A)
    Aj = jnp.asarray(A)
    if bf16:
        At = At.to(torch.bfloat16)
        Aj = Aj.astype(jnp.bfloat16)
        A = At.to(torch.float32).numpy()      # the stored values
        np.testing.assert_array_equal(np.asarray(Aj.astype(jnp.float32)), A)
    return A.astype(np.float64), At, Aj, v, alpha, w, beta


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _close(got, ref_jax, ref64):
    scale = np.abs(ref64).max()
    assert np.abs(np.asarray(got) - np.asarray(ref_jax)).max() <= TOL * scale
    assert np.abs(np.asarray(got) - ref64).max() <= TOL * scale


def _ata_both(At, Aj, v, alpha, w, beta):
    y, t = tfk.ata_apply(At, _t(v), _t(alpha), _t(w), beta=_t(beta))
    in_axes = (0, 0, None if alpha is None else 0, None if w is None else 0,
               None if beta is None else 0)
    yj, tj = jax.vmap(jfk.ata_apply, in_axes=in_axes)(
        Aj, _j(v), _j(alpha), _j(w), _j(beta))
    return y.numpy(), t.numpy(), yj, tj


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,m,n", SHAPES)
@pytest.mark.parametrize("mode", ["full", "beta", "pair", "operator"])
def test_ata_apply_matches_ipx(mode, B, m, n, bf16):
    A64, At, Aj, v, alpha, w, beta = _inputs(B, m, n, 7, bf16)
    if mode == "full":
        beta = None
    elif mode == "pair":
        alpha = beta = None
    elif mode == "operator":
        w = beta = None
    y, t, yj, tj = _ata_both(At, Aj, v, alpha, w, beta)
    z = np.zeros((B, n))
    t64 = np.einsum("bmn,bm->bn", A64, v)
    u64 = ((z if alpha is None else alpha) * (t64 + (z if beta is None else beta))
           + (z if w is None else w))
    y64 = np.einsum("bmn,bn->bm", A64, u64)
    _close(t, tj, t64)
    _close(y, yj, y64)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,m,n", SHAPES)
def test_a_and_at_matvec_match_ipx(B, m, n, bf16):
    A64, At, Aj, v, _, w, _ = _inputs(B, m, n, 11, bf16)
    y = tfk.a_matvec(At, _t(w)).numpy()
    t = tfk.at_matvec(At, _t(v)).numpy()
    yj = jax.vmap(jfk.a_matvec)(Aj, _j(w))
    tj = jax.vmap(jfk.at_matvec)(Aj, _j(v))
    _close(y, yj, np.einsum("bmn,bn->bm", A64, w))
    _close(t, tj, np.einsum("bmn,bm->bn", A64, v))


def test_beta_sum_is_rounded_before_the_alpha_scale():
    """t + beta cancels almost completely and alpha is huge: forming
    alpha*t + alpha*beta instead would lose the difference."""
    B, m, n = 1, 64, 128
    A64, At, _, v, _, _, _ = _inputs(B, m, n, 3, False)
    t = tfk.at_matvec(At, _t(v))
    beta = -t * (1 + 2e-7)
    alpha = torch.full((B, n), 1e10)
    y, t2 = tfk.ata_apply(At, _t(v), alpha, None, beta=beta)
    assert torch.equal(t, t2)
    e = (t + beta).double()                       # the rounded f32 sum
    y64 = np.einsum("bmn,bn->bm", A64, (alpha.double() * e).numpy())
    assert np.abs(y.numpy() - y64).max() <= 1e-5 * np.abs(y64).max()


def test_stripe_cols_gate():
    """Row 1's stripe caps m (``ata_apply`` refuses m = 65536); rows 2 and 3
    stream rows and have a tiling for it."""
    assert tfk.stripe_cols(1024, 2) == 32
    assert tfk.stripe_cols(1024, 4) == 16
    assert tfk.stripe_cols(4096, 2) in (8, 16)
    assert tfk.stripe_cols(1 << 16, 4) is None
    assert tfk.at_partials(1 << 16, 4) == (1 << 16) // tfk.at_tile(4)
    assert tfk.a_span(2048, 4) == 2048 and tfk.a_partials(2048, 4) == 0


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("square", [False, True], ids=["plain", "squared"])
def test_float64_out_plain_versions_are_mv64(square, bf16):
    """``out_dtype=torch.float64``: the plain versions are float64 products
    of the stored values, what ``numerics.mv64`` computes, unrounded."""
    from ipx_torch import numerics
    B, m, n = 2, 64, 128
    _, At, _, v, alpha, w, _ = _inputs(B, m, n, 5, bf16)
    x = _t(alpha if square else w)
    f64 = torch.float64
    y = tfk.a_matvec(At, x, square=square, out_dtype=f64)
    A2 = At.double().square() if square else At
    assert y.dtype == f64 and torch.equal(y, numerics.mv64(A2, x))
    t = tfk.at_matvec(At, _t(v), out_dtype=f64)
    ref = numerics.mv64(At.mT, _t(v))
    assert t.dtype == f64
    assert (t - ref).abs().max() <= 1e-14 * ref.abs().max()
    # rounded once, the float32 outputs are within the plain version's
    # float32 summation error of them
    y32 = tfk.a_matvec(At, x, square=square)
    assert (y32.double() - y).abs().max() <= TOL * y.abs().max()


def test_out_dtype_is_float32_or_float64():
    A = torch.zeros(1, 4, 8)
    with pytest.raises(TypeError):
        tfk.a_matvec(A, torch.zeros(1, 8), out_dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tfk.at_matvec(A, torch.zeros(1, 4), out_dtype=torch.float16)
