"""ipx_torch.kernels.cholesky.assemble_sym_batched against
ipx.kernels.cholesky.assemble_sym_batched (Pallas, interpret mode on the
CPU) and an f64 oracle, on the same numpy inputs.  Tolerance 2e-6 relative to
the f64 result's inf-norm: both sides are f32-faithful products of the same
bf16 values and differ in summation order only.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ipx.kernels import cholesky as jpk
from ipx_torch.kernels import cholesky as tpk
from ipx_torch.linsys import normal_eq as tne

torch.set_num_threads(1)

TOL = 2e-6


def _inputs(B, m, n, seed):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, m, n)) / np.sqrt(n)).astype(np.float32)
    d2 = np.exp(1.5 * rng.standard_normal((B, n))).astype(np.float32)
    At = torch.from_numpy(A).to(torch.bfloat16)
    Aj = jnp.asarray(A).astype(jnp.bfloat16)
    A64 = At.to(torch.float64).numpy()
    return A64, At, Aj, d2


@pytest.mark.parametrize("B,m,n", [(2, 128, 256), (1, 256, 256)])
def test_assemble_matches_ipx_and_f64(B, m, n):
    A64, At, Aj, d2 = _inputs(B, m, n, 5)
    M = tpk.assemble_sym_batched(At, torch.from_numpy(d2))
    Mj = np.asarray(jpk.assemble_sym_batched(Aj, jnp.asarray(d2)))
    M64 = np.einsum("bin,bn,bjn->bij", A64, d2.astype(np.float64), A64)
    assert M.dtype == torch.float32 and tuple(M.shape) == (B, m, m)
    assert torch.equal(M, M.mT), "M must be exactly symmetric"
    scale = np.abs(M64).max()
    assert np.abs(M.numpy() - Mj).max() <= TOL * scale
    assert np.abs(M.numpy() - M64).max() <= TOL * scale


@pytest.mark.parametrize("m,n", [(64, 128), (200, 136), (300, 130)])
def test_assemble_ragged_shapes_f32_and_bf16(m, n):
    """Shapes the TPU kernel's gate refuses (m or n off the 128 grid) are
    taken here; f32-stored A as well."""
    A64, At, _, d2 = _inputs(2, m, n, 9)
    for A in (At, At.to(torch.float32)):
        M = tpk.assemble_sym_batched(A, torch.from_numpy(d2))
        M64 = np.einsum("bin,bn,bjn->bij", A64, d2.astype(np.float64), A64)
        assert torch.equal(M, M.mT)
        assert np.abs(M.numpy() - M64).max() <= TOL * np.abs(M64).max()


@pytest.mark.parametrize("m", [128, 320])
def test_normal_eq_assemble_routes(m):
    """normal_eq.assemble: a bf16 A takes the kernel's function, an f32 or
    f64 A the block recursion; all agree with the f64 product."""
    n = 256
    A64, At, _, d2 = _inputs(2, m, n, 13)
    d2t = torch.from_numpy(d2)
    M64 = np.einsum("bin,bn,bjn->bij", A64, d2.astype(np.float64), A64)
    scale = np.abs(M64).max()
    for A, d, tol in ((At, d2t, TOL), (At.float(), d2t, TOL),
                      (At.double(), d2t.double(), 1e-14)):
        M = tne.assemble(A, d)
        assert M.dtype == d.dtype
        assert torch.equal(M, M.mT)
        assert np.abs(M.double().numpy() - M64).max() <= tol * scale
