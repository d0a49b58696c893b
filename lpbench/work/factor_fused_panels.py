"""Row 5: the Cholesky factor of ``J (A D^2 A^T) J + reg I`` from A: the
assembly as row 4's, the Jacobi scale and the factor."""
from lpbench.work._common import F32, cholesky_ops, factor_out_bytes, tri

MODULE = "ipx_torch.kernels.cholesky"


def work(A, d2, j, reg):
    B, m, n = A.shape
    ops = B * (m * n + 2 * n * tri(m) + 2 * tri(m) + cholesky_ops(m))
    nbytes = (A.numel() * A.element_size() + F32 * B * (n + m + 1)
              + B * factor_out_bytes(m))
    return ops, nbytes
