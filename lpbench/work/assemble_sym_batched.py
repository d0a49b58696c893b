"""Row 4: ``M = (A * d2) A^T``, symmetric: A scaled once, the product
counted once per entry of the lower triangle; M written whole."""
from lpbench.work._common import F32, tri

MODULE = "ipx_torch.kernels.cholesky"


def work(A, d2):
    B, m, n = A.shape
    ops = B * (m * n + 2 * n * tri(m))
    return ops, A.numel() * A.element_size() + F32 * B * (n + m * m)
