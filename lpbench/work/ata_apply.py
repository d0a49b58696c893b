"""Row 1: ``y = A (alpha (A^T v + beta) + w)``, ``t = A^T v``; with
``alpha=None`` the pair ``(A w, A^T v)``."""
from lpbench.work._common import F32

MODULE = "ipx_torch.kernels.fused"


def work(A, v, alpha, w, beta=None):
    B, m, n = A.shape
    ops = 4 * B * m * n + (3 * B * n if alpha is not None else 0)
    vecs = sum(x is not None for x in (alpha, w, beta))
    nbytes = (A.numel() * A.element_size() + F32 * B * m
              + F32 * B * n * vecs + F32 * B * (m + n))
    return ops, nbytes
