"""Row 8: ``L L^T x = b`` from a full L^T, two sweeps."""
from lpbench.work._common import solve_bytes

MODULE = "ipx_torch.kernels.cholesky"


def work(LT, W, b):
    B, m = b.shape
    return B * 2 * m * m, B * solve_bytes(m)
