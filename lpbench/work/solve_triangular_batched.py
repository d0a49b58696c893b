"""Row 11: one blocked sweep, ``L y = b`` or ``L^T x = b``."""
from lpbench.work._common import solve_bytes

MODULE = "ipx_torch.kernels.cholesky"


def work(L, W, b, lower=True):
    B, m = b.shape
    return B * m * m, B * solve_bytes(m)
