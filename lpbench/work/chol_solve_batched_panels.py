"""Row 6: ``L L^T x = b`` from the panels, two sweeps."""
from lpbench.work._common import solve_bytes

MODULE = "ipx_torch.kernels.cholesky"


def work(panels, W, b):
    B, m = b.shape
    return B * 2 * m * m, B * solve_bytes(m)
