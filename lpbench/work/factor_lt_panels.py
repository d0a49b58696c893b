"""Row 7: the Cholesky factor of an assembled matrix (its triangle read)."""
from lpbench.work._common import F32, cholesky_ops, factor_out_bytes, tri

MODULE = "ipx_torch.kernels.cholesky"


def work(M):
    B, m, _ = M.shape
    return B * cholesky_ops(m), B * (F32 * tri(m) + factor_out_bytes(m))
