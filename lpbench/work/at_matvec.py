"""Row 3: ``A^T v``."""
import torch

from lpbench.work._common import F32

MODULE = "ipx_torch.kernels.fused"


def work(A, v, out_dtype=torch.float32):
    B, m, n = A.shape
    out = torch.empty((), dtype=out_dtype).element_size()
    nbytes = A.numel() * A.element_size() + F32 * B * m + out * B * n
    return 2 * B * m * n, nbytes
