"""Row 2: ``A w`` or, with ``square``, ``(A * A) w``."""
import torch

from lpbench.work._common import F32

MODULE = "ipx_torch.kernels.fused"


def work(A, w, square=False, out_dtype=torch.float32):
    B, m, n = A.shape
    ops = (3 if square else 2) * B * m * n
    out = torch.empty((), dtype=out_dtype).element_size()
    return ops, A.numel() * A.element_size() + F32 * B * n + out * B * m
