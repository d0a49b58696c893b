"""Row 5b: the Cholesky factor of each 128 x 128 diagonal block and its
inverse (triangles read and written)."""
from lpbench.work._common import F32, NB, tri

MODULE = "ipx_torch.kernels.cholesky"


def work(CD, out_lt=None, out_w=None, lower_out=False):
    B = CD.shape[0]
    return B * 2 * NB ** 3 / 3, B * 3 * F32 * tri(NB)
