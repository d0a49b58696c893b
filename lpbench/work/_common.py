"""What the work functions share: the diagonal block of the port's blocked
factors and the counts of its triangles.  The counts are the function's own
work, whatever implements it: 2 operations a multiply-add, a symmetric or
triangular result counted once per entry it needs, every input byte read
once and every output byte written once.  Where a kernel computes or moves
more (whole tiles, a split of each product into passes, a panel read twice)
that surplus is the kernel's and is not counted."""
NB = 128        # the diagonal block of the port's factors and solves
F32 = 4


def tri(k: int) -> int:
    """Entries of a k x k triangle with its diagonal."""
    return k * (k + 1) // 2


def cholesky_ops(m: int) -> float:
    """A Cholesky factor of an m x m matrix, and the inverses of its
    m / NB diagonal blocks of L (the W the solves take)."""
    return m ** 3 / 3 + (m // NB) * NB ** 3 / 3


def factor_out_bytes(m: int) -> int:
    """The factor's triangle and W's m / NB triangles, float32."""
    return F32 * (tri(m) + (m // NB) * tri(NB))


def solve_bytes(m: int) -> int:
    """A blocked pair-solve or one sweep: the factor's entries outside the
    diagonal blocks, W's triangles, b and x."""
    off = (m * m - (m // NB) * NB * NB) // 2
    return F32 * (off + (m // NB) * tri(NB) + 2 * m)
