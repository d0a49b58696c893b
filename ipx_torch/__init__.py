"""ipx_torch: the interior-point LP solver of ``ipx`` on PyTorch and CUDA.

Mehrotra predictor-corrector on batches of dense standard-form LPs,
normal-equations KKT solves by batched Cholesky with matrix-free CG
refinement, and hand-written CUDA kernels for the A streams and the
normal-matrix assembly.  Imports torch and numpy only.
"""
from ipx_torch.options import SolverOptions, DEFAULT_OPTIONS
from ipx_torch.status import Status
from ipx_torch.problem.lp import LP, make_lp
from ipx_torch.api import Solution, solve, solve_batch

__version__ = "0.1.0"

__all__ = ["SolverOptions", "DEFAULT_OPTIONS", "Status", "LP", "make_lp",
           "Solution", "solve", "solve_batch"]
