"""ipx_torch: the interior-point LP solver of ``ipx`` on PyTorch and CUDA.

Mehrotra predictor-corrector on batches of dense standard-form LPs,
normal-equations KKT solves by batched Cholesky with matrix-free CG
refinement, and hand-written CUDA kernels for the A streams, the
normal-matrix assembly, the factor and the preconditioner apply.  General
LPs and MPS files go through host-side standard-form conversion, presolve
and Ruiz scaling.  Imports torch, numpy and scipy only.
"""
from ipx_torch.options import SolverOptions, DEFAULT_OPTIONS
from ipx_torch.status import Status
from ipx_torch.problem.lp import LP, GeneralLP, make_lp, to_standard_form
from ipx_torch.api import (Solution, solve, solve_batch, solve_general,
                           solve_mps, solve_large, solve_many)

__version__ = "0.1.0"

__all__ = [
    "SolverOptions", "DEFAULT_OPTIONS", "Status", "LP", "GeneralLP",
    "make_lp", "to_standard_form", "Solution", "solve", "solve_batch",
    "solve_general", "solve_mps", "solve_large", "solve_many",
]
