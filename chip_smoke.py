#!/usr/bin/env python3
"""Smoke run of ``ipx_torch`` on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``ipx_torch/csrc`` with nvcc, holds each kernel
against its plain PyTorch version and an f64 oracle at the main path's
shapes (m=1024, n=2048), times each beside its bound (matrix products at the
tensor-core rate of an f32-faithful bf16 split, the float32 CUDA-core figure
beside it), then drives the paths
through the public entry points: ``ipx_torch.solve_batch`` on B=256 distinct
bf16-stored instances under ``SolverOptions.throughput()`` as it stands
(``chol_backend="pallas_left"``: fused assemble+factor panels, diagonal
factor, panel pair-solve, one-stream matvecs), the same batch under
``chol_backend="pallas"`` (assembled matrix, right-looking kernel factor,
full-L^T pair-solve), the same options on the library Cholesky
(``chol_backend="xla"``) and on ``"blocked_left"``, ``"blocked"``,
``"hybrid"``, ``"panels"`` and ``cg_operator="assembled"`` at B=64, two
batches whose m = 1000 is off the 128 grid (padded routes),
``throughput()`` as defined at B=64 (A stored float32: row 4's float32
kernel and the accumulation of an assembled matrix), the rescue ladder
(``augmented_fallback=True``) on the main path's 256 instances, the Schur-form
route on every lane at B=64 and the augmented LU route at B=4, one stalled
LP alone through ``ipx_torch.solve``'s ladder, ``refactor_period=2`` at
B=64, the kernel module's own factor-then-solve paths at B=256, an f64
oracle solve on the card, twelve lanes solved alone, the
fixed-iteration rate of three factor routes, and the front ends:
``ipx_torch.solve(c, A, b)`` with its default presolve at the main path's
width, ``solve_general`` on a general LP of 1536 x 2432 in standard form
against HiGHS (also with A rounded to bf16 values and stored bf16),
``solve_mps`` on the committed fixtures, ``solve_many`` on mixed sizes, a
chunked solve resumed from its on-disk snapshots, ``python -m ipx_torch``
in child processes, and the large single LP through ``ipx_torch.solve_large``:
at m=2048 under a one-rank NCCL group (with config 5's batch-sharded
``solve_batch`` driven as a caller drives it), config 5 with each A split
over the "row" axis (``solve_batch(share, mesh=)`` on eight instances at
the main path's width, in this process at p = 1 and on two child processes
that share the card over gloo), the ``"sharded_schur"``
endgame forced at m=4096, an f32 A at m=8192 chunked and not, and config 4
whole (m=32768, n=65536, bf16 A), with row 10 held past the pair-solve's m,
row 4's far-corner tiles against f64 beside the summations the limit
rejects, and, on each of these four paths, rows 4 and 10 held on the first
and the last normal matrix the path built against their plain versions and
float64.
Every phase prints one JSON line, and a line with its seconds; any failure
exits non-zero.  Needs a CUDA
device: without one it exits with code 2 and prints no result.  The
``row_sharded`` phase starts this file twice more as
``chip_smoke.py --row-sharded-rank RANK PORT``, one rank each.
"""
from __future__ import annotations

import contextlib
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from scipy.optimize import linprog

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; "
                     "this script measures on a GPU only\n")
    sys.exit(2)

import ipx_torch
import ipx_torch.api
from ipx_torch import native, numerics, obs
from ipx_torch.devinfo import nvidia_smi_line, time_ms
from ipx_torch.ipm import batched
from ipx_torch.kernels import _build
from ipx_torch.kernels import cholesky as pk
from ipx_torch.kernels import fused as fk
from ipx_torch import mesh as meshlib
from ipx_torch.linsys import augmented, normal_eq, products, schur
from ipx_torch.numerics import dtype_of
from ipx_torch.problem.generate import (lp_from_optimum,
                                        random_feasible_large_device,
                                        random_feasible_batch_device,
                                        random_feasible_lp,
                                        random_general_lp)
from ipx_torch.problem.lp import GeneralLP
from ipx_torch.problem.mps import read_mps

M_ROWS, N_COLS = 1024, 2048         # the main path's width
B_CHECK = 8                         # batch of the kernel-vs-plain comparison
B_MAIN = 256                        # batch of the timed kernels and the solve
TOL_F64 = 1e-6      # kernel vs f64 product, relative to the f64 result's
                    # inf-norm.  The kernels sum in two levels or in f64; one
                    # chain of 2048 f32 terms is 5e-6 off and costs the
                    # solver lanes, so it is not accepted
TOL_PLAIN = 1e-5    # kernel vs plain version (one f32 matmul), same scale:
                    # the plain version's own summation error
# The panel kernels are held to these, each set from what an H100 gave on
# these inputs (B = 8, d2 spread over many decades, reg 1e-8 .. 1e-4; the
# measured value is in brackets) and at most 10x that.
# Panels against the f64 Cholesky factor of the f64 scaled regularised matrix,
# relative to the factor's largest entry: the forward error of an f32 factor,
# condition x eps [5.3e-5 fused on the tensor cores (7.7e-5 on the CUDA
# cores before), 2.4e-5 from the assembled matrix on the tensor cores (6.8e-5
# on the CUDA cores before); the plain versions 2.3e-4
# and 6.4e-5]
TOL_PANELS_F64 = 5e-4
# kernel panels against the plain version's: two f32 factors of one
# ill-conditioned matrix [2.2e-4]
TOL_PANELS_PLAIN = 2e-3
# ||L L^T - Ms|| / ||Ms|| (max norms), the factor's backward error, which does
# not grow with the condition [9.0e-7 fused on the tensor cores, 9.6e-7 on
# the CUDA cores before]
TOL_RECONSTRUCT = 5e-6
# Pair-solve against an f64 solve WITH THE SAME f32 FACTOR, relative to the
# solution's largest entry: y, r and x are rounded to f32 once per entry and
# the factor's condition amplifies that [2.6e-4; the plain version, which
# sums in f32, 2.2e-3], and its backward error
# ||L L^T x - b|| / (||L L^T|| ||x||) [4.5e-7]
TOL_SOLVE_F64 = 2e-3
TOL_SOLVE_PLAIN = 2e-2
TOL_SOLVE_BACKWARD = 3e-6
# the padded route's solve against the f64 matrix it factored [4.5e-6: the
# f32 assembly and factor are in it]
TOL_PADDED_BACKWARD = 3e-5
# Diagonal block: ||W L - I|| (max norm) on a panel's own tile [2.4e-7] and on
# the ill-conditioned block whose entries span 1e8 [3.5e-6]; L against the f64
# factor relative to its largest entry [6.0e-8 and 3.1e-7]
TOL_DIAG_INVERSE = 2e-6
TOL_DIAG_INVERSE_ILL = 3e-5
TOL_DIAG_FACTOR = 2e-6
# The full-matrix factors (same inputs, B = 8) share the panel factors'
# limits above against the f64 factor [cholesky_batched 4.6e-5,
# factor_lt_batched 1.9e-5 (5.8e-5 before the tensor cores); the plain
# versions 6.6e-5, 6.4e-5], on ||L L^T - Ms|| / ||Ms|| [7.3e-7, 3.3e-7] and on
# ||W L - I|| [2.4e-7]; against their plain versions [6.4e-5, 6.2e-5] they
# have a limit of their own
# (TOL_LT_PLAIN).  Their solves share the panel pair-solve's limits: the
# pair-solve from a full L^T against an f64 solve with the same factor [3.2e-4; plain 1.8e-3], backward
# error [3.7e-7]; two one-sweep solves [3.2e-4; plain 2.9e-3], [3.8e-7]; the
# lower sweep alone [9.6e-7; plain 1.3e-5]; m = 4864, one instance, backward
# error against the f32 matrix [2.2e-7, 2.1e-7].
# factor_lt_batched against factor_lt_panels on the same matrix: panel 0's
# diagonal tile and W_0 bit for bit, the rest to rounding (another product
# behind the panel TRSM), relative to the factor's largest entry [2.7e-5]
TOL_LT_VS_PANELS = 4e-4
# cholesky_batched and factor_lt_batched against their plain versions,
# relative to the factor's largest entry [6.4e-5, 6.2e-5]
TOL_LT_PLAIN = 6e-4
# the pair-solve from L^T against two one-sweep solves from L, same factor,
# relative to the solution's largest entry [5.9e-6]
TOL_TWO_SWEEPS = 5e-5
# kernel_api at B = 256: backward error of the two factor-then-solve paths
# against the f32 matrix they factored [8.9e-7, 1.5e-6].  Their solutions
# against an f64 factor and solve of it are printed and held to nothing: the
# forward error is condition x eps on these mid-solve matrices [1.5e-2,
# 1.0e-2 of the largest entry] and says little about the kernels
TOL_API_BACKWARD = 3e-5
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
F32_FLOPS = 67e12                   # H100 SXM, float32 outside tensor cores
F64_FLOPS = 34e12                   # H100 SXM, float64 outside tensor cores
F64_TC_FLOPS = 67e12                # H100 SXM, float64 tensor cores
BF16_TC_FLOPS = 989e12              # H100 SXM, bf16 tensor cores, dense
# An f32-faithful product on bf16 tensor cores takes several passes: an f32
# operand against a bf16 one three (the exact split of the f32 side), two f32
# operands six (bf16x6).  The matrix-product rows are bounded at that rate:
# the least time the card could take for the same work.
ASM_PASSES, CHOL_PASSES = 3, 6
DEV = "cuda"
# Without the rescue ladder (augmented_fallback=False) a float32 lane may
# stop short of OPTIMAL; at least half of the batch has to get there (measured on an
# H100 with these seeds: 214 of 256 on the kernel route, 202 of 256 on
# "pallas", 49 of 64 on the library route, 45 to 54 of 64 on the other
# backends, 11 of 16 at m = 1000), and every OPTIMAL lane is held to the full
# contract.
MIN_OPTIMAL_SHARE = 0.5
# A lane solved alone goes through the same code as in the batch, and the
# kernels give it the same bits at any batch size (phase ``panel_kernels``
# checks the factor at B = 1 and the pair-solve at B = 1 and 3 bit for bit
# against a batch of 8).  PyTorch's own reductions do not (dot products,
# minima), and a lane that stalls amplifies that without bound: of 10 lanes
# that stall in a batch of 64 (probes/norescue_gpu.py --alone 10, H100), the
# best-iterate gap alone over the gap in the batch runs from 0.007 to 3.8 on
# the kernel route and from 0.008 to 608 on the library route, and the
# kernel route's gap alone over the library route's alone from 0.002 to 123
# (geometric mean 0.32); the 10 lanes that end OPTIMAL in the batch all end
# OPTIMAL alone on both routes.  So no single stalled lane can be held to a
# number, and the phase holds
#   every lane alone      to the batch's path while the two are comparable:
#                         the gap of the first EARLY_ITERS iterations within
#                         EARLY_TOL (measured over the twelve lanes: at
#                         most 1.7e-5);
#   OPTIMAL in the batch  to OPTIMAL alone, or within NEAR_MISS_GAP;
#   the stalled lanes     together: the geometric mean over them of (gap
#                         alone on the kernel route) / (gap alone on the
#                         library route), and of (gap alone) / (gap in the
#                         batch) on the kernel route, each at most
#                         ALONE_GEOMEAN_FACTOR, and no fewer OPTIMAL alone on
#                         the kernel route than on the library route less one.
N_ALONE_STALLED = 8
N_ALONE_OPTIMAL = 4
ALONE_GEOMEAN_FACTOR = 10.0
NEAR_MISS_GAP = 1e-5
EARLY_ITERS = 6
EARLY_TOL = 1e-3

N_RAGGED = 2045     # an n whose A rows are not 16-byte aligned
M_SPANS, N_SPANS = 2100, 4500   # rows 2 and 3 with two spans of w, the
                                # second ragged, and two or three tiles
M_ROWS_F32, N_ROWS_F32 = 8192, 16384    # rows 2 and 3 at large_f32's shape
B_XLA = 64          # batch of the library-Cholesky path and of the backends
                    # that share the pair-solve kernels with the wide paths,
                    # of the Schur-form route and of refactor_period=2
B_LU = 4            # batch of the augmented LU route (K is (m+n)^2 a lane)
N_LADDER_TRIES = 4  # stalled lanes tried alone until one drives the ladder
B_PADDED = 16       # batch of the padded path
M_PADDED = 1000     # its m, off the 128 grid

# the large single LP (config 4, BASELINE.json "Large single LP (m=32k,
# n=64k)"), solved whole on one card at p = 1, and the smaller shapes of its
# other paths: an f32 A (row 4's float32 kernel), the Schur-form endgame
# forced, a one-rank NCCL group; row 10 alone past MAX_M
M_LARGE, N_LARGE = 32768, 65536
M_LARGE_F32 = 8192
M_SCHUR = 4096
M_GROUP = 2048
M_ROW10 = 8192
LARGE_OBJ_TOL = 1e-5        # objective against the constructed optimum
# Row 4 against f64 on the large LPs' shapes: config 4's far-corner tiles,
# relative to each tile's largest entry [1.29e-6, 1.12e-6, 1.09e-6 first,
# last, corner on an H100], and the whole M of the path's first and last
# normal matrix, each entry over sqrt(D_i D_j) [1.91e-6, 1.70e-6 at config
# 4; at most 1.09e-6 on the smaller shapes].  n = 65536 is 1024 chunk sums
# an entry where the contract's n is 32, so TOL_F64 is not the limit.  The
# limit rejects what the summation rule rejects, measured on the same rows
# in the same run (``_far_corners``, which fails if it would not): one
# float32 chain an entry [1.63e-5], A o d2 rounded once to bf16 [1.43e-3];
# the plain version, one library f32 product, was 6.28e-5 off on the whole M.
# An offset that overflowed would be off by O(1).
TOL_LARGE_F64 = 5e-6
LARGE_CHUNK = 8             # exec_chunk_iters of the chunked f32 run
_LARGE = ("assemble_sym_batched", "factor_lt_batched", "diag_factor_inv")
# config 5 with each A split over the "row" axis: the main path's width,
# eight instances, in one process at p = 1 and on a (1, 2) mesh of two
# ranks that share the card over gloo; the objectives within
# ``dryrun_multichip``'s 1e-5 of the one-process solve and of the optima
B_ROW = 8
ROW_SEED = 11
ROW_OBJ_TOL = 1e-5
ROW_CHILD_TIMEOUT = 300     # seconds for the two ranks of the mesh run

# kernel name -> (source, TPU kernel it replaces)
KERNELS = {
    "ata_apply": ("ipx_torch/csrc/fused_matvec.cu", "ipx/kernels/fused.py:80"),
    "a_matvec": ("ipx_torch/csrc/row_matvec.cu", "ipx/kernels/fused.py:142"),
    "at_matvec": ("ipx_torch/csrc/row_matvec.cu", "ipx/kernels/fused.py:161"),
    "assemble_sym_batched": ("ipx_torch/csrc/assemble_sym.cu",
                             "ipx/kernels/cholesky.py:1399"),
    "factor_fused_panels": ("ipx_torch/csrc/fused_panel.cu",
                            "ipx/kernels/cholesky.py:1522"),
    # no TPU kernel: the XLA glue between the panel kernels' calls
    "diag_factor_inv": ("ipx_torch/csrc/factor_panels.cu",
                        "ipx/kernels/cholesky.py:192"),
    "chol_solve_batched_panels": ("ipx_torch/csrc/solve_panels.cu",
                                  "ipx/kernels/cholesky.py:1219"),
    "factor_lt_panels": ("ipx_torch/csrc/accum_panel.cu",
                         "ipx/kernels/cholesky.py:1093"),
    "chol_solve_batched_lt": ("ipx_torch/csrc/solve_panels.cu",
                              "ipx/kernels/cholesky.py:640"),
    "cholesky_batched": ("ipx_torch/csrc/cholesky_right.cu",
                         "ipx/kernels/cholesky.py:285"),
    "factor_lt_batched": ("ipx_torch/csrc/accum_panel.cu",
                          "ipx/kernels/cholesky.py:900"),
    "solve_triangular_batched": ("ipx_torch/csrc/solve_panels.cu",
                                 "ipx/kernels/cholesky.py:469"),
}
LT_KERNELS = ("chol_solve_batched_lt", "cholesky_batched",
              "factor_lt_batched", "solve_triangular_batched")
_MATVECS = ("ata_apply", "a_matvec", "at_matvec")
_ASSEMBLED = _MATVECS + ("assemble_sym_batched",)
_RIGHT = _ASSEMBLED + ("diag_factor_inv", "cholesky_batched",
                       "chol_solve_batched_lt")
_LEFT = _MATVECS + ("factor_fused_panels", "diag_factor_inv",
                    "chol_solve_batched_panels")
_F32 = _ASSEMBLED + ("factor_lt_panels", "diag_factor_inv",
                     "chol_solve_batched_panels")
# the Schur rung's reduced factor and its solves on pallas_left: row 5 (with
# the squared stream of row 2 for its Jacobi scale), 5b, the pair-solve and
# ata_apply as the inner CG operator; its other products are rows 2 and 3
_SCHUR = ("ata_apply", "a_matvec", "at_matvec", "factor_fused_panels",
          "diag_factor_inv", "chol_solve_batched_panels")
# the large LP's routes: rows 4 and 10 (with the diagonal kernel), and rows 2
# and 3 for every product with A and the Jacobi diagonal
_LARGE_PATH = _LARGE + ("a_matvec", "at_matvec")
# which kernels each driven path must launch
PATH_KERNELS = {
    "pallas_left": _LEFT,
    # throughput() with the rescue ladder: stage 1 is pallas_left
    "rescue": _LEFT,
    "pallas": _RIGHT,
    "xla": _ASSEMBLED,
    "padded": _ASSEMBLED + ("factor_lt_panels", "diag_factor_inv",
                            "chol_solve_batched_panels"),
    "throughput_f32": _F32,
    "blocked_left": _ASSEMBLED + ("diag_factor_inv", "chol_solve_batched_lt"),
    "blocked": _ASSEMBLED + ("diag_factor_inv", "chol_solve_batched_lt"),
    "hybrid": _ASSEMBLED + ("chol_solve_batched_lt",),
    "panels": _ASSEMBLED + ("diag_factor_inv", "chol_solve_batched_panels"),
    "assembled": _RIGHT,
    "padded_lt": _RIGHT,
    "augmented_schur": _SCHUR,
    # the LU route: an LU of K, its products rows 2 and 3
    "augmented": ("a_matvec", "at_matvec"),
    # one LP alone: stage 1 on pallas_left, then the ladder's rungs
    "ladder": _LEFT,
    "refactor2": _F32,
    "kernel_api": LT_KERNELS + ("diag_factor_inv",),
    # the front ends: the default options run the library route, whose
    # assembly of an f32 A on the card is row 4's float32 kernel;
    # throughput() with an f32 A the assembled panel route (row 7), on or
    # off the 128 grid; a bf16 A on the grid the fused panel route
    "presolve": ("assemble_sym_batched",),
    "presolve_throughput": _F32,
    "general": ("assemble_sym_batched",),
    "general_throughput": _F32,
    "general_bf16": _LEFT,
    "mps": ("assemble_sym_batched",),
    "many": _F32,
    "resume": ("assemble_sym_batched",),
    # the large single LP at p = 1: the assembly kernel on the whole A, the
    # full-matrix factor (row 10 with the diagonal kernel), the solves
    # W-substitutions with library products (past the pair-solve's m), the
    # products with A and the Jacobi diagonal rows 2 and 3
    "large": _LARGE_PATH,
    "large_f32": _LARGE_PATH,
    "sharded_schur": _LARGE_PATH,
    "large_group": _LARGE_PATH,
    # config 5 on the sharded route: at p = 1 the whole factor of each
    # lane, on the (1, 2) mesh (rank 0's counts) the diagonal blocks
    "row_sharded": _LARGE_PATH,
    "row_sharded_mesh": _LARGE_PATH,
}
# the library calls a path may make: the factor and triangular solve of the
# library route, which the kernel paths must not make, and the LU route's
FACTOR_CALLS = ("cholesky_ex", "solve_triangular")
LU_CALLS = ("lu_factor_ex", "lu_solve")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(phase: str, why: str) -> None:
    emit(phase, ok=False, error=why)
    sys.exit(1)


def reset_counts() -> None:
    for d in (fk.LAUNCHES, pk.LAUNCHES):
        for k in d:
            d[k] = 0


def counts() -> dict:
    return {**fk.LAUNCHES, **pk.LAUNCHES}


def slice_options(**kw):
    """The main path's options: ``throughput()`` with its own
    ``chol_backend="pallas_left"``."""
    return ipx_torch.SolverOptions.throughput(
        a_storage="bfloat16", augmented_fallback=False, max_iter=64, **kw)


def f32_options(**kw):
    """``throughput()`` with its own ``a_storage="float32"``: an f32 A is
    assembled (row 4's float32 kernel) and factored from the assembled
    matrix (row 7), not by the fused panel stage."""
    return ipx_torch.SolverOptions.throughput(augmented_fallback=False,
                                              max_iter=64, **kw)


class LibraryFactorCalls:
    """Counts calls of the library Cholesky, triangular solve and LU while
    it is active: the kernel paths must make none of the first two."""

    def __enter__(self):
        self.calls = {name: 0 for name in FACTOR_CALLS + LU_CALLS}
        self._orig = {name: getattr(torch.linalg, name) for name in self.calls}

        def counted(name, fn):
            def call(*a, **kw):
                self.calls[name] += 1
                return fn(*a, **kw)
            return call

        for name, fn in self._orig.items():
            setattr(torch.linalg, name, counted(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(torch.linalg, name, fn)


class RungRecorder:
    """While active, wraps ``ipx_torch.api._run_batch``, through which every
    run of the entry points goes (stage 1 and each rung of the rescue
    ladder), and records per call: the route, whether it was warm-started,
    lanes in, lanes OPTIMAL out, most iterations, seconds (synchronised) and
    the kernel launches made in it.  The first warm-started
    ``augmented_schur`` call's A and starting iterate are kept
    (``schur_start``) for the reduced factor's check."""

    def __enter__(self):
        self.calls, self.schur_start = [], None
        self._orig = ipx_torch.api._run_batch

        def run(lp, opts, state0=None):
            torch.cuda.synchronize()
            before, t0 = counts(), time.perf_counter()
            st = self._orig(lp, opts, state0)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            after = counts()
            warm = state0 is not None
            if opts.linsys == "augmented_schur" and warm \
                    and self.schur_start is None:
                k = min(B_CHECK, lp.A.shape[0])
                self.schur_start = (lp.A[:k], state0.x[:k], state0.s[:k],
                                    opts)
            self.calls.append(dict(
                linsys=opts.linsys, warm=warm, lanes=int(lp.A.shape[0]),
                optimal=int((st.status == int(ipx_torch.Status.OPTIMAL)).sum()),
                max_iterations=int(st.it.max()), seconds=round(secs, 3),
                launches={k: after[k] - before[k] for k in after
                          if after[k] != before[k]}))
            return st

        ipx_torch.api._run_batch = run
        return self

    def __exit__(self, *exc):
        ipx_torch.api._run_batch = self._orig

    def rungs(self, in_batch: bool) -> list:
        """The calls named as rungs: stage 1, then (``solve_batch`` only)
        the in-batch Schur rung, then the ladder's LU warm, LU cold and
        Schur rungs."""
        out = []
        for i, c in enumerate(self.calls):
            if i == 0:
                name = "stage1"
            elif c["linsys"] == "augmented":
                name = "lu_warm" if c["warm"] else "lu_cold"
            elif in_batch and i == 1:
                name = "in_batch_schur"
            else:
                name = "schur"
            out.append({"rung": name, **c})
        return out


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_env() -> str:
    card = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=card,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return card


def phase_build() -> None:
    secs = _build.build_all()
    emit("build", ok=True, seconds=round(secs, 2), sources=list(_build.SOURCES),
         flags=list(_build.NVCC_FLAGS))


def _inputs(B: int, a_dtype: torch.dtype, seed: int, m: int = M_ROWS,
            n: int = N_COLS):
    g = torch.Generator(device=DEV).manual_seed(seed)
    kw = dict(generator=g, device=DEV, dtype=torch.float32)
    A = (torch.randn(B, m, n, **kw) / n ** 0.5).to(a_dtype)
    v = torch.randn(B, m, **kw)
    w = torch.randn(B, n, **kw)
    beta = torch.randn(B, n, **kw)
    # a D^2 = x/s profile with the spread of a mid-solve iterate
    alpha = torch.exp(3.0 * torch.randn(B, n, **kw))
    return A, v, w, beta, alpha


def _f64_refs(A, v, w, beta, alpha) -> dict:
    A64 = A.double()
    t = torch.matmul(v.double().unsqueeze(1), A64).squeeze(1)
    u = alpha.double() * (t + beta.double()) + w.double()
    av = lambda x: torch.matmul(A64, x.unsqueeze(-1)).squeeze(-1)
    return {
        "ata_apply": (av(u), t),
        "ata_apply/pair": (av(w.double()), t),
        "ata_apply/operator": (av(alpha.double() * t), t),
        "ata_apply/no_beta": (av(alpha.double() * t + w.double()), t),
        "a_matvec": (av(w.double()),),
        "a_matvec/squared": (torch.matmul(
            A64 * A64, alpha.double().unsqueeze(-1)).squeeze(-1),),
        "a_matvec/f64": (av(w.double()),),
        "at_matvec": (t,),
        "at_matvec/f64": (t,),
        "assemble_sym_batched": (
            torch.matmul(A64 * alpha.double().unsqueeze(1), A64.mT),),
    }


def _calls(A, v, w, beta, alpha):
    """name -> (kernel call, plain call), each returning a tuple.  A name
    with a slash is another calling mode of the kernel before the slash, as
    the main path uses it: the independent pair (A w, A^T v) of the residuals
    and the Gondzio step, the normal operator A (d2 (A^T v)) of the CG, and a
    refinement right-hand side without beta, the squared stream that gives
    the Jacobi diagonal (A o A) d2, and rows 2 and 3 with the float64 sums
    unrounded (``out_dtype``, the float64 products of the sharded routes;
    the plain version a float64 product).  Modes are compared, not
    timed."""
    f64 = torch.float64
    tup = lambda x: x if isinstance(x, tuple) else (x,)
    return {
        "ata_apply": (lambda: fk.ata_apply(A, v, alpha, w, beta=beta),
                      lambda: fk.ata_apply_plain(A, v, alpha, w, beta=beta)),
        "ata_apply/pair": (lambda: fk.ata_apply(A, v, None, w),
                           lambda: fk.ata_apply_plain(A, v, None, w)),
        "ata_apply/operator": (lambda: fk.ata_apply(A, v, alpha, None),
                               lambda: fk.ata_apply_plain(A, v, alpha, None)),
        "ata_apply/no_beta": (lambda: fk.ata_apply(A, v, alpha, w),
                              lambda: fk.ata_apply_plain(A, v, alpha, w)),
        "a_matvec": (lambda: tup(fk.a_matvec(A, w)),
                     lambda: tup(fk.a_matvec_plain(A, w))),
        "a_matvec/squared": (
            lambda: tup(fk.a_matvec(A, alpha, square=True)),
            lambda: tup(fk.a_matvec_plain(A, alpha, square=True))),
        "a_matvec/f64": (
            lambda: tup(fk.a_matvec(A, w, out_dtype=f64)),
            lambda: tup(fk.a_matvec_plain(A, w, out_dtype=f64))),
        "at_matvec": (lambda: tup(fk.at_matvec(A, v)),
                      lambda: tup(fk.at_matvec_plain(A, v))),
        "at_matvec/f64": (
            lambda: tup(fk.at_matvec(A, v, out_dtype=f64)),
            lambda: tup(fk.at_matvec_plain(A, v, out_dtype=f64))),
        "assemble_sym_batched": (
            lambda: tup(pk.assemble_sym_batched(A, alpha)),
            lambda: tup(pk.assemble_sym_batched_plain(A, alpha))),
    }


def _bound(nbytes: float, flops: float, asm_flops: float = 0.0,
           chol_flops: float = 0.0, f64_flops: float = 0.0) -> dict:
    """The least time for the work: the larger of bytes over the memory rate
    and operations over the card's rate for their type.  ``flops`` are
    float32 operations at the CUDA-core rate; ``asm_flops`` and
    ``chol_flops`` are matrix products at the bf16 tensor-core rate,
    ASM_PASSES and CHOL_PASSES times over; ``f64_flops`` float64 operations
    at the card's float64 peak, its tensor cores' rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = (flops / F32_FLOPS + f64_flops / F64_TC_FLOPS
          + (ASM_PASSES * asm_flops + CHOL_PASSES * chol_flops)
          / BF16_TC_FLOPS) * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def _f32_cuda_core_ms(nbytes: float, flops: float, asm_flops: float = 0.0,
                      chol_flops: float = 0.0, f64_flops: float = 0.0) -> float:
    """The same work as ``_bound`` with every product on the CUDA cores (in
    float32, the float64 work in float64): the yardstick of the kernels
    before the tensor cores, printed apart from the ``kernels`` line (phase
    ``bounds``)."""
    return max(nbytes / HBM_BYTES_PER_S,
               (flops + asm_flops + chol_flops) / F32_FLOPS
               + f64_flops / F64_FLOPS) * 1e3


def _matvec_work(B: int, itemsize: int) -> dict:
    """name -> (bytes, f32 flops at the CUDA-core rate, tensor-core flops of
    the assembly) of the phase-``kernels`` rows: each input read once, each
    output written once."""
    m, n = M_ROWS, N_COLS
    a_bytes = B * m * n * itemsize
    vec = lambda k: 4 * B * k
    return {
        "ata_apply": (a_bytes + vec(m) + 3 * vec(n) + vec(m) + vec(n),
                      4 * B * m * n, 0),
        "a_matvec": (a_bytes + vec(n) + vec(m), 2 * B * m * n, 0),
        "at_matvec": (a_bytes + vec(m) + vec(n), 2 * B * m * n, 0),
        # the lower triangle with its diagonal: m (m + 1) / 2 entries of M,
        # one product (2 flops) per entry and column of A.  (The kernel's 128
        # tiles compute whole diagonal tiles, m (m + 128) / 2 entries; that
        # surplus is the kernel's, not the function's.)
        "assemble_sym_batched": _assembly_work(B, m, n, itemsize),
    }


def _bounds(B: int, itemsize: int) -> dict:
    """name -> bound fields (``_bound``) of the phase-``kernels`` rows."""
    return {name: _bound(*w) for name, w in _matvec_work(B, itemsize).items()}


def _oversize_rows() -> str | None:
    """An A on the card with more rows than one block's shared memory holds
    as a column stripe stays on the fused route: ``ata_apply`` (row 1,
    whose stripe caps m) refuses it before any launch, and rows 2 and 3
    (row streams, nothing of A in shared memory) take it and agree with a
    float64 product.  Nothing hands it to library matmuls.  Returns what
    went wrong, or None."""
    m, n = 1 << 15, 64
    A, v, w, _, _ = _inputs(1, torch.bfloat16, seed=10, m=m, n=n)
    if not products.use_fused_matvec(slice_options(), A):
        return f"m={m} leaves the fused route"
    before = dict(fk.LAUNCHES)
    try:
        fk.ata_apply(A, v, w, None)
    except ValueError:
        pass
    else:
        return f"ata_apply took m={m} on the card instead of refusing it"
    if dict(fk.LAUNCHES) != before:
        return "a refused call counted"
    A64 = A.double()
    for name, got, ref in (
            ("a_matvec", fk.a_matvec(A, w),
             (A64 @ w.double().unsqueeze(-1)).squeeze(-1)),
            ("at_matvec", fk.at_matvec(A, v),
             (v.double().unsqueeze(1) @ A64).squeeze(1))):
        err = _mx(got.double() - ref) / _mx(ref)
        if not err <= TOL_F64:
            return f"{name} at m={m}: {err:.3e} off float64 (limit {TOL_F64})"
    return None


def _t_was_used(label: str, case: str, A, v, w, beta, alpha, got) -> None:
    """``ata_apply``'s y is A applied to the u formed from the t it returned:
    u = alpha (t + beta) + w in float32, each operation rounded as the
    kernel rounds it (t + beta first, no contraction), and ``ata_apply``
    with v = 0, alpha = None and w = u forms the same u and streams the
    same second phase, so it gives y's bits."""
    al, ww, be = {"ata_apply": (alpha, w, beta),
                  "ata_apply/pair": (None, w, None),
                  "ata_apply/operator": (alpha, None, None),
                  "ata_apply/no_beta": (alpha, w, None)}[case]
    y, t = got
    zero = torch.zeros_like(t)
    u = ((zero if al is None else al) * (t + (zero if be is None else be))
         + (zero if ww is None else ww))
    if not torch.equal(y, fk.ata_apply(A, torch.zeros_like(v), None, u)[0]):
        fail("kernels", f"{label}: y is not A applied to the returned t")


def _misaligned(A: torch.Tensor) -> torch.Tensor:
    """A copy of A whose data starts one element past a 16-byte boundary:
    rows 2 and 3 read it element by element."""
    buf = torch.empty(A.numel() + 1, dtype=A.dtype, device=A.device)
    out = buf[1:].view(A.shape)
    out.copy_(A)
    return out


def _row_bits(label: str, case: str, A, v, w, alpha, got) -> None:
    """Rows 2 and 3 give the same bits from a second launch, for a lane at
    B = 1 and 3 as in the batch, and from a copy of A read element by
    element (data off a 16-byte boundary): the tiling depends on (m, n,
    the stored type) alone and no sum is taken in a racing order."""
    f64 = torch.float64
    call, x = {
        "a_matvec": (lambda A_, x_: fk.a_matvec(A_, x_), w),
        "a_matvec/squared": (
            lambda A_, x_: fk.a_matvec(A_, x_, square=True), alpha),
        "a_matvec/f64": (
            lambda A_, x_: fk.a_matvec(A_, x_, out_dtype=f64), w),
        "at_matvec": (lambda A_, x_: fk.at_matvec(A_, x_), v),
        "at_matvec/f64": (
            lambda A_, x_: fk.at_matvec(A_, x_, out_dtype=f64), v),
    }[case]
    if not torch.equal(got[0], call(A, x)):
        fail("kernels", f"{label}: two launches differ")
    if not torch.equal(got[0], call(_misaligned(A), x)):
        fail("kernels", f"{label}: the element-by-element path differs")
    _lanes_bitwise("kernels", label, call, (A, x), got)


def _check_odd_shapes(rows: dict) -> None:
    """The matvecs and the assembly off the main path's shape, held against
    the plain version and f64 like the other modes, bf16 and f32: at n =
    N_RAGGED (all four) rows that are not 16-byte aligned are staged (row
    1, the assembly) or read (rows 2 and 3) element by element and the last
    stripe, chunk or warp step is ragged; at m = M_PADDED (all four) the
    stripe's copy chunks are ceil(m / 8) rows, the last one short, the rows'
    swizzle runs over a count that is not a multiple of 8, rows 2 and 3's
    last row block and tile are short, and the assembly's last tile row is
    zero-filled and its stores masked; at M_SPANS x N_SPANS (rows 2 and 3)
    w takes two spans, the second ragged, and t two (bf16) or three (f32)
    tiles.  ``ata_apply``'s y is A applied to the t it returned; rows 2 and
    3 give the same bits twice, across B and element by element; M is
    exactly symmetric, the same bits from a second launch and, for a lane,
    at B = 1 and 3 as in the batch."""
    cuts = ((f"n{N_RAGGED}", M_ROWS, N_RAGGED, _ASSEMBLED),
            (f"m{M_PADDED}", M_PADDED, N_COLS, _ASSEMBLED),
            (f"m{M_SPANS}n{N_SPANS}", M_SPANS, N_SPANS,
             ("a_matvec", "at_matvec")))
    for a_dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for cut, m, n, names in cuts:
            if n > N_COLS:
                A, v, w, beta, alpha = _inputs(B_CHECK, a_dtype, 8, m, n)
            else:
                A, v, w, beta, alpha = _inputs(B_CHECK, a_dtype, seed=8)
                A, v = A[:, :m, :n].contiguous(), v[:, :m].contiguous()
                w, beta, alpha = (x[:, :n].contiguous()
                                  for x in (w, beta, alpha))
            refs = _f64_refs(A, v, w, beta, alpha)
            calls = _calls(A, v, w, beta, alpha)
            for name in names:
                kern, plain = calls[name]
                got, ref_plain = kern(), plain()
                torch.cuda.synchronize()
                label = f"{name}/{cut}/{tag}"
                if any(g.shape != r.shape or not bool(torch.isfinite(g).all())
                       for g, r in zip(got, refs[name])):
                    fail("kernels", f"{label}: bad shape or non-finite")
                worst_plain = max(_mx(g - p) / _mx(r) for g, p, r
                                  in zip(got, ref_plain, refs[name]))
                worst_f64 = max(_mx(g.double() - r) / _mx(r)
                                for g, r in zip(got, refs[name]))
                rows[name]["checks"][label] = {"rel_err_vs_plain": worst_plain,
                                               "rel_err_vs_f64": worst_f64}
                if worst_plain > TOL_PLAIN or worst_f64 > TOL_F64:
                    fail("kernels", f"{label}: rel err vs plain "
                         f"{worst_plain:.3e}, vs f64 {worst_f64:.3e} "
                         f"(tolerances {TOL_PLAIN}, {TOL_F64})")
                if name == "ata_apply":
                    _t_was_used(label, name, A, v, w, beta, alpha, got)
                if name in ("a_matvec", "at_matvec"):
                    _row_bits(label, name, A, v, w, alpha, got)
                if name == "assemble_sym_batched":
                    _check_assembly(label, got[0], A, alpha)
            del A, refs, calls


def _check_assembly(label, M, A, d2) -> None:
    """M of ``assemble_sym_batched`` (at B_CHECK) exactly symmetric, the same
    bits from a second launch, and a lane's bits at B = 1 and 3 those of the
    batch."""
    if not torch.equal(M, M.mT):
        fail("kernels", f"{label}: M is not exactly symmetric")
    if not torch.equal(M, pk.assemble_sym_batched(A, d2)):
        fail("kernels", f"{label}: two launches differ")
    _lanes_bitwise("kernels", label, pk.assemble_sym_batched, (A, d2), (M,))


def _rows_b1(A: torch.Tensor, rows: dict, tag: str, phase: str,
             block: int = 2048) -> dict:
    """Rows 2 and 3 at B = 1 on a large LP's A (1, m, n): y = A w, (A o A)
    d2 and t = A^T v, rounded and in float64, held against float64 and the
    plain version, both taken a block of rows at a time, and the same bits
    from a second launch; then timed beside their bound, the plain version
    (by blocks), one library product on a float32 copy of A made outside
    the timed region, and the route the sharded and augmented products took
    before this kernel (``numerics.mv`` / ``mv64``: a copy of A a block of
    rows at a time, then a library product).  Into ``rows[name][tag]``."""
    _, m, n = A.shape
    g = torch.Generator(device=DEV).manual_seed(12)
    w = torch.randn(1, n, generator=g, device=DEV)
    v = torch.randn(1, m, generator=g, device=DEV)
    d2 = torch.exp(3.0 * torch.randn(1, n, generator=g, device=DEV))
    f32, f64 = torch.float32, torch.float64
    blocks = [slice(r, min(m, r + block)) for r in range(0, m, block)]

    def plain_a(x, square=False, out=f32):
        return torch.cat([fk.a_matvec_plain(A[:, b], x, square, out)
                          for b in blocks], dim=1)

    def plain_at(x, out=f32):
        t = torch.zeros(1, n, dtype=out, device=DEV)
        for b in blocks:
            t += fk.at_matvec_plain(A[:, b], x[:, b].contiguous(), out)
        return t

    ref_y, ref_sq, ref_t = plain_a(w, out=f64), plain_a(d2, True, f64), \
        plain_at(v, f64)
    cases = {
        "a_matvec": (lambda: fk.a_matvec(A, w), lambda: plain_a(w), ref_y),
        "a_matvec/squared": (lambda: fk.a_matvec(A, d2, square=True),
                             lambda: plain_a(d2, True), ref_sq),
        "a_matvec/f64": (lambda: fk.a_matvec(A, w, out_dtype=f64),
                         lambda: ref_y, ref_y),
        "at_matvec": (lambda: fk.at_matvec(A, v), lambda: plain_at(v), ref_t),
        "at_matvec/f64": (lambda: fk.at_matvec(A, v, out_dtype=f64),
                          lambda: ref_t, ref_t),
    }
    checks = {}
    for case, (kern, plain, ref) in cases.items():
        label = f"{case}/{tag}"
        got, ref_plain = kern(), plain()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            fail(phase, f"{label}: bad shape or non-finite")
        if not torch.equal(got, kern()):
            fail(phase, f"{label}: two launches differ")
        checks[case] = {
            "rel_err_vs_plain": _mx(got.double() - ref_plain.double())
            / _mx(ref),
            "rel_err_vs_f64": _mx(got.double() - ref) / _mx(ref)}
        if not (checks[case]["rel_err_vs_plain"] <= TOL_PLAIN
                and checks[case]["rel_err_vs_f64"] <= TOL_F64):
            fail(phase, f"{label}: {checks[case]} (tolerances {TOL_PLAIN}, "
                 f"{TOL_F64})")
    del ref_y, ref_sq, ref_t
    Af = A.float()
    work = _bound(A.numel() * A.element_size() + 4 * (m + n), 2 * m * n)
    out = {}
    for name, kern, kern64, plain, lib, before, before64 in (
            ("a_matvec", lambda: fk.a_matvec(A, w),
             lambda: fk.a_matvec(A, w, out_dtype=f64), lambda: plain_a(w),
             lambda: torch.mv(Af[0], w[0]), lambda: numerics.mv(A, w),
             lambda: numerics.mv64(A, w)),
            ("at_matvec", lambda: fk.at_matvec(A, v),
             lambda: fk.at_matvec(A, v, out_dtype=f64), lambda: plain_at(v),
             lambda: v[0] @ Af[0], lambda: numerics.mv(A.mT, v),
             lambda: numerics.mv64(A.mT, v))):
        slow = dict(reps=3, warm=1)
        row = {"m": m, "n": n, "batch": 1, "a_dtype": str(A.dtype),
               "ms": time_ms(kern), "f64_out_ms": time_ms(kern64),
               "plain_ms": time_ms(plain, **slow),
               "library_ms": time_ms(lib, **slow),
               "route_before_ms": time_ms(before, **slow),
               "route_before_f64_ms": time_ms(before64, **slow), **work,
               "max_rel_err_vs_f64": max(c["rel_err_vs_f64"] for k, c in
                                         checks.items()
                                         if k.startswith(name))}
        rows[name][tag] = row
        out[name] = row
    del Af
    torch.cuda.empty_cache()
    emit(f"{phase}/rows_2_3", tag=tag, checks=checks, **out)
    return out


def phase_kernels() -> dict:
    """Kernel against plain version and f64 product at B_CHECK for both
    storage types of A and every calling mode of the main path, then times at
    B_MAIN with bf16 A (the main path)."""
    rows = {name: {"name": name, "route": "cuda", "source": src,
                   "replaces": rep, "max_abs_err": 0.0, "checks": {}}
            for name, (src, rep) in KERNELS.items()}
    matvec_rows = ("ata_apply", "a_matvec", "at_matvec",
                   "assemble_sym_batched")
    for a_dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        args = _inputs(B_CHECK, a_dtype, seed=1)
        refs = _f64_refs(*args)
        for case, (kern, plain) in _calls(*args).items():
            name, label = case.split("/")[0], f"{case}/{tag}"
            got, ref_plain = kern(), plain()
            torch.cuda.synchronize()
            worst_plain = worst_f64 = abs_plain = 0.0
            for g_, p_, r_ in zip(got, ref_plain, refs[case]):
                if g_.shape != r_.shape or not bool(torch.isfinite(g_).all()):
                    fail("kernels", f"{label}: bad shape or non-finite")
                scale = float(r_.abs().max())
                abs_plain = max(abs_plain, float((g_ - p_).abs().max()))
                worst_plain = max(worst_plain,
                                  float((g_ - p_).abs().max()) / scale)
                worst_f64 = max(worst_f64,
                                float((g_.double() - r_).abs().max()) / scale)
            if name == "assemble_sym_batched":
                _check_assembly(label, got[0], args[0], args[4])
            if name == "ata_apply":
                # the t written out must be the t that was used
                _t_was_used(label, case, *args, got)
                # no atomics: a second launch on the same inputs gives the
                # same bits
                if not all(torch.equal(a, b) for a, b in zip(got, kern())):
                    fail("kernels", f"{label}: two launches differ")
            if name in ("a_matvec", "at_matvec"):
                A_, v_, w_, _, alpha_ = args
                _row_bits(label, case, A_, v_, w_, alpha_, got)
            rows[name]["checks"][label] = {
                "rel_err_vs_plain": worst_plain, "rel_err_vs_f64": worst_f64}
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            abs_plain)
            if worst_plain > TOL_PLAIN or worst_f64 > TOL_F64:
                fail("kernels", f"{label}: rel err vs plain "
                     f"{worst_plain:.3e}, vs f64 {worst_f64:.3e} "
                     f"(tolerances {TOL_PLAIN}, {TOL_F64})")
        del args, refs
    _check_odd_shapes(rows)
    wrong = _oversize_rows()
    if wrong:
        fail("kernels", wrong)
    torch.cuda.empty_cache()
    A32 = _inputs(1, torch.float32, 11, M_ROWS_F32, N_ROWS_F32)[0]
    _rows_b1(A32, rows, "b1_f32", "kernels")
    del A32
    torch.cuda.empty_cache()

    # ---- times at the main path's batch, bf16-stored A --------------------
    A, v, w, beta, alpha = _inputs(B_MAIN, torch.bfloat16, seed=2)
    bounds = _bounds(B_MAIN, 2)
    for name, (kern, plain) in _calls(A, v, w, beta, alpha).items():
        if "/" in name:
            continue
        rows[name]["ms"] = time_ms(kern)
        rows[name]["plain_ms"] = time_ms(plain, reps=3, warm=1)
        rows[name].update(bounds[name])
    # library yardsticks: ONE PyTorch call of the same product.  torch.bmm
    # takes no mixed types, so it gets a float32 copy of A made outside the
    # timed region (it reads twice the bytes).  ata_apply is two dependent
    # products: no single call computes it.
    Af = A.float()
    Wf = Af * alpha.unsqueeze(1)
    w3, v3 = w.unsqueeze(-1), v.unsqueeze(1)
    rows["ata_apply"]["library_ms"] = None
    rows["a_matvec"]["library_ms"] = time_ms(lambda: torch.bmm(Af, w3))
    rows["at_matvec"]["library_ms"] = time_ms(lambda: torch.bmm(v3, Af))
    rows["assemble_sym_batched"]["library_ms"] = time_ms(
        lambda: torch.bmm(Wf, Af.mT), reps=3, warm=1)
    # an f32 A (throughput() as defined, the padded and assembled routes,
    # every front end) on the same values: rows 1-3 read 4 bytes an entry;
    # row 4 takes two f32 operands, so its bound counts the products at the
    # six-pass rate
    bounds32 = _bounds(B_MAIN, 4)
    f32_calls = _calls(Af, v, w, beta, alpha)
    for name in matvec_rows:
        kern, plain = f32_calls[name]
        slow = name == "assemble_sym_batched"
        rows[name]["f32_a"] = {
            "ms": time_ms(kern, **(dict(reps=3, warm=1) if slow else {})),
            "plain_ms": time_ms(plain, reps=3, warm=1),
            "library_ms": rows[name]["library_ms"], **bounds32[name]}
    nbytes, _, asm = _matvec_work(B_MAIN, 4)["assemble_sym_batched"]
    rows["assemble_sym_batched"]["f32_a"].update(
        **_bound(nbytes, 0, chol_flops=asm),
        f32_cuda_core_ms=_f32_cuda_core_ms(nbytes, asm))
    del A, Af, Wf, f32_calls
    torch.cuda.empty_cache()
    emit("kernels", ok=True, batch_check=B_CHECK, batch_timed=B_MAIN,
         m=M_ROWS, n=N_COLS, tol_vs_plain=TOL_PLAIN, tol_vs_f64=TOL_F64,
         kernels=[rows[k] for k in matvec_rows])
    return rows


# --------------------------------------------------------------------------
# the panel-major factor and pair-solve
# --------------------------------------------------------------------------

NB = pk.NB


def _panel_inputs(B: int, seed: int, m: int = M_ROWS):
    """bf16 A, d2 with a mid-solve spread, the Jacobi scale from the squared
    stream, a DISTINCT reg per instance (1e-8 .. 1e-4: reg_boost differs
    across a batch), and the f64 scaled regularised matrix."""
    A, _, _, _, d2 = _inputs(B, torch.bfloat16, seed)
    A = A[:, :m].contiguous()
    reg = torch.logspace(-8, -4, B, device=DEV, dtype=torch.float32)
    j = torch.rsqrt(fk.a_matvec(A, d2, square=True))
    return A, d2, j, reg


def _scaled_f64(A, d2, j, reg):
    A64, j64 = A.double(), j.double()
    M = torch.matmul(A64 * d2.double().unsqueeze(1), A64.mT)
    Ms = M * j64.unsqueeze(2) * j64.unsqueeze(1)
    Ms.diagonal(dim1=1, dim2=2).add_(reg.double().unsqueeze(-1))
    return Ms


def _lt_of(panels) -> torch.Tensor:
    """The (B, m, m) f64 upper-triangular L^T the panels are rows of."""
    B, _, m = panels[0].shape
    LT = torch.zeros(B, m, m, dtype=torch.float64, device=panels[0].device)
    for k, p in enumerate(panels):
        LT[:, k * NB:(k + 1) * NB, k * NB:] = p.double()
    return LT


def _mx(t: torch.Tensor) -> float:
    return float(t.abs().max())


def _check_lt(phase, label, LTg, Wg, LTp, Ms64, checks,
              tol_plain=TOL_PANELS_PLAIN, plain_own_error=False) -> float:
    """A kernel factor as (LT (B, m, m) = L^T, W) against the plain version's
    LT (within tol_plain, widened by the plain version's own distance from
    the f64 factor where ``plain_own_error``) and the f64 Cholesky of Ms64;
    returns the largest |kernel - plain|."""
    L64 = torch.linalg.cholesky(Ms64)
    scale = _mx(L64)
    if not bool(torch.isfinite(LTg).all()) or not bool(torch.isfinite(Wg).all()):
        fail(phase, f"{label}: non-finite factor")
    LTg, LTp = LTg.double(), LTp.double()
    vs_f64 = _mx(LTg - L64.mT) / scale
    plain_vs_f64 = _mx(LTp - L64.mT) / scale
    abs_plain = _mx(LTg - LTp)
    rec = _mx(torch.matmul(LTg.mT, LTg) - Ms64) / _mx(Ms64)
    eye = torch.eye(NB, dtype=torch.float64, device=DEV)
    winv = max(_mx(torch.matmul(Wg[:, k].double(),
                                LTg[:, k * NB:(k + 1) * NB,
                                    k * NB:(k + 1) * NB].mT) - eye)
               for k in range(Wg.shape[1]))
    if plain_own_error:
        tol_plain += plain_vs_f64
    checks[label] = {"rel_err_vs_f64": vs_f64, "plain_vs_f64": plain_vs_f64,
                     "rel_err_vs_plain": abs_plain / scale,
                     "reconstruction": rec, "w_l_minus_i": winv}
    if vs_f64 > TOL_PANELS_F64 or abs_plain / scale > tol_plain \
            or rec > TOL_RECONSTRUCT or winv > TOL_DIAG_INVERSE:
        fail(phase, f"{label}: {checks[label]} (tolerances "
             f"{TOL_PANELS_F64}, {tol_plain}, {TOL_RECONSTRUCT}, "
             f"{TOL_DIAG_INVERSE})")
    return abs_plain


def _check_factor(label, got, plain, Ms64, checks) -> float:
    """Panels and W of a kernel factor against the plain version's and the
    f64 Cholesky of Ms64; returns the largest |kernel - plain|."""
    return _check_lt("panel_kernels", label, _lt_of(got[0]), got[1],
                     _lt_of(plain[0]), Ms64, checks)


def _ill_conditioned_block() -> torch.Tensor:
    """SPD 128 x 128 block with diagonal entries spanning 1e8, the f32
    endgame regime."""
    rng = np.random.default_rng(0)
    d = 10.0 ** rng.uniform(-4, 4, NB)
    R = rng.standard_normal((NB, NB)) * 0.1 + np.eye(NB)
    M = (R @ R.T) * np.outer(np.sqrt(d), np.sqrt(d))
    M = 0.5 * (M + M.T) + 1e-6 * np.diag(d)
    return torch.tensor(M[None], dtype=torch.float32, device=DEV)


def _check_diag(label, CD, tol_inv, checks) -> float:
    LT, W = pk.diag_factor_inv(CD)
    LTp, _ = pk.diag_factor_inv_plain(CD)
    torch.cuda.synchronize()
    L64 = torch.linalg.cholesky(torch.tril(CD.double())
                                + torch.tril(CD.double(), -1).mT)
    eye = torch.eye(NB, dtype=torch.float64, device=DEV)
    res = {"w_l_minus_i": _mx(torch.matmul(W.double(), LT.double().mT) - eye),
           "rel_err_vs_f64": _mx(LT.double() - L64.mT) / _mx(L64),
           "plain_vs_f64": _mx(LTp.double() - L64.mT) / _mx(L64),
           "rel_err_vs_plain": _mx(LT - LTp) / _mx(L64)}
    checks[label] = res
    if _mx(torch.tril(LT, -1)) != 0.0 or _mx(torch.triu(W, 1)) != 0.0:
        fail("panel_kernels", f"{label}: L^T not upper or W not lower")
    if res["w_l_minus_i"] > tol_inv or res["rel_err_vs_f64"] > TOL_DIAG_FACTOR:
        fail("panel_kernels", f"{label}: {res} (tolerances {tol_inv}, "
             f"{TOL_DIAG_FACTOR})")
    return _mx(LT - LTp)


def _check_pair_solve(phase, label, x, xp, LT, b, checks) -> float:
    """A pair-solve's x and its plain version's xp against an f64 solve WITH
    THE SAME f32 FACTOR LT (f64 copy of L^T): the kernel's own error, apart
    from the factor's.  Returns the largest |kernel - plain|."""
    torch.cuda.synchronize()
    t = torch.linalg.solve_triangular(LT.mT, b.double().unsqueeze(-1),
                                      upper=False)
    x64 = torch.linalg.solve_triangular(LT, t, upper=True).squeeze(-1)
    LLt = torch.matmul(LT.mT, LT)
    back = (_mx(torch.matmul(LLt, x.double().unsqueeze(-1)).squeeze(-1)
                - b.double()) / (_mx(LLt) * _mx(x)))
    res = {"rel_err_vs_f64": _mx(x.double() - x64) / _mx(x64),
           "plain_vs_f64": _mx(xp.double() - x64) / _mx(x64),
           "rel_err_vs_plain": _mx(x - xp) / _mx(x64),
           "backward_error": back}
    checks[label] = res
    if not bool(torch.isfinite(x).all()) or tuple(x.shape) != tuple(b.shape):
        fail(phase, f"{label}: bad shape or non-finite")
    if res["rel_err_vs_f64"] > TOL_SOLVE_F64 \
            or res["rel_err_vs_plain"] > TOL_SOLVE_PLAIN \
            or back > TOL_SOLVE_BACKWARD:
        fail(phase, f"{label}: {res} (tolerances {TOL_SOLVE_F64}, "
             f"{TOL_SOLVE_PLAIN}, {TOL_SOLVE_BACKWARD})")
    return _mx(x - xp)


def _check_solve(label, panels, W, b, checks) -> float:
    return _check_pair_solve(
        "panel_kernels", label, pk.chol_solve_batched_panels(panels, W, b),
        pk.chol_solve_batched_panels_plain(panels, W, b), _lt_of(panels), b,
        checks)


def _panel_work(B: int) -> dict:
    """Work of the panel kernels at (B, M_ROWS, N_COLS), as ``_matvec_work``:
    inputs read once, outputs written once; the factors' products at the
    tensor-core rate (the assembly three passes, the Cholesky work six), the
    rest in float32 at the CUDA-core rate.  The factors' rows count one
    whole factor (m / NB panel launches, the diagonal blocks and the panel
    TRSM with them, as the wrapper is timed); the pair-solve's one apply."""
    m, n, nb = M_ROWS, N_COLS, M_ROWS // NB
    panels = 4 * B * m * (m + NB) // 2          # block lower triangle, f32
    w_out = 4 * B * nb * NB * NB
    # FMAs per instance: the lower triangle of A D^2 A^T; a Cholesky factor
    # of m x m and the inverses of its nb diagonal blocks
    asm = (m * (m + 1) // 2) * n
    chol = m ** 3 // 6 + nb * NB ** 3 // 6
    factor_io = 4 * B * m * (m - NB) // 2 + w_out          # suffixes, W
    # name -> (bytes, f32 flops at the CUDA-core rate, tensor-core flops of
    # the assembly, of the Cholesky work)
    return {
        "factor_fused_panels": (2 * B * m * n + 4 * B * (n + m + 1)
                                + panels + w_out, 0, 2 * B * asm,
                                2 * B * chol),
        # the block lower triangle of M in, panels and W out
        "factor_lt_panels": (2 * panels + w_out, 0, 0, 2 * B * chol),
        # tile in, L^T and W out; NB^3 / 6 float64 FMAs for the factor and
        # as many for the inverse
        "diag_factor_inv": (3 * 4 * B * NB * NB, 0, 0, 0,
                            2 * B * NB ** 3 // 3),
        "chol_solve_batched_panels": (factor_io + 2 * 4 * B * m,
                                      2 * 2 * (factor_io // 4), 0, 0),
        # the same function from a full L^T: the strict block triangle and W
        # are all it needs of it
        "chol_solve_batched_lt": (factor_io + 2 * 4 * B * m,
                                  2 * 2 * (factor_io // 4), 0, 0),
        # one sweep: the same bytes, each met once
        "solve_triangular_batched": (factor_io + 2 * 4 * B * m,
                                     2 * (factor_io // 4), 0, 0),
        # the block lower triangle of M in, of the factor out, and W
        "cholesky_batched": _lt_factor_work(B, m),
        "factor_lt_batched": _lt_factor_work(B, m),
    }


def _assembly_work(B: int, m: int, n: int, itemsize: int) -> tuple:
    """Row 4's work at (B, m, n) as ``_matvec_work`` counts it: A and d2 in,
    M out; one product a lower-triangle entry and column of A."""
    return (B * m * n * itemsize + 4 * B * n + 4 * B * m * m, 0,
            2 * B * (m * (m + 1) // 2) * n)


def _lt_factor_work(B: int, m: int) -> tuple:
    """Row 10's work at (B, m) as ``_panel_work`` counts it: the block lower
    triangle of M in, of L^T out, W out; a Cholesky factor and the inverses
    of its diagonal blocks on the tensor cores."""
    nb = m // NB
    panels = 4 * B * m * (m + NB) // 2
    chol = m ** 3 // 6 + nb * NB ** 3 // 6
    return (2 * panels + 4 * B * nb * NB * NB, 0, 0, 2 * B * chol)


def _lt_own_work(B: int) -> dict:
    """Work of the left-looking factors' own launches at (B, M_ROWS), as
    ``_panel_work``: ``accumulate``, the m / NB accumulation launches (rows 7
    and 10: per panel k, the k prior panels' suffixes P_j[:, (k - j) NB:] and
    Ms's tile row read, C_k written; k (nb - k) tile products, six passes),
    and ``row_panels``, row 10's m / NB row-panel launches (W and the
    suffixes of C_k read, the row panels outside the diagonal tiles written,
    zeros included; nb - 1 - k tile products a panel)."""
    nb = M_ROWS // NB
    tile = 4 * NB * NB
    acc_bytes = B * tile * sum(k * (nb - k) + 2 * (nb - k) for k in range(nb))
    acc_flops = B * 2 * NB ** 3 * sum(k * (nb - k) for k in range(nb))
    rows_bytes = B * tile * (nb + sum(nb - 1 - k for k in range(nb))
                             + nb * (nb - 1))
    rows_flops = B * 2 * NB ** 3 * sum(nb - 1 - k for k in range(nb))
    return {"accumulate": (acc_bytes, 0, 0, acc_flops),
            "row_panels": (rows_bytes, 0, 0, rows_flops)}


def _panel_bounds(B: int) -> dict:
    """name -> bound fields (``_bound``) of the panel kernels' rows."""
    return {name: _bound(*w) for name, w in _panel_work(B).items()}


def phase_panel_kernels(rows: dict) -> None:
    """The four kernels of the panel-major factor against their plain
    versions and f64 oracles at B_CHECK, the pair-solve also at B = 1 and 3,
    an m off the 128 grid through ``normal_eq.factor``; then times at
    B_MAIN."""
    checks = {name: rows[name]["checks"] for name in (
        "factor_fused_panels", "factor_lt_panels", "diag_factor_inv",
        "chol_solve_batched_panels")}
    A, d2, j, reg = _panel_inputs(B_CHECK, seed=1)
    Ms64 = _scaled_f64(A, d2, j, reg)

    fused = pk.factor_fused_panels(A, d2, j, reg)
    rows["factor_fused_panels"]["max_abs_err"] = _check_factor(
        "fused/bf16", fused, pk.factor_fused_panels_plain(A, d2, j, reg),
        Ms64, checks["factor_fused_panels"])
    # reg is per instance: instance 0's first pivot is sqrt(1 + 1e-8),
    # the last one's sqrt(1 + 1e-4)
    l00 = fused[0][0][:, 0, 0].double() ** 2 - 1.0
    if abs(float(l00[-1]) - 1e-4) > 2e-6 or abs(float(l00[0])) > 2e-6:
        fail("panel_kernels", f"reg not per instance: L00^2 - 1 = {l00.tolist()}")
    # an instance alone gets the bits it gets in the batch
    alone = pk.factor_fused_panels(*(t[:1].contiguous()
                                     for t in (A, d2, j, reg)))
    if not all(torch.equal(a, b[:1]) for a, b in zip(alone[0], fused[0])) \
            or not torch.equal(alone[1], fused[1][:1]):
        fail("panel_kernels", "fused factor at B=1 differs from the same "
             "instance in a batch of 8")
    del alone

    Ms32 = Ms64.float().contiguous()
    rows["factor_lt_panels"]["max_abs_err"] = _check_factor(
        "lt/f32", pk.factor_lt_panels(Ms32), pk.factor_lt_panels_plain(Ms32),
        Ms32.double(), checks["factor_lt_panels"])

    err = _check_diag("tile", Ms32[:, :NB, :NB].contiguous(),
                      TOL_DIAG_INVERSE, checks["diag_factor_inv"])
    err = max(err, _check_diag("ill_conditioned", _ill_conditioned_block(),
                               TOL_DIAG_INVERSE_ILL,
                               checks["diag_factor_inv"]))
    rows["diag_factor_inv"]["max_abs_err"] = err
    # a block that is not positive definite: a diagonal entry that is not
    # positive (or not finite), no trap, the other instance untouched
    bad = Ms32[:2, :NB, :NB].clone()
    bad[1, 5, 5] = -1.0
    d = torch.diagonal(pk.diag_factor_inv(bad)[0], dim1=1, dim2=2)
    torch.cuda.synchronize()
    if not bool((d[0] > 0).all()) or bool(((d[1] > 0)
                                           & torch.isfinite(d[1])).all()):
        fail("panel_kernels", "non-PD block not reported on its diagonal")

    g = torch.Generator(device=DEV).manual_seed(3)
    xt = torch.randn(B_CHECK, M_ROWS, generator=g, device=DEV,
                     dtype=torch.float64)
    b = torch.matmul(Ms64, xt.unsqueeze(-1)).squeeze(-1).float()
    panels, W = fused
    err = _check_solve("B8", panels, W, b, checks["chol_solve_batched_panels"])
    x8 = pk.chol_solve_batched_panels(panels, W, b)
    for Bs in (1, 3):       # any batch: blocks are independent
        xs = pk.chol_solve_batched_panels(
            tuple(p[:Bs].contiguous() for p in panels), W[:Bs].contiguous(),
            b[:Bs].contiguous())
        if not torch.equal(xs, x8[:Bs]):
            fail("panel_kernels", f"pair-solve at B={Bs} differs from the "
                 "same instances in a batch of 8")
    rows["chol_solve_batched_panels"]["max_abs_err"] = err

    # m = 1000: assembled, padded to 1024 with an identity block (rows 4 + 7)
    Ap, d2p, _, _ = _panel_inputs(B_CHECK, seed=1, m=M_PADDED)
    before = counts()
    fac = normal_eq.factor(Ap, d2p, slice_options())
    rp = b[:, :M_PADDED].contiguous()
    yp = normal_eq._chol_solve(fac, rp)
    after = counts()
    Msp = _scaled_f64(Ap, d2p, fac.j, torch.full((B_CHECK,), 1e-8, device=DEV))
    back = (_mx(torch.matmul(Msp, yp.double().unsqueeze(-1)).squeeze(-1)
                - rp.double()) / (_mx(Msp) * _mx(yp)))
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    checks["factor_lt_panels"]["padded_m1000"] = {
        "backward_error": back, "launched": delta}
    if not bool(fac.ok.all()) or tuple(yp.shape) != (B_CHECK, M_PADDED) \
            or back > TOL_PADDED_BACKWARD \
            or delta != {"assemble_sym_batched": 1, "factor_lt_panels": 8,
                         "diag_factor_inv": 8, "chol_solve_batched_panels": 1}:
        fail("panel_kernels", f"padded route: backward error {back:.3e}, "
             f"launched {delta}")
    del A, Ms64, Ms32, fused, panels, W, fac
    torch.cuda.empty_cache()

    # ---- times at the main path's batch --------------------------------------
    # A factor's row times its wrapper whole: the m / NB panel launches with
    # the diagonal kernel and the panel TRSM (a library bmm) between them.
    # ``trsm_bmm_ms`` and the diagonal kernel's own row say what of it is not
    # the panel kernel's.
    A, d2, j, reg = _panel_inputs(B_MAIN, seed=2)
    bounds = _panel_bounds(B_MAIN)
    nb = M_ROWS // NB

    def set_times(name, kern, plain, **extra):
        rows[name]["ms"] = time_ms(kern, reps=5, warm=1)
        rows[name]["plain_ms"] = time_ms(plain, reps=2, warm=1)
        rows[name].update(bounds[name])
        rows[name].update(extra)

    panels, W = pk.factor_fused_panels(A, d2, j, reg)
    dst = torch.empty_like(panels[0])

    def panel_trsms():
        for k in range(nb - 1):
            w = M_ROWS - (k + 1) * NB
            torch.bmm(W[:, k], panels[k][:, :, NB:],
                      out=dst.view(-1)[:B_MAIN * NB * w].view(B_MAIN, NB, w))

    trsm_ms = time_ms(panel_trsms, reps=5, warm=1)
    del dst
    scratch = torch.empty(B_MAIN * NB * M_ROWS, device=DEV)

    def panel_stages():
        # the m / NB panel launches alone, on the factor's own prior panels
        stage = pk._fused_panel_rows(A, d2, j, reg)
        for k in range(nb):
            w = M_ROWS - k * NB
            stage(k, panels[:k], scratch[:B_MAIN * NB * w].view(B_MAIN, NB, w))

    panels_ms = time_ms(panel_stages, reps=5, warm=1)
    del scratch
    xla_opts = slice_options(chol_backend="xla")
    set_times("factor_fused_panels",
              lambda: pk.factor_fused_panels(A, d2, j, reg),
              lambda: pk.factor_fused_panels_plain(A, d2, j, reg),
              # no one library call computes it; the route it replaces is
              # assemble + scale + reg I + cholesky_ex, timed here
              library_ms=None, panels_ms=panels_ms, trsm_bmm_ms=trsm_ms,
              library_route_ms=time_ms(
                  lambda: normal_eq.factor(A, d2, xla_opts), reps=5, warm=1))

    Ms = pk.assemble_sym_batched(A, d2)
    Ms.mul_(j.unsqueeze(2)).mul_(j.unsqueeze(1))
    Ms.diagonal(dim1=1, dim2=2).add_(reg.unsqueeze(-1))
    p7, _ = pk.factor_lt_panels(Ms)
    scratch = torch.empty(B_MAIN * NB * M_ROWS, device=DEV)

    def lt_stages():
        # the m / NB accumulation launches alone, on the factor's own prior
        # panels
        stage = pk._lt_panel_rows(Ms)
        for k in range(nb):
            w = M_ROWS - k * NB
            stage(k, p7[:k], scratch[:B_MAIN * NB * w].view(B_MAIN, NB, w))

    own = _lt_own_work(B_MAIN)["accumulate"]
    set_times("factor_lt_panels",
              lambda: pk.factor_lt_panels(Ms),
              lambda: pk.factor_lt_panels_plain(Ms),
              # the same function in one library call
              library_ms=time_ms(lambda: torch.linalg.cholesky_ex(
                  Ms, check_errors=False), reps=5, warm=1),
              trsm_bmm_ms=trsm_ms,
              own_ms=time_ms(lt_stages, reps=5, warm=1),
              own_bound=_bound(*own),
              own_f32_cuda_core_ms=_f32_cuda_core_ms(*own))
    del p7, scratch

    CD = Ms[:, :NB, :NB].contiguous()
    eye = torch.eye(NB, device=DEV).expand(B_MAIN, NB, NB)

    def diag_library():
        # no single call: the factor, then its inverse as a triangular solve
        # against the identity
        L_, _ = torch.linalg.cholesky_ex(CD, check_errors=False)
        return L_, torch.linalg.solve_triangular(L_, eye, upper=False)

    set_times("diag_factor_inv", lambda: pk.diag_factor_inv(CD),
              lambda: pk.diag_factor_inv_plain(CD),
              library_ms=time_ms(diag_library, reps=5, warm=1),
              # every call enqueued before the first runs: a launch takes
              # the host about as long as the kernel takes the card
              queued_ms=time_ms(lambda: pk.diag_factor_inv(CD),
                                queued=True))

    g = torch.Generator(device=DEV).manual_seed(4)
    b = torch.randn(B_MAIN, M_ROWS, generator=g, device=DEV)
    L, _ = torch.linalg.cholesky_ex(Ms, check_errors=False)
    b3 = b.unsqueeze(-1)
    p16 = tuple(p[:B_PADDED].contiguous() for p in panels)
    W16, b16 = W[:B_PADDED].contiguous(), b[:B_PADDED].contiguous()
    set_times("chol_solve_batched_panels",
              lambda: pk.chol_solve_batched_panels(panels, W, b),
              lambda: pk.chol_solve_batched_panels_plain(panels, W, b),
              # one library call of the same function, on the library's factor
              library_ms=time_ms(lambda: torch.cholesky_solve(b3, L)),
              # and the two triangular solves the library route applies
              two_trsm_ms=time_ms(lambda: torch.linalg.solve_triangular(
                  L.mT, torch.linalg.solve_triangular(L, b3, upper=False),
                  upper=True)),
              # the padded path's batch: the first B_PADDED instances, every
              # call enqueued before the first runs (the kernel, not the
              # host's launch)
              b16_ms=time_ms(lambda: pk.chol_solve_batched_panels(
                  p16, W16, b16), queued=True))
    del A, Ms, L, panels, W, p16, W16, b16
    torch.cuda.empty_cache()
    emit("panel_kernels", ok=True, batch_check=B_CHECK, batch_timed=B_MAIN,
         m=M_ROWS, n=N_COLS,
         tolerances=dict(panels_vs_f64=TOL_PANELS_F64,
                         panels_vs_plain=TOL_PANELS_PLAIN,
                         reconstruction=TOL_RECONSTRUCT,
                         solve_vs_f64=TOL_SOLVE_F64,
                         solve_vs_plain=TOL_SOLVE_PLAIN,
                         solve_backward=TOL_SOLVE_BACKWARD,
                         padded_backward=TOL_PADDED_BACKWARD,
                         diag_inverse=TOL_DIAG_INVERSE,
                         diag_inverse_ill=TOL_DIAG_INVERSE_ILL,
                         diag_factor=TOL_DIAG_FACTOR),
         kernels=[rows[k] for k in checks])


# --------------------------------------------------------------------------
# the factors and solves over a full (B, m, m) matrix
# --------------------------------------------------------------------------

def _lanes_bitwise(phase, name, call, args, full) -> None:
    """``call`` on the first 1 and 3 instances of ``args`` gives those lanes
    the bits they have in ``full``, the result on the batch of 8."""
    for Bs in (1, 3):
        got = call(*(a[:Bs].contiguous() for a in args))
        got = got if isinstance(got, tuple) else (got,)
        if not all(torch.equal(g, f[:Bs]) for g, f in zip(got, full)):
            fail(phase, f"{name} at B={Bs} differs from the same instances "
                 "in a batch of 8")


def _limit_checks(checks) -> str | None:
    """m = MAX_M is taken by all four kernels (one instance, factor then
    solve), m = MAX_M + 128 refused by each wrapper but the full-matrix
    factor ``factor_lt_batched`` (which takes it: ``_large_m_factor``) and by
    ``normal_eq.factor`` before any factor work.  Returns what went wrong, or
    None."""
    m = pk.MAX_M
    g = torch.Generator(device=DEV).manual_seed(5)
    G = torch.randn(1, m, m, generator=g, device=DEV) / m ** 0.5
    M = torch.matmul(G, G.mT)
    M.diagonal(dim1=1, dim2=2).add_(1.0)
    b = torch.randn(1, m, generator=g, device=DEV)
    LT, W = pk.factor_lt_batched(M)
    x = pk.chol_solve_batched_lt(LT, W, b)
    L, W9 = pk.cholesky_batched(M)
    x2 = pk.solve_triangular_batched(
        L, W9, pk.solve_triangular_batched(L, W9, b, lower=True), lower=False)
    torch.cuda.synchronize()
    M64 = M.double()
    back = [_mx(torch.matmul(M64, v.double().unsqueeze(-1)).squeeze(-1)
                - b.double()) / (_mx(M64) * _mx(v)) for v in (x, x2)]
    checks["chol_solve_batched_lt"][f"m{m}"] = {"backward_error": back[0]}
    checks["solve_triangular_batched"][f"m{m}"] = {"backward_error": back[1]}
    if not max(back) <= TOL_PADDED_BACKWARD:
        return f"m={m}: backward errors {back}"
    del G, M, M64, LT, L
    big = m + NB
    Z = torch.zeros(1, big, big, device=DEV)
    Wz = torch.zeros(1, big // NB, NB, NB, device=DEV)
    bz = torch.zeros(1, big, device=DEV)
    before = counts()
    attempts = {
        "cholesky_batched": lambda: pk.cholesky_batched(Z),
        "chol_solve_batched_lt": lambda: pk.chol_solve_batched_lt(Z, Wz, bz),
        "solve_triangular_batched":
            lambda: pk.solve_triangular_batched(Z, Wz, bz),
        "normal_eq.factor": lambda: normal_eq.factor(
            torch.zeros(1, big, NB, dtype=torch.bfloat16, device=DEV),
            torch.ones(1, NB, device=DEV),
            slice_options(chol_backend="pallas")),
    }
    for name, call in attempts.items():
        try:
            call()
        except ValueError:
            continue
        return f"{name} took m={big} instead of refusing it"
    return None if counts() == before else f"a refused m={big} launched"


def _diag_rel(got, ref) -> dict:
    """Mean and RMS of (got - ref) / ref on the diagonals of (B', n, n)
    tensors, ref float64: a sum whose terms all have one sign shows a biased
    rounding as a mean away from zero.  Beside them the RMS of the
    off-diagonal error relative to each matrix's largest entry of ref."""
    E = got.double() - ref
    d = (torch.diagonal(E, dim1=-2, dim2=-1)
         / torch.diagonal(ref, dim1=-2, dim2=-1))
    off = (E - torch.diag_embed(torch.diagonal(E, dim1=-2, dim2=-1))
           ) / ref.abs().amax(dim=(-2, -1), keepdim=True)
    return {"diag_mean_rel": float(d.mean()),
            "diag_rms_rel": float((d ** 2).mean().sqrt()),
            "offdiag_rms_rel": float((off ** 2).mean().sqrt())}


def _start_tile_diagonals(A, d2, j, reg) -> dict:
    """Row 5's start tiles, the first tile of every panel's C_k, against
    float64 (``_diag_rel``): the whole (J (A_k d2 A_k^T) J + reg - sum_j
    P_j^T P_j, relative to it), the assembly alone (reg 0, zero prior
    panels) and the subtraction alone (d2 = 0, which makes the assembly
    exactly 0, reg 0; relative to the sum subtracted), with the P_j the
    kernel's own panels.  ``probes/assembly_error.py`` runs it on any
    checkout."""
    B, m, _ = A.shape
    dev = A.device
    panels, _ = pk.factor_fused_panels(A, d2, j, reg)
    A64, j64, x64 = A.double(), j.double(), A.double() * d2.double()[:, None]
    zreg = torch.zeros_like(reg)
    runs = {"whole": (pk._fused_panel_rows(A, d2, j, reg), panels),
            "assembly": (pk._fused_panel_rows(A, d2, j, zreg),
                         tuple(torch.zeros_like(p) for p in panels)),
            "subtraction": (pk._fused_panel_rows(A, torch.zeros_like(d2), j,
                                                 zreg), panels)}
    out = {}
    for name, (rows, prior) in runs.items():
        got, ref = [], []
        for k in range(0 if name != "subtraction" else 1, m // NB):
            o = k * NB
            C = torch.empty(B, NB, m - o, device=dev)
            rows(k, prior[:k], C)
            S = 0.0
            for i, p in enumerate(panels[:k]):
                P = p[:, :, (k - i) * NB:(k - i + 1) * NB].double()
                S = S + torch.matmul(P.mT, P)
            R = -S if name == "subtraction" else (
                torch.matmul(x64[:, o:o + NB], A64[:, o:o + NB].mT)
                * j64[:, o:o + NB, None] * j64[:, None, o:o + NB])
            if name == "whole":
                R = R + torch.diag_embed(reg.double()[:, None].expand(B, NB))
                R = R - S
            got.append(C[:, :, :NB])
            ref.append(R)
        out[name] = _diag_rel(torch.cat(got), torch.cat(ref))
    return out


def _tile_rel(got, ref) -> dict:
    """Mean and RMS of (got - ref) over whole (B', n, n) tiles, relative to
    each tile's largest entry of ref (float64)."""
    E = (got.double() - ref) / ref.abs().amax(dim=(-2, -1), keepdim=True)
    return {"tile_mean_rel": float(E.mean()),
            "tile_rms_rel": float((E ** 2).mean().sqrt())}


def _lt_start_tiles(Ms, panels, rows) -> dict:
    """Row 7's start tiles, the first tile of every C_k with k >= 1, from
    ``rows(k, prior, C)`` (``kernels.cholesky._lt_panel_rows(Ms)`` or
    another build's launches) on the prior panels ``panels`` of a factor of
    Ms, against float64: ``whole``, C_k against Ms's tile less sum_j
    P_j^T P_j, relative to that value, and ``subtraction``, C_k - Ms against
    minus the sum, relative to the sum subtracted (``_diag_rel``, and the
    whole tile's mean and RMS, ``_tile_rel``).  ``probes/assembly_error.py``
    runs it on any checkout."""
    B, m, _ = Ms.shape
    got, start, S = [], [], []
    for k in range(1, m // NB):
        o = k * NB
        C = torch.empty(B, NB, m - o, device=Ms.device)
        rows(k, panels[:k], C)
        s = 0.0
        for i, p in enumerate(panels[:k]):
            P = p[:, :, (k - i) * NB:(k - i + 1) * NB].double()
            s = s + torch.matmul(P.mT, P)
        got.append(C[:, :, :NB].double())
        start.append(Ms[:, o:o + NB, o:o + NB].double())
        S.append(s)
    got, start, S = torch.cat(got), torch.cat(start), torch.cat(S)
    return {"whole": {**_diag_rel(got, start - S), **_tile_rel(got, start - S)},
            "subtraction": {**_diag_rel(got - start, -S),
                            **_tile_rel(got - start, -S)}}


def _right_own_ms(Ms) -> float:
    """Device time of ``cholesky_batched``'s panel TRSMs and trailing updates
    of Ms without its diagonal launches: each timed call runs them in place
    on a fresh copy of Ms with the factor's own W (they read no diagonal
    tile), so they see the values of a real factor."""
    _, W = pk.cholesky_batched(Ms)
    T = torch.empty_like(Ms)

    def panels():
        for k in range(Ms.shape[1] // NB - 1):
            pk._right_panel(T, W, k)

    return time_ms(panels, reps=5, warm=1, setup=lambda: T.copy_(Ms))


def _lt_own_ms(Ms) -> dict:
    """``factor_lt_batched``'s own launches on Ms, timed apart: its m / NB
    accumulation launches on the factor's own L^T, and its m / NB row-panel
    launches (each k's C_k kept from a first pass) into a copy of that L^T,
    each beside its floor (``_lt_own_work``)."""
    nb, B = M_ROWS // NB, Ms.shape[0]
    LT, W = pk.factor_lt_batched(Ms)
    Cs = [torch.empty(B, NB, M_ROWS - k * NB, device=DEV) for k in range(nb)]
    for k, C in enumerate(Cs):
        pk._lt_accumulate(Ms, LT, C, k)
    LT2 = LT.clone()

    def accumulate():
        for k, C in enumerate(Cs):
            pk._lt_accumulate(Ms, LT, C, k)

    def row_panels():
        for k, C in enumerate(Cs):
            pk._lt_row_panel(W, C, LT2, k)

    work = _lt_own_work(B)
    out = {"accumulate_own_ms": time_ms(accumulate, reps=5, warm=1),
           "accumulate_own_bound": _bound(*work["accumulate"]),
           "row_panels_own_ms": time_ms(row_panels, reps=5, warm=1),
           "row_panels_own_bound": _bound(*work["row_panels"])}
    torch.cuda.synchronize()
    if not torch.equal(LT2, LT):
        fail("lt_kernels", "factor_lt_batched's row panels differ when "
             "launched again on the same C_k")
    return out


def _large_m_factor(rows: dict) -> None:
    """Row 10 at B = 1 and m = M_ROW10, past MAX_M (the large single LP's
    factor): against its plain version and the f64 factor with the panel
    factors' limits, its backward error, its time beside its bound; the
    pair-solve still refuses that m, launching nothing."""
    phase, m = "lt_kernels", M_ROW10
    g = torch.Generator(device=DEV).manual_seed(6)
    G = torch.randn(1, m, m, generator=g, device=DEV) / m ** 0.5
    M = torch.matmul(G, G.mT)
    M.diagonal(dim1=1, dim2=2).add_(1.0)
    del G
    LT, W = pk.factor_lt_batched(M)
    LTp, _ = pk.factor_lt_batched_plain(M)
    M64 = M.double()
    L64 = torch.linalg.cholesky(M64)
    LT64 = LT.double()
    top = _mx(L64)
    res = {"m": m, "batch": 1,
           "vs_f64": _mx(LT64 - L64.mT) / top,
           "vs_plain": _mx(LT - LTp) / top,
           "backward": _mx(torch.matmul(LT64.mT, LT64) - M64) / _mx(M64)}
    Lkk = torch.stack([LT64[0, o:o + NB, o:o + NB].mT
                       for o in range(0, m, NB)])
    res["w_inverse"] = _mx(torch.matmul(W[0].double(), Lkk)
                           - torch.eye(NB, device=DEV, dtype=torch.float64))
    del M64, L64, LT64, LTp
    if not (res["vs_f64"] <= TOL_PANELS_F64 and res["vs_plain"] <= TOL_LT_PLAIN
            and res["backward"] <= TOL_RECONSTRUCT
            and res["w_inverse"] <= TOL_DIAG_INVERSE):
        fail(phase, f"factor_lt_batched at m={m}: {res}")
    before = counts()
    try:
        pk.chol_solve_batched_lt(LT, W, torch.zeros(1, m, device=DEV))
    except ValueError:
        res["pair_solve_refuses"] = True
    else:
        fail(phase, f"chol_solve_batched_lt took m={m}")
    if counts() != before:
        fail(phase, f"a refused m={m} launched")
    res["ms"] = time_ms(lambda: pk.factor_lt_batched(M), reps=3, warm=1)
    res["plain_ms"] = time_ms(lambda: pk.factor_lt_batched_plain(M), reps=2,
                              warm=1)
    res["library_ms"] = time_ms(
        lambda: torch.linalg.cholesky_ex(M, check_errors=False), reps=3, warm=1)
    res.update(_bound(*_lt_factor_work(1, m)))
    rows["factor_lt_batched"][f"m{m}_b1"] = res
    del M, LT, W
    torch.cuda.empty_cache()


def phase_lt_kernels(rows: dict) -> None:
    """The four kernels over a full (B, m, m) matrix against their plain
    versions and f64 oracles at B_CHECK on the panel kernels' ill-conditioned
    inputs, against the panel kernels on the same factor, at B = 1 and 3, at
    the largest m and past it; then times at B_MAIN."""
    phase = "lt_kernels"
    checks = {name: rows[name]["checks"] for name in LT_KERNELS}
    A, d2, j, reg = _panel_inputs(B_CHECK, seed=1)
    Ms64 = _scaled_f64(A, d2, j, reg)
    Ms32 = Ms64.float().contiguous()
    Ms32_64 = Ms32.double()

    # ---- the two factors -----------------------------------------------------
    L, W9 = pk.cholesky_batched(Ms32)
    Lp, _ = pk.cholesky_batched_plain(Ms32)
    rows["cholesky_batched"]["max_abs_err"] = _check_lt(
        phase, "right/f32", L.mT, W9, Lp.mT, Ms32_64,
        checks["cholesky_batched"], tol_plain=TOL_LT_PLAIN)
    if _mx(torch.triu(L, 1)) != 0.0:
        fail(phase, "cholesky_batched: strict upper triangle not exactly 0")
    LT, W10 = pk.factor_lt_batched(Ms32)
    LTpl, _ = pk.factor_lt_batched_plain(Ms32)
    rows["factor_lt_batched"]["max_abs_err"] = _check_lt(
        phase, "lt/f32", LT, W10, LTpl, Ms32_64, checks["factor_lt_batched"],
        tol_plain=TOL_LT_PLAIN)
    if _mx(torch.tril(LT, -1)) != 0.0:
        fail(phase, "factor_lt_batched: strict lower triangle not exactly 0")
    # against the panel-major factor of the same matrix: the accumulation is
    # the same kernel body, so panel 0's diagonal tile and W_0 agree bit for
    # bit; the panel TRSM is another product (hand-written here, a library
    # matmul there), so everything behind it agrees to rounding
    panels7, W7 = pk.factor_lt_panels(Ms32)
    LT7 = pk.lt_of_panels(panels7)
    vs7 = _mx(LT - LT7) / _mx(LT7)
    checks["factor_lt_batched"]["vs_factor_lt_panels"] = {
        "rel_diff": vs7, "w_rel_diff": _mx(W10 - W7) / _mx(W7)}
    if not torch.equal(LT[:, :NB, :NB], LT7[:, :NB, :NB]) \
            or not torch.equal(W10[:, 0], W7[:, 0]) or vs7 > TOL_LT_VS_PANELS:
        fail(phase, f"factor_lt_batched against factor_lt_panels: first tile "
             f"not bitwise, or rest off by {vs7:.3e}")
    # rows 7 and 10 run one accumulation body over two address maps: from
    # row 10's own prior rows, row 7's launches give every C_k bit for bit,
    # and the diagonal kernel on it row 10's L_kk^T and W_k
    p10, rows7 = pk.panels_of_lt(LT), pk._lt_panel_rows(Ms32)
    for k in range(M_ROWS // NB):
        o = k * NB
        C7 = torch.empty(B_CHECK, NB, M_ROWS - o, device=DEV)
        C10 = torch.empty_like(C7)
        rows7(k, p10[:k], C7)
        pk._lt_accumulate(Ms32, LT, C10, k)
        L7, Wk = pk.diag_factor_inv(C7[:, :, :NB])
        if not (torch.equal(C7, C10)
                and torch.equal(L7, LT[:, o:o + NB, o:o + NB])
                and torch.equal(Wk, W10[:, k])):
            fail(phase, f"panel {k}: factor_lt_panels' accumulation on "
                 "factor_lt_batched's prior rows differs from its own")
    checks["factor_lt_batched"]["rows_7_10_bitwise"] = True
    del p10, C7, C10

    # ---- the pair-solve from a full L^T -----------------------------------------
    g = torch.Generator(device=DEV).manual_seed(3)
    xt = torch.randn(B_CHECK, M_ROWS, generator=g, device=DEV,
                     dtype=torch.float64)
    b = torch.matmul(Ms64, xt.unsqueeze(-1)).squeeze(-1).float()
    x8 = pk.chol_solve_batched_lt(LT, W10, b)
    rows["chol_solve_batched_lt"]["max_abs_err"] = _check_pair_solve(
        phase, "B8", x8, pk.chol_solve_batched_lt_plain(LT, W10, b),
        LT.double(), b, checks["chol_solve_batched_lt"])
    # the panel pair-solve on the same factor: the same bits
    x6 = pk.chol_solve_batched_panels(panels7, W7, b)
    if not torch.equal(pk.chol_solve_batched_lt(LT7, W7, b), x6):
        fail(phase, "chol_solve_batched_lt differs from "
             "chol_solve_batched_panels on the same factor")
    # nothing on or below the diagonal is read
    LTn = LT7.clone()
    LTn[torch.ones(M_ROWS, M_ROWS, dtype=torch.bool, device=DEV).tril()
        .expand_as(LTn)] = float("nan")
    if not torch.equal(pk.chol_solve_batched_lt(LTn, W7, b), x6):
        fail(phase, "chol_solve_batched_lt reads below the strict suffixes")
    del LTn

    # ---- one sweep, twice, against the pair-solve on L^T ------------------------
    y = pk.solve_triangular_batched(L, W9, b, lower=True)
    x11 = pk.solve_triangular_batched(L, W9, y, lower=False)
    yp = pk.solve_triangular_batched_plain(L, W9, b, lower=True)
    xp = pk.solve_triangular_batched_plain(L, W9, yp, lower=False)
    rows["solve_triangular_batched"]["max_abs_err"] = _check_pair_solve(
        phase, "two_sweeps", x11, xp, L.mT.double(), b,
        checks["solve_triangular_batched"])
    y64 = torch.linalg.solve_triangular(L.double(), b.double().unsqueeze(-1),
                                        upper=False).squeeze(-1)
    x8r = pk.chol_solve_batched_lt(L.mT.contiguous(), W9, b)
    sweeps = {"lower_rel_err_vs_f64": _mx(y.double() - y64) / _mx(y64),
              "lower_plain_vs_f64": _mx(yp.double() - y64) / _mx(y64),
              "two_sweeps_vs_pair_solve": _mx(x11 - x8r) / _mx(x8r)}
    checks["solve_triangular_batched"]["sweeps"] = sweeps
    if sweeps["lower_rel_err_vs_f64"] > TOL_SOLVE_F64 \
            or sweeps["two_sweeps_vs_pair_solve"] > TOL_TWO_SWEEPS:
        fail(phase, f"solve_triangular_batched: {sweeps}")

    # ---- a lane gets the same bits at any batch size ----------------------------
    _lanes_bitwise(phase, "cholesky_batched", pk.cholesky_batched, (Ms32,),
                   (L, W9))
    _lanes_bitwise(phase, "factor_lt_batched", pk.factor_lt_batched, (Ms32,),
                   (LT, W10))
    _lanes_bitwise(phase, "chol_solve_batched_lt", pk.chol_solve_batched_lt,
                   (LT, W10, b), (x8,))
    for lower, full in ((True, y), (False, pk.solve_triangular_batched(
            L, W9, b, lower=False))):
        _lanes_bitwise(
            phase, f"solve_triangular_batched(lower={lower})",
            lambda L_, W_, b_: pk.solve_triangular_batched(L_, W_, b_,
                                                           lower=lower),
            (L, W9, b), (full,))

    # ---- a lane that is not positive definite shows on its own diagonal ---------
    bad = Ms32[:2].clone()
    bad[1, 130, 130] = -1.0
    for name, fn, full in (("cholesky_batched", pk.cholesky_batched, L),
                           ("factor_lt_batched", pk.factor_lt_batched, LT)):
        F, _ = fn(bad)
        d = torch.diagonal(F, dim1=1, dim2=2)
        torch.cuda.synchronize()
        if not torch.equal(F[0], full[0]) or bool(
                ((d[1] > 0) & torch.isfinite(d[1])).all()):
            fail(phase, f"{name}: a lane that is not positive definite is "
                 "not reported on its diagonal, or touched its neighbour")
    opts = slice_options(chol_backend="pallas")
    d2bad = d2[:2].clone()
    d2bad[1] = -d2bad[1]
    ok = normal_eq.factor(A[:2].contiguous(), d2bad, opts).ok.tolist()
    if ok != [True, False]:
        fail(phase, f"normal_eq.factor: ok = {ok} for a negative d2 in lane 1")

    wrong = _limit_checks(checks)
    if wrong:
        fail(phase, wrong)
    _large_m_factor(rows)
    # a tensor-core sum of one sign shows a bias on the diagonal: rows 5's
    # and 7's start tiles against f64 (row 9's update:
    # probes/assembly_error.py)
    diagonals = {"fused_start_tiles": _start_tile_diagonals(A, d2, j, reg),
                 "lt_start_tiles": _lt_start_tiles(
                     Ms32, panels7, pk._lt_panel_rows(Ms32))}
    del A, Ms64, Ms32, Ms32_64, L, Lp, LT, LTpl, LT7, panels7
    torch.cuda.empty_cache()

    # ---- times at the main path's batch ---------------------------------------------
    A, d2, j, reg = _panel_inputs(B_MAIN, seed=2)
    bounds = _panel_bounds(B_MAIN)
    Ms = pk.assemble_sym_batched(A, d2)
    Ms.mul_(j.unsqueeze(2)).mul_(j.unsqueeze(1))
    Ms.diagonal(dim1=1, dim2=2).add_(reg.unsqueeze(-1))
    del A

    def set_times(name, kern, plain, **extra):
        rows[name]["ms"] = time_ms(kern, reps=5, warm=1)
        rows[name]["plain_ms"] = time_ms(plain, reps=2, warm=1)
        rows[name].update(bounds[name])
        rows[name].update(extra)

    def diag_launches(kern) -> int:
        """Launches of the diagonal-block kernel inside one call of kern."""
        before = pk.LAUNCHES["diag_factor_inv"]
        kern()
        return pk.LAUNCHES["diag_factor_inv"] - before

    # the same function in one library call, for both factors
    chol_ms = time_ms(lambda: torch.linalg.cholesky_ex(Ms, check_errors=False),
                      reps=5, warm=1)
    set_times("cholesky_batched", lambda: pk.cholesky_batched(Ms),
              lambda: pk.cholesky_batched_plain(Ms), library_ms=chol_ms,
              diag_launches_inside=diag_launches(
                  lambda: pk.cholesky_batched(Ms)),
              # row 9's own time: its 14 launches without the 8 diagonal ones
              own_ms=_right_own_ms(Ms))
    set_times("factor_lt_batched", lambda: pk.factor_lt_batched(Ms),
              lambda: pk.factor_lt_batched_plain(Ms), library_ms=chol_ms,
              diag_launches_inside=diag_launches(
                  lambda: pk.factor_lt_batched(Ms)),
              # the panel-major factor of the same matrix, same run
              factor_lt_panels_ms=time_ms(lambda: pk.factor_lt_panels(Ms),
                                          reps=5, warm=1),
              **_lt_own_ms(Ms))
    L, W = pk.cholesky_batched(Ms)
    LT = L.mT.contiguous()
    panels = pk.panels_of_lt(LT)
    g = torch.Generator(device=DEV).manual_seed(4)
    b = torch.randn(B_MAIN, M_ROWS, generator=g, device=DEV)
    b3 = b.unsqueeze(-1)
    set_times("chol_solve_batched_lt",
              lambda: pk.chol_solve_batched_lt(LT, W, b),
              lambda: pk.chol_solve_batched_lt_plain(LT, W, b),
              library_ms=time_ms(lambda: torch.cholesky_solve(b3, L)),
              two_trsm_ms=time_ms(lambda: torch.linalg.solve_triangular(
                  L.mT, torch.linalg.solve_triangular(L, b3, upper=False),
                  upper=True)),
              # the panel pair-solve on the same factor, same run
              chol_solve_batched_panels_ms=time_ms(
                  lambda: pk.chol_solve_batched_panels(panels, W, b)))
    set_times("solve_triangular_batched",
              lambda: pk.solve_triangular_batched(L, W, b, lower=True),
              lambda: pk.solve_triangular_batched_plain(L, W, b, lower=True),
              library_ms=time_ms(lambda: torch.linalg.solve_triangular(
                  L, b3, upper=False)),
              upper_ms=time_ms(lambda: pk.solve_triangular_batched(
                  L, W, b, lower=False)),
              upper_library_ms=time_ms(lambda: torch.linalg.solve_triangular(
                  L.mT, b3, upper=True)))
    del Ms, L, LT, panels, W
    torch.cuda.empty_cache()
    emit(phase, ok=True, batch_check=B_CHECK, batch_timed=B_MAIN, m=M_ROWS,
         diagonals=diagonals,
         tolerances=dict(factor_vs_f64=TOL_PANELS_F64,
                         factor_vs_plain=TOL_LT_PLAIN,
                         reconstruction=TOL_RECONSTRUCT,
                         lt_vs_panels=TOL_LT_VS_PANELS,
                         solve_vs_f64=TOL_SOLVE_F64,
                         solve_vs_plain=TOL_SOLVE_PLAIN,
                         solve_backward=TOL_SOLVE_BACKWARD,
                         two_sweeps=TOL_TWO_SWEEPS,
                         largest_m_backward=TOL_PADDED_BACKWARD),
         kernels=[rows[k] for k in LT_KERNELS])


def phase_kernel_api() -> dict:
    """The kernel module's public paths at the main path's batch, as the
    package's users drive them: ``factor_lt_batched`` then
    ``chol_solve_batched_lt``, and ``cholesky_batched`` then
    ``solve_triangular_batched`` forward and backward, solving SPD systems
    against an f64 solve.  Returns the launch counts of this run."""
    phase = "kernel_api"
    A, d2, j, reg = _panel_inputs(B_MAIN, seed=6)
    Ms = pk.assemble_sym_batched(A, d2)
    Ms.mul_(j.unsqueeze(2)).mul_(j.unsqueeze(1))
    Ms.diagonal(dim1=1, dim2=2).add_(reg.unsqueeze(-1))
    del A
    g = torch.Generator(device=DEV).manual_seed(7)
    b = torch.randn(B_MAIN, M_ROWS, generator=g, device=DEV)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    LT, W = pk.factor_lt_batched(Ms)
    x_lt = pk.chol_solve_batched_lt(LT, W, b)
    L, W9 = pk.cholesky_batched(Ms)
    y = pk.solve_triangular_batched(L, W9, b, lower=True)
    x_tri = pk.solve_triangular_batched(L, W9, y, lower=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = counts()
    del LT, L
    Ms64 = Ms.double()
    x64 = torch.cholesky_solve(b.double().unsqueeze(-1),
                               torch.linalg.cholesky(Ms64)).squeeze(-1)
    res = {}
    for name, x in (("factor_lt+chol_solve_lt", x_lt),
                    ("cholesky+two_sweeps", x_tri)):
        res[name] = {
            "backward_error": _mx(torch.matmul(
                Ms64, x.double().unsqueeze(-1)).squeeze(-1) - b.double())
            / (_mx(Ms64) * _mx(x)),
            "rel_err_vs_f64": _mx(x.double() - x64) / _mx(x64)}
    problems = []
    for name, r in res.items():
        if not r["backward_error"] <= TOL_API_BACKWARD:
            problems.append(f"{name}: {r}")
    if any(launched[k] == 0 for k in PATH_KERNELS["kernel_api"]):
        problems.append(f"a kernel of the path was never launched: {launched}")
    emit(phase, ok=not problems, batch=B_MAIN, m=M_ROWS,
         seconds=round(secs, 3), launches=launched,
         tolerances=dict(backward=TOL_API_BACKWARD),
         **res)
    if problems:
        fail(phase, "; ".join(problems))
    del Ms, Ms64
    torch.cuda.empty_cache()
    return launched


def _contract_problems(sols, obj_star, n_min: int) -> tuple:
    """The OPTIMAL lanes' objective errors, and what fails the contract:
    a non-finite or misshapen lane, fewer than ``n_min`` OPTIMAL, an
    OPTIMAL lane off the 1e-5 objective or the 1e-6 gap."""
    opt = [(s, o) for s, o in zip(sols, obj_star) if s.optimal]
    obj_err = [abs(s.objective - o) / (1 + abs(o)) for s, o in opt]
    problems = []
    if any(s.x.shape != (N_COLS,)
           or not all(np.isfinite(a).all() for a in (s.x, s.y, s.s))
           for s in sols):
        problems.append("non-finite or misshapen solution")
    if len(opt) < n_min:
        problems.append(f"only {len(opt)} of {len(sols)} lanes OPTIMAL")
    if obj_err and max(obj_err) > 1e-5:
        problems.append(f"OPTIMAL objective off by {max(obj_err):.3e}")
    if opt and max(s.rel_gap for s, _ in opt) > 1e-6:
        problems.append("an OPTIMAL lane misses the 1e-6 gap")
    return opt, obj_err, problems


def _status_counts(sols) -> dict:
    out: dict = {}
    for s in sols:
        out[s.status_name] = out.get(s.status_name, 0) + 1
    return out


def phase_solve_batch(path: str, batch: int, m: int, opts):
    """One whole ``solve_batch`` on ``batch`` fresh instances: every kernel
    of ``path`` must be launched, at least half of the lanes end OPTIMAL,
    and every OPTIMAL lane meets the contract."""
    phase = f"solve_batch/{path}"
    g = torch.Generator(device=DEV).manual_seed(0)
    gb = random_feasible_batch_device(batch, m, N_COLS, g,
                                      a_storage="bfloat16", device=DEV)
    torch.cuda.synchronize()
    reset_counts()
    with LibraryFactorCalls() as lib:
        t0 = time.perf_counter()
        sols = ipx_torch.solve_batch(gb.lp, options=opts, device=DEV)
        secs = time.perf_counter() - t0
    launched = counts()

    opt, obj_err, problems = _contract_problems(
        sols, gb.obj_star.tolist(), MIN_OPTIMAL_SHARE * batch)
    res = dict(
        batch=batch, m=m, n=N_COLS, chol_backend=opts.chol_backend,
        cg_operator=opts.cg_operator, linsys=opts.linsys,
        refactor_period=opts.refactor_period,
        seconds=round(secs, 3), status=_status_counts(sols),
        median_iterations=statistics.median(s.iterations for s in sols),
        max_iterations=max(s.iterations for s in sols),
        optimal_max_rel_gap=max((s.rel_gap for s, _ in opt), default=None),
        optimal_max_rp_rel=max((s.rp_rel for s, _ in opt), default=None),
        optimal_max_rd_rel=max((s.rd_rel for s, _ in opt), default=None),
        optimal_max_obj_rel_err=max(obj_err, default=None),
        median_rel_gap=statistics.median(s.rel_gap for s in sols),
        launches=launched, library_calls=lib.calls)
    if any(launched[k] == 0 for k in PATH_KERNELS[path]):
        problems.append(f"a kernel of the path was never launched: {launched}")
    if opts.chol_backend not in ("xla", "hybrid") \
            and any(lib.calls[k] for k in FACTOR_CALLS):
        problems.append(f"library factor or triangular solve called on the "
                        f"kernel path: {lib.calls}")
    if opts.linsys == "augmented" and not lib.calls["lu_factor_ex"]:
        problems.append("the LU route made no lu_factor_ex call")
    emit(phase, ok=not problems, **res)
    if problems:
        fail(phase, "; ".join(problems))
    return gb, sols, launched


def rescue_options():
    """``throughput()`` with the rescue ladder (``augmented_fallback=True``,
    the default): stage 1 is the main path."""
    return ipx_torch.SolverOptions.throughput(a_storage="bfloat16",
                                              max_iter=64)


def _schur_factor_check(start, checks) -> float:
    """The Schur rung's reduced factor at its first Mehrotra iterate (the
    warm start, boost 1) against the plain version and the f64 Cholesky of
    the f64 scaled matrix, with the panel factor's limits.  Against the
    plain version the limit is widened by the plain version's own distance
    from the f64 factor: with d2p spread over many decades (up to its cap
    1 / aug_reg) the plain version's one float32 chain an entry is 1.0e-2
    from it where the kernel is 6.7e-5 (H100, B=8 of the stalled lanes),
    so the two differ by what the plain version gets wrong."""
    A, x, s, opts = start
    fac = augmented.factor_schur(A, x / s, opts)
    ne = fac.ne
    if not ne.LTp:
        fail("solve_batch/rescue", "the reduced factor did not take the "
             "panel route")
    reg = torch.full((A.shape[0],), opts.reg, device=DEV)
    plain = pk.factor_fused_panels_plain(A, fac.d2p, ne.j, reg)
    Ms64 = _scaled_f64(A, fac.d2p, ne.j, reg)
    checks["d2p_max"] = _mx(fac.d2p)
    checks["d2p_min"] = float(fac.d2p.min())
    return _check_lt("solve_batch/rescue_reduced_factor",
                     "schur_first_iterate", _lt_of(ne.LTp), ne.W,
                     _lt_of(plain[0]), Ms64, checks, plain_own_error=True)


def phase_rescue(gb, main_sols):
    """``solve_batch`` with the rescue ladder on the main path's instances.
    Its stage 1 is the main path's computation, so no lane OPTIMAL there
    may be lost; the stalled lanes go through the in-batch Schur rung
    (rows 1, 5, 5b and 6 on the reduced system) and the per-LP rungs, and
    at least one must come back OPTIMAL.  Per rung: lanes in, lanes fixed,
    seconds and launches, recorded around ``ipx_torch.api._run_batch``."""
    phase = "solve_batch/rescue"
    opts = rescue_options()
    torch.cuda.synchronize()
    reset_counts()
    with LibraryFactorCalls() as lib, RungRecorder() as rec:
        t0 = time.perf_counter()
        sols = ipx_torch.solve_batch(gb.lp, options=opts, device=DEV)
        secs = time.perf_counter() - t0
    launched = counts()
    batch = len(sols)
    main_opt = [i for i, s in enumerate(main_sols) if s.optimal]
    lost = [i for i in main_opt if not sols[i].optimal]
    opt, obj_err, problems = _contract_problems(
        sols, gb.obj_star.tolist(), len(main_opt))
    rungs = rec.rungs(in_batch=True)
    schur = [r for r in rungs if r["rung"] == "in_batch_schur"]
    stalled = batch - len(main_opt)
    if lost:
        problems.append(f"lanes OPTIMAL without the rescue are not now: "
                        f"{lost[:8]}")
    if any(launched[k] == 0 for k in PATH_KERNELS["rescue"]):
        problems.append(f"a kernel of the path was never launched: "
                        f"{launched}")
    if schur and any(not schur[0]["launches"].get(k) for k in _SCHUR):
        problems.append(f"the Schur rung launched not every kernel of its "
                        f"reduced system: {schur[0]['launches']}")
    if any(lib.calls[k] for k in FACTOR_CALLS):
        problems.append(f"library factor or triangular solve called: "
                        f"{lib.calls}")
    if stalled and len(opt) <= len(main_opt):
        problems.append("the rescue fixed none of the stalled lanes")
    its = [s.iterations for s in sols]
    res = dict(batch=batch, m=M_ROWS, n=N_COLS, seconds=round(secs, 3),
               status=_status_counts(sols),
               optimal_without_rescue=len(main_opt),
               median_iterations=statistics.median(its),
               max_iterations=max(its),
               optimal_max_rel_gap=max((s.rel_gap for s, _ in opt),
                                       default=None),
               optimal_max_obj_rel_err=max(obj_err, default=None),
               rungs=[{"rung": r["rung"], "lanes_in": r["lanes"],
                       "optimal_out": r["optimal"], "seconds": r["seconds"],
                       "max_iterations": r["max_iterations"],
                       "launches": r["launches"]} for r in rungs],
               launches=launched, library_calls=lib.calls)
    emit(phase, ok=not problems, **res)
    if problems:
        fail(phase, "; ".join(problems))
    if rec.schur_start is not None:
        checks = {}
        _schur_factor_check(rec.schur_start, checks)
        emit("solve_batch/rescue_reduced_factor", ok=True, batch_check=len(
            rec.schur_start[0]), checks=checks)
    return launched


def phase_ladder(gb, main_sols):
    """``ipx_torch.solve`` alone on lanes the main path left STALLED, in
    order, until one drives the single-LP ladder (a lane alone may end
    otherwise than in its batch); the LU rungs run at full width
    (K of order m + n)."""
    phase = "solve/ladder"
    opts = rescue_options()
    stalled = [i for i, s in enumerate(main_sols)
               if s.status_name == "STALLED"][:N_LADDER_TRIES]
    tried, launched = [], None
    for i in stalled:
        lp = ipx_torch.LP(c=gb.lp.c[i], A=gb.lp.A[i], b=gb.lp.b[i],
                          obj_offset=gb.lp.obj_offset[i])
        torch.cuda.synchronize()
        reset_counts()
        with LibraryFactorCalls() as lib, RungRecorder() as rec:
            t0 = time.perf_counter()
            sol = ipx_torch.solve(lp, options=opts, presolve=False,
                                  device=DEV)
            secs = time.perf_counter() - t0
        launched = counts()
        rungs = rec.rungs(in_batch=False)
        o = float(gb.obj_star[i])
        row = dict(lane=i, status=sol.status_name, iterations=sol.iterations,
                   rel_gap=sol.rel_gap,
                   obj_rel_err=abs(sol.objective - o) / (1 + abs(o)),
                   seconds=round(secs, 3),
                   fixed_by=next((r["rung"] for r in rungs
                                  if r["optimal"]), None),
                   rungs=[{k: r[k] for k in ("rung", "optimal", "seconds",
                                             "max_iterations")}
                          for r in rungs],
                   library_calls=dict(lib.calls))
        tried.append(row)
        if len(rungs) > 1:
            break
    problems = []
    for row in tried:
        if row["status"] == "OPTIMAL" and (row["obj_rel_err"] > 1e-5
                                           or row["rel_gap"] > 1e-6):
            problems.append(f"lane {row['lane']}: OPTIMAL but off the "
                            "contract")
    driven = tried and len(tried[-1]["rungs"]) > 1
    if not driven:
        problems.append(f"none of the STALLED lanes {stalled} drove the "
                        "ladder alone")
    elif any(launched[k] == 0 for k in PATH_KERNELS["ladder"]):
        problems.append(f"a kernel of the path was never launched: "
                        f"{launched}")
    if driven and not tried[-1]["library_calls"]["lu_factor_ex"]:
        problems.append("the ladder ran no LU rung")
    emit(phase, ok=not problems, lanes=tried)
    if problems:
        fail(phase, "; ".join(problems))
    return launched


def phase_oracle_f64(gb) -> None:
    k = 4
    g64 = lp_from_optimum(gb.lp.A[:k], gb.x_star[:k], gb.y_star[:k],
                          gb.s_star[:k], dtype=torch.float64)
    opts = ipx_torch.SolverOptions(dtype="float64", tol=1e-9, tol_feas=1e-9,
                                   augmented_fallback=False)
    lp64 = g64.lp.astype(torch.float64)        # f64 copy of the bf16 values
    sols = ipx_torch.solve_batch(lp64, options=opts, device=DEV)
    err = [abs(s.objective - o) / (1 + abs(o))
           for s, o in zip(sols, g64.obj_star.tolist())]
    ok = all(s.optimal for s in sols) and max(err) <= 1e-8
    emit("oracle_f64", ok=ok, status=[s.status_name for s in sols],
         iterations=[s.iterations for s in sols], max_obj_rel_err=max(err))
    if not ok:
        fail("oracle_f64", "f64 solve on the card missed the optimum")


def phase_single(gb, batch_sols) -> None:
    """``ipx_torch.solve`` on lanes of the batch, each alone: the first
    N_ALONE_OPTIMAL lanes the batch ended OPTIMAL (the soonest-finished one
    among them) on the kernel route, and the first N_ALONE_STALLED lanes it
    did not, on both factor routes.  Held against what the batch made of the
    same lanes and, for the stalled ones, against the library route alone."""
    easy = min((i for i, s in enumerate(batch_sols) if s.optimal),
               key=lambda i: (batch_sols[i].iterations, i))
    optimal = list(dict.fromkeys(
        [easy] + [i for i, s in enumerate(batch_sols) if s.optimal]
    ))[:N_ALONE_OPTIMAL]
    stalled = [i for i, s in enumerate(batch_sols)
               if not s.optimal][:N_ALONE_STALLED]
    routes = {"pallas_left": slice_options(),
              "xla": slice_options(chol_backend="xla")}

    def alone(i, opts):
        return ipx_torch.solve(gb.lp.c[i].cpu().numpy(),
                               gb.lp.A[i].float().cpu().numpy(),
                               gb.lp.b[i].cpu().numpy(), options=opts,
                               presolve=False, device=DEV)

    out, problems = [], []
    for i in optimal + stalled:
        ref = batch_sols[i]
        sol = alone(i, routes["pallas_left"])
        o = float(gb.obj_star[i])
        err = abs(sol.objective - o) / (1 + abs(o))
        row = dict(lane=i, status=sol.status_name, iterations=sol.iterations,
                   rel_gap=sol.rel_gap, obj_rel_err=err,
                   batch_status=ref.status_name,
                   batch_iterations=ref.iterations, batch_rel_gap=ref.rel_gap)
        out.append(row)
        if sol.x.shape != (N_COLS,) or not all(
                np.isfinite(a).all() for a in (sol.x, sol.y, sol.s)):
            problems.append(f"lane {i}: non-finite or misshapen")
        if sol.status_name not in ("OPTIMAL", "STALLED", "MAX_ITER"):
            problems.append(f"lane {i}: status {sol.status_name}")
        if sol.optimal and (err > 1e-5 or sol.rel_gap > 1e-6):
            problems.append(f"lane {i}: OPTIMAL but off by {err:.3e}")
        k = min(EARLY_ITERS, sol.iterations, ref.iterations)
        early = np.abs(sol.trace[:k, 3] / ref.trace[:k, 3] - 1.0).max()
        row["early_gap_rel_diff"] = float(early)
        if k < min(EARLY_ITERS, ref.iterations) or not early <= EARLY_TOL:
            problems.append(f"lane {i}: leaves the batch's path within "
                            f"{EARLY_ITERS} iterations ({early:.3e})")
        if ref.optimal and not sol.optimal and sol.rel_gap > NEAR_MISS_GAP:
            problems.append(f"lane {i}: {sol.status_name} alone at "
                            f"{sol.rel_gap:.3e}, OPTIMAL in the batch")
        if not ref.optimal:
            lib = alone(i, routes["xla"])
            row.update(library_status=lib.status_name,
                       library_rel_gap=lib.rel_gap)

    hard = [r for r in out if "library_rel_gap" in r]
    geomean = lambda xs: float(np.exp(np.mean(np.log(xs)))) if xs else None
    over_library = geomean([r["rel_gap"] / r["library_rel_gap"] for r in hard])
    over_batch = geomean([r["rel_gap"] / r["batch_rel_gap"] for r in hard])
    n_opt = sum(r["status"] == "OPTIMAL" for r in hard)
    n_opt_lib = sum(r["library_status"] == "OPTIMAL" for r in hard)
    for name, g in (("the library route alone", over_library),
                    ("the batch", over_batch)):
        if g is not None and not g <= ALONE_GEOMEAN_FACTOR:
            problems.append(f"stalled lanes alone end {g:.3g}x (geometric "
                            f"mean) wider than on {name}")
    if n_opt < n_opt_lib - 1:
        problems.append(f"{n_opt} stalled lanes OPTIMAL alone on the kernel "
                        f"route, {n_opt_lib} on the library route")
    emit("single", ok=not problems, near_miss_gap=NEAR_MISS_GAP,
         early_iters=EARLY_ITERS, early_tol=EARLY_TOL,
         geomean_factor=ALONE_GEOMEAN_FACTOR,
         stalled_geomean_gap_over_library_alone=over_library,
         stalled_geomean_gap_over_batch=over_batch,
         stalled_optimal_alone=n_opt, stalled_optimal_alone_library=n_opt_lib,
         lanes=out)
    if problems:
        fail("single", "; ".join(problems))


def phase_rate(gb, card: str) -> None:
    """Steady-state time of one batched iteration on three factor routes, in
    one process on one card: the panel-major kernel route (``pallas_left``),
    the library route (``xla``), then the right-looking kernel factor with
    the full-L^T pair-solve (``pallas``), each from two trip counts."""
    k1, k2 = 2, 6
    out = {}
    for name, opts in (("pallas_left", slice_options()),
                       ("xla", slice_options(chol_backend="xla")),
                       ("pallas", slice_options(chol_backend="pallas"))):
        lp = gb.lp.with_a_storage(opts)
        st0, fac = batched.batch_starting_state(lp, opts)

        def run(k: int) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = batched.run_batch_fixed_iters(lp, st0, k, opts, fac)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if not bool(torch.isfinite(res.mu).all()):
                fail("rate", f"{name}: non-finite mu in the fixed-iteration run")
            return dt

        run(k1)
        t1 = min(run(k1) for _ in range(2))
        t2 = min(run(k2) for _ in range(2))
        t_iter = max((t2 - t1) / (k2 - k1), 1e-9)
        B = lp.A.shape[0]
        out[name] = dict(seconds_k1=t1, seconds_k2=t2,
                         ms_per_batched_iteration=t_iter * 1e3,
                         batched_iterations_per_s=1.0 / t_iter,
                         instance_iterations_per_s=B / t_iter)
        del st0, fac
        torch.cuda.empty_cache()
    emit("rate", ok=True, batch=gb.lp.A.shape[0], m=M_ROWS, n=N_COLS, k1=k1,
         k2=k2, card=card, **out["pallas_left"], library_route=out["xla"],
         pallas=out["pallas"])


# --------------------------------------------------------------------------
# the problem layer and front ends
# --------------------------------------------------------------------------
ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"     # snapshots of the resume phase
# the full-width general LP: 1536 x 2432 in standard form (each bounded
# variable adds a row; presolve keeps every row)
GENERAL_LP = dict(seed=0, n=1024, m_eq=128, m_ub=384, n_free=8,
                  scale_spread=1.0)
GENERAL_TOL = 5e-7      # the solve's gap, as tests/test_netlib_suite.py
TOL_GENERAL_OBJ = 1e-6  # objective against HiGHS, relative
TOL_GENERAL_FEAS = 1e-5  # rows and bounds in original units, as the suite
TOL_CONSTRUCTED = 1e-5  # objective against a constructed optimum (contract)
FIXTURES = ("classic01_max.mps", "classic02.mps", "syn01.mps", "syn02.mps",
            "syn03_max.mps")
# the hand-derived optima of tests/test_mps_fixtures.py (f32 limits there:
# objective 1e-6 relative, x within 1e-4)
CLASSIC_OPTIMA = {"classic01_max.mps": (21.0, [3.0, 3.0, 2.0, -1.0, 6.0, 1.0]),
                  "classic02.mps": (5.0, [-1.0, 3.0, 0.0])}
N_MANY = 48             # LPs of solve_many, m drawn from M_MANY, n = 2m
M_MANY = (320, 1024)
SNAPSHOT_EVERY = 4
# a resumed solve: objective and extra iterations against one
# uninterrupted solve (the limits of tests/test_obs_cli.py)
TOL_RESUME_OBJ = 1e-6
RESUME_EXTRA_ITERS = 4
CLI_TIMEOUT = 300


def _rel(got: float, ref: float) -> float:
    return abs(got - ref) / (1 + abs(ref))


class Stages:
    """While active, wraps the front ends' stages in ``ipx_torch.api`` and
    sums the seconds of each: ``to_standard_form``, ``_presolve`` and
    ``bucket_lps`` (host), ``_run_batch`` (every device loop, stage 1 and
    the ladder's rungs, synchronised), ``_primal_polish`` (host).  What is
    left of the whole call is postsolve, the host's f64 re-check of the
    reported point and the moves to and from the card.  ``expect`` names
    the stages the phase's calls must go through: a name missing from
    ``ipx_torch.api`` raises on entry and an expected stage never called
    raises on exit, so a renamed stage cannot report zero seconds."""
    NAMES = ("to_standard_form", "_presolve", "bucket_lps", "_run_batch",
             "_primal_polish")
    # the polish runs only on an OPTIMAL exit, which the phases check
    FRONT = ("to_standard_form", "_presolve", "_run_batch")

    def __init__(self, *expect: str):
        unknown = set(expect) - set(self.NAMES)
        if unknown:
            raise ValueError(f"unknown stages {sorted(unknown)}")
        self.expect = expect

    def __enter__(self):
        self.seconds = dict.fromkeys(self.NAMES, 0.0)
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.buckets = None
        self.bucket_lanes = []      # input indices in the order solved
        self.stage1 = []            # each stage 1's statuses (dense, cold)
        self._orig = {n: getattr(ipx_torch.api, n) for n in self.NAMES}

        def timed_call(name, fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
                if name == "bucket_lps":
                    self.buckets = {f"{m}x{n}": len(v)
                                    for (m, n), v in sorted(out.items())}
                    self.bucket_lanes = [i for _, v in sorted(out.items())
                                         for i, _ in v]
                if name == "_run_batch":
                    run = inspect.signature(fn).bind(*a, **kw).arguments
                    if run["opts"].linsys == "dense" \
                            and run.get("state0") is None:
                        self.stage1 += out.status.tolist()
                return out
            return call

        for name, fn in self._orig.items():
            setattr(ipx_torch.api, name, timed_call(name, fn))
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.total = time.perf_counter() - self._t0
        for name, fn in self._orig.items():
            setattr(ipx_torch.api, name, fn)
        never = [n for n in self.expect if self.calls[n] == 0]
        if never and exc[0] is None:
            raise RuntimeError(f"stages never called: {never}; was a "
                               f"function of ipx_torch.api renamed?")

    def split(self) -> dict:
        s = self.seconds
        front = s["to_standard_form"] + s["_presolve"] + s["bucket_lps"]
        return dict(
            seconds=round(self.total, 3),
            standard_form_s=round(s["to_standard_form"], 3),
            presolve_s=round(s["_presolve"], 3),
            padding_s=round(s["bucket_lps"], 3),
            device_solve_s=round(s["_run_batch"], 3),
            device_runs=self.calls["_run_batch"],
            postsolve_polish_s=round(self.total - front - s["_run_batch"], 3),
            polish_s=round(s["_primal_polish"], 3))


def _launch_problems(path: str, launched: dict) -> list:
    if any(launched[k] == 0 for k in PATH_KERNELS[path]):
        return [f"a kernel of the path {path} was never launched: "
                f"{launched}"]
    return []


def _finite(sol, n: int) -> list:
    if sol.x.shape != (n,) or not all(np.isfinite(a).all()
                                      for a in (sol.x, sol.y, sol.s)):
        return ["non-finite or misshapen solution"]
    return []


def phase_presolve(gen) -> dict:
    """``ipx_torch.solve(c, A, b)`` with its default ``presolve=True`` on
    one LP at the main path's width, under the default options (the
    library route) and under ``throughput()``: OPTIMAL, within 1e-5 of the
    constructed optimum, with host seconds for presolve, the device loop
    and postsolve with the polish."""
    phase = "solve/presolve"
    out = {}
    for path, opts in (("presolve", ipx_torch.SolverOptions()),
                       ("presolve_throughput",
                        ipx_torch.SolverOptions.throughput())):
        torch.cuda.synchronize()
        reset_counts()
        with Stages(*Stages.FRONT[1:]) as st:
            sol = ipx_torch.solve(gen.c, gen.A, gen.b, options=opts,
                                  device=DEV)
        out[path] = launched = counts()
        err = _rel(sol.objective, gen.obj_star)
        problems = _finite(sol, N_COLS) + _launch_problems(path, launched)
        if not sol.optimal:
            problems.append(f"ended {sol.status_name}")
        elif err > TOL_CONSTRUCTED:
            problems.append(f"objective off the constructed optimum by "
                            f"{err:.3e}")
        emit(phase, ok=not problems, options=path, m=M_ROWS, n=N_COLS,
             chol_backend=opts.chol_backend, status=sol.status_name,
             iterations=sol.iterations, obj_rel_err=err,
             rel_gap=sol.rel_gap, rp_rel=sol.rp_rel, rd_rel=sol.rd_rel,
             **st.split(), launches=launched)
        if problems:
            fail(phase, "; ".join(problems))
    return out


def _highs(glp) -> float:
    """HiGHS's optimum of a GeneralLP, in the problem's own sense."""
    ref = linprog(glp.c, A_ub=glp.A_ub, b_ub=glp.b_ub, A_eq=glp.A_eq,
                  b_eq=glp.b_eq, bounds=list(zip(glp.lb, glp.ub)),
                  method="highs")
    if ref.status != 0:
        raise RuntimeError(f"HiGHS ended with status {ref.status}")
    obj = ref.fun + glp.obj_offset
    return -obj if getattr(glp, "maximize", False) else obj


def _general_problems(glp, sol, ref_obj: float) -> tuple:
    """``tests/test_netlib_suite.py``'s limits: OPTIMAL, the objective
    against HiGHS, rows and bounds in original units."""
    err = _rel(sol.objective, ref_obj)
    scale = 1 + max(np.abs(glp.b_ub).max(initial=0.0),
                    np.abs(glp.b_eq).max(initial=0.0))
    feas = max((glp.A_ub @ sol.x - glp.b_ub).max(initial=0.0),
               np.abs(glp.A_eq @ sol.x - glp.b_eq).max(initial=0.0)) / scale
    bounds = max((glp.lb - sol.x).max(initial=0.0),
                 (sol.x - glp.ub).max(initial=0.0))
    problems = _finite(sol, glp.n)
    if not sol.optimal:
        problems.append(f"ended {sol.status_name}")
    elif err > TOL_GENERAL_OBJ:
        problems.append(f"objective off HiGHS by {err:.3e}")
    if sol.optimal and not (feas <= TOL_GENERAL_FEAS
                            and bounds <= TOL_GENERAL_FEAS):
        problems.append(f"infeasible in original units: rows {feas:.3e}, "
                        f"bounds {bounds:.3e}")
    return dict(obj_rel_err=err, row_violation_rel=feas,
                bound_violation=bounds), problems


def _bf16_values(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).double().numpy()


def phase_general() -> dict:
    """``ipx_torch.solve_general`` on the full-width general LP (standard
    form, presolve with Ruiz scaling, the device solve, postsolve with the
    polish) under the default options and ``throughput()``, each against
    HiGHS; then the same LP with A_eq and A_ub rounded to bf16 values under
    ``throughput(a_storage="bfloat16")`` (power-of-two scales keep the
    scaled A exact in bf16), against HiGHS on the rounded data."""
    glp = random_general_lp(**GENERAL_LP)
    rounded = GeneralLP(
        c=glp.c, A_ub=_bf16_values(glp.A_ub), b_ub=glp.b_ub,
        A_eq=_bf16_values(glp.A_eq), b_eq=glp.b_eq, lb=glp.lb, ub=glp.ub,
        name=glp.name + "_bf16")
    m_std, n_std = ipx_torch.to_standard_form(glp)[1].shape
    out = {}
    runs = (("solve_general", "general", glp, ipx_torch.SolverOptions(
                tol=GENERAL_TOL)),
            ("solve_general", "general_throughput", glp,
             ipx_torch.SolverOptions.throughput(tol=GENERAL_TOL)),
            ("solve_general/bf16", "general_bf16", rounded,
             ipx_torch.SolverOptions.throughput(tol=GENERAL_TOL,
                                                a_storage="bfloat16")))
    refs = {}
    for phase, path, lp, opts in runs:
        if lp.name not in refs:
            t0 = time.perf_counter()
            refs[lp.name] = (_highs(lp), time.perf_counter() - t0)
        ref_obj, highs_s = refs[lp.name]
        torch.cuda.synchronize()
        reset_counts()
        with Stages(*Stages.FRONT) as st:
            sol = ipx_torch.solve_general(lp, opts, device=DEV)
        out[path] = launched = counts()
        res, problems = _general_problems(lp, sol, ref_obj)
        problems += _launch_problems(path, launched)
        emit(phase, ok=not problems, options=path, m_std=m_std, n_std=n_std,
             a_storage=opts.a_storage, chol_backend=opts.chol_backend,
             status=sol.status_name, iterations=sol.iterations,
             objective=sol.objective, highs_objective=ref_obj,
             highs_s=round(highs_s, 3), rel_gap=sol.rel_gap,
             rp_rel=sol.rp_rel, rd_rel=sol.rd_rel, **res, **st.split(),
             launches=launched)
        if problems:
            fail(phase, "; ".join(problems))
    return out


def _same_lp(a, b) -> bool:
    return (all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("c", "A_ub", "b_ub", "A_eq", "b_eq", "lb", "ub"))
            and a.obj_offset == b.obj_offset and a.name == b.name
            and getattr(a, "maximize", False) == getattr(b, "maximize",
                                                         False))


def phase_mps() -> dict:
    """``ipx_torch.solve_mps`` on the five committed fixtures under the
    default options: the native tokenizer built and loaded, both parsers
    giving the same LP, each solve OPTIMAL within 1e-6 of HiGHS, and the
    two classic files at their hand-derived optima."""
    phase = "solve_mps"
    problems = []
    if native.load_mps_lib() is None:
        fail(phase, "the native MPS tokenizer did not build or load")
    # parsing, the parsers' comparison and HiGHS stay outside the timed
    # window: it holds the solves alone
    parsed, refs = {}, {}
    for name in FIXTURES:
        path = str(ROOT / "tests" / "fixtures" / name)
        parsed[name] = py = read_mps(path, use_native=False)
        if not _same_lp(py, read_mps(path, use_native=True)):
            problems.append(f"{name}: the parsers disagree")
        refs[name] = _highs(py)
    sols = {}
    torch.cuda.synchronize()
    reset_counts()
    with Stages(*Stages.FRONT) as st:
        for name in FIXTURES:
            sols[name] = ipx_torch.solve_mps(
                str(ROOT / "tests" / "fixtures" / name), device=DEV)
    rows = []
    for name in FIXTURES:
        py, sol = parsed[name], sols[name]
        row = dict(file=name, m_ub=py.A_ub.shape[0], m_eq=py.A_eq.shape[0],
                   n=py.n, status=sol.status_name, iterations=sol.iterations,
                   objective=sol.objective,
                   obj_rel_err_highs=_rel(sol.objective, refs[name]))
        if not sol.optimal or row["obj_rel_err_highs"] > TOL_GENERAL_OBJ:
            problems.append(f"{name}: {sol.status_name}, objective off "
                            f"HiGHS by {row['obj_rel_err_highs']:.3e}")
        if name in CLASSIC_OPTIMA:
            obj, xstar = CLASSIC_OPTIMA[name]
            row["obj_rel_err_pinned"] = _rel(sol.objective, obj)
            row["x_err_pinned"] = float(np.abs(sol.x - xstar).max())
            if row["obj_rel_err_pinned"] > TOL_GENERAL_OBJ \
                    or row["x_err_pinned"] > 1e-4:
                problems.append(f"{name}: off its pinned optimum")
        rows.append(row)
    launched = counts()
    problems += _launch_problems("mps", launched)
    emit(phase, ok=not problems, native_library=str(native.library_path()),
         parsers_identical=not any("parsers" in p for p in problems),
         files=rows, **st.split(), launches=launched)
    if problems:
        fail(phase, "; ".join(problems))
    return launched


def _over_limit(sol, g, opts, rescued: bool) -> dict:
    """An OPTIMAL lane off its constructed optimum by more than
    TOL_CONSTRUCTED.  Its error splits exactly as c@x - c@x* =
    y*@(A x - b) + s*@x (c = A^T y* + s*, b = A x*): the part of its primal
    residual and its optimality part.  A lane that stage 1 ended OPTIMAL is
    never right past the limit: the dense route projects onto Ax = b.  A
    lane the rescue ladder ended OPTIMAL is right when its OPTIMAL
    certificate holds in float64 (gap within tol, both residuals within
    the solver's feasibility tolerance) and its optimality part is within
    TOL_CONSTRUCTED: the ladder's routes have no projection, and ``ipx``'s
    in-batch Schur rung ends such lanes with the same residual and the
    same error (``probes/schur_rung_cpu.py``, ROADMAP.md section 3)."""
    scale = 1 + abs(g.obj_star)
    tol_feas = max(opts.tol_feas, opts.feas_eps_mult
                   * torch.finfo(dtype_of(opts.dtype)).eps)
    row = dict(m=g.A.shape[0], rescued=rescued,
               obj_rel_err=_rel(sol.objective, g.obj_star),
               infeasibility_part=float(g.y_star @ (g.A @ sol.x - g.b))
               / scale,
               optimality_part=float(g.s_star @ sol.x) / scale,
               iterations=sol.iterations, rel_gap=sol.rel_gap,
               rp_rel=sol.rp_rel, rd_rel=sol.rd_rel, tol_feas=tol_feas)
    row["right"] = bool(rescued
                        and abs(row["optimality_part"]) <= TOL_CONSTRUCTED
                        and sol.rel_gap <= opts.tol
                        and max(sol.rp_rel, sol.rd_rel) <= tol_feas)
    return row


def phase_many() -> dict:
    """``ipx_torch.solve_many`` on N_MANY LPs of mixed sizes (m drawn from
    M_MANY with a seeded generator, n = 2m) under ``throughput()``: the
    buckets, padded on the host, land on and off the 128 grid.  At least
    half OPTIMAL; every lane that stage 1 ends OPTIMAL within 1e-5 of its
    constructed optimum; every lane the rescue ladder ends OPTIMAL within
    1e-5 or, past it, right by its certificate (``_over_limit``); every
    lane past 1e-5 is printed."""
    phase = "solve_many"
    opts = ipx_torch.SolverOptions.throughput()
    ms = np.random.default_rng(0).integers(M_MANY[0], M_MANY[1] + 1, N_MANY)
    gens = [random_feasible_lp(int(m), 2 * int(m), seed=i)
            for i, m in enumerate(ms)]
    torch.cuda.synchronize()
    reset_counts()
    with Stages("bucket_lps", "_run_batch") as st:
        sols = ipx_torch.solve_many([(g.c, g.A, g.b) for g in gens],
                                    options=opts, device=DEV)
    launched = counts()
    problems = _launch_problems("many", launched)
    stage1 = dict(zip(st.bucket_lanes, st.stage1))
    if sorted(stage1) != list(range(N_MANY)) \
            or len(st.stage1) != N_MANY:
        problems.append(f"stage 1 not read once for every lane: "
                        f"{len(st.stage1)} statuses")
    rescued = {i for i, code in stage1.items()
               if code != int(ipx_torch.Status.OPTIMAL)}
    errs = [_rel(s.objective, g.obj_star)
            for s, g in zip(sols, gens) if s.optimal]
    over = {i: _over_limit(s, g, opts, i in rescued)
            for i, (s, g) in enumerate(zip(sols, gens)) if s.optimal
            and _rel(s.objective, g.obj_star) > TOL_CONSTRUCTED}
    for s, g in zip(sols, gens):
        problems += _finite(s, g.A.shape[1])[:1]
    if len(errs) < N_MANY / 2:
        problems.append(f"only {len(errs)} of {N_MANY} OPTIMAL")
    wrong = {i: row for i, row in over.items() if not row["right"]}
    if wrong:
        problems.append(f"OPTIMAL lanes off their optimum: {wrong}")
    emit(phase, ok=not problems, lps=N_MANY, m_range=list(M_MANY),
         buckets=st.buckets, status=_status_counts(sols),
         optimal_stage1=N_MANY - len(rescued),
         rescued_optimal=sum(sols[i].optimal for i in rescued),
         median_iterations=statistics.median(s.iterations for s in sols),
         optimal_max_obj_rel_err=max(errs, default=None),
         stage1_max_obj_rel_err=max(
             (_rel(s.objective, g.obj_star) for i, (s, g)
              in enumerate(zip(sols, gens)) if i not in rescued),
             default=None),
         over_limit=over, **st.split(), launches=launched)
    if problems:
        fail(phase, "; ".join(problems))
    return launched


def phase_resume(gen) -> dict:
    """``obs.solve_with_snapshots`` on the ``solve/presolve`` LP without
    presolve, a snapshot every SNAPSHOT_EVERY iterations written to disk
    and resumed from it, against one uninterrupted ``solve``."""
    phase = "resume"
    WORK.mkdir(parents=True, exist_ok=True)
    path = WORK / "resume.npz"
    path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    full = ipx_torch.solve(gen.c, gen.A, gen.b, presolve=False, device=DEV)
    full_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_counts()
    with Stages("_run_batch") as st:
        sol = obs.solve_with_snapshots(gen.c, gen.A, gen.b,
                                       every=SNAPSHOT_EVERY, path=str(path),
                                       device=DEV)
    launched = counts()
    with np.load(path) as z:
        snap_it = int(z["it"])
    path.unlink()
    err = _rel(sol.objective, full.objective)
    problems = _launch_problems("resume", launched)
    if not (sol.optimal and full.optimal):
        problems.append(f"ended {sol.status_name} (uninterrupted "
                        f"{full.status_name})")
    if err > TOL_RESUME_OBJ:
        problems.append(f"objective off the uninterrupted solve by {err:.3e}")
    if not SNAPSHOT_EVERY < sol.iterations <= full.iterations \
            + RESUME_EXTRA_ITERS or snap_it != sol.iterations:
        problems.append(f"{sol.iterations} iterations resumed, "
                        f"{full.iterations} uninterrupted, snapshot at "
                        f"{snap_it}")
    emit(phase, ok=not problems, m=M_ROWS, n=N_COLS, every=SNAPSHOT_EVERY,
         status=sol.status_name, iterations=sol.iterations,
         uninterrupted_iterations=full.iterations,
         uninterrupted_s=round(full_s, 3), obj_rel_err=err,
         obj_rel_err_constructed=_rel(sol.objective, gen.obj_star),
         **st.split(), launches=launched)
    if problems:
        fail(phase, "; ".join(problems))
    return launched


def phase_cli() -> None:
    """``python -m ipx_torch`` as a user runs it, in child processes on the
    card with the CLI's defaults: an MPS fixture and a random LP at the
    main path's width.  Exit 0, OPTIMAL, the objective against HiGHS and
    the constructed optimum.  (The children's kernel launches are theirs,
    not counted here.)"""
    phase = "cli"
    syn02 = ROOT / "tests" / "fixtures" / "syn02.mps"
    runs = ((["solve", str(syn02), "--json", "--quiet"], _highs(
                read_mps(str(syn02), use_native=False))),
            (["random", "--m", str(M_ROWS), "--n", str(N_COLS), "--json",
              "--quiet"], None))
    rows, problems = [], []
    for args, ref_obj in runs:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "ipx_torch", *args],
                           capture_output=True, text=True, cwd=ROOT,
                           timeout=CLI_TIMEOUT)
        secs = time.perf_counter() - t0
        lines = r.stdout.strip().splitlines()
        res = json.loads(lines[-1]) if r.returncode == 0 and lines else {}
        err = (None if not res
               else _rel(res["objective"], ref_obj) if ref_obj is not None
               else float(res["known_optimum_rel_err"]))
        tol = TOL_GENERAL_OBJ if ref_obj is not None else TOL_CONSTRUCTED
        rows.append(dict(args=args[:2], returncode=r.returncode,
                         status=res.get("status"),
                         iterations=res.get("iterations"), obj_rel_err=err,
                         seconds=round(secs, 2)))
        if r.returncode != 0 or res.get("status") != "OPTIMAL" \
                or err is None or err > tol:
            problems.append(f"{args[0]}: exit {r.returncode}, {res}, "
                            f"stderr {r.stderr[-800:]}")
    emit(phase, ok=not problems, runs=rows)
    if problems:
        fail(phase, "; ".join(problems))


class SplitTimer:
    """While active, wraps the pieces of a ``solve_large`` iteration and sums
    each one's seconds, synchronised before and after: the Jacobi diagonal
    (row 2's squared stream), the assembly (row 4), the factor (row 10 with
    the diagonal kernel), the preconditioner's solves (W-substitutions) and
    the products with A (``products.product``: rows 2 and 3, rounded to
    float32 on ``"sharded"``, float64 out on ``"sharded_schur"`` and the
    re-check, whose seconds are ``products_f64``).  What is left of the
    solve's seconds is the elementwise work, the collectives and the host.
    A piece missing from its module raises on entry, and
    :meth:`never_called` names the pieces a run's stages must have called
    and did not, so a renamed piece cannot report zero seconds.
    ``library_products`` counts the library products with A the route
    falls back to off the card (``products.mv``, ``products.mv64``): none
    on the card."""

    PIECES = {"jacobi": (schur, "_diag_scan"),
              "assembly": (pk, "assemble_sym_batched"),
              "factor": (pk, "factor_lt_batched"),
              "solves": (schur, "_precond"),
              "products": (products, "product")}
    LIBRARY = ((products, "mv"), (products, "mv64"))
    # the pieces each stage's route calls
    ROUTE = {"sharded": ("jacobi", "assembly", "factor", "solves",
                         "products"),
             "sharded_schur": ("jacobi", "assembly", "factor", "solves",
                               "products_f64")}

    def __enter__(self):
        self.seconds = dict.fromkeys([*self.PIECES, "products_f64"], 0.0)
        self.calls = dict.fromkeys(self.seconds, 0)
        self.library_products = 0
        self._lib = {}
        for mod, name in self.LIBRARY:
            fn = getattr(mod, name)
            self._lib[name] = fn

            def counted(*a, _fn=fn, **kw):
                self.library_products += 1
                return _fn(*a, **kw)
            setattr(mod, name, counted)
        self._orig = {}
        for label, (mod, name) in self.PIECES.items():
            fn = getattr(mod, name)     # AttributeError for a renamed piece
            self._orig[label] = fn

            def timed_call(*a, _fn=fn, _label=label, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                if _label == "products" and out.dtype == torch.float64:
                    _label = "products_f64"
                self.seconds[_label] += time.perf_counter() - t0
                self.calls[_label] += 1
                return out
            setattr(mod, name, timed_call)
        return self

    def __exit__(self, *exc):
        for label, (mod, name) in self.PIECES.items():
            setattr(mod, name, self._orig[label])
        for mod, name in self.LIBRARY:
            setattr(mod, name, self._lib[name])

    def never_called(self, routes) -> list:
        want = {k for r in routes for k in self.ROUTE[r]}
        return sorted(k for k in want if self.calls[k] == 0)


class FactorCalls:
    """While active, keeps the arguments of the first and the last
    ``schur.factor`` call (A by reference, d2 and reg_scale copied): what
    the path built its normal matrices from, for :func:`_replay_factor`."""

    def __enter__(self):
        self.calls = {}
        self._orig = schur.factor

        def keep(A, d2, opts, reg_scale=1.0):
            rs = reg_scale.clone() if torch.is_tensor(reg_scale) else reg_scale
            rec = (A, d2.clone(), opts, rs)
            self.calls.setdefault("first", rec)
            self.calls["last"] = rec
            return self._orig(A, d2, opts, reg_scale)
        schur.factor = keep
        return self

    def __exit__(self, *exc):
        schur.factor = self._orig


def _replay_factor(rec, mesh) -> dict:
    """One recorded ``schur.factor`` call made again through the path's own
    code, on the mesh it ran on: row 4's inputs and output (copied before
    the path scales it in place) and row 10's input (the scaled,
    regularized matrix) and output.  The kernels are deterministic, so these
    are the bits the path computed."""
    got = {}
    asm, fac = pk.assemble_sym_batched, pk.factor_lt_batched

    def asm_keep(A, d2):
        M = asm(A, d2)
        got["asm"] = (A, d2, M.clone())
        return M

    def fac_keep(M):
        LT, W = fac(M)
        got["factor"] = (M, LT, W)
        return LT, W

    pk.assemble_sym_batched, pk.factor_lt_batched = asm_keep, fac_keep
    try:
        with schur.use_mesh(mesh or meshlib.make_mesh(batch=1, row=1)):
            schur.factor(*rec)
    finally:
        pk.assemble_sym_batched, pk.factor_lt_batched = asm, fac
    if set(got) != {"asm", "factor"}:
        fail("large", f"the replayed factor did not reach rows 4 and 10: "
             f"{sorted(got)}")
    return got


def _event_ms(fn):
    """(fn(), its device time in ms between two CUDA events): one call."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _hold_assembly(A3, d2, M, timing: bool) -> dict:
    """Row 4's output M (1, m, m) on the path's own inputs against its plain
    version and against float64, every tile of the lower triangle (the f64
    product formed TB rows by TB columns at a time).  Each difference is
    taken over sqrt(D_i D_j), D the f64 diagonal: |sum d2 a_i a_j| is at
    most that, so the reading is the entries' relative summation error and
    the same for every scale of d2.  With ``timing`` the plain version's
    call and one library product are timed."""
    m, n = A3.shape[1:]
    A, d64 = A3[0], d2[0].double()
    tb = min(m, 4096)
    res = {"m": m, "n": n, "a_dtype": str(A.dtype),
           "symmetric_bitwise": bool(torch.equal(M[0], M[0].mT))}
    P, plain_ms = _event_ms(lambda: pk.assemble_sym_batched_plain(A3, d2))
    if timing:
        res["plain_ms"] = plain_ms
        Af = A3.float()
        Wf = Af * d2.unsqueeze(1)
        res["library_ms"] = time_ms(lambda: torch.matmul(Wf, Af.mT), reps=1,
                                    warm=1)
        del Af, Wf
    D = torch.cat([(A[r:r + tb].double() ** 2) @ d64
                   for r in range(0, m, tb)])
    s = torch.rsqrt(D)
    err = dict.fromkeys(("vs_f64", "plain_vs_f64", "vs_plain"), 0.0)
    for r in range(0, m, tb):
        Ar = A[r:r + tb].double() * d64
        for c in range(0, r + tb, tb):
            T = Ar @ A[c:c + tb].double().mT
            sc = s[r:r + tb, None] * s[None, c:c + tb]
            got = M[0, r:r + tb, c:c + tb].double()
            pl = P[0, r:r + tb, c:c + tb].double()
            for k, v in (("vs_f64", _mx((got - T) * sc)),
                         ("plain_vs_f64", _mx((pl - T) * sc)),
                         ("vs_plain", _mx((got - pl) * sc))):
                err[k] = max(err[k], v)
        del Ar
    res.update(err)
    del P
    torch.cuda.empty_cache()
    return res


def _backward(LT, M64, tb: int) -> float:
    """||L L^T - M|| / ||M|| (max norms) in float64, LT (m, m) = L^T."""
    LT64 = LT.double()
    return max(_mx(LT64[:, r:r + tb].mT @ LT64 - M64[r:r + tb])
               for r in range(0, LT.shape[0], tb)) / _mx(M64)


def _hold_factor(M, LT, W, timing: bool) -> dict:
    """Row 10's output (LT, W) on the matrix the path gave it (M (1, m, m),
    scaled and regularized): its backward error ||L L^T - M|| / ||M|| in
    float64 and ||W_k L_kk - I||, which do not grow with M's condition, and
    its distance from the plain version's factor and from the float64
    Cholesky of M, relative to the f64 factor's largest entry, which do.
    Beside them the plain version's backward and forward errors and the
    library float32 Cholesky's forward error.  Where M, rounded to float32,
    is not positive definite in float64 (``f64_not_pd_at``, the failing
    minor), the forward readings are None.  With ``timing`` the plain
    version's call and the library Cholesky are timed."""
    m = M.shape[-1]
    tb = min(m, 4096)
    res = {"m": m, "finite": bool(torch.isfinite(LT).all()
                                  and torch.isfinite(W).all())}
    (LTp, _), plain_ms = _event_ms(lambda: pk.factor_lt_batched_plain(M))
    if timing:
        res["plain_ms"] = plain_ms
        res["library_ms"] = time_ms(
            lambda: torch.linalg.cholesky_ex(M, check_errors=False), reps=1,
            warm=1)
    M64 = M[0].double()
    L64, info = torch.linalg.cholesky_ex(M64)
    res["f64_not_pd_at"] = int(info) or None
    res.update(vs_f64=None, plain_vs_f64=None, library_vs_f64=None,
               vs_plain=None)
    if not int(info):
        top = _mx(L64)

        def fwd(X, lower=False) -> float:
            return max(_mx((X[r:r + tb].mT if lower else X[r:r + tb])
                           .double() - L64[:, r:r + tb].mT)
                       for r in range(0, m, tb)) / top
        res["vs_f64"] = fwd(LT[0])
        res["plain_vs_f64"] = fwd(LTp[0])
        Llib = torch.linalg.cholesky_ex(M[0])[0]
        res["library_vs_f64"] = fwd(Llib.mT.contiguous())
        del Llib
        res["vs_plain"] = max(_mx(LT[0, r:r + tb] - LTp[0, r:r + tb])
                              for r in range(0, m, tb)) / top
    del L64
    res["backward"] = _backward(LT[0], M64, tb)
    res["plain_backward"] = _backward(LTp[0], M64, tb)
    del M64, LTp
    LT64 = LT[0].double()
    Lkk = torch.stack([LT64[o:o + NB, o:o + NB].mT for o in range(0, m, NB)])
    res["w_inverse"] = _mx(torch.matmul(W[0].double(), Lkk)
                           - torch.eye(NB, device=DEV, dtype=torch.float64))
    del LT64, Lkk
    torch.cuda.empty_cache()
    return res


def _hold_path(phase: str, calls: dict, mesh, timing: bool = False) -> tuple:
    """Rows 4 and 10 held on the first and the last normal matrix of a
    ``solve_large`` run (replayed, :func:`_replay_factor`) -> (readings,
    problems).  Launches made here come after the path's counts were read."""
    out, problems = {}, []
    for when, rec in calls.items():
        got = _replay_factor(rec, mesh)
        asm = _hold_assembly(*got.pop("asm"), timing=timing and when == "last")
        fac = _hold_factor(*got.pop("factor"),
                           timing=timing and when == "last")
        del got
        out[when] = {"assemble_sym_batched": asm, "factor_lt_batched": fac}
        problems += _held_problems(phase, when, asm, fac)
    return out, problems


def _held_problems(phase: str, when: str, asm: dict, fac: dict) -> list:
    """What fails of rows 4 and 10 held on a path's ``when`` ("first" or
    "last") normal matrix (:func:`_hold_assembly`, :func:`_hold_factor`)."""
    problems = []
    if not (asm["symmetric_bitwise"] and asm["vs_f64"] <= TOL_LARGE_F64
            and asm["vs_plain"] <= asm["plain_vs_f64"] + TOL_LARGE_F64):
        problems.append(f"{phase}: assemble_sym_batched on the {when} "
                        f"matrix: {asm}")
    # The first matrix is held to the full-matrix factors' limits whole.
    # The last one, once d2 spans many decades, is ill-conditioned: its f32
    # factors' forward errors are its condition times eps (the plain
    # version's and the library's are printed beside the kernel's; at
    # config 4 it is not even positive definite in f64), so it is held to
    # the limits that do not grow with the condition, the backward error
    # and ||W L - I|| (the latter with the ill-conditioned block's limit).
    if when == "first":
        ok = (fac["vs_f64"] is not None
              and fac["vs_f64"] <= TOL_PANELS_F64
              and fac["vs_plain"] <= TOL_LT_PLAIN
              and fac["w_inverse"] <= TOL_DIAG_INVERSE)
    else:
        ok = fac["w_inverse"] <= TOL_DIAG_INVERSE_ILL
    if not (ok and fac["finite"] and fac["backward"] <= TOL_RECONSTRUCT):
        problems.append(f"{phase}: factor_lt_batched on the {when} "
                        f"matrix: {fac}")
    return problems


def _far_corners(A: torch.Tensor) -> dict:
    """Row 4 on the large LP's A (m, n) against float64: the first and the
    last 128-row blocks' diagonal tiles and the tile where they meet (the
    far corner of the lower triangle, past 2^31 entries of M at config 4),
    each from those rows of A alone, relative to each f64 tile's largest
    entry; the mirror tile bit for bit the corner's transpose.  Beside it,
    on the same rows, the forms the summation rule rejects, each read the
    same way: one float32 chain an entry (``rejected_one_chain_f32``), A o
    d2 rounded once to bf16 and summed exactly (``rejected_one_pass_bf16``,
    the least error of a one-pass split), and one library float32 product
    (``library_f32``, printed only)."""
    m, n = A.shape
    g = torch.Generator(device=DEV).manual_seed(8)
    d2 = 0.5 + torch.rand(1, n, generator=g, device=DEV)
    M = pk.assemble_sym_batched(A.unsqueeze(0), d2)[0]
    R = torch.cat([A[:NB], A[-NB:]])
    R64 = R.double()
    T = torch.matmul(R64 * d2[0].double(), R64.mT)

    def tiles(X) -> float:
        X = X.double()
        return max(_mx(X[a] - T[a]) / _mx(T[a]) for a in (
            (slice(0, NB), slice(0, NB)), (slice(NB, None), slice(NB, None)),
            (slice(NB, None), slice(0, NB))))

    out = {k: _mx(got.double() - ref) / _mx(ref) for k, (got, ref) in {
        "first": (M[:NB, :NB], T[:NB, :NB]),
        "last": (M[-NB:, -NB:], T[NB:, NB:]),
        "corner": (M[-NB:, :NB], T[NB:, :NB])}.items()}
    out["mirror_bitwise"] = bool(torch.equal(M[:NB, -NB:], M[-NB:, :NB].mT))
    del M
    Rf = R.float()
    U = (Rf * d2[0]).mT.contiguous()            # (n, 256): column k of R o d2
    V = Rf.mT.contiguous()
    acc = torch.zeros(2 * NB, 2 * NB, device=DEV)
    for k in range(n):
        acc.addr_(U[k], V[k])
    out["rejected_one_chain_f32"] = tiles(acc)
    out["rejected_one_pass_bf16"] = tiles(
        (Rf * d2[0]).bfloat16().double() @ R64.mT)
    out["library_f32"] = tiles((Rf * d2[0]) @ Rf.mT)
    del U, V, acc
    torch.cuda.empty_cache()
    return out


def _large_times(A: torch.Tensor, rows: dict, tag: str) -> dict:
    """Rows 4 and 10 at B = 1 on the large LP's shape, each timed beside its
    bound (``_bound``), into ``rows[...][tag]``: the assembly with a d2 of
    one decade, the factor on that M Jacobi-scaled with reg 1e-8."""
    m, n = A.shape
    A3 = A.unsqueeze(0)
    g = torch.Generator(device=DEV).manual_seed(9)
    d2 = 0.5 + torch.rand(1, n, generator=g, device=DEV)
    asm = {"m": m, "n": n, "batch": 1, "a_dtype": str(A.dtype),
           "ms": time_ms(lambda: pk.assemble_sym_batched(A3, d2), reps=2,
                         warm=1)}
    asm.update(_bound(*_assembly_work(1, m, n, A.element_size())))
    M = pk.assemble_sym_batched(A3, d2)
    j = torch.rsqrt(M.diagonal(dim1=1, dim2=2))
    M.mul_(j.unsqueeze(2)).mul_(j.unsqueeze(1))
    M.diagonal(dim1=1, dim2=2).add_(1e-8)
    fac = {"m": m, "batch": 1,
           "ms": time_ms(lambda: pk.factor_lt_batched(M), reps=2, warm=1)}
    fac.update(_bound(*_lt_factor_work(1, m)))
    del M
    torch.cuda.empty_cache()
    rows["assemble_sym_batched"][tag] = asm
    rows["factor_lt_batched"][tag] = fac
    return {"assemble_sym_batched": asm, "factor_lt_batched": fac}


def _large_run(phase: str, lp, star: float, opts, mesh=None,
               chunk: int = 0, split: bool = False, hold: bool = True,
               timing: bool = False) -> tuple:
    """One ``solve_large`` with its stages recorded (RungRecorder) and,
    with ``split``, its seconds split by piece; the library Cholesky and
    triangular solve must not be called.  With ``hold``, rows 4 and 10 are
    then held on the run's first and last normal matrix (:func:`_hold_path`,
    ``timing`` their plain versions' times).  Returns (result dict,
    launches, problems, solution)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    timer = SplitTimer() if split else contextlib.nullcontext()
    with LibraryFactorCalls() as lib, RungRecorder() as rec, \
            FactorCalls() as fcalls, timer:
        t0 = time.perf_counter()
        sol = ipx_torch.solve_large(lp, mesh=mesh, options=opts,
                                    exec_chunk_iters=chunk, device=DEV)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launched = counts()
    err = abs(sol.objective - star) / (1 + abs(star))
    res = dict(m=lp.A.shape[0], n=lp.A.shape[1], a_dtype=str(lp.A.dtype),
               exec_chunk_iters=chunk,
               status=sol.status_name, iterations=sol.iterations,
               rel_gap=sol.rel_gap, rp_rel=sol.rp_rel, rd_rel=sol.rd_rel,
               objective=sol.objective, obj_rel_err=err, seconds=secs,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               stages=[{k: c[k] for k in ("linsys", "warm", "optimal",
                                          "max_iterations", "seconds")}
                       for c in rec.calls],
               launches={k: v for k, v in launched.items() if v},
               library_calls=lib.calls)
    problems = []
    if split:
        res["split_seconds"] = dict(timer.seconds)
        res["split_seconds"]["rest"] = secs - sum(timer.seconds.values())
        res["split_calls"] = timer.calls
        res["library_products"] = timer.library_products
        never = timer.never_called({c["linsys"] for c in rec.calls})
        if never:
            problems.append(f"{phase}: pieces never called: {never}; was a "
                            f"function renamed?")
        if timer.library_products:
            problems.append(f"{phase}: {timer.library_products} library "
                            "products with A (rows 2 and 3 take them all)")
    if not (sol.optimal and sol.rel_gap <= 1e-6 and err <= LARGE_OBJ_TOL):
        problems.append(f"{phase}: {sol.status_name}, gap {sol.rel_gap:.2e}, "
                        f"objective {err:.2e} off its optimum")
    if any(launched[k] == 0 for k in PATH_KERNELS[phase]):
        problems.append(f"{phase}: a kernel of the path was never launched")
    if any(lib.calls[k] for k in FACTOR_CALLS):
        problems.append(f"{phase}: library factor or triangular solve called: "
                        f"{lib.calls}")
    if hold:
        res["held"], held_problems = _hold_path(phase, fcalls.calls, mesh,
                                                timing)
        problems += held_problems
    return res, launched, problems, sol


def phase_large(rows: dict) -> dict:
    """Config 4 whole on the card: m=32768, n=65536, A stored bf16 (its
    values rounded before b and c are formed), generated on the card from
    seed 0; row 4's far-corner tiles against float64, beside the summations
    the limit rejects; rows 4 and 10 timed at this shape; then
    ``solve_large`` at p = 1 with the default options (the endgame armed)
    to OPTIMAL, gap 1e-6, objective within 1e-5, its seconds split by piece
    and its peak memory; rows 4 and 10 held on the run's first and last
    normal matrix, their plain versions and library calls timed there."""
    phase = "large"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = torch.Generator(device=DEV).manual_seed(0)
    lp, star = random_feasible_large_device(M_LARGE, N_LARGE, g,
                                            torch.bfloat16, device=DEV)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    corners = _far_corners(lp.A)
    emit("large/far_corners", **corners)
    if not (max(corners[k] for k in ("first", "last", "corner"))
            <= TOL_LARGE_F64 and corners["mirror_bitwise"]):
        fail(phase, f"assemble_sym_batched's far corners: {corners}")
    if min(corners[k] for k in ("rejected_one_chain_f32",
                                "rejected_one_pass_bf16")) <= TOL_LARGE_F64:
        fail(phase, f"TOL_LARGE_F64 passes a rejected summation: {corners}")
    kernel_times = _large_times(lp.A, rows, "large_b1")
    opts = ipx_torch.SolverOptions(dtype="float32", a_storage="bfloat16")
    res, launched, problems, _ = _large_run(phase, lp, star, opts, split=True,
                                            timing=True)
    # the plain versions and the library calls, timed on the run's last
    # normal matrix (the kernels' times do not depend on the values)
    for name, row in res["held"]["last"].items():
        rows[name]["large_b1"].update(
            {k: row[k] for k in ("plain_ms", "library_ms")})
    # rows 2 and 3 on config 4's A, after the solve
    res["rows_2_3"] = _rows_b1(lp.A.unsqueeze(0), rows, "large_b1", phase)
    res.update(generate_seconds=gen_s, far_corners=corners,
               kernel_times=kernel_times,
               launches_rows_4_10={k: launched[k] for k in _LARGE})
    emit(phase, ok=not problems, **res)
    if problems:
        fail(phase, "; ".join(problems))
    del lp
    torch.cuda.empty_cache()
    return launched


def _f32_assembly_times(A: torch.Tensor) -> dict:
    """Row 4 at B = 1 on an f32 A (m, n) with a d2 of one decade: the
    kernel, its plain version and one library f32 product of the same
    function (A o d2 formed outside the timed region), beside the bound
    (``_bound``: two f32 operands, the six-pass rate)."""
    m, n = A.shape
    A3 = A.unsqueeze(0)
    g = torch.Generator(device=DEV).manual_seed(9)
    d2 = 0.5 + torch.rand(1, n, generator=g, device=DEV)
    W = A3 * d2.unsqueeze(1)
    nbytes, _, asm = _assembly_work(1, m, n, 4)
    out = {"m": m, "n": n, "batch": 1, "a_dtype": str(A.dtype),
           "ms": time_ms(lambda: pk.assemble_sym_batched(A3, d2), reps=3,
                         warm=1),
           "plain_ms": time_ms(
               lambda: pk.assemble_sym_batched_plain(A3, d2), reps=2, warm=1),
           "library_ms": time_ms(lambda: torch.matmul(W, A3.mT), reps=2,
                                 warm=1),
           **_bound(nbytes, 0, chol_flops=asm)}
    del W
    torch.cuda.empty_cache()
    return out


def phase_large_f32(rows: dict) -> dict:
    """m=8192, n=16384 with A float32 (row 4's float32 kernel, row 10):
    row 4 timed at this shape; ``solve_large`` to OPTIMAL, then with
    exec_chunk_iters=8, which must give the same status and the objective
    within 1e-5 relative (what ``tests/test_sharded.py`` asks of ``ipx``);
    the counts and the held rows 4 and 10 are the first run's."""
    phase = "large_f32"
    m = M_LARGE_F32
    g = torch.Generator(device=DEV).manual_seed(1)
    lp, star = random_feasible_large_device(m, 2 * m, g, torch.float32,
                                            device=DEV)
    asm = _f32_assembly_times(lp.A)
    rows["assemble_sym_batched"]["large_f32_b1"] = asm
    opts = ipx_torch.SolverOptions(dtype="float32")
    res, launched, problems, sol = _large_run(phase, lp, star, opts)
    res2, _, problems2, sol2 = _large_run(phase, lp, star, opts,
                                          chunk=LARGE_CHUNK, hold=False)
    problems += problems2
    if sol2.status != sol.status or abs(sol2.objective - sol.objective) > (
            1e-5 * (1 + abs(sol.objective))):
        problems.append(f"chunked {sol2.status_name} {sol2.objective} against "
                        f"{sol.status_name} {sol.objective}")
    emit(phase, ok=not problems, assembly_times=asm, unchunked=res,
         chunked=res2)
    if problems:
        fail(phase, "; ".join(problems))
    return launched


def phase_sharded_schur() -> dict:
    """``linsys="sharded_schur"`` forced at m=4096, n=8192, bf16 A: the
    endgame route whether or not ``large`` needed it, to OPTIMAL within
    1e-5 of the optimum; rows 4 and 10 held on its normal matrices."""
    phase = "sharded_schur"
    g = torch.Generator(device=DEV).manual_seed(2)
    lp, star = random_feasible_large_device(M_SCHUR, 2 * M_SCHUR, g,
                                            torch.bfloat16, device=DEV)
    opts = ipx_torch.SolverOptions(dtype="float32", a_storage="bfloat16",
                                   linsys="sharded_schur")
    res, launched, problems, _ = _large_run(phase, lp, star, opts)
    emit(phase, ok=not problems, **res)
    if problems:
        fail(phase, "; ".join(problems))
    return launched


def phase_large_group() -> dict:
    """``solve_large`` at m=2048 under a one-rank NCCL group (started here:
    ``mesh.init_distributed`` is a no-op for one process), so that
    ``make_mesh`` and the collectives run on the card's backend, rows 4
    and 10 held on its normal matrices; then config 5's batch-sharded solve
    on the same mesh as a caller drives it (``batch_lp_sharding``, then
    ``solve_batch`` of the share, the solutions gathered; B=4 at the main
    path's width, the rescue ladder on: all four OPTIMAL within 1e-5); the
    group destroyed after."""
    import socket
    phase = "large_group"
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
        timeout=meshlib.TIMEOUT)
    try:
        mesh = meshlib.make_mesh(batch=1, row=1)
        g = torch.Generator(device=DEV).manual_seed(3)
        lp, star = random_feasible_large_device(M_GROUP, 2 * M_GROUP, g,
                                                torch.bfloat16, device=DEV)
        opts = ipx_torch.SolverOptions(dtype="float32", a_storage="bfloat16")
        res, launched, problems, _ = _large_run(phase, lp, star, opts,
                                                mesh=mesh)
        gb = random_feasible_batch_device(4, M_ROWS, N_COLS, g,
                                          a_storage="bfloat16", device=DEV)
        # config 5 as a caller drives it: this rank's share of the batch,
        # the solutions gathered over the "batch" group
        share = type(gb.lp)(**{
            f: getattr(gb.lp, f)[idx]
            for f, idx in meshlib.batch_lp_sharding(mesh, 4).items()})
        parts = [None] * mesh.shape[meshlib.BATCH_AXIS]
        torch.distributed.all_gather_object(
            parts, ipx_torch.solve_batch(share, options=rescue_options(),
                                         device=DEV),
            group=mesh.groups[meshlib.BATCH_AXIS])
        sols = [s for part in parts for s in part]
        errs = [abs(s.objective - o) / (1 + abs(o))
                for s, o in zip(sols, gb.obj_star.tolist())]
        res["batch_sharded"] = dict(status=[s.status_name for s in sols],
                                    max_obj_rel_err=max(errs))
        if len(sols) != 4 or not all(s.optimal for s in sols) \
                or max(errs) > LARGE_OBJ_TOL:
            problems.append(f"batch-sharded solve: {res['batch_sharded']}")
        res["backend"] = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    emit(phase, ok=not problems, **res)
    if problems:
        fail(phase, "; ".join(problems))
    return launched


class KernelCalls:
    """While active, keeps the inputs and outputs of the first and the last
    call of rows 4 and 10 (``assemble_sym_batched``, ``factor_lt_batched``),
    copied at the call (the path scales the assembled matrix in place):
    what :func:`_hold_calls` holds after the run, on a rank whose path runs
    collectives that cannot be replayed alone."""

    def __enter__(self):
        self.calls = {"asm": {}, "factor": {}}
        self._orig = asm, fac = pk.assemble_sym_batched, pk.factor_lt_batched

        def asm_keep(A, d2):
            M = asm(A, d2)
            self._keep("asm", (A, d2.clone(), M.clone()))
            return M

        def fac_keep(M):
            LT, W = fac(M)
            self._keep("factor", (M.clone(), LT.clone(), W.clone()))
            return LT, W
        pk.assemble_sym_batched, pk.factor_lt_batched = asm_keep, fac_keep
        return self

    def _keep(self, name, rec):
        self.calls[name].setdefault("first", rec)
        self.calls[name]["last"] = rec

    def __exit__(self, *exc):
        pk.assemble_sym_batched, pk.factor_lt_batched = self._orig


def _worst(rows: list) -> dict:
    """One reading from a lane's each: the largest of each number, every
    flag's AND."""
    out = {}
    for k in rows[0]:
        vals = [r[k] for r in rows if r[k] is not None]
        if not vals:
            out[k] = None
        elif isinstance(vals[0], bool):
            out[k] = all(vals)
        elif isinstance(vals[0], float):
            out[k] = max(vals)
        else:
            out[k] = vals[0]
    return out


def _hold_calls(phase: str, calls: dict) -> tuple:
    """Rows 4 and 10 held lane by lane on the first and the last call a run
    made (:class:`KernelCalls`) -> (the worst reading over the lanes of
    each, problems)."""
    out, problems = {}, []
    for when in ("first", "last"):
        A, d2, M = calls["asm"][when]
        Ms, LT, W = calls["factor"][when]
        asms, facs = [], []
        for b in range(A.shape[0]):
            asms.append(_hold_assembly(A[b:b + 1], d2[b:b + 1], M[b:b + 1],
                                       timing=False))
            facs.append(_hold_factor(Ms[b:b + 1], LT[b:b + 1], W[b:b + 1],
                                     timing=False))
            problems += _held_problems(f"{phase} lane {b}", when, asms[-1],
                                       facs[-1])
        out[when] = {"assemble_sym_batched": _worst(asms),
                     "factor_lt_batched": _worst(facs)}
    return out, problems


def _row_batch():
    """The eight instances of the ``row_sharded`` phase, made on the card
    from ROW_SEED (every process that makes them gets the same bits)."""
    g = torch.Generator(device=DEV).manual_seed(ROW_SEED)
    return random_feasible_batch_device(B_ROW, M_ROWS, N_COLS, g,
                                        a_storage="bfloat16", device=DEV)


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _row_solve(lp, mesh, hold: bool) -> dict:
    """``solve_batch(lp, mesh=mesh)`` on the sharded route, its launches
    counted from 0 and, with ``hold``, rows 4 and 10 held on its first and
    last normal matrices afterwards."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with KernelCalls() as kc, LibraryFactorCalls() as lib:
        t0 = time.perf_counter()
        # the default options with the instances' A storage, the endgame
        # armed
        sols = ipx_torch.solve_batch(lp, options=ipx_torch.SolverOptions(
            dtype="float32", a_storage="bfloat16", linsys="sharded"),
            device=DEV, mesh=mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    res = dict(seconds=secs,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=counts(), library_calls=lib.calls,
               status=[q.status_name for q in sols],
               iterations=[q.iterations for q in sols],
               objective=[q.objective for q in sols],
               digest=_digest(*[q.x for q in sols]))
    if hold:
        res["held"], res["problems"] = _hold_calls("row_sharded", kc.calls)
    return res


def row_sharded_child(rank: int, port: int) -> int:
    """One of the two ranks of the ``row_sharded`` phase's mesh (run as
    ``chip_smoke.py --row-sharded-rank RANK PORT``): a gloo group on the one
    card, a (1, 2) mesh, this rank's share of the eight instances (each A's
    column block), rank 0 holding rows 4 and 10; one ROW_RESULT line."""
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank, timeout=meshlib.TIMEOUT)
    try:
        mesh = meshlib.make_mesh(batch=1, row=2)
        gb = _row_batch()
        idx = meshlib.batch_lp_sharding(mesh, B_ROW, N_COLS)
        share = type(gb.lp)(**{f: getattr(gb.lp, f)[i]
                               for f, i in idx.items()})
        res = _row_solve(share, mesh, hold=rank == 0)
        res.update(rank=rank, backend=torch.distributed.get_backend())
    finally:
        torch.distributed.destroy_process_group()
    print("ROW_RESULT " + json.dumps(res), flush=True)
    return 0


def phase_row_sharded() -> dict:
    """Config 5 with each A split over the "row" axis, at the main path's
    width (m=1024, n=2048, bf16 A, eight instances, default options with
    the endgame armed): ``solve_batch(..., mesh=make_mesh())`` in this
    process at p = 1 with ``linsys="sharded"``, then on a (1, 2) mesh of two
    child processes sharing the card over gloo (the kernels already built
    here).  All eight OPTIMAL within 1e-5 of the optima on both, the
    objectives within 1e-5 relative of the main path's one-process
    ``solve_batch`` (throughput() with the ladder), both ranks' x bit for
    bit, rows 4 and 10 held on rank 0's first and last normal matrices.
    Returns the launches of the p = 1 run and rank 0's."""
    import socket
    phase = "row_sharded"
    gb = _row_batch()
    star = gb.obj_star.tolist()
    ref = ipx_torch.solve_batch(gb.lp, options=rescue_options(), device=DEV)
    ref_obj = [q.objective for q in ref]
    p1 = _row_solve(gb.lp, meshlib.make_mesh(), hold=False)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--row-sharded-rank",
         str(r), str(port)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=ROW_CHILD_TIMEOUT))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    ranks = []
    for r, (pr, (out, err)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("ROW_RESULT ")]
        if pr.returncode != 0 or not lines:
            fail(phase, f"rank {r} exit {pr.returncode}: {err[-3000:]}")
        ranks.append(json.loads(lines[-1][len("ROW_RESULT "):]))
    problems = list(ranks[0].pop("problems"))
    for name, run in (("p1", p1), ("mesh", ranks[0])):
        errs = [abs(o - t) / (1 + abs(t)) for o, t in zip(run["objective"],
                                                          star)]
        vs = [abs(o - t) / (1 + abs(t)) for o, t in zip(run["objective"],
                                                        ref_obj)]
        run.update(max_obj_rel_err=max(errs), max_vs_one_process=max(vs))
        if run["status"] != ["OPTIMAL"] * B_ROW or max(errs) > ROW_OBJ_TOL \
                or max(vs) > ROW_OBJ_TOL:
            problems.append(f"{name}: {run['status']}, objectives "
                            f"{max(errs):.2e} off the optima, {max(vs):.2e} "
                            f"off the one-process solve")
        if any(run["launches"][k] == 0 for k in PATH_KERNELS[phase]):
            problems.append(f"{name}: a kernel of the path was never "
                            f"launched: {run['launches']}")
        if any(run["library_calls"][k] for k in FACTOR_CALLS):
            problems.append(f"{name}: library factor called: "
                            f"{run['library_calls']}")
    if ranks[1]["digest"] != ranks[0]["digest"]:
        problems.append("the two ranks' x differ")
    res = dict(m=M_ROWS, n=N_COLS, batch=B_ROW, p1=p1, mesh=ranks[0],
               rank1={k: ranks[1][k] for k in ("seconds", "peak_memory_gib",
                                               "iterations", "digest")},
               one_process=dict(status=[q.status_name for q in ref],
                                iterations=[q.iterations for q in ref]))
    emit(phase, ok=not problems, **res)
    if problems:
        fail(phase, "; ".join(problems))
    return {"row_sharded": p1["launches"],
            "row_sharded_mesh": ranks[0]["launches"]}


def timed(phase_fn, *args, name=None):
    """Run a phase and print the seconds it took on a line of its own."""
    t0 = time.perf_counter()
    out = phase_fn(*args)
    emit("seconds", of=name or phase_fn.__name__.removeprefix("phase_"),
         seconds=round(time.perf_counter() - t0, 2))
    return out


def main() -> int:
    t_start = time.perf_counter()
    card = phase_env()
    timed(phase_build)
    rows = timed(phase_kernels)
    timed(phase_panel_kernels, rows)
    timed(phase_lt_kernels, rows)
    by_path = {}

    def drive(path, batch, m, opts):
        """One driven path: counts set to 0 just before, read just after."""
        gb_, sols_, by_path[path] = timed(phase_solve_batch, path, batch, m,
                                          opts, name=f"solve_batch/{path}")
        return gb_, sols_

    # the main path: throughput() as it stands, every factor and every
    # preconditioner apply through the hand-written kernels
    gb, sols = drive("pallas_left", B_MAIN, M_ROWS, slice_options())
    # the same instances with the rescue ladder: stage 1 as above, then the
    # in-batch Schur rung and the per-LP rungs on the lanes it stalled
    by_path["rescue"] = timed(phase_rescue, gb, sols,
                              name="solve_batch/rescue")
    # the same batch at full width on the right-looking kernel factor and
    # the full-L^T pair-solve
    drive("pallas", B_MAIN, M_ROWS, slice_options(chol_backend="pallas"))
    # the earlier paths (library Cholesky, padded panel route) and the other
    # backends that keep a full L^T or emit panels from library products
    drive("xla", B_XLA, M_ROWS, slice_options(chol_backend="xla"))
    drive("padded", B_PADDED, M_PADDED, slice_options())
    # throughput() as defined, A stored float32: row 4's float32 kernel and
    # row 7's accumulation at full width
    drive("throughput_f32", B_XLA, M_ROWS, f32_options())
    for backend in ("blocked_left", "blocked", "hybrid", "panels"):
        drive(backend, B_XLA, M_ROWS, slice_options(chol_backend=backend))
    drive("assembled", B_XLA, M_ROWS,
          slice_options(chol_backend="pallas", cg_operator="assembled"))
    drive("padded_lt", B_PADDED, M_PADDED,
          slice_options(chol_backend="pallas"))
    # the rescue ladder's routes on their own, every lane, and one LP alone
    # through the ladder; refactor_period=2 on throughput() as defined
    drive("augmented_schur", B_XLA, M_ROWS,
          slice_options(linsys="augmented_schur"))
    drive("augmented", B_LU, M_ROWS, slice_options(linsys="augmented"))
    by_path["ladder"] = timed(phase_ladder, gb, sols, name="solve/ladder")
    drive("refactor2", B_XLA, M_ROWS, f32_options(refactor_period=2))
    by_path["kernel_api"] = timed(phase_kernel_api)
    timed(phase_oracle_f64, gb)
    timed(phase_single, gb, sols)
    timed(phase_rate, gb, card)
    del gb, sols
    torch.cuda.empty_cache()
    # the problem layer and front ends, each path with its counts set to 0
    # just before it and read just after
    gen = random_feasible_lp(M_ROWS, N_COLS, seed=0)
    by_path.update(timed(phase_presolve, gen, name="solve/presolve"))
    by_path.update(timed(phase_general, name="solve_general"))
    by_path["mps"] = timed(phase_mps, name="solve_mps")
    by_path["many"] = timed(phase_many, name="solve_many")
    by_path["resume"] = timed(phase_resume, gen, name="resume")
    timed(phase_cli, name="cli")
    # the large single LP and the multi-device code: the small shapes first,
    # then config 4 whole
    by_path["large_group"] = timed(phase_large_group)
    by_path.update(timed(phase_row_sharded))
    by_path["sharded_schur"] = timed(phase_sharded_schur)
    by_path["large_f32"] = timed(phase_large_f32, rows)
    by_path["large"] = timed(phase_large, rows)

    out = []
    for name, row in rows.items():
        row = {k: v for k, v in row.items() if k != "checks"}
        # the count of the first path, main path first, that runs the kernel
        row["launches"] = next(c[name] for p, c in by_path.items()
                               if name in PATH_KERNELS[p])
        row["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        out.append(row)
    # the rows with matrix products, counted at the float32 CUDA-core rate
    work = {**_matvec_work(B_MAIN, 2), **_panel_work(B_MAIN)}
    emit("bounds", batch=B_MAIN, f32_cuda_core_ms={
        name: _f32_cuda_core_ms(*w) for name, w in work.items()
        if any(w[2:4])})
    print(json.dumps({"kernels": out}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--row-sharded-rank"]:
        sys.exit(row_sharded_child(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
