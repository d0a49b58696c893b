"""Solver configuration.

One frozen dataclass carries every tunable.  Field names, defaults and
validation are those of ``ipx.options.SolverOptions``, so one set of keyword
arguments drives both packages.  Fields whose values this package does not
carry yet are still accepted here (validation is identical) and refused by
:func:`check_ported`, which every entry point calls.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

LINSYS_CHOICES = ("dense", "sharded", "augmented", "augmented_schur",
                  "sharded_schur")
CHOL_BACKEND_CHOICES = ("xla", "pallas", "pallas_left", "panels", "hybrid",
                        "blocked", "blocked_left")


@dataclass(frozen=True)
class SolverOptions:
    """Options for the Mehrotra predictor-corrector IPM."""

    # --- termination -------------------------------------------------------
    tol: float = 1e-6           # relative duality-gap tolerance
    tol_feas: float = 1e-6      # relative primal/dual infeasibility tolerance
    max_iter: int = 64          # hard iteration cap (sizes the trace)

    # --- Mehrotra algorithm constants --------------------------------------
    alpha_damping: float = 0.9995   # fraction-to-boundary damping factor
    adaptive_damping: bool = True   # eta = max(damping_floor, 1 - mu)
    damping_floor: float = 0.995
    sigma_power: float = 3.0        # sigma = (mu_aff / mu) ** sigma_power
    # Gondzio multiple centrality correctors per iteration (0 = off).  Each
    # reuses the factorization (two extra solves: the correction is itself
    # refined once) and is accepted only on a material step gain outside
    # the f32 endgame.
    gondzio_correctors: int = 0

    # --- numerics ------------------------------------------------------------
    # Compute dtype.  "float64" runs on the card too (through the non-fused
    # route) and serves as the device-side oracle.
    dtype: str = "float32"
    reg: float = 1e-8           # relative Tikhonov regularization of A D^2 A^T
    refine_steps: int = 3       # PCG iterations per normal-equations solve
    # CG operator: "matrix_free" applies A (d2 (A^T v)) every iteration;
    # "assembled" streams the m x m normal matrix instead.
    cg_operator: str = "matrix_free"
    kkt_refine_steps: int = 2   # full-KKT refinement sweeps (corrector)
    # CG iterations for the normal-eq solves INSIDE KKT refinement sweeps
    # (-1 = same as refine_steps).  0 is one direct preconditioner apply.
    refine_solve_cg: int = -1
    predictor_refine_steps: int = 2  # refinement sweeps, affine direction
    # Factor reuse across iterations: period=k factors once per k
    # iterations; the k-1 stale steps use the previous factor as CG
    # preconditioner against the fresh matrix-free operator.
    refactor_period: int = 1
    stale_solve_cg: int = 2     # refine_steps used on stale steps
    # Both precision names are kept for interchangeability.  This package
    # computes every f32 product in IEEE f32 (no TF32, no reduced-pass
    # modes), which meets "highest"; the cheaper names select nothing else.
    matmul_precision: str = "highest"
    assembly_precision: str = "highest"
    pos_floor: float = 1e-30    # absolute floor keeping x, s > 0
    mu_floor_rel: float = 1e-12 # stop (STALLED) once mu < mu_floor_rel * mu0
    stall_window: int = 10      # STALLED if mu has not halved in this many
                                # iterations (0 disables)
    # Endgame patience: within rel_gap <= stall_gap_guard * tol the windowed
    # stall test loosens from "halved" to "shrank >= 2%" over the window.
    stall_gap_guard: float = 16.0
    # After a non-finite step the iteration keeps the previous iterate and
    # multiplies the Tikhonov reg by reg_boost_step (capped) before retrying.
    reg_boost_step: float = 1e3
    reg_boost_cap: float = 1e9
    reg_boost_decay: float = 0.1        # sharded route only
    reg_boost_decay_dense: float = 1.0  # dense route: sticky by default
    infeas_diverge_thresh: float = 1e7
    warm_start_mu: float = 1e-5
    # Project each search direction onto {A dx = -rp} via the loop-invariant
    # AA^T factor: pins primal feasibility at mu-independent accuracy.
    project_feasibility: bool = True
    proj_cg_iters: int = 1      # CG iterations for the projection solve
    # Centrality backoff: halve alpha up to backoff_candidates-1 times until
    # min(x_j s_j) >= neighborhood_gamma * mu after the step.
    backoff_candidates: int = 8
    neighborhood_gamma: float = 1e-2
    # Effective feasibility tolerance is max(tol_feas, feas_eps_mult*eps).
    feas_eps_mult: float = 16.0

    # --- linear-system backend ---------------------------------------------
    linsys: str = "dense"
    aug_reg: float = 1e-6
    aug_schur_refine: int = 5
    # Retry a STALLED / failed dense-route solve with the augmented system.
    augmented_fallback: bool = True
    # "xla" names the library Cholesky (torch.linalg.cholesky_ex and two
    # triangular solves).  The others are float32-only and solve with the
    # pair-solve kernels of ``ipx_torch.kernels.cholesky``: "pallas_left"
    # the panel-major kernel factor (fused with the assembly for a bf16 A),
    # "panels" the same layout from library products, "pallas" the
    # right-looking kernel factor, "blocked" / "blocked_left" right- and
    # left-looking factors from library products, "hybrid" the library
    # Cholesky with its diagonal blocks inverted afterwards.
    chol_backend: str = "xla"
    # "fused" evaluates the matrix-free normal operator and the KKT
    # refinement right-hand sides with the one-stream kernels of
    # ``ipx_torch.kernels.fused``; "xla" takes A w and A^T v apart, on rows
    # 2 and 3 of the kernels on the card (float64 sums) and as library
    # matmuls on the CPU.
    matvec_backend: str = "xla"  # "xla" | "fused"
    # "bfloat16" keeps A in bf16 in device memory; all arithmetic stays f32
    # (kernels upcast in registers).  Exact when A's entries are
    # bf16-representable; otherwise the solved LP is the rounded instance.
    a_storage: str = "float32"   # "float32" | "bfloat16"
    cg_iters_sharded: int = 40

    # --- sharding ----------------------------------------------------------
    batch_axis: str = "batch"
    row_axis: str = "row"

    def __post_init__(self):
        if self.max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter}")
        if not (self.tol > 0 and self.tol_feas > 0):
            raise ValueError("tol and tol_feas must be positive")
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.refine_steps < 0 or self.kkt_refine_steps < 0:
            raise ValueError("refinement step counts must be >= 0")
        if self.refine_solve_cg < -1:
            raise ValueError("refine_solve_cg must be >= -1")
        if self.refactor_period < 1:
            raise ValueError("refactor_period must be >= 1")
        if self.refactor_period > 1 and self.cg_operator != "matrix_free":
            raise ValueError(
                "refactor_period > 1 requires cg_operator='matrix_free' "
                "(an assembled CG operator would be stale with the factor)")
        if self.refactor_period > 1 and not self.linsys.startswith("dense"):
            raise ValueError(
                "refactor_period > 1 is only supported on the dense route")
        if self.a_storage not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported a_storage {self.a_storage!r}")
        if self.a_storage == "bfloat16" and self.dtype != "float32":
            raise ValueError("a_storage='bfloat16' requires dtype='float32'")
        if self.linsys not in LINSYS_CHOICES:
            raise ValueError(f"unsupported linsys {self.linsys!r}")
        if self.chol_backend not in CHOL_BACKEND_CHOICES:
            raise ValueError(f"unsupported chol_backend {self.chol_backend!r}")
        if self.dtype == "float64" and self.chol_backend != "xla":
            raise ValueError(
                "chol_backend='pallas'/'hybrid'/'blocked' solves are "
                "float32-only; use chol_backend='xla' with dtype='float64'")

    def replace(self, **kw) -> "SolverOptions":
        return dataclasses.replace(self, **kw)

    @classmethod
    def throughput(cls, **kw) -> "SolverOptions":
        """The batch-throughput configuration: fused assemble+factor backend
        (``pallas_left``), fused one-stream matvecs, one CG refinement per
        solve, direct (CG-less) feasibility projection and refinement-sweep
        solves.  Not the default: degenerate or badly scaled instances need
        the robust settings.  Keyword overrides are applied on top.
        """
        base = dict(dtype="float32", chol_backend="pallas_left",
                    matvec_backend="fused", refine_steps=1,
                    proj_cg_iters=0, refine_solve_cg=0)
        base.update(kw)
        return cls(**base)


DEFAULT_OPTIONS = SolverOptions()


def check_ported(opts: SolverOptions) -> None:
    """Refuse option values whose code path is not in this package yet.

    An option is either honoured or refused, never silently replaced.  Each
    message names the ROADMAP.md item that will carry the value.
    """
    if opts.dtype == "bfloat16":
        raise NotImplementedError(
            "dtype='bfloat16' as COMPUTE dtype is not carried: "
            "torch.linalg has no bf16 Cholesky (use a_storage='bfloat16')")
