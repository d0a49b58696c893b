"""Contracts of the ipx_torch package: what it imports, which options it
validates like ipx, which it refuses for now, and what its kernel wrappers
take."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import ipx
import ipx_torch
from ipx_torch.kernels import cholesky as tpk, fused as tfk
from ipx_torch.problem.lp import make_lp

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_import_pulls_in_neither_jax_nor_ipx():
    code = ("import sys; import ipx_torch, ipx_torch.convert, "
            "ipx_torch.kernels.fused, ipx_torch.kernels.cholesky, "
            "ipx_torch.problem.generate, ipx_torch.ipm.batched, "
            "ipx_torch.obs, ipx_torch.cli, ipx_torch.native, "
            "ipx_torch.problem.mps, ipx_torch.problem.presolve, "
            "ipx_torch.problem.batching, ipx_torch.ipm.reference_numpy; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'ipx' or m.startswith('ipx.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_never_import_jax_or_ipx():
    files = sorted((ROOT / "ipx_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    pat = re.compile(r"^\s*(import|from)\s+(jax|ipx)(\.|\s|$)", re.M)
    for f in files:
        assert not pat.search(f.read_text()), f


def test_tf32_stays_off():
    import ipx_torch.numerics  # noqa: F401  (asserts at import)
    assert torch.backends.cuda.matmul.allow_tf32 is False


BAD_OPTIONS = [
    dict(max_iter=0), dict(tol=0.0), dict(tol_feas=-1.0), dict(dtype="float16"),
    dict(refine_steps=-1), dict(kkt_refine_steps=-1), dict(refine_solve_cg=-2),
    dict(refactor_period=0),
    dict(refactor_period=2, cg_operator="assembled"),
    dict(refactor_period=2, linsys="augmented"),
    dict(a_storage="float16"), dict(a_storage="bfloat16", dtype="float64"),
    dict(linsys="nope"), dict(chol_backend="nope"),
    dict(dtype="float64", chol_backend="pallas"),
]


@pytest.mark.parametrize("kw", BAD_OPTIONS, ids=[str(k) for k in BAD_OPTIONS])
def test_option_validation_matches_ipx(kw):
    with pytest.raises(ValueError):
        ipx.SolverOptions(**kw)
    with pytest.raises(ValueError):
        ipx_torch.SolverOptions(**kw)


def test_exports_match_ipx():
    """Every name ``ipx`` exports, and no other."""
    assert ipx_torch.__all__ == ipx.__all__
    assert all(hasattr(ipx_torch, name) for name in ipx_torch.__all__)


def test_problem_exports_match_ipx():
    """``ipx_torch.problem`` exports what ``ipx.problem`` does, among them
    ``random_feasible_lp`` and ``random_feasible_batch``; so does ``obs``
    with ``debug_mode`` and ``checked_solve``, under ``ipx``'s parameter
    names."""
    import inspect
    import ipx.obs
    import ipx.problem
    import ipx_torch.obs
    import ipx_torch.problem

    def public(mod):
        return {k for k in vars(mod) if not k.startswith("_")
                and not inspect.ismodule(getattr(mod, k))}
    assert public(ipx_torch.problem) == public(ipx.problem)
    for name in ("debug_mode", "checked_solve"):
        got, ref = (inspect.signature(getattr(mod, name)).parameters
                    for mod in (ipx_torch.obs, ipx.obs))
        assert list(got) == list(ref), name


def test_random_feasible_batch_matches_ipx():
    """The same list of instances as ``ipx``'s, bit for bit, keywords
    passed through."""
    import numpy as np
    from ipx.problem import random_feasible_batch as jb
    from ipx_torch.problem import random_feasible_batch as tb
    for kw in ({}, dict(support=5, scale_spread=1.0)):
        got, ref = tb(3, 8, 16, seed=4, **kw), jb(3, 8, 16, seed=4, **kw)
        assert len(got) == len(ref) == 3
        for a, b in zip(got, ref):
            for f in ("c", "A", "b", "x_star", "y_star", "s_star"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
            assert a.obj_star == b.obj_star


def test_options_same_fields_defaults_and_throughput():
    import dataclasses
    fj = {f.name: f.default for f in dataclasses.fields(ipx.SolverOptions)}
    ft = {f.name: f.default for f in dataclasses.fields(ipx_torch.SolverOptions)}
    assert fj == ft
    assert (dataclasses.asdict(ipx.SolverOptions.throughput(max_iter=9))
            == dataclasses.asdict(ipx_torch.SolverOptions.throughput(max_iter=9)))
    o = ipx_torch.SolverOptions().replace(tol=1e-3)
    assert o.tol == 1e-3 and hash(o) is not None
    assert {int(s): s.name for s in ipx.Status} == \
        {int(s): s.name for s in ipx_torch.Status}


def _tiny_lp():
    return make_lp([1.0, 1.0, 1.0], [[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]],
                   [1.0, 1.0], device="cpu")


NOT_PORTED = [
    dict(dtype="bfloat16"),
]
# the sharded routes, carried by solve_large (they need the mesh it makes)
SHARDED = [dict(linsys="sharded"), dict(linsys="sharded_schur")]
# option values that were refused until their code path was carried
NOW_PORTED = [
    dict(chol_backend="pallas"), dict(chol_backend="blocked"),
    dict(chol_backend="blocked_left"), dict(chol_backend="panels"),
    dict(chol_backend="hybrid"), dict(cg_operator="assembled"),
    dict(linsys="augmented"), dict(linsys="augmented_schur"),
    dict(refactor_period=2), dict(augmented_fallback=True),
]


@pytest.mark.parametrize("kw", NOT_PORTED, ids=[str(k) for k in NOT_PORTED])
def test_unported_option_values_are_refused(kw):
    base = dict(augmented_fallback=False)
    base.update(kw)
    opts = ipx_torch.SolverOptions(**base)
    with pytest.raises(NotImplementedError, match="ROADMAP|not carried"):
        ipx_torch.solve_batch([_tiny_lp()], options=opts, device="cpu")
    with pytest.raises(NotImplementedError):
        ipx_torch.solve(_tiny_lp(), options=opts, presolve=False, device="cpu")


@pytest.mark.parametrize("kw", NOW_PORTED, ids=[str(k) for k in NOW_PORTED])
def test_ported_option_values_solve(kw):
    """Each solves the tiny LP (optimum 1 at x = (0, 1, 0)) on the CPU,
    through both entry points; objective within 1e-5 (float32, gap 1e-6)."""
    opts = ipx_torch.SolverOptions(**{"augmented_fallback": False, **kw})
    sols = ipx_torch.solve_batch([_tiny_lp()], options=opts, device="cpu")
    one = ipx_torch.solve(_tiny_lp(), options=opts, presolve=False,
                          device="cpu")
    for sol in (sols[0], one):
        assert sol.optimal, sol.status_name
        assert abs(sol.objective - 1.0) <= 1e-5


@pytest.mark.parametrize("kw", SHARDED, ids=[str(k) for k in SHARDED])
def test_sharded_option_values_solve(kw):
    """Each sharded route solves the tiny LP through ``solve_large`` on the
    CPU (one process: p = 1), through ``check_ported`` first; objective
    within 1e-5."""
    opts = ipx_torch.SolverOptions(**{"augmented_fallback": False, **kw})
    ipx_torch.options.check_ported(opts)
    sol = ipx_torch.solve_large(_tiny_lp(), options=opts, device="cpu")
    assert sol.optimal, sol.status_name
    assert abs(sol.objective - 1.0) <= 1e-5


def test_presolve_and_default_fallback_are_refused():
    """The defaults were refused until their code was carried, and now
    solve: presolve=True (the problem layer) and augmented_fallback=True
    (the rescue ladder).  The name is the earlier contract's, kept so that
    the test's history reads on under one name."""
    ok = ipx_torch.SolverOptions(augmented_fallback=False)
    sol = ipx_torch.solve(_tiny_lp(), options=ok, device="cpu")
    assert sol.optimal and abs(sol.objective - 1.0) <= 1e-5
    sol = ipx_torch.solve(_tiny_lp(), device="cpu")
    assert sol.optimal and abs(sol.objective - 1.0) <= 1e-5
    sol = ipx_torch.solve(_tiny_lp(), presolve=False, device="cpu")
    assert sol.optimal and abs(sol.objective - 1.0) <= 1e-5
    # throughput() as it stands names pallas_left, and runs
    unchanged = ipx_torch.SolverOptions.throughput(augmented_fallback=False)
    assert unchanged.chol_backend == "pallas_left"
    sol, = ipx_torch.solve_batch([_tiny_lp()], device="cpu", options=unchanged)
    assert sol.optimal and abs(sol.objective - 1.0) <= 1e-5


def test_tiny_lp_solves():
    sol = ipx_torch.solve(_tiny_lp(), presolve=False, device="cpu",
                          options=ipx_torch.SolverOptions(
                              dtype="float64", augmented_fallback=False))
    assert sol.optimal and abs(sol.objective - 1.0) <= 1e-6


A = torch.zeros(2, 8, 16)
V, W = torch.zeros(2, 8), torch.zeros(2, 16)

BAD_CALLS = [
    ("a_matvec f64 A", lambda: tfk.a_matvec(A.double(), W), TypeError),
    ("a_matvec f64 w", lambda: tfk.a_matvec(A, W.double()), TypeError),
    ("a_matvec shape", lambda: tfk.a_matvec(A, V), ValueError),
    ("a_matvec rank", lambda: tfk.a_matvec(A[0], W[0]), ValueError),
    ("a_matvec squared shape", lambda: tfk.a_matvec(A, V, square=True), ValueError),
    ("at_matvec shape", lambda: tfk.at_matvec(A, W), ValueError),
    ("at_matvec dtype", lambda: tfk.at_matvec(A, V.to(torch.bfloat16)), TypeError),
    ("ata alpha shape", lambda: tfk.ata_apply(A, V, V, W), ValueError),
    ("ata beta dtype", lambda: tfk.ata_apply(A, V, W, W, beta=W.double()), TypeError),
    ("ata strided A", lambda: tfk.ata_apply(A.mT.contiguous().mT, V, W, W), ValueError),
    ("ata strided v", lambda: tfk.ata_apply(A, torch.zeros(2, 16)[:, ::2], W, W), ValueError),
    ("assemble f16 A", lambda: tpk.assemble_sym_batched(A.half(), W), TypeError),
    ("assemble f64 d2", lambda: tpk.assemble_sym_batched(A, W.double()), TypeError),
    ("assemble d2 shape", lambda: tpk.assemble_sym_batched(A, V), ValueError),
    ("assemble rank", lambda: tpk.assemble_sym_batched(A[0], W[0]), ValueError),
]


@pytest.mark.parametrize("name,call,exc", BAD_CALLS, ids=[c[0] for c in BAD_CALLS])
def test_kernel_wrappers_refuse_wrong_inputs(name, call, exc):
    with pytest.raises(exc):
        call()


def test_wrappers_count_no_launch_on_cpu():
    before = dict(tfk.LAUNCHES), dict(tpk.LAUNCHES)
    tfk.ata_apply(A, V, W, W)
    tfk.a_matvec(A, W)
    tfk.at_matvec(A, V)
    tpk.assemble_sym_batched(A, W)
    assert (dict(tfk.LAUNCHES), dict(tpk.LAUNCHES)) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_oversize_rows_stay_on_the_fused_route_and_are_refused(dtype):
    """An A with more rows than one block's shared memory holds as a column
    stripe is still the kernels' to take under ``matvec_backend="fused"``:
    the route does not look at the shape.  ``ata_apply`` (row 1, whose
    stripe caps m) refuses it before any device call instead of handing it
    to library matmuls; rows 2 and 3 stream rows, keep nothing of A in
    shared memory and have a tiling for it."""
    from ipx_torch.linsys import products
    m, n = 1 << 15, 8
    big = torch.zeros(1, m, n, dtype=dtype)
    isz = big.element_size()
    assert tfk.stripe_cols(m, isz) is None
    fused = ipx_torch.SolverOptions.throughput(
        chol_backend="xla", augmented_fallback=False)
    assert products.use_fused_matvec(fused, big)
    assert not products.use_fused_matvec(
        fused.replace(matvec_backend="xla"), big)
    assert not products.use_fused_matvec(fused, big.double())
    before = dict(tfk.LAUNCHES)
    with pytest.raises(ValueError, match="do not fit"):
        tfk._stripe_width(big)
    assert dict(tfk.LAUNCHES) == before
    # rows 2 and 3: one span of w (n is narrow), m / tile partial t
    assert tfk.a_span(n, isz) == 32 * 16 // isz
    assert tfk.a_partials(n, isz) == 0
    assert tfk.at_partials(m, isz) == m // tfk.at_tile(isz)


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
