"""Which products with A go through rows 2 and 3 (``kernels.fused.a_matvec``
/ ``at_matvec``) and which stay library products, route by route.

``linsys.products`` decides: on a CUDA device with A stored float32 or
bf16 every route's products, and the re-check's, take rows 2 and 3, the
fused route's take the kernels' wrappers on either device, and on the CPU
every other route keeps the library product it had, bit for bit
(``numerics.mv``, ``mv64``, ``mv_wide``).  Where the decision says so, each
of the routes' product sites calls the row kernels' wrappers: checked here
on the CPU with the card test forced and the wrappers recorded (their plain
versions then run).  No JAX, no GPU.
"""
import numpy as np
import pytest
import torch

import ipx_torch
from ipx_torch import api
from ipx_torch import mesh as meshlib
from ipx_torch import numerics
from ipx_torch.kernels import fused as fk
from ipx_torch.linsys import augmented, normal_eq, products, schur
from ipx_torch.options import LINSYS_CHOICES
from ipx_torch.problem.generate import random_feasible_lp

torch.set_num_threads(1)

F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
ROUTES_ON_ROWS = ("augmented", "augmented_schur", "sharded", "sharded_schur")


def test_linsys_choices_are_the_routes_decided_here():
    assert set(LINSYS_CHOICES) == {"dense", *ROUTES_ON_ROWS}


class _StoredA:
    """An A as the decision sees it, on any device: where it lives, how it
    is stored, its shape (B=1, m=2, n=3)."""

    shape = (1, 2, 3)

    def __init__(self, device, dtype):
        self.device, self.dtype = torch.device(device), dtype

    @property
    def mT(self):
        return self


def _recorded(monkeypatch):
    """Every product the decision can pick, patched to record its kind and
    return zeros of the right shape: ``("rows", out_dtype)`` for the
    kernels' wrappers, ``(name, None)`` for the library products."""
    calls = []

    def kernel(length):
        def rec(A, x, square=False, out_dtype=F32):
            calls.append(("rows", out_dtype))
            return torch.zeros(1, length, dtype=out_dtype)
        return rec

    def library(name):
        def rec(A, x):
            calls.append((name, None))
            dt = F64 if name == "mv64" else x.dtype
            return torch.zeros(1, 5 - x.shape[-1], dtype=dt)
        return rec

    monkeypatch.setattr(fk, "a_matvec", kernel(2))
    monkeypatch.setattr(fk, "at_matvec", kernel(3))
    for name in ("mv", "mv_wide", "mv64"):
        monkeypatch.setattr(products, name, library(name))
    return calls


# each route under each matvec_backend, and this A's pair at each sums
USES = ([f"{r}/{b}" for r in sorted(LINSYS_CHOICES) for b in ("xla", "fused")]
        + [f"sums/{s}" for s in ("working", "wide", "f64")])


@pytest.mark.parametrize("use", USES)
@pytest.mark.parametrize("device", ["cpu", "cuda", torch.device("cuda", 1)],
                         ids=["cpu", "cuda", "cuda1"])
@pytest.mark.parametrize("dtype", [F32, BF16, F64], ids=["f32", "bf16", "f64"])
def test_product_table(monkeypatch, use, device, dtype):
    """The whole table, by route and ``matvec_backend`` (through
    ``normal_eq.matvecs``) or by sums (``products.pair``, the re-check's
    being ``"f64"``), device and A's storage: the fused route (dense,
    ``"fused"``, A stored f32 or bf16) takes the kernels' wrappers on
    either device; on the card an A stored f32 or bf16 takes rows 2 and 3
    everywhere, float64 out for ``"f64"`` sums (``"sharded_schur"``'s local
    ones); anything else takes the library product of its sums, ``mv`` on
    the dense route and ``"sharded"``, ``mv_wide`` on the augmented routes,
    ``mv64`` for ``"sharded_schur"``."""
    calls = _recorded(monkeypatch)
    A = _StoredA(device, dtype)
    kind, how = use.split("/")
    stored = dtype != F64
    fused = kind == "dense" and how == "fused" and stored
    if kind == "sums":
        sums = how
        fwd, tr = products.pair(A, sums)
    else:
        sums = {"dense": "working", "sharded": "working",
                "sharded_schur": "f64"}.get(kind, "wide")
        opts = ipx_torch.SolverOptions(linsys=kind, matvec_backend=how)
        assert products.use_fused_matvec(opts, A) is fused
        with schur.use_mesh(meshlib.make_mesh()):
            fwd, tr = normal_eq.matvecs(A, opts)
    fwd(torch.ones(1, 3))
    tr(torch.ones(1, 2))
    if fused or (stored and torch.device(device).type == "cuda"):
        want = ("rows", F64 if sums == "f64" else F32)
    else:
        want = ({"working": "mv", "wide": "mv_wide", "f64": "mv64"}[sums],
                None)
    assert calls == [want, want]


def _lp_arrays(B=2, m=24, n=40, seed=0, dtype=F32):
    rng = np.random.default_rng(seed)
    A = torch.from_numpy((rng.standard_normal((B, m, n)) / np.sqrt(n))
                         .astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((B, n)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, m)).astype(np.float32))
    d2 = torch.from_numpy(np.exp(rng.standard_normal((B, n)))
                          .astype(np.float32))
    return A, w, v, d2


@pytest.mark.parametrize("a_dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("linsys", sorted(LINSYS_CHOICES))
def test_cpu_products_stay_library_bit_for_bit(linsys, a_dtype):
    """On the CPU each route's (A w, A^T v) is the library product it was
    before rows 2 and 3 took the card's: one-chain float32 (``mv``) on the
    dense route under ``matvec_backend="xla"`` and on ``"sharded"``,
    float64 sums rounded once (``mv_wide``, ``mv64``) on the augmented
    routes and ``"sharded_schur"``."""
    A, w, v, d2 = _lp_arrays(dtype=a_dtype)
    opts = ipx_torch.SolverOptions(linsys=linsys)
    with schur.use_mesh(meshlib.make_mesh()):
        fwd, tr = normal_eq.matvecs(A, opts)
        y, t = fwd(w), tr(v)
    wide = linsys != "dense" and linsys != "sharded"
    prod = numerics.mv_wide if wide else numerics.mv
    assert torch.equal(y, prod(A, w)) and y.dtype == F32
    assert torch.equal(t, prod(A.mT, v)) and t.dtype == F32
    if linsys.startswith("augmented") or linsys == "sharded_schur":
        # the augmented module's own product site
        with schur.use_mesh(meshlib.make_mesh()):
            a1, a2 = augmented._apply_unreg(A, d2, w, v, opts)
        inv_d2 = 1.0 / torch.clamp(d2, min=torch.finfo(F32).tiny)
        assert torch.equal(a2, numerics.mv_wide(A, w))
        assert torch.equal(a1, -inv_d2 * w + numerics.mv_wide(A.mT, v))


def test_cpu_sharded_float64_products_and_diagonal_stay_library():
    """``schur.matvecs(wide=True)`` on float64 vectors (the re-check of
    ``api.solve_large``) and the Jacobi diagonal keep their library forms
    on the CPU."""
    A, w, v, d2 = _lp_arrays(dtype=BF16)
    with schur.use_mesh(meshlib.make_mesh()):
        fwd, tr = schur.matvecs(A, wide=True)
        assert torch.equal(fwd(w.double()), numerics.mv64(A, w.double()))
        assert torch.equal(tr(v.double()), numerics.mv64(A.mT, v.double()))
    Af = A.float()
    ref = torch.matmul(Af * Af, d2.unsqueeze(-1)).squeeze(-1)
    assert torch.equal(schur._diag_scan(A, d2), ref)


@pytest.fixture
def forced_rows(monkeypatch):
    """The card test forced to the card's answer on the CPU, and every call
    of the row kernels' wrappers recorded as (name, square, out_dtype)."""
    calls = []
    a_mv, at_mv = fk.a_matvec, fk.at_matvec

    def a_rec(A, w, square=False, out_dtype=F32):
        calls.append(("a_matvec", square, out_dtype))
        return a_mv(A, w, square, out_dtype)

    def at_rec(A, v, out_dtype=F32):
        calls.append(("at_matvec", False, out_dtype))
        return at_mv(A, v, out_dtype)

    monkeypatch.setattr(products, "on_card",
                        lambda A: A.dtype in products.ROW_DTYPES)
    monkeypatch.setattr(fk, "a_matvec", a_rec)
    monkeypatch.setattr(fk, "at_matvec", at_rec)
    return calls


@pytest.mark.parametrize("linsys", sorted(LINSYS_CHOICES))
def test_card_routes_call_rows_2_and_3(forced_rows, linsys):
    """Where the decision says so, the routes' products go to the row
    kernels: rounded to float32 on the dense route under
    ``matvec_backend="xla"``, the augmented routes and ``"sharded"``,
    float64 out through the all-reduce on ``"sharded_schur"``."""
    A, w, v, _ = _lp_arrays(dtype=BF16)
    opts = ipx_torch.SolverOptions(linsys=linsys)
    with schur.use_mesh(meshlib.make_mesh()):
        fwd, tr = normal_eq.matvecs(A, opts)
        y, t = fwd(w), tr(v)
    assert y.dtype == t.dtype == F32
    out = F64 if linsys == "sharded_schur" else F32
    assert forced_rows == [("a_matvec", False, out), ("at_matvec", False, out)]
    # on the CPU the wrappers run their plain versions: float32 products,
    # float64 ones for out_dtype=float64
    Af = A.float()
    ref_y = Af.double() @ w.double().unsqueeze(-1)
    assert (y.double() - ref_y.squeeze(-1)).abs().max() <= 1e-6
    assert t.shape == (A.shape[0], A.shape[2])


def test_card_dense_cg_operator_calls_rows_2_and_3(forced_rows):
    """The dense route's matrix-free CG operator under ``"xla"``, A (d2
    (A^T v)), is one product each way on the rows; the fused route keeps
    row 1's single stream (not recorded here)."""
    A, w, v, d2 = _lp_arrays(dtype=F32)
    for backend in ("xla", "fused"):
        opts = ipx_torch.SolverOptions(matvec_backend=backend,
                                       refine_steps=1)
        fac = normal_eq.factor(A, d2, opts)
        forced_rows.clear()
        dy = normal_eq.solve(fac, A, v, opts)
        # one operator product for the first residual, one in the CG step
        pair = [("at_matvec", False, F32), ("a_matvec", False, F32)]
        assert forced_rows == (pair * 2 if backend == "xla" else [])
        M = A.double() @ (d2.double().unsqueeze(-1) * A.double().mT)
        res = v.double() - (M @ dy.double().unsqueeze(-1)).squeeze(-1)
        assert res.abs().max() <= 1e-3 * v.abs().max()


def test_card_augmented_products_call_rows_2_and_3(forced_rows):
    """The augmented module's own product site, the true augmented operator
    (A^T dy, then A dx), on rows 2 and 3 rounded to float32."""
    A, w, v, d2 = _lp_arrays(dtype=BF16)
    for linsys in ("augmented", "augmented_schur"):
        augmented._apply_unreg(A, d2, w, v,
                               ipx_torch.SolverOptions(linsys=linsys))
    assert forced_rows == [("at_matvec", False, F32), ("a_matvec", False, F32)] * 2


def test_card_sharded_diagonal_and_recheck_call_rows_2_and_3(forced_rows):
    """The Jacobi diagonal is row 2's squared stream; the float64 re-check's
    vectors (float64 copies of a float32 solve's iterates) go to rows 2 and
    3 as float32, float64 out."""
    A, w, v, d2 = _lp_arrays(dtype=BF16)
    schur._diag_scan(A, d2)
    assert forced_rows == [("a_matvec", True, F32)]
    forced_rows.clear()
    with schur.use_mesh(meshlib.make_mesh()):
        fwd, tr = schur.matvecs(A, wide=True)
        y, t = fwd(w.double()), tr(v.double())
    assert forced_rows == [("a_matvec", False, F64), ("at_matvec", False, F64)]
    assert y.dtype == t.dtype == F64
    assert torch.equal(y, numerics.mv64(A, w))


@pytest.mark.parametrize("a_dtype", [F32, BF16], ids=["f32", "bf16"])
def test_dense_recheck_calls_rows_2_and_3_once(forced_rows, a_dtype):
    """The float64 re-check of a batch without a mesh (``solve_batch``'s
    and ``solve``'s Solutions) takes one product each way over the whole
    batch, float64 out, where the card takes rows 2 and 3 for an A stored
    float32 or bf16: not one a lane."""
    opts = ipx_torch.SolverOptions(
        dtype="float32", max_iter=2,
        a_storage="bfloat16" if a_dtype == BF16 else "float32")
    gs = [random_feasible_lp(16, 32, seed=s) for s in range(3)]
    blp = api._prepare([ipx_torch.make_lp(g.c, torch.from_numpy(g.A).to(
        a_dtype), g.b, device="cpu") for g in gs], opts, "cpu")
    assert blp.A.dtype == a_dtype
    st = api._run_batch(blp, opts)
    forced_rows.clear()
    sols = api._states_to_solutions(blp, st)
    assert forced_rows == [("a_matvec", False, F64), ("at_matvec", False, F64)]
    assert len(sols) == 3 and all(s.rp_rel > 0 for s in sols)
