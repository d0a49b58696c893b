"""The port's problem layer against ``ipx``'s: standard form, postsolve,
presolve, the MPS parsers, bucketed padding and the float64 numpy
reference solver.  All of it is numpy host code, copied, so the same seeded
inputs must give exactly the same arrays."""
import dataclasses

import numpy as np
import pytest
import torch

from ipx.ipm import reference_numpy as jref
from ipx.problem import batching as jbatching
from ipx.problem import lp as jlp
from ipx.problem import mps as jmps
from ipx.problem import presolve as jpresolve
from ipx.problem.generate import random_general_lp as j_random_general_lp
from ipx_torch import native as tnative
from ipx_torch.ipm import reference_numpy as tref
from ipx_torch.problem import batching as tbatching
from ipx_torch.problem import lp as tlp
from ipx_torch.problem import mps as tmps
from ipx_torch.problem import presolve as tpresolve
from ipx_torch.problem.generate import (random_feasible_lp,
                                        random_general_lp)

from test_netlib_suite import SUITE
from test_problem_layer import SIMPLE_MPS, _random_mps
from test_mps_fixtures import CLASSIC, FIXTURES, _path

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _numpy_blas_on_one_thread():
    """numpy's BLAS spins its threads against the other test workers' (the
    dependent-row QR of presolve); one thread for this module's tests,
    where threadpoolctl is installed."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1):
        yield


def _same(a, b):
    """Dataclass instances (or tuples) with equal fields, arrays exactly."""
    if dataclasses.is_dataclass(a):
        a = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
        b = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (np.ndarray, list, tuple)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b or (a != a and b != b), (a, b)


SUITE_IDS = [f"synth{c['seed']}" for c in SUITE]


@pytest.mark.parametrize("cfg", SUITE, ids=SUITE_IDS)
def test_standard_form_and_postsolve_match_ipx(cfg):
    """The generator, the conversion and its Postsolve, exactly."""
    tg, jg = random_general_lp(**cfg), j_random_general_lp(**cfg)
    _same(tg, jg)
    t_out, j_out = tlp.to_standard_form(tg), jlp.to_standard_form(jg)
    for t, j in zip(t_out[:4], j_out[:4]):
        _same(t, j)
    _same(t_out[4], j_out[4])
    z = np.random.default_rng(cfg["seed"]).uniform(0, 2, t_out[4].n_std)
    np.testing.assert_array_equal(t_out[4].x_orig(z), j_out[4].x_orig(z))


def _edge(name):
    """The standard forms of ``tests/test_problem_layer.py``'s presolve
    cases: zero row or column, infeasible, unbounded, singleton, duplicate
    and dependent rows."""
    rng = np.random.default_rng(0)
    if name == "zero_row":
        return np.ones(2), np.array([[1.0, 2.0], [0.0, 0.0]]), np.array([3.0, 0.0])
    if name == "zero_row_infeasible":
        return np.ones(2), np.array([[1.0, 2.0], [0.0, 0.0]]), np.array([3.0, 1.0])
    if name == "zero_col":
        return (np.array([1.0, 5.0]), np.array([[1.0, 0.0], [2.0, 0.0]]),
                np.array([1.0, 2.0]))
    if name == "zero_col_unbounded":
        return np.array([1.0, -1.0]), np.array([[1.0, 0.0]]), np.array([1.0])
    if name == "singleton_row":
        return (np.ones(3), np.array([[3.0, 0.0, 0.0], [1.0, 1.0, 1.0]]),
                np.array([6.0, 5.0]))
    if name == "duplicate_rows":
        return (np.ones(2), np.array([[1.0, 2.0], [2.0, 4.0], [1.0, 0.0]]),
                np.array([3.0, 6.0, 1.0]))
    if name == "duplicate_rows_inconsistent":
        return (np.ones(2), np.array([[1.0, 2.0], [2.0, 4.0]]),
                np.array([3.0, 7.0]))
    m, n = 30, 60
    A = rng.standard_normal((m, n))
    for k in range(3):
        A[m - 1 - k] = rng.standard_normal(m - 3) @ A[:m - 3]
    A *= 10.0 ** rng.uniform(-2, 2, size=(m, 1))
    b = A @ np.abs(rng.standard_normal(n))
    if name == "dependent_rows_inconsistent":
        b[m - 1] += 1.0
    return np.abs(rng.standard_normal(n)) + 0.1, A, b


# edge case -> the status presolve must give
EDGES = {"zero_row": "ok", "zero_row_infeasible": "infeasible",
         "zero_col": "ok", "zero_col_unbounded": "unbounded",
         "singleton_row": "ok", "duplicate_rows": "ok",
         "duplicate_rows_inconsistent": "infeasible", "dependent_rows": "ok",
         "dependent_rows_inconsistent": "infeasible"}
PRESOLVE_CASES = ([("suite", c) for c in SUITE_IDS]
                  + [("edge", e) for e in EDGES])


@pytest.mark.parametrize("pow2", [False, True], ids=["ruiz", "pow2"])
@pytest.mark.parametrize("kind,name", PRESOLVE_CASES,
                         ids=[n for _, n in PRESOLVE_CASES])
def test_presolve_matches_ipx(kind, name, pow2):
    """Every field of the PresolveResult, and both postsolve maps,
    exactly; the expected statuses of the edge cases."""
    if kind == "suite":
        cfg = SUITE[SUITE_IDS.index(name)]
        c, A, b, _, _ = tlp.to_standard_form(random_general_lp(**cfg))
    else:
        c, A, b = _edge(name)
    t = tpresolve.presolve(c, A, b, pow2_scales=pow2)
    j = jpresolve.presolve(c, A, b, pow2_scales=pow2)
    _same(t, j)
    assert t.status == EDGES.get(name, "ok")
    if t.status == "ok":
        rng = np.random.default_rng(1)
        xr, yr = rng.standard_normal(t.A.shape[1]), rng.standard_normal(t.A.shape[0])
        np.testing.assert_array_equal(t.postsolve_x(xr), j.postsolve_x(xr))
        np.testing.assert_array_equal(t.postsolve_y(yr), j.postsolve_y(yr))
        if pow2:   # every scale a power of two: exact in binary floating point
            for s in (t.row_scale, t.col_scale):
                np.testing.assert_array_equal(s, 2.0 ** np.round(np.log2(s)))


def _native_lib():
    lib = tnative.load_mps_lib()
    if lib is None:
        pytest.skip("no C++ toolchain")
    return lib


MPS_TEXTS = ([("fixture", f) for f in FIXTURES + [c[0] for c in CLASSIC]]
             + [("random", str(s)) for s in range(3)]
             + [("simple", "SIMPLE_MPS")])


@pytest.mark.parametrize("parser", ["python", "native"])
@pytest.mark.parametrize("kind,name", MPS_TEXTS,
                         ids=[n for _, n in MPS_TEXTS])
def test_mps_parsers_match_ipx(kind, name, parser):
    """Each of the port's parsers gives ``ipx``'s Python parser's
    GeneralLP exactly, on the committed fixtures and on seeded MPS text."""
    if parser == "native":
        _native_lib()
    text = (open(_path(name)).read() if kind == "fixture"
            else _random_mps(int(name)) if kind == "random" else SIMPLE_MPS)
    t = tmps.read_mps_string(text, use_native=(parser == "native"))
    j = jmps.read_mps_string(text, use_native=False)
    _same(t, j)
    assert getattr(t, "maximize", False) == getattr(j, "maximize", False)


def test_native_library_is_built_outside_the_sources():
    """The port builds its own copy of the tokenizer into the package's
    build directory, never next to a source and never ``ipx``'s."""
    _native_lib()
    from ipx_torch.kernels._build import build_dir
    path = tnative.library_path()
    assert path.exists() and path.parent == build_dir()
    assert tnative.SRC.parent.name == "native"
    assert tnative.SRC.parent.parent.name == "ipx_torch"


INT_MPS = ("NAME I\nROWS\n N obj\nCOLUMNS\n    M1 'MARKER' 'INTORG'\n"
           "    x obj 1.0\nENDATA\n")


@pytest.mark.parametrize("parser", ["python", "native"])
def test_mps_rejects_integer_markers(parser):
    if parser == "native":
        _native_lib()
    with pytest.raises(tmps.MPSError):
        tmps.read_mps_string(INT_MPS, use_native=(parser == "native"))


def test_bucket_and_pad_match_ipx():
    """The same buckets, the same members in the same order, and the same
    padded arrays as ``ipx``'s LPs hold; unpadding restores the shape."""
    shapes = [(10, 25), (12, 30), (40, 90), (11, 28), (33, 64), (100, 150)]
    probs = []
    for i, (m, n) in enumerate(shapes):
        g = random_feasible_lp(m, n, seed=i)
        probs.append((g.c, g.A, g.b))
    for mult in ((8, 16), (32, 64)):
        tb = tbatching.bucket_lps(probs, *mult)
        jb = jbatching.bucket_lps(probs, *mult)
        assert sorted(tb) == sorted(jb)
        for key in tb:
            assert [i for i, _ in tb[key]] == [i for i, _ in jb[key]]
            for (i, tp), (_, jp) in zip(tb[key], jb[key]):
                assert (tp.m_orig, tp.n_orig) == (jp.m_orig, jp.n_orig)
                for f in ("c", "A", "b"):
                    np.testing.assert_array_equal(
                        getattr(tp, f), np.asarray(getattr(jp.lp, f)))
                assert tp.A.shape == key
                assert tp.unpad_x(tp.c).shape == (shapes[i][1],)
                assert tp.unpad_y(tp.b).shape == (shapes[i][0],)
    assert len(tbatching.bucket_lps(probs[:4], 8, 16)) == 2
    assert (tbatching.bucket_shape(1000, 2000)
            == jbatching.bucket_shape(1000, 2000))
    with pytest.raises(ValueError):
        tbatching.pad_lp(*probs[0], 16, 22)   # no room for 6 row slacks


@pytest.mark.parametrize("m,n,seed", [(20, 45, 0), (50, 100, 3)])
def test_reference_numpy_matches_ipx(m, n, seed):
    """BASELINE config 1's float64 numpy solver: the port's copy gives
    ``ipx``'s result exactly, and reaches the constructed optimum."""
    g = random_feasible_lp(m, n, seed=seed)
    t, j = tref.solve(g.c, g.A, g.b), jref.solve(g.c, g.A, g.b)
    _same(t, j)
    assert t.status == 1
    assert abs(t.objective - g.obj_star) <= 1e-8 * (1 + abs(g.obj_star))
