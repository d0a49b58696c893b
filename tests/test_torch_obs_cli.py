"""The port's checkpoint/resume, spans and profiling hooks and CLI on the
CPU, with snapshots crossing between ``ipx`` and ``ipx_torch``."""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ipx
import ipx_torch
from ipx import obs as jobs
from ipx_torch import obs
from ipx_torch.cli import _add_solver_flags, _build_options, main
from ipx_torch.options import CHOL_BACKEND_CHOICES, LINSYS_CHOICES
from ipx_torch.problem.generate import random_feasible_lp
from ipx_torch.status import Status

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one thread: torch's CPU build may hang in a batched LU on more than one
ENV = dict(os.environ, OMP_NUM_THREADS="1",
           PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
OPTS = dict(dtype="float32")


def _rel(a, b):
    return abs(a - b) / (1 + abs(b))


def test_resume_reaches_uninterrupted_objective(tmp_path):
    """A solve stopped after 4 iterations, checkpointed and resumed ends
    where one uninterrupted solve ends (``tests/test_obs_cli.py``'s limits
    for ``ipx``)."""
    g = random_feasible_lp(40, 80, seed=3)
    opts = ipx_torch.SolverOptions(**OPTS)
    full = ipx_torch.solve(g.c, g.A, g.b, options=opts, device="cpu")
    assert full.optimal
    ck = str(tmp_path / "st.npz")
    part = ipx_torch.solve(g.c, g.A, g.b, options=opts.replace(max_iter=4),
                           checkpoint_to=ck, device="cpu")
    assert part.status == int(Status.MAX_ITER)
    res = ipx_torch.solve(g.c, g.A, g.b, options=opts, resume_from=ck,
                          device="cpu")
    assert res.optimal
    assert _rel(res.objective, full.objective) <= 1e-6
    assert 4 < res.iterations <= full.iterations + 4


@pytest.mark.parametrize("writer", ["ipx", "ipx_torch"])
def test_snapshot_crosses_packages(tmp_path, writer):
    """A snapshot written by one package after 4 iterations resumes in the
    other: the layout is the same, the resumed run continues (more than 4
    iterations) and reaches the writer's uninterrupted objective."""
    g = random_feasible_lp(40, 80, seed=3)
    ck = str(tmp_path / "st.npz")
    jopts, topts = ipx.SolverOptions(**OPTS), ipx_torch.SolverOptions(**OPTS)
    if writer == "ipx":
        part = ipx.solve(g.c, g.A, g.b, options=jopts.replace(max_iter=4),
                         checkpoint_to=ck)
        full = ipx.solve(g.c, g.A, g.b, options=jopts, presolve=False)
        res = ipx_torch.solve(g.c, g.A, g.b, options=topts, resume_from=ck,
                              device="cpu")
    else:
        part = ipx_torch.solve(g.c, g.A, g.b,
                               options=topts.replace(max_iter=4),
                               checkpoint_to=ck, device="cpu")
        full = ipx_torch.solve(g.c, g.A, g.b, options=topts, presolve=False,
                               device="cpu")
        res = ipx.solve(g.c, g.A, g.b, options=jopts, resume_from=ck)
    assert part.status == int(Status.MAX_ITER)
    assert res.optimal
    assert _rel(res.objective, full.objective) <= 1e-6
    assert 4 < res.iterations <= full.iterations + 4
    # the writer's state as the other package loads it
    with np.load(ck) as z:
        assert z["x"].shape == (80,) and z["it"].shape == ()
        assert int(z["it"]) == 4


def test_state_layout_single_and_batched(tmp_path):
    """A one-lane state is written without its batch axis, as ``ipx``'s
    single solve writes it, and loads back as a batch of one; a batch keeps
    its axis; each field round-trips exactly; ``resume_state`` resizes the
    trace and reopens a MAX_ITER lane only."""
    gs = [random_feasible_lp(12, 30, seed=i) for i in range(3)]
    lps = [ipx_torch.make_lp(g.c, g.A, g.b, device="cpu") for g in gs]
    from ipx_torch.api import _prepare, _run_batch
    opts = ipx_torch.SolverOptions(max_iter=6)
    st = _run_batch(_prepare(lps, opts, "cpu"), opts)
    one = _run_batch(_prepare(lps[:1], opts, "cpu"), opts)
    for state, name in ((st, "b.npz"), (one, "s.npz")):
        path = str(tmp_path / name)
        obs.save_state(path, state)
        with np.load(path) as z:
            assert z["x"].shape == tuple(state.x.shape[int(name == "s.npz"):])
        back = obs.load_state(path, device="cpu")
        for f in obs._STATE_FIELDS:
            assert torch.equal(getattr(back, f), getattr(state, f)), f
        # ipx loads the same file as its own state
        jst = jobs.load_state(path)
        np.testing.assert_array_equal(np.asarray(jst.x),
                                      state.x.numpy()[0] if name == "s.npz"
                                      else state.x.numpy())
    re = obs.resume_state(st, 20)
    assert re.trace.shape == (3, 20, 8)
    assert torch.equal(re.trace[:, :6], st.trace)
    maxed = st.status == int(Status.MAX_ITER)
    assert torch.equal(re.status[maxed],
                       torch.full_like(re.status[maxed], int(Status.RUNNING)))
    assert torch.equal(re.status[~maxed], st.status[~maxed])
    with pytest.raises(ValueError):
        obs.resume_state(st, 2)


def test_solve_with_snapshots(tmp_path):
    """Snapshots every 3 iterations; re-running the call with the snapshot
    present resumes and returns the converged solution."""
    g = random_feasible_lp(30, 60, seed=5)
    path = str(tmp_path / "snap.npz")
    opts = ipx_torch.SolverOptions(max_iter=40, **OPTS)
    sol = obs.solve_with_snapshots(g.c, g.A, g.b, options=opts, every=3,
                                   path=path, device="cpu")
    assert sol.optimal and sol.iterations > 3
    assert _rel(sol.objective, g.obj_star) <= 2e-6
    st = obs.load_state(path, device="cpu")
    assert int(st.it.max()) == sol.iterations
    again = obs.solve_with_snapshots(g.c, g.A, g.b, options=opts, every=3,
                                     path=path, device="cpu")
    assert again.optimal and again.iterations == sol.iterations


def test_timed_section_and_trace_to(tmp_path):
    """``obs.span`` and ``obs.count`` under ``obs.tracing``, and a span in
    ``obs.trace_to``'s Chrome trace (the name is the earlier contract's:
    ``obs.span`` took the place of ``timed_section``)."""
    with obs.tracing() as t:
        with obs.span("work"):
            sum(range(1000))
        obs.count("items", 3)
    got = t.summary()
    assert got["spans"]["work"]["calls"] == 1
    assert got["spans"]["work"]["seconds"] >= 0
    assert got["counters"] == {"items": 3}
    with obs.trace_to(str(tmp_path)):
        with obs.span("work.traced"):
            torch.ones(8) @ torch.ones(8)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files and '"work.traced"' in (tmp_path / files[0]).read_text()


def _cli(*args):
    r = subprocess.run([sys.executable, "-m", "ipx_torch", *args],
                       capture_output=True, text=True, env=ENV, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_cli_random_json():
    out = _cli("random", "--m", "20", "--n", "40", "--json", "--quiet",
               "--device", "cpu")
    assert out["status"] == "OPTIMAL"
    assert float(out["known_optimum_rel_err"]) <= 1e-5


def test_cli_solve_mps(tmp_path):
    mps = tmp_path / "t.mps"
    mps.write_text("NAME T\nROWS\n N obj\n G g1\nCOLUMNS\n"
                   "    x obj 2.0 g1 1.0\n    y obj 3.0 g1 1.0\n"
                   "RHS\n    rhs g1 4.0\nENDATA\n")
    out = _cli("solve", str(mps), "--json", "--quiet", "--dtype", "float64",
               "--device", "cpu")
    assert out["status"] == "OPTIMAL"
    assert abs(out["objective"] - 8.0) < 1e-6   # min 2x+3y, x+y>=4 -> x=4


def test_cli_bench_refused(capsys):
    assert main(["bench", "--chunks", "2"]) == 2
    assert "ROADMAP.md" in capsys.readouterr().err


def test_cli_backend_choices_round_trip():
    """Every option value SolverOptions takes is reachable by flag."""
    for flag, names, field in (("--chol-backend", CHOL_BACKEND_CHOICES,
                                "chol_backend"),
                               ("--linsys", LINSYS_CHOICES, "linsys")):
        for name in names:
            p = argparse.ArgumentParser()
            _add_solver_flags(p)
            args = p.parse_args([flag, name])
            assert getattr(_build_options(args), field) == name
            assert args.device == "cuda"
