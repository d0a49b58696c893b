"""The large single LP and the multi-device routes of ipx_torch on the CPU:
``linsys="sharded"`` and ``"sharded_schur"`` (``linsys/schur.py``),
``solve_large`` and config 5 (``mesh.py``): a batch split over the "batch"
axis, and each A split over the "row" axis (``solve_batch(share,
mesh=mesh)``, the sharded route over a batch of lanes).

p = 1 runs in this process.  p = 2 (the 128-blocked diagonal path: the
factor at m = 512, two blocks a rank; the solves at m = 256) and p = 4 (m =
64: the whole-block path) are launched together, each as its own ranks of
this file run as a worker script, one process a rank on gloo over 127.0.0.1;
every rank
prints its results as one JSON line, which the tests below read.  Every
launch waits at most ``LAUNCH_TIMEOUT`` seconds and every collective
``mesh.init_distributed``'s timeout, so a hang fails in seconds.

Tolerances: a factor's backward error ||L L^T - Ms|| / ||Ms|| against the f64
scaled, regularized matrix within 1e-5 (f32 factor); a solve against the f64
solve of the same system and against the port's dense route within 1e-4 of
its largest entry (3 CG steps preconditioned by an exact f32 factor); an
OPTIMAL objective within 5e-6 of the constructed optimum and of the port's
dense solve (``tests/test_sharded.py``'s limits for ``ipx``); config 5 with
row > 1 within 1e-4 of the optima and 1e-5 of ``ipx``'s row = 2 solve
(``__graft_entry__.dryrun_multichip``'s limits).  Every rank's solution is
held bit for bit to rank 0's (config 5: to its row group's).
"""
import datetime
import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ipx_torch  # noqa: E402
from ipx_torch import mesh as meshlib  # noqa: E402
from ipx_torch.kernels import cholesky as pk  # noqa: E402
from ipx_torch.linsys import normal_eq, schur  # noqa: E402
from ipx_torch.problem.generate import random_feasible_lp  # noqa: E402

torch.set_num_threads(1)

# seconds for one launch of all its ranks: both launches and the p = 1
# fixture took 166 s together inside the six-worker tier-1 run (the first
# test's setup), 20-35 s on a quiet machine; a hang still fails well inside
# the suite's time limit
LAUNCH_TIMEOUT = 400
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
# p -> m of each launch's solves and of its factor check: mp = 128 and 256
# (blocked diagonal, one and two 128-blocks a rank), mp = 16 (whole block)
LAUNCHES = {2: 256, 4: 64}
FACTOR_M = {2: 512, 4: 64}
CROSS_LP = dict(m=64, n=128, seed=1)     # the cross-package LP
# config 5 with row > 1: dryrun_multichip's shape and options, a batch of 4
ROW_LP = dict(m=32, n=64)
ROW_BATCH = 4
ROW_MAX_ITER = 40
# a degenerate lane (support 28 < m) that ends stage 1 STALLED and the
# endgame ends OPTIMAL, in a batch of the first three ROW_LP instances
DEGENERATE_LP = dict(m=32, n=64, seed=3, support=28)


# --------------------------------------------------------------------------
# the checks, run by every rank (and at p = 1 by this process)
# --------------------------------------------------------------------------

def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _factor_solve(mesh, m: int, seed: int = 5) -> dict:
    """One sharded factor and solve against the f64 solve and the dense
    route; the factor's backward error from its rows gathered."""
    p = mesh.shape[meshlib.ROW_AXIS]
    i = mesh.coords[meshlib.ROW_AXIS]
    n = 2 * m
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    d2 = rng.uniform(0.1, 10.0, n)
    rhs = rng.standard_normal(m)
    f32 = torch.float32
    At = torch.tensor(A, dtype=f32)
    nl = n // p
    A_loc = At[:, i * nl:(i + 1) * nl].contiguous().unsqueeze(0)
    d2t = torch.tensor(d2, dtype=f32).unsqueeze(0)
    rt = torch.tensor(rhs, dtype=f32).unsqueeze(0)
    opts = ipx_torch.SolverOptions(linsys="sharded")
    with schur.use_mesh(mesh):
        fac = normal_eq.factor(A_loc, d2t, opts)
        y = normal_eq.solve(fac, A_loc, rt, opts)[0]
        rows = schur._all_gather_rows(fac.L, schur._row())[0]
    L = (rows.T if p == 1 else rows).double().numpy()
    j = fac.j[0].double().numpy()
    M = (A * d2) @ A.T
    Ms = j[:, None] * M * j[None, :] + opts.reg * np.eye(m)
    y64 = np.linalg.solve(M, rhs)
    dense = ipx_torch.SolverOptions()
    fd = normal_eq.factor(At.unsqueeze(0), d2t, dense)
    yd = normal_eq.solve(fd, At.unsqueeze(0), rt, dense)[0].double().numpy()
    yn = y.double().numpy()
    top = np.abs(y64).max()
    return dict(
        ok=bool(fac.ok.all()), w=int(fac.W.shape[-1]),
        backward=float(np.abs(L @ L.T - Ms).max() / np.abs(Ms).max()),
        vs_f64=float(np.abs(yn - y64).max() / top),
        vs_dense=float(np.abs(yn - yd).max() / top),
        digest=_digest(y.numpy()))


def _sol(sol, g=None) -> dict:
    out = dict(status=sol.status_name, objective=sol.objective,
               iterations=sol.iterations, rel_gap=sol.rel_gap,
               digest=_digest(sol.x, sol.y, sol.s))
    if g is not None:
        out["err"] = abs(sol.objective - g.obj_star) / (1 + abs(g.obj_star))
    return out


def _bf16_lp(m: int, n: int, seed: int):
    """A seeded LP whose A holds bf16 values, its optimum built from them
    (the recipe of ``tests/test_sharded.py::test_sharded_bf16_storage``)."""
    rng = np.random.default_rng(seed)
    A = torch.tensor(rng.normal(size=(m, n)) / np.sqrt(n),
                     dtype=torch.float32).to(torch.bfloat16).double().numpy()
    perm = rng.permutation(n)
    x_star = np.zeros(n)
    x_star[perm[:m]] = rng.uniform(0.5, 2.0, m)
    s_star = np.zeros(n)
    s_star[perm[m:]] = rng.uniform(0.5, 2.0, n - m)
    y_star = rng.normal(size=m)
    c = A.T @ y_star + s_star
    return A, A @ x_star, c, float(c @ x_star)


def _solves(mesh, m: int) -> dict:
    """solve_large on the route's LPs: the default options (the endgame
    armed), bf16 storage, chunked and unchunked, "sharded_schur" forced on
    a degenerate LP; each against its optimum, the first against the dense
    route too."""
    O = ipx_torch.SolverOptions
    out = {}
    g = random_feasible_lp(m, 2 * m, seed=4)
    out["default"] = _sol(ipx_torch.solve_large(g.c, g.A, g.b, mesh=mesh,
                                                device="cpu"), g)
    dense = ipx_torch.solve(g.c, g.A, g.b, options=O(augmented_fallback=False),
                            presolve=False, device="cpu")
    out["default"]["dense_objective"] = dense.objective
    A, b, c, star = _bf16_lp(m, 2 * m, seed=7)
    sol = ipx_torch.solve_large(c, A, b, mesh=mesh, device="cpu",
                                options=O(a_storage="bfloat16"))
    out["bf16"] = _sol(sol)
    out["bf16"]["err"] = abs(sol.objective - star) / (1 + abs(star))
    o = O(augmented_fallback=False)
    for name, chunk in (("unchunked", 0), ("chunked", 5)):
        out[name] = _sol(ipx_torch.solve_large(
            g.c, g.A, g.b, mesh=mesh, options=o, exec_chunk_iters=chunk,
            device="cpu"), g)
    gd = random_feasible_lp(64, 128, seed=7, support=48)
    out["schur"] = _sol(ipx_torch.solve_large(
        gd.c, gd.A, gd.b, mesh=mesh, device="cpu",
        options=O(linsys="sharded_schur")), gd)
    return out


def _solve_share(lps, mesh, opts) -> list:
    """Config 5 as a caller drives it: this rank solves its
    ``batch_lp_sharding`` share (with row > 1 each A's column block) with
    ``solve_batch`` and the solutions are gathered over the "batch" group,
    so every rank holds all of them."""
    blp = ipx_torch.api.batched.stack_lps(lps)
    idx = meshlib.batch_lp_sharding(mesh, len(lps), blp.n)
    share = ipx_torch.LP(**{f: getattr(blp, f)[i] for f, i in idx.items()})
    sols = ipx_torch.solve_batch(share, options=opts, device="cpu", mesh=mesh)
    parts = [None] * mesh.shape[meshlib.BATCH_AXIS]
    torch.distributed.all_gather_object(
        parts, sols, group=mesh.groups[meshlib.BATCH_AXIS])
    return [sol for part in parts for sol in part]


def _row_lps(degenerate: bool = False):
    """The config-5 batch (``ROW_LP``, seeds 0..3), or its first three with
    ``DEGENERATE_LP`` last -> (generated, LPs)."""
    gs = [random_feasible_lp(**ROW_LP, seed=s) for s in range(ROW_BATCH)]
    if degenerate:
        gs[-1] = random_feasible_lp(**DEGENERATE_LP)
    return gs, [ipx_torch.make_lp(q.c, q.A, q.b, dtype=torch.float32,
                                  device="cpu") for q in gs]


def _row_sharded(mesh, degenerate: bool = False) -> dict:
    """Config 5 on ``mesh`` with its row axis > 1, the endgame armed; the
    statuses of every run of the solve loop recorded (stage 1, then the
    endgame's lanes)."""
    gs, lps = _row_lps(degenerate)
    runs, run = [], ipx_torch.api._run_batch

    def recorded(lp, opts, state0=None):
        st = run(lp, opts, state0)
        runs.append(dict(linsys=opts.linsys, status=st.status.tolist()))
        return st
    ipx_torch.api._run_batch = recorded
    try:
        sols = _solve_share(lps, mesh,
                            ipx_torch.SolverOptions(max_iter=ROW_MAX_ITER))
    finally:
        ipx_torch.api._run_batch = run
    return dict(
        status=[q.status_name for q in sols],
        objective=[q.objective for q in sols],
        err=[abs(q.objective - g.obj_star) / (1 + abs(g.obj_star))
             for q, g in zip(sols, gs)],
        lane_digests=[_digest(q.x, q.y, q.s) for q in sols], runs=runs)


def _worker(rank: int, world: int, port: int) -> dict:
    meshlib.init_distributed(f"127.0.0.1:{port}", world, rank,
                             timeout=GROUP_TIMEOUT)
    res = {}
    mesh = meshlib.make_mesh(batch=1, row=world)
    res["factor"] = _factor_solve(mesh, FACTOR_M[world])
    res["solves"] = _solves(mesh, LAUNCHES[world])
    try:
        ipx_torch.solve_large(np.ones(50), np.ones((30, 50)), np.ones(30),
                              mesh=mesh, device="cpu")
        res["indivisible"] = "accepted"
    except ValueError as e:
        res["indivisible"] = str(e)
    if world == 2:
        g = random_feasible_lp(**CROSS_LP)
        res["cross"] = _sol(ipx_torch.solve_large(
            g.c, g.A, g.b, mesh=mesh, device="cpu",
            options=ipx_torch.SolverOptions(augmented_fallback=False)))
        # config 5: each rank solves its half of a batch of 4
        bmesh = meshlib.make_mesh(batch=world, row=1)
        gs = [random_feasible_lp(16, 32, seed=s) for s in range(4)]
        lps = [ipx_torch.make_lp(q.c, q.A, q.b, dtype=torch.float32,
                                 device="cpu") for q in gs]
        sols = _solve_share(lps, bmesh,
                            ipx_torch.SolverOptions(max_iter=32))
        res["batch"] = dict(
            status=[s.status_name for s in sols],
            err=[abs(s.objective - q.obj_star) / (1 + abs(q.obj_star))
                 for s, q in zip(sols, gs)],
            digest=_digest(*[s.x for s in sols]))
        res["row"] = _row_sharded(mesh)
        res["row_degenerate"] = _row_sharded(mesh, degenerate=True)
    if world == 4:
        res["row_2x2"] = _row_sharded(meshlib.make_mesh(batch=2, row=2))
    torch.distributed.destroy_process_group()
    return res


# --------------------------------------------------------------------------
# launching the ranks
# --------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(worlds) -> dict:
    """For each p in ``worlds``, p ranks of this file as workers, all
    launches at once -> {p: the ranks' result dicts in rank order}.  Any
    rank that fails or outlasts LAUNCH_TIMEOUT fails the launch, and every
    child is gone when this returns."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for world in worlds:
        port = _free_port()
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env) for r in range(world)]
    outs = {}
    try:
        for world, prs in procs.items():
            outs[world] = [pr.communicate(timeout=LAUNCH_TIMEOUT)
                           for pr in prs]
    finally:
        for prs in procs.values():
            for pr in prs:
                if pr.poll() is None:
                    pr.kill()
                    pr.communicate()
    results = {}
    for world, prs in procs.items():
        results[world] = []
        for r, (pr, (out, err)) in enumerate(zip(prs, outs[world])):
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("RESULT ")]
            assert pr.returncode == 0 and lines, (
                f"rank {r} of {world}: exit {pr.returncode}\n{err[-3000:]}")
            results[world].append(json.loads(lines[-1][len("RESULT "):]))
    return results


@pytest.fixture(scope="module")
def ranks():
    """Each launch's per-rank results, launched once for the module."""
    return _launch(LAUNCHES)


@pytest.fixture(scope="module")
def p1():
    mesh = meshlib.make_mesh()
    return dict(factor=_factor_solve(mesh, 256), solves=_solves(mesh, 64))


def _views(p1, ranks):
    """(p, results of rank 0, all ranks' results) for p = 1, 2, 4."""
    out = [(1, p1, [p1])]
    out += [(w, r[0], r) for w, r in sorted(ranks.items())]
    return out


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_factor_and_solve_match_f64_and_dense(p, p1, ranks):
    _, r0, allr = next(v for v in _views(p1, ranks) if v[0] == p)
    f = r0["factor"]
    assert f["ok"]
    # W's blocks: 128 at mp = 256 (p = 1) and mp = 128 (p = 2), the whole
    # mp = 16 block at p = 4
    assert f["w"] == {1: 128, 2: 128, 4: 16}[p]
    assert f["backward"] <= 1e-5, f
    assert f["vs_f64"] <= 1e-4, f
    assert f["vs_dense"] <= 1e-4, f
    assert {r["factor"]["digest"] for r in allr} == {f["digest"]}


@pytest.mark.parametrize("p", [1, 2, 4])
def test_solve_large_matches_optimum_and_dense(p, p1, ranks):
    _, r0, _ = next(v for v in _views(p1, ranks) if v[0] == p)
    s = r0["solves"]["default"]
    assert s["status"] == "OPTIMAL", s
    assert s["err"] <= 5e-6, s
    d = s["dense_objective"]
    assert abs(s["objective"] - d) / (1 + abs(d)) <= 5e-6, s


@pytest.mark.parametrize("p", [1, 2, 4])
def test_solve_large_bf16_storage(p, p1, ranks):
    _, r0, _ = next(v for v in _views(p1, ranks) if v[0] == p)
    s = r0["solves"]["bf16"]
    assert s["status"] == "OPTIMAL", s
    assert s["err"] <= 2e-6, s


@pytest.mark.parametrize("p", [1, 2, 4])
def test_solve_large_chunked_matches_unchunked(p, p1, ranks):
    """Same status, objective within 1e-5 relative (the limit
    ``tests/test_sharded.py`` sets ``ipx``), both at the optimum."""
    _, r0, _ = next(v for v in _views(p1, ranks) if v[0] == p)
    full, chunked = r0["solves"]["unchunked"], r0["solves"]["chunked"]
    assert chunked["status"] == full["status"] == "OPTIMAL"
    assert abs(chunked["objective"] - full["objective"]) <= (
        1e-5 * (1 + abs(full["objective"])))
    assert chunked["err"] <= 2e-6, chunked


@pytest.mark.parametrize("p", [1, 2, 4])
def test_sharded_schur_endgame_degenerate(p, p1, ranks):
    """The degenerate LP of ``tests/test_sharded.py`` (support 48 < m = 64)
    on "sharded_schur" alone: OPTIMAL, gap 1e-6, objective within 2e-5."""
    _, r0, _ = next(v for v in _views(p1, ranks) if v[0] == p)
    s = r0["solves"]["schur"]
    assert s["status"] == "OPTIMAL", s
    assert s["rel_gap"] <= 1e-6 and s["err"] <= 2e-5, s


@pytest.mark.parametrize("p", [2, 4])
def test_ranks_end_bit_equal(p, ranks):
    """Every rank returns the same Solution bits: every value that steers
    control flow is replicated."""
    allr = ranks[p]
    for key in ("default", "bf16", "unchunked", "chunked", "schur"):
        assert len({r["solves"][key]["digest"] for r in allr}) == 1, key
        assert len({r["solves"][key]["iterations"] for r in allr}) == 1, key


def test_solve_large_rejects_indivisible(ranks):
    assert "divisible" in ranks[4][0]["indivisible"]
    with pytest.raises(ValueError, match="need 2 ranks"):
        meshlib.make_mesh(batch=1, row=2)


def test_batch_sharded_solve_two_ranks(ranks):
    """Config 5 on two ranks: each solves half of a batch of 4; every rank
    returns all four, OPTIMAL within 5e-5 of the constructed optima (the
    limit of ``tests/_distributed_worker.py``), the same bits on both."""
    b = [r["batch"] for r in ranks[2]]
    assert b[0]["status"] == ["OPTIMAL"] * 4, b[0]
    assert max(b[0]["err"]) <= 5e-5, b[0]
    assert b[0]["digest"] == b[1]["digest"]


def test_cross_package_solve_large_matches_ipx(ranks):
    """The same seeded LP through ``ipx.solve_large`` on a row = 2 mesh of
    the virtual CPU devices and through the port on two gloo ranks, the
    endgame off (one ``ipx`` stage compiles: about 7 s on a quiet machine):
    the same status, objectives within 1e-6 relative."""
    import jax
    import ipx
    from ipx import mesh as jmesh

    if len(jax.devices()) < 2:
        pytest.fail("needs 2 virtual CPU devices (tests/conftest.py sets 8)")
    g = random_feasible_lp(**CROSS_LP)
    ref = ipx.solve_large(g.c, g.A, g.b, mesh=jmesh.make_mesh(batch=1, row=2),
                          options=ipx.SolverOptions(augmented_fallback=False))
    got = ranks[2][0]["cross"]
    assert got["status"] == ref.status_name == "OPTIMAL"
    assert abs(got["objective"] - ref.objective) <= (
        1e-6 * (1 + abs(ref.objective))), (got, ref.objective)


def _ipx_row_sharded():
    """``ipx``'s batched solve of the ROW_LP batch jitted on a (1, 2) mesh
    of the virtual CPU devices, A placed P("batch", "row", None), as
    ``__graft_entry__.dryrun_multichip`` runs it -> (objectives, statuses)
    of the final iterates."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import ipx
    from ipx.ipm import batched
    from ipx.problem.lp import make_lp

    if len(jax.devices()) < 2:
        pytest.fail("needs 2 virtual CPU devices (tests/conftest.py sets 8)")
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("batch", "row"))
    gs, _ = _row_lps()
    blp = batched.stack_lps([make_lp(g.c, g.A, g.b) for g in gs]
                            ).astype(jnp.float32)
    sh = type(blp)(c=NamedSharding(mesh, P("batch", None)),
                   A=NamedSharding(mesh, P("batch", "row", None)),
                   b=NamedSharding(mesh, P("batch", "row")),
                   obj_offset=NamedSharding(mesh, P("batch")))
    blp = jax.tree_util.tree_map(jax.device_put, blp, sh)
    opts = ipx.SolverOptions(dtype="float32", max_iter=ROW_MAX_ITER)
    st = jax.jit(batched.run_batch, static_argnums=(1,))(blp, opts)
    obj = np.asarray(jnp.einsum("bj,bj->b", blp.c, st.x), np.float64)
    return obj, [int(v) for v in np.asarray(st.status)]


def test_row_sharded_batch_matches_ipx(ranks):
    """Config 5 on a (1, 2) mesh, each A's column block on each rank: all
    four OPTIMAL within 1e-4 of the constructed optima and 1e-5 of ``ipx``'s
    solve on a row = 2 mesh (one compile, about 5 s on a quiet machine);
    both ranks return the same bits."""
    rows = [r["row"] for r in ranks[2]]
    got = rows[0]
    assert got["status"] == ["OPTIMAL"] * ROW_BATCH, got
    assert max(got["err"]) <= 1e-4, got
    ref, status = _ipx_row_sharded()
    assert status == [int(ipx_torch.Status.OPTIMAL)] * ROW_BATCH
    rel = np.abs(np.array(got["objective"]) - ref) / (1 + np.abs(ref))
    assert rel.max() <= 1e-5, (got["objective"], ref)
    assert rows[1]["lane_digests"] == got["lane_digests"]


def test_row_sharded_endgame_rescues_degenerate_lane(ranks):
    """A degenerate lane among three healthy ones on the (1, 2) mesh: stage
    1 ("sharded") ends it STALLED and runs the others to OPTIMAL; the
    endgame runs that lane alone on "sharded_schur" and ends it OPTIMAL
    within 1e-4 of its optimum, the others untouched; both ranks agree."""
    rows = [r["row_degenerate"] for r in ranks[2]]
    got = rows[0]
    stage1, endgame = got["runs"]
    assert stage1["linsys"] == "sharded"
    assert stage1["status"][:3] == [int(ipx_torch.Status.OPTIMAL)] * 3
    assert stage1["status"][3] == int(ipx_torch.Status.STALLED), got
    assert endgame == dict(linsys="sharded_schur",
                           status=[int(ipx_torch.Status.OPTIMAL)]), got
    assert got["status"] == ["OPTIMAL"] * ROW_BATCH, got
    assert max(got["err"]) <= 1e-4, got
    assert got["lane_digests"][:3] == ranks[2][0]["row"]["lane_digests"][:3]
    assert rows[1] == got


def test_row_sharded_2x2_mesh_row_groups_agree(ranks):
    """Config 5 on a (2, 2) mesh: each batch group solves two lanes across
    its row pair; every lane OPTIMAL, and the ranks of each row group (ranks
    0, 1 and 2, 3) return the same bits of their own lanes, gathered on
    every rank."""
    rows = [r["row_2x2"] for r in ranks[4]]
    assert rows[0]["status"] == ["OPTIMAL"] * ROW_BATCH, rows[0]
    assert max(rows[0]["err"]) <= 1e-4, rows[0]
    for r in rows[1:]:
        assert r["lane_digests"] == rows[0]["lane_digests"]


def test_row_sharded_2x2_mesh_matches_1x2(ranks):
    """The gathered (2, 2) result agrees with the (1, 2) run within 1e-6
    relative on every objective."""
    a = np.array(ranks[4][0]["row_2x2"]["objective"])
    b = np.array(ranks[2][0]["row"]["objective"])
    assert (np.abs(a - b) / (1 + np.abs(b))).max() <= 1e-6, (a, b)


def test_sharded_route_batched_one_process():
    """``linsys="sharded"`` at p = 1 over a batch of three lanes: each lane
    within 1e-6 of the dense route's objective and of its own run at B = 1,
    with the same status and iterations (a batched library product may
    round a lane differently from the unbatched one, so not bit for bit)."""
    _, lps = _row_lps()
    lps = lps[:3]
    O = ipx_torch.SolverOptions
    opts = O(linsys="sharded", augmented_fallback=False)
    mesh = meshlib.make_mesh()
    batch = ipx_torch.solve_batch(lps, options=opts, device="cpu", mesh=mesh)
    alone = [ipx_torch.solve_batch([lp], options=opts, device="cpu",
                                   mesh=mesh)[0] for lp in lps]
    dense = ipx_torch.solve_batch(lps, options=O(augmented_fallback=False),
                                  device="cpu")
    for got, one, d in zip(batch, alone, dense):
        assert got.status_name == one.status_name == "OPTIMAL"
        assert got.iterations == one.iterations
        for ref in (one.objective, d.objective):
            assert abs(got.objective - ref) <= 1e-6 * (1 + abs(ref))


def test_batch_lp_sharding_row_axis():
    """A rank's share on a (2, 2) mesh: its half of the lanes, each A's
    column block by its row index; c, b and the offset whole per lane.  An
    n or a batch that the mesh does not divide raises ValueError."""
    def mesh(b, r):
        return meshlib.Mesh(shape={"batch": 2, "row": 2},
                            coords={"batch": b, "row": r},
                            groups={"batch": None, "row": None})
    idx = meshlib.batch_lp_sharding(mesh(1, 1), 4, 64)
    assert idx == dict(c=slice(2, 4), A=(slice(2, 4), slice(None),
                                         slice(32, 64)),
                       b=slice(2, 4), obj_offset=slice(2, 4))
    assert meshlib.batch_lp_sharding(mesh(0, 1), 4, 64)["A"][2] == slice(32,
                                                                         64)
    with pytest.raises(ValueError, match="not divisible"):
        meshlib.batch_lp_sharding(mesh(0, 0), 4, 63)
    with pytest.raises(ValueError, match="not divisible"):
        meshlib.batch_lp_sharding(mesh(0, 0), 4)
    with pytest.raises(ValueError, match="not divisible"):
        meshlib.batch_lp_sharding(mesh(0, 0), 3, 64)


def test_solve_batch_refuses_a_share_without_its_mesh():
    """A share whose A holds a column block of its LPs, given to solve_batch
    without its mesh (or with the wrong one), raises ValueError instead of
    solving another LP."""
    _, lps = _row_lps()
    blp = ipx_torch.api.batched.stack_lps(lps)
    share = ipx_torch.LP(c=blp.c, A=blp.A[:, :, :32].contiguous(), b=blp.b,
                         obj_offset=blp.obj_offset)
    with pytest.raises(ValueError, match="mesh"):
        ipx_torch.solve_batch(share, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        ipx_torch.solve_batch(share, device="cpu", mesh=meshlib.make_mesh())


def test_sharded_needs_an_active_mesh():
    """Outside ``use_mesh`` the route raises the RuntimeError ``ipx``
    raises, directly and through an entry point that sets no mesh."""
    A = torch.ones(1, 2, 4)
    d2 = torch.ones(1, 4)
    with pytest.raises(RuntimeError, match="requires an active mesh"):
        normal_eq.factor(A, d2, ipx_torch.SolverOptions(linsys="sharded"))
    lp = ipx_torch.make_lp([1.0, 1.0, 1.0], [[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]],
                           [1.0, 1.0], device="cpu")
    with pytest.raises(RuntimeError, match="requires an active mesh"):
        ipx_torch.solve_batch([lp], device="cpu", options=ipx_torch.SolverOptions(
            linsys="sharded", augmented_fallback=False))


def test_blocked_products_match_whole(monkeypatch):
    """A product whose matrix needs a copy of more than ``COPY_BYTES`` (a
    bf16 A met by a float32 or float64 vector) makes it a block of rows at
    a time: the same result as one copy of the whole, A w and A^T v, in
    float32 and float64 sums, as at config 4 (8 and 16 blocks): the float64
    sums bit for bit, the float32 ones within 1e-6 of the largest entry (the
    CPU's library sums a product in an order that depends on its shape)."""
    from ipx_torch import numerics
    rng = np.random.default_rng(2)
    A = torch.tensor(rng.standard_normal((1, 96, 160)),
                     dtype=torch.float32).to(torch.bfloat16)
    w = torch.tensor(rng.standard_normal((1, 160)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((1, 96)), dtype=torch.float32)
    whole = [numerics.mv(A, w), numerics.mv(A.mT, v),
             numerics.mv64(A, w), numerics.mv64(A.mT, v)]
    monkeypatch.setattr(numerics, "COPY_BYTES", 7 * 160 * 4)
    blocked = [numerics.mv(A, w), numerics.mv(A.mT, v),
               numerics.mv64(A, w), numerics.mv64(A.mT, v)]
    for got, ref in zip(blocked, whole):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        if ref.dtype == torch.float64:
            assert torch.equal(got, ref)
        else:
            assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()


def test_large_generator_builds_its_optimum():
    """``random_feasible_large_device`` on the CPU: A holds bf16 values, b =
    A x* and c = A^T y* + s* within float32 rounding of the float64
    products of the stored A, and ``solve_large`` reaches its optimum."""
    from ipx_torch.problem.generate import random_feasible_large_device
    g = torch.Generator().manual_seed(0)
    lp, star = random_feasible_large_device(64, 128, g, device="cpu")
    assert lp.A.dtype == torch.bfloat16 and lp.c.dtype == torch.float32
    sol = ipx_torch.solve_large(lp, device="cpu",
                                options=ipx_torch.SolverOptions(
                                    a_storage="bfloat16"))
    assert sol.optimal, sol.status_name
    assert abs(sol.objective - star) / (1 + abs(star)) <= 5e-6


def test_factor_lt_takes_m_above_max_m():
    """The full-matrix factor takes any multiple of 128 (m = 4992, the first
    above MAX_M): its plain version on the CPU, held to the matrix on a few
    vectors; the pair-solve still refuses that m."""
    m = (pk.MAX_M // pk.NB + 1) * pk.NB
    assert m == 4992
    rng = np.random.default_rng(0)
    G = torch.tensor(rng.standard_normal((m, 32)) / 8.0, dtype=torch.float32)
    M = G @ G.T
    M.diagonal().add_(1.0)
    LT, W = pk.factor_lt_batched(M.unsqueeze(0))
    assert LT.shape == (1, m, m) and W.shape == (1, m // pk.NB, pk.NB, pk.NB)
    V = torch.tensor(rng.standard_normal((m, 4)), dtype=torch.float32)
    err = (LT[0].T @ (LT[0] @ V) - M @ V).abs().max() / (M @ V).abs().max()
    assert float(err) <= 1e-5
    with pytest.raises(ValueError, match="exceeds"):
        pk.chol_solve_batched_lt(LT, W, torch.zeros(1, m))


if __name__ == "__main__":
    rank, world, port = (int(a) for a in sys.argv[1:4])
    print("RESULT " + json.dumps(_worker(rank, world, port)), flush=True)
