"""The slice as a whole: ipx_torch.solve_batch(device="cpu") against
ipx.solve_batch on the same instances (numpy, seeded), under the slice's
options  throughput(chol_backend="xla", a_storage="bfloat16",
augmented_fallback=False).

f64: same status per lane and objectives equal to 1e-8.  f32: every lane
OPTIMAL in both packages and objectives within 1e-5 of the constructed
optimum; f32 iteration counts are never compared lane by lane (they
reshuffle under any change of rounding order).
"""
import numpy as np
import pytest
import torch

import ipx
import ipx_torch
from ipx.problem.generate import random_feasible_lp
from ipx.problem.lp import make_lp as jmake_lp
from ipx_torch.problem.generate import (random_feasible_batch_device,
                                        random_feasible_lp as t_random_lp)
from ipx_torch.problem.lp import make_lp as tmake_lp

torch.set_num_threads(1)


def _rel(a, b):
    return abs(a - b) / (1 + abs(b))


def _bf16_instances(B, m, n, seed0):
    """Instances whose A is bf16-representable, b and c rebuilt from the
    rounded A so the constructed optimum is exact."""
    out = []
    for i in range(B):
        g = random_feasible_lp(m, n, seed=seed0 + i)
        A = torch.from_numpy(g.A).to(torch.bfloat16).double().numpy()
        b = A @ g.x_star
        c = A.T @ g.y_star + g.s_star
        out.append((c, A, b, float(c @ g.x_star)))
    return out


def test_slice_options_f32_bf16_storage():
    insts = _bf16_instances(3, 64, 128, 40)
    kw = dict(chol_backend="xla", a_storage="bfloat16",
              augmented_fallback=False)
    sj = ipx.solve_batch([jmake_lp(c, A, b) for c, A, b, _ in insts],
                         options=ipx.SolverOptions.throughput(**kw))
    st = ipx_torch.solve_batch(
        [tmake_lp(c, A, b, device="cpu") for c, A, b, _ in insts],
        options=ipx_torch.SolverOptions.throughput(**kw), device="cpu")
    assert len(st) == len(sj) == 3
    for a, b_, (_, _, _, obj) in zip(st, sj, insts):
        assert a.optimal and b_.optimal, (a.status_name, b_.status_name)
        assert _rel(a.objective, obj) <= 1e-5
        assert _rel(b_.objective, obj) <= 1e-5
        assert a.rel_gap <= 1e-6 and a.rp_rel <= 1e-5 and a.rd_rel <= 1e-5
        assert a.x.shape == (128,) and a.y.shape == (64,)
        assert a.trace.shape == (64, 8)
        assert (a.trace[:a.iterations, 0] > 0).all()


def test_f64_same_status_and_objective():
    gs = [random_feasible_lp(64, 128, seed=50 + i) for i in range(3)]
    kw = dict(dtype="float64", tol=1e-9, tol_feas=1e-9,
              augmented_fallback=False)
    sj = ipx.solve_batch([jmake_lp(g.c, g.A, g.b) for g in gs],
                         options=ipx.SolverOptions(**kw))
    st = ipx_torch.solve_batch(
        [tmake_lp(g.c, g.A, g.b, device="cpu") for g in gs],
        options=ipx_torch.SolverOptions(**kw), device="cpu")
    for a, b_, g in zip(st, sj, gs):
        assert a.status == b_.status == int(ipx_torch.Status.OPTIMAL)
        assert _rel(a.objective, b_.objective) <= 1e-8
        assert _rel(a.objective, g.obj_star) <= 1e-8
        assert _rel(a.dual_objective, g.obj_star) <= 1e-7


@pytest.mark.parametrize("kw", [
    dict(),
    dict(matvec_backend="fused"),
    dict(matvec_backend="fused", gondzio_correctors=1),
    dict(a_storage="bfloat16"),
], ids=["robust", "fused", "fused-gondzio", "xla-bf16"])
def test_other_carried_options_f32(kw):
    """Robust defaults, the fused route with f32 A, Gondzio correctors, and
    bf16 storage on the library-matmul route."""
    insts = _bf16_instances(2, 64, 128, 60)
    sols = ipx_torch.solve_batch(
        [tmake_lp(c, A, b, device="cpu") for c, A, b, _ in insts],
        options=ipx_torch.SolverOptions(augmented_fallback=False, **kw),
        device="cpu")
    for s, (_, _, _, obj) in zip(sols, insts):
        assert s.optimal, s.iteration_table()
        assert _rel(s.objective, obj) <= 1e-5


def test_batched_no_overshoot_mixed_convergence():
    """A batch whose lanes hit the cap: every lane reports at most max_iter
    iterations while other lanes keep the loop alive, in both packages."""
    gs = [random_feasible_lp(48, 96, seed=s) for s in range(4)]
    kw = dict(max_iter=4, augmented_fallback=False)
    sj = ipx.solve_batch([jmake_lp(g.c, g.A, g.b) for g in gs],
                         options=ipx.SolverOptions(**kw))
    st = ipx_torch.solve_batch(
        [tmake_lp(g.c, g.A, g.b, device="cpu") for g in gs],
        options=ipx_torch.SolverOptions(**kw), device="cpu")
    for a, b_ in zip(st, sj):
        assert a.iterations <= 4 and b_.iterations <= 4
        assert a.status == b_.status == int(ipx_torch.Status.MAX_ITER)
        assert a.iterations == b_.iterations == 4


def test_single_solve_is_a_batch_of_one():
    g = t_random_lp(50, 100, seed=3)
    o = ipx_torch.SolverOptions(augmented_fallback=False)
    one = ipx_torch.solve(g.c, g.A, g.b, options=o, presolve=False,
                          device="cpu")
    lp = tmake_lp(g.c, g.A, g.b, device="cpu")
    via_lp = ipx_torch.solve(lp, options=o, presolve=False, device="cpu")
    assert one.optimal and one.status_name == "OPTIMAL"
    assert _rel(one.objective, g.obj_star) <= 5e-6
    assert one.objective == via_lp.objective
    assert np.all(one.x > 0) and np.all(one.s > 0)
    assert "iter" in one.iteration_table().splitlines()[0]
    assert len(one.iteration_table().splitlines()) == one.iterations + 1


def test_max_iter_status_single():
    g = t_random_lp(30, 60, seed=6)
    sol = ipx_torch.solve(
        g.c, g.A, g.b, presolve=False, device="cpu",
        options=ipx_torch.SolverOptions(max_iter=2, augmented_fallback=False))
    assert sol.status == int(ipx_torch.Status.MAX_ITER)
    assert sol.iterations == 2


def test_device_generator_known_optimum():
    gen = torch.Generator(device="cpu").manual_seed(5)
    gb = random_feasible_batch_device(3, 64, 128, gen, a_storage="bfloat16",
                                      device="cpu")
    assert gb.lp.A.dtype == torch.bfloat16 and tuple(gb.lp.A.shape) == (3, 64, 128)
    A = gb.lp.A.double()
    # strict complementarity and feasibility of the constructed pair
    assert float((gb.x_star * gb.s_star).abs().max()) == 0.0
    assert ((gb.x_star > 0).sum(1) == 64).all()
    r = torch.einsum("bmn,bn->bm", A, gb.x_star.double()) - gb.lp.b.double()
    assert float(r.abs().max()) <= 1e-5
    opts = ipx_torch.SolverOptions.throughput(
        chol_backend="xla", a_storage="bfloat16", augmented_fallback=False)
    sols = ipx_torch.solve_batch(gb.lp, options=opts, device="cpu")
    for s, o in zip(sols, gb.obj_star.tolist()):
        assert s.optimal and _rel(s.objective, o) <= 1e-5
    # same seed, same batch
    gen2 = torch.Generator(device="cpu").manual_seed(5)
    gb2 = random_feasible_batch_device(3, 64, 128, gen2, a_storage="bfloat16",
                                       device="cpu")
    assert torch.equal(gb.lp.c, gb2.lp.c)


def test_stack_lps_rejects_mixed_shapes_and_empty():
    from ipx_torch.ipm.batched import stack_lps
    a = tmake_lp(np.ones(4), np.ones((2, 4)), np.ones(2), device="cpu")
    b = tmake_lp(np.ones(6), np.ones((2, 6)), np.ones(2), device="cpu")
    with pytest.raises(ValueError):
        stack_lps([a, b])
    with pytest.raises(ValueError):
        stack_lps([])
    with pytest.raises(ValueError):
        tmake_lp(np.ones(4), np.ones((2, 5)), np.ones(2), device="cpu")
    with pytest.raises(ValueError):
        ipx_torch.solve_batch(a, device="cpu", options=ipx_torch.SolverOptions(
            augmented_fallback=False))


def test_assembled_cg_operator_iterations_match_ipx():
    """cg_operator="assembled" follows the reference: on the same seeded
    instances both packages end every lane OPTIMAL under each operator and
    need the same median iterations to within one, and under "assembled"
    the same iterations lane by lane to within one.  (Whether the operator
    costs iterations shows only at larger m, where it does so in both:
    probes/assembled_cg_cpu.py on the CPU, probes/norescue_gpu.py
    --assembled on the card.)"""
    insts = _bf16_instances(8, 96, 192, 500)
    medians = {}
    for op in ("matrix_free", "assembled"):
        kw = dict(chol_backend="xla", a_storage="bfloat16",
                  augmented_fallback=False, max_iter=64, cg_operator=op)
        sj = ipx.solve_batch([jmake_lp(c, A, b) for c, A, b, _ in insts],
                             options=ipx.SolverOptions.throughput(**kw))
        st = ipx_torch.solve_batch(
            [tmake_lp(c, A, b, device="cpu") for c, A, b, _ in insts],
            options=ipx_torch.SolverOptions.throughput(**kw), device="cpu")
        for a, b_, (_, _, _, obj) in zip(st, sj, insts):
            assert a.optimal and b_.optimal, (op, a.status_name,
                                              b_.status_name)
            assert _rel(a.objective, obj) <= 1e-5
        medians[op] = (float(np.median([s.iterations for s in sj])),
                       float(np.median([s.iterations for s in st])))
        if op == "assembled":
            # the operator under test: lane by lane
            for a, b_ in zip(st, sj):
                assert abs(a.iterations - b_.iterations) <= 1, (
                    [s.iterations for s in st], [s.iterations for s in sj])
    for op, (mj, mt) in medians.items():
        assert abs(mj - mt) <= 1.0, (op, medians)
