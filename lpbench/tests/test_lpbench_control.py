"""The comparison that decides ``correct`` fails what it must.

The control (the constructed optimum at TF32 precision, in the program's
place) fails the limits where the port's own answers pass; the port with
float32 A stored as bfloat16 fails the large LP's.  Then whole runs, the
card's look skipped (the port's plain versions on the CPU), with the timed
path broken underneath, must come out not correct: a step that returns its
state unchanged, half of a batch left out or answered by the other half, an
answer altered where it is produced."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import ipx_torch
from ipx_torch import api
from ipx_torch.ipm import mehrotra
from lpbench import control, harness, reference


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      -3.0e-5, 0.0])
    r = control.tf32(x)
    assert r.tolist()[:4] == [1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9]
    assert r[5] == 0 and r[4] < 0
    assert ((control.tf32(torch.randn(1000)).view(torch.int32)
             & 0x1FFF) == 0).all()


@pytest.mark.parametrize("workload, changed", [
    ("dense_lp.batch256", {}),
    ("large_lp.single", {"a_storage": "bfloat16"})])
def test_control_fails_where_the_port_passes(tiny_here, bench_all,
                                             workload, changed):
    recs = []
    control.readings(workload, [3, 2 ** 32 + 9], True, changed, "cpu",
                     here=tiny_here, bench=bench_all, emit=recs.append)
    by = {}
    for r in recs:
        by.setdefault(r["kind"], []).append(r)
    assert all(r["failed"] == 0 for r in by["program"])
    assert all(r["failed"] == r["lps"] for r in by["control"])
    cfg = harness.cell(bench_all, workload)["config"]
    limits = harness.load_config(cfg, tiny_here)["limits"]
    for r in by["control"]:
        assert r["worst"]["rp"] > 3 * limits["rp"]
    for r in by.get("program_control", []):
        assert r["failed"] == r["lps"]


def broken_run(tiny_here, bench_all, workload):
    return harness.run(workload, 2 ** 33 + 1, 0.2, False, device="cpu",
                       bench=bench_all, here=tiny_here)


CELLS = ("dense_lp.batch256", "large_lp.single")


@pytest.mark.parametrize("workload", CELLS)
def test_unbroken_run_is_correct(tiny_here, bench_all, workload):
    assert broken_run(tiny_here, bench_all, workload)["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_step_that_returns_its_state(tiny_here, bench_all, workload,
                                     monkeypatch):
    def unchanged(lp, state, opts, fac_aat=None, fac=None):
        return dataclasses.replace(state, it=state.it + 1)
    monkeypatch.setattr(mehrotra, "step_masked", unchanged)
    res = broken_run(tiny_here, bench_all, workload)
    assert not res["correct"]
    assert res["checks"]["unsolved"]["value"] == 100.0


@pytest.mark.parametrize("answers", ["half_missing", "half_repeated"])
def test_half_of_the_batch_left_out(tiny_here, bench_all, monkeypatch,
                                    answers):
    solve_batch = ipx_torch.solve_batch

    def half(lp, options=None, device="cuda"):
        B = lp.A.shape[0]
        h = B // 2
        first = ipx_torch.LP(c=lp.c[:h], A=lp.A[:h], b=lp.b[:h],
                             obj_offset=lp.obj_offset[:h])
        sols = solve_batch(first, options=options, device=device)
        return sols if answers == "half_missing" else sols + sols
    monkeypatch.setattr(ipx_torch, "solve_batch", half)
    res = broken_run(tiny_here, bench_all, "dense_lp.batch256")
    assert not res["correct"]
    assert res["failed"] >= res["attempted"] // 2


@pytest.mark.parametrize("workload, where", [
    ("dense_lp.batch256", "_states_to_solutions"),
    ("large_lp.single", "_sharded_solutions")])
def test_answer_altered_where_produced(tiny_here, bench_all, monkeypatch,
                                       workload, where):
    made = getattr(api, where)

    def altered(lp, st):
        sols = made(lp, st)
        x = sols[-1].x.copy()
        x[int(np.argmax(x))] *= 1 + 1e-3
        sols[-1] = dataclasses.replace(sols[-1], x=x)
        return sols
    monkeypatch.setattr(api, where, altered)
    res = broken_run(tiny_here, bench_all, workload)
    assert not res["correct"]
    assert res["checks"]["rp"]["value"] > res["checks"]["rp"]["limit"]


def test_verdict_counts_each_failing_lp_once():
    per_lp = {k: np.zeros(4) for k in reference.PER_LP}
    per_lp["optimal"][:3] = 1
    per_lp["rp"][1] = 1.0
    per_lp["obj"][1] = 1.0
    per_lp["rd"][3] = 9.0       # not judged: no optimum claimed
    limits = dict.fromkeys(reference.NUMBERS, 0.5)
    limits["unsolved"] = 30.0
    failed, checks = reference.verdict(per_lp, limits)
    assert failed == 2
    assert checks["unsolved"]["value"] == 25.0
    assert checks["rp"] == {"value": 1.0, "limit": 0.5}
    assert checks["rd"]["value"] == 0.0
    assert not reference.correct(checks)
    per_lp["rp"][1] = per_lp["obj"][1] = 0.0
    assert reference.correct(reference.verdict(per_lp, limits)[1])
