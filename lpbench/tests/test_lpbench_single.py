"""A CPU rehearsal of the cell ``dense_lp.single`` on a copy of ``lpbench/``
cut to m=128, n=256 with 2 + 2 redundant rows: the untraced run's result
line, the readers of the program's spans with and without a recorded
summary, and the TF32 control failing the configuration's limits where
the port's own answers pass."""
from __future__ import annotations

import io
import json
import shutil

import numpy as np
import pytest
import torch

from lpbench import control, gen_host, harness, program_spans

CELL = "dense_lp.single"
CONFIG = "dense_lp_presolve"
READERS = {"api.presolve_s.solve": "api.presolve",
           "api.presolve_rank_s.solve": "api.presolve.rank",
           "api.postsolve_s.solve": "api.postsolve"}


@pytest.fixture(scope="module")
def single_here(tmp_path_factory):
    here = tmp_path_factory.mktemp("single") / "lpbench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = harness.load_config(CONFIG, here)
    cfg.update(m=128, n=256, duplicate_rows=2, combined_rows=2)
    (here / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    return here


@pytest.fixture(autouse=True)
def _no_summaries():
    program_spans.SUMMARIES.clear()
    yield
    program_spans.SUMMARIES.clear()


def test_untraced_run(single_here, bench):
    log = io.StringIO()
    res = harness.run(CELL, 2 ** 33 + 19, 0.5, False, device="cpu",
                      bench=bench, here=single_here, log=log)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"lps_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["checks"]["negative"]["value"] == 0
    assert "call 0: 1 LPs" in log.getvalue()
    # no profiler, so the program's spans were never opened
    assert program_spans.SUMMARIES == []
    json.dumps(res)


def test_traced_run_off_the_card(single_here, bench):
    """On the CPU the harness starts no profiler: the program's spans are
    never opened and the device's readers find nothing; the harness's own
    wrappers still read the loop's time and the iterations."""
    log = io.StringIO()
    res = harness.run(CELL, 5, 0.2, True, device="cpu", bench=bench,
                      here=single_here, log=log)
    assert res["correct"]
    assert set(res["metrics"]) == {"api.outside_loop_s.single",
                                   "ipm.iters.single"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    for name in [*READERS, "kernels.roofline.single", "device.idle.single"]:
        assert f"metric {name}: nothing to read" in log.getvalue()


def test_readers_read_a_recorded_call(single_here):
    """Under a profiler the driver records the call's spans, and each
    reader returns that span's seconds; with no summary, None."""
    import ipx_torch
    readers = {n: harness.load_metric(n, single_here) for n in READERS}
    assert all(r({}) is None for r in readers.values())
    cfg = harness.load_config(CONFIG, single_here)
    mix = harness.load_mix("solve1", single_here)
    drv = harness.load_driver(mix["entry"], single_here)
    cpu = torch.device("cpu")
    opts = harness.program_options(ipx_torch, cfg["options"])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        drv.call(ipx_torch, drv.inputs(cfg, mix, 3, 0, cpu), opts, cpu)
    (summary,) = program_spans.SUMMARIES
    for name, span in READERS.items():
        assert readers[name]({}) == summary["spans"][span]["seconds"] > 0
    assert summary["counters"]["api.presolve.rows_dropped"] \
        + summary["counters"]["api.presolve.rank_dropped"] == 4
    # a summary without the spans, as a program without them records
    program_spans.SUMMARIES[:] = [{"calls": 1, "spans": {}, "counters": {}}]
    assert all(r({}) is None for r in readers.values())


def test_control_fails_where_the_port_passes(single_here, bench):
    recs = []
    control.readings(CELL, [3, 2 ** 32 + 9], True, {}, "cpu",
                     here=single_here, bench=bench, emit=recs.append)
    by = {}
    for r in recs:
        by.setdefault(r["kind"], []).append(r)
    limits = harness.load_config(CONFIG, single_here)["limits"]
    assert all(r["failed"] == 0 for r in by["program"])
    for r in by["control"]:
        assert r["failed"] == r["lps"] == 1
        assert r["worst"]["rp"] > 3 * limits["rp"]
        assert r["worst"]["rd"] > 3 * limits["rd"]


def test_same_seed_same_instance(single_here):
    cfg = harness.load_config(CONFIG, single_here)
    a = gen_host.instance(cfg, 2 ** 31 + 11, 3)
    b = gen_host.instance(cfg, 2 ** 31 + 11, 3)
    c = gen_host.instance(cfg, 2 ** 31 + 11, 4)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["A"], c["A"])
