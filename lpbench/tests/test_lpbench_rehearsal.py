"""One tiny end-to-end run of each driver on CPU tensors with the port's
plain versions, untraced and traced, and the shape of the result line."""
from __future__ import annotations

import io
import json

import pytest

from lpbench import harness

CELLS = ("dense_lp.batch256", "large_lp.single")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
DEVICE_METRICS = ("kernels.roofline.batch", "kernels.roofline.single",
                  "device.idle.batch", "device.idle.single")


def run(tiny_here, bench, workload, trace, seed=2 ** 33 + 5):
    log = io.StringIO()
    res = harness.run(workload, seed, 0.5, trace, device="cpu", bench=bench,
                      here=tiny_here, log=log)
    return res, log.getvalue()


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run(tiny_here, bench_all, workload):
    res, log = run(tiny_here, bench_all, workload, False)
    assert list(res) == KEYS
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    cell = harness.cell(bench_all, workload)
    names = {m["name"] for m in cell["end_to_end"]}
    assert set(res["metrics"]) == names and "setup_s" in names
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(res["checks"]) == {"missing", "wrong_status", "unsolved",
                                  "negative", "gap", "rp", "rd", "obj"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    assert "call 0:" in log
    json.dumps(res)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run(tiny_here, bench_all, workload):
    res, log = run(tiny_here, bench_all, workload, True)
    assert res["correct"]
    cell = harness.cell(bench_all, workload)
    names = {m["name"] for m in cell["per_layer"]}
    # off the card nothing is read under a device metric's name
    assert set(res["metrics"]) == names - set(DEVICE_METRICS)
    for name in names & set(DEVICE_METRICS):
        assert f"metric {name}: nothing to read" in log
    assert "busy_s" not in res["device"] and "breakdown" not in res


def test_same_seed_same_inputs(tiny_here, bench_all):
    cfg = harness.load_config("dense_lp", tiny_here)
    mix = harness.load_mix("batch256", tiny_here)
    drv = harness.load_driver("solve_batch", tiny_here)
    import torch
    a = drv.inputs(cfg, mix, 2 ** 31 + 11, 3, torch.device("cpu"))
    b = drv.inputs(cfg, mix, 2 ** 31 + 11, 3, torch.device("cpu"))
    c = drv.inputs(cfg, mix, 2 ** 31 + 11, 4, torch.device("cpu"))
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["A"], c["A"])


@pytest.mark.card
def test_card_run(card, bench_all):
    """Both drivers for a second on the card, the kernels built or
    loaded."""
    for workload in CELLS:
        res = harness.run(workload, 7, 1.0, False, bench=bench_all)
        assert res["correct"], res["checks"]
        assert res["device"]["platform"] == "gpu"
