"""A configuration, a mix and a per-layer metric added as new files under
new names are found by name, without an edit to any file there."""
from __future__ import annotations

import json

import torch

from lpbench import harness


def test_new_files_are_found(tiny_here, bench):
    cfg = harness.load_config("dense_lp", tiny_here)
    cfg["name"], cfg["m"], cfg["n"] = "dense_small", 128, 384
    (tiny_here / "configs" / "dense_small.json").write_text(json.dumps(cfg))
    mix = harness.load_mix("batch256", tiny_here)
    mix["name"], mix["lps_per_call"] = "batch3", 3
    (tiny_here / "mixes" / "batch3.json").write_text(json.dumps(mix))
    (tiny_here / "metrics" / "ipm.first_iters.small.py").write_text(
        "def read(records):\n"
        "    return float(records['calls'][0]['iterations'][0])\n")
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "dense_small.batch3",
                             "config": "dense_small", "traffic": "batch3",
                             "chips": 1, "why": "a test"})
    new["per_layer"].append({"name": "ipm.first_iters.small",
                             "unit": "iterations", "better": "lower",
                             "source": "program_counter", "layer": "ipm",
                             "moves": "lps_per_s",
                             "workloads": ["dense_small.batch3"]})
    for m in new["end_to_end"]:
        if m["name"] == "lps_per_s":
            m["workloads"].append("dense_small.batch3")
    w = harness.cell(new, "dense_small.batch3")
    assert [m["name"] for m in w["per_layer"]] == ["ipm.first_iters.small"]
    res = harness.run("dense_small.batch3", 5, 0.2, True, device="cpu",
                      bench=new, here=tiny_here)
    assert res["correct"] and res["attempted"] % 3 == 0
    assert res["metrics"]["ipm.first_iters.small"]["value"] >= 1
    inp = harness.load_driver("solve_batch", tiny_here).inputs(
        cfg, mix, 5, 0, torch.device("cpu"))
    assert tuple(inp["A"].shape) == (3, 128, 384)


def test_renamed_function_reads_nothing(tiny_here, bench, monkeypatch):
    """A function the tracer wraps that is gone from the port: a line on
    stderr and no metric, not a crash."""
    from ipx_torch.linsys import schur
    monkeypatch.delattr(schur, "_precond")
    import io
    log = io.StringIO()
    monkeypatch.setattr("sys.stderr", log)
    res = harness.run("dense_lp.batch256", 3, 0.2, True, device="cpu",
                      bench=bench, here=tiny_here, log=log)
    assert res["correct"]
    assert "schur._precond not found" in log.getvalue()
