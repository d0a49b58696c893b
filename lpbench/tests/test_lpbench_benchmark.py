"""``BENCHMARK.json`` against the contract it is checked by: its keys,
names and units, every file it names, and each configuration's limits
against the options it states."""
from __future__ import annotations

import json
import re

import pytest
import torch

from lpbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["lpbench"]
    assert bench["command"] == ["python3", "lpbench/run.py"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    r = bench["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    # a full check: 2 + 14 runs a cell, 24 cells at most, each run
    # run_seconds + 60 s, 2 x 90 s of compile a cell, 1200 s spare
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["source"].startswith("https://")
        assert c["file"] == f"lpbench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert cfg["source"] == c["source"]


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(names)
    configs = {c["name"] for c in bench["configs"]}
    assert configs == {w["config"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and line(w["why"])
        assert (harness.HERE / "mixes" / f"{w['traffic']}.json").exists()
        mix = harness.load_mix(w["traffic"])
        assert (harness.HERE / "drivers" / f"{mix['entry']}.py").exists()
        cell = harness.cell(bench, w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("name", ["dense_lp", "large_lp"])
def test_limits_are_what_the_options_state(name):
    """The gap and residual limits are the tolerance the configuration's
    options promise, as exact values of what the solver tests in float32:
    no looser than the rounding of that test."""
    import ipx_torch
    cfg = harness.load_config(name)
    g, lim = cfg["guarantees"], cfg["limits"]
    opts = harness.program_options(ipx_torch, cfg["options"])
    assert (opts.tol, opts.tol_feas, opts.feas_eps_mult, opts.dtype) == (
        g["tol"], g["tol_feas"], g["feas_eps_mult"], g["dtype"])
    eps = torch.finfo(getattr(torch, g["dtype"])).eps
    u = eps / 2
    assert lim["gap"] == g["tol"] * (1 + cfg["n"] * u)
    assert lim["rp"] == lim["rd"] == max(g["tol_feas"],
                                         g["feas_eps_mult"] * eps) + u
    assert lim["missing"] == lim["wrong_status"] == lim["negative"] == 0
    assert 0 < lim["unsolved"] < 100
    assert 0 < lim["obj"] < 1e-3
