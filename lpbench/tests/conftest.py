"""Shared fixtures of the benchmark's tests: the checkout's root on the
path, one CPU thread for the port's plain versions, and a copy of
``lpbench/`` whose configurations and mixes are cut to sizes the CPU runs
in about a second."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from lpbench import harness  # noqa: E402

torch.set_num_threads(1)

TINY = {"dense_lp": (128, 256), "large_lp": (128, 256)}


@pytest.fixture(scope="session")
def bench() -> dict:
    return harness.load_benchmark(ROOT)


# the large LP's cell, left out of BENCHMARK.json (PERF.md, Open questions:
# its solve times spread over seeds far past any bound), kept runnable: its
# driver, configuration, mix and metric files are in place
LARGE_CELL = {
    "workload": {"name": "large_lp.single", "config": "large_lp",
                 "traffic": "single", "chips": 1, "why": "the large LP"},
    "end_to_end": {"name": "solve_s", "unit": "s", "better": "lower",
                   "bound": 0.25, "source": "host_clock",
                   "workloads": ["large_lp.single"]},
    "per_layer": [
        ("api.outside_loop_s.single", "s", "api"),
        ("ipm.iters.single", "iterations", "ipm"),
        ("linsys.precond_ms.large", "ms", "linsys"),
        ("kernels.roofline.single", "%", "kernels"),
        ("device.idle.single", "%", "device")],
}


@pytest.fixture(scope="session")
def bench_all(bench) -> dict:
    """BENCHMARK.json with the large LP's cell added."""
    out = json.loads(json.dumps(bench))
    out["workloads"].append(LARGE_CELL["workload"])
    out["end_to_end"].insert(0, LARGE_CELL["end_to_end"])
    for name, unit, layer in LARGE_CELL["per_layer"]:
        out["per_layer"].append({
            "name": name, "unit": unit, "better": "lower",
            "source": "program_span", "layer": layer, "moves": "solve_s",
            "workloads": ["large_lp.single"]})
    return out


@pytest.fixture(scope="session")
def tiny_here(tmp_path_factory) -> Path:
    """A copy of ``lpbench/`` with every configuration at m=128, n=256,
    4 LPs a batch call and warm-ups of the same size."""
    here = tmp_path_factory.mktemp("tiny") / "lpbench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, (m, n) in TINY.items():
        cfg = harness.load_config(name, here)
        cfg["m"], cfg["n"] = m, n
        (here / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    mix = harness.load_mix("batch256", here)
    mix["lps_per_call"], mix["warmup"] = 4, {"lps": 2}
    (here / "mixes" / "batch256.json").write_text(json.dumps(mix))
    mix = harness.load_mix("single", here)
    mix["warmup"] = {"m": 128, "n": 256}
    (here / "mixes" / "single.json").write_text(json.dumps(mix))
    return here


@pytest.fixture
def card():
    """Skips a test that needs the card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.device("cuda")
