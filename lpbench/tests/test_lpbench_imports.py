"""Nothing the benchmark runs loads JAX or the JAX package: a scan of
every import under ``lpbench/`` by top-level name, the reference and the
generator free of the program, the run's own check of ``sys.modules``, and
a run in a directory that holds only the benchmark's files."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from lpbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "ipx"}
ROOT = harness.ROOT


def imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not \
                node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_ipx():
    files = sorted(harness.HERE.rglob("*.py"))
    assert len(files) > 20
    for p in files:
        assert not imports(p) & FORBIDDEN, p


def test_yardstick_imports_nothing_of_the_program():
    for name in ("reference.py", "gen.py"):
        assert "ipx_torch" not in imports(harness.HERE / name), name
    for p in sorted((harness.HERE / "work").glob("*.py")):
        assert "ipx_torch" not in imports(p), p
    for p in sorted((harness.HERE / "metrics").glob("*.py")):
        assert "ipx_torch" not in imports(p), p


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ipx_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ipx.kernels", sys)
    assert harness.forbidden_modules() == ["ipx"]


def test_run_module_loads_no_forbidden_module():
    """What a run loads, the port included, in a fresh process."""
    code = ("import lpbench.run, lpbench.tracing, lpbench.control\n"
            "import lpbench.harness as h, ipx_torch\n"
            "from ipx_torch.kernels import _build\n"
            "for e in ('solve_batch', 'solve_large'): h.load_driver(e)\n"
            "for e in h.kernel_entries(): h.load_work(e)\n"
            "for m in h.load_benchmark()['per_layer']: "
            "h.load_metric(m['name'])\n"
            "print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_the_program_exits_nonzero(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "lpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "lpbench/run.py", "--workload", "dense_lp.batch256",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
