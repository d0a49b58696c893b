"""One run of one cell of the benchmark of ``ipx_torch``.

Everything that belongs to one configuration, traffic mix, entry, metric or
kernel entry sits in a file of its own, found by name:

- ``configs/<config>.json``: the deployment (sizes, A's storage dtype, the
  solver options its users run, the limits its answers are held to);
- ``mixes/<mix>.json``: the traffic (the entry, LPs per call, the warm-up);
- ``drivers/<entry>.py``: how one call of that entry is made;
- ``metrics/<metric>.py``: ``read(records)`` of one metric, end-to-end
  (from the run's own clock and counts) or per-layer (from the traced
  run's records);
- ``work/<kernel entry>.py``: ``MODULE`` and ``work(*args, **kwargs)`` ->
  (operations, bytes) of one kernel entry of the port.

A run sets up (imports, the port's kernels loaded or built, a warm-up),
calls the cell's entry back to back, each call on a fresh input made from
``(seed, call)`` outside the clock, until the calls' summed time reaches
``seconds`` (the call that crosses the line completes and counts), then
judges every answer with ``reference.judge`` on inputs made again from the
same seeds.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ipx")
WARM_UP_CALL = 1 << 40      # the warm-up's call index: no timed call has it


class Refused(RuntimeError):
    """A run that must print no result (no card, no program, a forbidden
    module loaded); ``code`` is the exit code."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    """The ``workloads`` entry ``name`` with its ``end_to_end`` and
    ``per_layer`` metrics: those without a ``workloads`` key, and those
    that list the cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = dict(cells[name])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    w["end_to_end"] = mine(bench["end_to_end"])
    w["per_layer"] = mine(bench["per_layer"])
    return w


def load_config(name: str, here: Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def load_mix(name: str, here: Path = HERE) -> dict:
    return load_json(here / "mixes" / f"{name}.json")


def load_file(path: Path, label: str):
    """The module in ``path``, loaded by its file name (metric names hold
    dots, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(entry: str, here: Path = HERE):
    return load_file(here / "drivers" / f"{entry}.py",
                     f"lpbench_driver_{entry}")


def load_metric(name: str, here: Path = HERE):
    """``read(records) -> number or None`` of the metric ``name``."""
    return load_file(here / "metrics" / f"{name}.py",
                     "lpbench_metric_" + name.replace(".", "_")).read


def load_work(entry: str, here: Path = HERE):
    """The work file of a kernel entry: ``MODULE``, the port's module that
    holds the entry, and ``work(*args, **kwargs) -> (operations, bytes)``."""
    return load_file(here / "work" / f"{entry}.py", f"lpbench_work_{entry}")


def kernel_entries(here: Path = HERE) -> list:
    return sorted(p.stem for p in (here / "work").glob("*.py")
                  if not p.stem.startswith("_"))


def forbidden_modules() -> list:
    """Top-level names of loaded modules that no run may load, compared
    whole (``ipx_torch`` is the port; ``ipx`` is the JAX package)."""
    tops = {k.split(".")[0] for k in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def program_options(program, spec: dict):
    """The ``SolverOptions`` a configuration states: ``preset``
    (``"default"`` or ``"throughput"``) with the other keys on top."""
    kw = {k: v for k, v in spec.items() if k != "preset"}
    preset = spec.get("preset", "default")
    if preset == "throughput":
        return program.SolverOptions.throughput(**kw)
    if preset == "default":
        return program.SolverOptions(**kw)
    raise ValueError(f"unknown options preset {preset!r}")


def answers_of(program, solutions) -> dict:
    """The host arrays of a call's Solutions, in the reference's terms:
    what each status claims (an optimum; infeasibility or unboundedness),
    the iterate and the objective."""
    import numpy as np
    S = program.Status
    codes = [int(s.status) for s in solutions]
    return dict(
        x=[s.x for s in solutions], y=[s.y for s in solutions],
        s=[s.s for s in solutions],
        objective=np.array([s.objective for s in solutions], dtype=float),
        optimal=np.array([c == int(S.OPTIMAL) for c in codes], dtype=bool),
        infeasible=np.array([c in (int(S.PRIMAL_INFEASIBLE),
                                   int(S.DUAL_INFEASIBLE)) for c in codes],
                            dtype=bool),
        status=codes, iterations=[int(s.iterations) for s in solutions])


def stack_answers(ans: dict) -> dict:
    """The answer lists stacked into arrays where their shapes agree (a
    misshapen answer stays a list: the reference reports it missing)."""
    import numpy as np
    out = dict(ans)
    for k in ("x", "y", "s"):
        shapes = {np.shape(v) for v in ans[k]}
        if len(shapes) == 1 and ans[k]:
            out[k] = np.stack(ans[k])
    return out


def device_info(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> str | None:
    """The card's name and power limit (``nvidia-smi``), reported beside
    every share: a card set below its maximum runs slower under load."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", bench: dict | None = None, here: Path = HERE,
        t_start: float | None = None, log=sys.stderr) -> dict:
    """One run of ``workload``; returns the result line's object.  On a
    card only: ``device="cpu"`` drives the same loop on the port's plain
    versions for the rehearsals, and reads no device metric."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark(here.parent) if bench is None else bench
    w = cell(bench, workload)
    cfg, mix = load_config(w["config"], here), load_mix(w["traffic"], here)
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false", 3)
        if torch.cuda.device_count() < w["chips"]:
            raise Refused(f"{torch.cuda.device_count()} card(s), the cell "
                          f"asks for {w['chips']}", 3)
    try:
        import ipx_torch as program
        from ipx_torch.kernels import _build
    except ImportError as e:
        raise Refused(f"the program ipx_torch does not import: {e}", 4)
    if dev.type == "cuda":
        _build.build_all()
    from lpbench import reference, tracing
    driver = load_driver(mix["entry"], here)
    opts = program_options(program, cfg["options"])
    driver.warm_up(program, cfg, mix, opts, dev, seed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    tracer = (tracing.Tracer(dev, here, mix["entry"])
              if trace else tracing.NoTracer())
    calls = []
    spent = 0.0
    with tracer:
        while spent < seconds:
            inp = driver.inputs(cfg, mix, seed, len(calls), dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            with tracer.call():
                t0 = time.perf_counter()
                sols = driver.call(program, inp, opts, dev)
                dt = time.perf_counter() - t0
            spent += dt
            n_lps = inp["A"].shape[0]
            print(f"call {len(calls)}: {n_lps} LPs, {dt:.4f} s", file=log)
            del inp
            calls.append(dict(seconds=dt, lps=n_lps,
                              answers=answers_of(program, sols)))
            del sols
    device_fields = device_info(dev)
    found = forbidden_modules()
    if found:
        raise Refused(f"modules loaded that no run may load: {found}", 5)
    records = tracer.records(calls)
    del tracer
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    per_call = []
    for k, c in enumerate(calls):
        inp = driver.inputs(cfg, mix, seed, k, dev)
        per_call.append(reference.judge(inp, stack_answers(c["answers"]),
                                        dev))
        del inp
    per_lp = reference.merge(per_call)
    failed, checks = reference.verdict(per_lp, cfg["limits"])
    attempted = sum(c["lps"] for c in calls)

    records.update(setup_s=setup_s, seconds=spent, attempted=attempted,
                   passed=attempted - failed)
    metrics = {}
    for m in w["per_layer"] if trace else w["end_to_end"]:
        v = load_metric(m["name"], here)(records)
        if v is None:
            print(f"metric {m['name']}: nothing to read", file=log)
        else:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if dev.type == "cuda":
        device_fields["power_limit"] = power_limit()
        if trace and records.get("device"):
            device_fields["busy_s"] = records["device"]["busy_s"]
            device_fields["window_s"] = records["device"]["window_s"]
    result = {"correct": reference.correct(checks) and attempted > 0,
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_fields}
    if trace and records.get("breakdown"):
        result["breakdown"] = records["breakdown"]
    result["checks"] = checks
    return result
