"""Readings that the limits of ``configs/<config>.json`` are set from.

    python3 lpbench/control.py --workload <cell> --seeds 1 2 3 [--program]
        [--program-control KEY=VALUE ...] [--out FILE]

For each seed, the first call's input of a run with that seed (the cell's
own size) is made and judged three ways, each printing one JSON line of
the worst reading of every number over the call's LPs:

- ``control``: the reference's answer, the constructed optimum (x*, y*,
  s*), put in the program's place at the nearest precision below the
  configuration's float32 with TF32 off: each entry rounded to TF32 (10
  bits of mantissa), the objective its own c.x.  It has to fail;
- with ``--program``: the port's own answer on that input (the sound
  readings; no window, one call a seed, all seeds in one process);
- with ``--program-control``: the port with those options changed, such as
  ``a_storage=bfloat16`` (its own lower-precision path) on a float32 A.

Runs on a card (the port's kernels) or with ``--device cpu`` on the plain
versions at the sizes a test can hold.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from lpbench import harness, reference  # noqa: E402


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) on TF32's 10 bits of
    mantissa, as a float32 tensor."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def control_answers(inp: dict) -> dict:
    """The constructed optimum at TF32 precision, as answers."""
    host = lambda t: tf32(t).to(torch.float64).cpu().numpy()
    x, y, s = host(inp["x_star"]), host(inp["y_star"]), host(inp["s_star"])
    c = inp["c"].to(torch.float64).cpu().numpy()
    off = inp["obj_offset"].to(torch.float64).cpu().numpy()
    return dict(x=x, y=y, s=s, objective=(c * x).sum(-1) + off,
                optimal=np.ones(len(x), dtype=bool),
                infeasible=np.zeros(len(x), dtype=bool))


def _value(text: str):
    for conv in (int, float):
        try:
            return conv(text)
        except ValueError:
            pass
    return {"true": True, "false": False}.get(text, text)


def readings(workload: str, seeds, program: bool, changed: dict,
             device: str, here: Path = harness.HERE, bench=None, emit=print):
    """Emit one reading a seed and kind (see the module's docstring)."""
    bench = harness.load_benchmark(here.parent) if bench is None else bench
    w = harness.cell(bench, workload)
    cfg = harness.load_config(w["config"], here)
    mix = harness.load_mix(w["traffic"], here)
    driver = harness.load_driver(mix["entry"], here)
    dev = torch.device(device)
    kinds = [("control", None)]
    if program or changed:
        import ipx_torch
        opts = harness.program_options(ipx_torch, cfg["options"])
        if program:
            kinds.append(("program", opts))
        if changed:
            kinds.append(("program_control", opts.replace(**changed)))
        driver.warm_up(ipx_torch, cfg, mix, opts, dev, 0)
    for seed in seeds:
        for kind, opts in kinds:
            inp = driver.inputs(cfg, mix, seed, 0, dev)
            t0 = time.perf_counter()
            if opts is None:
                ans = control_answers(inp)
                its = None
            else:
                sols = driver.call(ipx_torch, inp, opts, dev)
                ans = harness.stack_answers(harness.answers_of(ipx_torch,
                                                               sols))
                its = ans["iterations"]
            secs = time.perf_counter() - t0
            per_lp = reference.judge(inp, ans, dev)
            failed, checks = reference.verdict(per_lp, cfg["limits"])
            rec = dict(workload=workload, kind=kind, seed=seed,
                       lps=int(inp["A"].shape[0]), failed=failed,
                       seconds=secs,
                       worst={k: c["value"] for k, c in checks.items()})
            if its is not None:
                rec["iterations"] = [min(its), float(np.median(its)),
                                     max(its)]
                bad = [(st, it) for st, it, ok in zip(
                    ans["status"], its, ans["optimal"]) if not ok]
                rec["unsolved"] = bad
            if kind == "program_control":
                rec["changed"] = changed
            emit(rec)
            del inp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--program-control", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    changed = dict(kv.split("=", 1) for kv in args.program_control)
    changed = {k: _value(v) for k, v in changed.items()}
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    try:
        readings(args.workload, args.seeds, args.program, changed,
                 args.device, emit=emit)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
