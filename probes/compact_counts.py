#!/usr/bin/env python3
"""Stage 1 of ``dense_lp.batch256``'s calls under ``ipx_torch.obs.tracing()``:
the steps a call takes against its lanes' iterations, and how far the loop
narrows to the lanes still running.

    python3 probes/compact_counts.py [--root ROOT] [--tag TAG] [--seed S]
        [--calls K] [--lps 256 --m 1024 --n 2048] [--device cuda]

The calls are the cell's (``lpbench/gen.py``: 256 LPs of 1024 x 2048, A
stored bf16, call k drawn from ``--seed`` and k), solved by ``solve_batch``
under ``SolverOptions.throughput(a_storage="bfloat16", max_iter=64)`` after
one warm-up call.  ``--root`` measures another checkout's ``ipx_torch``
(export the parent with ``git archive`` into ``build/parent``).  One JSON
line a call: the call's seconds (synchronised, traced), stage 1's steps
(the ``ipm.step`` spans directly under ``api.call``) and their device
seconds, the lanes' median and largest iterations (rescue rungs
included), the lanes that reached the rescue, the OPTIMAL lanes, and,
where the checkout has them, ``ipm.compact``'s calls and device seconds
and the counters ``ipm.compact.shrinks`` and ``ipm.lane_steps`` (every
``run_batch`` of the call, the rungs' included).  Ends with the card's
name and power limit (none with ``--device cpu``, a rehearsal at a small
``--m``, ``--n`` and ``--lps``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--seed", type=int, default=3000020001)
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--lps", type=int, default=256)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))

    import torch

    import ipx_torch
    from ipx_torch import obs
    from ipx_torch.devinfo import nvidia_smi_line
    from lpbench import gen

    dev = torch.device(args.device)
    opts = ipx_torch.SolverOptions.throughput(a_storage="bfloat16",
                                              max_iter=64)

    def lp_of(call):
        inp = gen.batch(args.lps, args.m, args.n,
                        gen.generator(args.seed, call, dev), "bfloat16", dev)
        return ipx_torch.LP(c=inp["c"], A=inp["A"], b=inp["b"],
                            obj_offset=inp["obj_offset"])

    ipx_torch.solve_batch(lp_of(1 << 40), options=opts, device=dev)
    for call in range(args.calls):
        lp = lp_of(call)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: 0)
        sync()
        t0 = time.perf_counter()
        with obs.tracing() as t:
            sols = ipx_torch.solve_batch(lp, options=opts, device=dev)
            sync()
        seconds = time.perf_counter() - t0
        stage1 = [r for r in t.spans if r.name == "ipm.step"
                  and t.spans[r.parent].name == obs.CALL]
        its = [s.iterations for s in sols]
        summ = t.summary()
        compact = summ["spans"].get("ipm.compact", {})
        cnt = summ["counters"]
        print(json.dumps({
            "tag": args.tag, "seed": args.seed, "call": call,
            "seconds": round(seconds, 4),
            "stage1_steps": len(stage1),
            "stage1_step_device_s": sum(r.device_s or 0 for r in stage1),
            "median_iters": statistics.median(its), "max_iters": max(its),
            "rescue_lanes_in": cnt.get("api.rescue.lanes_in"),
            "near_miss_in": cnt.get("api.rescue.near_miss_in"),
            "optimal": sum(s.optimal for s in sols),
            "compact_calls": compact.get("calls"),
            "compact_device_s": compact.get("device_seconds"),
            "shrinks": cnt.get("ipm.compact.shrinks"),
            "lane_steps": cnt.get("ipm.lane_steps")}), flush=True)
    if dev.type == "cuda":
        print(json.dumps({"tag": args.tag, "card": nvidia_smi_line()}))


if __name__ == "__main__":
    main()
