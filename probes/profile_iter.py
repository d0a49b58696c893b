"""Stage times of one batched Mehrotra iteration on the GPU.

    python3 probes/profile_iter.py [--batch 256] [--m 1024] [--n 2048]

Times the stages of the main path's iteration (bf16-stored A, fused matvecs,
library Cholesky) with CUDA events at a mid-solve iterate, then traces a few
whole steps with ``torch.profiler`` for the device time by kernel name, the
number of device kernels per step and the share of the step during which the
device is idle (launch overhead of the eager step).  One JSON line per
result; the card's name and power limit are in the first.  Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ipx_torch
from ipx_torch.devinfo import nvidia_smi_line, time_ms
from ipx_torch.ipm import batched, mehrotra
from ipx_torch.kernels import cholesky as pk
from ipx_torch.kernels import fused as fk
from ipx_torch.linsys import normal_eq
from ipx_torch.problem.generate import random_feasible_batch_device


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--m", type=int, default=1024)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--warm-steps", type=int, default=6,
                    help="masked steps before timing (a mid-solve iterate)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("profile_iter: no CUDA device\n")
        return 2
    print(json.dumps({"card": nvidia_smi_line(), "torch": torch.__version__,
                      "batch": args.batch, "m": args.m, "n": args.n}),
          flush=True)

    opts = ipx_torch.SolverOptions.throughput(
        chol_backend="xla", a_storage="bfloat16", augmented_fallback=False,
        max_iter=64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    gb = random_feasible_batch_device(args.batch, args.m, args.n, gen,
                                      a_storage="bfloat16")
    lp = gb.lp
    st, fac_aat = batched.batch_starting_state(lp, opts)
    for _ in range(args.warm_steps):
        st = mehrotra.step_masked(lp, st, opts, fac_aat)
    A, d2 = lp.A, st.x / st.s
    fac = normal_eq.factor(A, d2, opts, reg_scale=st.reg_boost)
    M = normal_eq.assemble(A, d2)
    Ms = (M * fac.j.unsqueeze(2) * fac.j.unsqueeze(1)
          + 1e-8 * torch.eye(args.m, device="cuda"))
    rhs = st.rp.clone()

    stages = {
        "assemble_sym_batched": lambda: pk.assemble_sym_batched(A, d2),
        "jacobi_scale_and_reg": lambda: (
            M * fac.j.unsqueeze(2) * fac.j.unsqueeze(1)
            + 1e-8 * torch.eye(args.m, device="cuda")),
        "cholesky_ex": lambda: torch.linalg.cholesky_ex(
            Ms, check_errors=False),
        "factor_whole": lambda: normal_eq.factor(A, d2, opts),
        "chol_solve_two_trsm": lambda: normal_eq._chol_solve(fac, rhs),
        "ata_apply": lambda: fk.ata_apply(A, rhs, d2, None),
        "solve_cg1": lambda: normal_eq.solve(fac, A, rhs, opts),
        "mehrotra_step": lambda: mehrotra.mehrotra_step(lp, st, opts, fac_aat),
    }
    print(json.dumps({"stage_ms": {k: time_ms(f, reps=5, warm=1) for k, f in stages.items()}}),
          flush=True)

    # whole steps under the profiler: device time by kernel, kernels per
    # step, idle share
    from torch.profiler import ProfilerActivity, profile
    steps = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s2 = st
        for _ in range(steps):
            s2 = mehrotra.mehrotra_step(lp, s2, opts, fac_aat)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type.name == "CUDA"]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(json.dumps({
        "profiled_steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps if rows else None,
        "device_idle_share": (1 - busy_ms / wall_ms) if rows else None,
        "device_kernels_per_step": sum(r[2] for r in rows) / steps,
        "top_kernels_ms_per_step": [
            {"name": k[:80], "ms": ms / steps, "calls": c / steps}
            for k, ms, c in rows[:14]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
