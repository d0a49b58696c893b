"""Stage times of one batched Mehrotra iteration on the GPU.

    python3 probes/profile_iter.py [--batch 256] [--m 1024] [--n 2048]

Times the stages of the main path's iteration (bf16-stored A, fused matvecs)
with CUDA events at a mid-solve iterate on three factor routes: the
panel-major kernels (``chol_backend="pallas_left"``, what ``throughput()``
names), the library Cholesky (``"xla"``) and the right-looking kernel factor
with the full-L^T pair-solve (``"pallas"``).  Then traces a few whole steps
of each route with ``torch.profiler`` for the device time by kernel name, the
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

    left = ipx_torch.SolverOptions.throughput(
        a_storage="bfloat16", augmented_fallback=False, max_iter=64)
    xla = left.replace(chol_backend="xla")
    right = left.replace(chol_backend="pallas")
    gen = torch.Generator(device="cuda").manual_seed(0)
    gb = random_feasible_batch_device(args.batch, args.m, args.n, gen,
                                      a_storage="bfloat16")
    lp = gb.lp
    st, fac_aat = batched.batch_starting_state(lp, left)
    for _ in range(args.warm_steps):
        st = mehrotra.step_masked(lp, st, left, fac_aat)
    _, fac_aat_xla = batched.batch_starting_state(lp, xla)
    _, fac_aat_right = batched.batch_starting_state(lp, right)
    A, d2 = lp.A, (st.x / st.s).contiguous()
    rhs = st.rp.clone()
    B, m = args.batch, args.m
    NB, nb = pk.NB, args.m // pk.NB

    # ---- the kernel route, stage by stage ------------------------------------
    fac = normal_eq.factor(A, d2, left, reg_scale=st.reg_boost)
    reg = (left.reg * st.reg_boost).contiguous()
    scratch = torch.empty(B * NB * m, device="cuda")
    CD = fac.LTp[0][:, :, :NB].mT.matmul(fac.LTp[0][:, :, :NB]).contiguous()

    def panel_stages():
        rows = pk._fused_panel_rows(A, d2, fac.j, reg)
        for k in range(nb):
            w = m - k * NB
            rows(k, fac.LTp[:k], scratch[:B * NB * w].view(B, NB, w))

    dst = torch.empty(B * NB * m, device="cuda")

    def panel_trsms():
        for k in range(nb - 1):
            w = m - k * NB
            C = scratch[:B * NB * w].view(B, NB, w)
            torch.bmm(fac.W[:, k], C[:, :, NB:],
                      out=dst[:B * NB * (w - NB)].view(B, NB, w - NB))

    stages = {
        "jacobi_diag_squared_a_matvec": lambda: fk.a_matvec(A, d2, square=True),
        "fused_panel_stages_x8": panel_stages,
        "diag_factor_inv_x1": lambda: pk.diag_factor_inv(CD),
        "factor_whole": lambda: normal_eq.factor(A, d2, left),
        "chol_solve_batched_panels": lambda: normal_eq._chol_solve(fac, rhs),
        "ata_apply": lambda: fk.ata_apply(A, rhs, d2, None),
        "solve_cg1": lambda: normal_eq.solve(fac, A, rhs, left),
        "panel_trsm_bmm_x7": panel_trsms,
        "mehrotra_step": lambda: mehrotra.mehrotra_step(lp, st, left, fac_aat),
    }
    out = {k: time_ms(f, reps=5, warm=1) for k, f in stages.items()}
    print(json.dumps({"route": "pallas_left", "stage_ms": out}), flush=True)
    del fac, scratch, dst, CD

    # ---- the library route ---------------------------------------------------
    facx = normal_eq.factor(A, d2, xla, reg_scale=st.reg_boost)
    M = normal_eq.assemble(A, d2)
    Ms = (M * facx.j.unsqueeze(2) * facx.j.unsqueeze(1)
          + 1e-8 * torch.eye(args.m, device="cuda"))
    LT = facx.L.mT.contiguous()
    r3 = rhs.unsqueeze(-1)
    stages = {
        "assemble_sym_batched": lambda: pk.assemble_sym_batched(A, d2),
        "jacobi_scale_and_reg": lambda: (
            M * facx.j.unsqueeze(2) * facx.j.unsqueeze(1)
            + 1e-8 * torch.eye(args.m, device="cuda")),
        "cholesky_ex": lambda: torch.linalg.cholesky_ex(
            Ms, check_errors=False),
        "factor_whole": lambda: normal_eq.factor(A, d2, xla),
        "chol_solve_two_trsm": lambda: normal_eq._chol_solve(facx, rhs),
        # the same apply with L^T laid out contiguously, and as the one
        # library call that computes it
        "two_trsm_contiguous_lt": lambda: torch.linalg.solve_triangular(
            LT, torch.linalg.solve_triangular(facx.L, r3, upper=False),
            upper=True),
        "torch_cholesky_solve": lambda: torch.cholesky_solve(r3, facx.L),
        "solve_cg1": lambda: normal_eq.solve(facx, A, rhs, xla),
        "mehrotra_step": lambda: mehrotra.mehrotra_step(lp, st, xla,
                                                        fac_aat_xla),
    }
    out = {k: time_ms(f, reps=5, warm=2) for k, f in stages.items()}
    # one apply inside a run of twenty, back to back as in a step
    out["chol_solve_two_trsm_of_20"] = time_ms(
        lambda: [normal_eq._chol_solve(facx, rhs) for _ in range(20)],
        reps=3, warm=1) / 20
    print(json.dumps({"route": "xla", "stage_ms": out}), flush=True)
    del LT, facx

    # ---- the right-looking kernel factor and the full-L^T pair-solve ---------
    facr = normal_eq.factor(A, d2, right, reg_scale=st.reg_boost)
    Lr = facr.LT.mT.contiguous()
    stages = {
        "cholesky_batched": lambda: pk.cholesky_batched(Ms),
        "factor_lt_batched": lambda: pk.factor_lt_batched(Ms),
        "transpose_l_to_lt": lambda: Lr.mT.contiguous(),
        "factor_whole": lambda: normal_eq.factor(A, d2, right),
        "chol_solve_batched_lt": lambda: normal_eq._chol_solve(facr, rhs),
        "solve_triangular_batched_lower": lambda: pk.solve_triangular_batched(
            Lr, facr.W, rhs, lower=True),
        "solve_triangular_batched_upper": lambda: pk.solve_triangular_batched(
            Lr, facr.W, rhs, lower=False),
        "solve_cg1": lambda: normal_eq.solve(facr, A, rhs, right),
        "mehrotra_step": lambda: mehrotra.mehrotra_step(lp, st, right,
                                                        fac_aat_right),
    }
    out = {k: time_ms(f, reps=5, warm=1) for k, f in stages.items()}
    print(json.dumps({"route": "pallas", "stage_ms": out}), flush=True)
    del M, Ms, Lr, facr

    # whole steps under the profiler: device time by kernel, kernels per
    # step, idle share
    from torch.profiler import ProfilerActivity, profile
    steps = 3
    for route, opts, faat in (("pallas_left", left, fac_aat),
                              ("xla", xla, fac_aat_xla),
                              ("pallas", right, fac_aat_right)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s2 = st
            for _ in range(steps):
                s2 = mehrotra.mehrotra_step(lp, s2, opts, faat)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0
                and e.device_type.name == "CUDA"]
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        print(json.dumps({
            "route": route, "profiled_steps": steps,
            "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps if rows else None,
            "device_idle_share": (1 - busy_ms / wall_ms) if rows else None,
            "device_kernels_per_step": sum(r[2] for r in rows) / steps,
            "top_kernels_ms_per_step": [
                {"name": k[:80], "ms": ms / steps, "calls": c / steps}
                for k, ms, c in rows[:14]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
