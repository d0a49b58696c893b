#!/usr/bin/env python3
"""Smoke run of ``ipx_torch`` on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``ipx_torch/csrc`` with nvcc, holds each kernel
against its plain PyTorch version and an f64 product at the main path's
shapes (m=1024, n=2048), times each beside its bound, then drives the main
path through the public entry points: ``ipx_torch.solve_batch`` on B=256
distinct bf16-stored instances under the fused-matvec throughput options, an
f64 oracle solve on the card, two lanes solved alone, and the
fixed-iteration rate.
Every phase prints one JSON line; any failure exits non-zero.  Needs a CUDA
device: without one it exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; "
                     "this script measures on a GPU only\n")
    sys.exit(2)

import ipx_torch
from ipx_torch.devinfo import nvidia_smi_line, time_ms
from ipx_torch.ipm import batched
from ipx_torch.kernels import _build
from ipx_torch.kernels import cholesky as pk
from ipx_torch.kernels import fused as fk
from ipx_torch.linsys import normal_eq
from ipx_torch.problem.generate import (lp_from_optimum,
                                        random_feasible_batch_device)

M_ROWS, N_COLS = 1024, 2048         # the main path's width
B_CHECK = 8                         # batch of the kernel-vs-plain comparison
B_MAIN = 256                        # batch of the timed kernels and the solve
TOL_F64 = 1e-6      # kernel vs f64 product, relative to the f64 result's
                    # inf-norm.  The kernels sum in two levels or in f64; one
                    # chain of 2048 f32 terms is 5e-6 off and costs the
                    # solver lanes, so it is not accepted
TOL_PLAIN = 1e-5    # kernel vs plain version (one f32 matmul), same scale:
                    # the plain version's own summation error
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
F32_FLOPS = 67e12                   # H100 SXM, float32 outside tensor cores
DEV = "cuda"
# Without the rescue ladder (not ported yet) a float32 lane may stop short
# of OPTIMAL; at least half of the batch has to get there (measured on an
# H100 with these seeds: 201 of 256), and every OPTIMAL lane is held to the
# full contract.
MIN_OPTIMAL_SHARE = 0.5
# A lane solved alone goes through the same code as in the batch, but the
# library's triangular solves round differently at another batch size, so
# its best-iterate gap may differ by this factor, and OPTIMAL may flip only
# on a lane that ends within NEAR_MISS_GAP either way.
SINGLE_GAP_FACTOR = 10.0
NEAR_MISS_GAP = 1e-5

# kernel name -> (source, TPU kernel it replaces)
KERNELS = {
    "ata_apply": ("ipx_torch/csrc/fused_matvec.cu", "ipx/kernels/fused.py:80"),
    "a_matvec": ("ipx_torch/csrc/fused_matvec.cu", "ipx/kernels/fused.py:142"),
    "at_matvec": ("ipx_torch/csrc/fused_matvec.cu", "ipx/kernels/fused.py:161"),
    "assemble_sym_batched": ("ipx_torch/csrc/assemble_sym.cu",
                             "ipx/kernels/cholesky.py:1399"),
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(phase: str, why: str) -> None:
    emit(phase, ok=False, error=why)
    sys.exit(1)


def reset_counts() -> None:
    for d in (fk.LAUNCHES, pk.LAUNCHES):
        for k in d:
            d[k] = 0


def counts() -> dict:
    return {**fk.LAUNCHES, **pk.LAUNCHES}


def slice_options(**kw):
    return ipx_torch.SolverOptions.throughput(
        chol_backend="xla", a_storage="bfloat16", augmented_fallback=False,
        max_iter=64, **kw)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_env() -> str:
    card = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=card,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return card


def phase_build() -> None:
    secs = _build.build_all()
    emit("build", ok=True, seconds=round(secs, 2), sources=list(_build.SOURCES),
         flags=list(_build.NVCC_FLAGS))


def _inputs(B: int, a_dtype: torch.dtype, seed: int):
    g = torch.Generator(device=DEV).manual_seed(seed)
    kw = dict(generator=g, device=DEV, dtype=torch.float32)
    A = (torch.randn(B, M_ROWS, N_COLS, **kw) / N_COLS ** 0.5).to(a_dtype)
    v = torch.randn(B, M_ROWS, **kw)
    w = torch.randn(B, N_COLS, **kw)
    beta = torch.randn(B, N_COLS, **kw)
    # a D^2 = x/s profile with the spread of a mid-solve iterate
    alpha = torch.exp(3.0 * torch.randn(B, N_COLS, **kw))
    return A, v, w, beta, alpha


def _f64_refs(A, v, w, beta, alpha) -> dict:
    A64 = A.double()
    t = torch.matmul(v.double().unsqueeze(1), A64).squeeze(1)
    u = alpha.double() * (t + beta.double()) + w.double()
    av = lambda x: torch.matmul(A64, x.unsqueeze(-1)).squeeze(-1)
    return {
        "ata_apply": (av(u), t),
        "ata_apply/pair": (av(w.double()), t),
        "ata_apply/operator": (av(alpha.double() * t), t),
        "ata_apply/no_beta": (av(alpha.double() * t + w.double()), t),
        "a_matvec": (av(w.double()),),
        "at_matvec": (t,),
        "assemble_sym_batched": (
            torch.matmul(A64 * alpha.double().unsqueeze(1), A64.mT),),
    }


def _calls(A, v, w, beta, alpha):
    """name -> (kernel call, plain call), each returning a tuple.  A name
    with a slash is another calling mode of the kernel before the slash, as
    the main path uses it: the independent pair (A w, A^T v) of the residuals
    and the Gondzio step, the normal operator A (d2 (A^T v)) of the CG, and a
    refinement right-hand side without beta.  Modes are compared, not timed."""
    tup = lambda x: x if isinstance(x, tuple) else (x,)
    return {
        "ata_apply": (lambda: fk.ata_apply(A, v, alpha, w, beta=beta),
                      lambda: fk.ata_apply_plain(A, v, alpha, w, beta=beta)),
        "ata_apply/pair": (lambda: fk.ata_apply(A, v, None, w),
                           lambda: fk.ata_apply_plain(A, v, None, w)),
        "ata_apply/operator": (lambda: fk.ata_apply(A, v, alpha, None),
                               lambda: fk.ata_apply_plain(A, v, alpha, None)),
        "ata_apply/no_beta": (lambda: fk.ata_apply(A, v, alpha, w),
                              lambda: fk.ata_apply_plain(A, v, alpha, w)),
        "a_matvec": (lambda: tup(fk.a_matvec(A, w)),
                     lambda: tup(fk.a_matvec_plain(A, w))),
        "at_matvec": (lambda: tup(fk.at_matvec(A, v)),
                      lambda: tup(fk.at_matvec_plain(A, v))),
        "assemble_sym_batched": (
            lambda: tup(pk.assemble_sym_batched(A, alpha)),
            lambda: tup(pk.assemble_sym_batched_plain(A, alpha))),
    }


def _bounds(B: int, itemsize: int) -> dict:
    """name -> (bound_ms, bound_by): the larger of bytes over the memory
    rate (each input read once, each output written once) and float32
    operations over the CUDA-core rate."""
    m, n = M_ROWS, N_COLS
    a_bytes = B * m * n * itemsize
    vec = lambda k: 4 * B * k
    work = {
        "ata_apply": (a_bytes + vec(m) + 3 * vec(n) + vec(m) + vec(n),
                      4 * B * m * n),
        "a_matvec": (a_bytes + vec(n) + vec(m), 2 * B * m * n),
        "at_matvec": (a_bytes + vec(m) + vec(n), 2 * B * m * n),
        # the lower triangle with its diagonal: m (m + 1) / 2 entries of M,
        # one FMA (2 flops) per entry and column of A.  (The kernel's 128
        # tiles compute whole diagonal tiles, m (m + 128) / 2 entries; that
        # surplus is the kernel's, not the function's.)
        "assemble_sym_batched": (a_bytes + vec(n) + 4 * B * m * m,
                                 2 * B * (m * (m + 1) // 2) * n),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def _refuses_oversize_rows() -> str | None:
    """An A on the card with more rows than a block's shared memory holds
    stays on the fused route and is refused by every wrapper; nothing hands
    it to library matmuls.  Returns what went wrong, or None."""
    m, n = 1 << 15, 64
    A = torch.zeros(1, m, n, dtype=torch.bfloat16, device=DEV)
    v = torch.zeros(1, m, device=DEV)
    w = torch.ones(1, n, device=DEV)
    if not normal_eq.use_fused_matvec(slice_options(), A):
        return f"m={m} leaves the fused route"
    attempts = {
        "ata_apply": lambda: fk.ata_apply(A, v, w, None),
        "a_matvec": lambda: fk.a_matvec(A, w),
        "at_matvec": lambda: fk.at_matvec(A, v),
    }
    before = dict(fk.LAUNCHES)
    for name, call in attempts.items():
        try:
            call()
        except ValueError:
            continue
        return f"{name} took m={m} on the card instead of refusing it"
    return None if dict(fk.LAUNCHES) == before else "a refused call counted"


def phase_kernels() -> dict:
    """Kernel against plain version and f64 product at B_CHECK for both
    storage types of A and every calling mode of the main path, then times at
    B_MAIN with bf16 A (the main path)."""
    rows = {name: {"name": name, "route": "cuda", "source": src,
                   "replaces": rep, "max_abs_err": 0.0, "checks": {}}
            for name, (src, rep) in KERNELS.items()}
    for a_dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        args = _inputs(B_CHECK, a_dtype, seed=1)
        refs = _f64_refs(*args)
        for case, (kern, plain) in _calls(*args).items():
            name, label = case.split("/")[0], f"{case}/{tag}"
            got, ref_plain = kern(), plain()
            torch.cuda.synchronize()
            worst_plain = worst_f64 = abs_plain = 0.0
            for g_, p_, r_ in zip(got, ref_plain, refs[case]):
                if g_.shape != r_.shape or not bool(torch.isfinite(g_).all()):
                    fail("kernels", f"{label}: bad shape or non-finite")
                scale = float(r_.abs().max())
                abs_plain = max(abs_plain, float((g_ - p_).abs().max()))
                worst_plain = max(worst_plain,
                                  float((g_ - p_).abs().max()) / scale)
                worst_f64 = max(worst_f64,
                                float((g_.double() - r_).abs().max()) / scale)
            if name == "assemble_sym_batched" and \
                    not torch.equal(got[0], got[0].mT):
                fail("kernels", f"{label}: M is not exactly symmetric")
            if name == "ata_apply":
                # the t written out must be the t that was used: an
                # at_matvec launch of the same kernel reproduces it exactly
                if not torch.equal(got[1], fk.at_matvec(args[0], args[1])):
                    fail("kernels", f"{label}: t differs from at_matvec")
            rows[name]["checks"][label] = {
                "rel_err_vs_plain": worst_plain, "rel_err_vs_f64": worst_f64}
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                            abs_plain)
            if worst_plain > TOL_PLAIN or worst_f64 > TOL_F64:
                fail("kernels", f"{label}: rel err vs plain "
                     f"{worst_plain:.3e}, vs f64 {worst_f64:.3e} "
                     f"(tolerances {TOL_PLAIN}, {TOL_F64})")
        del args, refs
    wrong = _refuses_oversize_rows()
    if wrong:
        fail("kernels", wrong)
    torch.cuda.empty_cache()

    # ---- times at the main path's batch, bf16-stored A --------------------
    A, v, w, beta, alpha = _inputs(B_MAIN, torch.bfloat16, seed=2)
    bounds = _bounds(B_MAIN, 2)
    for name, (kern, plain) in _calls(A, v, w, beta, alpha).items():
        if "/" in name:
            continue
        rows[name]["ms"] = time_ms(kern)
        rows[name]["plain_ms"] = time_ms(plain, reps=3, warm=1)
        rows[name]["bound_ms"], rows[name]["bound_by"] = bounds[name]
    # library yardsticks: ONE PyTorch call of the same product.  torch.bmm
    # takes no mixed types, so it gets a float32 copy of A made outside the
    # timed region (it reads twice the bytes).  ata_apply is two dependent
    # products: no single call computes it.
    Af = A.float()
    Wf = Af * alpha.unsqueeze(1)
    w3, v3 = w.unsqueeze(-1), v.unsqueeze(1)
    rows["ata_apply"]["library_ms"] = None
    rows["a_matvec"]["library_ms"] = time_ms(lambda: torch.bmm(Af, w3))
    rows["at_matvec"]["library_ms"] = time_ms(lambda: torch.bmm(v3, Af))
    rows["assemble_sym_batched"]["library_ms"] = time_ms(
        lambda: torch.bmm(Wf, Af.mT), reps=3, warm=1)
    del A, Af, Wf
    torch.cuda.empty_cache()
    emit("kernels", ok=True, batch_check=B_CHECK, batch_timed=B_MAIN,
         m=M_ROWS, n=N_COLS, tol_vs_plain=TOL_PLAIN, tol_vs_f64=TOL_F64,
         kernels=list(rows.values()))
    return rows


def phase_solve_batch():
    batch = B_MAIN
    g = torch.Generator(device=DEV).manual_seed(0)
    gb = random_feasible_batch_device(batch, M_ROWS, N_COLS, g,
                                      a_storage="bfloat16", device=DEV)
    opts = slice_options()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sols = ipx_torch.solve_batch(gb.lp, options=opts, device=DEV)
    secs = time.perf_counter() - t0
    launched = counts()

    obj_star = gb.obj_star.tolist()
    by_status: dict = {}
    for s in sols:
        by_status[s.status_name] = by_status.get(s.status_name, 0) + 1
    opt = [(s, o) for s, o in zip(sols, obj_star) if s.optimal]
    obj_err = [abs(s.objective - o) / (1 + abs(o)) for s, o in opt]
    res = dict(
        batch=batch, m=M_ROWS, n=N_COLS, seconds=round(secs, 3),
        status=by_status,
        median_iterations=statistics.median(s.iterations for s in sols),
        max_iterations=max(s.iterations for s in sols),
        optimal_max_rel_gap=max((s.rel_gap for s, _ in opt), default=None),
        optimal_max_rp_rel=max((s.rp_rel for s, _ in opt), default=None),
        optimal_max_rd_rel=max((s.rd_rel for s, _ in opt), default=None),
        optimal_max_obj_rel_err=max(obj_err, default=None),
        median_rel_gap=statistics.median(s.rel_gap for s in sols),
        launches=launched)
    problems = []
    if any(s.x.shape != (N_COLS,)
           or not all(np.isfinite(a).all() for a in (s.x, s.y, s.s))
           for s in sols):
        problems.append("non-finite or misshapen solution")
    if len(opt) < MIN_OPTIMAL_SHARE * batch:
        problems.append(f"only {len(opt)} of {batch} lanes OPTIMAL")
    if obj_err and max(obj_err) > 1e-5:
        problems.append(f"OPTIMAL objective off by {max(obj_err):.3e}")
    if opt and max(s.rel_gap for s, _ in opt) > 1e-6:
        problems.append("an OPTIMAL lane misses the 1e-6 gap")
    if any(v == 0 for v in launched.values()):
        problems.append(f"a kernel was never launched: {launched}")
    emit("solve_batch", ok=not problems, **res)
    if problems:
        fail("solve_batch", "; ".join(problems))
    return gb, sols, launched


def phase_oracle_f64(gb) -> None:
    k = 4
    g64 = lp_from_optimum(gb.lp.A[:k], gb.x_star[:k], gb.y_star[:k],
                          gb.s_star[:k], dtype=torch.float64)
    opts = ipx_torch.SolverOptions(dtype="float64", tol=1e-9, tol_feas=1e-9,
                                   augmented_fallback=False)
    lp64 = g64.lp.astype(torch.float64)        # f64 copy of the bf16 values
    sols = ipx_torch.solve_batch(lp64, options=opts, device=DEV)
    err = [abs(s.objective - o) / (1 + abs(o))
           for s, o in zip(sols, g64.obj_star.tolist())]
    ok = all(s.optimal for s in sols) and max(err) <= 1e-8
    emit("oracle_f64", ok=ok, status=[s.status_name for s in sols],
         iterations=[s.iterations for s in sols], max_obj_rel_err=max(err))
    if not ok:
        fail("oracle_f64", "f64 solve on the card missed the optimum")


def phase_single(gb, batch_sols) -> None:
    """``ipx_torch.solve`` on two lanes of the batch, each alone: lane 0 and
    the OPTIMAL lane the batch finished soonest.  Each is held against what
    the batch run made of the same lane."""
    easy = min((i for i, s in enumerate(batch_sols) if s.optimal),
               key=lambda i: (batch_sols[i].iterations, i))
    out, problems = [], []
    for i in dict.fromkeys((0, easy)):
        ref = batch_sols[i]
        c = gb.lp.c[i].cpu().numpy()
        A = gb.lp.A[i].float().cpu().numpy()
        b = gb.lp.b[i].cpu().numpy()
        sol = ipx_torch.solve(c, A, b, options=slice_options(),
                              presolve=False, device=DEV)
        o = float(gb.obj_star[i])
        err = abs(sol.objective - o) / (1 + abs(o))
        out.append(dict(lane=i, status=sol.status_name,
                        iterations=sol.iterations, rel_gap=sol.rel_gap,
                        obj_rel_err=err, batch_status=ref.status_name,
                        batch_iterations=ref.iterations,
                        batch_rel_gap=ref.rel_gap))
        if sol.x.shape != (N_COLS,) or not all(
                np.isfinite(a).all() for a in (sol.x, sol.y, sol.s)):
            problems.append(f"lane {i}: non-finite or misshapen")
        if sol.status_name not in ("OPTIMAL", "STALLED", "MAX_ITER"):
            problems.append(f"lane {i}: status {sol.status_name}")
        if sol.optimal and (err > 1e-5 or sol.rel_gap > 1e-6):
            problems.append(f"lane {i}: OPTIMAL but off by {err:.3e}")
        if sol.rel_gap > SINGLE_GAP_FACTOR * ref.rel_gap:
            problems.append(f"lane {i}: gap {sol.rel_gap:.3e} alone, "
                            f"{ref.rel_gap:.3e} in the batch")
        if sol.optimal != ref.optimal and \
                max(sol.rel_gap, ref.rel_gap) > NEAR_MISS_GAP:
            problems.append(f"lane {i}: {sol.status_name} alone, "
                            f"{ref.status_name} in the batch")
    emit("single", ok=not problems, gap_factor=SINGLE_GAP_FACTOR,
         near_miss_gap=NEAR_MISS_GAP, lanes=out)
    if problems:
        fail("single", "; ".join(problems))


def phase_rate(gb, card: str) -> None:
    opts = slice_options()
    lp = gb.lp.with_a_storage(opts)
    st0, fac = batched.batch_starting_state(lp, opts)
    k1, k2 = 2, 6

    def run(k: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = batched.run_batch_fixed_iters(lp, st0, k, opts, fac)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not bool(torch.isfinite(out.mu).all()):
            fail("rate", "non-finite mu in the fixed-iteration run")
        return dt

    run(k1)
    t1 = min(run(k1) for _ in range(2))
    t2 = min(run(k2) for _ in range(2))
    t_iter = max((t2 - t1) / (k2 - k1), 1e-9)
    B = lp.A.shape[0]
    emit("rate", ok=True, batch=B, m=M_ROWS, n=N_COLS, k1=k1, k2=k2,
         seconds_k1=t1, seconds_k2=t2, ms_per_batched_iteration=t_iter * 1e3,
         batched_iterations_per_s=1.0 / t_iter,
         instance_iterations_per_s=B / t_iter, card=card)


def main() -> int:
    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    rows = phase_kernels()
    gb, sols, launched = phase_solve_batch()
    phase_oracle_f64(gb)
    phase_single(gb, sols)
    phase_rate(gb, card)

    out = []
    for name, row in rows.items():
        row = {k: v for k, v in row.items() if k != "checks"}
        row["launches"] = launched[name]
        out.append(row)
    print(json.dumps({"kernels": out}), flush=True)
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
