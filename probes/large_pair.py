#!/usr/bin/env python3
"""One ``solve_large`` of any checkout of this repository, for comparing two
trees on one card.

    python3 probes/large_pair.py <root of a checkout> <tag> [--m 32768]
                                 [--n 65536] [--f32]

Imports ``ipx_torch`` from the checkout given, builds its kernels, generates
the large LP on the card as ``chip_smoke.py`` does (seed 0, A stored bf16
with its values rounded before b and c are formed, or float32 with
``--f32`` and seed 1) and solves it at p = 1 with the default options (the
endgame armed). Prints one JSON line: the card, status, iterations, the
stages (route, iterations, seconds), seconds, objective error against the
constructed optimum, peak memory and the kernel launches.  To compare a
change with its parent, export the parent (``git archive``) into a
git-ignored directory and run parent, change, change, parent in one call.
Needs a CUDA device.
"""
import argparse
import json
import sys
import time

ap = argparse.ArgumentParser()
ap.add_argument("root")
ap.add_argument("tag")
ap.add_argument("--m", type=int, default=32768)
ap.add_argument("--n", type=int, default=65536)
ap.add_argument("--f32", action="store_true")
a = ap.parse_args()
sys.path.insert(0, a.root)

import torch  # noqa: E402

import ipx_torch  # noqa: E402
import ipx_torch.api  # noqa: E402
from ipx_torch.kernels import _build  # noqa: E402
from ipx_torch.kernels import cholesky as pk, fused as fk  # noqa: E402
from ipx_torch.problem.generate import random_feasible_large_device  # noqa

from checkout import devinfo  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("large_pair: needs a CUDA device")
_build.build_all()
a_dtype = torch.float32 if a.f32 else torch.bfloat16
g = torch.Generator(device="cuda").manual_seed(1 if a.f32 else 0)
lp, star = random_feasible_large_device(a.m, a.n, g, a_dtype, device="cuda")
opts = ipx_torch.SolverOptions(dtype="float32", a_storage=(
    "float32" if a.f32 else "bfloat16"))
stages = []
orig = ipx_torch.api._run_batch


def run(lp_, opts_, state0=None):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = orig(lp_, opts_, state0)
    torch.cuda.synchronize()
    stages.append({"linsys": opts_.linsys, "iterations": int(st.it.max()),
                   "seconds": time.perf_counter() - t0})
    return st


ipx_torch.api._run_batch = run
for d in (fk.LAUNCHES, pk.LAUNCHES):
    for k in d:
        d[k] = 0
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
sol = ipx_torch.solve_large(lp, options=opts, device="cuda")
torch.cuda.synchronize()
secs = time.perf_counter() - t0
print(json.dumps({
    "tag": a.tag, "card": devinfo.nvidia_smi_line(), "m": a.m, "n": a.n,
    "a_dtype": str(a_dtype), "status": sol.status_name,
    "iterations": sol.iterations, "stages": stages, "seconds": secs,
    "obj_rel_err": abs(sol.objective - star) / (1 + abs(star)),
    "rel_gap": sol.rel_gap,
    "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    "launches": {k: v for k, v in {**fk.LAUNCHES, **pk.LAUNCHES}.items()
                 if v}}), flush=True)
