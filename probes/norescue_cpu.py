"""No-rescue OPTIMAL counts of ipx and ipx_torch on identical instances, on
the CPU.

    python probes/norescue_cpu.py jax   1024 2048 16
    python probes/norescue_cpu.py torch 1024 2048 16 [threads [set]]

Each run solves the same instances (A rounded to bf16) under the port's
first-slice options through one package's ``solve_batch`` and prints status, iterations, gap and objective error per
lane.  ``set`` picks the instances: ``numpy`` (default; numpy-made, seeds
100..) or ``torchgen`` (the port's batch generator on a CPU torch.Generator,
seed 0).  The JAX side runs its Pallas kernels in interpret mode and takes
several minutes at m=1024.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

which, m, n, B = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
threads = int(sys.argv[5]) if len(sys.argv) > 5 else 3
inst_set = sys.argv[6] if len(sys.argv) > 6 else "numpy"

import torch

torch.set_num_threads(threads)
from norescue_gpu import numpy_instance

if inst_set == "numpy":
    insts = [numpy_instance(m, n, 100 + i) for i in range(B)]
else:
    from ipx_torch.problem.generate import random_feasible_batch_device
    gb = random_feasible_batch_device(
        B, m, n, torch.Generator(device="cpu").manual_seed(0),
        a_storage="bfloat16", device="cpu")
    insts = [(gb.lp.c[i].numpy(), gb.lp.A[i].float().numpy(),
              gb.lp.b[i].numpy(), float(gb.obj_star[i])) for i in range(B)]
kw = dict(chol_backend="xla", a_storage="bfloat16", augmented_fallback=False,
          max_iter=64)
t0 = time.time()
if which == "torch":
    import ipx_torch
    from ipx_torch.problem.lp import make_lp
    sols = ipx_torch.solve_batch(
        [make_lp(c, A, b, device="cpu") for c, A, b, _ in insts],
        options=ipx_torch.SolverOptions.throughput(**kw), device="cpu")
else:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import ipx
    from ipx.problem.lp import make_lp
    sols = ipx.solve_batch([make_lp(c, A, b) for c, A, b, _ in insts],
                           options=ipx.SolverOptions.throughput(**kw))
print(which, m, n, B, "seconds", round(time.time() - t0, 1),
      "OPTIMAL", sum(s.optimal for s in sols), "of", B)
for s, (_, _, _, obj) in zip(sols, insts):
    print(s.status_name, s.iterations, "%.2e" % s.rel_gap,
          "%.2e" % (abs(s.objective - obj) / (1 + abs(obj))))
