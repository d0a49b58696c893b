"""Times of the pair-solve kernel (rows 6 and 8) at other compile-time sizes.

    python3 probes/pair_variants.py [PT,CL,RING ...]

``csrc/solve_panels.cu`` is written for a thread-block cluster of CL blocks
an instance, PT threads a block and a ring of RING chunks; the package
builds it with the sizes in the source.  This probe writes copies of the
source with other sizes under ``build/pair_variants/``, builds each with the
package's nvcc flags, and times each one's ``ipx_solve_pair_panels`` on the
same fused factor (B=256, m=1024, n=2048, bf16 A) with every call enqueued
behind a spinning kernel, at B = 1, 16, 64 and 256.  One JSON line a size:
the times, the largest difference from the plain version relative to its
largest entry, and whether instance 0 alone gets its bits from the batch.
The first line is the card's name and power limit; ``kept`` marks the sizes
in the source.  Without arguments it runs the sizes PERF.md reports.  Needs
a CUDA device.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ipx_torch.devinfo import nvidia_smi_line, time_ms  # noqa: E402
from ipx_torch.kernels import _build, cholesky as pk, fused as fk  # noqa: E402

SIZES = ((256, 8, 8), (512, 8, 4), (256, 4, 8), (512, 4, 4), (256, 2, 4),
         (512, 2, 4), (512, 1, 3), (256, 1, 4))
NAMES = ("PT", "CL", "RING")


def _source_sizes(src: str) -> tuple:
    return tuple(int(re.search(rf"^constexpr int {n} = (\d+);", src,
                               re.M).group(1)) for n in NAMES)


def _start_build(src: str, sizes: tuple, out: str):
    """nvcc on a copy of the source with the given sizes; returns
    (process, library path)."""
    for name, val in zip(NAMES, sizes):
        src, count = re.subn(rf"^constexpr int {name} = \d+;",
                             f"constexpr int {name} = {val};", src,
                             flags=re.M)
        assert count == 1, name
    tag = "p{}_c{}_r{}".format(*sizes)
    cu = os.path.join(out, f"solve_panels_{tag}.cu")
    lib = os.path.join(out, f"solve_panels_{tag}.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", lib, cu]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def main() -> int:
    sizes = [tuple(int(v) for v in a.split(",")) for a in sys.argv[1:]] \
        or list(SIZES)
    src = (_build.CSRC / "solve_panels.cu").read_text()
    kept = _source_sizes(src)
    if kept not in sizes:
        sizes.append(kept)
    out = os.path.join(os.path.dirname(_build.build_dir()), "pair_variants")
    os.makedirs(out, exist_ok=True)
    jobs = [(s, *_start_build(src, s, out)) for s in sizes]
    _build.build_all()
    print(json.dumps({"card": nvidia_smi_line()}), flush=True)

    B, m, n = 256, 1024, 2048
    g = torch.Generator(device="cuda").manual_seed(2)
    A = (torch.randn(B, m, n, generator=g, device="cuda")
         / n ** 0.5).to(torch.bfloat16)
    d2 = torch.exp(3.0 * torch.randn(B, n, generator=g, device="cuda"))
    reg = torch.logspace(-8, -4, B, device="cuda")
    j = torch.rsqrt(fk.a_matvec(A, d2, square=True))
    panels, W = pk.factor_fused_panels(A, d2, j, reg)
    del A
    rhs = torch.randn(B, m, generator=g, device="cuda")
    xp = pk.chol_solve_batched_panels_plain(
        tuple(p[:4] for p in panels), W[:4], rhs[:4])
    stream = torch.cuda.current_stream().cuda_stream

    for s, proc, lib in jobs:
        log, _ = proc.communicate()
        row = dict(zip(("threads", "cluster", "ring"), s), kept=s == kept)
        if proc.returncode != 0:
            row["build_error"] = log[-2000:]
            print(json.dumps(row), flush=True)
            continue
        fn = ctypes.CDLL(lib).ipx_solve_pair_panels
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def solve(Bs):
            p = tuple(q[:Bs].contiguous() for q in panels)
            Wb, rb = W[:Bs].contiguous(), rhs[:Bs].contiguous()
            x = torch.empty_like(rb)
            ptrs = pk._panel_ptrs(p)

            def call():
                rc = fn(ptrs, Wb.data_ptr(), rb.data_ptr(), x.data_ptr(),
                        Bs, m, stream)
                if rc != 0:
                    raise RuntimeError(f"launch failed ({rc})")
            return call, x

        call, x = solve(B)
        call()
        call1, x1 = solve(1)
        call1()
        torch.cuda.synchronize()
        row["rel_err_vs_plain"] = float((x[:4] - xp).abs().max()
                                        / xp.abs().max())
        row["b1_bits_as_in_batch"] = torch.equal(x1, x[:1])
        for Bs in (1, 16, 64, 256):
            row[f"ms_b{Bs}"] = time_ms(solve(Bs)[0], reps=20, warm=1,
                                       queued=True)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
