"""Times of the right-looking factor's panel kernels (row 9) at other
compile-time shapes.

    python3 probes/right_variants.py [RCK,RSTAGES,RBLOCKS ...]

``csrc/cholesky_right.cu`` contracts in chunks of RCK columns through a ring
of RSTAGES stages, with launch bounds of RBLOCKS blocks an SM; the package
builds it with the shape in the source.  This probe writes copies of the
source with other shapes under ``build/right_variants/``, builds each with
the package's nvcc flags (printing ptxas's registers and spills), and times
each one's 14 launches of ``ipx_right_trsm`` and ``ipx_right_update`` (the
factor at B=256, m=1024 less its 8 diagonal launches), each call on a fresh
copy of the scaled regularised matrix of n=2048 bf16 A with its factor's W,
and its 7 updates alone.
One JSON line a shape, with a hash of the bits of a whole factor made with
it (the diagonal tiles' CUDA-core sums follow RCK, so shapes with another
RCK give other bits); ``kept`` marks the shape in the source, which runs
first and last.  The first line is the card's name and power limit.
Without arguments it runs the shapes PERF.md reports.  Needs a CUDA device.
"""
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ipx_torch.devinfo import nvidia_smi_line, time_ms  # noqa: E402
from ipx_torch.kernels import _build, cholesky as pk, fused as fk  # noqa: E402

SHAPES = ((32, 3, 1), (32, 2, 1), (16, 3, 2), (16, 4, 2))
NAMES = ("RCK", "RSTAGES", "RBLOCKS")
B, M, N, NB = 256, 1024, 2048, pk.NB


def _build_shape(src: str, shape: tuple, out: str):
    """A copy of the source with the given shape, built; returns (its two
    C entry points, ptxas's registers and spill stores)."""
    for name, val in zip(NAMES, shape):
        src, count = re.subn(rf"^constexpr int {name} = \d+;",
                             f"constexpr int {name} = {val};", src,
                             flags=re.M)
        assert count == 1, name
    tag = "c{}_s{}_b{}".format(*shape)
    cu = os.path.join(out, f"cholesky_right_{tag}.cu")
    lib = os.path.join(out, f"cholesky_right_{tag}.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
           str(_build.CSRC), "-o", lib, cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stdout + res.stderr)
    text = res.stdout + res.stderr
    so = ctypes.CDLL(lib)
    entries = []
    for name, args in pk.RIGHT_ENTRY_ARGS.items():
        fn = getattr(so, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
        entries.append(fn)
    return entries, {"registers": re.findall(r"Used (\d+) registers", text),
                "spill_stores": re.findall(r"(\d+) bytes spill stores", text)}


def main() -> int:
    src = (_build.CSRC / "cholesky_right.cu").read_text()
    kept = tuple(int(re.search(rf"^constexpr int {n} = (\d+);", src,
                               re.M).group(1)) for n in NAMES)
    shapes = ([tuple(int(v) for v in a.split(",")) for a in sys.argv[1:]]
              or list(SHAPES))
    shapes = [kept] + [s for s in shapes if s != kept] + [kept]
    out = os.path.join(_build.build_dir().parent, "right_variants")
    os.makedirs(out, exist_ok=True)
    _build.build_all()
    print(json.dumps({"card": nvidia_smi_line()}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(2)
    A = (torch.randn(B, M, N, generator=g, device="cuda")
         / N ** 0.5).to(torch.bfloat16)
    d2 = torch.exp(3.0 * torch.randn(B, N, generator=g, device="cuda"))
    reg = torch.logspace(-8, -4, B, device="cuda")
    j = torch.rsqrt(fk.a_matvec(A, d2, square=True))
    Ms = pk.assemble_sym_batched(A, d2)
    Ms.mul_(j.unsqueeze(2)).mul_(j.unsqueeze(1))
    Ms.diagonal(dim1=1, dim2=2).add_(reg.unsqueeze(-1))
    del A
    for shape in shapes:
        entries, info = _build_shape(src, shape, out)
        T = Ms.clone()
        W = torch.empty(B, M // NB, NB, NB, device="cuda")
        for k in range(M // NB):
            tile = T[:, k * NB:(k + 1) * NB, k * NB:(k + 1) * NB]
            pk.diag_factor_inv(tile, tile, W[:, k], lower_out=True)
            if k < M // NB - 1:
                pk._right_panel(T, W, k, entries)
        torch.cuda.synchronize()
        sha = hashlib.sha256(T[:16].cpu().numpy().tobytes()).hexdigest()[:16]
        update = entries[1]

        def fresh():
            T.copy_(Ms)

        def panels(update_only=False):
            # in place on a fresh copy of Ms with the factor's own W (no
            # diagonal tile is read): with the TRSMs, a real factor's values
            st = torch.cuda.current_stream().cuda_stream
            for k in range(M // NB - 1):
                if not update_only:
                    pk._right_panel(T, W, k, entries)
                elif update(T.data_ptr(), B, M, k, st) != 0:
                    raise RuntimeError(f"update failed at k={k}")

        print(json.dumps({
            "shape": dict(zip(NAMES, shape)), "kept": shape == kept, **info,
            "factor_sha": sha,
            "own_x14_ms": time_ms(panels, reps=5, warm=1, setup=fresh),
            "update_x7_ms": time_ms(lambda: panels(True), reps=5, warm=1,
                                    setup=fresh)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
