"""Variants and diagnostics of row 4's float32-A kernel
(``assemble_sym_f32_tc_kernel`` in ``ipx_torch/csrc/assemble_sym.cu``).

    python3 probes/assembly_variants.py [VARIANT ...]

Each variant is a copy of the source and of ``csrc/mma_common.cuh`` (the
warp-specialised pipeline it shares with rows 7 and 10) under
``build/assembly_variants/``, built with ``-Xptxas -v``:

  kept            the source as it is
  no_products     without the consumers' wgmma products
  no_split        without the producers' split (the copies and handovers
                  stay)
  no_copy         without the producers' copies (the split reads whatever
                  the raw ring holds)
  overhead_only   none of the three: the handovers, the chunk sums' adds
                  and the epilogue
  no_fence        without the proxy fence between the split and the wgmma
                  reads
  [VARIANT:]NAME=V[,NAME=V...]
                  VARIANT (default kept) with the source's constants NAME set
                  to V, as WRSTAGES=3,WSSTAGES=4

Each prints one JSON line: ptxas's registers and spills of the kernel, its
time at m=1024, n=2048 with B=256 and B=64 (``throughput_f32``'s batch) and
at B=1, m=8192, n=16384 (f32 A, d2 spread over decades as in mid-solve),
and, for the variants that compute the
function, the largest difference from ``kept``, whether its bits are
``kept``'s and its largest error against float64 relative to the largest
entry of M.  The first line is the card's name and power limit.  Without
arguments it runs every variant.  Needs a CUDA device.
"""
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ipx_torch.devinfo import nvidia_smi_line, time_ms  # noqa: E402
from ipx_torch.kernels import _build, cholesky as pk  # noqa: E402

SRC = (_build.CSRC / "assemble_sym.cu").read_text()
HDR = (_build.CSRC / "mma_common.cuh").read_text()
KERNEL = "assemble_sym_f32_tc_kernel"
WGMMA = re.compile(r"wgmma128<[01]>\((hh|chain), dx\[\d\], dy\[\d\]\);")
SPLIT = ("store_parts(dst, r, kh, x);",
         "store_parts(dst + 3 * PART_E, r, kh, a);")
COPY = "            if (c < nc) {\n                float* rx = raw(c);"
FENCE = 'asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");'


def _no_products(src, hdr):
    hdr, n = WGMMA.subn("(void)0;", hdr)
    assert n == 6, n
    return src, hdr


def _no_split(src, hdr):
    for call in SPLIT:
        assert call in src, call
        src = src.replace(call, "(void)0;")
    return src, hdr


def _no_copy(src, hdr):
    assert COPY in src
    return src.replace(COPY, COPY.replace("if (c < nc)", "if (c < 0)")), hdr


def _no_fence(src, hdr):
    assert FENCE in hdr
    return src, hdr.replace(FENCE, "")


def _all(*fns):
    def f(src, hdr):
        for fn in fns:
            src, hdr = fn(src, hdr)
        return src, hdr
    return f


# name -> (transform of (source, header), computes the function)
VARIANTS = {
    "kept": (lambda s, h: (s, h), True),
    "no_products": (_no_products, False),
    "no_split": (_no_split, False),
    "no_copy": (_no_copy, False),
    "overhead_only": (_all(_no_products, _no_split, _no_copy), False),
    "no_fence": (_no_fence, False),
}


def _variant(name: str):
    """(source, header, computes the function) of a variant's name."""
    if "=" not in name:
        fn, computes = VARIANTS[name]
        return (*fn(SRC, HDR), computes)
    base, _, consts = name.rpartition(":")
    src, hdr, computes = _variant(base or "kept")
    for item in consts.split(","):
        const, val = item.split("=")
        src, n = re.subn(rf"constexpr (int|size_t) {const} = [^;]+;",
                         rf"constexpr \1 {const} = {int(val)};", src)
        assert n == 1, const
    return src, hdr, computes


def _start_build(name: str, out: str):
    src, hdr, computes = _variant(name)
    tag = re.sub(r"[^A-Za-z0-9_]", "_", name)
    d = os.path.join(out, tag)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "assemble_sym.cu"), "w") as f:
        f.write(src)
    with open(os.path.join(d, "mma_common.cuh"), "w") as f:
        f.write(hdr)
    shutil.copy(_build.CSRC / "panel_common.cuh", d)
    lib = os.path.join(d, "assemble_sym.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
           os.path.join(d, "assemble_sym.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib, computes


def _ptxas(log: str) -> list:
    """ptxas's lines for the float32 kernel."""
    lines, mine = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mine = KERNEL in ln
        elif mine and ("Used" in ln or "spill" in ln or "warning" in ln):
            lines.append(ln.strip())
    return lines


def _inputs(B, m, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(B, m, n, generator=g, device="cuda") / n ** 0.5
    d2 = torch.exp(3.0 * torch.randn(B, n, generator=g, device="cuda"))
    return A, d2


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    if "kept" not in names:
        names.insert(0, "kept")
    out = os.path.join(os.path.dirname(_build.build_dir()),
                       "assembly_variants")
    jobs = {name: _start_build(name, out) for name in names}
    print(json.dumps({"card": nvidia_smi_line()}), flush=True)
    shapes = ((256, 1024, 2048, 2), (64, 1024, 2048, 4), (1, 8192, 16384, 3))
    check = _inputs(8, 1024, 2048, seed=1)
    A64 = check[0].double()
    R = torch.matmul(A64 * check[1].double().unsqueeze(1), A64.mT)
    del A64
    ref = None
    for name in names:
        proc, lib, computes = jobs[name]
        log, _ = proc.communicate()
        row = {"variant": name}
        if proc.returncode != 0:
            row["build_error"] = log[-3000:]
            print(json.dumps(row), flush=True)
            continue
        row["ptxas"] = _ptxas(log)
        fn = ctypes.CDLL(lib).ipx_assemble_sym
        fn.argtypes = pk.ASSEMBLE_ENTRY_ARGS["ipx_assemble_sym"]
        fn.restype = ctypes.c_int

        def call(A, d2, _fn=fn):
            B, m, n = A.shape
            M = torch.empty(B, m, m, device="cuda")
            rc = _fn(A.data_ptr(), 0, d2.data_ptr(), M.data_ptr(), B, m, n,
                     torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")
            return M

        for B, m, n, seed in shapes:
            A, d2 = _inputs(B, m, n, seed)
            row[f"ms_b{B}_m{m}"] = time_ms(lambda: call(A, d2), reps=5,
                                           warm=2)
            del A, d2
        if computes:
            M = call(*check)
            torch.cuda.synchronize()
            if ref is None:
                ref = M
            row["max_diff_vs_kept"] = float((M - ref).abs().max())
            row["bits_of_kept"] = bool(torch.equal(M, ref))
            row["vs_f64"] = float((M.double() - R).abs().max()
                                  / R.abs().max())
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
