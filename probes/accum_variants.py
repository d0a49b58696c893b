"""Variants of the left-looking factors' tensor-core accumulation and
row-panel product (rows 7 and 10, ``csrc/accum_panel.cu``), built from
copies of the source, timed and held against float64 on one card.

    python3 probes/accum_variants.py [--lanes] [VARIANT ...]

Variants (a copy of the source and of ``csrc/mma_common.cuh``, whose
pipeline it shares with row 4's float32 kernel, under
``build/accum_variants/``, built with the package's nvcc flags and the ones
named):

  kept            the source as it is: the accumulation on wgmma, the five
                  smaller cross products chained through one accumulator a
                  prior panel
  mma_sync        the accumulation's consumers on mma.sync
                  (-DIPX_ACCUM_WGMMA=0)
  alone           every product summed alone (-DIPX_ACCUM_CHAIN_SMALL=0)
  alone_mma_sync  both
  no_products, no_split, no_copy, copies_only, products_only, split_only,
  overhead_only, no_fence, no_ms_read, no_store, no_epilogue
                  diagnostics, times only (their results are wrong): the
                  kept source without its wgmma products, without the
                  split, without the copies, with the copies alone, the
                  products alone, the split alone, none of the three (the
                  handovers and the epilogue), without the proxy fence
                  between the split and the wgmma reads, and the
                  accumulation's epilogue without its reads of Ms, without
                  its stores of C, or without both
  spin_wait, wait_hint
                  the mbarrier waits as a spinning test_wait, or as a
                  try_wait with a suspend-time hint of 100 ns
  [VARIANT:]NAME=V[,NAME=V...]
                  VARIANT (default kept) with the source's constants NAME
                  set to V, as RSTAGES=7,SSTAGES=2

Each prints one JSON line: ptxas's registers and spills; row 7's eight
accumulation launches at B=256, m=1024 (the scaled, regularised normal
matrix of an n=2048 bf16 A) on the kept build's own prior panels, timed
together and per k; row 10's eight row-panel launches on the kept build's
factor; and, for the variants that compute the function, the largest
difference from ``kept``, whether its bits are ``kept``'s, and row 7's start
tiles against float64 (``chip_smoke._lt_start_tiles`` over three batches of
8, seeds 1-3, means over them).  With ``--lanes``, ``solve_batch`` under
``throughput()`` with A stored float32 (B=64, m=1024, n=2048, seeds 0 and 1)
with each computing variant's accumulation in the package's place: the
OPTIMAL lanes and the median iterations.  The first line is the card's name
and power limit.  Without arguments it runs every variant.  Needs a CUDA
device.
"""
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import ipx_torch  # noqa: E402
from ipx_torch.devinfo import nvidia_smi_line, time_ms  # noqa: E402
from ipx_torch.kernels import _build, cholesky as pk  # noqa: E402
from ipx_torch.problem.generate import random_feasible_batch_device  # noqa: E402

NB = pk.NB
B, M = 256, 1024
# the source and the header it shares, one text for the edits below (a
# variant's copy is split again at SEP)
SEP = "\n// ==== mma_common.cuh ====\n"
SRC = ((_build.CSRC / "accum_panel.cu").read_text() + SEP
       + (_build.CSRC / "mma_common.cuh").read_text())
WGMMA_CALLS = ("wgmma128<0>(hh, dx[0], dy[0]);",
               "wgmma128<1>(chain, dx[1], dy[0]);",
               "wgmma128<1>(chain, dx[2], dy[0]);",
               "wgmma128<1>(chain, dx[0], dy[1]);",
               "wgmma128<1>(chain, dx[1], dy[1]);",
               "wgmma128<1>(chain, dx[0], dy[2]);")


def _no_products(src: str) -> str:
    for call in WGMMA_CALLS:
        assert call in src, call
        src = src.replace(call, "(void)0;")
    return src


def _no_split(src: str) -> str:
    loop = "#pragma unroll\n    for (int u = 0; u < 2; ++u)"
    assert loop in src
    return src.replace(loop, "#pragma unroll\n    for (int u = 0; u < 0; ++u)")


def _no_copy(src: str) -> str:
    src, n = re.subn(r"\n( *)cp16\(r([xy]) \+ p \* TILE \+ s4, ([xy])g \+ "
                     r"size_t\(p\) \* ld \+ s4\);", r"\n\1(void)r\2; (void)\3g;",
                     src)
    assert n == 2, n
    return src


def _no_fence(src: str) -> str:
    fence = 'asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");'
    assert fence in src
    return src.replace(fence, "")


MS_READ = """        const float2 s = *reinterpret_cast<const float2*>(
            Mrow + size_t(r) * m + c);"""
C_STORE = """        *reinterpret_cast<float2*>(Cb + size_t(r) * w + c) =
            make_float2(__fsub_rn(s.x, u0), __fsub_rn(s.y, u1));"""


def _no_ms_read(src: str) -> str:
    assert MS_READ in src
    return src.replace(MS_READ, "        const float2 s = make_float2(0.f, 0.f);")


def _no_store(src: str) -> str:
    assert C_STORE in src
    # the values stay live: a store that never happens
    return src.replace(C_STORE, "        if (__fsub_rn(s.x, u0) == 1.25e30f)\n"
                       + C_STORE)


TRY_WAIT = "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"


def _wait(src: str, how: str) -> str:
    assert TRY_WAIT in src
    return src.replace(TRY_WAIT, how)


# name -> (source, extra nvcc flags, computes the function)
VARIANTS = {
    "kept": (SRC, [], True),
    "mma_sync": (SRC, ["-DIPX_ACCUM_WGMMA=0"], True),
    "alone": (SRC, ["-DIPX_ACCUM_CHAIN_SMALL=0"], True),
    "alone_mma_sync": (SRC, ["-DIPX_ACCUM_CHAIN_SMALL=0",
                             "-DIPX_ACCUM_WGMMA=0"], True),
    "no_products": (_no_products(SRC), [], False),
    "no_split": (_no_split(SRC), [], False),
    "no_copy": (_no_copy(SRC), [], False),
    "copies_only": (_no_products(_no_split(SRC)), [], False),
    "products_only": (_no_copy(_no_split(SRC)), [], False),
    "split_only": (_no_copy(_no_products(SRC)), [], False),
    "overhead_only": (_no_copy(_no_products(_no_split(SRC))), [], False),
    "no_fence": (_no_fence(SRC), [], False),
    "no_ms_read": (_no_ms_read(SRC), [], False),
    "no_store": (_no_store(SRC), [], False),
    "no_epilogue": (_no_store(_no_ms_read(SRC)), [], False),
    "spin_wait": (_wait(SRC, TRY_WAIT.replace("try_wait", "test_wait")), [],
                  True),
    "wait_hint": (_wait(SRC, TRY_WAIT.replace("%2;", "%2, 100;")), [], True),
}


def _variant(name: str):
    """(source, flags, computes the function) of a variant's name."""
    if "=" not in name:
        return VARIANTS[name]
    base, _, consts = name.rpartition(":")
    src, flags, computes = VARIANTS[base or "kept"]
    for item in consts.split(","):
        const, val = item.split("=")
        src, n = re.subn(rf"constexpr (int|size_t) {const} = [^;]+;",
                         rf"constexpr \1 {const} = {int(val)};", src)
        assert n == 1, const
    return src, flags, computes


def _start_build(name: str, out: str):
    src, flags, _ = _variant(name)
    tag = re.sub(r"[^A-Za-z0-9_]", "_", name)
    d = os.path.join(out, tag)
    os.makedirs(d, exist_ok=True)
    cu = os.path.join(d, "accum_panel.cu")
    lib = os.path.join(d, "accum_panel.so")
    for path, text in zip((cu, os.path.join(d, "mma_common.cuh")),
                          src.split(SEP)):
        with open(path, "w") as f:
            f.write(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC),
           "-Xptxas", "-v", "-o", lib, cu]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def _scaled(seed: int, batch: int):
    A, d2, j, reg = cs._panel_inputs(batch, seed=seed)
    Ms = pk.assemble_sym_batched(A, d2)
    Ms.mul_(j.unsqueeze(2)).mul_(j.unsqueeze(1))
    Ms.diagonal(dim1=1, dim2=2).add_(reg.unsqueeze(-1))
    return Ms


def _entries(lib: str):
    dll = ctypes.CDLL(lib)
    out = {}
    for name in ("ipx_accum_panel", "ipx_lt_rows"):
        fn = getattr(dll, name)
        fn.argtypes = pk.ACCUM_ENTRY_ARGS[name]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def _rows(fn, Ms):
    """``rows(k, prior, C)`` launching another build's accumulation."""
    def rows(k, prior, C):
        rc = fn(Ms.data_ptr(), pk._panel_ptrs(prior), C.data_ptr(),
                Ms.shape[0], Ms.shape[1], k,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"accumulation launch failed ({rc}) at k={k}")
    return rows


def _lanes(fn) -> dict:
    """solve_batch on the float32-A path with ``fn`` as the accumulation."""
    saved = pk._fns.get("ipx_accum_panel")
    pk._fns["ipx_accum_panel"] = fn
    out = {}
    try:
        for seed in (0, 1):
            g = torch.Generator(device="cuda").manual_seed(seed)
            lp = random_feasible_batch_device(64, M, 2048, g,
                                              a_storage="bfloat16").lp
            sols = ipx_torch.solve_batch(lp, options=cs.f32_options())
            out[f"seed{seed}"] = {
                "optimal": sum(s.optimal for s in sols),
                "median_iterations": statistics.median(
                    s.iterations for s in sols)}
    finally:
        if saved is None:
            pk._fns.pop("ipx_accum_panel", None)
        else:
            pk._fns["ipx_accum_panel"] = saved
    return out


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--lanes"]
    lanes = "--lanes" in sys.argv[1:]
    names = args or list(VARIANTS)
    if "kept" not in names:
        names.insert(0, "kept")
    out = os.path.join(os.path.dirname(_build.build_dir()), "accum_variants")
    os.makedirs(out, exist_ok=True)
    jobs = {name: _start_build(name, out) for name in names}
    _build.build_all()
    print(json.dumps({"card": nvidia_smi_line()}), flush=True)

    Ms = _scaled(2, B)
    panels, _ = pk.factor_lt_panels(Ms)
    LT, W10 = pk.factor_lt_batched(Ms)
    nb = M // NB
    Cs = []
    for k in range(nb):
        C = torch.empty(B, NB, M - k * NB, device="cuda")
        pk._lt_accumulate(Ms, LT, C, k)
        Cs.append(C)
    checks = [(_scaled(seed, 8), None) for seed in (1, 2, 3)]
    checks = [(m8, pk.factor_lt_panels(m8)[0]) for m8, _ in checks]
    ref = None
    st = torch.cuda.current_stream().cuda_stream
    for name in names:
        proc, lib = jobs[name]
        log, _ = proc.communicate()
        row = {"variant": name}
        if proc.returncode != 0:
            row["build_error"] = log[-3000:]
            print(json.dumps(row), flush=True)
            continue
        row["ptxas"] = [ln.strip() for ln in log.splitlines()
                        if "Used" in ln or "spill" in ln]
        fns = _entries(lib)
        rows = _rows(fns["ipx_accum_panel"], Ms)
        outs = [torch.empty(B, NB, M - k * NB, device="cuda")
                for k in range(nb)]

        def accumulate():
            for k in range(nb):
                rows(k, panels[:k], outs[k])

        LT2 = LT.clone()

        def row_panels():
            for k in range(nb):
                if fns["ipx_lt_rows"](W10.data_ptr(), Cs[k].data_ptr(),
                                      LT2.data_ptr(), B, M, k, st):
                    raise RuntimeError(f"{name}: row-panel launch failed")

        accumulate()
        torch.cuda.synchronize()
        row["accumulate_x8_ms"] = time_ms(accumulate, reps=5, warm=1)
        row["accumulate_per_k_ms"] = [
            time_ms(lambda k=k: rows(k, panels[:k], outs[k]), reps=5, warm=1)
            for k in range(nb)]
        row["row_panels_x8_ms"] = time_ms(row_panels, reps=5, warm=1)
        if _variant(name)[2]:
            if name == "kept":
                ref = [o.clone() for o in outs]
            else:
                row["max_rel_vs_kept"] = max(
                    float((o - r).abs().max() / r.abs().max())
                    for o, r in zip(outs, ref))
                row["bits_as_kept"] = all(torch.equal(o, r)
                                          for o, r in zip(outs, ref))
            stats: dict = {}
            for m8, p8 in checks:
                got = cs._lt_start_tiles(m8, p8, _rows(fns["ipx_accum_panel"],
                                                        m8))
                for part, vals in got.items():
                    acc = stats.setdefault(part, dict.fromkeys(vals, 0.0))
                    for key, v in vals.items():
                        acc[key] += v / len(checks)
            row["lt_start_tiles"] = stats
            if lanes:
                row["lanes"] = _lanes(fns["ipx_accum_panel"])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
