#!/usr/bin/env python3
"""Variants and times of rows 2 and 3 (``a_matvec``, ``at_matvec``: the row
streams of ``ipx_torch/csrc/row_matvec.cu``) beside the stripe kernel they
replaced.

    python3 probes/row_variants.py [--parent ROOT] [--quick] [--log FILE]
                                   [VARIANT ...]

Each variant is a copy of the source under ``build/row_variants/`` built with
``-Xptxas -v`` (every copy's nvcc started together):

  kept              the source as it is
  NAME=V[,NAME=V]   the source's constants NAME set to V (RW, UNROLL,
                    ROWS_A, SPAN_MAX, TILE_BYTES), e.g. RW=2 or UNROLL=16
  span=S / tile=T   the kept build with row 2's span or row 3's tile given
                    at the launch (S a multiple of 32 granules, at most
                    SPAN_MAX; T at most TILE_BYTES / itemsize)
  bulk              row 2 from ``probes/row_bulk.cu``: a ring of
                    cp.async.bulk copies fed by one producer warp in place
                    of the non-allocating loads, the same sums in the same
                    order (row 3 the kept build's; aligned rows only, the
                    other shapes' checks skipped)

For every variant: ptxas's registers and spills of each kernel; the largest
error of y = A w, (A o A) w and t = A^T v against float64 relative to the
largest entry, at the main width (B=8, m=1024, n=2048) and at odd shapes
(m=1000, n=2045: rows not 16-byte aligned; m=2100, n=4496 and 4500: two
spans, two or three tiles); whether the bits are ``kept``'s, the same from
a second launch, for a lane at B=1 and 3 as in the batch and from an A
whose data starts off a 16-byte boundary (the element-by-element path); and
CUDA-event times at B=256, m=1024, n=2048 (bf16 and f32 A), at B=1, m=8192, n=16384 (f32 A) and, unless
``--quick``, at B=1, m=32768, n=65536 (bf16 A, config 4's), each beside the
bytes bound.  Once: the same products through one ``torch.bmm`` on an f32
A, through ``numerics.mv`` / ``mv64`` (a copy of A, a block of rows at a
time: what the sharded routes took before) and ``mv_wide`` (the augmented
routes' float64 copy), and with ``--parent ROOT`` the parent's stripe
kernel (modes 1-3 of its ``csrc/fused_matvec.cu``) at the main width.  One
JSON line each (also appended to FILE with ``--log``); the card's name and
power limit first.  Needs a CUDA device.
"""
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ipx_torch import numerics  # noqa: E402
from ipx_torch.devinfo import nvidia_smi_line, time_ms  # noqa: E402
from ipx_torch.kernels import _build, fused as fk  # noqa: E402

SRC = (_build.CSRC / "row_matvec.cu").read_text()
OUT = os.path.join(ROOT, "build", "row_variants")
HBM = 3.35e12
P, I = ctypes.c_void_p, ctypes.c_int
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
DEFAULT = ("kept", "RW=2", "RW=8", "UNROLL=4", "UNROLL=16", "ROWS_A=128",
           "span=2048", "tile=128")
LOG = None     # --log FILE


def emit(obj: dict) -> None:
    """One JSON line on stdout and, with ``--log``, in its file."""
    line = json.dumps(obj)
    print(line, flush=True)
    if LOG:
        with open(LOG, "a") as f:
            f.write(line + "\n")


def _parse(spec: str):
    """(constants, runtime) of a variant name."""
    consts, run = {}, {}
    if spec == "kept":
        return consts, run
    for item in spec.split(","):
        k, v = item.split("=")
        (run if k in ("span", "tile") else consts)[k] = int(v)
    return consts, run


def _start(tag: str, src: str):
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{re.sub(r'[^A-Za-z0-9_]', '_', tag)}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = path[:-3] + ".so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
           path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def _ptxas(text: str) -> dict:
    """kernel (its name and mangled template arguments) -> registers and
    spill stores, from ``-Xptxas -v``."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(\d+)(\w+?_kernel)(\w*)", m.group(1))
            name = f"{k.group(2)}{k.group(3)}" if k else m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.setdefault(name, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


class Rows:
    """Rows 2 and 3 of one build, called through its C entries."""

    def __init__(self, lib: str, run: dict, consts: dict, a_lib=None):
        so = ctypes.CDLL(lib)
        self.a = ctypes.CDLL(a_lib or lib).ipx_rows_a
        self.a.argtypes = [P, I, P, I, P, P, P, I, I, I, I, P]
        self.at = so.ipx_rows_at
        self.at.argtypes = [P, I, P, P, P, P, I, I, I, I, P]
        self.a.restype = self.at.restype = I
        self.run = run
        self.tile_bytes = consts.get("TILE_BYTES", fk._TILE_BYTES)
        self.span_max = consts.get("SPAN_MAX", fk._SPAN_MAX)

    def _go(self, fn, A, *args):
        B, m, n = A.shape
        rc = fn(A.data_ptr(), int(A.dtype == BF16), *args, B, m, n,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    def y(self, A, w, square=False, out=F32):
        B, m, n = A.shape
        step = 32 * 16 // A.element_size()
        span = self.run.get("span") or min(-(-n // step) * step,
                                           self.span_max)
        ns = -(-n // span)
        y = torch.empty(B, m, dtype=out, device=A.device)
        part = torch.empty(B, ns, m, dtype=F64, device=A.device) \
            if ns > 1 else None
        self._go(self.a, A, w.data_ptr(), int(square),
                 y.data_ptr() if out == F32 else None,
                 y.data_ptr() if out == F64 else None,
                 None if part is None else part.data_ptr(), span)
        return y

    def t(self, A, v, out=F32):
        B, m, n = A.shape
        tile = self.run.get("tile") or self.tile_bytes // A.element_size()
        nt = -(-m // tile)
        t = torch.empty(B, n, dtype=out, device=A.device)
        part = torch.empty(B, nt, n, dtype=F64, device=A.device) \
            if nt > 1 else None
        self._go(self.at, A, v.data_ptr(),
                 t.data_ptr() if out == F32 else None,
                 t.data_ptr() if out == F64 else None,
                 None if part is None else part.data_ptr(), tile)
        return t


def _inputs(B, m, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    kw = dict(generator=g, device="cuda", dtype=F32)
    A = (torch.randn(B, m, n, **kw) / n ** 0.5).to(dtype)
    w = torch.randn(B, n, **kw)
    d2 = torch.exp(3.0 * torch.randn(B, n, **kw))
    v = torch.randn(B, m, **kw)
    return A, w, d2, v


def _refs(A, w, d2, v, rows=2048):
    """float64 y, (A o A) d2 and t, a block of rows at a time."""
    B, m, n = A.shape
    y = torch.empty(B, m, dtype=F64, device=A.device)
    sq = torch.empty_like(y)
    t = torch.zeros(B, n, dtype=F64, device=A.device)
    for r0 in range(0, m, rows):
        Ab = A[:, r0:r0 + rows].double()
        y[:, r0:r0 + rows] = (Ab @ w.double().unsqueeze(-1)).squeeze(-1)
        sq[:, r0:r0 + rows] = ((Ab * Ab) @ d2.double().unsqueeze(-1)
                               ).squeeze(-1)
        t += (v[:, r0:r0 + rows].double().unsqueeze(1) @ Ab).squeeze(1)
        del Ab
    return y, sq, t


def _rel(got, ref) -> float:
    return float((got.double() - ref).abs().max() / ref.abs().max())


def _bound_ms(A) -> float:
    B, m, n = A.shape
    return (A.numel() * A.element_size() + 4 * B * (m + n)) / HBM * 1e3


def _misaligned(A):
    """A copy of A whose data starts one element past a 16-byte boundary:
    the element-by-element path."""
    buf = torch.empty(A.numel() + 1, dtype=A.dtype, device=A.device)
    out = buf[1:].view(A.shape)
    out.copy_(A)
    return out


def _check(rows: Rows, A, w, d2, v) -> dict:
    ry, rs, rt = _refs(A, w, d2, v)
    try:
        y = rows.y(A, w)
    except RuntimeError:
        return {"skipped": "the build refuses this shape", "out": None}
    s, t = rows.y(A, d2, True), rows.t(A, v)
    Au = _misaligned(A)
    try:
        paths = torch.equal(rows.y(Au, w), y) \
            and torch.equal(rows.t(Au, v), t)
    except RuntimeError:
        paths = None
    del Au
    y64, t64 = rows.y(A, w, out=F64), rows.t(A, v, out=F64)
    same = (torch.equal(y, rows.y(A, w)) and torch.equal(t, rows.t(A, v))
            and torch.equal(s, rows.y(A, d2, True)))
    lanes = True
    for Bs in (1, 3):
        if Bs < A.shape[0]:
            sl = lambda x: x[:Bs].contiguous()
            lanes &= (torch.equal(rows.y(sl(A), sl(w)), y[:Bs])
                      and torch.equal(rows.t(sl(A), sl(v)), t[:Bs]))
    return {"y": _rel(y, ry), "sq": _rel(s, rs), "t": _rel(t, rt),
            "y64": _rel(y64, ry), "t64": _rel(t64, rt),
            "rounded_once": bool(torch.equal(y64.float(), y)
                                 and torch.equal(t64.float(), t)),
            "same_bits_twice": bool(same), "lanes_bitwise": bool(lanes),
            "misaligned_same_bits": paths if paths is None else bool(paths),
            "out": (y, s, t)}


# the main width; rows not 16-byte aligned; two spans and two or three
# tiles, rows aligned and not
SHAPES_CHECK = ((8, 1024, 2048), (3, 1000, 2045), (3, 2100, 4496),
                (3, 2100, 4500))


def _times(rows: Rows, quick: bool) -> dict:
    out = {}
    shapes = [(256, 1024, 2048, BF16), (256, 1024, 2048, F32),
              (1, 8192, 16384, F32)]
    if not quick:
        shapes.append((1, 32768, 65536, BF16))
    for B, m, n, dt in shapes:
        A, w, d2, v = _inputs(B, m, n, dt, 2)
        tag = f"B{B}_m{m}_n{n}_{'bf16' if dt == BF16 else 'f32'}"
        reps = dict(reps=30, warm=20)
        out[tag] = {"a_ms": time_ms(lambda: rows.y(A, w), **reps),
                    "a_sq_ms": time_ms(lambda: rows.y(A, d2, True), **reps),
                    "at_ms": time_ms(lambda: rows.t(A, v), **reps),
                    "a_f64_ms": time_ms(lambda: rows.y(A, w, out=F64),
                                        **reps),
                    "at_f64_ms": time_ms(lambda: rows.t(A, v, out=F64),
                                         **reps),
                    "bound_ms": _bound_ms(A)}
        del A
        torch.cuda.empty_cache()
    return out


def _yardsticks(quick: bool, parent) -> dict:
    out = {}
    for B, m, n, dt in ((256, 1024, 2048, BF16), (256, 1024, 2048, F32)):
        A, w, d2, v = _inputs(B, m, n, dt, 2)
        tag = f"B{B}_{'bf16' if dt == BF16 else 'f32'}"
        Af = A.float()
        w3, v3 = w.unsqueeze(-1), v.unsqueeze(1)
        row = {"bmm_a_ms": time_ms(lambda: torch.bmm(Af, w3)),
               "bmm_at_ms": time_ms(lambda: torch.bmm(v3, Af)),
               "mv_wide_a_ms": time_ms(lambda: numerics.mv_wide(A, w),
                                       reps=3, warm=1),
               "mv_wide_at_ms": time_ms(lambda: numerics.mv_wide(A.mT, v),
                                        reps=3, warm=1)}
        del Af
        if parent is not None:
            W = fk.stripe_cols(m, A.element_size())
            ypart = torch.empty(B, fk.stripe_partials(n, W), m, dtype=F64,
                                device="cuda")
            y = torch.empty(B, m, device="cuda")
            t = torch.empty(B, n, device="cuda")

            def stripe(mode, x_v, x_w):
                rc = parent(mode, A.data_ptr(), int(dt == BF16),
                            None if x_v is None else x_v.data_ptr(), None,
                            None, None if x_w is None else x_w.data_ptr(),
                            y.data_ptr(), t.data_ptr(), ypart.data_ptr(), B,
                            m, n, W, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"parent stripe mode {mode}: {rc}")
            row["parent_a_ms"] = time_ms(lambda: stripe(1, None, w))
            row["parent_at_ms"] = time_ms(lambda: stripe(2, v, None))
            row["parent_a_sq_ms"] = time_ms(lambda: stripe(3, None, d2))
            stripe(1, None, w)
            row["parent_a_rel_f64"] = _rel(y, _refs(A, w, d2, v)[0])
        out[tag] = row
        del A
        torch.cuda.empty_cache()
    shapes = [(8192, 16384, F32)] + ([] if quick else [(32768, 65536, BF16)])
    for m, n, dt in shapes:
        A, w, d2, v = _inputs(1, m, n, dt, 2)
        out[f"B1_m{m}_{'bf16' if dt == BF16 else 'f32'}"] = {
            "mv_a_ms": time_ms(lambda: numerics.mv(A, w), reps=3, warm=1),
            "mv_at_ms": time_ms(lambda: numerics.mv(A.mT, v), reps=3, warm=1),
            "mv64_a_ms": time_ms(lambda: numerics.mv64(A, w), reps=3, warm=1),
            "mv64_at_ms": time_ms(lambda: numerics.mv64(A.mT, v), reps=3,
                                  warm=1)}
        del A
        torch.cuda.empty_cache()
    return out


def main() -> int:
    args = sys.argv[1:]
    parent_root = None
    if "--parent" in args:
        k = args.index("--parent")
        parent_root = args[k + 1]
        del args[k:k + 2]
    global LOG
    if "--log" in args:
        k = args.index("--log")
        LOG = args[k + 1]
        del args[k:k + 2]
    quick = "--quick" in args
    args = [a for a in args if a != "--quick"]
    if not torch.cuda.is_available():
        sys.stderr.write("row_variants: needs a CUDA device\n")
        return 2
    if LOG:
        os.makedirs(os.path.dirname(os.path.abspath(LOG)), exist_ok=True)
    emit({"card": nvidia_smi_line(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    specs = args or list(DEFAULT)
    builds = {}
    if "bulk" in specs:
        builds["bulk"] = _start("bulk", open(os.path.join(
            ROOT, "probes", "row_bulk.cu")).read())
    for spec in specs:
        if spec == "bulk":
            spec = "kept"
        consts, _ = _parse(spec)
        key = ",".join(f"{k}={v}" for k, v in sorted(consts.items())) \
            or "kept"
        if key in builds:
            continue
        src = SRC
        for k, v in consts.items():
            src, hits = re.subn(rf"constexpr int {k} = [^;]+;",
                                f"constexpr int {k} = {v};", src)
            if hits != 1:
                sys.exit(f"row_variants: no constant {k}")
        builds[key] = _start(key, src)
    parent = None
    if parent_root:
        psrc = open(os.path.join(parent_root, "ipx_torch", "csrc",
                                 "fused_matvec.cu")).read()
        builds["parent_stripe"] = _start("parent_stripe", psrc)
    libs = {}
    for key, (proc, lib) in builds.items():
        text, _ = proc.communicate()
        if proc.returncode:
            emit({"build": key, "ok": False, "nvcc": text[-3000:]})
            return 1
        libs[key] = lib
        emit({"build": key, "ptxas": _ptxas(text)})
    if parent_root:
        parent = ctypes.CDLL(libs.pop("parent_stripe")).ipx_fused_matvec
        parent.argtypes = [I, P, I, P, P, P, P, P, P, P, I, I, I, I, P]
        parent.restype = I
    kept_out = {}
    for spec in specs:
        consts, run = _parse("kept" if spec == "bulk" else spec)
        key = ",".join(f"{k}={v}" for k, v in sorted(consts.items())) \
            or "kept"
        rows = Rows(libs[key], run, consts,
                    libs["bulk"] if spec == "bulk" else None)
        line = {"variant": spec, "checks": {}}
        for B, m, n in SHAPES_CHECK:
            for dt in (BF16, F32):
                A, w, d2, v = _inputs(B, m, n, dt, 1)
                tag = f"B{B}_m{m}_n{n}_{'bf16' if dt == BF16 else 'f32'}"
                res = _check(rows, A, w, d2, v)
                outs = res.pop("out")
                if spec == "kept":
                    kept_out[tag] = outs
                elif tag in kept_out and outs is not None:
                    res["kept_bits"] = all(torch.equal(a, b) for a, b in
                                           zip(outs, kept_out[tag]))
                line["checks"][tag] = res
        torch.cuda.synchronize()
        line["times"] = _times(rows, quick)
        emit(line)
    emit({"yardsticks": _yardsticks(quick, parent)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
