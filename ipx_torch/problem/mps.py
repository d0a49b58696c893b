"""MPS file reader (SURVEY.md component N3; BASELINE.json config 2).

Parses the (free-format) MPS dialect used by the Netlib LP collection into a
:class:`ipx_torch.problem.lp.GeneralLP`.  Two front ends share one semantic
builder:

  * a native C++ tokenizer/parser (``ipx_torch/native/mps_parser.cpp``, loaded
    via ctypes) — the fast path for large files;
  * a pure-Python parser — always available, the fallback and the reference
    for the shared semantics.

Both produce the same flat :class:`ParsedMPS`; all MPS semantics (L/G/E
conversion, RANGES expansion, bound-record application order including the
netlib negative-UP convention, OBJSENSE negation) are applied afterwards in
:func:`_build_general_lp`, so the parsers cannot diverge behaviorally.
Supported sections: NAME, OBJSENSE, ROWS (N/L/G/E), COLUMNS, RHS, RANGES,
BOUNDS (LO/UP/FX/FR/MI/PL/BV/LI/UI).  Integer markers raise (LP solver only).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np

from ipx_torch.problem.lp import GeneralLP


class MPSError(ValueError):
    pass


# bound-record codes shared with the native parser
_B_LO, _B_UP, _B_FX, _B_FR, _B_MI, _B_PL = range(6)


@dataclass
class ParsedMPS:
    """Flat parse result — identical from both front ends."""
    name: str
    maximize: bool
    row_types: np.ndarray    # (m,) uint8: ord('L'|'G'|'E')
    rhs: np.ndarray          # (m,)
    has_range: np.ndarray    # (m,) bool
    ranges: np.ndarray       # (m,)
    n_cols: int
    ent_row: np.ndarray      # (nnz,) int32
    ent_col: np.ndarray      # (nnz,) int32
    ent_val: np.ndarray      # (nnz,)
    obj_col: np.ndarray      # int32
    obj_val: np.ndarray
    bounds: list = field(default_factory=list)  # [(code, col, val)] in order
    obj_rhs: float = 0.0     # RHS entry on the objective row (negated const)


# ---------------------------------------------------------------------------
# pure-Python front end
# ---------------------------------------------------------------------------

def _parse_python(text: str) -> ParsedMPS:
    name = ""
    maximize = False
    section = None
    obj_row = None
    row_types: dict[str, str] = {}
    row_order: list[str] = []
    ridx: dict[str, int] = {}
    col_idx: dict[str, int] = {}
    ent_row: list[int] = []
    ent_col: list[int] = []
    ent_val: list[float] = []
    obj_c: list[int] = []
    obj_v: list[float] = []
    rhs: dict[str, float] = {}
    ranges: dict[str, float] = {}
    bounds: list = []
    obj_rhs = 0.0

    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        is_header = raw[0] not in " \t"
        tok = raw.split()
        if is_header:
            head = tok[0].upper()
            if head == "NAME":
                name = tok[1] if len(tok) > 1 else ""
                section = "NAME"
            elif head == "OBJSENSE":
                section = "OBJSENSE"
                if len(tok) > 1:
                    maximize = tok[1].upper().startswith("MAX")
            elif head in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS"):
                section = head
            elif head == "ENDATA":
                break
            else:
                raise MPSError(f"unknown MPS section {head!r}")
            continue

        if section == "OBJSENSE":
            maximize = tok[0].upper().startswith("MAX")
        elif section == "ROWS":
            rt, rname = tok[0].upper(), tok[1]
            if rt not in ("N", "L", "G", "E"):
                raise MPSError(f"bad row type {rt!r}")
            if rt == "N":
                if obj_row is None:
                    obj_row = rname
            else:
                row_types[rname] = rt
                ridx[rname] = len(row_order)
                row_order.append(rname)
        elif section == "COLUMNS":
            if len(tok) >= 3 and tok[1].upper() == "'MARKER'":
                if any("INTORG" in t.upper() for t in tok):
                    raise MPSError("integer variables not supported (LP only)")
                continue
            cname = tok[0]
            cj = col_idx.setdefault(cname, len(col_idx))
            pairs = tok[1:]
            if len(pairs) % 2:
                raise MPSError(f"odd COLUMNS entry: {raw!r}")
            for r, v in zip(pairs[::2], pairs[1::2]):
                if r == obj_row:
                    obj_c.append(cj)
                    obj_v.append(float(v))
                elif r in ridx:
                    ent_row.append(ridx[r])
                    ent_col.append(cj)
                    ent_val.append(float(v))
        elif section in ("RHS", "RANGES"):
            pairs = tok[1:] if len(tok) % 2 else tok
            tgt = rhs if section == "RHS" else ranges
            for r, v in zip(pairs[::2], pairs[1::2]):
                if section == "RHS" and r == obj_row:
                    # standard MPS: RHS on the N row is the NEGATED
                    # objective constant (several Netlib files use this)
                    obj_rhs = float(v)
                else:
                    tgt[r] = float(v)
        elif section == "BOUNDS":
            bt = tok[0].upper()
            if bt in ("LO", "UP", "FX", "LI", "UI"):
                if len(tok) < 4:
                    raise MPSError(f"bad bound line: {raw!r}")
                cname, val = tok[2], float(tok[3])
            elif bt in ("FR", "MI", "PL"):
                cname, val = tok[2], 0.0
            elif bt == "BV":
                raise MPSError("binary variables not supported (LP only)")
            else:
                raise MPSError(f"bad bound type {bt!r}")
            if cname not in col_idx:
                raise MPSError(f"bound on unknown column {cname!r}")
            code = {"LO": _B_LO, "LI": _B_LO, "UP": _B_UP, "UI": _B_UP,
                    "FX": _B_FX, "FR": _B_FR, "MI": _B_MI, "PL": _B_PL}[bt]
            bounds.append((code, col_idx[cname], val))
        elif section in ("NAME", None):
            continue
        else:
            raise MPSError(f"data line outside a section: {raw!r}")

    if obj_row is None:
        raise MPSError("no objective (N) row")

    m = len(row_order)
    return ParsedMPS(
        name=name, maximize=maximize,
        row_types=np.frombuffer(
            "".join(row_types[r] for r in row_order).encode(), np.uint8
        ).copy() if m else np.zeros(0, np.uint8),
        rhs=np.array([rhs.get(r, 0.0) for r in row_order]),
        has_range=np.array([r in ranges for r in row_order], bool),
        ranges=np.array([ranges.get(r, 0.0) for r in row_order]),
        n_cols=len(col_idx),
        ent_row=np.asarray(ent_row, np.int32),
        ent_col=np.asarray(ent_col, np.int32),
        ent_val=np.asarray(ent_val, np.float64),
        obj_col=np.asarray(obj_c, np.int32),
        obj_val=np.asarray(obj_v, np.float64),
        bounds=bounds,
        obj_rhs=obj_rhs,
    )


# ---------------------------------------------------------------------------
# native (C++) front end
# ---------------------------------------------------------------------------

def _parse_native(text: str) -> ParsedMPS | None:
    from ipx_torch import native
    lib = native.load_mps_lib()
    if lib is None:
        return None
    data = text.encode()
    errbuf = ctypes.create_string_buffer(512)
    h = lib.ipx_mps_parse(data, len(data), errbuf, len(errbuf))
    if not h:
        raise MPSError(errbuf.value.decode() or "native MPS parse failed")
    try:
        counts = (ctypes.c_int64 * 6)()
        lib.ipx_mps_counts(h, counts)
        m, n, nnz, nobj, nbnd, flags = (int(counts[i]) for i in range(6))

        def arr(shape, dtype):
            return np.zeros(shape, dtype)

        row_types = arr(m, np.int32)
        rhs = arr(m, np.float64)
        has_range = arr(m, np.uint8)
        ranges = arr(m, np.float64)
        ent_row = arr(nnz, np.int32)
        ent_col = arr(nnz, np.int32)
        ent_val = arr(nnz, np.float64)
        obj_col = arr(nobj, np.int32)
        obj_val = arr(nobj, np.float64)
        obj_rhs = float(lib.ipx_mps_obj_rhs(h))
        bnd_type = arr(nbnd, np.int32)
        bnd_col = arr(nbnd, np.int32)
        bnd_val = arr(nbnd, np.float64)
        ptrs = [a.ctypes.data_as(ctypes.c_void_p) for a in
                (row_types, rhs, has_range, ranges, ent_row, ent_col,
                 ent_val, obj_col, obj_val, bnd_type, bnd_col, bnd_val)]
        lib.ipx_mps_fill(h, *ptrs)
        name = lib.ipx_mps_name(h).decode()
    finally:
        lib.ipx_mps_free(h)

    return ParsedMPS(
        name=name, maximize=bool(flags & 1),
        row_types=row_types.astype(np.uint8),
        rhs=rhs, has_range=has_range.astype(bool), ranges=ranges,
        n_cols=n,
        ent_row=ent_row, ent_col=ent_col, ent_val=ent_val,
        obj_col=obj_col, obj_val=obj_val,
        bounds=[(int(t), int(c), float(v))
                for t, c, v in zip(bnd_type, bnd_col, bnd_val)],
        obj_rhs=obj_rhs,
    )


# ---------------------------------------------------------------------------
# shared semantic builder
# ---------------------------------------------------------------------------

def _build_general_lp(p: ParsedMPS) -> GeneralLP:
    m, n = len(p.row_types), p.n_cols
    A = np.zeros((m, n))
    np.add.at(A, (p.ent_row, p.ent_col), p.ent_val)
    c = np.zeros(n)
    np.add.at(c, p.obj_col, p.obj_val)

    # vectorized constraint-form construction (row order within A_ub/A_eq is
    # irrelevant to the LP; both parser front ends share this builder)
    t = p.row_types
    hr = p.has_range
    is_eq = (t == ord("E")) & ~hr
    is_l = (t == ord("L")) & ~hr
    is_g = (t == ord("G")) & ~hr
    A_eq_rows = list(A[is_eq])
    b_eq = list(p.rhs[is_eq])
    A_ub_rows = list(A[is_l]) + list(-A[is_g])
    b_ub = list(p.rhs[is_l]) + list(-p.rhs[is_g])
    if hr.any():
        bi = p.rhs[hr]
        rv = p.ranges[hr]
        tr = t[hr]
        lo = np.where(tr == ord("L"), bi - np.abs(rv),
                      np.where(tr == ord("G"), bi,
                               np.where(rv >= 0, bi, bi + rv)))
        hi = np.where(tr == ord("L"), bi,
                      np.where(tr == ord("G"), bi + np.abs(rv),
                               np.where(rv >= 0, bi + rv, bi)))
        A_ub_rows += list(A[hr]) + list(-A[hr])
        b_ub += list(hi) + list(-lo)

    # bound records in file order (netlib UP-negative convention included)
    lb_val = np.zeros(n)
    ub_val = np.full(n, np.inf)
    lb_set = np.zeros(n, bool)
    ub_set = np.zeros(n, bool)
    free = np.zeros(n, bool)
    for code, j, v in p.bounds:
        if code == _B_LO:
            lb_val[j] = v; lb_set[j] = True
        elif code == _B_UP:
            ub_val[j] = v; ub_set[j] = True
            if v < 0 and not lb_set[j]:
                lb_val[j] = -np.inf; lb_set[j] = True
        elif code == _B_FX:
            lb_val[j] = v; lb_set[j] = True
            ub_val[j] = v; ub_set[j] = True
        elif code == _B_FR:
            free[j] = True
        elif code == _B_MI:
            lb_val[j] = -np.inf; lb_set[j] = True
        elif code == _B_PL:
            ub_val[j] = np.inf; ub_set[j] = True

    lbv = np.zeros(n)
    ubv = np.full(n, np.inf)
    lbv[free] = -np.inf
    ubv[free] = np.inf
    lbv[lb_set] = lb_val[lb_set]
    ubv[ub_set] = ub_val[ub_set]

    # objective constant: RHS on the N row is the negated constant, so the
    # original objective is  c@x - obj_rhs  (in the file's optimization
    # sense).  GeneralLP stores the MINIMIZE form; for maximize files both c
    # and the constant flip sign.
    k = -p.obj_rhs
    if p.maximize:
        c = -c
        k = -k

    glp = GeneralLP(
        c=c,
        A_ub=np.array(A_ub_rows).reshape(-1, n) if A_ub_rows else None,
        b_ub=np.array(b_ub) if A_ub_rows else None,
        A_eq=np.array(A_eq_rows).reshape(-1, n) if A_eq_rows else None,
        b_eq=np.array(b_eq) if A_eq_rows else None,
        lb=lbv, ub=ubv, name=p.name, obj_offset=k,
    )
    glp.maximize = p.maximize   # objective was negated; flag for reporting
    return glp


def read_mps_string(text: str, use_native: bool | None = None) -> GeneralLP:
    """Parse MPS text into a GeneralLP.

    ``use_native=None`` tries the C++ parser and falls back to Python;
    True forces native (raises if unavailable); False forces Python.
    """
    if use_native is False:
        return _build_general_lp(_parse_python(text))
    parsed = _parse_native(text)
    if parsed is None:
        if use_native:
            raise MPSError("native MPS parser unavailable (no C++ toolchain)")
        parsed = _parse_python(text)
    return _build_general_lp(parsed)


def read_mps(path: str, use_native: bool | None = None) -> GeneralLP:
    with open(path) as f:
        return read_mps_string(f.read(), use_native)
