"""Launch geometry and shared-memory sizes that the Python wrappers compute
for the CUDA kernels, against the formulas and constants of the sources they
mirror, and the matvec wrappers' refusals.  The kernels themselves run on
the card only (``chip_smoke.py``); what is checked here needs no GPU: a
wrong mirror allocates a scratch of the wrong size or refuses an m the
kernel takes.
"""
import re
from pathlib import Path

import pytest
import torch

from ipx_torch.kernels import _build
from ipx_torch.kernels import fused as tfk

torch.set_num_threads(1)

CSRC = Path(_build.CSRC)


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    found = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*(\d+)", text)
    assert found, f"{name} not in {source}"
    return int(found.group(1))


def test_stripe_constants_match_the_source():
    assert _constant("fused_matvec.cu", "THREADS") == tfk._THREADS
    assert _constant("fused_matvec.cu", "CLUSTER") == tfk._CLUSTER
    assert _constant("fused_matvec.cu", "NCHUNK") == tfk._NCHUNK
    text = (CSRC / "fused_matvec.cu").read_text()
    assert "SMEM_LIMIT = 227u * 1024u" in text
    assert tfk._SMEM_LIMIT == 227 * 1024


def test_stripe_smem_formula_matches_the_source():
    text = (CSRC / "fused_matvec.cu").read_text()
    assert ("return BARS_BYTES + round16(size_t(m) * W * itemsize)\n"
            "           + size_t(WARPS + 1) * W * sizeof(double)"
            " + size_t(m) * sizeof(double);") in text
    assert "BARS_BYTES = NCHUNK * sizeof(uint64_t)" in text


@pytest.mark.parametrize("m,W,itemsize,nbytes", [
    # eight copy barriers; stripe rows unpadded (swizzled granules),
    # 16-byte rounded; the 8 warps' phase-1 column sums, u and v as doubles
    (1024, 32, 2, 64 + 1024 * 32 * 2 + 9 * 32 * 8 + 1024 * 8),
    (1024, 16, 4, 64 + 1024 * 16 * 4 + 9 * 16 * 8 + 1024 * 8),
    (1000, 16, 4, 64 + 1000 * 16 * 4 + 9 * 16 * 8 + 1000 * 8),
    (3, 8, 2, 64 + 48 + 9 * 8 * 8 + 3 * 8),
])
def test_stripe_smem_bytes(m, W, itemsize, nbytes):
    assert tfk._stripe_smem_bytes(m, W, itemsize) == nbytes


@pytest.mark.parametrize("m,itemsize,W", [
    # the largest m a stripe of 8 columns takes: 24 m + 640 bytes of bf16,
    # 40 m + 640 of f32 (9596 and 5758 with the padded rows and float v of
    # earlier kernels: not lowered)
    (9658, 2, 8), (9659, 2, None), (5795, 4, 8), (5796, 4, None),
    # the main path's width: 32 columns a stripe
    (1024, 2, 32), (1024, 4, 16),
])
def test_stripe_m_limits(m, itemsize, W):
    assert tfk.stripe_cols(m, itemsize) == W


def test_three_stripe_blocks_share_an_sm():
    assert 3 * (tfk._stripe_smem_bytes(1024, 32, 2) + 1024) <= 228 * 1024


@pytest.mark.parametrize("n,W,partials", [
    (2048, 32, 32),         # the main path: 64 stripes, pairs
    (2045, 32, 32),         # ragged last stripe, same pairs
    (2080, 32, 33),         # 65 stripes: the grid rounds up to 66
    (128, 32, 2),
    (32, 32, 1),            # one stripe, padded to a pair
    (24, 8, 2),             # 3 stripes, rounded up to 4
])
def test_stripe_partials(n, W, partials):
    assert tfk.stripe_partials(n, W) == partials


def _c_expr(expr: str) -> str:
    """A C integer expression of the sources as Python: comments dropped,
    unsigned suffixes dropped, division truncating, && as and, || as or,
    lines joined."""
    expr = re.sub(r"//[^\n]*", "", expr)
    expr = re.sub(r"\b(\d+)u\b", r"\1", expr)
    expr = expr.replace("/", "//").replace("&&", " and ").replace("||", " or ")
    return "(" + expr + ")"


def _constexprs(*sources: str) -> dict:
    """The integer ``constexpr`` values of the sources, evaluated in order
    (``size_t(x)`` as x, ``sizeof`` of the types they use, the build's
    ``IPX_PANEL_MAX_M``); those that need what is not known here are left
    out."""
    env = {"size_t": int, "sizeof": lambda t: t, "float": 4, "double": 8,
           "short2": 4, "IPX_PANEL_MAX_M": _build.PANEL_MAX_M}
    for source in sources:
        text = re.sub(r"//[^\n]*", "", (CSRC / source).read_text())
        for name, expr in re.findall(
                r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*([^;]+);", text):
            try:
                env[name] = eval(_c_expr(expr), {}, env)  # noqa: S307
            except (NameError, SyntaxError):
                continue
    return env


def _static_asserts(source: str) -> list:
    """The conditions of the source's static_asserts, as Python."""
    text = re.sub(r"//[^\n]*", "", (CSRC / source).read_text())
    return [_c_expr(c) for c in
            re.findall(r"static_assert\(\s*([^,]+),", text)]


def test_fused_panel_smem_fits_one_block():
    """The ring of the tensor-core panel kernel (raw stages and the split
    tiles), as the source computes it, within the 227 KB one block may ask
    for; its static_asserts hold, and the size in its comment is right."""
    c = _constexprs("panel_common.cuh", "fused_panel.cu")
    text = (CSRC / "fused_panel.cu").read_text()
    assert c["FUSED_SMEM"] <= 227 * 1024
    assert f"// {c['FUSED_SMEM']}" in text
    asserts = _static_asserts("fused_panel.cu")
    assert len(asserts) == 3
    for cond in asserts:
        assert eval(cond, {}, c), cond  # noqa: S307 - own source
    # the ring and the split tiles, then the first tile's diagonal sums on
    # the CUDA cores (the assembly's and the subtraction's, two halves each)
    assert c["FUSED_SMEM"] == (4 * (128 * 64 * 2 + 128 * 72 * 2 + 64 * 4)
                               + 3 * 128 * 72 * 2 + 2 * 256 * 4)
    # the launch asks for exactly that size
    assert "int(FUSED_SMEM)" in text and "FT, FUSED_SMEM," in text


def test_assembly_smem_fits_one_block():
    """The bf16 assembly's ring, split tiles and staged output tile, as the
    source computes them, within the 227 KB one block may ask for; its
    static_assert (the finished tile fits the ring's region) holds, the size
    in its comment is right, and the launch asks for exactly that.  The
    float32 A launches the warp-specialised kernel with its own size."""
    c = _constexprs("panel_common.cuh", "mma_common.cuh", "assemble_sym.cu")
    text = (CSRC / "assemble_sym.cu").read_text()
    assert c["ASM_SMEM"] <= 227 * 1024
    assert f"// {c['ASM_SMEM']}" in text
    assert c["OUT_B"] == c["TILE"] * (c["TILE"] + 1) * 4
    asserts = [a for a in _static_asserts("assemble_sym.cu")
               if "RSTAGES * RSTAGE_B" in a and "WRSTAGES" not in a]
    assert len(asserts) == 1
    for cond in asserts:
        assert eval(cond, {}, c), cond  # noqa: S307 - own source
    assert "int(ASM_SMEM)" in text and "FT, ASM_SMEM," in text
    # the float32 A: the tensor-core kernel, split operands on both sides
    assert ("assemble_sym_f32_tc_kernel<<<grid, WAT, F32_SMEM, stream>>>("
            in text)


def test_diag_factor_inv_smem_lets_two_blocks_share_an_sm():
    """The diagonal kernel (row 5b): the tile as float32 with a padded row
    and the block column's C as doubles, as the source computes it and as
    its comment says; two blocks of 256 threads an SM (228 KB, 1 KB
    reserved for each), so B = 256 runs in one wave on 132 SMs; the launch
    asks for exactly that size."""
    c = _constexprs("panel_common.cuh", "factor_panels.cu")
    text = (CSRC / "factor_panels.cu").read_text()
    assert (c["DN"], c["DL"], c["DTHREADS"]) == (128, 32, 256)
    assert c["DIAG_SMEM"] == 128 * 129 * 4 + 128 * 33 * 8 == 99840
    assert f"// {c['DIAG_SMEM']}" in text
    assert 2 * (c["DIAG_SMEM"] + 1024) <= 228 * 1024 \
        < 3 * (c["DIAG_SMEM"] + 1024)
    asserts = [a for a in _static_asserts("factor_panels.cu")
               if "DIAG_SMEM" in a]
    assert len(asserts) == 1 and eval(asserts[0], {}, c)  # noqa: S307
    assert "__launch_bounds__(DTHREADS, 2)" in text
    assert "int(DIAG_SMEM)" in text and "DTHREADS, DIAG_SMEM," in text


def test_right_factor_smem_lets_two_blocks_share_an_sm():
    """Row 9's tensor-core tile product: two raw stages of both 128 x 16
    float32 operands, six split bf16 tiles with padded rows and the
    diagonal's CUDA-core sums, as the source computes it and as its comment
    says; two blocks of 256 threads an SM, as the launch bounds count on
    (228 KB, 1 KB reserved for each); every static_assert holds; both
    launches ask for exactly that size and share the header's helpers."""
    c = _constexprs("panel_common.cuh", "cholesky_right.cu")
    text = (CSRC / "cholesky_right.cu").read_text()
    assert (c["RT"], c["RCK"], c["RSTAGES"], c["RBLOCKS"]) == (256, 16, 2, 2)
    assert c["RIGHT_SMEM"] == (2 * 2 * 128 * 16 * 4 + 6 * 128 * 24 * 2
                               + 128 * 4) == 70144
    assert f"// {c['RIGHT_SMEM']}" in text
    assert 2 * (c["RIGHT_SMEM"] + 1024) <= 228 * 1024
    asserts = _static_asserts("cholesky_right.cu")
    assert len(asserts) == 3
    for cond in asserts:
        assert eval(cond, {}, c), cond  # noqa: S307 - own source
    assert text.count("__launch_bounds__(RT, RBLOCKS)") == 2
    assert text.count("RT, RIGHT_SMEM,") == 2
    assert '#include "mma_common.cuh"' in text and "mma_add(" in text


def test_right_entry_args_match_the_source():
    """The argument types ``cholesky_batched`` (and the probes that launch
    another build of the source) give row 9's two C entry points, against
    their declarations: a pointer for each pointer, a C int for each int."""
    import ctypes

    from ipx_torch.kernels import cholesky as tpk

    text = (CSRC / "cholesky_right.cu").read_text()
    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int}
    for name, args in tpk.RIGHT_ENTRY_ARGS.items():
        found = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert found, name
        params = [p.strip() for p in found.group(1).split(",")]
        want = [kinds["ptr" if "*" in p else p.split()[0]] for p in params]
        assert args == want, (name, params)


def test_assembly_f32_smem_and_registers_fit_one_block():
    """Row 4's float32 kernel (warp-specialised, as rows 7 and 10, with two
    producer warpgroups): the split ring first (core matrices from a 1
    KB-aligned offset), the raw ring of both operands' padded rows and d2,
    the parked chunk sums, the diagonal's CUDA-core sums and the mbarriers,
    as the source computes them and as its comment says, within the 227 KB
    one block may ask for; the finished tile staged over the raw ring and
    the park; one block of 512 threads an SM, whose 128 registers a thread
    the setmaxnreg handover only moves; every static_assert holds; the
    launch asks for exactly that size."""
    c = _constexprs("panel_common.cuh", "mma_common.cuh", "assemble_sym.cu")
    text = (CSRC / "assemble_sym.cu").read_text()
    assert (c["WCT"], c["WPG"], c["WPT"], c["WAT"], c["WCK"]) == \
        (256, 2, 256, 512, 16)
    assert (c["WRSTAGES"], c["WSSTAGES"], c["WSTEPS"], c["WRLD"]) == \
        (4, 3, 4, 20)
    assert c["SSTAGE_B"] == 6 * 128 * 16 * 2
    assert c["WRAW_OFF"] == 3 * 6 * 4096 and c["WRAW_OFF"] % 1024 == 0
    assert c["F32_SMEM"] == (3 * 6 * 4096 + 4 * (2 * 128 * 20 * 4 + 16 * 4)
                             + 64 * 256 * 4 + 128 * 4 + 2 * 3 * 8) == 222000
    assert c["F32_SMEM"] <= 227 * 1024
    assert f"// {c['F32_SMEM']}" in text
    assert c["OUT_B"] <= c["WRSTAGES"] * c["WRSTAGE_B"] + c["WPARK_B"]
    assert c["WPARK_OFF"] == c["WRAW_OFF"] + c["WRSTAGES"] * c["WRSTAGE_B"]
    # padded raw rows: the 16-byte reads of 8 consecutive rows hit 8
    # distinct groups of 4 banks
    assert len({(r * c["WRLD"] // 4) % 8 for r in range(8)}) == 8
    assert c["W_LAUNCH_REGS"] == 65536 // 512 // 8 * 8 == 128
    assert (c["W_CONSUMER_REGS"], c["W_PRODUCER_REGS"]) == (200, 56)
    assert 256 * 200 + 256 * 56 == 512 * c["W_LAUNCH_REGS"]
    asserts = [a for a in _static_asserts("assemble_sym.cu")
               if "W" in a or "F32_SMEM" in a]
    assert len(asserts) == 5
    for cond in asserts:
        assert eval(cond, {}, c), cond  # noqa: S307 - own source
    assert "__launch_bounds__(WAT, 1)" in text
    assert "int(F32_SMEM)" in text and "WAT, F32_SMEM," in text
    assert "set_regs<false, W_PRODUCER_REGS>();" in text
    assert "set_regs<true, W_CONSUMER_REGS>();" in text
    # the shared pipeline: six cross products, hi.hi alone, 64-column chunks
    assert "consume<WSTEPS, WSSTAGES, WCT, true>(" in text
    assert "produce<WRSTAGES, WSSTAGES, WPT>(" in text
    # bf16 parts on the tensor cores, no TF32 in the kernel or the pipeline
    header = (CSRC / "mma_common.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in header
    for src in (text, header):
        assert "tf32" not in re.sub(r"//[^\n]*", "", src).lower()


def test_assemble_entry_args_match_the_source():
    """The argument types ``assemble_sym_batched`` gives the assembly's C
    entry point, against its declaration: a pointer for each pointer, a C
    int for each int."""
    import ctypes

    from ipx_torch.kernels import cholesky as tpk

    text = (CSRC / "assemble_sym.cu").read_text()
    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int}
    assert set(tpk.ASSEMBLE_ENTRY_ARGS) == set(
        re.findall(r'extern "C" int (\w+)\(', text))
    for name, args in tpk.ASSEMBLE_ENTRY_ARGS.items():
        found = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert found, name
        params = [p.strip() for p in found.group(1).split(",")]
        want = [kinds["ptr" if "*" in p else p.split()[0]] for p in params]
        assert args == want, (name, params)


def test_accum_panel_smem_and_registers_fit_one_block():
    """Rows 7 and 10's warp-specialised kernels: the raw ring, the split
    ring, the parked totals, two tiles of diagonal sums and the mbarriers,
    as the source computes them and as its comment says, within the 227 KB
    one block may ask for; one block of 384 threads an SM, whose 168
    registers a thread the setmaxnreg handover only moves (a consumer
    asking for more than the producers gave back would wait for ever);
    every static_assert holds; both launches ask for exactly that size."""
    c = _constexprs("panel_common.cuh", "mma_common.cuh", "accum_panel.cu")
    text = (CSRC / "accum_panel.cu").read_text()
    header = (CSRC / "mma_common.cuh").read_text()
    assert (c["CT"], c["PT"], c["AT"], c["CK"]) == (256, 128, 384, 16)
    assert (c["RSTAGES"], c["SSTAGES"]) == (4, 3)
    assert c["PART_B"] == 128 * 16 * 2
    assert c["ACCUM_SMEM"] == (4 * 2 * 128 * 16 * 4 + 3 * 6 * 4096
                               + 64 * 256 * 4 + 128 * 4 + 2 * 3 * 8)
    assert c["ACCUM_SMEM"] <= 227 * 1024
    assert f"// {c['ACCUM_SMEM']}" in text
    assert c["LAUNCH_REGS"] == 65536 // 384 // 8 * 8 == 168
    # the split for each consumer kind: wgmma, then mma.sync
    regs = {}
    for who in ("consumer", "producer"):
        found = re.search(rf"{who} = WG \? (\d+) : (\d+);", text)
        assert found, who
        regs[who] = (int(found.group(1)), int(found.group(2)))
    assert regs == {"consumer": (200, 224), "producer": (104, 56)}
    for wg in (0, 1):
        assert (256 * regs["consumer"][wg] + 128 * regs["producer"][wg]
                == 384 * c["LAUNCH_REGS"])
    asserts = _static_asserts("accum_panel.cu")
    assert len(asserts) == 5
    for cond in asserts:
        for kind, wg in (("true", 0), ("false", 1)):
            for who in ("consumer", "producer"):
                cond = cond.replace(f"Regs<{kind}>::{who}",
                                    str(regs[who][wg]))
        assert eval(cond, {}, c), cond  # noqa: S307 - own source
    assert text.count("__launch_bounds__(AT, 1)") == 2
    assert "int(ACCUM_SMEM)" in text and text.count("AT, ACCUM_SMEM,") == 2
    assert "setmaxnreg.inc" in header and "setmaxnreg.dec" in header
    assert text.count("set_regs<true,") == 2 \
        and text.count("set_regs<false,") == 2
    # the split parts (mma_common.cuh): 8 x 8 core matrices, row n,
    # contraction half kh
    assert ("return (n >> 3) * 128 + kh * 64 + (n & 7) * 8;" in header)
    assert ("(uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32)"
            in header)


def test_accum_entry_args_match_the_source():
    """The argument types the factor wrappers (and the probes that launch
    another build of the source) give rows 7 and 10's three C entry points,
    against their declarations: a pointer for each pointer, a C int for
    each int."""
    import ctypes

    from ipx_torch.kernels import cholesky as tpk

    text = (CSRC / "accum_panel.cu").read_text()
    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int}
    assert set(tpk.ACCUM_ENTRY_ARGS) == set(
        re.findall(r'extern "C" int (\w+)\(', text))
    for name, args in tpk.ACCUM_ENTRY_ARGS.items():
        found = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        assert found, name
        params = [p.strip() for p in found.group(1).split(",")]
        want = [kinds["ptr" if "*" in p else p.split()[0]] for p in params]
        assert args == want, (name, params)
    # the CUDA-core panel kernels are gone from the diagonal kernel's source
    old = (CSRC / "factor_panels.cu").read_text()
    for name in tpk.ACCUM_ENTRY_ARGS:
        assert name not in old, name


def test_tensor_core_sources_share_one_mma_header():
    """The tensor-core kernels include the shared header and define none of
    its helpers again."""
    helpers = ("void cp16(", "void ldm_x4(", "void mma(", "void mma_add(",
               "void split2(", "void split8(", "void ring(", "typedef float Frag",
               "void zero_frag(", "void add_frag(", "int core_off(",
               "uint64_t part_desc(", "void bar_init(", "void bar_arrive(",
               "void bar_wait(", "void set_regs(", "void wgmma128(",
               "void produce(", "void wg_step(", "void consume(")
    header = (CSRC / "mma_common.cuh").read_text()
    for h in helpers:
        assert h in header, h
    for source in ("fused_panel.cu", "assemble_sym.cu", "cholesky_right.cu",
                   "accum_panel.cu"):
        text = (CSRC / source).read_text()
        assert '#include "mma_common.cuh"' in text, source
        for h in helpers:
            assert h not in text, (source, h)


def _pair_smem(nb: int, c: dict) -> int:
    """Shared memory of a pair-solve block for nb column blocks, by the
    layout the source documents: the copy ring; its own blocks of r and x,
    y_k and the partials two steps each, the row-group partials and one
    vector, as doubles; the tile list, two shorts an entry."""
    own = -(-nb // c["CL"])
    doubles = (2 * own * 128 + 2 * 128 + 2 * c["CL"] * 128
               + c["PWARPS"] * 128 + 128)
    return (c["RING"] * c["CHUNK_F"] * 4 + 8 * doubles
            + 4 * 2 * own * (nb + 1))


def test_pair_solve_smem_formula_matches_the_source():
    text = (CSRC / "solve_panels.cu").read_text()
    assert ("constexpr int owned(int nb) { return (nb + CL - 1) / CL; }"
            in text)
    assert ("constexpr int list_len(int nb) "
            "{ return 2 * owned(nb) * (nb + 1); }") in text
    assert ("""    return size_t(RING) * CHUNK_F * sizeof(float)
        + (size_t(2) * owned(nb) * NB + 2 * NB + size_t(2) * CL * NB
           + size_t(PWARPS) * NB + NB) * sizeof(double)
        + size_t(list_len(nb)) * sizeof(short2);""") in text
    assert "static_assert(pair_smem_bytes(MAX_PANELS) <= SMEM_LIMIT," in text
    # the launch asks for the size of its m, the attribute for the largest
    assert "cfg.dynamicSmemBytes = pair_smem_bytes(nb);" in text
    assert "int(pair_smem_bytes(MAX_PANELS))" in text


@pytest.mark.parametrize("m,nbytes,per_sm", [
    # ring 3 x 16 KB; doubles: r and x of its own blocks (all nb of them),
    # y_k and partials two steps each, eight row groups, one vector; the
    # tile list 2 nb (nb + 1) entries of 4 bytes
    # the largest m: one block an SM
    (_build.PANEL_MAX_M, 49152 + 8 * (2 * 38 * 128 + 4 * 128 + 9 * 128)
     + 4 * 2 * 38 * 39, 1),
    # the main path's m: two blocks share an SM (228 KB, 1 KB reserved for
    # each), so a batch of 256 runs at once on 132 SMs
    (1024, 49152 + 8 * (2 * 8 * 128 + 4 * 128 + 9 * 128) + 4 * 2 * 8 * 9, 2),
    (128, 49152 + 8 * (2 * 128 + 4 * 128 + 9 * 128) + 4 * 2 * 2, 3),
])
def test_pair_solve_smem(m, nbytes, per_sm):
    """The cluster pair-solve's constants (a cluster of CL blocks of 256
    threads, 32-row chunks of 16 KB in a ring of three) and its shared memory
    per block at m, within one block's 227 KB; every static_assert of the
    source holds."""
    c = _constexprs("panel_common.cuh", "solve_panels.cu")
    assert c["MAX_PANELS"] == _build.PANEL_MAX_M // 128 == 38
    assert (c["CL"], c["PT"], c["RCH"], c["CHUNKS"], c["RING"]) == \
        (1, 256, 32, 4, 3)
    assert _pair_smem(m // 128, c) == nbytes
    assert nbytes <= c["SMEM_LIMIT"] == 227 * 1024
    assert per_sm * (nbytes + 1024) <= 228 * 1024 < \
        (per_sm + 1) * (nbytes + 1024)
    env = dict(c, pair_smem_bytes=lambda nb: _pair_smem(nb, c))
    for cond in _static_asserts("solve_panels.cu"):
        if "tri_smem_bytes" in cond:
            continue                # a function of m: checked by nvcc
        assert eval(cond, {}, env), cond  # noqa: S307 - own source


def test_pair_solve_grid_is_the_clusters_the_card_runs():
    """The persistent grid: min(B, clusters resident at once) clusters of CL
    blocks, the clusters the card runs found by the occupancy query and the
    cluster size given at launch, not fixed in the kernel."""
    text = (CSRC / "solve_panels.cu").read_text()
    assert "cudaOccupancyMaxActiveClusters(&act, kern, &cfg)" in text
    assert "int& act = active[dev][nb];" in text
    assert "cfg.gridDim = dim3(CL * (B < act ? B : act));" in text
    assert "attr[0].val.clusterDim.x = CL;" in text
    assert "__cluster_dims__" not in text


def test_every_source_is_built():
    for src in CSRC.glob("*.cu"):
        assert src.stem in _build.SOURCES


A = torch.zeros(2, 64, 96)
V, W_ = torch.zeros(2, 64), torch.zeros(2, 96)

BAD_CALLS = [
    ("ata f64 A", lambda: tfk.ata_apply(A.double(), V, W_, W_), TypeError),
    ("ata rank", lambda: tfk.ata_apply(A[0], V[0], W_[0], W_[0]), ValueError),
    ("ata strided A", lambda: tfk.ata_apply(A.mT.contiguous().mT, V, W_, W_),
     ValueError),
    ("ata v shape", lambda: tfk.ata_apply(A, W_, W_, W_), ValueError),
    ("ata alpha f64", lambda: tfk.ata_apply(A, V, W_.double(), W_), TypeError),
    ("ata beta shape", lambda: tfk.ata_apply(A, V, W_, W_, beta=V), ValueError),
    ("ata w elsewhere", lambda: tfk.ata_apply(A, V, W_, W_.to("meta")),
     ValueError),
    ("a bf16 w", lambda: tfk.a_matvec(A, W_.to(torch.bfloat16)), TypeError),
    ("a w shape", lambda: tfk.a_matvec(A, V), ValueError),
    ("at v strided", lambda: tfk.at_matvec(A, torch.zeros(2, 128)[:, ::2]),
     ValueError),
    ("at int A", lambda: tfk.at_matvec(A.int(), V), TypeError),
]


@pytest.mark.parametrize("name,call,exc", BAD_CALLS,
                         ids=[c[0] for c in BAD_CALLS])
def test_matvec_wrappers_refuse_wrong_inputs(name, call, exc):
    before = dict(tfk.LAUNCHES)
    with pytest.raises(exc):
        call()
    assert dict(tfk.LAUNCHES) == before


# --------------------------------------------------------------------------
# rows 2 and 3: the row streams of csrc/row_matvec.cu
# --------------------------------------------------------------------------

def _row_blocks(m: int, n: int, itemsize: int) -> tuple[int, int]:
    """Blocks an instance of rows 2 and 3 launches, as ``launch_a`` and
    ``launch_at`` of the source count them: (row blocks of ROWS_A x spans,
    tiles x warp steps of 32 granules)."""
    step = 32 * 16 // itemsize
    a = -(-m // tfk._ROWS_A) * -(-n // tfk.a_span(n, itemsize))
    at = -(-m // tfk.at_tile(itemsize)) * -(-n // step)
    return a, at


def test_row_constants_match_the_source():
    c = _constexprs("row_matvec.cu")
    text = (CSRC / "row_matvec.cu").read_text()
    # the grids _row_blocks mirrors
    assert ("const int nrb = (m + ROWS_A - 1) / ROWS_A, "
            "ns = (n + span - 1) / span;") in text
    assert ("const int nch = (n + CW - 1) / CW, "
            "nt = (m + tile - 1) / tile;") in text
    assert c["THREADS"] == tfk._ROW_THREADS
    assert c["SPAN_MAX"] == tfk._SPAN_MAX
    assert c["ROWS_A"] == tfk._ROWS_A
    assert c["TILE_BYTES"] == tfk._TILE_BYTES
    # w's span as doubles and row 3's v and warp sums (bf16: 256 columns a
    # block) are static shared memory, under the 48 KB a launch gets
    # without asking
    assert c["SPAN_MAX"] * 8 <= 48 * 1024
    assert (c["TILE_MAX"] + c["WARPS"] * 256) * 8 <= 48 * 1024
    # a block's rows are whole passes of its warps
    assert c["ROWS_A"] % (c["WARPS"] * c["RW"]) == 0


def test_row_entry_args_match_the_source():
    """The argument types the wrappers give the C entry points of rows 1-3,
    against their declarations: a pointer for each pointer, a C int for
    each int."""
    import ctypes

    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int}
    for name, (source, symbol, args) in tfk._ENTRIES.items():
        text = (CSRC / f"{source}.cu").read_text()
        found = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
        assert found, name
        params = [p.strip() for p in found.group(1).split(",")]
        want = [kinds["ptr" if "*" in p else p.split()[0]] for p in params]
        assert args == want, (name, params)


@pytest.mark.parametrize("n,itemsize,span,partials", [
    (2048, 2, 2048, 0),     # the main path: one span, y written at once
    (2048, 4, 2048, 0),
    (2045, 2, 2048, 0),     # rounded up to a warp's step (256 bf16 columns)
    (100, 4, 128, 0),       # (128 f32 columns)
    (4096, 2, 4096, 0),
    (4097, 2, 4096, 2),
    (16384, 4, 4096, 4),    # large_f32
    (65536, 2, 4096, 16),   # config 4: 16 partial y a row
])
def test_row_a_span_and_partials(n, itemsize, span, partials):
    assert tfk.a_span(n, itemsize) == span
    assert tfk.a_partials(n, itemsize) == partials
    # what the C entry accepts: a multiple of a warp's step, at most
    # SPAN_MAX
    step = 32 * 16 // itemsize
    assert span % step == 0 and step <= span <= tfk._SPAN_MAX


@pytest.mark.parametrize("m,itemsize,tile,partials", [
    (1024, 2, 2048, 0),     # the main path: one tile, t written at once
    (1024, 4, 1024, 0),
    (1000, 4, 1024, 0),
    (2100, 2, 2048, 2),     # chip_smoke.py's odd shape: a ragged tile
    (2100, 4, 1024, 3),
    (8192, 4, 1024, 8),     # large_f32
    (32768, 2, 2048, 16),   # config 4
])
def test_row_at_tile_and_partials(m, itemsize, tile, partials):
    assert tfk.at_tile(itemsize) == tile
    assert tfk.at_partials(m, itemsize) == partials
    # the partial t is 8 bytes a column for every TILE_BYTES of it
    assert 8 / (tile * itemsize) <= 0.002


@pytest.mark.parametrize("m,n,itemsize", [
    (32768, 65536, 2), (32768, 65536, 4), (8192, 16384, 4), (1024, 2048, 2),
    (9659, 2048, 2), (5796, 2048, 4), (1, 1, 2), (3, 5, 4)])
def test_rows_take_any_m(m, n, itemsize):
    """Rows 2 and 3 keep nothing of A in shared memory: every m and n has a
    tiling (up to config 4's m = 32768, n = 65536, past the stripe's m
    limit), its grid fits CUDA's, and its scratch is a few per cent of A's
    bytes at most."""
    a_blocks, at_blocks = _row_blocks(m, n, itemsize)
    assert 1 <= a_blocks < 2 ** 31 and 1 <= at_blocks < 2 ** 31
    a_bytes = m * n * itemsize
    scratch = 8 * (tfk.a_partials(n, itemsize) * m
                   + tfk.at_partials(m, itemsize) * n)
    assert scratch <= max(0.04 * a_bytes, 8 * (m + n))


@pytest.mark.parametrize("m,n,itemsize,blocks", [
    # rows of ROWS_A by spans; tiles by 32 granules of columns
    (1024, 2048, 2, (32, 1 * 8)),
    (1024, 2048, 4, (32, 1 * 16)),
    (32768, 65536, 2, (1024 * 16, 16 * 256)),
    (8192, 16384, 4, (256 * 4, 8 * 128)),
])
def test_row_grids_fill_the_card(m, n, itemsize, blocks):
    """An instance's blocks; at B = 256 on the main width and at B = 1 on
    the large LPs' shapes every grid is at least 7 blocks an SM of 132."""
    assert _row_blocks(m, n, itemsize) == blocks
    B = 256 if m == 1024 else 1
    assert min(blocks) * B >= 7 * 132
