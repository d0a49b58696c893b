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


def _constexprs(*sources: str) -> dict:
    """The integer ``constexpr`` values of the sources, evaluated in order
    (``size_t(x)`` as x); those that need what is not known here are left
    out."""
    env = {"size_t": int}
    for source in sources:
        text = (CSRC / source).read_text()
        for name, expr in re.findall(
                r"constexpr\s+(?:int|size_t)\s+(\w+)\s*=\s*([^;]+);", text):
            try:
                env[name] = eval(expr, {}, env)  # noqa: S307 - own source
            except (NameError, SyntaxError):
                continue
    return env


def test_fused_panel_smem_fits_one_block():
    """The ring of the tensor-core panel kernel (raw stages and the split
    tiles), as the source computes it, within the 227 KB one block may ask
    for; its static_asserts hold, and the size in its comment is right."""
    c = _constexprs("panel_common.cuh", "fused_panel.cu")
    text = (CSRC / "fused_panel.cu").read_text()
    assert c["FUSED_SMEM"] <= 227 * 1024
    assert f"// {c['FUSED_SMEM']}" in text
    asserts = re.findall(r"static_assert\(([^,]+),", text)
    assert len(asserts) == 2
    for cond in asserts:
        assert eval(cond, {}, c), cond  # noqa: S307 - own source
    # the launch asks for exactly that size
    assert "int(FUSED_SMEM)" in text and "FT, FUSED_SMEM," in text


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
