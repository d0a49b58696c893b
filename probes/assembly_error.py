"""Error against float64 of the sums that run on the tensor cores, by where
they sum, with the diagonal apart (a sum whose terms all have one sign shows
a biased rounding there as a mean away from zero).

    python3 probes/assembly_error.py [root of a checkout]

Imports ``ipx_torch`` from the checkout given (default: this one), builds
its kernels, prints the card's name and power limit, then one JSON line for
each of:

- ``assembly``: ``assemble_sym_batched`` on three batches of 8 (m=1024,
  n=2048, bf16 A, d2 spread over many decades as in mid-solve) with the bf16
  A itself (``bf16_a``), the same values as float32 (``f32_a_bf16_values``:
  the float32 kernel, whose column operand then splits into hi alone) and
  the plain version (``plain``, one float32 matmul); and with a float32 A of
  full mantissas drawn after them (``f32_a``: the float32 kernel of the
  checkout measured; ``f32_a_plain``): the largest and the RMS error
  relative to the largest entry of M, the mean of all errors so scaled, and
  the mean and RMS of the relative error on the diagonal;
- ``fused_start_tiles``: the first tile of every panel's C_k from
  ``factor_fused_panels``' panel kernel, on the same batches (Jacobi scale,
  reg from 1e-8 to 1e-4), against the float64 value of
  J (A_k * d2) A_k^T J + reg - sum_j P_j^T P_j with the P_j the kernel's own
  panels: ``whole``; ``assembly``, the kernel run with reg 0 and zero prior
  panels; ``subtraction``, the kernel run with d2 = 0 (the assembly is then
  exactly 0) and reg 0, relative to the sum it subtracts.  The mean and RMS
  of the relative error on the diagonal, and the RMS of the off-diagonal
  error relative to the largest entry of the tile (``chip_smoke.py``'s
  ``_start_tile_diagonals``, of this tree, over the checkout's kernels);
- ``lt_start_tiles``: row 7's start tiles, the first tile of every C_k
  (k >= 1) from ``factor_lt_panels``' accumulation launches on the float32
  scaled regularised matrix of the same batches, with the factor's own
  prior panels, against the float64 value of Ms's tile less sum_j P_j^T P_j:
  ``whole`` relative to it and ``subtraction`` relative to the sum
  subtracted; the diagonal's mean and RMS, the off-diagonal RMS and the
  whole tile's mean and RMS relative to its largest entry
  (``chip_smoke.py``'s ``_lt_start_tiles``, of this tree, over the
  checkout's kernels);
- ``right_update``: the trailing update of ``cholesky_batched``'s first
  panel (the diagonal factor, the panel TRSM and the update of the C entry
  points) on the scaled regularised matrix of the same batches, against
  T - P P^T in float64 with P the kernel's own panel: the diagonal's error
  relative to the sum subtracted (mean, RMS), and the off-diagonal RMS
  relative to the largest entry of P P^T.

Means are over the batches.  Run it on two checkouts in one call to compare
them.  Needs a CUDA device.
"""
import json
import os
import sys

ROOT = (sys.argv[1] if len(sys.argv) > 1 else
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ipx_torch.kernels import _build, cholesky as pk  # noqa: E402
from ipx_torch.kernels import fused as fk  # noqa: E402

from checkout import chip_smoke, devinfo, right_panel  # noqa: E402

SMOKE = chip_smoke()

SEEDS = (1, 2, 3)
B, M, N = 8, 1024, 2048
NB = pk.NB


def _acc(stats: dict, key: str, values: dict) -> None:
    s = stats.setdefault(key, dict.fromkeys(values, 0.0))
    for k, v in values.items():
        s[k] += float(v) / len(SEEDS)


def _diag_stats(E, R, off_scale) -> dict:
    """Diagonal error E relative to R (mean, RMS) and the off-diagonal RMS
    of E / off_scale; E, R (B', n, n) float64."""
    d = torch.diagonal(E, dim1=-2, dim2=-1) / torch.diagonal(R, dim1=-2,
                                                             dim2=-1)
    off = E - torch.diag_embed(torch.diagonal(E, dim1=-2, dim2=-1))
    return {"diag_mean_rel": d.mean(), "diag_rms_rel": (d ** 2).mean().sqrt(),
            "offdiag_rms_rel": ((off / off_scale) ** 2).mean().sqrt()}


def assembly(stats, A, d2, A32) -> None:
    _assembly(stats, A, d2, (
        ("bf16_a", pk.assemble_sym_batched(A, d2)),
        ("f32_a_bf16_values", pk.assemble_sym_batched(A.float(), d2)),
        ("plain", pk.assemble_sym_batched_plain(A, d2))))
    _assembly(stats, A32, d2, (
        ("f32_a", pk.assemble_sym_batched(A32, d2)),
        ("f32_a_plain", pk.assemble_sym_batched_plain(A32, d2))))


def _assembly(stats, A, d2, results) -> None:
    A64 = A.double()
    R = torch.matmul(A64 * d2.double().unsqueeze(1), A64.mT)
    scale = R.abs().amax(dim=(1, 2), keepdim=True)
    for name, Mk in results:
        E = Mk.double() - R
        dr = torch.diagonal(E / R, dim1=1, dim2=2)
        _acc(stats, "assembly/" + name, {
            "max_rel": (E.abs() / scale).max(),
            "rms_rel": ((E / scale) ** 2).mean().sqrt(),
            "diag_mean_rel": dr.mean(), "diag_rms_rel": (dr ** 2).mean().sqrt(),
            "mean_rel": (E / scale).mean()})


def fused_start_tiles(stats, A, d2, j, reg) -> None:
    for name, v in SMOKE._start_tile_diagonals(A, d2, j, reg).items():
        _acc(stats, "fused_start_tiles/" + name, v)


def _scaled64(A, d2, j, reg):
    A64, j64 = A.double(), j.double()
    Ms64 = torch.matmul(A64 * d2.double().unsqueeze(1), A64.mT)
    Ms64 = Ms64 * j64.unsqueeze(2) * j64.unsqueeze(1)
    Ms64.diagonal(dim1=1, dim2=2).add_(reg.double().unsqueeze(-1))
    return Ms64


def lt_start_tiles(stats, A, d2, j, reg) -> None:
    Ms = _scaled64(A, d2, j, reg).float().contiguous()
    panels, _ = pk.factor_lt_panels(Ms)
    for name, v in SMOKE._lt_start_tiles(Ms, panels,
                                         pk._lt_panel_rows(Ms)).items():
        _acc(stats, "lt_start_tiles/" + name, v)


def right_update(stats, A, d2, j, reg) -> None:
    """One panel step of the right-looking factor through the C entry
    points: the diagonal factor, the TRSM and the update of panel 0."""
    T = _scaled64(A, d2, j, reg).float().contiguous()
    T0 = T.double()
    W = torch.empty(B, M // NB, NB, NB, device="cuda")
    tile = T[:, :NB, :NB]
    pk.diag_factor_inv(tile, tile, W[:, 0], lower_out=True)
    right_panel(pk)(T, W, 0)
    torch.cuda.synchronize()
    P = T[:, NB:, :NB].double()
    S = torch.matmul(P, P.mT)
    ref = T0[:, NB:, NB:] - S
    E = torch.tril(T[:, NB:, NB:].double() - ref)
    scale = S.abs().amax(dim=(1, 2), keepdim=True)
    _acc(stats, "right_update", _diag_stats(E, S, scale))


def main() -> int:
    _build.build_all()
    print(json.dumps({"card": devinfo.nvidia_smi_line(), "root": ROOT}),
          flush=True)
    stats: dict = {}
    for seed in SEEDS:
        g = torch.Generator(device="cuda").manual_seed(seed)
        A = (torch.randn(B, M, N, generator=g, device="cuda")
             / N ** 0.5).to(torch.bfloat16)
        d2 = torch.exp(3.0 * torch.randn(B, N, generator=g, device="cuda"))
        reg = torch.logspace(-8, -4, B, device="cuda")
        j = torch.rsqrt(fk.a_matvec(A, d2, square=True))
        A32 = torch.randn(B, M, N, generator=g, device="cuda") / N ** 0.5
        assembly(stats, A, d2, A32)
        del A32
        fused_start_tiles(stats, A, d2, j, reg)
        lt_start_tiles(stats, A, d2, j, reg)
        right_update(stats, A, d2, j, reg)
    for name, s in stats.items():
        print(json.dumps({"sums": name, **s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
