"""Error of the normal-matrix assembly against float64, by where it sums.

    python3 probes/assembly_error.py

``assemble_sym_batched`` on three batches of 8 (m=1024, n=2048, bf16 A, d2
spread over many decades as in mid-solve): with the bf16 A itself (the
tensor cores), with the same values as float32 (the CUDA cores) and the
plain version (one float32 matmul), each against the float64 product.  One
JSON line each, means over the batches: the largest error and the RMS error
relative to the largest entry of M, and, on the diagonal, the mean and RMS
of the relative error (a sum whose terms all have one sign shows a biased
rounding there as a mean away from zero); the mean of all errors relative
to the largest entry.  The first line is the card's name and power limit.
Needs a CUDA device.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from ipx_torch.devinfo import nvidia_smi_line  # noqa: E402
from ipx_torch.kernels import _build, cholesky as pk  # noqa: E402

SEEDS = (1, 2, 3)


def main() -> int:
    _build.build_all()
    print(json.dumps({"card": nvidia_smi_line()}), flush=True)
    stats: dict = {}
    for seed in SEEDS:
        g = torch.Generator(device="cuda").manual_seed(seed)
        A = (torch.randn(8, 1024, 2048, generator=g, device="cuda")
             / 2048 ** 0.5).to(torch.bfloat16)
        d2 = torch.exp(3.0 * torch.randn(8, 2048, generator=g, device="cuda"))
        A64 = A.double()
        R = torch.matmul(A64 * d2.double().unsqueeze(1), A64.mT)
        scale = R.abs().amax(dim=(1, 2), keepdim=True)
        for name, M in (("tensor_cores", pk.assemble_sym_batched(A, d2)),
                        ("cuda_cores", pk.assemble_sym_batched(A.float(), d2)),
                        ("plain", pk.assemble_sym_batched_plain(A, d2))):
            E = M.double() - R
            dr = torch.diagonal(E / R, dim1=1, dim2=2)
            s = stats.setdefault(name, dict.fromkeys(
                ("max_rel", "rms_rel", "diag_mean_rel", "diag_rms_rel",
                 "mean_rel"), 0.0))
            s["max_rel"] += float((E.abs() / scale).max()) / len(SEEDS)
            s["rms_rel"] += float(((E / scale) ** 2).mean().sqrt()) / len(SEEDS)
            s["diag_mean_rel"] += float(dr.mean()) / len(SEEDS)
            s["diag_rms_rel"] += float((dr ** 2).mean().sqrt()) / len(SEEDS)
            s["mean_rel"] += float((E / scale).mean()) / len(SEEDS)
    for name, s in stats.items():
        print(json.dumps({"assembly": name, **s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
