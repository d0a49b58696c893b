"""Main-path kernel times of one checkout of this repository, for comparing
two trees on one card.

    python3 probes/kernel_times.py <root of a checkout> <tag>

Imports ``ipx_torch`` from the checkout given, builds its kernels and prints
one JSON line: the card, the build seconds, and CUDA-event times at B=256,
m=1024, n=2048 (bf16 A) of the eight panel launches of the fused factor, the
whole fused factor, ``ata_apply``, ``a_matvec`` (plain and squared),
``at_matvec``, ``assemble_sym_batched`` (and on an f32 copy of A, row 4's
float32 kernel), ``factor_lt_panels`` / ``factor_lt_batched`` /
``cholesky_batched`` on the assembled matrix, the eight accumulation
launches of ``factor_lt_panels`` alone on its own prior panels, the eight
accumulation and the eight row-panel launches of ``factor_lt_batched``
alone on its own L^T (each panel's C kept from a first pass),
``diag_factor_inv`` on its first diagonal tile, the 14 launches of
``cholesky_batched``'s panel TRSM and trailing update alone (its own time,
without the 8 diagonal launches, each call on a fresh copy of the matrix
with the factor's own W), and the pair-solves
``chol_solve_batched_panels`` (at B=256 and on the first 16 instances) and
``chol_solve_batched_lt`` on the fused factor, and a hash of the fused
factor's, the panel pair-solve's, ``diag_factor_inv``'s,
``cholesky_batched``'s, ``factor_lt_panels``' and ``factor_lt_batched``'s
bits.  The pair-solves are timed
queued behind a spinning kernel, so that at B=16 the time is the kernel's
and not the host's time to launch it.  The timer is this tree's
(``probes/checkout.py``), whichever checkout is measured.  To compare a
change with its parent in one call, export the parent (``git archive``) into
a git-ignored directory and run parent, change, change, parent.  Needs a
CUDA device.
"""
import hashlib
import json
import sys
import time

if len(sys.argv) != 3:
    sys.exit(__doc__)
root, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)

import torch  # noqa: E402

from ipx_torch.kernels import _build, cholesky as pk, fused as fk  # noqa: E402

from checkout import devinfo, lt_steps, right_panel  # noqa: E402

nvidia_smi_line, time_ms = devinfo.nvidia_smi_line, devinfo.time_ms

t0 = time.perf_counter()
_build.build_all()
tb = time.perf_counter() - t0
B, m, n, NB = 256, 1024, 2048, 128
g = torch.Generator(device="cuda").manual_seed(2)
kw = dict(generator=g, device="cuda", dtype=torch.float32)
A = (torch.randn(B, m, n, **kw) / n ** 0.5).to(torch.bfloat16)
v = torch.randn(B, m, **kw)
w = torch.randn(B, n, **kw)
beta = torch.randn(B, n, **kw)
d2 = torch.exp(3.0 * torch.randn(B, n, **kw))
reg = torch.logspace(-8, -4, B, device="cuda")
j = torch.rsqrt(fk.a_matvec(A, d2, square=True))
panels, W = pk.factor_fused_panels(A, d2, j, reg)
scratch = torch.empty(B * NB * m, device="cuda")


def stages():
    """The m / NB panel launches alone, on the factor's own prior panels."""
    rows = pk._fused_panel_rows(A, d2, j, reg)
    for k in range(m // NB):
        wk = m - k * NB
        rows(k, panels[:k], scratch[:B * NB * wk].view(B, NB, wk))


Ms = pk.assemble_sym_batched(A, d2)
Ms.mul_(j.unsqueeze(2)).mul_(j.unsqueeze(1))
Ms.diagonal(dim1=1, dim2=2).add_(reg.unsqueeze(-1))
out = {"tag": tag, "build_s": tb, "card": nvidia_smi_line()}


def sha(*ts) -> str:
    """Hash of the bits of the first 16 instances: two checkouts whose
    kernels agree bit for bit print the same."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t[:16].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


out["factor_fused_panels_sha"] = sha(*panels, W)
out["panel_stages_x8"] = time_ms(stages, reps=5, warm=1)
out["factor_fused_panels"] = time_ms(
    lambda: pk.factor_fused_panels(A, d2, j, reg), reps=5, warm=1)
out["ata_apply"] = time_ms(lambda: fk.ata_apply(A, v, d2, w, beta=beta))
out["a_matvec"] = time_ms(lambda: fk.a_matvec(A, w))
out["at_matvec"] = time_ms(lambda: fk.at_matvec(A, v))
out["a_matvec_sq"] = time_ms(lambda: fk.a_matvec(A, d2, square=True))
out["factor_lt_panels"] = time_ms(lambda: pk.factor_lt_panels(Ms), reps=5,
                                  warm=1)
out["factor_lt_batched"] = time_ms(lambda: pk.factor_lt_batched(Ms), reps=5,
                                   warm=1)
p7, W7 = pk.factor_lt_panels(Ms)
out["factor_lt_panels_sha"] = sha(*p7, W7)


def lt_stages():
    """factor_lt_panels' m / NB accumulation launches alone, on the factor's
    own prior panels."""
    rows = pk._lt_panel_rows(Ms)
    for k in range(m // NB):
        wk = m - k * NB
        rows(k, p7[:k], scratch[:B * NB * wk].view(B, NB, wk))


out["factor_lt_panels_own_x8"] = time_ms(lt_stages, reps=5, warm=1)
del p7, W7
LT10, W10 = pk.factor_lt_batched(Ms)
out["factor_lt_batched_sha"] = sha(LT10, W10)
accumulate, row_panel = lt_steps(pk)
C10 = [torch.empty(B, NB, m - k * NB, device="cuda") for k in range(m // NB)]
for k, C in enumerate(C10):
    accumulate(Ms, LT10, C, k)
LT10b = LT10.clone()
out["factor_lt_batched_accumulate_x8"] = time_ms(
    lambda: [accumulate(Ms, LT10, C, k) for k, C in enumerate(C10)], reps=5,
    warm=1)
out["factor_lt_batched_row_panels_x8"] = time_ms(
    lambda: [row_panel(W10, C, LT10b, k) for k, C in enumerate(C10)], reps=5,
    warm=1)
del LT10, LT10b, W10, C10
Af = A.float()
out["assemble_sym_batched_f32"] = time_ms(
    lambda: pk.assemble_sym_batched(Af, d2), reps=3, warm=1)
del Af
out["assemble_sym_batched"] = time_ms(lambda: pk.assemble_sym_batched(A, d2),
                                      reps=5, warm=1)
CD = Ms[:, :NB, :NB].contiguous()
out["diag_factor_inv"] = time_ms(lambda: pk.diag_factor_inv(CD), queued=True)
out["diag_factor_inv_sha"] = sha(*pk.diag_factor_inv(CD))
out["cholesky_batched"] = time_ms(lambda: pk.cholesky_batched(Ms), reps=5,
                                  warm=1)
L9, W9 = pk.cholesky_batched(Ms)
out["cholesky_batched_sha"] = sha(L9, W9)
del L9
panel, T9 = right_panel(pk), torch.empty_like(Ms)


def right_panels():
    """cholesky_batched's TRSM and update launches alone, in place on T9
    (the diagonal tiles, which they do not read, are left as they were)."""
    for k in range(m // NB - 1):
        panel(T9, W9, k)


out["cholesky_batched_own_x14"] = time_ms(right_panels, reps=5, warm=1,
                                          setup=lambda: T9.copy_(Ms))
del Ms, CD, T9, W9


def queued_ms(fn):
    return time_ms(fn, reps=20, warm=1, queued=True)


rhs = torch.randn(B, m, **kw)
p16 = tuple(p[:16].contiguous() for p in panels)
W16, rhs16 = W[:16].contiguous(), rhs[:16].contiguous()
out["chol_solve_batched_panels"] = queued_ms(
    lambda: pk.chol_solve_batched_panels(panels, W, rhs))
out["chol_solve_batched_panels_b16"] = queued_ms(
    lambda: pk.chol_solve_batched_panels(p16, W16, rhs16))
out["chol_solve_batched_panels_sha"] = sha(
    pk.chol_solve_batched_panels(panels, W, rhs))
LT = pk.lt_of_panels(panels)
out["chol_solve_batched_lt"] = queued_ms(
    lambda: pk.chol_solve_batched_lt(LT, W, rhs))
print(json.dumps(out), flush=True)
