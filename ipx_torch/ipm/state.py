"""IPM iterate state: a frozen dataclass of batched tensors.

Everything the solve loop carries: the primal-dual iterate, the convergence
scalars computed by the previous step, best-iterate tracking (the final f32
iterations can degrade, so the reported solution is the best point visited),
the iteration counter and status per lane, and a bounded trace buffer.
Every field has a leading batch dimension B.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

TRACE_COLS = 8  # [mu, rp_rel, rd_rel, rel_gap, alpha_p, alpha_d, sigma, pobj]


@dataclass(frozen=True)
class IPMState:
    x: torch.Tensor           # (B, n) primal iterate, > 0
    y: torch.Tensor           # (B, m) dual iterate
    s: torch.Tensor           # (B, n) dual slacks, > 0
    it: torch.Tensor          # (B,) int32 iteration counter
    status: torch.Tensor      # (B,) int32 Status code
    mu: torch.Tensor          # (B,) duality measure x@s/n
    mu0: torch.Tensor         # (B,) initial duality measure
    rp_rel: torch.Tensor      # (B,) relative primal infeasibility (inf-norm)
    rd_rel: torch.Tensor      # (B,) relative dual infeasibility (inf-norm)
    rel_gap: torch.Tensor     # (B,) relative complementarity gap
    best_x: torch.Tensor      # best-merit iterate seen so far
    best_y: torch.Tensor
    best_s: torch.Tensor
    best_merit: torch.Tensor  # (B,)
    reg_boost: torch.Tensor   # (B,) regularization escalation factor (>= 1)
    reg_floor: torch.Tensor   # (B,) decay floor for reg_boost
    trace: torch.Tensor       # (B, max_iter, TRACE_COLS)
    rp: torch.Tensor          # (B, m) primal residual A x - b at the iterate,
                              # carried so a step's entry does not stream A
                              # again for what the previous exit measured
    rd: torch.Tensor          # (B, n) dual residual A^T y + s - c


def init_state(x: torch.Tensor, y: torch.Tensor, s: torch.Tensor,
               mu0: torch.Tensor, max_iter: int) -> IPMState:
    B = x.shape[0]
    kw = dict(dtype=x.dtype, device=x.device)
    inf = torch.full((B,), float("inf"), **kw)
    ones = torch.ones(B, **kw)
    zi = torch.zeros(B, dtype=torch.int32, device=x.device)
    return IPMState(
        x=x, y=y, s=s, it=zi, status=zi.clone(),
        mu=inf, mu0=mu0.to(x.dtype),
        rp_rel=inf.clone(), rd_rel=inf.clone(), rel_gap=inf.clone(),
        best_x=x, best_y=y, best_s=s, best_merit=inf.clone(),
        reg_boost=ones, reg_floor=ones.clone(),
        trace=torch.zeros(B, max_iter, TRACE_COLS, **kw),
        # placeholders: refresh_residuals fills these before any step runs
        rp=torch.zeros_like(y), rd=torch.zeros_like(x),
    )


def take_lanes(obj, idx: torch.Tensor):
    """Lanes ``idx`` of a batched dataclass: an LP, an IPMState or a
    linear-system factor.  Each tensor field is gathered by index as stored
    (a bf16 A stays bf16); tuples (``NormalEqFactor.LTp``) and nested
    factors are followed; None, scalars and empty placeholders (the ``L``
    of a backend that carries ``W``) are kept."""
    def take(v):
        if isinstance(v, torch.Tensor):
            return v[idx] if v.ndim and v.numel() else v
        if isinstance(v, tuple):
            return tuple(take(u) for u in v)
        if dataclasses.is_dataclass(v):
            return take_lanes(v, idx)
        return v
    return type(obj)(**{f.name: take(getattr(obj, f.name))
                        for f in dataclasses.fields(obj)})


def put_lanes(st: IPMState, idx: torch.Tensor, sub: IPMState) -> IPMState:
    """``st`` with lanes ``idx`` replaced by the lanes of ``sub``."""
    out = {}
    for f in dataclasses.fields(st):
        a = getattr(st, f.name).clone()
        a[idx] = getattr(sub, f.name)
        out[f.name] = a
    return IPMState(**out)


def select_lanes(active: torch.Tensor, new: IPMState,
                 old: IPMState) -> IPMState:
    """Per-lane select: fields of ``new`` where ``active`` (B,), else
    ``old``."""
    out = {}
    for f in dataclasses.fields(IPMState):
        a, b = getattr(new, f.name), getattr(old, f.name)
        mask = active.reshape((-1,) + (1,) * (a.ndim - 1))
        out[f.name] = torch.where(mask, a, b)
    return IPMState(**out)
