"""Carry an LP or a solver state between numpy and this package.

The leaves of another implementation's ``LP`` and ``IPMState`` (for one
instance, or with a leading batch axis), given as numpy arrays, become this
package's batched dataclasses field by field, and back, so that two
implementations can take a step from the same state, or one can solve with
the other's factor.  Takes numpy only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ipx_torch.ipm.state import IPMState
from ipx_torch.kernels.cholesky import NB
from ipx_torch.linsys.normal_eq import NormalEqFactor
from ipx_torch.problem.lp import LP

_INT_FIELDS = ("it", "status")
# rank of each IPMState field for ONE instance
_RANK = {"x": 1, "y": 1, "s": 1, "best_x": 1, "best_y": 1, "best_s": 1,
         "rp": 1, "rd": 1, "trace": 2}


def _batched(a, rank: int) -> np.ndarray:
    a = np.asarray(a)
    if a.ndim == rank:
        return a[None]
    if a.ndim == rank + 1:
        return a
    raise ValueError(f"expected rank {rank} or {rank + 1}, got {a.shape}")


def lp_from_numpy(c, A, b, obj_offset=0.0, device="cuda",
                  dtype: torch.dtype = torch.float32) -> LP:
    """A batched LP (a single instance becomes a batch of one)."""
    A = _batched(A, 2)
    c = _batched(c, 1)
    b = _batched(b, 1)
    off = np.broadcast_to(np.asarray(obj_offset, np.float64), (A.shape[0],))
    if A.shape != (b.shape[0], b.shape[1], c.shape[1]) \
            or c.shape[0] != A.shape[0]:
        raise ValueError(f"inconsistent LP shapes: c{c.shape} A{A.shape} "
                         f"b{b.shape}")
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)   # copies
    return LP(c=t(c), A=t(A), b=t(b), obj_offset=t(off))


def state_from_numpy(fields: dict, device="cuda",
                     dtype: torch.dtype | None = None) -> IPMState:
    """``fields`` maps every IPMState field name to a numpy array.  Float
    fields take ``dtype`` (default: the dtype of ``fields["x"]``)."""
    names = [f.name for f in dataclasses.fields(IPMState)]
    missing = [k for k in names if k not in fields]
    if missing:
        raise ValueError(f"state fields missing: {missing}")
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, np.asarray(fields["x"]).dtype)
                                 ).dtype
    out = {}
    for k in names:
        a = _batched(fields[k], _RANK.get(k, 0))
        dt = torch.int32 if k in _INT_FIELDS else dtype
        out[k] = torch.tensor(a, dtype=dt, device=device)        # copies
    return IPMState(**out)


def state_to_numpy(state: IPMState) -> dict:
    """Every field as a numpy array with its leading batch axis."""
    return {f.name: getattr(state, f.name).detach().to("cpu").numpy()
            for f in dataclasses.fields(IPMState)}


def factor_from_ipx(panels, W, j, d2, ok, device="cuda", LT=None,
                    M=None) -> NormalEqFactor:
    """A normal-equations factor that carries W, from the numpy leaves of
    another implementation's, stacked over the batch: either panel-major,
    ``panels[k]`` (B, 128, m_pad - 128 k), or, with ``panels`` empty, the full
    transposed factor ``LT`` (B, m_pad, m_pad); ``W`` (B, m_pad / 128, 128,
    128), ``j`` (B, m), ``d2`` (B, n), ``ok`` (B,), and where the factor
    carries it the assembled matrix ``M`` (B, m, m).  One instance's leaves
    (each of one rank less) become a batch of one."""
    panels = [_batched(p, 2) for p in panels]
    if bool(panels) == (LT is not None):
        raise ValueError("give the panels or the full LT, one of the two")
    if panels:
        B, m_pad = panels[0].shape[0], panels[0].shape[2]
        for k, p in enumerate(panels):
            if p.shape != (B, NB, m_pad - k * NB):
                raise ValueError(f"panels[{k}] is {p.shape}, expected "
                                 f"{(B, NB, m_pad - k * NB)}")
        if len(panels) * NB != m_pad:
            raise ValueError(f"{len(panels)} panels do not make a factor of "
                             f"order {m_pad}")
    else:
        LT = _batched(LT, 2)
        B, m_pad = LT.shape[0], LT.shape[2]
        if LT.shape != (B, m_pad, m_pad) or m_pad % NB:
            raise ValueError(f"LT is {LT.shape}, expected (B, m_pad, m_pad) "
                             f"with m_pad a multiple of {NB}")
    W = _batched(W, 3)
    if W.shape != (B, m_pad // NB, NB, NB):
        raise ValueError(f"W{W.shape} does not belong to a factor of order "
                         f"{m_pad}")
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                                 device=device)                  # copies
    return NormalEqFactor(
        L=torch.zeros(0, dtype=torch.float32, device=device),
        j=f32(_batched(j, 1)), d2=f32(_batched(d2, 1)),
        ok=torch.tensor(np.atleast_1d(np.asarray(ok)), dtype=torch.bool,
                        device=device),
        W=f32(W), LTp=tuple(f32(p) for p in panels),
        LT=None if LT is None else f32(LT),
        M=None if M is None else f32(_batched(M, 2)))
