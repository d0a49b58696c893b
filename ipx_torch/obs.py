"""Observability: checkpoint/resume, profiling hooks, timing.

The solve loop carries a bounded trace buffer in ``IPMState`` (rendered by
``Solution.iteration_table``).  This module adds the host-side pieces:

  * checkpoint/resume: the IPM state (x, y, s, iteration, ...) is a handful
    of tensors; a ``.npz`` snapshot plus ``resume_state`` makes any solve
    restartable, since the iterate IS the algorithm state.  The file layout
    is ``ipx``'s (``ipx/obs.py``), so a snapshot written by either package
    resumes in the other.
  * ``timed_section`` / ``trace_to``: wall timing and ``torch.profiler``
    capture around a region.
  * ``solve_with_snapshots``: a solve checkpointed every k iterations.
  * ``debug_mode`` / ``checked_solve``: every step's named values tested
    for non-finite entries, raised or recorded.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ipx_torch.ipm.state import IPMState, TRACE_COLS
from ipx_torch.status import Status


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

_STATE_FIELDS = ("x", "y", "s", "it", "status", "mu", "mu0", "rp_rel",
                 "rd_rel", "rel_gap", "best_x", "best_y", "best_s",
                 "best_merit", "reg_boost", "reg_floor", "trace",
                 "rp", "rd")


def save_state(path: str, state: IPMState) -> None:
    """Snapshot an IPMState to a compressed ``.npz``.

    A state of one lane (what :func:`ipx_torch.solve` runs) is written in
    ``ipx``'s single-solve layout, without the leading batch axis (``x`` of
    shape (n,), ``it`` a scalar); a batch keeps its axis."""
    single = state.x.shape[0] == 1
    arrays = {}
    for f in _STATE_FIELDS:
        a = getattr(state, f).detach().to("cpu").numpy()
        arrays[f] = a[0] if single else a
    np.savez_compressed(path, **arrays)


def load_state(path: str, device="cuda") -> IPMState:
    """Load a snapshot into an IPMState on ``device``.  A single-solve
    snapshot (``x`` of rank 1) becomes a batch of one."""
    with np.load(path) as z:
        kw = {f: z[f] for f in _STATE_FIELDS if f in z.files}
    # snapshots written before the adaptive decay floor existed: never-failed
    if "reg_floor" not in kw:
        kw["reg_floor"] = np.ones_like(kw["reg_boost"])
    # snapshots written before residuals were carried: zeros are fine, every
    # run refreshes them from the iterate before stepping
    # (mehrotra.refresh_residuals)
    if "rp" not in kw:
        kw["rp"] = np.zeros_like(kw["y"])
        kw["rd"] = np.zeros_like(kw["x"])
    single = kw["x"].ndim == 1
    return IPMState(**{f: torch.from_numpy(np.ascontiguousarray(
        a[None] if single else a)).to(device) for f, a in kw.items()})


def resume_state(state: IPMState, max_iter: int) -> IPMState:
    """Prepare a loaded state to continue under a (possibly larger)
    iteration cap: the trace buffer is re-sized, everything else carries
    over, so the next run continues exactly where the snapshot stopped."""
    old = state.trace
    it = int(state.it.max())
    if max_iter < it:
        # a smaller cap than the iterations already done would truncate the
        # trace below state.it and break Solution.iteration_table
        raise ValueError(
            f"resume max_iter={max_iter} is smaller than the checkpoint's "
            f"completed iteration count {it}; pass max_iter >= {it}")
    rows = min(old.shape[-2], max_iter)
    trace = torch.zeros((*old.shape[:-2], max_iter, TRACE_COLS),
                        dtype=old.dtype, device=old.device)
    trace[..., :rows, :] = old[..., :rows, :]
    # a MAX_ITER exit becomes RUNNING again under the new cap; terminal
    # states (OPTIMAL/FAILED/STALLED) stay terminal
    status = torch.where(state.status == int(Status.MAX_ITER),
                         torch.full_like(state.status, int(Status.RUNNING)),
                         state.status)
    return dataclasses.replace(state, trace=trace, status=status)


# ---------------------------------------------------------------------------
# timing / profiling
# ---------------------------------------------------------------------------

@dataclass
class SectionTiming:
    name: str
    seconds: float = 0.0


@contextlib.contextmanager
def timed_section(name: str, sink: Optional[list] = None):
    """Wall-clock a region (device work must be synchronized by the caller:
    timing asynchronous launches measures the enqueue)."""
    t0 = time.perf_counter()
    rec = SectionTiming(name)
    try:
        yield rec
    finally:
        rec.seconds = time.perf_counter() - t0
        if sink is not None:
            sink.append(rec)


@contextlib.contextmanager
def trace_to(logdir: str):
    """``torch.profiler`` capture around a region, the host and, when there
    is one, the card; written to ``logdir`` as a Chrome trace (view in
    TensorBoard or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def solve_with_snapshots(c, A=None, b=None, options=None, *,
                         every: int = 8, path: str,
                         resume: bool = True, device="cuda"):
    """Solve with a periodic on-disk snapshot every ``every`` iterations.

    The solve runs in ``every``-iteration chunks on ``device``: after each
    chunk the state is checkpointed to ``path`` (atomic rename), so a
    killed process loses at most ``every`` iterations.  With
    ``resume=True`` an existing snapshot at ``path`` is picked up first:
    crash recovery is simply re-running the same call.  Returns the final
    :class:`ipx_torch.api.Solution`.
    """
    from ipx_torch.api import solve
    from ipx_torch.options import SolverOptions

    opts = options or SolverOptions()
    if every < 1:
        raise ValueError(f"every must be >= 1, got {every}")
    total = opts.max_iter
    start_done = 0
    sol = None
    resume_from = None
    if resume and os.path.exists(path):
        with np.load(path) as z:
            start_done = int(np.max(z["it"]))
        resume_from = path
    tmp = path + ".tmp.npz"
    while start_done < total:
        chunk = min(every, total - start_done)
        sol = solve(c, A, b, options=opts.replace(max_iter=start_done + chunk),
                    resume_from=resume_from, checkpoint_to=tmp,
                    presolve=False, device=device)
        os.replace(tmp, path)
        resume_from = path
        start_done = sol.iterations
        if sol.status != int(Status.MAX_ITER):
            break
    return sol


# ---------------------------------------------------------------------------
# non-finite checks
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def debug_mode():
    """NaN-strict execution for debugging solver numerics.

    While on, every step of every solve in this context
    (``ipm.batched.run_batch``) tests the factor's diagonal, the direction
    (dx, dy, ds), the step lengths and the new iterate of each lane it
    steps, and raises ``FloatingPointError`` naming the iteration, the lane
    and the field at the first non-finite value: one host read a step.
    Only for debugging: it conflicts with the solver's own deliberate NaN
    recovery (reg_boost), so expect a failing factorization to raise
    instead of recover.  Off (the default) nothing is tested or kept."""
    from ipx_torch.ipm import batched
    tok = batched.FINITE_CHECK.set("raise")
    try:
        yield
    finally:
        batched.FINITE_CHECK.reset(tok)


@dataclass
class CheckError:
    """What :func:`checked_solve` found: the first non-finite value's
    message, or None."""
    message: Optional[str] = None

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def checked_solve(lp, options=None):
    """Run one solve with :func:`debug_mode`'s checks recorded instead of
    raised: every non-finite value a step makes is captured as a raisable
    error instead of flowing silently into the recovery logic.  Debug tool:
    returns ``(err, IPMState)`` (a batch of one); ``err.get()`` is the first
    failure's message or None, ``err.throw()`` raises it.  It runs on the
    device ``lp`` lives on, the solve loop as a batch of one without the
    rescue ladder; on a healthy instance the state is a plain run's, bit
    for bit."""
    from ipx_torch.api import _prepare
    from ipx_torch.ipm import batched
    from ipx_torch.options import SolverOptions

    opts = options or SolverOptions()
    blp = _prepare([lp], opts, lp.c.device)
    found: list = []
    tok = batched.FINITE_CHECK.set(found)
    try:
        st = batched.run_batch(blp, opts)
    finally:
        batched.FINITE_CHECK.reset(tok)
    return CheckError(found[0] if found else None), st
