"""Observability: checkpoint/resume, profiling hooks, timing.

The solve loop carries a bounded trace buffer in ``IPMState`` (rendered by
``Solution.iteration_table``).  This module adds the host-side pieces:

  * checkpoint/resume: the IPM state (x, y, s, iteration, ...) is a handful
    of tensors; a ``.npz`` snapshot plus ``resume_state`` makes any solve
    restartable, since the iterate IS the algorithm state.  The file layout
    is ``ipx``'s (``ipx/obs.py``), so a snapshot written by either package
    resumes in the other.
  * ``span`` / ``count`` / ``tracing``: the program's own spans and
    counters (entry calls, the host re-check, the rescue rungs, each
    Mehrotra step's device time), recorded in memory under ``tracing()``
    and, while a ``torch.profiler`` records, ``record_function``s in its
    trace; off, a span is a shared null context.
  * ``trace_to``: ``torch.profiler`` capture around a region.
  * ``solve_with_snapshots``: a solve checkpointed every k iterations.
  * ``debug_mode`` / ``checked_solve``: every step's named values tested
    for non-finite entries, raised or recorded.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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
# spans and counters
# ---------------------------------------------------------------------------

CALL = "api.call"           # the root span of each entry call
_NULL = contextlib.nullcontext()
_TRACE: Optional["Trace"] = None        # the open ``tracing()`` record
_ENTRY_DEPTH = 0            # entry calls open, while spans are recorded


@dataclass
class SpanRecord:
    """One closed span: ``start_ns`` and ``end_ns`` on ``time.time_ns()``,
    the clock of ``torch.profiler``'s events, taken outside the span's
    ``record_function`` so that its profiler event lies inside them;
    ``parent`` the index of the enclosing span in ``Trace.spans`` (-1 at a
    root); ``call`` the index of the ``api.call`` it belongs to (-1
    outside any entry call); ``cpu_s`` the process's CPU seconds (all
    threads) it spanned; ``device_s`` the seconds between its pair of CUDA
    events, read when the record closes (None without)."""
    name: str
    start_ns: int
    end_ns: int = 0
    parent: int = -1
    call: int = -1
    cpu_s: float = 0.0
    device_s: Optional[float] = None
    child_ns: int = 0
    events: Optional[tuple] = None


class Trace:
    """The in-memory record of one :func:`tracing` context: its spans in
    the order they opened and its counters.  One thread: the spans of the
    solve path nest."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.calls = 0
        self._stack: list = []

    def _close(self):
        """Reads every span's CUDA events, once."""
        pending = [r for r in self.spans if r.events is not None]
        if pending:
            torch.cuda.synchronize()
            for r in pending:
                e0, e1 = r.events
                r.device_s = e0.elapsed_time(e1) / 1e3
                r.events = None

    def summary(self) -> dict:
        """By span name: ``calls``, ``seconds``, ``self_seconds`` (less the
        part its child spans cover), ``cpu_seconds`` and, where recorded,
        ``device_seconds``; the counters beside them, and ``calls``, the
        entry calls (``api.call`` spans) recorded."""
        spans: dict = {}
        for r in self.spans:
            if not r.end_ns:
                continue        # still open
            s = spans.setdefault(r.name, {"calls": 0, "seconds": 0.0,
                                          "self_seconds": 0.0,
                                          "cpu_seconds": 0.0})
            s["calls"] += 1
            s["seconds"] += (r.end_ns - r.start_ns) / 1e9
            s["self_seconds"] += (r.end_ns - r.start_ns - r.child_ns) / 1e9
            s["cpu_seconds"] += r.cpu_s
            if r.device_s is not None:
                s["device_seconds"] = s.get("device_seconds", 0.0) + r.device_s
        return {"calls": self.calls, "spans": spans,
                "counters": dict(self.counters)}


class _Span:
    """A span while :func:`tracing` records (see :func:`span`)."""

    __slots__ = ("trace", "rec", "rf", "cpu0")

    def __init__(self, trace: Trace, name: str, device: bool):
        self.trace = trace
        stack = trace._stack
        parent = stack[-1] if stack else -1
        call = trace.spans[parent].call if stack else -1
        if name == CALL and call < 0:
            call = trace.calls
            trace.calls += 1
        self.rec = SpanRecord(name, 0, parent=parent, call=call)
        if device and torch.cuda.is_available():
            self.rec.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
        self.rf = None

    def __enter__(self):
        rec = self.rec
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(rec.name)
        self.cpu0 = time.process_time()
        # the stamps lie next to the profiler's event: a thread preempted
        # between them moves them apart
        rec.start_ns = time.time_ns()
        if self.rf is not None:
            self.rf.__enter__()
        if rec.events is not None:
            rec.events[0].record()
        self.trace._stack.append(len(self.trace.spans))
        self.trace.spans.append(rec)
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec.end_ns = time.time_ns()
        rec.cpu_s = time.process_time() - self.cpu0
        self.trace._stack.pop()
        if rec.parent >= 0:
            self.trace.spans[rec.parent].child_ns += rec.end_ns - rec.start_ns
        return False


def span(name: str, device: bool = False):
    """A context manager naming a region of the program.

    Under :func:`tracing` the span is recorded (:class:`SpanRecord`); with
    ``device=True`` on a card, also a pair of CUDA events around it, read
    only when the record closes.  While a ``torch.profiler`` records, it
    is a ``record_function`` of the same name too, so a trace
    (:func:`trace_to`) shows the program's spans above the kernels and
    copies.  Otherwise it is a shared null context: no event, no
    ``record_function``, no allocation, no host read."""
    t = _TRACE
    if t is not None:
        return _Span(t, name, device)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def count(name: str, k) -> None:
    """Adds ``k`` to the counter ``name`` of the open :func:`tracing`
    record; nothing without one.  ``k`` is a number the host already
    holds: a counter never reads the device."""
    t = _TRACE
    if t is not None:
        t.counters[name] = t.counters.get(name, 0) + k


def entry(fn):
    """Marks a public entry of the port: a call made outside every other
    entry call opens the root span ``api.call`` (:func:`span`)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        global _ENTRY_DEPTH
        if _ENTRY_DEPTH or (_TRACE is None
                            and not torch.autograd._profiler_enabled()):
            return fn(*args, **kwargs)
        _ENTRY_DEPTH += 1
        try:
            with span(CALL):
                return fn(*args, **kwargs)
        finally:
            _ENTRY_DEPTH -= 1
    return call


@contextlib.contextmanager
def tracing():
    """Records the program's spans and counters while open; yields the
    :class:`Trace`, whose CUDA events are read when the context closes::

        with obs.tracing() as t:
            ipx_torch.solve_batch(lps, options)
        t.summary()["spans"]["api.recheck"]["seconds"]
    """
    global _TRACE
    if _TRACE is not None:
        raise RuntimeError("obs.tracing() is already open")
    t = _TRACE = Trace()
    try:
        yield t
    finally:
        _TRACE = None
        t._close()


@contextlib.contextmanager
def trace_to(logdir: str):
    """``torch.profiler`` capture around a region, the host and, when there
    is one, the card; written to ``logdir`` as a Chrome trace (view in
    TensorBoard or Perfetto), the program's spans (:func:`span`) above the
    kernels and copies they launch."""
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
