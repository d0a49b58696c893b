"""The traced run's records, taken by the harness's own wrappers.

While a :class:`Tracer` is active it replaces module attributes of the port
(callers reach these functions through them: ``batched.run_batch`` from
``api``, ``mehrotra.mehrotra_step`` from the step, ``schur._precond`` from
``schur``'s globals, ``fk.a_matvec`` and ``pk.assemble_sym_batched`` from
the linear-system modules) and puts them back on exit:

- ``ipm.run_batch`` and ``linsys.precond``: wall time, synchronised before
  and after, in a ``record_function`` span of that name;
- ``mehrotra.mehrotra_step``: counted inside the open ``run_batch``;
- the kernel entries (one file each under ``work/``): a pair of CUDA events
  around each call, no synchronise, and the call's operations and bytes
  from its arguments' shapes; a call made inside another traced entry
  (the diagonal factor inside a whole factor) counts as part of it;
- each call of the cell's entry: host time in a ``record_function`` span
  ``api.<entry>``;
- on a card, ``torch.profiler`` over the whole window: the device's busy
  time inside the entry's calls (the union of its activity intervals), the
  kernels that took most of it, and the idle gaps by the innermost span the
  host was in.

The untraced run uses :class:`NoTracer` and calls the port untouched.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import sys
import time

import torch

# the peaks a kernel share is taken against: one H100 SXM's dense bf16
# tensor-core rate (no float32-faithful split of a product can beat it) and
# its HBM3 rate (NVIDIA's data sheet)
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
TOP = 10
# the names of the harness's record_function spans begin with these
SPAN_PREFIXES = ("api.", "ipm.", "linsys.", "kernels.")


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take for the work."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


class NoTracer:
    """The untraced run: nothing wrapped, nothing recorded."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @contextlib.contextmanager
    def call(self):
        yield

    def records(self, calls) -> dict:
        return {"calls": [_call_record(c, None) for c in calls]}


def _call_record(c: dict, inner) -> dict:
    rec = {"seconds": c["seconds"], "lps": c["lps"],
           "iterations": c["answers"]["iterations"]}
    if inner is not None:
        rec["run_batch_s"] = inner["run_batch_s"]
        rec["steps"] = inner["steps"]
    return rec


class Tracer:
    def __init__(self, device, here, entry: str):
        from lpbench import harness
        from ipx_torch.ipm import batched, mehrotra
        from ipx_torch.linsys import schur
        self.cuda = device.type == "cuda"
        self.entry = entry
        self._patches = [
            (batched, "run_batch", self._run_batch),
            (mehrotra, "mehrotra_step", self._step),
            (schur, "_precond", self._timed("linsys.precond")),
        ]
        for name in harness.kernel_entries(here):
            w = harness.load_work(name, here)
            self._patches.append((importlib.import_module(w.MODULE), name,
                                  self._kernel(name, w.work)))
        self._orig = []
        self._calls = []           # per entry call: run_batch seconds, steps
        self._steps = []           # open run_batch step counters
        self._depth = 0
        self._pairs = []
        self.spans = {}
        self._prof = None

    # ---- wrappers ------------------------------------------------------
    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _timed(self, label: str):
        def wrap(fn):
            def timed(*a, **kw):
                with torch.profiler.record_function(label):
                    self._sync()
                    t0 = time.perf_counter()
                    out = fn(*a, **kw)
                    self._sync()
                    dt = time.perf_counter() - t0
                s = self.spans.setdefault(label, {"calls": 0, "seconds": 0.0})
                s["calls"] += 1
                s["seconds"] += dt
                return out
            return timed
        return wrap

    def _run_batch(self, fn):
        def run_batch(*a, **kw):
            self._steps.append(0)
            try:
                with torch.profiler.record_function("ipm.run_batch"):
                    self._sync()
                    t0 = time.perf_counter()
                    out = fn(*a, **kw)
                    self._sync()
                    dt = time.perf_counter() - t0
            finally:
                steps = self._steps.pop()
            if self._calls:
                self._calls[-1]["run_batch_s"].append(dt)
                self._calls[-1]["steps"].append(steps)
            return out
        return run_batch

    def _step(self, fn):
        def step(*a, **kw):
            if self._steps:
                self._steps[-1] += 1
            return fn(*a, **kw)
        return step

    def _kernel(self, name: str, work):
        label = "kernels." + name

        def wrap(fn):
            def kernel(*a, **kw):
                if self._depth:
                    return fn(*a, **kw)
                ops, nbytes = work(*a, **kw)
                self._depth += 1
                try:
                    with torch.profiler.record_function(label):
                        if not self.cuda:
                            return fn(*a, **kw)
                        e0 = torch.cuda.Event(enable_timing=True)
                        e1 = torch.cuda.Event(enable_timing=True)
                        e0.record()
                        out = fn(*a, **kw)
                        e1.record()
                finally:
                    self._depth -= 1
                self._pairs.append((name, ops, nbytes, e0, e1))
                return out
            return kernel
        return wrap

    # ---- lifetime ------------------------------------------------------
    def __enter__(self):
        for mod, name, make in self._patches:
            fn = getattr(mod, name, None)
            if fn is None:      # renamed or gone: its metrics read nothing
                print(f"trace: {mod.__name__}.{name} not found, not traced",
                      file=sys.stderr)
                continue
            self._orig.append((mod, name, fn))
            setattr(mod, name, make(fn))
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
        for mod, name, fn in reversed(self._orig):
            setattr(mod, name, fn)
        self._orig = []
        return False

    @contextlib.contextmanager
    def call(self):
        self._calls.append({"run_batch_s": [], "steps": []})
        with torch.profiler.record_function("api." + self.entry):
            yield

    # ---- records -------------------------------------------------------
    def records(self, calls) -> dict:
        out = {"calls": [_call_record(c, i)
                         for c, i in zip(calls, self._calls)],
               "spans": self.spans, "kernels": {}}
        if self.cuda:
            torch.cuda.synchronize()
            kern = out["kernels"]
            for name, ops, nbytes, e0, e1 in self._pairs:
                k = kern.setdefault(name, {"calls": 0, "seconds": 0.0,
                                           "bound_s": 0.0, "ops": 0.0,
                                           "bytes": 0.0})
                k["calls"] += 1
                k["seconds"] += e0.elapsed_time(e1) / 1e3
                k["bound_s"] += bound_s(ops, nbytes)
                k["ops"] += ops
                k["bytes"] += nbytes
        self._pairs = []
        if self._prof is not None:
            out.update(timeline(self._prof, "api." + self.entry))
            self._prof = None
        return out


# ---- the profiler's timeline ---------------------------------------------

def _merge(intervals):
    """Sorted, disjoint union of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _clip(union, windows):
    """The parts of ``union`` inside ``windows`` (both sorted, disjoint),
    and the gaps: the parts of ``windows`` outside ``union``."""
    inside, gaps = [], []
    i = 0
    for ws, we in windows:
        while i < len(union) and union[i][1] <= ws:
            i += 1
        t = ws
        j = i
        while j < len(union) and union[j][0] < we:
            s, e = max(union[j][0], ws), min(union[j][1], we)
            if s > t:
                gaps.append((t, s))
            inside.append((s, e))
            t = max(t, e)
            j += 1
        if t < we:
            gaps.append((t, we))
    return inside, gaps


def _innermost(spans, points):
    """For each point, the name of the innermost span holding it (spans of
    one thread nest), or ``"outside"``."""
    marks = [(s, 0, i) for i, (s, e, _) in enumerate(spans)]
    marks += [(e, 2, i) for i, (s, e, _) in enumerate(spans)]
    marks += [(p, 1, j) for j, p in enumerate(points)]
    marks.sort()
    open_, out = [], ["outside"] * len(points)
    for _, kind, i in marks:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            if i in open_:
                open_.remove(i)
        else:
            out[i] = spans[open_[-1]][2] if open_ else "outside"
    return out


def timeline(prof, call_label: str) -> dict:
    """Busy time, window and breakdown from the profiler's events: the
    device's activity intervals (kernels, copies, sets; not the device-side
    copies of host annotations) inside the spans ``call_label``."""
    events = prof.profiler.kineto_results.events()
    dev, spans = [], []
    for e in events:
        s, name = e.start_ns(), e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device-side copies of the host's spans are no activity
            if e.is_user_annotation() or name.startswith(SPAN_PREFIXES):
                continue
            dev.append((s, s + e.duration_ns(), name))
        elif e.is_user_annotation():
            spans.append((s, s + e.duration_ns(), name))
    windows = _merge([(s, e) for s, e, n in spans if n == call_label])
    window_ns = sum(e - s for s, e in windows)
    if not dev or not window_ns:
        return {}
    inside, gaps = _clip(_merge([(s, e) for s, e, _ in dev]), windows)
    busy_ns = sum(e - s for s, e in inside)
    starts = [s for s, _ in windows]
    by_op = {}
    for s, e, name in dev:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < windows[i][1]:
            by_op[name] = by_op.get(name, 0) + (e - s)
    spans.sort()
    where = _innermost(spans, [(s + e) / 2 for s, e in gaps])
    idle = {}
    for (s, e), name in zip(gaps, where):
        idle[name] = idle.get(name, 0) + (e - s)
    top = lambda d: [[k[:120], v / 1e9] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device": {"busy_s": busy_ns / 1e9, "window_s": window_ns / 1e9},
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(idle)}}
