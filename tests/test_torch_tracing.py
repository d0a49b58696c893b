"""The port's spans and counters (``ipx_torch.obs.span`` / ``count`` /
``tracing``) on tiny LPs on the CPU: where the spans of a ``solve_batch``
nest, the off path, and the stamps against ``torch.profiler``'s events."""
import numpy as np
import pytest
import torch

import ipx_torch
from ipx_torch import obs
from ipx_torch.ipm import mehrotra
from ipx_torch.problem.generate import random_feasible_lp

torch.set_num_threads(1)

OPTS = ipx_torch.SolverOptions(dtype="float32")

# span -> the span it sits in, in a solve_batch that rescues nothing (its
# lanes end apart, so the loop narrows)
PARENT = {"api.call": None, "api.prepare": "api.call",
          "ipm.start": "api.call", "ipm.step": "api.call",
          "ipm.compact": "api.call",
          "api.rescue": "api.call", "api.recheck": "api.call",
          "api.recheck.device": "api.recheck",
          "api.recheck.to_host": "api.recheck",
          "api.recheck.lanes": "api.recheck"}


def _lps(B=3, m=12, n=24):
    return [ipx_torch.make_lp(g.c, g.A, g.b, device="cpu")
            for g in (random_feasible_lp(m, n, seed=s) for s in range(B))]


def _solve(lps):
    return ipx_torch.solve_batch(lps, options=OPTS, device="cpu")


def test_solve_batch_spans_nest(monkeypatch):
    """The spans of one call nest as documented, all under one
    ``api.call``; one ``ipm.step`` a step of the loop, one ``ipm.compact``
    a narrowing, the counters as the widths stepped; self seconds are the
    duration less the children's."""
    steps = []          # the width of each step
    step = mehrotra.mehrotra_step

    def counted(lp, state, *a, **kw):
        steps.append(state.x.shape[0])
        return step(lp, state, *a, **kw)
    monkeypatch.setattr(mehrotra, "mehrotra_step", counted)
    with obs.tracing() as t:
        sols = _solve(_lps())
    assert all(s.optimal for s in sols)
    names = [r.name for r in t.spans]
    assert set(names) == set(PARENT)
    for r in t.spans:
        parent = t.spans[r.parent].name if r.parent >= 0 else None
        assert parent == PARENT[r.name], (r.name, parent)
        assert r.call == 0 and r.start_ns <= r.end_ns and r.cpu_s >= 0
        assert r.device_s is None           # no card
    summ = t.summary()
    assert summ["calls"] == 1
    assert summ["spans"]["ipm.step"]["calls"] == len(steps) > 0
    shrinks = sum(a != b for a, b in zip(steps, steps[1:]))
    assert summ["spans"]["ipm.compact"]["calls"] == shrinks > 0
    assert summ["counters"] == {"api.rescue.lanes_in": 0,
                                "api.rescue.near_miss_in": 0,
                                "api.recheck.lanes_checked": 3,
                                "ipm.compact.shrinks": shrinks,
                                "ipm.lane_steps": sum(steps)}
    for i, r in enumerate(t.spans):
        kids = sum(c.end_ns - c.start_ns for c in t.spans if c.parent == i)
        assert r.child_ns == kids
    whole = summ["spans"]["api.recheck"]
    parts = sum(summ["spans"][k]["seconds"]
                for k in ("api.recheck.device", "api.recheck.to_host",
                          "api.recheck.lanes"))
    assert whole["self_seconds"] == pytest.approx(whole["seconds"] - parts,
                                                  abs=1e-9)


class _Event:
    made = 0

    def __init__(self, enable_timing=False):
        _Event.made += 1

    def record(self):
        pass

    def elapsed_time(self, other):
        return 2.0      # ms


def test_off_records_nothing_and_on_keeps_the_bits(monkeypatch):
    """Off, a span is one shared null context: with a card faked, a whole
    ``solve_batch`` makes no CUDA event and opens no ``record_function``;
    on, each device span takes a pair of events, read when the record
    closes, and the Solutions are the same bit for bit."""
    rfs = []
    rf = torch.profiler.record_function

    def counted_rf(name):
        rfs.append(name)
        return rf(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "record_function", counted_rf)
    assert obs.span("a") is obs.span("b", device=True)
    lps = _lps()
    _Event.made = 0
    off = _solve(lps)
    assert _Event.made == 0 and not rfs and obs._TRACE is None
    obs.count("api.rescue.lanes_in", 1)         # nothing to add to
    with obs.tracing() as t:
        on = _solve(lps)
    dev = [r for r in t.spans
           if r.name in ("ipm.start", "ipm.step", "ipm.compact",
                         "api.recheck.device")]
    assert _Event.made == 2 * len(dev) and not rfs
    assert all(r.device_s == 2e-3 and r.events is None for r in dev)
    spans = t.summary()["spans"]
    assert spans["ipm.step"]["device_seconds"] == pytest.approx(
        2e-3 * spans["ipm.step"]["calls"])
    assert spans["api.recheck.device"]["device_seconds"] == 2e-3
    assert "device_seconds" not in spans["api.recheck"]
    for a, b in zip(off, on):
        for f in ("x", "y", "s", "trace"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
        assert (a.status, a.iterations, a.objective, a.rp_rel, a.rd_rel) == \
            (b.status, b.iterations, b.objective, b.rp_rel, b.rd_rel)


def test_span_stamps_match_the_profiler():
    """Each recorded span has the profiler's event of its name, and the
    event lies inside the span's stamps (both on ``time.time_ns()``'s
    clock, to 0.1 ms); over the two calls, some span of each name starts
    and ends within 1 ms of its event (a thread preempted between a stamp
    and its event moves them apart by a time slice, ms on a loaded host);
    the entry's root span and its children appear as
    ``record_function``s."""
    from torch.profiler import ProfilerActivity, profile
    lps = _lps(B=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a profile's first annotation pays its set-up: not a span's
        with torch.profiler.record_function("warm"):
            pass
        with obs.tracing() as t:
            _solve(lps)
            _solve(lps)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name() in PARENT:
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    recorded = {}
    for r in t.spans:
        recorded.setdefault(r.name, []).append((r.start_ns, r.end_ns))
    assert set(recorded) == set(events) == set(PARENT)
    for name, spans in recorded.items():
        assert len(spans) == len(events[name]) >= 2, name
        apart = []
        for (s, e), (ps, pe) in zip(spans, sorted(events[name])):
            assert s - 1e5 <= ps <= pe <= e + 1e5, name
            apart.append(max(ps - s, e - pe))
        assert min(apart) < 1e6, name
