"""The program's own span summaries, taken by a driver around each call of
the traced run and read by the per-layer readers of those spans.

While a ``torch.profiler`` records (the harness's ``--trace 1`` run on a
card), :func:`recording` opens ``program.obs.tracing()`` around one call
and appends the trace's ``summary()`` to :data:`SUMMARIES`; otherwise the
call runs untouched.  A program without ``obs.tracing`` records nothing,
and its readers find nothing to read.  The list is module state because
the harness hands readers only its own records: a driver's ``warm_up``
empties it, so each run reads its own calls alone.
"""
from __future__ import annotations

import contextlib

import torch

SUMMARIES: list = []        # one ``Trace.summary()`` a traced call


@contextlib.contextmanager
def recording(program):
    tracing = getattr(getattr(program, "obs", None), "tracing", None)
    if tracing is None or not torch.autograd._profiler_enabled():
        yield
        return
    with tracing() as t:
        yield
    SUMMARIES.append(t.summary())


def span_seconds(name: str):
    """Seconds inside the program's span ``name``, a call on average over
    the recorded calls that hold it, or None where none does."""
    per_call = [s["spans"][name]["seconds"] for s in SUMMARIES
                if name in s.get("spans", {})]
    return sum(per_call) / len(per_call) if per_call else None
