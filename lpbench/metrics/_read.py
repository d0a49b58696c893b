"""What the per-layer readers share.  Each reader takes the run's records
(``tracing.Tracer.records``, with the run's own clock and counts) and
returns a number, or None where what it reads is absent (a function
renamed or gone in the port, a run off the card)."""
from __future__ import annotations


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def outside_loop_s(records: dict):
    """Seconds of an entry call outside ``run_batch``, a call on average."""
    calls = [c for c in records["calls"] if c.get("run_batch_s")]
    return mean(c["seconds"] - sum(c["run_batch_s"]) for c in calls)


def iterations(records: dict):
    """``Solution.iterations`` an LP on average, rescue rungs included."""
    return mean(i for c in records["calls"] for i in c["iterations"])


def roofline(records: dict):
    """Summed bound over summed event time of every traced kernel call, in
    percent."""
    kern = records.get("kernels") or {}
    spent = sum(k["seconds"] for k in kern.values())
    if not spent:
        return None
    return 100.0 * sum(k["bound_s"] for k in kern.values()) / spent


def idle(records: dict):
    """The device's idle share inside the entry's calls, in percent."""
    dev = records.get("device")
    if not dev or not dev["window_s"]:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
